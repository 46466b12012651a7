"""State conversion: numpy arrays into the port's record and boundary types.

The system has no weights; its state is record data plus the
partitioner's boundary tables.  These helpers turn the numpy arrays a
test or a script makes from one seed into the port's types, so the JAX
package and the port can be fed identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.records import RecordBatch, StackedBatch
from repro_torch.device import resolve_device


def record_batch_from_numpy(data_u8: np.ndarray, n_valid=None,
                            device=None) -> RecordBatch:
    """A ``[rows, width]`` uint8 array as a RecordBatch on ``device``
    (default CUDA); ``n_valid`` marks a padding-resident batch."""
    data = np.ascontiguousarray(data_u8, dtype=np.uint8)
    if data.ndim != 2:
        raise ValueError(f"record data must be 2-D, got {data.shape}")
    t = torch.from_numpy(data.copy()).to(resolve_device(device))
    return RecordBatch(t, None if n_valid is None else int(n_valid))


def stacked_from_numpy(data_u8_3d: np.ndarray, n_valid_vec,
                       device=None) -> StackedBatch:
    """A ``[slots, rows, width]`` uint8 array plus its per-slot valid
    counts as a StackedBatch on ``device`` (default CUDA)."""
    data = np.ascontiguousarray(data_u8_3d, dtype=np.uint8)
    if data.ndim != 3:
        raise ValueError(f"stacked data must be 3-D, got {data.shape}")
    t = torch.from_numpy(data.copy()).to(resolve_device(device))
    return StackedBatch(t, np.asarray(n_valid_vec, dtype=np.int32))


def bounds_from_numpy(bounds_u32: np.ndarray) -> torch.Tensor:
    """uint32 boundary words (``[n_bounds]`` or ``[n_bounds, k]``) as the
    int64 tensor the port's kernels compare, on the CPU."""
    b = np.asarray(bounds_u32)
    if b.dtype != np.uint32:
        raise ValueError(f"boundary words must be uint32, got {b.dtype}")
    return torch.from_numpy(b.astype(np.int64))
