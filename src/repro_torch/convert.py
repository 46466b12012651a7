"""State conversion: numpy arrays into the port's record, boundary and
point types.

The Sphere paths have no weights; their state is record data, the
partitioner's boundary tables, and for k-means the points and the
centroid table.  The LM serving path has parameters and decode caches;
the training path adds the AdamW state.
These helpers turn the numpy arrays a test or a script makes from one
seed (or from the JAX package's trees, as numpy) into the port's types,
so the JAX package and the port can be fed identical inputs.
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


def points_from_numpy(pts: np.ndarray, device=None) -> torch.Tensor:
    """``[N, D]`` points as a float32 tensor on ``device`` (default
    CUDA)."""
    a = np.asarray(pts)
    if a.ndim != 2:
        raise ValueError(f"points must be 2-D, got {a.shape}")
    return torch.from_numpy(a.astype(np.float32)).to(resolve_device(device))


def centroids_from_numpy(c: np.ndarray, device=None) -> torch.Tensor:
    """A ``[K, D]`` centroid table as a float32 tensor on ``device``
    (default CUDA)."""
    return points_from_numpy(c, device)


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """One numpy array as a tensor of the same type and shape (0-d
    included) on ``device`` (default CUDA).  A bfloat16 array
    (``ml_dtypes.bfloat16``, what ``np.asarray`` makes of a JAX bfloat16
    array) is carried bit for bit through its 16-bit pattern."""
    a = np.array(a, order="C")           # a copy, of the same shape
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(tree_of_numpy, device=None):
    """The JAX package's parameter tree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tree of tensors
    on ``device`` (default CUDA): the same paths, shapes and types."""
    if isinstance(tree_of_numpy, dict):
        return {key: params_from_jax(sub, device)
                for key, sub in tree_of_numpy.items()}
    return tensor_from_numpy(tree_of_numpy, device)


def cache_from_jax(tree_of_numpy, device=None):
    """The JAX package's decode cache (KV caches, ring ``kpos``, RG-LRU
    states), as numpy, as the port's cache on ``device`` (default CUDA)."""
    return params_from_jax(tree_of_numpy, device)


def opt_state_from_jax(tree_of_numpy, device=None):
    """The JAX package's AdamW state (``step``, ``m``, ``v``, ``master``),
    as numpy, as the port's (``repro_torch.train.optim``) on ``device``
    (default CUDA), by the rule of :func:`params_from_jax`.  The
    ``int8_ef`` residual (``ef``) belongs to the podwise mode, which the
    port has not reached: a state that holds one raises."""
    keys = set(tree_of_numpy)
    if keys != {"step", "m", "v", "master"}:
        raise ValueError(f"an AdamW state holds step, m, v and master; got "
                         f"{sorted(keys)}")
    return params_from_jax(tree_of_numpy, device)
