"""Device selection for the port's entry points.

Every entry point that places records on a device (``SphereEngine``,
``RecordBatch.from_bytes``, the array executor) takes an explicit
``device``.  Leaving it out means CUDA: the port is written for the GPU,
and a machine without one must say so rather than quietly run the CPU
path.  Tests pass ``device="cpu"`` to run the plain PyTorch versions.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda`` and
    raises when CUDA is unavailable."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
