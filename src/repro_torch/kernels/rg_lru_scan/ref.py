"""Plain PyTorch version of the rg_lru_scan kernel.

The recurrence ``h_t = a_t * h_{t-1} + b_t`` as a loop over time, one
multiply and one add a step, as the JAX package's oracle (``lax.scan``)
and ``csrc/rg_lru_scan.cu`` compute it.  The wrappers in :mod:`.ops` use
it for tensors on the CPU; on the card it is the yardstick the kernel is
held to.
"""
from __future__ import annotations

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """``(h [B, T, W], h_last [B, W])`` for ``a, b [B, T, W]`` and
    ``h0 [B, W]``."""
    h = torch.empty_like(a)
    hv = h0
    for t in range(a.shape[1]):
        hv = hv * a[:, t] + b[:, t]
        h[:, t] = hv
    return h, hv
