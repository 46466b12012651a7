"""Entry point of the RG-LRU recurrence: ``rg_lru_scan``.

The port of ``repro.kernels.rg_lru_scan.ops``.  The route follows the
tensors' device: CUDA tensors go through the hand-written kernel
(:func:`.kernel.lru_scan`) or raise; CPU tensors take the plain version
(:mod:`.ref`); any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rg_lru_scan import kernel as _kernel
from repro_torch.kernels.rg_lru_scan.ref import lru_scan_ref


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """``(h [B, T, W], h_last [B, W])`` of ``h_t = a_t * h_{t-1} + b_t``
    for float32 ``a, b [B, T, W]`` and ``h0 [B, W]``."""
    if a.ndim != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                         a.shape[2]):
        raise ValueError(f"need a, b [B, T, W] and h0 [B, W], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    dev = a.device.type
    if dev == "cuda":
        return _kernel.lru_scan(a.contiguous(), b.contiguous(),
                                h0.contiguous())
    if dev != "cpu":
        raise ValueError(f"rg_lru_scan runs on cuda or cpu, not {dev}")
    return lru_scan_ref(a, b, h0)
