"""Entry point of the RG-LRU recurrence: ``rg_lru_scan``, with its gradient.

The port of ``repro.kernels.rg_lru_scan.ops``.  The route follows the
tensors' device: CUDA tensors go through the hand-written kernel
(:func:`.kernel.lru_scan`) or raise; CPU tensors take the plain version
(:mod:`.ref`); any other device raises.

``rg_lru_scan`` is differentiable (a ``torch.autograd.Function``).  With
``g`` the gradient of ``h`` and ``g_last`` that of ``h_last``, the
gradient of the state obeys

    dh_t = g_t + a_{t+1} * dh_{t+1},     dh_{T-1} = g_{T-1} + g_last,

the same first-order linear recurrence run backwards in time, so
:func:`rg_lru_scan_backward` runs it through the same route on
time-reversed inputs (on the card the same kernel, counted in
``kernel.backward_launches``), then ``da_t = dh_t * h_{t-1}`` (``h_{-1}
= h0``), ``db_t = dh_t`` and ``dh0 = a_0 * dh_0``.  The JAX package
differentiates its ``lax.associative_scan``; the Pallas kernel has no
gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rg_lru_scan import kernel as _kernel
from repro_torch.kernels.rg_lru_scan.ref import lru_scan_ref


def _check(a, b, h0) -> None:
    if a.ndim != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                         a.shape[2]):
        raise ValueError(f"need a, b [B, T, W] and h0 [B, W], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")


def _scan(a, b, h0, *, backward: bool):
    dev = a.device.type
    if dev == "cuda":
        launch = _kernel.lru_scan_backward if backward else _kernel.lru_scan
        return launch(a.contiguous(), b.contiguous(), h0.contiguous())
    if dev != "cpu":
        raise ValueError(f"rg_lru_scan runs on cuda or cpu, not {dev}")
    return lru_scan_ref(a, b, h0)


def rg_lru_scan_backward(a, h, h0, g, g_last):
    """``(da, db, dh0)`` of ``rg_lru_scan(a, b, h0) = (h, h_last)`` for
    upstream gradients ``g [B, T, W]`` and ``g_last [B, W]``."""
    if a.shape[1] == 0:
        return torch.zeros_like(a), torch.zeros_like(a), g_last.clone()
    # coefficient of dh_{t+1} in dh_t, reversed in time; the first step
    # of the reversed scan carries g_last in with coefficient 1
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    dh_rev, _ = _scan(a_next.flip(1), g.flip(1), g_last, backward=True)
    dh = dh_rev.flip(1)
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    return dh * h_prev, dh, a[:, 0] * dh[:, 0]


class _LruScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _scan(a, b, h0, backward=False)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        return rg_lru_scan_backward(a, h, h0, g, g_last)


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """``(h [B, T, W], h_last [B, W])`` of ``h_t = a_t * h_{t-1} + b_t``
    for float32 ``a, b [B, T, W]`` and ``h0 [B, W]``; differentiable in
    all three."""
    _check(a, b, h0)
    return _LruScan.apply(a, b, h0)
