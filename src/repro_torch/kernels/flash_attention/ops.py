"""Entry point of the attention kernel: ``flash_attention``, with its
gradient.

The port of ``repro.kernels.flash_attention.ops``, in the same
``[B, T, H, D]`` / ``[B, S, K, D]`` layout.  The route follows the
tensors' device: CUDA tensors go through the hand-written kernel
(:func:`.kernel.flash_attention_fwd`) or raise; CPU tensors take the
plain version (:mod:`.ref`); ``meta`` tensors (the dry run,
``launch/dryrun.py``) take the kernel's meta route
(:func:`.kernel.flash_attention_fwd`: the card's launch counted, no
work done); any other device raises.  The TPU wrapper's
``block_q`` / ``block_k`` tiling and its padding to tile multiples have
no counterpart: the CUDA kernel's tiles are fixed and it masks the
ragged tail itself.

``flash_attention`` is differentiable (a ``torch.autograd.Function``):
the backward (:func:`flash_attention_backward`) recomputes the plain
version (``ref.attention_ref``) one batch row at a time, so that the
``[H, T, S]`` float32 scores of one row are the most it holds, and
differentiates that.  It is the gradient of the function the plain
version computes, with p kept in float32; the bf16 kernel rounds p to
bf16 before the product with V, as the JAX model does.  The Pallas
kernel has no gradient (the JAX package trains through its XLA
``scan`` attention); a backward kernel is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _forward(q, k, v, causal, window):
    dev = q.device.type
    if dev in ("cuda", "meta"):
        return _kernel.flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window)
    if dev != "cpu":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{dev}")
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def flash_attention_backward(q, k, v, g, *, causal: bool, window: int):
    """``(dq, dk, dv)`` of ``flash_attention(q, k, v)`` for the upstream
    gradient ``g [B, T, H, D]``: the plain version recomputed and
    differentiated one batch row at a time."""
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    for i in range(q.shape[0]):
        with torch.enable_grad():
            row = tuple(x[i:i + 1].detach().requires_grad_()
                        for x in (q, k, v))
            out = flash_attention_ref(*row, causal=causal, window=window)
            for dst, src in zip(grads, torch.autograd.grad(
                    out, row, g[i:i + 1])):
                dst[i:i + 1] = src
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, g, causal=ctx.causal,
                                          window=ctx.window), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, T, H, D]; k, v: [B, S, K, D] (GQA: H = K * group).

    Causal masking keeps key s for query t when s <= t; a ``window`` w > 0
    also drops keys with t - s >= w.  Differentiable in q, k and v."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"need q [B, T, H, D] and k, v [B, S, K, D] with H "
                         f"a multiple of K, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _FlashAttention.apply(q, k, v, causal, window)
