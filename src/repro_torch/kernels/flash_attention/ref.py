"""Plain PyTorch version of the flash_attention kernel.

The same function as ``csrc/flash_attention.cu`` and the JAX package's
oracle (``repro.kernels.flash_attention.ref.attention_ref``): scores in
float32, causal and sliding-window masks as -1e30, a float32 softmax and
a float32 product with V, cast to the input type.  It materialises the
``[T, S]`` scores of every head.  The wrappers in :mod:`.ops` use it for
tensors on the CPU; on the card it is the yardstick the kernel is held
to, and then needs float32 matrix products in full precision
(``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [BHq, T, d]; k, v: [BHk, S, d]; GQA by head-group repetition."""
    bhq, T, d = q.shape
    bhk, S, _ = k.shape
    g = bhq // bhk
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) / math.sqrt(d)
    tpos = torch.arange(T, device=q.device)[:, None]
    spos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= spos <= tpos
    if window:
        mask &= tpos - spos < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """:func:`attention_ref` in the model's layout: q ``[B, T, H, D]``,
    k, v ``[B, S, K, D]``; returns ``[B, T, H, D]``."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2).reshape(B * H, T, D)
    kh = k.transpose(1, 2).reshape(B * K, S, D)
    vh = v.transpose(1, 2).reshape(B * K, S, D)
    out = attention_ref(qh, kh, vh, causal=causal, window=window)
    return out.reshape(B, H, T, D).transpose(1, 2)
