"""Entry point of the attention kernel: ``flash_attention``.

The port of ``repro.kernels.flash_attention.ops``, in the same
``[B, T, H, D]`` / ``[B, S, K, D]`` layout.  The route follows the
tensors' device: CUDA tensors go through the hand-written kernel
(:func:`.kernel.flash_attention_fwd`) or raise; CPU tensors take the
plain version (:mod:`.ref`); any other device raises.  The TPU wrapper's
``block_q`` / ``block_k`` tiling and its padding to tile multiples have
no counterpart: the CUDA kernel's tiles are fixed and it masks the
ragged tail itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, T, H, D]; k, v: [B, S, K, D] (GQA: H = K * group).

    Causal masking keeps key s for query t when s <= t; a ``window`` w > 0
    also drops keys with t - s >= w."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"need q [B, T, H, D] and k, v [B, S, K, D] with H "
                         f"a multiple of K, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    dev = q.device.type
    if dev == "cuda":
        return _kernel.flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window)
    if dev != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    return flash_attention_ref(q, k, v, causal=causal, window=window)
