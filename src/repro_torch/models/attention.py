"""GQA attention: flash-kernel prefill + cached decode.

The port of ``repro.models.attention``.  The JAX package gives
``chunked_attention`` three lowerings of one numerics contract: ``scan``,
``rect``, ``triangular`` (XLA loop choices over q / kv chunks) and
``pallas`` (the flash-attention TPU kernel).  Here every attention in
prefill, training or an encoder goes through one op,
``repro_torch.kernels.flash_attention``: the hand-written CUDA kernel
for tensors on the card, whatever ``attn_impl`` says, and its plain
version on the CPU.  That covers the causal self-attention, the
encoder's non-causal self-attention (``mode="encode"``) and the
decoder's cross-attention over the encoder memory (``memory_kv``: queries
and keys of different lengths, no mask), which the JAX package runs
through its ``scan`` lowering alone.  ``attn_impl`` is kept and
validated; ``q_chunk`` / ``kv_chunk`` are accepted and unused (the kernel
has its own tiles).  Numerics: the plain version keeps p float32 in the
product with V, as the TPU kernel does; the bf16 CUDA kernel rounds it
to V's type first, as the JAX ``scan`` lowering does.

Decode attends a single query against a **full cache** ([B, S, K, D],
positions implicit) or a **ring cache** ([B, W, K, D] plus an explicit
``kpos`` slot-position array) for windowed layers, in plain torch, as
the JAX package computes it outside any kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common
from repro_torch.models.common import sds, soft_cap
from repro_torch.parallel.sharding import ParallelConfig, constrain, heads_spec

NEG_INF = -1e30
ATTN_IMPLS = ("scan", "rect", "triangular", "pallas")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def shapes(cfg: ModelConfig, *, cross: bool = False) -> dict:
    pd = cfg.param_dtype
    d = cfg.d_model
    out = {
        "wq": sds((d, cfg.q_dim), pd),
        "wk": sds((d, cfg.kv_dim), pd),
        "wv": sds((d, cfg.kv_dim), pd),
        "wo": sds((cfg.q_dim, d), pd),
    }
    if cfg.qkv_bias:
        out["bq"] = sds((cfg.q_dim,), pd)
        out["bk"] = sds((cfg.kv_dim,), pd)
        out["bv"] = sds((cfg.kv_dim,), pd)
    if cfg.qk_norm:
        out["q_norm"] = sds((cfg.d_head,), pd)
        out["k_norm"] = sds((cfg.d_head,), pd)
    return out


def _project_q(p, x, cfg: ModelConfig):
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(x.shape[:-1] + (cfg.n_heads, cfg.d_head))
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(p, x, cfg: ModelConfig):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(x.shape[:-1] + (cfg.n_kv_heads, cfg.d_head))
    v = v.reshape(x.shape[:-1] + (cfg.n_kv_heads, cfg.d_head))
    if cfg.qk_norm:
        k = common.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# Prefill / training attention
# ---------------------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_chunk: int = 2048,
    kv_chunk: int = 2048,
    impl: str = "scan",
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention of q over k / v through the ``flash_attention`` op.

    On the card every ``impl`` reaches the CUDA kernel; on the CPU the
    op's plain version.  The kernel, like the TPU kernel, takes no score
    soft-cap and starts the queries at position 0, so a nonzero
    ``softcap`` or ``q_offset`` raises on every device (no shipped config
    sets ``attn_softcap``; prefill starts at 0)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; one of {ATTN_IMPLS}")
    if softcap:
        raise NotImplementedError(
            "attention soft-capping: the flash_attention kernel takes none")
    if q_offset:
        raise NotImplementedError(
            "q_offset: the flash_attention kernel starts queries at 0")
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, seq: int, *, ring: bool,
                 window: int = 0) -> dict:
    """Decode cache for one attention layer (compute dtype)."""
    ct = cfg.compute_dtype
    slots = min(window, seq) if ring and window else seq
    out = {
        "k": sds((batch, slots, cfg.n_kv_heads, cfg.d_head), ct),
        "v": sds((batch, slots, cfg.n_kv_heads, cfg.d_head), ct),
    }
    if ring and window and window < seq:
        out["kpos"] = sds((batch, slots), torch.int32)
    return out


def _zero(spec, device) -> torch.Tensor:
    """Zeros, or -1 for int32 leaves (an empty ring slot)."""
    if spec.dtype == torch.int32:
        return torch.full(spec.shape, -1, dtype=spec.dtype, device=device)
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def init_cache(cfg, batch, seq, *, ring, window=0, device=None):
    """A zeroed cache on ``device`` (default CUDA, raising without it)."""
    tree = cache_shapes(cfg, batch, seq, ring=ring, window=window)
    device = resolve_device(device)
    return {name: _zero(spec, device) for name, spec in tree.items()}


def _masked_write(buf, new, slot):
    """buf: [B,S,...], new: [B,1,...], slot: [B] int32 — an elementwise
    select over the whole cache, as the JAX package's shardable update."""
    onehot = torch.arange(buf.shape[1], device=buf.device)[None, :] \
        == slot[:, None]  # [B,S]
    oh = onehot.reshape(onehot.shape + (1,) * (buf.ndim - 2))
    return torch.where(oh, new.to(buf.dtype), buf)


def _scatter_write(buf, new, slot):
    """One-slot update: a copy of the cache with only the written slot
    changed (the JAX package's per-sample dynamic_update_slice)."""
    out = buf.clone()
    out[torch.arange(buf.shape[0], device=buf.device), slot.long()] = \
        new[:, 0].to(buf.dtype)
    return out


def update_cache(cache: dict, k_new, v_new, pos, mode: str = "masked"):
    """Append one token (k/v: [B,1,K,D]) at ``pos`` ([B] int32)."""
    write = _scatter_write if mode == "scatter" else _masked_write
    is_ring = "kpos" in cache
    slots = cache["k"].shape[1]
    slot = (pos % slots) if is_ring else pos
    out = dict(cache)
    out["k"] = write(cache["k"], k_new, slot)
    out["v"] = write(cache["v"], v_new, slot)
    if is_ring:
        out["kpos"] = write(cache["kpos"][..., None],
                            pos[:, None, None], slot)[..., 0]
    return out


def decode_attention(q, cache: dict, pos, *, window: int = 0,
                     softcap: float = 0.0):
    """q: [B,1,H,D] against cache; returns [B,1,H,D]."""
    B, _, H, D = q.shape
    k, v = cache["k"], cache["v"]
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, K, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if softcap:
        s = soft_cap(s, softcap)
    pos_b = pos[:, None]
    if "kpos" in cache:
        kpos = cache["kpos"]  # [B,S] true positions, -1 = empty
        valid = (kpos >= 0) & (kpos <= pos_b)
    else:
        kpos = torch.arange(S, device=q.device)[None, :]
        valid = kpos <= pos_b
    if window:
        valid = valid & (pos_b - kpos < window)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Layer-level apply
# ---------------------------------------------------------------------------

def apply(
    params: dict,
    x: torch.Tensor,                   # [B, T, d_model]
    *,
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    layer_sym: str,                    # "A" | "L"
    positions: torch.Tensor,           # [B, T] (or [B] for decode)
    mode: str,                         # "train" | "prefill" | "decode"
                                       # | "encode"
    cache: Optional[dict] = None,
    memory_kv: Optional[tuple] = None, # cross-attention (k, v) from encoder
    max_len: int = 0,                  # prefill: decode-cache capacity
):
    """Returns (out [B,T,d_model], new_cache).

    ``mode="encode"`` is an encoder-decoder model's encoder: non-causal
    self-attention with RoPE and no cache.  With ``memory_kv`` the layer
    is a cross-attention over the encoder memory's ``(k, v)`` ``[B, F, K,
    D]``: no RoPE on q (the memory's K / V carry none either), every
    memory row attended; at decode the cached memory, with the cache
    passed through unchanged."""
    is_local = layer_sym == "L"
    window = cfg.local_window if is_local else 0
    theta = cfg.rope_theta
    if is_local and getattr(cfg, "rope_theta_local", 0):
        theta = cfg.rope_theta_local
    cross = memory_kv is not None

    q = _project_q(params, x, cfg)
    if not cross:
        q = common.apply_rope(q, positions, theta)
    q = constrain(q, pcfg, heads_spec(pcfg, cfg.n_heads, batch_dims=2))

    if cross:
        k, v = memory_kv
        if mode == "decode":
            last = torch.full((x.shape[0],), k.shape[1] - 1,
                              dtype=torch.int32, device=x.device)
            out = decode_attention(q, {"k": k, "v": v}, last,
                                   softcap=cfg.attn_softcap)
            new_cache = cache
        else:
            out = chunked_attention(q, k, v, causal=False,
                                    q_chunk=pcfg.q_chunk,
                                    kv_chunk=pcfg.kv_chunk, impl="scan",
                                    softcap=cfg.attn_softcap)
            new_cache = None
    else:
        k_new, v_new = _project_kv(params, x, cfg)
        k_new = common.apply_rope(k_new, positions, theta)
        if mode == "decode":
            new_cache = update_cache(cache, k_new, v_new, positions[:, 0],
                                     mode=pcfg.cache_write)
            out = decode_attention(q, new_cache, positions[:, 0],
                                   window=window, softcap=cfg.attn_softcap)
        else:
            # the JAX package's mask takes the window only with causal
            causal = not (cfg.is_encoder_decoder and mode == "encode")
            out = chunked_attention(
                q, k_new, v_new, causal=causal,
                window=window if causal else 0,
                q_chunk=pcfg.q_chunk, kv_chunk=pcfg.kv_chunk,
                impl=pcfg.attn_impl if causal else "scan",
                softcap=cfg.attn_softcap)
            new_cache = None
            if mode == "prefill":
                new_cache = _prefill_cache(k_new, v_new, positions,
                                           window=window,
                                           max_len=max_len or k_new.shape[1])

    B, T = x.shape[0], x.shape[1]
    out = out.reshape(B, T, cfg.q_dim)
    return out @ params["wo"], new_cache


def _prefill_cache(k, v, positions, *, window, max_len):
    """Build the decode cache from prefill K/V.

    Full-attention layers get a [B, max_len, K, D] cache (prompt K/V in the
    first S slots); local layers get a ring of ``window`` slots.
    """
    S = k.shape[1]
    if window and window < max_len:
        # keep the last ``window`` positions, laid out ring-consistently:
        # true position p lives at slot p % window.
        last_pos = positions[:, -window:]
        slot = (last_pos % window).long()  # [B, W]
        B = k.shape[0]
        bidx = torch.arange(B, device=k.device)[:, None]

        def ring_scatter(buf):
            out = torch.zeros((B, window) + buf.shape[2:], dtype=buf.dtype,
                              device=buf.device)
            out[bidx, slot] = buf
            return out
        cache = {"k": ring_scatter(k[:, -window:]),
                 "v": ring_scatter(v[:, -window:])}
        kp = torch.full((B, window), -1, dtype=torch.int32, device=k.device)
        kp[bidx, slot] = last_pos.to(torch.int32)
        cache["kpos"] = kp
        return cache
    if max_len > S:
        pad = (0, 0, 0, 0, 0, max_len - S)
        k = F.pad(k, pad)
        v = F.pad(v, pad)
    return {"k": k, "v": v}
