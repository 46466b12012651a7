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

**Tensor parallelism.**  Under ``layout="tp"`` on a mesh whose ``model``
size divides ``n_heads`` (``sharding.tp_block``: the test of the JAX
package's ``heads_spec``), the causal self-attention (train, prefill and
decode), the encoder's non-causal one and the decoder's cross-attention
run on this rank's block of the q heads: ``params`` hold the column
blocks of ``wq`` (``bq``) and the row block of ``wo``, the input enters
through ``sharded.copy_to_model`` and the partial products through the
rank's rows of ``wo`` are summed over ``model``
(``sharded.reduce_from_model``).  K and V: where ``model`` divides
``n_kv_heads`` the rank projects its own kv heads (the blocks of ``wk``
/ ``wv``; a cross block's from the memory, :func:`project_memory`, and
its decode reads the rank's ``xk`` / ``xv``); otherwise
(``recurrentgemma-2b``: one kv head) the leaves
come whole, gathered over ``model`` as XLA must, and every rank projects
K and V whole; the replicated leaves inside the layer (those and the
qk-norm scales) enter through ``copy_to_model``, so their gradient is
the sum over the ranks.  The decode cache is the rank's block of
``train/step.py``'s ``cache_specs_for``: its kv heads where they split,
else a block of the sequence, else (slots that do not split) whole, as
the JAX package's ``kv_cache_spec`` keeps it; decode over a whole cache
runs the rank's q heads over it with nothing summed.  Where ``model``
does not divide ``n_heads`` the layer computes whole on every rank, its
cache whole too, in training, prefill and decode alike.  Over a
sequence-split cache, decode computes what XLA's partitioner makes of
``decode_attention``: every rank's q heads
gathered, the row maximum reduced over ``model``, the exponentials of
the rank's block, their sum reduced, p normalised and rounded to V's
type, the rank's ``p V`` summed over ``model``; a block without a valid
key adds zeros.  The new token's K / V lands only in the block that owns
its slot.  ``kpos`` follows the spec's rule (split over the sequence
wherever the slots divide), also where K / V split heads (``gemma3-12b``'s
local layers): there decode all-gathers it over ``model`` first and
keeps the block of the updated one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common
from repro_torch.models.common import sds, soft_cap
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import (ParallelConfig, constrain,
                                           heads_spec, tp_block)

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


def _project_q(p, x, cfg: ModelConfig, n_heads: int = 0):
    """q of ``n_heads`` heads (default the config's; a tensor-parallel
    rank's block of ``wq`` holds fewer)."""
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(x.shape[:-1] + (n_heads or cfg.n_heads, cfg.d_head))
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(p, x, cfg: ModelConfig, n_kv_heads: int = 0):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    kv = n_kv_heads or cfg.n_kv_heads
    k = k.reshape(x.shape[:-1] + (kv, cfg.d_head))
    v = v.reshape(x.shape[:-1] + (kv, cfg.d_head))
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
    heads = tp_block(pcfg, cfg.n_heads)
    if heads is not None:
        return _apply_tp(params, x, heads, cfg=cfg, pcfg=pcfg, window=window,
                         theta=theta, positions=positions, mode=mode,
                         cache=cache, max_len=max_len, memory_kv=memory_kv)

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


# ---------------------------------------------------------------------------
# Tensor-parallel route (this rank's q heads; module doc)
# ---------------------------------------------------------------------------

def _seq_block(x, index: int, size: int, dim: int = 1):
    """Block ``index`` of ``size`` along ``dim``."""
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


def _gather_model(x, mesh, dim: int):
    """The ``model`` ranks' ``x`` concatenated along ``dim`` in rank order
    (no autograd: decode runs under inference)."""
    moved = x.movedim(dim, 0).contiguous()
    return sharded.gather_wire(moved, mesh, ("model",)).movedim(0, dim)


def _tp_kv_heads(k, v, cfg: ModelConfig, index: int, size: int):
    """The kv heads of this rank's q heads from whole ``k`` / ``v``: the
    one head of an MQA layer, else the head of each q head in turn."""
    if k.shape[2] == 1:
        return k, v
    hm = cfg.n_heads // size
    idx = torch.arange(index * hm, (index + 1) * hm, device=k.device) \
        // (cfg.n_heads // cfg.n_kv_heads)
    return k[:, :, idx], v[:, :, idx]


def _rank_kv_params(params, cfg: ModelConfig, pcfg: ParallelConfig,
                    names=("wk", "wv", "bk", "bv", "k_norm")):
    """(``params`` with the replicated leaves among ``names`` through
    ``copy_to_model``, this rank's kv head count): ``wk`` / ``wv`` (and
    their biases) are replicated where ``model`` does not divide the kv
    heads, the qk-norm scales always."""
    kv_split = tp_block(pcfg, cfg.n_kv_heads) is not None
    p = dict(params)
    for name in names:
        whole = name in ("q_norm", "k_norm") or not kv_split
        if name in params and whole:
            p[name] = sharded.copy_to_model(params[name], pcfg.mesh)
    return p, cfg.n_kv_heads // (pcfg.model_size if kv_split else 1)


def project_memory(params, memory, *, cfg: ModelConfig,
                   pcfg: ParallelConfig):
    """A cross block's K / V ``[B, F, K, D]`` of the encoder ``memory``:
    under ``layout="tp"`` where the q heads split over ``model``, the
    rank's kv heads (whole where they do not split), ``memory`` and the
    replicated leaves through ``copy_to_model``; else every kv head."""
    if tp_block(pcfg, cfg.n_heads) is None:
        return _project_kv(params, memory, cfg)
    p, km = _rank_kv_params(params, cfg, pcfg)
    return _project_kv(p, sharded.copy_to_model(memory, pcfg.mesh), cfg, km)


def _apply_tp(params, x, heads, *, cfg: ModelConfig, pcfg: ParallelConfig,
              window, theta, positions, mode, cache, max_len, memory_kv=None):
    mesh = pcfg.mesh
    index, size = heads
    hm = cfg.n_heads // size
    kv_split = tp_block(pcfg, cfg.n_kv_heads) is not None
    x = sharded.copy_to_model(x, mesh)
    B, T = x.shape[0], x.shape[1]
    if memory_kv is not None:
        # a cross block: K / V the memory's (project_memory), no RoPE
        p, _ = _rank_kv_params(params, cfg, pcfg, ("q_norm",))
        q = _project_q(p, x, cfg, hm)
        k, v = memory_kv if kv_split else \
            _tp_kv_heads(*memory_kv, cfg, index, size)
        if mode == "decode":
            last = torch.full((B,), k.shape[1] - 1, dtype=torch.int32,
                              device=x.device)
            out = decode_attention(q, {"k": k, "v": v}, last,
                                   softcap=cfg.attn_softcap)
        else:
            out = chunked_attention(q, k, v, causal=False,
                                    q_chunk=pcfg.q_chunk,
                                    kv_chunk=pcfg.kv_chunk, impl="scan",
                                    softcap=cfg.attn_softcap)
        out = out.reshape(B, T, hm * cfg.d_head) @ params["wo"]
        return sharded.reduce_from_model(out, mesh), \
            cache if mode == "decode" else None
    p, km = _rank_kv_params(params, cfg, pcfg, ("wk", "wv", "bk", "bv",
                                                 "q_norm", "k_norm"))
    q = common.apply_rope(_project_q(p, x, cfg, hm), positions, theta)
    k_new, v_new = _project_kv(p, x, cfg, km)
    k_new = common.apply_rope(k_new, positions, theta)
    if mode == "decode":
        out, new_cache = _decode_tp(q, k_new, v_new, cache, positions[:, 0],
                                    cfg=cfg, pcfg=pcfg, window=window,
                                    kv_split=kv_split, index=index,
                                    size=size, max_len=max_len)
    else:
        k, v = (k_new, v_new) if kv_split else \
            _tp_kv_heads(k_new, v_new, cfg, index, size)
        # the encoder's self-attention is non-causal, as in ``apply``
        causal = not (cfg.is_encoder_decoder and mode == "encode")
        out = chunked_attention(q, k, v, causal=causal,
                                window=window if causal else 0,
                                q_chunk=pcfg.q_chunk, kv_chunk=pcfg.kv_chunk,
                                impl=pcfg.attn_impl if causal else "scan",
                                softcap=cfg.attn_softcap)
        new_cache = None
        if mode == "prefill":
            new_cache = _prefill_cache(k_new, v_new, positions, window=window,
                                       max_len=max_len or k_new.shape[1])
            slots = new_cache["k"].shape[1]
            if not kv_split and slots % size == 0:
                new_cache["k"] = _seq_block(new_cache["k"], index, size)
                new_cache["v"] = _seq_block(new_cache["v"], index, size)
            if "kpos" in new_cache and slots % size == 0:
                new_cache["kpos"] = _seq_block(new_cache["kpos"], index, size)
            new_cache = {n: c.contiguous() for n, c in new_cache.items()}
    out = out.reshape(B, T, hm * cfg.d_head) @ params["wo"]
    return sharded.reduce_from_model(out, mesh), new_cache


def _whole_cache(cache, *, window, max_len, size) -> bool:
    """Whether a cache of whole kv heads is whole over ``model`` rather
    than this rank's block of the sequence: its slots (a ring's window,
    else ``max_len``, the cache's capacity) do not split over the
    ``size`` ranks, as :func:`_apply_tp`'s prefill built it."""
    slots = window if "kpos" in cache else max_len
    return slots % size != 0


def _decode_tp(q, k_new, v_new, cache, pos, *, cfg, pcfg, window, kv_split,
               index, size, max_len):
    """One decode step of this rank's q heads over its cache block."""
    mesh = pcfg.mesh
    if not kv_split and _whole_cache(cache, window=window, max_len=max_len,
                                     size=size):
        # whole K / V on every rank: this rank's q heads over their kv
        # heads, nothing summed over model
        new_cache = update_cache(cache, k_new, v_new, pos,
                                 mode=pcfg.cache_write)
        k, v = _tp_kv_heads(new_cache["k"], new_cache["v"], cfg, index, size)
        out = decode_attention(q, {**new_cache, "k": k, "v": v}, pos,
                               window=window, softcap=cfg.attn_softcap)
        return out, new_cache
    if kv_split:
        # the rank's kv heads, every slot; kpos (a ring's) perhaps a block
        # of the slots: whole for the step, the block kept
        cache = dict(cache)
        kp_split = "kpos" in cache \
            and cache["kpos"].shape[1] != cache["k"].shape[1]
        if kp_split:
            cache["kpos"] = _gather_model(cache["kpos"], mesh, 1)
        new_cache = update_cache(cache, k_new, v_new, pos,
                                 mode=pcfg.cache_write)
        out = decode_attention(q, new_cache, pos, window=window,
                               softcap=cfg.attn_softcap)
        if kp_split:
            new_cache["kpos"] = _seq_block(new_cache["kpos"], index,
                                           size).contiguous()
        return out, new_cache
    return _decode_seq_split(q, k_new, v_new, cache, pos, cfg=cfg,
                             pcfg=pcfg, window=window, index=index,
                             size=size)


def _decode_seq_split(q, k_new, v_new, cache, pos, *, cfg, pcfg, window,
                      index, size):
    mesh = pcfg.mesh
    k, v = cache["k"], cache["v"]
    sm = k.shape[1]
    lo = index * sm
    ring = "kpos" in cache
    slots = sm * size
    slot = (pos % slots) if ring else pos
    local = torch.where((slot >= lo) & (slot < lo + sm), slot - lo,
                        torch.full_like(slot, -1))
    new_cache = dict(cache)
    new_cache["k"] = _masked_write(k, k_new, local)
    new_cache["v"] = _masked_write(v, v_new, local)
    pos_b = pos[:, None]
    if ring:
        new_cache["kpos"] = _masked_write(cache["kpos"][..., None],
                                          pos[:, None, None], local)[..., 0]
        kpos = new_cache["kpos"]
        valid = (kpos >= 0) & (kpos <= pos_b)
    else:
        kpos = lo + torch.arange(sm, device=q.device)[None, :]
        valid = kpos <= pos_b
    if window:
        valid = valid & (pos_b - kpos < window)
    # every rank's q heads, then this block's share of the softmax
    q_all = _gather_model(q, mesh, 2)                     # [B, 1, H, D]
    B, _, H, D = q_all.shape
    K = k.shape[2]
    kk, vv = new_cache["k"], new_cache["v"]
    qg = q_all.reshape(B, 1, K, H // K, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), kk.float()) \
        * (1.0 / math.sqrt(D))
    if cfg.attn_softcap:
        s = soft_cap(s, cfg.attn_softcap)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    top = sharded.model_sum(s.amax(dim=-1, keepdim=True).contiguous(), mesh,
                            op=dist.ReduceOp.MAX)
    e = torch.exp(s - top)                # 0 where a key is not valid
    total = sharded.model_sum(e.sum(dim=-1, keepdim=True), mesh)
    p = (e / total).to(vv.dtype).float()
    out = torch.einsum("bkgts,bskd->btkgd", p, vv.float()).contiguous()
    out = sharded.model_sum(out, mesh).reshape(B, 1, H, D).to(q.dtype)
    hm = H // size
    return out[:, :, index * hm:(index + 1) * hm], new_cache
