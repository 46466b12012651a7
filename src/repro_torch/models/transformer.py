"""The layer stack: ``n_groups`` repetitions of the config's pattern unit.

The port of ``repro.models.transformer`` for the layer kinds the serving
path runs: ``A`` (global attention + FFN), ``L`` (sliding-window
attention + FFN) and ``R`` (RG-LRU recurrent block + FFN).  The mLSTM /
sLSTM blocks (``m``, ``s``), MoE FFNs, encoder-decoder stacks and the
vision / audio frontends raise ``NotImplementedError``: they wait in
``ROADMAP.md`` queue 1 (the rest of the LM stack).

Parameters (and decode caches / recurrent states) for the unit are
stacked with a leading group dim, as in the JAX package, so the two
trees match path for path; the stack runs as a Python loop over the
groups (the JAX package's ``lax.scan``), each unit under the config's
remat policy when autograd records (``_remat_wrap``).

Cache tree mirrors the param tree: ``{"layer<i>": {...}}`` per unit
position, leaves stacked over groups. Attention layers hold KV (full or
ring) caches; recurrent layers hold their O(1) state.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, mlp, rglru
from repro_torch.models.common import rms_norm, sds, soft_cap
from repro_torch.parallel.sharding import ParallelConfig, batch_spec, constrain
from repro_torch.utils.pytree import tree_map, tree_map_with_path

SUPPORTED_LAYERS = ("A", "L", "R")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's stack does not
    run yet."""
    missing = []
    if any(sym not in SUPPORTED_LAYERS for sym in cfg.block_pattern):
        missing.append(f"layer kinds {sorted(set(cfg.block_pattern))}")
    if cfg.family == "moe":
        missing.append("MoE FFNs")
    if cfg.is_encoder_decoder:
        missing.append("encoder-decoder stacks")
    if cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported yet; the port "
            f"runs {'/'.join(SUPPORTED_LAYERS)} layers (ROADMAP.md queue 1)")


# ---------------------------------------------------------------------------
# Parameter shapes
# ---------------------------------------------------------------------------

def _unit_shapes(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    d = cfg.d_model
    unit = {}
    for i, sym in enumerate(cfg.block_pattern):
        if sym in ("A", "L"):
            layer = {
                "norm1": {"scale": sds((d,), pd)},
                "attn": attention.shapes(cfg),
                "norm2": {"scale": sds((d,), pd)},
                "mlp": mlp.shapes(cfg),
            }
        else:  # "R"
            layer = {
                "norm1": {"scale": sds((d,), pd)},
                "rglru": rglru.shapes(cfg),
                "norm2": {"scale": sds((d,), pd)},
                "mlp": mlp.shapes(cfg),
            }
        unit[f"layer{i}"] = layer
    return unit


def _stack_groups(unit_tree, n_groups: int):
    return tree_map(lambda s: sds((n_groups,) + s.shape, s.dtype), unit_tree)


def shapes(cfg: ModelConfig) -> dict:
    """Full parameter tree (as TensorSpecs)."""
    check_supported(cfg)
    pd = cfg.param_dtype
    d, vp = cfg.d_model, cfg.padded_vocab
    out = {
        "embed": {"w": sds((vp, d), pd)},
        "blocks": _stack_groups(_unit_shapes(cfg), cfg.n_groups),
        "final_norm": {"scale": sds((d,), pd)},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": sds((d, vp), pd)}
    return out


# ---------------------------------------------------------------------------
# Decode cache / recurrent state shapes
# ---------------------------------------------------------------------------

def _unit_cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    unit = {}
    for i, sym in enumerate(cfg.block_pattern):
        if sym in ("A", "L"):
            ring = sym == "L" and cfg.local_window and cfg.local_window < seq
            layer = {"attn": attention.cache_shapes(
                cfg, batch, seq, ring=ring, window=cfg.local_window)}
        else:  # "R"
            layer = {"rec": rglru.state_shapes(cfg, batch)}
        unit[f"layer{i}"] = layer
    return unit


def cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    check_supported(cfg)
    return _stack_groups(_unit_cache_shapes(cfg, batch, seq), cfg.n_groups)


def init_cache(cfg: ModelConfig, batch: int, seq: int, *, device=None):
    """A zeroed decode cache on ``device`` (default CUDA, raising without
    it)."""
    return _zero_state(cache_shapes(cfg, batch, seq), resolve_device(device))


# ---------------------------------------------------------------------------
# Unit application
# ---------------------------------------------------------------------------

def _zero_state(shape_tree, device):
    def init(path, s):
        if s.dtype == torch.int32:
            return torch.full(s.shape, -1, dtype=s.dtype, device=device)
        if path.split("/")[-1] == "m":  # log-space stabilisers: -inf-ish
            return torch.full(s.shape, -1e30, dtype=s.dtype, device=device)
        return torch.zeros(s.shape, dtype=s.dtype, device=device)

    return tree_map_with_path(init, shape_tree)


def _unit_apply(unit_params, x, *, cfg: ModelConfig, pcfg: ParallelConfig,
                positions, mode: str, unit_cache=None, max_len: int = 0):
    """Apply one pattern unit. Returns (x, new_cache, aux_loss); the aux
    loss is zero: it comes from MoE FFNs, not ported yet."""
    eps = cfg.norm_eps
    B = x.shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    collect = mode == "prefill" or unit_cache is not None
    new_cache = {} if collect else None

    def rec_state(i):
        if unit_cache is not None:
            return unit_cache[f"layer{i}"]["rec"]
        if mode != "prefill":
            return None
        return _zero_state(rglru.state_shapes(cfg, B), x.device)

    for i, sym in enumerate(cfg.block_pattern):
        lp = unit_params[f"layer{i}"]
        lc = unit_cache[f"layer{i}"] if unit_cache is not None else None
        if sym in ("A", "L"):
            h = rms_norm(x, lp["norm1"]["scale"], eps)
            out, attn_cache = attention.apply(
                lp["attn"], h, cfg=cfg, pcfg=pcfg, layer_sym=sym,
                positions=positions, mode=mode, max_len=max_len,
                cache=lc["attn"] if lc is not None else None)
            x = x + out
            h = rms_norm(x, lp["norm2"]["scale"], eps)
            x = x + mlp.apply(lp["mlp"], h, cfg=cfg, pcfg=pcfg)
            if new_cache is not None:
                new_cache[f"layer{i}"] = {
                    "attn": attn_cache if attn_cache is not None
                    else lc["attn"]}
        else:  # "R"
            h = rms_norm(x, lp["norm1"]["scale"], eps)
            out, st = rglru.apply(lp["rglru"], h, cfg=cfg,
                                  state=rec_state(i),
                                  chunk=pcfg.lru_chunk,
                                  unroll=pcfg.unroll_scans)
            x = x + out
            h = rms_norm(x, lp["norm2"]["scale"], eps)
            x = x + mlp.apply(lp["mlp"], h, cfg=cfg, pcfg=pcfg)
            if new_cache is not None:
                new_cache[f"layer{i}"] = {"rec": st}
        x = constrain(x, pcfg, batch_spec(pcfg, None, None))
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Stack application (a loop over groups)
# ---------------------------------------------------------------------------

# matrix products without batch dims: what JAX's
# ``dots_with_no_batch_dims_saveable`` keeps (``x @ W`` lowers to ``mm``;
# the batched products of attention and the block-diagonal gates do not)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, pcfg: ParallelConfig, mode: str):
    """``fn`` under the remat policy: ``"none"`` keeps every activation;
    ``"full"`` keeps only the unit's inputs and recomputes the rest in
    backward (non-reentrant ``torch.utils.checkpoint``, the JAX package's
    ``nothing_saveable``); ``"dots"`` keeps the outputs of matrix products
    as well (selective checkpointing).  As ``jax.checkpoint`` only acts on
    differentiated code, the wrapper runs ``fn`` plainly when autograd
    does not record (inference, ``no_grad``)."""
    if pcfg.remat == "none":
        return fn
    if pcfg.remat == "full":
        kw = {}
    elif pcfg.remat == "dots":
        kw = {"context_fn": partial(create_selective_checkpoint_contexts,
                                    _save_dots)}
    else:
        raise ValueError(pcfg.remat)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def stack_apply(blocks_params, x, *, cfg: ModelConfig, pcfg: ParallelConfig,
                positions, mode: str, caches=None,
                n_groups: Optional[int] = None, max_len: int = 0):
    """Run the full stack. Returns (x, new_caches, aux).

    ``caches`` is required for decode, ignored for train, and unused for
    prefill (prefill builds fresh caches of capacity ``max_len``).  The
    new caches are stacked over groups, as the JAX package's scan emits
    them; ``aux`` sums the units' aux losses (zero without MoE).
    """
    n_groups = n_groups or cfg.n_groups
    emit_cache = mode == "prefill" or caches is not None

    def body(h, unit_params, unit_cache):
        return _unit_apply(unit_params, h, cfg=cfg, pcfg=pcfg,
                           positions=positions, mode=mode,
                           unit_cache=unit_cache, max_len=max_len)

    body = _remat_wrap(body, pcfg, mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    for g in range(n_groups):
        unit = tree_map(lambda a: a[g], blocks_params)
        unit_cache = (None if caches is None
                      else tree_map(lambda a: a[g], caches))
        x, nc, aux_g = body(x, unit, unit_cache)
        aux = aux + aux_g
        outs.append(nc)
    if not emit_cache:
        return x, None, aux
    return x, tree_map(lambda *ys: torch.stack(ys), *outs), aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed(params, tokens, *, cfg: ModelConfig, pcfg: ParallelConfig):
    ct = getattr(torch, cfg.compute_dtype)
    w = params["embed"]["w"]
    x = w[tokens.long()].to(ct)
    if cfg.embed_scale:
        # sqrt(d_model) is rounded to the compute dtype first, as in the
        # JAX package (bf16: sqrt(2560) = 50.596 becomes 50.5)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=ct,
                             device=x.device)
    return constrain(x, pcfg, batch_spec(pcfg, None, None))


def lm_logits(params, x, *, cfg: ModelConfig, pcfg: ParallelConfig):
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, params["embed"]["w"])
    else:
        logits = x @ params["lm_head"]["w"]
    logits = soft_cap(logits, cfg.logit_softcap)
    return constrain(logits, pcfg, batch_spec(pcfg, None, "model"))
