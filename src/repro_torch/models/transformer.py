"""The layer stack: ``n_groups`` repetitions of the config's pattern unit.

The port of ``repro.models.transformer``: ``A`` (global attention +
FFN), ``L`` (sliding-window attention + FFN), ``R`` (RG-LRU recurrent
block + FFN), ``m`` (mLSTM block) and ``s`` (sLSTM block); in the
``moe`` family every ``A`` / ``L`` layer's FFN is the MoE FFN
(``models/moe.py``), whose load-balancing losses the stack sums into
``aux``.  An encoder-decoder config adds an ``encoder`` stack (run with
``mode="encode"``: non-causal self-attention) and, in each decoder
attention layer, a cross-attention block (``norm_x``, ``xattn``) over
the encoder memory, whose projected K / V the decode cache keeps
(``xk`` / ``xv``).  The modality frontends are the JAX package's stubs:
``project_frames`` (one linear map of precomputed audio frames) and
``splice_patches`` (a two-layer projector of precomputed vision patches,
spliced into the token stream).  Under ``layout="tp"`` on a mesh the
attention (the encoder's and the cross blocks' too), dense-FFN, RG-LRU,
mLSTM, sLSTM and MoE layers of both stacks compute on this rank's block
of their heads, columns, LRU width or experts where ``model`` divides
them (their modules say how), else whole, their recurrent states with
them (:func:`rec_split`); a cross block's K / V are projected on the
rank's kv heads (``attention.project_memory``).  Where ``model`` divides
the padded vocabulary (:func:`vocab_split`) the LM head computes the
rank's block of the logits (:func:`lm_logits`), and
``embed_mode="vocab_parallel"`` looks the tokens up in the rank's block
of the table, summed over ``model`` (:func:`embed`).  Where ``model``
divides ``d_model`` (:func:`frontend_split`) the frontends compute on
the rank's columns of ``w1``.

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
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, mlp, moe, rglru, xlstm
from repro_torch.models.common import rms_norm, sds, soft_cap
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import (ParallelConfig, batch_spec,
                                           constrain, tp_block)
from repro_torch.utils.pytree import tree_map, tree_map_with_path

# ---------------------------------------------------------------------------
# Parameter shapes
# ---------------------------------------------------------------------------

def _unit_shapes(cfg: ModelConfig, *, decoder_cross: bool) -> dict:
    pd = cfg.param_dtype
    d = cfg.d_model
    unit = {}
    for i, sym in enumerate(cfg.block_pattern):
        if sym in ("A", "L"):
            layer = {
                "norm1": {"scale": sds((d,), pd)},
                "attn": attention.shapes(cfg),
                "norm2": {"scale": sds((d,), pd)},
            }
            if decoder_cross:
                layer["norm_x"] = {"scale": sds((d,), pd)}
                layer["xattn"] = attention.shapes(cfg, cross=True)
            if cfg.family == "moe":
                layer["moe"] = moe.shapes(cfg)
            else:
                layer["mlp"] = mlp.shapes(cfg)
        elif sym == "R":
            layer = {
                "norm1": {"scale": sds((d,), pd)},
                "rglru": rglru.shapes(cfg),
                "norm2": {"scale": sds((d,), pd)},
                "mlp": mlp.shapes(cfg),
            }
        elif sym == "m":
            layer = {"norm1": {"scale": sds((d,), pd)},
                     "mlstm": xlstm.mlstm_shapes(cfg)}
        elif sym == "s":
            layer = {"norm1": {"scale": sds((d,), pd)},
                     "slstm": xlstm.slstm_shapes(cfg)}
        else:
            raise ValueError(sym)
        unit[f"layer{i}"] = layer
    return unit


def _stack_groups(unit_tree, n_groups: int):
    return tree_map(lambda s: sds((n_groups,) + s.shape, s.dtype), unit_tree)


def shapes(cfg: ModelConfig) -> dict:
    """Full parameter tree (as TensorSpecs)."""
    pd = cfg.param_dtype
    d, vp = cfg.d_model, cfg.padded_vocab
    out = {
        "embed": {"w": sds((vp, d), pd)},
        "blocks": _stack_groups(
            _unit_shapes(cfg, decoder_cross=cfg.is_encoder_decoder),
            cfg.n_groups),
        "final_norm": {"scale": sds((d,), pd)},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": sds((d, vp), pd)}
    if cfg.is_encoder_decoder:       # the encoder has the decoder's dims
        out["encoder"] = {
            "blocks": _stack_groups(_unit_shapes(cfg, decoder_cross=False),
                                    cfg.n_enc_layers // cfg.pattern_len),
            "final_norm": {"scale": sds((d,), pd)},
        }
    if cfg.frontend == "vision_patches":
        out["frontend"] = {"w1": sds((d, d), pd), "w2": sds((d, d), pd)}
    elif cfg.frontend == "audio_frames":
        out["frontend"] = {"w1": sds((d, d), pd)}
    return out


# ---------------------------------------------------------------------------
# Decode cache / recurrent state shapes
# ---------------------------------------------------------------------------

_STATE_SHAPES = {"R": rglru.state_shapes, "m": xlstm.mlstm_state_shapes,
                 "s": xlstm.slstm_state_shapes}
# each recurrent layer's split under tp and the dim of each state leaf
# ([B, ...]) that it cuts: the LRU width; the mLSTM's heads (its conv's
# features); the sLSTM's features
_REC_SPLIT = {"R": (rglru.lru_split, {"h": -1, "conv": -1}),
              "m": (xlstm.head_split, {"C": 1, "n": 1, "m": 1, "conv": -1}),
              "s": (xlstm.head_split, dict.fromkeys("cnmh", -1))}


def rec_split(sym: str, cfg: ModelConfig, pcfg: ParallelConfig):
    """(the split of a recurrent layer ``sym``, ``(index, size)`` or None
    where it computes whole; {state leaf: the dim of its ``[B, ...]``
    shape that the split cuts into ``size`` blocks, the rank's the
    ``index``-th})."""
    split, dims = _REC_SPLIT[sym]
    return split(cfg, pcfg), dims


def _unit_cache_shapes(cfg: ModelConfig, batch: int, seq: int,
                       *, cross_len: int = 0) -> dict:
    unit = {}
    for i, sym in enumerate(cfg.block_pattern):
        if sym in ("A", "L"):
            ring = sym == "L" and cfg.local_window and cfg.local_window < seq
            layer = {"attn": attention.cache_shapes(
                cfg, batch, seq, ring=ring, window=cfg.local_window)}
            if cfg.is_encoder_decoder and cross_len:
                kv = sds((batch, cross_len, cfg.n_kv_heads, cfg.d_head),
                         cfg.compute_dtype)
                layer["xk"], layer["xv"] = kv, kv
        else:  # "R", "m", "s"
            layer = {"rec": _STATE_SHAPES[sym](cfg, batch)}
        unit[f"layer{i}"] = layer
    return unit


def cache_shapes(cfg: ModelConfig, batch: int, seq: int,
                 *, cross_len: int = 0) -> dict:
    """The decode cache; an encoder-decoder config's attention layers
    also hold the cross-attention K / V of ``cross_len`` memory rows
    (none when it is 0)."""
    return _stack_groups(
        _unit_cache_shapes(cfg, batch, seq, cross_len=cross_len),
        cfg.n_groups)


def init_cache(cfg: ModelConfig, batch: int, seq: int, *, cross_len: int = 0,
               device=None):
    """A zeroed decode cache on ``device`` (default CUDA, raising without
    it)."""
    return _zero_state(cache_shapes(cfg, batch, seq, cross_len=cross_len),
                       resolve_device(device))


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
                positions, mode: str, unit_cache=None, memory=None,
                max_len: int = 0):
    """Apply one pattern unit. Returns (x, new_cache, aux_loss); the aux
    loss sums the unit's MoE layers' (zero without MoE).  In an
    encoder-decoder's decoder, each attention layer adds a cross block
    over the encoder ``memory`` (train / prefill: projected here, and
    prefill keeps the projection as the cache's ``xk`` / ``xv``) or over
    the cached ``xk`` / ``xv`` (decode); a decode cache without them
    skips the block, as the JAX package does."""
    eps = cfg.norm_eps
    B = x.shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    collect = mode == "prefill" or unit_cache is not None
    new_cache = {} if collect else None

    def rec_state(i, sym):
        if unit_cache is not None:
            return unit_cache[f"layer{i}"]["rec"]
        if mode != "prefill":
            return None
        state = _zero_state(_STATE_SHAPES[sym](cfg, B), x.device)
        split, dims = rec_split(sym, cfg, pcfg)
        if split is not None:    # the rank's block
            index, size = split
            state = {k: v.chunk(size, dim=dims[k])[index].contiguous()
                     for k, v in state.items()}
        return state

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
            cross = cfg.is_encoder_decoder and mode != "encode" and (
                memory is not None or (lc is not None and "xk" in lc))
            if cross:
                hx = rms_norm(x, lp["norm_x"]["scale"], eps)
                if memory is not None:  # train / prefill: project fresh
                    mem_kv = attention.project_memory(lp["xattn"], memory,
                                                      cfg=cfg, pcfg=pcfg)
                else:                   # decode: cached cross K/V
                    mem_kv = (lc["xk"], lc["xv"])
                xout, _ = attention.apply(
                    lp["xattn"], hx, cfg=cfg, pcfg=pcfg, layer_sym="A",
                    positions=positions, mode=mode, memory_kv=mem_kv)
                x = x + xout
            h = rms_norm(x, lp["norm2"]["scale"], eps)
            if cfg.family == "moe":
                ffn, aux_i = moe.apply(lp["moe"], h, cfg=cfg, pcfg=pcfg)
                aux = aux + aux_i
            else:
                ffn = mlp.apply(lp["mlp"], h, cfg=cfg, pcfg=pcfg)
            x = x + ffn
            if new_cache is not None:
                layer_new = {"attn": attn_cache if attn_cache is not None
                             else lc["attn"]}
                if cross:
                    layer_new["xk"], layer_new["xv"] = mem_kv
                new_cache[f"layer{i}"] = layer_new
        elif sym == "R":
            h = rms_norm(x, lp["norm1"]["scale"], eps)
            out, st = rglru.apply(lp["rglru"], h, cfg=cfg,
                                  state=rec_state(i, sym),
                                  chunk=pcfg.lru_chunk,
                                  unroll=pcfg.unroll_scans, pcfg=pcfg)
            x = x + out
            h = rms_norm(x, lp["norm2"]["scale"], eps)
            x = x + mlp.apply(lp["mlp"], h, cfg=cfg, pcfg=pcfg)
            if new_cache is not None:
                new_cache[f"layer{i}"] = {"rec": st}
        else:  # "m", "s": one residual branch, no FFN of the stack's
            h = rms_norm(x, lp["norm1"]["scale"], eps)
            if sym == "m":
                out, st = xlstm.mlstm_apply(lp["mlstm"], h, cfg=cfg,
                                            state=rec_state(i, sym),
                                            unroll=pcfg.unroll_scans,
                                            pcfg=pcfg)
            else:
                out, st = xlstm.slstm_apply(lp["slstm"], h, cfg=cfg,
                                            state=rec_state(i, sym),
                                            pcfg=pcfg)
            x = x + out
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
                positions, mode: str, caches=None, memory=None,
                n_groups: Optional[int] = None, max_len: int = 0,
                gather: Optional[Callable] = None):
    """Run the full stack. Returns (x, new_caches, aux).

    ``caches`` is required for decode, ignored for train / encode, and
    unused for prefill (prefill builds fresh caches of capacity
    ``max_len``); ``memory`` is the encoder's output for a decoder's
    cross blocks, and ``n_groups`` the groups to run (default the
    config's: the decoder's).  The new caches are stacked over groups, as
    the JAX package's scan emits them; ``aux`` sums the units' aux losses
    (zero without MoE).

    ``gather`` (a mesh train step's, port-only) makes one unit's whole
    parameters from its slice of the stacked blocks; it runs inside the
    unit's remat wrapper, as XLA gathers inside the JAX package's scan
    body: under ``remat="full"`` the recompute gathers the unit again,
    no whole unit outlives its forward, and its whole gradient lives
    until its backward reduce-scatters it.  Under ``remat="none"``
    autograd keeps each gathered unit for the backward, as it keeps any
    activation, so every unit is whole until then.
    """
    n_groups = n_groups or cfg.n_groups
    emit_cache = mode == "prefill" or caches is not None

    def body(h, unit_params, unit_cache):
        if gather is not None:
            unit_params = gather(unit_params)
        return _unit_apply(unit_params, h, cfg=cfg, pcfg=pcfg,
                           positions=positions, mode=mode,
                           unit_cache=unit_cache, memory=memory,
                           max_len=max_len)

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
# Embedding / head / frontends
# ---------------------------------------------------------------------------

def vocab_split(cfg: ModelConfig, pcfg: ParallelConfig):
    """(this rank's coordinate along ``model``, the ``model`` size) where
    the vocabulary splits over ``model``: ``layout="tp"`` on a mesh of
    several ``model`` ranks whose size divides ``cfg.padded_vocab``
    (``sharding.tp_block``, as the JAX package's ``validate_spec`` keeps
    the logits' and the table's ``model`` axis there), else None."""
    return tp_block(pcfg, cfg.padded_vocab)


def vocab_rows(w: torch.Tensor, cfg: ModelConfig, pcfg: ParallelConfig,
               dim: int = 0) -> torch.Tensor:
    """This rank's block of the vocabulary along ``dim`` of ``w``: ``w``
    itself where it is already the block (a rank's parameters), else a
    view of its rows (columns) of the whole leaf."""
    split = vocab_split(cfg, pcfg)
    vp = cfg.padded_vocab
    if split is None or w.shape[dim] != vp:
        return w
    i, n = split
    return w.narrow(dim, i * (vp // n), vp // n)


def head_weight(params, cfg: ModelConfig, pcfg: ParallelConfig
                ) -> torch.Tensor:
    """The LM head's weights on this rank: the table's rows ``[Vp', d]``
    (tied) or ``lm_head/w``'s columns ``[d, Vp']``, ``Vp'`` the rank's
    block of the vocabulary where it splits (:func:`vocab_split`), else
    the whole.  A tied table kept whole for ``embed_mode="gather"``
    gives a view of its rows."""
    if cfg.tie_embeddings:
        return vocab_rows(params["embed"]["w"], cfg, pcfg, 0)
    return vocab_rows(params["lm_head"]["w"], cfg, pcfg, 1)


def embed(params, tokens, *, cfg: ModelConfig, pcfg: ParallelConfig):
    """The token embeddings.  ``embed_mode="gather"`` takes them from the
    whole table.  ``embed_mode="vocab_parallel"`` where the vocabulary
    splits (:func:`vocab_split`; else it acts as ``gather``, in both
    packages) is the JAX package's masked take: each ``model`` rank takes
    the tokens of its block of the table (relative index, clamped; zero
    elsewhere) in the compute type, and the rows are summed over
    ``model`` (``sharded.reduce_from_model``), equal to the gather bit
    for bit."""
    ct = getattr(torch, cfg.compute_dtype)
    w = params["embed"]["w"]
    split = vocab_split(cfg, pcfg)
    if pcfg.embed_mode == "vocab_parallel" and split is not None:
        w = vocab_rows(w, cfg, pcfg, 0)
        n = w.shape[0]
        rel = tokens.long() - split[0] * n
        mine = ((rel >= 0) & (rel < n))[..., None]
        x = w[rel.clamp(0, n - 1)].to(ct)
        # -0.0 elsewhere: the sum over model is the holder's row, bit for
        # bit (a zero of either sign included)
        x = sharded.reduce_from_model(
            torch.where(mine, x, torch.full_like(x, -0.0)), pcfg.mesh)
    else:
        x = w[tokens.long()].to(ct)
    if cfg.embed_scale:
        # sqrt(d_model) is rounded to the compute dtype first, as in the
        # JAX package (bf16: sqrt(2560) = 50.596 becomes 50.5)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=ct,
                             device=x.device)
    return constrain(x, pcfg, batch_spec(pcfg, None, None))


def frontend_split(cfg: ModelConfig, pcfg: ParallelConfig):
    """(this rank's coordinate along ``model``, the ``model`` size) where
    the frontends compute on the rank's columns of ``w1`` (the JAX spec's
    ``model`` block of ``frontend/w1``, ``sharding.tp_block`` of
    ``d_model``), else None: they compute whole."""
    return tp_block(pcfg, cfg.d_model)


def splice_patches(params, x, patch_embeds, patch_pos, *, cfg, pcfg):
    """Splice projected vision-patch embeddings into the token stream.

    ``x`` [B, S, d]; ``patch_embeds`` [B, P, d]; ``patch_pos`` [B, P],
    distinct positions in [0, S) (with duplicates the JAX package's
    scatter order is undefined).  The projector is ``gelu(e @ w1) @ w2``
    (tanh GELU) in the compute type, scaled as the embedding is; as in
    the JAX package, an int inverse-index map ([B, S], -1 where no patch
    lands) is scattered first and the projection gathered through it.
    Where :func:`frontend_split` splits it, ``w1`` is the rank's columns
    and ``w2`` comes whole (its JAX block is columns too), its gradient
    summed over ``model``: the rank's GELU columns go through its rows of
    ``w2`` and the partial products are summed over ``model``."""
    fp = params["frontend"]
    ct = getattr(torch, cfg.compute_dtype)
    split = frontend_split(cfg, pcfg)
    if split is not None:
        patch_embeds = sharded.copy_to_model(patch_embeds, pcfg.mesh)
    hid = torch.nn.functional.gelu(patch_embeds.to(ct) @ fp["w1"],
                                   approximate="tanh")
    if split is None:
        proj = hid @ fp["w2"]
    else:
        index, n = split[0], hid.shape[-1]
        w2 = sharded.copy_to_model(fp["w2"], pcfg.mesh)
        proj = sharded.reduce_from_model(hid @ w2[index * n:(index + 1) * n],
                                         pcfg.mesh)
    if cfg.embed_scale:
        proj = proj * torch.tensor(math.sqrt(cfg.d_model), dtype=ct,
                                   device=proj.device)
    B, S, _ = x.shape
    P_ = patch_pos.shape[1]
    b_idx = torch.arange(B, device=x.device)[:, None]
    inv = torch.full((B, S), -1, dtype=torch.int64, device=x.device)
    inv[b_idx, patch_pos.long()] = torch.arange(
        P_, device=x.device)[None].expand(B, P_)
    picked = torch.take_along_dim(proj.to(x.dtype),
                                  inv.clamp(0, P_ - 1)[..., None], dim=1)
    return torch.where((inv >= 0)[..., None], picked, x)


def project_frames(params, frames, *, cfg, pcfg):
    """Audio frontend stub: one linear projection over frame embeddings
    (cast to the compute type first).  Where :func:`frontend_split`
    splits it, the rank projects its columns of ``w1`` and gathers them
    over ``model`` for the encoder, which takes them whole
    (``sharded.gather_from_model``)."""
    ct = getattr(torch, cfg.compute_dtype)
    split = frontend_split(cfg, pcfg)
    if split is not None:
        frames = sharded.copy_to_model(frames, pcfg.mesh)
    x = frames.to(ct) @ params["frontend"]["w1"]
    if split is not None:
        x = sharded.gather_from_model(x, pcfg.mesh)
    return constrain(x, pcfg, batch_spec(pcfg, None, None))


def lm_logits(params, x, *, cfg: ModelConfig, pcfg: ParallelConfig):
    """The final norm and the head: ``[B, T, Vp]`` logits, or where the
    vocabulary splits (:func:`vocab_split`) this rank's ``[B, T, Vp / M]``
    block of them, ``x`` entering through ``sharded.copy_to_model`` (its
    gradient the sum of the ranks')."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if vocab_split(cfg, pcfg) is not None:
        x = sharded.copy_to_model(x, pcfg.mesh)
    w = head_weight(params, cfg, pcfg)
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, w)
    else:
        logits = x @ w
    logits = soft_cap(logits, cfg.logit_softcap)
    return constrain(logits, pcfg, batch_spec(pcfg, None, "model"))
