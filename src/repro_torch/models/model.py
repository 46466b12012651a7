"""Unified model API: the port of ``repro.models.model``.

    param_shapes(cfg)                   -> TensorSpec tree
    init_params(cfg, generator, device) -> concrete params
    loss_fn(params, batch, ...)         -> (loss, metrics)     [training]
    prefill(params, batch, ...)         -> (last_logits, cache)
    decode_step(params, cache, token, pos, ...) -> (logits, cache)
    init_cache(cfg, batch, seq, ...)    -> zeroed decode cache
    forward(params, batch, ...)         -> (logits, aux_loss)

Parameters are a nested dict of tensors with the JAX tree's paths and
leaf shapes.  ``loss_fn`` is differentiable with autograd: the training
step (``repro_torch.train.step``) takes its gradient.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.models.losses import cross_entropy, fused_cross_entropy
from repro_torch.parallel.sharding import NO_PARALLEL, ParallelConfig


def param_shapes(cfg: ModelConfig):
    return transformer.shapes(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                *, keep=None):
    """Parameters from ``generator`` on ``device`` (default CUDA);
    ``keep(path, leaf)`` replaces each leaf as it is made
    (``common.materialize``)."""
    return common.materialize(transformer.shapes(cfg), generator,
                              resolve_device(device), keep=keep)


def cache_shapes(cfg: ModelConfig, batch: int, seq: int, *,
                 cross_len: int = 0):
    return transformer.cache_shapes(cfg, batch, seq, cross_len=cross_len)


def init_cache(cfg: ModelConfig, batch: int, seq: int, *, cross_len: int = 0,
               device=None):
    """A zeroed decode cache on ``device`` (default CUDA); an
    encoder-decoder's holds ``cross_len`` rows of cross K / V a layer."""
    return transformer.init_cache(cfg, batch, seq, cross_len=cross_len,
                                  device=resolve_device(device))


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def _stack_gather(gather, prefix: str):
    """A unit's gather for ``stack_apply`` from a mesh step's ``gather``
    (None without one)."""
    return None if gather is None else partial(gather, prefix=prefix,
                                               unit=True)


def _gathered(params, batch: dict, gather, *, cfg):
    """``params`` with every leaf outside the layer stacks whole, through
    a mesh step's ``gather`` (``sharded.BlockGather``), and the stacks'
    blocks as they are (``stack_apply`` gathers them a unit at a time);
    a frontend the batch does not reach is left out.  ``params`` itself
    without a gather."""
    if gather is None:
        return params
    skip = {"blocks", "encoder"}
    if cfg.frontend == "vision_patches" and "patch_embeds" not in batch:
        skip.add("frontend")
    out = gather({k: v for k, v in params.items() if k not in skip})
    out["blocks"] = params["blocks"]
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"blocks": enc["blocks"], **gather(
            {"final_norm": enc["final_norm"]}, prefix="encoder")}
    return out


def _encode(params, frames, *, cfg, pcfg, gather=None):
    """The encoder memory ``[B, F, d]`` of ``frames [B, F, d]``: the frame
    projection, the encoder stack (non-causal) and its final norm."""
    x = transformer.project_frames(params, frames, cfg=cfg, pcfg=pcfg)
    enc = params["encoder"]
    x, _, _ = transformer.stack_apply(
        enc["blocks"], x, cfg=cfg, pcfg=pcfg,
        positions=_positions(x[..., 0]), mode="encode",   # [B, F]
        n_groups=cfg.n_enc_layers // cfg.pattern_len,
        gather=_stack_gather(gather, "encoder/blocks"))
    return common.rms_norm(x, enc["final_norm"]["scale"], cfg.norm_eps)


def _embed_and_memory(params, batch: dict, *, cfg, pcfg, gather=None):
    """The token embeddings, with vision patches spliced in where the
    batch carries them, and the encoder memory of an encoder-decoder's
    ``enc_frames`` (else None)."""
    x = transformer.embed(params, batch["inputs"], cfg=cfg, pcfg=pcfg)
    if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
        x = transformer.splice_patches(params, x, batch["patch_embeds"],
                                       batch["patch_pos"], cfg=cfg, pcfg=pcfg)
    memory = None
    if cfg.is_encoder_decoder:
        memory = _encode(params, batch["enc_frames"], cfg=cfg, pcfg=pcfg,
                         gather=gather)
    return x, memory


def _backbone(params, batch: dict, *, cfg: ModelConfig,
              pcfg: ParallelConfig, mode: str, gather=None):
    """Embed + frontends + stack. Returns (pre-head hiddens, aux)."""
    x, memory = _embed_and_memory(params, batch, cfg=cfg, pcfg=pcfg,
                                  gather=gather)
    x, _, aux = transformer.stack_apply(
        params["blocks"], x, cfg=cfg, pcfg=pcfg,
        positions=_positions(batch["inputs"]), mode=mode, memory=memory,
        gather=_stack_gather(gather, "blocks"))
    return x, aux


def forward(params, batch: dict, *, cfg: ModelConfig,
            pcfg: ParallelConfig = NO_PARALLEL, mode: str = "train",
            gather=None):
    """Full-sequence forward. Returns (logits, aux_loss): the logits
    ``[B, T, Vp]``, or on a mesh where the vocabulary splits over
    ``model`` (``transformer.vocab_split``) this rank's ``[B, T, Vp / M]``
    block of them."""
    params = _gathered(params, batch, gather, cfg=cfg)
    x, aux = _backbone(params, batch, cfg=cfg, pcfg=pcfg, mode=mode,
                       gather=gather)
    logits = transformer.lm_logits(params, x, cfg=cfg, pcfg=pcfg)
    return logits, aux


def loss_fn(params, batch: dict, *, cfg: ModelConfig,
            pcfg: ParallelConfig = NO_PARALLEL, gather=None):
    """Training loss of ``batch`` (``inputs``, ``labels`` [B, T] int32,
    -1 = ignore). Returns (loss, metrics).  With ``pcfg.fused_head`` (and
    no logit soft-cap) the head and the cross-entropy run chunk by chunk
    (``fused_cross_entropy``); otherwise over materialised logits.

    ``gather`` (port-only; a mesh train step's ``sharded.BlockGather``)
    takes ``params`` as this rank's blocks: the leaves outside the
    stacks are gathered whole here, once (the head's and a
    ``vocab_parallel`` table's over the batch axes alone: the rank's
    block of the vocabulary), and each pattern unit inside
    ``transformer.stack_apply``.  Without it ``params`` are whole.

    Where the vocabulary splits over ``model`` (``transformer.
    vocab_split``) the head and both cross-entropies run on this rank's
    block of it (``losses``), every ``model`` rank computing the same
    loss."""
    vmesh = None if transformer.vocab_split(cfg, pcfg) is None \
        else pcfg.mesh
    if pcfg.fused_head and not cfg.logit_softcap:
        params = _gathered(params, batch, gather, cfg=cfg)
        x, aux = _backbone(params, batch, cfg=cfg, pcfg=pcfg, mode="train",
                           gather=gather)
        x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        loss, metrics = fused_cross_entropy(
            x, transformer.head_weight(params, cfg, pcfg), batch["labels"],
            real_vocab=cfg.vocab_size, transpose_w=cfg.tie_embeddings,
            chunk=pcfg.head_chunk, unroll=pcfg.unroll_scans, mesh=vmesh)
    else:
        logits, aux = forward(params, batch, cfg=cfg, pcfg=pcfg,
                              mode="train", gather=gather)
        loss, metrics = cross_entropy(logits, batch["labels"],
                                      real_vocab=cfg.vocab_size, mesh=vmesh)
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def prefill(params, batch: dict, *, cfg: ModelConfig,
            pcfg: ParallelConfig = NO_PARALLEL, max_len: int = 0):
    """Run the prompt, build the decode cache (capacity ``max_len``; a
    stack without attention layers, as the xLSTM's, holds O(1) recurrent
    state and leaves ``max_len`` unused).  ``batch`` carries ``inputs``
    and, by the config, ``enc_frames`` (an encoder-decoder: the cache
    then holds the memory's cross K / V) or ``patch_embeds`` /
    ``patch_pos`` (vision patches, optional).

    Under ``layout="tp"`` on a mesh (the serving mesh, ``train/step.py``
    ``make_prefill_step``) ``params`` are a rank's serving parameters,
    the cache is the rank's ``model`` block of each leaf
    (``cache_specs_for``) and the logits the rank's block of the
    vocabulary where it splits (``transformer.vocab_split``).

    Returns (last_logits, cache)."""
    tokens = batch["inputs"]
    S = tokens.shape[1]
    max_len = max_len or S
    x, memory = _embed_and_memory(params, batch, cfg=cfg, pcfg=pcfg)
    x, new_caches, _ = transformer.stack_apply(
        params["blocks"], x, cfg=cfg, pcfg=pcfg,
        positions=_positions(tokens), mode="prefill", memory=memory,
        max_len=max_len)
    logits = transformer.lm_logits(params, x[:, -1:, :], cfg=cfg, pcfg=pcfg)
    return logits[:, 0], new_caches


def decode_step(params, cache, token, pos, *, cfg: ModelConfig,
                pcfg: ParallelConfig = NO_PARALLEL, max_len: int = 0):
    """One decode step. token: [B,1] int32; pos: [B] int32.  ``max_len``
    (the cache's capacity, port-only; required on a serving mesh, where
    ``train/step.py`` ``make_decode_step`` passes it) tells the mesh's
    attention whether a cache of whole kv heads is whole or a block of
    the sequence (``attention._whole_cache``).

    Returns (logits [B, Vp], new_cache); on a mesh where the vocabulary
    splits, the rank's ``[B, Vp / M]`` block of the logits.
    """
    x = transformer.embed(params, token, cfg=cfg, pcfg=pcfg)
    x, new_caches, _ = transformer.stack_apply(
        params["blocks"], x, cfg=cfg, pcfg=pcfg, positions=pos[:, None],
        mode="decode", caches=cache, max_len=max_len)
    logits = transformer.lm_logits(params, x, cfg=cfg, pcfg=pcfg)
    return logits[:, 0], new_caches
