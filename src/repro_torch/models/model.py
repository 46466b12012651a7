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

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.models.losses import cross_entropy, fused_cross_entropy
from repro_torch.parallel.sharding import NO_PARALLEL, ParallelConfig


def param_shapes(cfg: ModelConfig):
    return transformer.shapes(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Parameters from ``generator`` on ``device`` (default CUDA)."""
    return common.materialize(transformer.shapes(cfg), generator,
                              resolve_device(device))


def cache_shapes(cfg: ModelConfig, batch: int, seq: int):
    return transformer.cache_shapes(cfg, batch, seq)


def init_cache(cfg: ModelConfig, batch: int, seq: int, *, device=None):
    """A zeroed decode cache on ``device`` (default CUDA)."""
    return transformer.init_cache(cfg, batch, seq,
                                  device=resolve_device(device))


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def _backbone(params, batch: dict, *, cfg: ModelConfig,
              pcfg: ParallelConfig, mode: str):
    """Embed + stack. Returns (pre-head hiddens, aux)."""
    tokens = batch["inputs"]
    x = transformer.embed(params, tokens, cfg=cfg, pcfg=pcfg)
    x, _, aux = transformer.stack_apply(
        params["blocks"], x, cfg=cfg, pcfg=pcfg,
        positions=_positions(tokens), mode=mode)
    return x, aux


def forward(params, batch: dict, *, cfg: ModelConfig,
            pcfg: ParallelConfig = NO_PARALLEL, mode: str = "train"):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    x, aux = _backbone(params, batch, cfg=cfg, pcfg=pcfg, mode=mode)
    logits = transformer.lm_logits(params, x, cfg=cfg, pcfg=pcfg)
    return logits, aux


def loss_fn(params, batch: dict, *, cfg: ModelConfig,
            pcfg: ParallelConfig = NO_PARALLEL):
    """Training loss of ``batch`` (``inputs``, ``labels`` [B, T] int32,
    -1 = ignore). Returns (loss, metrics).  With ``pcfg.fused_head`` (and
    no logit soft-cap) the head and the cross-entropy run chunk by chunk
    (``fused_cross_entropy``); otherwise over materialised logits."""
    if pcfg.fused_head and not cfg.logit_softcap:
        x, aux = _backbone(params, batch, cfg=cfg, pcfg=pcfg, mode="train")
        x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        tied = cfg.tie_embeddings
        w = params["embed"]["w"] if tied else params["lm_head"]["w"]
        loss, metrics = fused_cross_entropy(
            x, w, batch["labels"], real_vocab=cfg.vocab_size,
            transpose_w=tied, chunk=pcfg.head_chunk,
            unroll=pcfg.unroll_scans)
    else:
        logits, aux = forward(params, batch, cfg=cfg, pcfg=pcfg,
                              mode="train")
        loss, metrics = cross_entropy(logits, batch["labels"],
                                      real_vocab=cfg.vocab_size)
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def prefill(params, batch: dict, *, cfg: ModelConfig,
            pcfg: ParallelConfig = NO_PARALLEL, max_len: int = 0):
    """Run the prompt, build the decode cache (capacity ``max_len``).

    Returns (last_logits, cache)."""
    tokens = batch["inputs"]
    S = tokens.shape[1]
    max_len = max_len or S
    x = transformer.embed(params, tokens, cfg=cfg, pcfg=pcfg)
    x, new_caches, _ = transformer.stack_apply(
        params["blocks"], x, cfg=cfg, pcfg=pcfg,
        positions=_positions(tokens), mode="prefill", max_len=max_len)
    logits = transformer.lm_logits(params, x[:, -1:, :], cfg=cfg, pcfg=pcfg)
    return logits[:, 0], new_caches


def decode_step(params, cache, token, pos, *, cfg: ModelConfig,
                pcfg: ParallelConfig = NO_PARALLEL):
    """One decode step. token: [B,1] int32; pos: [B] int32.

    Returns (logits [B, Vp], new_cache).
    """
    x = transformer.embed(params, token, cfg=cfg, pcfg=pcfg)
    x, new_caches, _ = transformer.stack_apply(
        params["blocks"], x, cfg=cfg, pcfg=pcfg, positions=pos[:, None],
        mode="decode", caches=cache)
    logits = transformer.lm_logits(params, x, cfg=cfg, pcfg=pcfg)
    return logits[:, 0], new_caches
