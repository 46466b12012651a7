"""TensorSpec input stand-ins for every (arch x shape) cell.

The port of ``repro.models.inputs``: ``input_specs(cfg, shape)`` returns
the batch tree each step function consumes, as shapes and dtypes, with no
allocation.  The modality frontends are stubs, as in the JAX package:
VLM cells carry precomputed anyres patch embeddings; audio cells carry
precomputed frame embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import sds


def _frontend_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    out = {}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = sds((b, cfg.frontend_positions, cfg.d_model),
                                  cfg.compute_dtype)
        out["patch_pos"] = sds((b, cfg.frontend_positions), torch.int32)
    if cfg.is_encoder_decoder:
        # the encoder consumes precomputed frames at the same sequence length
        out["enc_frames"] = sds((b, s, cfg.d_model), cfg.compute_dtype)
    return out


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return {"inputs": sds((b, s), torch.int32),
            "labels": sds((b, s), torch.int32),
            **_frontend_specs(cfg, b, s)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return {"inputs": sds((b, s), torch.int32), **_frontend_specs(cfg, b, s)}


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {"token": sds((b, 1), torch.int32), "pos": sds((b,), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape)
    if shape.kind == "decode":
        return decode_batch_specs(cfg, shape)
    raise ValueError(shape.kind)
