"""Gated FFN (SwiGLU / GeGLU): the port of ``repro.models.mlp``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, sds
from repro_torch.parallel.sharding import ParallelConfig, batch_spec, constrain


def shapes(cfg: ModelConfig, width: int | None = None) -> dict:
    pd = cfg.param_dtype
    f = width or cfg.d_ff
    return {
        "wi": sds((cfg.d_model, f), pd),
        "wg": sds((cfg.d_model, f), pd),
        "wo": sds((f, cfg.d_model), pd),
    }


def apply(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
          pcfg: ParallelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    h = act(x @ params["wg"]) * (x @ params["wi"])
    h = constrain(h, pcfg, batch_spec(pcfg, None, "model"))
    return h @ params["wo"]
