"""Gated FFN (SwiGLU / GeGLU): the port of ``repro.models.mlp``.

Under ``layout="tp"`` on a mesh whose ``model`` size divides ``d_ff``
(``sharding.tp_block``, where the JAX package's activation spec splits
the hidden dim over ``model``), ``params`` are this rank's blocks: the
column blocks of ``wi`` / ``wg`` and the row block of ``wo``.  The rank
computes its hidden columns and the partial product through its rows of
``wo``, and the partial outputs are summed over ``model``
(``sharded.reduce_from_model``, in the compute type, as XLA sums the
row-split product); the input enters through ``sharded.copy_to_model``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, sds
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import (ParallelConfig, batch_spec,
                                           constrain, tp_block)


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
    split = tp_block(pcfg, cfg.d_ff)
    if split is not None:
        x = sharded.copy_to_model(x, pcfg.mesh)
    act = activation(cfg.act)
    h = act(x @ params["wg"]) * (x @ params["wi"])
    h = constrain(h, pcfg, batch_spec(pcfg, None, "model"))
    out = h @ params["wo"]
    if split is not None:
        out = sharded.reduce_from_model(out, pcfg.mesh)
    return out
