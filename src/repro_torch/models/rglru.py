"""Griffin/RecurrentGemma recurrent block: conv1d + RG-LRU with gated branch.

The port of ``repro.models.rglru``.  RG-LRU (Real-Gated Linear Recurrent
Unit):

    r_t = sigmoid(gate_a(x_t))            recurrence gate (block-diag linear)
    i_t = sigmoid(gate_x(x_t))            input gate
    log a_t = -c * softplus(a_param) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates, ``a`` and ``b`` are computed in float32 exactly as the JAX
package computes them; the recurrence itself goes through the
``rg_lru_scan`` op (the CUDA kernel for tensors on the card, its plain
version on the CPU), in prefill over the whole prompt and in decode one
step at a time with the carried state.  The full residual block is
Griffin's:

    y = W_out( RG-LRU(conv1d(W_x x)) * gelu(W_g x) )

Under ``layout="tp"`` on a mesh whose ``model`` size divides both the
LRU width and ``N_GATE_BLOCKS`` (:func:`lru_split`), ``p`` holds this
rank's blocks of ``in_x``, ``in_g``, ``conv_w`` and ``a_param`` (a
contiguous slice of the width) and of ``out`` (its rows), the recurrent
state its slice of ``h`` and ``conv``: every op but the two gates is
elementwise over the width, so the rank runs the conv, the gates and
``rg_lru_scan`` on its slice ``[B, T, W / model]`` and the partial
products through its rows of ``out`` are summed over ``model``
(``sharded.reduce_from_model``).  The gates are block-diagonal over
``N_GATE_BLOCKS`` blocks, and the JAX rule for ``gate_a`` / ``gate_x``
(``P(None, None, "model")``) splits the output columns of every block,
not the blocks: the rank needs its ``N_GATE_BLOCKS / model`` whole
blocks, so those two leaves come whole (gathered over ``model`` as well)
and the rank takes its blocks; their gradient is summed over ``model``
(``sharded.copy_to_model``), so each rank's whole gradient is the
layer's.  A ``model`` size that divides the width but not
``N_GATE_BLOCKS`` would cut a block between ranks: there the layer
computes whole on every ``model`` rank, on whole leaves and a whole
state, as every rank computes the embedding, so each rank's gradient is
already the layer's and nothing is summed over ``model``.  A true split
of the gate columns is ROADMAP item 1.3f part 2.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rg_lru_scan import ops as lru_ops
from repro_torch.models import common
from repro_torch.models.common import block_diag_apply, block_diag_shapes, sds
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import NO_PARALLEL, ParallelConfig, tp_block

RGLRU_C = 8.0
N_GATE_BLOCKS = 8


def shapes(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "in_x": sds((d, w), pd),
        "in_g": sds((d, w), pd),
        "conv_w": sds((cfg.conv1d_width, w), pd),
        "gate_a": block_diag_shapes(N_GATE_BLOCKS, w, w // N_GATE_BLOCKS, pd),
        "gate_x": block_diag_shapes(N_GATE_BLOCKS, w, w // N_GATE_BLOCKS, pd),
        "a_param": sds((w,), torch.float32),
        "out": sds((w, d), pd),
    }


def state_shapes(cfg: ModelConfig, batch: int) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": sds((batch, w), torch.float32),
        "conv": sds((batch, cfg.conv1d_width - 1, w), cfg.compute_dtype),
    }


def _lru(p, x, h0, *, chunk: int = 0, unroll: bool = False):
    """x: [B,T,W] (post-conv); h0: [B,W] fp32. Returns (y [B,T,W], h_T).

    ``chunk`` and ``unroll`` are accepted for the JAX package's signature
    and change nothing: there they bound the associative scan's memory,
    and the ``rg_lru_scan`` kernel holds one state per channel whatever
    ``T`` is.
    """
    r = torch.sigmoid(block_diag_apply(p["gate_a"], x).float())
    i = torch.sigmoid(block_diag_apply(p["gate_x"], x).float())
    log_a = -RGLRU_C * F.softplus(p["a_param"]) * r   # [B,T,W]
    a = torch.exp(log_a)
    gated = i * x.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    h, h_t = lru_ops.rg_lru_scan(a, b, h0.float())
    return h.to(x.dtype), h_t


def lru_split(cfg: ModelConfig, pcfg: ParallelConfig
              ) -> Optional[Tuple[int, int]]:
    """(this rank's coordinate along ``model``, the ``model`` size) where
    the layer computes on the rank's slice of the LRU width
    (``sharding.tp_block`` of the width, and a ``model`` size that
    divides ``N_GATE_BLOCKS``), else None: the layer computes whole."""
    split = tp_block(pcfg, cfg.lru_width or cfg.d_model)
    if split is None or N_GATE_BLOCKS % split[1]:
        return None
    return split


def _rank_gates(p, pcfg: ParallelConfig, split) -> dict:
    """``p`` with the gates cut to this rank's ``N_GATE_BLOCKS / model``
    blocks (the whole leaves through ``copy_to_model``)."""
    index, size = split
    k = N_GATE_BLOCKS // size
    out = dict(p)
    for name in ("gate_a", "gate_x"):
        w = sharded.copy_to_model(p[name]["w"], pcfg.mesh)
        out[name] = {"w": w[index * k:(index + 1) * k]}
    return out


def apply(p, x, *, cfg: ModelConfig, state=None, chunk: int = 0,
          unroll: bool = False, pcfg: ParallelConfig = NO_PARALLEL):
    """Full Griffin recurrent block. x: [B,T,d] -> (out, new_state | None);
    on a ``tp`` mesh on this rank's slice of the width (module doc)."""
    B, T, d = x.shape
    w = cfg.lru_width or d
    split = lru_split(cfg, pcfg)
    if split is not None:
        p = _rank_gates(p, pcfg, split)
        x = sharded.copy_to_model(x, pcfg.mesh)
        w //= split[1]
    out, new_state = _block(p, x, w, state, chunk, unroll)
    if split is not None:
        out = sharded.reduce_from_model(out, pcfg.mesh)
    return out, new_state


def _block(p, x, w, state, chunk, unroll):
    B = x.shape[0]
    branch = x @ p["in_x"]
    gate = F.gelu((x @ p["in_g"]).float(), approximate="tanh").to(x.dtype)
    if state is None:
        xc = common.causal_conv1d(branch, p["conv_w"])
        h0 = torch.zeros((B, w), dtype=torch.float32, device=x.device)
        y, _ = _lru(p, xc, h0, chunk=chunk, unroll=unroll)
        return (y * gate) @ p["out"], None
    xc, new_conv = common.causal_conv1d(branch, p["conv_w"], state["conv"])
    y, h_t = _lru(p, xc, state["h"], chunk=chunk, unroll=unroll)
    out = (y * gate) @ p["out"]
    return out, {"h": h_t, "conv": new_conv}
