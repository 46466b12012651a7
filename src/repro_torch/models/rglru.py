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

Under ``layout="tp"`` on a mesh whose ``model`` size divides the LRU
width (:func:`lru_split`), ``p`` holds this rank's blocks of ``in_x``,
``in_g``, ``conv_w`` and ``a_param`` (a contiguous slice ``[s, e)`` of
the width) and of ``out`` (its rows), the recurrent state its slice of
``h`` and ``conv``: every op but the two gates is elementwise over the
width, so the rank runs the conv, ``rg_lru_scan`` and the gating on its
slice ``[B, T, W / model]`` and the partial products through its rows of
``out`` are summed over ``model`` (``sharded.reduce_from_model``).  The
gates are block-diagonal over ``N_GATE_BLOCKS`` blocks, and the JAX rule
for ``gate_a`` / ``gate_x`` (``P(None, None, "model")``) splits the
output columns of every block, not the blocks, so those two leaves come
whole (gathered over ``model`` as well) and their gradient is summed
over ``model`` (``sharded.copy_to_model``), so each rank's whole
gradient is the layer's.  Where ``model`` divides ``N_GATE_BLOCKS`` the
rank's slice is whole blocks, and it applies them to its own slice of
the conv output.  Elsewhere a block spans several ranks (``model = 16``)
or a slice crosses blocks (``model = 5``): the rank all-gathers the conv
output over ``model`` (``sharded.all_gather``, whose backward
reduce-scatters: each rank's gradient of the gathered whole covers the
blocks it used, and their sum is each slice's whole gradient), keeps the
blocks its slice touches (:func:`gate_span`) and applies them, keeping
its own columns (:func:`rank_gate_columns`).
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
    return _recur(p, x, block_diag_apply(p["gate_a"], x),
                  block_diag_apply(p["gate_x"], x), h0)


def _recur(p, x, gate_a, gate_x, h0):
    """The RG-LRU from the gates' products ``gate_a`` / ``gate_x``
    (``[B, T, W]``, before the sigmoid) of the conv output ``x``."""
    r = torch.sigmoid(gate_a.float())
    i = torch.sigmoid(gate_x.float())
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
    (``sharding.tp_block`` of the width), else None: the layer computes
    whole."""
    return tp_block(pcfg, cfg.lru_width or cfg.d_model)


def gate_span(width: int, index: int, size: int) -> Tuple[int, int]:
    """The gate blocks ``[b0, b1)`` that hold rank ``index``'s columns
    ``[index W / size, (index + 1) W / size)`` of the width ``W``."""
    block, n = width // N_GATE_BLOCKS, width // size
    return index * n // block, -(-(index + 1) * n // block)


def rank_gate_columns(xb: torch.Tensor, w: torch.Tensor, index: int,
                      size: int) -> torch.Tensor:
    """Rank ``index``'s columns of ``block_diag_apply({"w": w}, x)`` (of
    ``size`` equal slices of the width): ``w`` is the whole gate leaf
    ``[N_GATE_BLOCKS, W / 8, W / 8]`` and ``xb`` the whole blocks of the
    conv output ``x`` that :func:`gate_span` names, ``[..., (b1 - b0) W
    / 8]``."""
    width = w.shape[0] * w.shape[1]
    b0, b1 = gate_span(width, index, size)
    y = block_diag_apply({"w": w[b0:b1]}, xb)
    n = width // size
    start = index * n - b0 * w.shape[1]
    return y[..., start:start + n]


def _split_gates(p, xc, mesh, split):
    """The products of the two gates on this rank's slice ``xc`` of the
    conv output (the module doc): the rank's columns of the blocks its
    slice touches, from ``xc`` itself where ``model`` divides
    ``N_GATE_BLOCKS`` (the slice is whole blocks), else from the conv
    output gathered over ``model``."""
    index, size = split
    gates = [sharded.copy_to_model(p[name]["w"], mesh)
             for name in ("gate_a", "gate_x")]
    xb = xc
    if N_GATE_BLOCKS % size:
        width = xc.shape[-1] * size
        b0, b1 = gate_span(width, index, size)
        block = width // N_GATE_BLOCKS
        whole = sharded.all_gather(xc.movedim(-1, 0).contiguous(), mesh,
                                   ("model",))           # [W, B, T]
        # the touched blocks alone, a tensor of their own: the gathered
        # whole is not kept for the backward
        xb = whole[b0 * block:b1 * block].movedim(0, -1).contiguous()
        del whole
    return [rank_gate_columns(xb, w, index, size) for w in gates]


def apply(p, x, *, cfg: ModelConfig, state=None, chunk: int = 0,
          unroll: bool = False, pcfg: ParallelConfig = NO_PARALLEL):
    """Full Griffin recurrent block. x: [B,T,d] -> (out, new_state | None);
    on a ``tp`` mesh on this rank's slice of the width (module doc).
    ``chunk`` and ``unroll`` change nothing (:func:`_lru`)."""
    split = lru_split(cfg, pcfg)
    if split is not None:
        x = sharded.copy_to_model(x, pcfg.mesh)
    branch = x @ p["in_x"]
    gate = F.gelu((x @ p["in_g"]).float(), approximate="tanh").to(x.dtype)
    if state is None:
        xc, new_conv = common.causal_conv1d(branch, p["conv_w"]), None
        h0 = torch.zeros(xc.shape[::2], dtype=torch.float32,
                         device=x.device)
    else:
        xc, new_conv = common.causal_conv1d(branch, p["conv_w"],
                                            state["conv"])
        h0 = state["h"]
    if split is None:
        y, h_t = _lru(p, xc, h0, chunk=chunk, unroll=unroll)
    else:
        y, h_t = _recur(p, xc, *_split_gates(p, xc, pcfg.mesh, split), h0)
    out = (y * gate) @ p["out"]
    if split is not None:
        out = sharded.reduce_from_model(out, pcfg.mesh)
    return out, None if state is None else {"h": h_t, "conv": new_conv}
