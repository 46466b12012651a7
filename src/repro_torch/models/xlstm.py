"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM.

The port of ``repro.models.xlstm``, in plain torch (the JAX package has
no kernel here: its chunk and step are plain XLA).  mLSTM (matrix-memory
LSTM) is a gated linear-attention RNN:

    C_t = exp(logsig f_t) C_{t-1} + exp(i_t) k_t v_t^T
    n_t = exp(logsig f_t) n_{t-1} + exp(i_t) k_t
    h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t))

with a log-space stabiliser m_t.  Prefill and training use the
**chunkwise-parallel** form (an intra-chunk ``[L, L]`` attention matrix
and an inter-chunk state carried by a Python loop over the chunks, the
JAX package's ``lax.scan``); decode uses the O(1) recurrent step, and the
sequential form is the test oracle of the chunkwise one.

sLSTM has a true nonlinear recurrence (h feeds back through the gates),
so it runs token by token (a Python loop, the JAX package's
``lax.scan``) with block-diagonal recurrent weights, one block per head.

Every float32 island of the JAX package is kept: the gate products over
``qkv`` cast to float32 with float32 gate weights, the chunk and decode
math, the sLSTM pre-activations and its whole recurrence; ``h`` goes back
to the input's dtype before ``out_norm``.

Under ``layout="tp"`` on a mesh whose ``model`` size divides the heads
(:func:`head_split`) both blocks compute on this rank's contiguous block
of heads, the JAX package's specs' blocks of their features:

* the mLSTM: ``p`` holds the rank's features of ``conv_w``, of the
  block-diagonal ``q`` / ``k`` / ``v`` (whole blocks), of ``out_norm``
  and ``down``'s rows.  ``up``, ``igate`` and ``fgate`` come whole (their
  JAX blocks, halves of ``[xm | z]`` and thirds of ``qkv``, do not line
  up with heads).  The rank takes its heads' ``xm`` and ``z`` columns of
  ``up``, whose gradient is summed over ``model``
  (``sharded.copy_to_model``).  The gates mix every head's features
  into each head's gate, and a random-weight stack amplifies the
  rounding of a sum of the ranks' partial products into the gates'
  log-space stabiliser: the ranks gather ``q`` / ``k`` / ``v`` over
  ``model`` in the compute type (``sharded.gather_from_model``, a
  ``[B, T, 3 inner / model]`` block a rank) and compute the gate
  products alike, bit for bit the whole layer's, then keep their
  heads' gates (:func:`_head_gates`).  The chunks and the decode step
  run on ``[B, T, H / model, dh]``; ``out_norm``'s mean square is the
  sum over ``model`` of the ranks' sums (``reduce_from_model``, then
  ``copy_to_model``), and the partial products through ``down``'s rows
  are summed over ``model``.
* the sLSTM: ``p`` holds the rank's columns of ``w_i/f/z/o`` and its
  features of ``b_*``; ``r_*`` comes whole (its JAX spec splits every
  head's columns) and the rank takes its heads' blocks.  The token loop
  runs on ``[B, d / model]`` with no collective a step; ``h`` is then
  gathered over ``model`` (``sharded.gather_from_model``, whose backward
  keeps the rank's columns) for ``out_norm`` and the FFN, which the JAX
  specs keep whole and every rank computes alike.

The recurrent states are the rank's heads' (``C``, ``n``, ``m``) and
features (``conv``; the sLSTM's ``c``, ``n``, ``m``, ``h``).  Where
``model`` does not divide the heads, both blocks compute whole on every
``model`` rank, on whole leaves and states.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import block_diag_apply, block_diag_shapes, sds
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import NO_PARALLEL, ParallelConfig, tp_block

CHUNK = 256  # mLSTM chunk length for the chunkwise-parallel form


def _inner(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def head_split(cfg: ModelConfig, pcfg: ParallelConfig
               ) -> Optional[Tuple[int, int]]:
    """(this rank's coordinate along ``model``, the ``model`` size) where
    the mLSTM and sLSTM compute on the rank's block of heads
    (``sharding.tp_block`` of the heads, and a ``model`` size that
    divides the mLSTM's ``q`` / ``k`` / ``v`` blocks, as the JAX spec
    splits them), else None: they compute whole."""
    split = tp_block(pcfg, cfg.n_heads)
    if split is None or (_inner(cfg) // cfg.mlstm_qkv_blocksize) % split[1]:
        return None
    return split


def split_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   mesh) -> torch.Tensor:
    """``common.rms_norm`` over a width whose ``model`` blocks the ranks
    hold: ``x`` and ``scale`` are this rank's columns, and the mean
    square is the sum over ``model`` of the ranks' sums of squares
    (``reduce_from_model``, then ``copy_to_model``: each rank's sum
    feeds every rank's columns, so its gradient is their sum)."""
    dt = x.dtype
    x = x.float()
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    sq = sharded.copy_to_model(sharded.reduce_from_model(sq, mesh), mesh)
    var = sq / (x.shape[-1] * mesh.axes_size("model"))
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_shapes(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    d, inner = cfg.d_model, _inner(cfg)
    bs = cfg.mlstm_qkv_blocksize
    h = cfg.n_heads
    return {
        "up": sds((d, 2 * inner), pd),
        "conv_w": sds((cfg.conv1d_width, inner), pd),
        "q": block_diag_shapes(inner // bs, inner, bs, pd),
        "k": block_diag_shapes(inner // bs, inner, bs, pd),
        "v": block_diag_shapes(inner // bs, inner, bs, pd),
        "igate": {"w": sds((3 * inner, h), torch.float32),
                  "b": sds((h,), torch.float32)},
        "fgate": {"w": sds((3 * inner, h), torch.float32),
                  "b": sds((h,), torch.float32)},
        "out_norm": sds((inner,), pd),
        "down": sds((inner, d), pd),
    }


def mlstm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    inner = _inner(cfg)
    h = cfg.n_heads
    dh = inner // h
    return {
        "C": sds((batch, h, dh, dh), torch.float32),
        "n": sds((batch, h, dh), torch.float32),
        "m": sds((batch, h), torch.float32),
        "conv": sds((batch, cfg.conv1d_width - 1, inner), cfg.compute_dtype),
    }


def _mlstm_qkv_gates(p, x, cfg: ModelConfig, conv_state=None,
                     split=None, mesh=None):
    """x: [B,T,d] -> q,k,v [B,T,H,dh], i/f raw gates [B,T,H], z [B,T,inner];
    on a ``split`` (:func:`head_split`) the rank's heads' (module doc)."""
    inner = _inner(cfg)
    h = cfg.n_heads
    dh = inner // h
    if split is None:
        xm, z = torch.chunk(x @ p["up"], 2, dim=-1)
    else:
        index, size = split
        x = sharded.copy_to_model(x, mesh)
        up = sharded.copy_to_model(p["up"], mesh)
        n = inner // size
        xm = x @ up[:, index * n:(index + 1) * n]
        z = x @ up[:, inner + index * n:inner + (index + 1) * n]
        h //= size
    if conv_state is None:
        xc = common.causal_conv1d(xm, p["conv_w"])
        new_conv = None
    else:
        xc, new_conv = common.causal_conv1d(xm, p["conv_w"], conv_state)
    xc = F.silu(xc)
    q = block_diag_apply(p["q"], xc)
    k = block_diag_apply(p["k"], xc) / math.sqrt(dh)
    v = block_diag_apply(p["v"], xm)
    if split is None:
        qkv = torch.cat([q, k, v], dim=-1).float()
        ig = qkv @ p["igate"]["w"] + p["igate"]["b"]  # [B,T,H]
        fg = qkv @ p["fgate"]["w"] + p["fgate"]["b"]
    else:
        ig, fg = _head_gates(p, q, k, v, split, mesh)
    shp = x.shape[:-1] + (h, dh)
    return (q.reshape(shp), k.reshape(shp), v.reshape(shp), ig, fg, z,
            new_conv)


def _head_gates(p, q, k, v, split, mesh):
    """The input and forget gates of this rank's heads from its ``q`` /
    ``k`` / ``v`` features (``[B, T, inner / model]`` each, the compute
    type): every rank's gathered over ``model`` into the whole ``qkv``
    (``sharded.gather_from_model``), whose gate products every rank
    computes alike, as the whole layer computes them, through
    ``copy_to_model`` (each rank's gradient is its heads' gates', and
    their sum is the whole one every rank then holds) before the rank
    takes its heads' gates."""
    index, size = split
    parts = sharded.gather_from_model(torch.stack([q, k, v], dim=-2), mesh)
    qkv = parts.reshape(parts.shape[:-2] + (-1,)).float()   # [q | k | v]
    g = torch.cat([qkv @ p[name]["w"] + p[name]["b"]
                   for name in ("igate", "fgate")], dim=-1)
    g = sharded.copy_to_model(g, mesh)
    H = g.shape[-1] // 2
    n = H // size
    return (g[..., index * n:(index + 1) * n],
            g[..., H + index * n:H + (index + 1) * n])


def _mlstm_out(p, h, z, dtype, cfg: ModelConfig, split, mesh):
    """``out_norm``, the ``z`` gate and ``down`` on ``h`` ``[B, T,
    inner]`` (the rank's heads' on a ``split``, summed over ``model``)."""
    if split is None:
        h = common.rms_norm(h.to(dtype), p["out_norm"], cfg.norm_eps)
    else:
        h = split_rms_norm(h.to(dtype), p["out_norm"], cfg.norm_eps, mesh)
    out = (h * F.silu(z)) @ p["down"]
    if split is not None:
        out = sharded.reduce_from_model(out, mesh)
    return out


def _mlstm_chunk(carry, qkvif):
    """One chunk of the chunkwise-parallel mLSTM. Shapes: q,k,v [B,L,H,dh];
    ig,fg [B,L,H]. Carry: C [B,H,dk,dv], n [B,H,dk], m [B,H]."""
    C, n, m = carry
    q, k, v, ig, fg = qkvif
    B, L, H, dh = q.shape
    logf = F.logsigmoid(fg.float())                        # [B,L,H]
    b = torch.cumsum(logf, dim=1)                          # inclusive cumsum
    i32 = ig.float()
    g = torch.cummax(i32 - b, dim=1).values                # running max of i-b
    m_t = b + torch.maximum(m[:, None], g)                 # [B,L,H]
    b_last = b[:, -1]

    qf = q.float().transpose(1, 2)                         # [B,H,L,dh]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)

    # intra-chunk: D[t,s] = exp(b_t - b_s + i_s - m_t) for s <= t
    bt = b.transpose(1, 2)                                 # [B,H,L]
    mt = m_t.transpose(1, 2)
    it = i32.transpose(1, 2)
    logD = bt[..., :, None] - bt[..., None, :] + it[..., None, :] \
        - mt[..., :, None]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    # masked before the exp: above the diagonal logD grows with the
    # chunk and overflows, and exp's gradient there (0 * inf) would be
    # NaN (the JAX package masks after the exp, and its gradient is NaN
    # from L = 64 on); the values are the same
    D = torch.exp(torch.where(tri, logD, -math.inf))      # [B,H,L,L]
    scores = (qf @ kf.transpose(-1, -2)) * D
    h_intra = scores @ vf
    den_intra = scores.sum(-1)                             # [B,H,L]

    # inter-chunk: contribution of carried state
    decay_in = torch.exp(m[:, None] + b - m_t).transpose(1, 2)  # [B,H,L]
    h_inter = (qf @ C) * decay_in[..., None]
    den_inter = torch.einsum("bhtd,bhd->bht", qf, n) * decay_in

    den = den_intra + den_inter
    h = (h_intra + h_inter) / torch.maximum(
        torch.abs(den), torch.exp(-mt))[..., None]

    # chunk-end state
    m_new = m_t[:, -1]                                     # [B,H]
    decay_state = torch.exp(m + b_last - m_new)            # [B,H]
    w_s = torch.exp(b_last[:, None] - b + i32 - m_new[:, None]) \
        .transpose(1, 2)                                   # [B,H,L]
    kw = kf * w_s[..., None]
    C_new = C * decay_state[..., None, None] + kw.transpose(-1, -2) @ vf
    n_new = n * decay_state[..., None] + kw.sum(2)
    return (C_new, n_new, m_new), h.transpose(1, 2)        # [B,L,H,dh]


def mlstm_apply(p, x, *, cfg: ModelConfig, state=None, unroll: bool = False,
                pcfg: ParallelConfig = NO_PARALLEL):
    """Full block. x: [B,T,d]. Returns (out [B,T,d], new_state | None);
    on a ``tp`` mesh on this rank's heads (module doc).

    The prompt runs in chunks of ``L``: ``CHUNK`` halved until it divides
    ``T`` (the JAX package's rule; the chunk length changes the rounding,
    and a prompt of odd length runs in chunks of one token).  ``unroll``
    is accepted for the JAX package's signature: the loop over the chunks
    is a Python loop either way."""
    B, T, d = x.shape

    if state is not None and T == 1:
        return _mlstm_decode(p, x, cfg, state, pcfg)

    split = head_split(cfg, pcfg)
    conv_state = state["conv"] if state is not None else None
    q, k, v, ig, fg, z, new_conv = _mlstm_qkv_gates(p, x, cfg, conv_state,
                                                    split, pcfg.mesh)
    H, dh = q.shape[-2:]

    L = CHUNK
    while T % L:
        L //= 2
    if state is None:
        carry = (torch.zeros((B, H, dh, dh), dtype=torch.float32,
                             device=x.device),
                 torch.zeros((B, H, dh), dtype=torch.float32,
                             device=x.device),
                 torch.full((B, H), -1e30, dtype=torch.float32,
                            device=x.device))
    else:
        carry = (state["C"], state["n"], state["m"])
    hs = []
    for t in range(0, T, L):
        carry, h_c = _mlstm_chunk(carry, tuple(
            a[:, t:t + L] for a in (q, k, v, ig, fg)))
        hs.append(h_c)
    h = torch.cat(hs, dim=1).reshape(B, T, H * dh)
    out = _mlstm_out(p, h, z, x.dtype, cfg, split, pcfg.mesh)
    new_state = None
    if state is not None:
        C, n, m = carry
        new_state = {"C": C, "n": n, "m": m, "conv": new_conv}
    return out, new_state


def _mlstm_decode(p, x, cfg: ModelConfig, state,
                  pcfg: ParallelConfig = NO_PARALLEL):
    """O(1) recurrent step. x: [B,1,d]; on a ``tp`` mesh on this rank's
    heads and its block of the state (module doc)."""
    B = x.shape[0]
    split = head_split(cfg, pcfg)
    q, k, v, ig, fg, z, new_conv = _mlstm_qkv_gates(p, x, cfg, state["conv"],
                                                    split, pcfg.mesh)
    width = q.shape[-2] * q.shape[-1]
    q, k, v = (a[:, 0].float() for a in (q, k, v))        # [B,H,dh]
    ig, fg = ig[:, 0].float(), fg[:, 0].float()
    C, n, m = state["C"], state["n"], state["m"]
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    fprime = torch.exp(logf + m - m_new)[..., None]
    iprime = torch.exp(ig - m_new)[..., None]
    C_new = C * fprime[..., None] + iprime[..., None] * (
        k[..., :, None] * v[..., None, :])
    n_new = n * fprime + iprime * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    out = _mlstm_out(p, h.reshape(B, 1, width), z, x.dtype, cfg, split,
                     pcfg.mesh)
    return out, {"C": C_new, "n": n_new, "m": m_new, "conv": new_conv}


def mlstm_sequential_oracle(p, x, *, cfg: ModelConfig):
    """Step-by-step reference (test oracle for the chunkwise form)."""
    B, T, d = x.shape
    state = {k: torch.zeros(s.shape, dtype=s.dtype, device=x.device)
             if k != "m" else
             torch.full(s.shape, -1e30, dtype=s.dtype, device=x.device)
             for k, s in mlstm_state_shapes(cfg, B).items()}
    outs = []
    for t in range(T):
        o, state = _mlstm_decode(p, x[:, t:t + 1], cfg, state)
        outs.append(o)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_ffn_width(cfg: ModelConfig) -> int:
    return common.round_up(int(cfg.d_model * cfg.slstm_proj_factor), 128)


def slstm_shapes(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    out = {}
    for g in "ifzo":
        out[f"w_{g}"] = sds((d, d), pd)
        out[f"r_{g}"] = sds((h, hd, hd), pd)  # block-diagonal recurrence
        out[f"b_{g}"] = sds((d,), torch.float32)
    f = slstm_ffn_width(cfg)
    out["ffn"] = {"wi": sds((d, f), pd), "wg": sds((d, f), pd),
                  "wo": sds((f, d), pd)}
    out["out_norm"] = sds((d,), pd)
    return out


def slstm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    d = cfg.d_model
    return {
        "c": sds((batch, d), torch.float32),
        "n": sds((batch, d), torch.float32),
        "m": sds((batch, d), torch.float32),
        "h": sds((batch, d), torch.float32),
    }


def _slstm_step(p, carry, x_t, r32):
    """x_t: [B,d] fp32 pre-activations W x (4 gates stacked; a rank's
    ``[B, d / model]`` of its heads under a ``tp`` split).  ``r32``: the
    recurrent weights ``r_*`` of those heads in float32, which
    ``slstm_apply`` casts once per call (the JAX package casts them in
    every step)."""
    c, n, m, h = carry
    H, hd = r32["i"].shape[:2]
    d = H * hd

    def rec(name, hh):
        hb = hh.reshape(hh.shape[0], H, hd)
        return torch.einsum("bhi,hio->bho", hb, r32[name]).reshape(
            hh.shape[0], d)

    xi, xf, xz, xo = torch.chunk(x_t, 4, dim=-1)
    itilde = xi + rec("i", h) + p["b_i"]
    ftilde = xf + rec("f", h) + p["b_f"]
    z = torch.tanh(xz + rec("z", h) + p["b_z"])
    o = torch.sigmoid(xo + rec("o", h) + p["b_o"])
    logf = F.logsigmoid(ftilde)
    m_new = torch.maximum(logf + m, itilde)
    iprime = torch.exp(itilde - m_new)
    fprime = torch.exp(logf + m - m_new)
    c_new = fprime * c + iprime * z
    n_new = fprime * n + iprime
    # torch.maximum, not clamp: at n = 1 (every first step) the gradient
    # splits between the two sides, as jnp.maximum's does
    h_new = o * c_new / torch.maximum(n_new, torch.ones_like(n_new))
    return (c_new, n_new, m_new, h_new), h_new


def slstm_apply(p, x, *, cfg: ModelConfig, state=None,
                pcfg: ParallelConfig = NO_PARALLEL):
    """x: [B,T,d] -> (out, new_state | None). Sequential loop over T; on
    a ``tp`` mesh over this rank's heads (module doc)."""
    B, T, _ = x.shape
    split = head_split(cfg, pcfg)
    r = {g: p[f"r_{g}"] for g in "ifzo"}
    if split is not None:
        index, size = split
        x = sharded.copy_to_model(x, pcfg.mesh)
        k = cfg.n_heads // size
        r = {g: sharded.copy_to_model(w, pcfg.mesh)[index * k:(index + 1) * k]
             for g, w in r.items()}
    d = r["i"].shape[0] * r["i"].shape[1]   # the rank's heads' width
    xf = x.float()
    pre = torch.cat([xf @ p[f"w_{g}"].float() for g in "ifzo"], dim=-1)
    if state is None:
        carry = (torch.zeros((B, d), dtype=torch.float32, device=x.device),
                 torch.zeros((B, d), dtype=torch.float32, device=x.device),
                 torch.full((B, d), -1e30, dtype=torch.float32,
                            device=x.device),
                 torch.zeros((B, d), dtype=torch.float32, device=x.device))
    else:
        carry = (state["c"], state["n"], state["m"], state["h"])
    r32 = {g: w.float() for g, w in r.items()}
    hs = []
    for t in range(T):
        carry, h_t = _slstm_step(p, carry, pre[:, t], r32)
        hs.append(h_t)
    h = torch.stack(hs, dim=1).to(x.dtype)  # [B,T,d]
    if split is not None:
        h = sharded.gather_from_model(h, pcfg.mesh)
    h = common.rms_norm(h, p["out_norm"], cfg.norm_eps)
    ffn = p["ffn"]
    out = (F.gelu(h @ ffn["wg"], approximate="tanh") * (h @ ffn["wi"])) \
        @ ffn["wo"]
    new_state = None
    if state is not None:
        c, n, m, hh = carry
        new_state = {"c": c, "n": n, "m": m, "h": hh}
    return out, new_state
