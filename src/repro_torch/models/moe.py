"""Mixture-of-Experts FFN with two dispatch formulations.

The port of ``repro.models.moe`` on one device, in plain torch (the JAX
package's dispatch is plain XLA, no kernel).  The token -> expert
dispatch and combine is a Sphere shuffle inside the model: data moves to
the UDF's home (the expert), is processed, and is shuffled back.

Dispatch modes (``ParallelConfig.moe_dispatch``):

  * ``einsum`` (the default) — GShard-style dense one-hot dispatch /
    combine einsums with a capacity factor: the shuffle as a literal
    dense "transport matrix", about ``2 * E * C * d`` extra MACs a token.
  * ``gather`` — index-based dispatch (a gather into ``[G, E, C, d]``)
    and combine: the same routing and capacity, no one-hot FLOPs.  The
    JAX package combines by a scatter-add; here each token sums its own
    ``k`` slots gathered back from the experts' outputs, so no atomic
    adds are involved and the result is deterministic.
  * ``a2a`` — the explicit all-to-all of an expert-parallel mesh; it
    runs ``gather`` where the JAX package falls back to it (no mesh, or
    ``layout="tp"``, or one ``model`` rank).  The all-to-all itself, under
    ``layout="fsdp"`` over several ``model`` ranks, is not ported
    (``ROADMAP.md`` item 1.3g): it raises.

All share routing: top-k softmax gates (float32 router), position in
expert by a stable sort in first-come order over the ``k``-major
flattening, tokens past capacity dropped and the gates renormalised
over the surviving slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, sds
from repro_torch.parallel.sharding import ParallelConfig

CAPACITY_FACTOR = 1.25
GROUP_SIZE = 4096  # tokens per dispatch group (GShard-style)
DISPATCH_MODES = ("einsum", "gather", "a2a")


def shapes(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": sds((d, e), torch.float32),
        "wi": sds((e, d, f), pd),
        "wg": sds((e, d, f), pd),
        "wo": sds((e, f, d), pd),
    }


def capacity(group: int, cfg: ModelConfig) -> int:
    c = int(group * cfg.top_k / cfg.n_experts * CAPACITY_FACTOR)
    return max(8, ((c + 7) // 8) * 8)


def _positions_by_sort(flat: torch.Tensor) -> torch.Tensor:
    """Rank of each slot within its expert's run (first-come order).

    flat: [G, n] expert ids.  A stable sort groups the slots by expert;
    a running maximum of the run starts gives each slot's rank in its
    run, scattered back to the slot's place.  No [n, E] one-hot."""
    G, n = flat.shape
    order = torch.argsort(flat, dim=-1, stable=True)      # groups by expert
    se = torch.gather(flat, 1, order)
    idx = torch.arange(n, device=flat.device).expand(G, n)
    newrun = torch.cat([torch.ones((G, 1), dtype=torch.bool,
                                   device=flat.device),
                        se[:, 1:] != se[:, :-1]], dim=-1)
    run_start = torch.cummax(torch.where(newrun, idx, 0), dim=1).values
    rank = idx - run_start                                # pos within run
    return torch.zeros_like(rank).scatter_(1, order, rank)


def _route(params, xg, cfg: ModelConfig):
    """xg: [G, S, d] -> gates [G,S,k], eids [G,S,k], pos-in-expert [G,S,k],
    aux load-balance loss."""
    logits = xg.float() @ params["router"]                # [G,S,E]
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, the lower expert first on a tie; a
    # stable descending sort keeps exactly that (torch.topk promises no
    # order among ties)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = top[..., :cfg.top_k], order[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # position-in-expert over slots in priority order (all k=0 slots first)
    G, S, k = eids.shape
    E = cfg.n_experts
    flat = eids.transpose(1, 2).reshape(G, k * S)
    pos = _positions_by_sort(flat).reshape(G, k, S).transpose(1, 2)

    # aux loss (Switch): E * mean_e(frac_tokens_e * mean_prob_e)
    top1 = F.one_hot(eids[..., 0], E).float()
    frac_tokens = top1.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef
    return gates, eids, pos, aux


def _expert_ffn(params, xe, cfg: ModelConfig):
    """xe: [G, E, C, d] -> [G, E, C, d]."""
    act = activation(cfg.act)
    h = act(torch.einsum("gecd,edf->gecf", xe, params["wg"])) * torch.einsum(
        "gecd,edf->gecf", xe, params["wi"])
    return torch.einsum("gecf,efd->gecd", h, params["wo"])


def apply(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
          pcfg: ParallelConfig):
    """x: [B, T, d] -> (out [B, T, d], aux_loss scalar)."""
    mode = pcfg.moe_dispatch
    if mode not in DISPATCH_MODES:
        raise ValueError(mode)
    if mode == "a2a":
        if pcfg.mesh is not None and pcfg.layout == "fsdp" \
                and pcfg.model_size > 1 \
                and cfg.n_experts % pcfg.model_size == 0:
            raise NotImplementedError(
                "moe_dispatch='a2a' over several model ranks under "
                "layout='fsdp' (the expert all-to-all) is not ported: "
                "ROADMAP.md item 1.3g (the MoE on the LM mesh)")
        mode = "gather"  # the JAX package's meshless / TP fallback
    B, T, d = x.shape
    total = B * T
    group = min(GROUP_SIZE, total)
    while total % group:
        group //= 2
    G = total // group
    xg = x.reshape(G, group, d)
    gates, eids, pos, aux = _route(params, xg, cfg)
    C = capacity(group, cfg)
    keep = pos < C  # overflow tokens dropped
    gates = torch.where(keep, gates, 0.0)
    # renormalise over surviving slots
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    if mode == "einsum":
        out = _apply_einsum(params, xg, gates, eids, pos, keep, C, cfg)
    else:
        out = _apply_gather(params, xg, gates, eids, pos, keep, C, cfg)
    return out.reshape(B, T, d).to(x.dtype), aux


def _apply_einsum(params, xg, gates, eids, pos, keep, C, cfg):
    """GShard dense one-hot dispatch / combine (the faithful baseline)."""
    E = cfg.n_experts
    dt = xg.dtype
    # combine tensor [G,S,E,C] = gate on (expert, slot) pairs, in xg's
    # dtype as in the JAX package: a gate that rounds to 0 there drops
    # out of dispatch too.  Each token's k slots name k distinct experts,
    # so the sum over k adds one term to each (e, c).  A dropped slot's
    # position is past C: its one-hot row is zero (jax.nn.one_hot's rule)
    eh = F.one_hot(eids, E).to(dt)                         # [G,S,k,E]
    ph = F.one_hot(torch.where(keep, pos, 0), C).to(dt) \
        * keep[..., None].to(dt)                           # [G,S,k,C]
    combine = torch.einsum("gske,gskc->gsec", eh,
                           ph * gates.to(dt)[..., None])   # [G,S,E,C]
    dispatch = (combine > 0).to(dt)
    xe = torch.einsum("gsd,gsec->gecd", xg, dispatch)      # the shuffle out
    ye = _expert_ffn(params, xe, cfg)
    return torch.einsum("gecd,gsec->gsd", ye, combine)    # the shuffle back


def _apply_gather(params, xg, gates, eids, pos, keep, C, cfg):
    """Index-based dispatch: gather tokens into [G,E,C,d], and each token
    gathers its k slots back.

    The dispatch table has one extra slot per expert, ``C``, where every
    dropped slot lands (the JAX package's out-of-range writes, which
    ``mode="drop"`` discards); it is sliced off, so nothing is written
    out of range."""
    G, S, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    tok = torch.arange(S, device=dev)[None, :, None].expand(G, S, k)
    slot = eids * (C + 1) + torch.where(keep, pos, C)      # [G,S,k]
    flat_slot = slot.reshape(G, S * k)

    # dispatch table [G,E,C]: source token of slot (e,c) and whether
    # a kept slot fills it
    table = torch.zeros((G, E * (C + 1)), dtype=torch.long, device=dev)
    table.scatter_(1, flat_slot, tok.reshape(G, S * k))
    filled = torch.zeros((G, E * (C + 1)), dtype=torch.bool, device=dev)
    filled.scatter_(1, flat_slot, keep.reshape(G, S * k))
    table = table.view(G, E, C + 1)[..., :C]
    filled = filled.view(G, E, C + 1)[..., :C]

    xe = torch.gather(xg, 1, table.reshape(G, E * C, 1).expand(-1, -1, d))
    xe = torch.where(filled.reshape(G, E * C, 1), xe, 0).view(G, E, C, d)
    ye = _expert_ffn(params, xe, cfg)

    # combine: token s sums its kept slots' outputs, weighted by its gates
    back = (eids * C + torch.where(keep, pos, 0)).reshape(G, S * k, 1)
    contrib = torch.gather(ye.reshape(G, E * C, d), 1,
                           back.expand(-1, -1, d)).view(G, S, k, d)
    contrib = contrib * gates.to(ye.dtype)[..., None]
    return torch.where(keep[..., None], contrib, 0).sum(dim=2)
