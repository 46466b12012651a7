"""Mixture-of-Experts FFN with two dispatch formulations.

The port of ``repro.models.moe`` in plain torch (the JAX package's
dispatch is plain XLA, no kernel).  The token -> expert dispatch and
combine is a Sphere shuffle inside the model: data moves to the UDF's
home (the expert), is processed, and is shuffled back.

Dispatch modes (``ParallelConfig.moe_dispatch``):

  * ``einsum`` (the default) — GShard-style dense one-hot dispatch /
    combine einsums with a capacity factor: the shuffle as a literal
    dense "transport matrix", about ``2 * E * C * d`` extra MACs a token.
  * ``gather`` — index-based dispatch (a gather into ``[G, E, C, d]``)
    and combine: the same routing and capacity, no one-hot FLOPs.  The
    JAX package combines by a scatter-add; here each token sums its own
    ``k`` slots gathered back from the experts' outputs, so no atomic
    adds are involved and the result is deterministic.
  * ``a2a`` — the explicit expert all-to-all of a mesh under
    ``layout="fsdp"`` over several ``model`` ranks (:func:`_apply_a2a`);
    elsewhere (no mesh, ``layout="tp"``, one ``model`` rank) it runs
    ``gather``, as the JAX package falls back (under ``tp`` split over
    ``model`` as below).

All share routing: top-k softmax gates (float32 router), position in
expert by a stable sort in first-come order over the ``k``-major
flattening, tokens past capacity dropped and the gates renormalised
over the surviving slots.

**On a mesh that splits the batch** (:func:`_batch_ranks`) each rank
holds its rows of the global batch, and the layer gives what the JAX
package's ``apply`` gives on the global ``[B, T, d]`` under ``pjit``
(:func:`_apply_grouped`): the rank all-gathers every batch rank's expert
ids (integers, no gradient), takes the positions over the global groups
of ``min(GROUP_SIZE, B * T)`` tokens, keeps its own tokens' and
dispatches and combines only those (each slot's FFN depends on its token
alone, and an empty slot's output is 0, so no expert FLOP is repeated);
the aux loss is taken from the ``[2, E]`` statistics summed over the
batch ranks by an all-gather that autograd crosses, so each rank's share
of the global aux gradient reaches its own router probabilities.  The
train step weights each rank's loss by its token share before the
backward; the shares sum to 1 and the gather's backward sums over the
ranks, so the aux term is counted once.

**Under ``layout="tp"``** on a mesh whose ``model`` size ``M`` divides
``n_experts`` (:func:`ep_split`; the JAX package's rule ``moe/w(i|g)`` ->
``P("model", "data", None)``) each ``model`` rank keeps experts ``[i E /
M, (i + 1) E / M)`` of ``wi`` / ``wg`` / ``wo``.  Every ``model`` rank
routes its rows whole, exactly as above (the router, ids, positions,
capacity, dropped slots and renormalised gates, ``C_l`` too), then
dispatches only its own experts' slots into ``[G, E / M, C, d]`` buffers
(``einsum`` and ``gather`` alike), runs its experts and combines their
weighted outputs; the input and the router enter through
``sharded.copy_to_model`` and the partial outputs are summed by
``sharded.reduce_from_model``, as the dense FFN's.  The aux loss is the
same on every ``model`` rank; only rank 0's carries a gradient, so that
the sum over ``model`` of the router's and the input's gradients counts
it once.  Where ``ep_split`` is None the layer computes whole on every
``model`` rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, sds
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import ParallelConfig, tp_block

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


def _gates(params, xg, cfg: ModelConfig):
    """xg: [..., d] -> router probabilities [..., E], top-k gates
    renormalised [..., k] and expert ids [..., k]."""
    logits = xg.float() @ params["router"]                # [G,S,E]
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, the lower expert first on a tie; a
    # stable descending sort keeps exactly that (torch.topk promises no
    # order among ties)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = top[..., :cfg.top_k], order[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eids


def _route(params, xg, cfg: ModelConfig):
    """xg: [G, S, d] -> gates [G,S,k], eids [G,S,k], pos-in-expert [G,S,k],
    aux load-balance loss."""
    probs, gates, eids = _gates(params, xg, cfg)

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


class MeshRanks:
    """The batch ranks of a mesh as the MoE layer sees them: ``size``
    ranks along ``axes`` (mesh order), this one at ``index`` (its rows
    are the global batch's ``index``-th block, :func:`sharded.batch_rows`);
    ``model_size`` / ``model_index`` along ``model`` where ``model`` splits
    the batch (``layout="fsdp"``), else 1 / 0.  ``gather`` is the
    autograd all-gather over the batch ranks, ``exchange`` the autograd
    all-to-all over ``model``."""

    def __init__(self, mesh, axes: tuple):
        self.mesh, self.axes = mesh, axes
        self.size = mesh.axes_size(axes)
        self.index = mesh.axes_index(axes)
        split = "model" in axes
        self.model_size = mesh.shape["model"] if split else 1
        self.model_index = mesh.axis_index("model") if split else 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return sharded.all_gather(x, self.mesh, self.axes)

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        return sharded.all_to_all(x, self.mesh, "model")


def _batch_ranks(pcfg: ParallelConfig):
    """:class:`MeshRanks` of ``pcfg``'s mesh over the axes that split the
    batch (``data_axes``; ``pod`` only where the step is not podwise, whose
    inner config leaves it out), or None without a mesh, where they are
    one rank, or where every rank holds the whole batch
    (``pcfg.whole_batch``: a serving mesh's batch-1 prefill groups its
    one row, as the JAX package's global batch)."""
    mesh = pcfg.mesh
    if mesh is None or pcfg.whole_batch:
        return None
    named = tuple(a for a in pcfg.data_axes if mesh.shape.get(a, 1) > 1)
    axes = mesh.mesh_axes(named)
    if not axes:
        return None
    if axes != named:
        raise ValueError(f"the batch axes {named} are not in the mesh's "
                         f"order {mesh.axis_names}")
    return MeshRanks(mesh, axes)


def a2a_route(cfg: ModelConfig, pcfg: ParallelConfig) -> bool:
    """Whether ``apply`` takes the expert all-to-all (:func:`_apply_a2a`):
    ``moe_dispatch="a2a"`` under ``layout="fsdp"`` on a mesh of several
    ``model`` ranks over which the experts split evenly.  A mesh train
    step then gathers the experts over their other axes only
    (``train/step.py``): each rank reads its own experts alone."""
    ranks = _batch_ranks(pcfg)
    return (pcfg.moe_dispatch == "a2a" and pcfg.layout == "fsdp"
            and ranks is not None and ranks.model_size > 1
            and cfg.n_experts % ranks.model_size == 0)


def ep_split(cfg: ModelConfig, pcfg: ParallelConfig):
    """(this rank's coordinate along ``model``, the ``model`` size ``M``)
    where the layer computes on the rank's ``E / M`` experts: ``layout=
    "tp"`` on a mesh of several ``model`` ranks whose size divides
    ``n_experts`` (``sharding.tp_block``), else None (whole)."""
    return tp_block(pcfg, cfg.n_experts) if cfg.n_experts else None


def _tp_out(out, aux, x, pcfg: ParallelConfig, block):
    """The layer's ``(out, aux)`` in ``x``'s type; under ``block`` the
    partial outputs summed over ``model`` and the aux loss's gradient
    kept on ``model`` rank 0 alone."""
    out = out.to(x.dtype)
    if block is None:
        return out, aux
    return (sharded.reduce_from_model(out, pcfg.mesh),
            aux if block[0] == 0 else aux.detach())


def apply(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
          pcfg: ParallelConfig):
    """x: [B, T, d] -> (out [B, T, d], aux_loss scalar).  On a mesh that
    splits the batch, ``x`` is this rank's rows and the result its rows
    of the global batch's (the aux loss the global one)."""
    mode = pcfg.moe_dispatch
    if mode not in DISPATCH_MODES:
        raise ValueError(mode)
    ranks = _batch_ranks(pcfg)
    if mode == "a2a":
        if a2a_route(cfg, pcfg):
            return _apply_a2a(params, x, cfg=cfg, ranks=ranks)
        mode = "gather"  # the JAX package's meshless / TP fallback
    block = ep_split(cfg, pcfg)
    if block is not None:   # wi / wg / wo hold the rank's E / M experts
        params = {**params, "router": sharded.copy_to_model(
            params["router"], pcfg.mesh)}
        x = sharded.copy_to_model(x, pcfg.mesh)
    if ranks is not None:
        out, aux = _apply_grouped(params, x, cfg=cfg, mode=mode, ranks=ranks,
                                  block=block)
        return _tp_out(out, aux, x, pcfg, block)
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

    dispatch = _apply_einsum if mode == "einsum" else _apply_gather
    out = dispatch(params, xg, gates, eids, pos, keep, C, cfg, block)
    return _tp_out(out.reshape(B, T, d), aux, x, pcfg, block)


def _aux_totals(probs, eids, ranks) -> torch.Tensor:
    """The ``[2, E]`` sums over every batch rank's tokens of the top-1
    one-hot and of the router probabilities, each rank's summed in rank
    order (the same on every rank); the gradient reaches each rank's
    own probabilities."""
    E = probs.shape[-1]
    # a count of E bins (bincount's length follows the data, which a
    # dry run's meta tensors cannot give)
    ids = eids[..., 0].reshape(-1).long()
    top1 = torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids)).float()
    part = torch.stack([top1, probs.reshape(-1, E).sum(0)])
    return ranks.gather(part[None]).sum(0)


def _apply_grouped(params, x, *, cfg: ModelConfig, mode: str, ranks,
                   block=None):
    """``apply`` of the global batch, on this rank's rows ``x`` [b, T, d].

    The global ``n * size`` tokens (rank ``i``'s the ``i``-th block) form
    groups of ``min(GROUP_SIZE, n * size)`` as in ``apply``; each
    rank's ``n`` tokens are cut into segments of ``gcd(n, group)``, each
    inside one group.  The positions come from every rank's ids, so the
    capacity, the dropped slots and the renormalised gates are the
    global group's.  A segment's kept slots take the first places of
    its own ``[E, C_l]`` buffer in the same first-come order: a slot's
    output depends only on its token, so the values are the global
    group's, and ``C_l`` (the segment's largest kept count an expert,
    rounded up to 8) is ``C`` where a segment is a whole group.  On
    ``meta`` tensors (the dry run), which hold no ids, ``C_l`` is its
    upper bound, ``C`` or the segment's tokens rounded up to 8.  Under
    ``block`` (:func:`ep_split`) the rank dispatches its experts' slots
    alone; returns the partial output (before the sum over ``model``)."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = B * T
    total = n * ranks.size
    group = min(GROUP_SIZE, total)
    while total % group:
        group //= 2
    C = capacity(group, cfg)
    seg = math.gcd(n, group)
    xg = x.reshape(n // seg, seg, d)
    probs, gates, eids = _gates(params, xg, cfg)

    # positions over the global groups, from every rank's ids
    ids = ranks.gather(eids.reshape(n, k).to(torch.int32)).long()
    G = total // group
    flat = ids.view(G, group, k).transpose(1, 2).reshape(G, k * group)
    pos = _positions_by_sort(flat).view(G, k, group).transpose(1, 2)
    lo = ranks.index * n
    pos = pos.reshape(total, k)[lo:lo + n].view(eids.shape)
    keep = pos < C
    gates = torch.where(keep, gates, 0.0)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    totals = _aux_totals(probs, eids, ranks)
    aux = E * torch.sum((totals[0] / total) * (totals[1] / total)) \
        * cfg.router_aux_coef

    if seg < group:   # the segment's own slots, first come first placed
        Gl = n // seg
        slot = _positions_by_sort(eids.transpose(1, 2).reshape(Gl, k * seg))
        slot = slot.view(Gl, k, seg).transpose(1, 2)
        if x.device.type == "meta":
            # a dry run has no ids to read: the most a segment can keep
            C_l = min(C, max(8, -(-seg // 8) * 8))
        else:
            used = int(torch.where(keep, slot + 1, 0).max())
            C_l = max(8, -(-used // 8) * 8)
    else:
        slot, C_l = pos, C
    dispatch = _apply_einsum if mode == "einsum" else _apply_gather
    out = dispatch(params, xg, gates, eids, slot, keep, C_l, cfg, block)
    return out.reshape(B, T, d), aux


def _apply_a2a(params, x, *, cfg: ModelConfig, ranks):
    """The explicit Sphere-shuffle dispatch (the JAX package's
    ``_apply_a2a``): this rank routes its own ``n`` tokens, packs
    ``[M, E_loc, cap, d]`` slot buffers (experts in contiguous blocks of
    ``E // M`` a ``model`` rank), exchanges them with one all-to-all over
    ``model``, runs its ``E_loc`` experts on what it received, reverses
    the exchange and combines.  Its semantics differ from ``apply``'s:
    ``cap`` from the rank's own tokens, positions in token-major slot
    order, the surviving slots weighted by their pre-drop gates (no
    renormalisation), and the aux loss from the ``[2, E]`` sums over every
    batch rank with ``frac_tok`` over the count of top-1 slots.  Dropped
    slots land in an extra slot of each expert, sliced off (the JAX
    package's out-of-range writes); the combine is each token's sum of
    its ``k`` slots (the JAX scatter-add over tokens).  ``wi`` / ``wg`` /
    ``wo`` are this rank's ``E_loc`` experts, as a mesh train step
    gathers them (:func:`a2a_route`), or all ``E``, of which the rank
    reads its own; the others' gradients are then zero here and a sum
    over the batch ranks puts each in place."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    M, m = ranks.model_size, ranks.model_index
    E_loc = E // M
    n = B * T
    total = n * ranks.size
    cap = max(8, -(-int(n * k * CAPACITY_FACTOR / E) // 8) * 8)
    act = activation(cfg.act)
    dev = x.device
    xt = x.reshape(n, d)
    probs, gates, eids = _gates(params, xt, cfg)          # [n, k]

    flat_e = eids.reshape(n * k)                          # token-major
    pos = _positions_by_sort(flat_e[None])[0]
    keep = pos < cap
    slot = flat_e * (cap + 1) + torch.where(keep, pos, cap)
    tok = torch.arange(n, device=dev).repeat_interleave(k)
    table = torch.zeros(E * (cap + 1), dtype=torch.long, device=dev)
    table.scatter_(0, slot, tok)
    filled = torch.zeros(E * (cap + 1), dtype=torch.bool, device=dev)
    filled.scatter_(0, slot, keep)
    table = table.view(E, cap + 1)[:, :cap]
    filled = filled.view(E, cap + 1)[:, :cap]
    send = torch.where(filled[..., None], xt[table], 0)   # [E, cap, d]
    recv = ranks.exchange(send.view(M, E_loc, cap, d))

    xe = recv.transpose(0, 1).reshape(E_loc, M * cap, d)
    wi, wg, wo = (params[k] if params[k].shape[0] == E_loc
                  else params[k][m * E_loc:(m + 1) * E_loc]
                  for k in ("wi", "wg", "wo"))
    h = act(torch.einsum("ecd,edf->ecf", xe, wg)) \
        * torch.einsum("ecd,edf->ecf", xe, wi)
    ye = torch.einsum("ecf,efd->ecd", h, wo)
    back = ye.view(E_loc, M, cap, d).transpose(0, 1).contiguous()
    ret = ranks.exchange(back).reshape(E * cap, d)        # [E, cap, d]

    w = (gates.reshape(n * k) * keep).to(ret.dtype)
    contrib = ret[flat_e * cap + torch.where(keep, pos, 0)] * w[:, None]
    contrib = torch.where(keep[:, None], contrib, 0)
    out = contrib.view(n, k, d).sum(1)

    totals = _aux_totals(probs, eids, ranks)
    frac_tok = totals[0] / torch.clamp(totals[0].sum(), min=1.0)
    mean_prob = totals[1] / max(total, 1)
    aux = E * torch.sum(frac_tok * mean_prob) * cfg.router_aux_coef
    return out.reshape(B, T, d).to(x.dtype), aux


def _local_slots(eids, keep, cfg: ModelConfig, block):
    """(expert ids within the rank's block, the kept slots that go to
    it, the block's expert count): ``eids`` and ``keep`` as they are
    without a ``block``.  A slot of another rank's expert keeps id 0 and
    is not kept here."""
    if block is None:
        return eids, keep, cfg.n_experts
    index, size = block
    el = cfg.n_experts // size
    local = eids - index * el
    mine = (local >= 0) & (local < el)
    return torch.where(mine, local, 0), keep & mine, el


def _apply_einsum(params, xg, gates, eids, pos, keep, C, cfg, block=None):
    """GShard dense one-hot dispatch / combine (the faithful baseline),
    over the experts of ``block`` (:func:`_local_slots`)."""
    eids, keep, E = _local_slots(eids, keep, cfg, block)
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


def _apply_gather(params, xg, gates, eids, pos, keep, C, cfg, block=None):
    """Index-based dispatch: gather tokens into [G,E,C,d], and each token
    gathers its k slots back (the experts of ``block``,
    :func:`_local_slots`).

    The dispatch table has one extra slot per expert, ``C``, where every
    dropped slot lands (the JAX package's out-of-range writes, which
    ``mode="drop"`` discards); it is sliced off, so nothing is written
    out of range."""
    G, S, d = xg.shape
    eids, keep, E = _local_slots(eids, keep, cfg, block)
    k = cfg.top_k
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
