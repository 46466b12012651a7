"""The train step builder and the sharding trees: the port of
``repro.train.step``.

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``, updating ``params`` and ``opt_state`` in place.
Without a mesh it is one device's forward and backward through autograd
followed by the AdamW update.  On a mesh (``pcfg.mesh``, one
``torch.distributed`` rank per process) the trees are this rank's blocks
(:mod:`repro_torch.parallel.sharded`) and ``batch`` is this rank's rows
of the global batch (:func:`local_batch`), in the JAX package's two
modes:

  * ``pjit`` — what XLA does under one global jit, by hand: the rank's
    rows run forward and backward on whole parameters gathered from the
    blocks through autograd (:class:`sharded.BlockGather`): the leaves
    outside the layer stack once a microbatch, each pattern unit inside
    its remat wrapper (``transformer.stack_apply``), where XLA gathers
    inside the JAX package's ``lax.scan``.  Each gather's backward
    reduce-scatters the unit's whole gradient (summed over the batch
    axes) back to blocks, and AdamW updates the blocks.  The loss and
    metrics are the global token-weighted means, as over the global
    batch: each rank's loss is weighted by its share of the valid tokens
    before the backward.  Under ``layout="tp"`` the ranks of one
    ``model`` group compute the same rows (the JAX package splits the
    heads and FFN columns over them instead; the values are the same).
    An MoE layer groups tokens, drops slots and takes its aux loss over
    the global batch, exchanging ids and statistics with the other batch
    ranks, and under ``layout="fsdp"`` with ``moe_dispatch="a2a"``
    exchanges its slots with the other ``model`` ranks
    (:mod:`repro_torch.models.moe`), whose experts it then gathers over
    their other axes only.  With ``accum_steps = n`` a rank's rows are
    its rows of each global microbatch in turn (:func:`local_batch`), and
    each microbatch is weighted, reduced and averaged as the JAX
    package's scan over the global microbatches does.
  * ``podwise`` (with ``multi_pod``) — each pod runs the ``pjit`` step
    over its own ``("data", "model")`` ranks up to the gradient; then the
    **only cross-pod traffic** is the explicit (optionally compressed)
    gradient mean over ``pod`` (:func:`collectives.cross_pod_mean`), and
    the loss and metrics are averaged over ``pod``.  An MoE layer's
    groups and aux loss are the pod's rows', as in the JAX package's
    per-pod ``loss_fn``.  Parameters and state are replicated over
    ``pod``; the ``int8_ef`` residual ``ef`` is each pod's own.

The serve-step builders are not ported: the port's ``ServeEngine`` calls
``model.prefill`` / ``model.decode_step`` itself.

A training step is literally a two-stage Sphere job: stage 1 = local
fwd/bwd UDF over the pod's chunk of the batch, shuffle = the cross-pod
gradient reduction, stage 2 = optimizer UDF.
"""
from __future__ import annotations

import re
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model, moe
from repro_torch.parallel import collectives, sharded
from repro_torch.parallel.sharding import (NamedSharding, ParallelConfig, P,
                                           batch_spec, param_specs_for,
                                           validate_spec)
from repro_torch.train import optim
from repro_torch.utils.pytree import (tree_flatten_with_paths, tree_map,
                                      tree_map_with_path, tree_unflatten)

METRIC_KEYS = ("nll", "z_loss", "accuracy", "tokens", "aux_loss")
_EXPERTS = re.compile(r"moe/w[igo]$")


# ---------------------------------------------------------------------------
# Sharding spec trees
# ---------------------------------------------------------------------------

def batch_specs_for(batch_tree, pcfg: ParallelConfig):
    """Every batch leaf shards its leading (global-batch) dim — unless the
    batch does not divide the data axes (e.g. long_500k's batch=1)."""
    def leaf(s):
        spec = batch_spec(pcfg, *([None] * (len(s.shape) - 1)))
        return validate_spec(spec, s.shape, pcfg.axis_sizes)

    return tree_map(leaf, batch_tree)


def opt_state_specs_for(param_tree, pcfg: ParallelConfig,
                        ocfg: optim.AdamWConfig):
    """The state's specs: each tree as its parameter; ``ef`` under
    ``multi_pod`` ``P("pod", *spec)``, as in the JAX package (each pod's
    own residual: a rank keeps the block its parameter spec gives)."""
    pspecs = param_specs_for(param_tree, pcfg)
    out = {"step": P(), "m": pspecs, "v": pspecs, "master": pspecs}
    if ocfg.error_feedback:
        out["ef"] = tree_map(
            lambda s: P("pod", *s) if pcfg.multi_pod else s, pspecs)
    return out


def cache_specs_for(cache_tree, pcfg: ParallelConfig):
    """PartitionSpecs for a decode cache / recurrent state tree.

    Leaves are [G, B, ...]: group dim replicated, batch over (pod, data),
    then for KV caches heads over ``model`` when divisible else the sequence
    dim (flash-decoding); recurrent states shard their first model-divisible
    feature dim.
    """
    if pcfg.mesh is None:
        return tree_map(lambda s: P(), cache_tree)
    b = pcfg.data_axes if len(pcfg.data_axes) > 1 else pcfg.data_axes[0]
    msz = pcfg.model_size

    def leaf(path: str, s):
        name = path.split("/")[-1]
        shape = s.shape
        if name in ("k", "v", "xk", "xv"):
            g, bb, S, K, D = shape
            if K % msz == 0:
                spec = P(None, b, None, "model", None)
            elif S % msz == 0:
                spec = P(None, b, "model", None, None)
            else:
                spec = P(None, b, None, None, None)
        elif name == "kpos":
            S = shape[2]
            spec = P(None, b, "model") if S % msz == 0 else P(None, b, None)
        else:
            # recurrent state: [G, B, ...feature dims]
            dims = [None, b]
            placed = False
            for d in shape[2:]:
                if not placed and d % msz == 0 and d >= msz:
                    dims.append("model")
                    placed = True
                else:
                    dims.append(None)
            spec = P(*dims)
        return validate_spec(spec, shape, pcfg.axis_sizes)

    return tree_map_with_path(leaf, cache_tree)


def to_shardings(spec_tree, mesh):
    """Each spec bound to ``mesh`` (None without a mesh)."""
    if mesh is None:
        return None
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def train_state_specs(cfg: ModelConfig, pcfg: ParallelConfig,
                      ocfg: optim.AdamWConfig, batch_tree):
    pshapes = model.param_shapes(cfg)
    return (param_specs_for(pshapes, pcfg),
            opt_state_specs_for(pshapes, pcfg, ocfg),
            batch_specs_for(batch_tree, pcfg))


def local_batch(batch: dict, pcfg: ParallelConfig) -> dict:
    """This rank's rows of a global batch, the whole batch without a
    mesh.  The rows of each global microbatch ``i`` (``accum_steps = n``:
    global rows ``[i B / n, (i + 1) B / n)``) split over the data axes
    row-major (``batch_spec``), this rank's block of each concatenated in
    turn, so that the step's ``i``-th microbatch of its rows is its share
    of the JAX package's ``i``-th.  The podwise step first takes the
    pod's block of the global batch and splits that (the JAX package's
    ``pod_body``: the pod's rows, then their microbatches).  Raises where
    a microbatch does not split evenly over the ranks."""
    mesh = pcfg.mesh
    if mesh is None:
        return batch
    n = max(pcfg.accum_steps, 1)
    podwise = pcfg.mode == "podwise" and pcfg.multi_pod
    axes = pcfg.with_(multi_pod=False).data_axes if podwise \
        else pcfg.data_axes

    def rows(x):
        if podwise:
            x = sharded.batch_rows(x, mesh, ("pod",))
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"into accum_steps={n} microbatches")
        k = x.shape[0] // n
        parts = [sharded.batch_rows(x[i * k:(i + 1) * k], mesh, axes)
                 for i in range(n)]
        return parts[0] if n == 1 else torch.cat(parts)
    return {k: rows(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _loss_and_grads(leaves, template, batch, *, cfg, pcfg, loss_scale=None,
                    gather=None):
    """(loss, metrics, grads) of ``model.loss_fn`` at the parameters
    ``leaves`` (in tree order; a mesh step's blocks with its ``gather``),
    all detached; the gradient is that of ``loss * loss_scale`` where a
    scale is given."""
    params = tree_unflatten(template, leaves)
    loss, metrics = model.loss_fn(params, batch, cfg=cfg, pcfg=pcfg,
                                  gather=gather)
    # a leaf the batch does not reach (a vision frontend on text) gets
    # zeros, as from jax.grad
    grads = torch.autograd.grad(
        loss if loss_scale is None else loss * loss_scale, leaves,
        materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _value_and_grad_accum(params, batch, *, cfg, pcfg, loss_scale=None,
                          gather=None):
    """fwd/bwd with optional gradient accumulation over microbatches.
    Returns ((loss, metrics), grads), ``grads`` shaped like ``params``.

    Gradients are taken with respect to detached aliases of the parameter
    tensors (the same storage, no copy), so the parameters themselves need
    not require grad and the update may write them in place.  With
    ``accum_steps > 1`` the batch is split along dim 0 and run
    microbatch by microbatch, accumulating fp32 grads: activation memory
    divides by ``accum_steps``.  ``loss_scale`` scales the gradient, not
    the returned loss.

    With a mesh step's ``gather`` (:class:`sharded.BlockGather`)
    ``params`` are this rank's blocks and ``batch`` its rows
    (:func:`local_batch`): each microbatch's loss is weighted by the
    rank's share of that microbatch's valid tokens over the batch ranks,
    the gathers' backward hands back the blocks of the gradient summed
    over them, and the loss and metrics returned are each global
    microbatch's (:func:`_global_metrics`), averaged over the
    microbatches as the JAX package's scan averages them."""
    leaves = [p.detach().requires_grad_() for _, p in
              tree_flatten_with_paths(params)]
    n = pcfg.accum_steps

    def run(mb):
        scale = loss_scale
        if gather is not None:
            tokens = (mb["labels"] >= 0).sum().float()
            total = sharded.all_reduce(tokens.clone(), gather.mesh,
                                       gather.batch_axes)
            scale = tokens / torch.clamp(total, min=1.0)
        loss, metrics, grads = _loss_and_grads(
            leaves, params, mb, cfg=cfg, pcfg=pcfg, loss_scale=scale,
            gather=gather)
        if gather is not None:
            loss, metrics = _global_metrics(loss, metrics, gather.mesh,
                                            gather.batch_axes)
        return loss, metrics, grads

    if n <= 1:
        loss, metrics, grads = run(batch)
        return (loss, metrics), tree_unflatten(params, grads)

    micro = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])
             for k, x in batch.items()}
    acc_g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    dev = acc_g[0].device
    acc_l = torch.zeros((), dtype=torch.float32, device=dev)
    acc_m = {k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in METRIC_KEYS}
    for i in range(n):
        loss, metrics, grads = run({k: x[i] for k, x in micro.items()})
        for a, g in zip(acc_g, grads):
            a.add_(g.float() / n)
        del grads
        acc_l = acc_l + loss / n
        acc_m = {k: acc_m[k] + metrics[k] / n for k in acc_m}
    return (acc_l, acc_m), tree_unflatten(params, acc_g)


def _global_metrics(loss, metrics, mesh, batch_axes):
    """The loss and metrics over the union of the batch ranks' rows: each
    rank's token-weighted means summed as token-weighted sums (one
    all-reduce), over the global token count, as ``losses.cross_entropy``
    takes them over the global batch.  ``aux_loss`` is the same on every
    batch rank (dense: 0; MoE: the global batch's, from statistics summed
    over the batch ranks, ``models/moe.py``)."""
    n = metrics["tokens"].float()
    aux = metrics["aux_loss"].float()
    v = torch.stack([n * (loss.float() - aux), n * metrics["nll"],
                     n * metrics["z_loss"], n * metrics["accuracy"], n])
    v = sharded.all_reduce(v, mesh, batch_axes)
    denom = torch.clamp(v[4], min=1.0)
    out = {"nll": v[1] / denom, "z_loss": v[2] / denom,
           "accuracy": v[3] / denom, "tokens": v[4], "aux_loss": aux}
    return v[0] / denom + aux, out


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: optim.AdamWConfig, lr_fn: Callable):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` in place.  On a mesh,
    ``params`` and ``opt_state`` hold this rank's blocks and ``batch`` its
    rows (:func:`local_batch`)."""
    if pcfg.mode not in ("pjit", "podwise"):
        raise ValueError(pcfg.mode)
    podwise = pcfg.mode == "podwise" and pcfg.multi_pod
    mesh = pcfg.mesh
    if podwise and (mesh is None or "pod" not in mesh.shape):
        raise ValueError("the podwise step needs a mesh with a 'pod' axis "
                         "(launch.mesh.make_debug_mesh(multi_pod=True))")

    if mesh is None:
        def step(params, opt_state, batch):
            (loss, metrics), grads = _value_and_grad_accum(
                params, batch, cfg=cfg, pcfg=pcfg)
            new_params, new_opt, om = optim.apply_updates(
                params, grads, opt_state, ocfg, lr_fn)
            return new_params, new_opt, {**metrics, **om, "loss": loss}
        return step

    inner = pcfg.with_(multi_pod=False) if podwise else pcfg
    batch_axes = mesh.mesh_axes(a for a in inner.data_axes
                                if a in mesh.shape)
    pshapes = model.param_shapes(cfg)
    specs = param_specs_for(pshapes, pcfg)
    # an MoE's experts under the expert all-to-all: each rank reads its
    # own alone, so they are gathered over their other axes only
    experts = ("model",) if moe.a2a_route(cfg, inner) else ()
    gather = sharded.BlockGather(
        specs, pshapes, mesh, batch_axes,
        keep=lambda path: experts if _EXPERTS.search(path) else ())

    def step(params, opt_state, batch):
        (loss, metrics), grads = _value_and_grad_accum(
            params, batch, cfg=cfg, pcfg=inner, gather=gather)
        new_ef = None
        if podwise:
            grads, new_ef = collectives.cross_pod_mean(
                grads, mesh=mesh, axis="pod", compress=pcfg.compress_pod,
                ef_state=opt_state.get("ef"))
            npods = mesh.axes_size("pod")
            loss = sharded.all_reduce(loss, mesh, "pod") / npods
            metrics = {k: sharded.all_reduce(v, mesh, "pod") / npods
                       for k, v in metrics.items()}
        new_params, new_opt, om = optim.apply_updates(
            params, grads, opt_state, ocfg, lr_fn, specs=specs, mesh=mesh)
        if new_ef is not None:
            new_opt["ef"] = new_ef
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    step.specs = specs
    return step
