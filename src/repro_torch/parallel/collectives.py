"""Cross-pod ("wide-area") collective schedule — the UDT analogue.

The port of ``repro.parallel.collectives`` on ``torch.distributed``.
The paper's transport insight: the long-haul hop is the scarce resource;
give it a dedicated protocol and keep bulk traffic local. Mapped to a
multi-pod training job:

  * parameters/optimizer state are sharded *within* a pod and replicated
    *across* pods, so the only cross-pod traffic is one gradient reduction
    per step;
  * that reduction runs hierarchically (the in-pod reduce-scatter of the
    step, :mod:`repro_torch.parallel.sharded`; the cross-pod hop is
    explicit here);
  * the cross-pod hop can be compressed: bf16 cast, or int8 with error
    feedback (the residual of quantisation is carried to the next step, so
    compression is unbiased in the long run).

Where the JAX package runs these functions inside a ``shard_map`` manual
over ``pod``, here each rank calls them on its own blocks, and the
collectives run over the mesh's ``pod`` group (``Mesh.group_for``), op
for op: ``pmean`` is an all-reduce ``SUM`` over the pod count, ``pmax``
an all-reduce ``MAX``, ``all_gather`` an all-gather.  A leaf's int8
scale is the maximum over the WHOLE leaf and every pod, as the JAX
package's ``pmax`` of a whole-array maximum: an all-reduce ``MAX`` over
the whole mesh, since a pod's ranks hold blocks that cover the leaf.
``WIRE`` counts the bytes this rank hands to the cross-pod collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.spmd import _from_wire, _to_wire
from repro_torch.parallel.sharded import all_reduce
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

# bytes this rank handed to collectives over the pod axis (the int8
# scale's all-reduce included)
WIRE = {"pod": 0}
# elements quantised, gathered and summed at once (the int8 path's
# temporaries stay a few of these, whatever the leaf's size)
CHUNK = 2 ** 24


def _reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    return all_reduce(x, mesh, axes, op, wire=(WIRE, "pod"))


def _pmean(x: torch.Tensor, mesh, axis: str, npods: int) -> torch.Tensor:
    return _reduce(x, mesh, axis).div_(npods)


def _int8_mean(x: torch.Tensor, ef: torch.Tensor, mesh, axis: str,
               npods: int):
    """(mean, new ef) of one leaf, written into ``x`` and ``ef``: ``x +
    ef`` quantised to int8 on a scale shared by every pod, the int8
    values all-gathered over ``axis`` and summed as int32, as the JAX
    package does, chunk by chunk."""
    xf = ef.add_(x)                                # x + ef, in float32
    lo, hi = torch.aminmax(xf)                     # max |xf|, no temporary
    amax = _reduce(torch.maximum(-lo, hi).reshape(1), mesh, mesh.axis_names,
                   dist.ReduceOp.MAX)[0]
    scale = torch.clamp(amax, min=1e-30) / 127.0
    group = mesh.group_for(axis)
    flat, out = xf.view(-1), x.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        part = flat[i:i + CHUNK]
        q = torch.clamp(torch.round(part / scale), -127, 127) \
            .to(torch.int8)
        # the residual, in ef, rounded once as a fused multiply-subtract
        # (XLA's CPU code contracts the JAX package's ``xf - q * scale``
        # to one): exact in float64, whose 53 bits hold the product
        part.copy_(part.double() - q.double() * scale.double())
        src = _to_wire(q, mesh)
        if group is None:
            gathered = src
        else:
            gathered = torch.empty(npods * src.numel(), dtype=torch.int8,
                                   device=src.device)
            dist.all_gather_into_tensor(gathered, src, group=group)
            WIRE["pod"] += src.nbytes
        total = _from_wire(gathered, mesh).view(npods, -1) \
            .to(torch.int32).sum(0)
        out[i:i + CHUNK] = total.float() * scale / npods
    return x, xf


def cross_pod_mean(grads, *, mesh, axis: str = "pod",
                   compress: str = "none", ef_state=None):
    """Mean-reduce a grad pytree over ``axis`` with optional compression.

    Returns (reduced_grads, new_ef_state). ``ef_state`` is required (a
    pytree of fp32 residuals, zeros initially) when ``compress=='int8_ef'``.
    Every leaf is this rank's block; ``mesh`` names the groups.  The
    results are written into the tensors of ``grads`` and ``ef_state``,
    which are returned (the step holds one gradient tree, not two).
    """
    npods = mesh.axes_size(axis)

    if compress == "none":
        return tree_map(lambda x: _pmean(x, mesh, axis, npods), grads), \
            ef_state

    if compress == "bf16":
        def red(x):
            b = x.to(torch.bfloat16)
            return x.copy_(_reduce(b, mesh, axis) / npods)
        return tree_map(red, grads), ef_state

    if compress == "int8_ef":
        if ef_state is None:
            raise ValueError("compress='int8_ef' needs ef_state (float32 "
                             "residuals shaped like the gradients)")
        out = [_int8_mean(g, e, mesh, axis, npods) for g, e in
               zip(tree_leaves(grads), tree_leaves(ef_state))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                tree_unflatten(grads, [o[1] for o in out]))

    raise ValueError(compress)


def pod_efficiency_ratio(step_time_multi: float, step_time_single: float):
    """The paper's LLPR analogue: multi-pod step time vs single-pod."""
    return step_time_single / max(step_time_multi, 1e-12)
