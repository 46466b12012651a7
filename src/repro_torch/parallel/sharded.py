"""Trees of blocks on a mesh of ``torch.distributed`` ranks.

A port-only module, as ``convert.py`` is: it does by hand what XLA does
for the JAX package under ``pjit``.  There a parameter is one global
array that a ``NamedSharding`` lays over the devices; here every rank
keeps only its **block** of each leaf, the part the leaf's
``PartitionSpec`` (:mod:`repro_torch.parallel.sharding`) gives its mesh
coordinates.  A dim whose spec entry names axes is split into equal
blocks over them, row-major in the order named; a dim whose entry is
``None``, and every axis the spec does not name, keeps the leaf whole
(replicated).  Every axis a spec names splits storage, ``model``
included.

* :func:`shard_tree` keeps each leaf's block (no communication);
* :func:`gather_tree` all-gathers the blocks back to whole leaves (the
  checkpoints);
* :func:`reduce_scatter_leaf` sums a whole gradient over the batch axes
  and leaves each rank its block of the sum: a ``SUM`` reduce-scatter
  over the batch axes that split the leaf, an all-reduce over those
  that do not;
* :func:`global_norm_sq` is the squared norm of the whole tree from its
  blocks, counting each block once however many ranks hold it;
* :func:`all_gather` and :func:`all_to_all` are collectives that
  autograd crosses (the MoE's token grouping, aux statistics and expert
  exchange on a mesh, ``models/moe.py``): the backward of each is the
  matching reverse collective;
* :func:`gather_from_model` hands a layer's columns, computed on this
  rank's block, to what every ``model`` rank computes whole (its
  backward keeps the rank's block of the gradient);
* :func:`copy_to_model` and :func:`reduce_from_model` bracket a layer
  that computes on this rank's block of its width under
  ``layout="tp"`` (``models/attention.py``, ``mlp.py``, ``rglru.py``,
  ``xlstm.py``, the frontends, and the LM head, its cross-entropy and
  the ``vocab_parallel`` embedding on the rank's block of the
  vocabulary): the first is the
  identity forward and sums the gradient over ``model`` backward, the
  second sums the partial outputs over ``model`` forward and is the
  identity backward; :func:`model_argmax` is the maximum and its index
  over a dim split over ``model`` (the cross-entropy's row maximum and
  its accuracy);
* :func:`gather_block` is :func:`gather_leaf` as autograd crosses it,
  with :func:`reduce_scatter_leaf` for its backward, and
  :class:`BlockGather` applies it to the subtrees a mesh train step
  hands the model (``train/step.py``): the leaves outside the layer
  stack once a microbatch, each pattern unit inside the unit's remat
  wrapper, as XLA gathers inside the JAX package's ``lax.scan``.

Every rank calls each function on the same tree in the same order (the
collectives pair up leaf by leaf; none is skipped for an empty block).
On a gloo group whose ranks keep their tensors on a GPU the collectives
copy through the host (``Mesh.host_staged``).  ``WIRE`` counts the bytes
this rank hands to each kind of collective.

The autograd collectives issue their reverse in the backward, and under
``torch.utils.checkpoint`` their forward again in the recompute; every
rank runs the same graph, so the ranks issue them in the same order.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.spmd import _from_wire, _to_wire
from repro_torch.parallel.mesh_utils import Mesh
from repro_torch.parallel.sharding import P
from repro_torch.utils.pytree import (tree_flatten_with_paths, tree_leaves,
                                      tree_map_with_path, tree_unflatten)

# bytes this rank handed to the gathers, the reduce-scatters (and the
# all-reduces that stand for them over an axis that does not split a
# leaf), the norm's exchange, and the autograd collectives (forward,
# recompute and backward: ``all_gather`` the MoE's ids and aux
# statistics, ``all_to_all`` its expert exchange), and the sums over
# ``model`` of the tensor-parallel layers (``tp_all_reduce``: their
# outputs forward and in the recompute, their inputs' gradients backward,
# at decode a sequence-split cache's softmax statistics and product, and a
# vocab-split cross-entropy's exponentials' sums and gold logits); the
# vocab-split maxima (``model_argmax``), a serving rank's logits, the
# RG-LRU's conv output where its gate blocks do not split over ``model``
# (forward, and the reduce-scatter backward) and ``gather_from_model``'s
# columns count under ``all_gather``
WIRE = {"gather": 0, "reduce_scatter": 0, "norm": 0, "all_gather": 0,
        "all_to_all": 0, "tp_all_reduce": 0}


def _split_dims(spec, ndim: int, mesh: Mesh) -> List[Tuple[int, tuple]]:
    """``(dim, axes)`` for each dim split over more than one rank; axes in
    the order the spec names them, those of one rank left out."""
    out = []
    for d, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        names = tuple(a for a in names if mesh.shape.get(a, 1) > 1)
        if names:
            out.append((d, names))
    return out


def _split_axes(spec, ndim: int, mesh: Mesh) -> tuple:
    """Every axis that splits the leaf, in mesh order."""
    return mesh.mesh_axes([a for _, names in _split_dims(spec, ndim, mesh)
                           for a in names])


def block_slices(spec, shape, mesh: Mesh) -> tuple:
    """The slices of a whole leaf of ``shape`` that this rank keeps."""
    sl = [slice(None)] * len(shape)
    for d, names in _split_dims(spec, len(shape), mesh):
        n = mesh.axes_size(names)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over "
                             f"{names} ({n} ranks)")
        k = shape[d] // n
        i = mesh.axes_index(names)
        sl[d] = slice(i * k, (i + 1) * k)
    return tuple(sl)


def local_block(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole ``x``: a tensor of its own (the
    whole may be freed), or ``x`` itself where the rank keeps it all."""
    sl = block_slices(spec, x.shape, mesh)
    if all(s == slice(None) for s in sl):
        return x
    return x[sl].clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh: Mesh):
    """Each leaf's block (``specs`` a tree of PartitionSpecs parallel to
    ``tree``); no communication."""
    return tree_unflatten(tree, [
        local_block(x, s, mesh) for x, s in
        zip(tree_leaves(tree), tree_leaves(specs))])


def gather_leaf(x: torch.Tensor, spec, shape, mesh: Mesh) -> torch.Tensor:
    """The whole leaf of ``shape`` whose blocks the ranks hold."""
    dims = _split_dims(spec, len(shape), mesh)
    axes = mesh.mesh_axes([a for _, names in dims for a in names])
    if not axes:
        return x
    sizes = [mesh.shape[a] for a in axes]
    src = _to_wire(x, mesh)
    out = torch.empty(math.prod(sizes) * src.numel(), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src.reshape(-1),
                                group=mesh.group_for(axes))
    WIRE["gather"] += x.nbytes
    # [*axes in mesh order, *block] -> each dim preceded by its axes
    lead = {a: i for i, a in enumerate(axes)}
    split = dict(dims)
    perm = []
    for d in range(len(shape)):
        perm += [lead[a] for a in split.get(d, ())]
        perm.append(len(axes) + d)
    whole = out.view(sizes + list(src.shape)).permute(perm).reshape(shape)
    return _from_wire(whole, mesh)


def gather_tree(tree, specs, shapes, mesh: Mesh):
    """Whole leaves from blocks; ``shapes`` a tree of the whole shapes
    (TensorSpecs or tensors)."""
    return tree_unflatten(tree, [
        gather_leaf(x, s, tuple(w.shape), mesh) for x, s, w in
        zip(tree_leaves(tree), tree_leaves(specs), tree_leaves(shapes))])


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, op=dist.ReduceOp.SUM,
               wire: Optional[tuple] = None) -> torch.Tensor:
    """``x`` reduced over ``axes``, written into ``x`` (through a host
    copy on a staged mesh) and returned; ``wire``, a ``(counter dict,
    key)``, grows by the bytes handed to the collective."""
    group = mesh.group_for(axes)
    if group is None:
        return x
    buf = _to_wire(x, mesh)
    dist.all_reduce(buf, op=op, group=group)
    if wire is not None:
        wire[0][wire[1]] += buf.nbytes
    return x if buf is x else x.copy_(buf)


def reduce_scatter_leaf(g: torch.Tensor, spec, mesh: Mesh,
                        batch_axes) -> torch.Tensor:
    """This rank's block of the sum of every batch rank's whole ``g``:
    a ``SUM`` reduce-scatter over the batch axes that split the leaf,
    then an all-reduce of the block over those that do not.  Along an
    axis that splits the leaf but carries no batch rows (``model`` under
    ``layout="tp"``), every rank holds the same sum and keeps its block.
    """
    shape = tuple(g.shape)
    dims = _split_dims(spec, len(shape), mesh)
    split = _split_axes(spec, len(shape), mesh)
    batch = mesh.mesh_axes(batch_axes)
    scatter = tuple(a for a in split if a in batch)
    reduce = tuple(a for a in batch if a not in split)
    sl = block_slices(spec, shape, mesh)
    block_shape = tuple(len(range(*s.indices(n))) for s, n in zip(sl, shape))
    if scatter:
        # [..., (axes of dim d), block_d, ...]: the scattered axes first
        # (mesh order, as the group numbers its ranks), the others cut
        # down to this rank's coordinate
        view, pos = [], {}
        named = dict(dims)
        for d, n in enumerate(shape):
            for a in named.get(d, ()):
                pos[a] = len(view)
                view.append(mesh.shape[a])
            view.append(n // mesh.axes_size(named[d]) if d in named else n)
        gv = g.reshape(view)
        for a in split:
            if a not in scatter:
                gv = gv.narrow(pos[a], mesh.axis_index(a), 1)
        lead = [pos[a] for a in scatter]
        rest = [i for i in range(len(view)) if i not in lead]
        src = _to_wire(gv.permute(lead + rest), mesh)
        out = torch.empty(math.prod(block_shape), dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src.reshape(-1), op=dist.ReduceOp.SUM,
                                   group=mesh.group_for(scatter))
        WIRE["reduce_scatter"] += src.nbytes
        out = _from_wire(out.view(block_shape), mesh)
    else:
        out = local_block(g, spec, mesh)
        if out is g and reduce:     # the all-reduce writes its own copy
            out = g.clone(memory_format=torch.contiguous_format)
    return all_reduce(out, mesh, reduce, wire=(WIRE, "reduce_scatter"))


def owns(spec, ndim: int, mesh: Mesh) -> bool:
    """Whether this rank counts its block of the leaf: of the ranks that
    hold the same block (they differ only along axes that do not split
    it), the one at coordinate 0 on each of those axes."""
    split = _split_axes(spec, ndim, mesh)
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names
               if a not in split)


def global_norm_sq(tree, specs, mesh: Mesh) -> torch.Tensor:
    """Squared Frobenius norm of the whole tree (float32), from this
    rank's blocks: one all-reduce of the per-leaf sums of squares, each
    leaf's block counted by its owner alone (:func:`owns`), so a leaf
    replicated over an axis counts once."""
    leaves = tree_leaves(tree)
    specs = tree_leaves(specs)
    dev = leaves[0].device
    part = torch.stack([
        torch.sum(torch.square(x.float())) if owns(s, x.ndim, mesh)
        else torch.zeros((), dtype=torch.float32, device=dev)
        for x, s in zip(leaves, specs)])
    part = all_reduce(part, mesh, mesh.axis_names, wire=(WIRE, "norm"))
    return part.sum()


def batch_rows(x: torch.Tensor, mesh: Optional[Mesh], batch_axes
               ) -> torch.Tensor:
    """This rank's rows of a global batch leaf: the leading dim split
    over ``batch_axes`` row-major in the order given (the ranks of the
    other axes compute the same rows)."""
    if mesh is None:
        return x
    names = tuple(a for a in batch_axes if a in mesh.shape)
    n = mesh.axes_size(names)
    if x.shape[0] % n:
        raise ValueError(f"a global batch of {x.shape[0]} rows does not "
                         f"split over {names} ({n} ranks)")
    k = x.shape[0] // n
    i = mesh.axes_index(names)
    return x[i * k:(i + 1) * k]


# ------------------------------------------------ collectives autograd crosses
def gather_wire(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` concatenated along dim 0, in the
    group's rank order (row-major in mesh order); no autograd."""
    group = mesh.group_for(axes)
    if group is None:
        return x
    src = _to_wire(x, mesh)
    out = torch.empty((mesh.axes_size(axes) * src.shape[0],)
                      + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    WIRE["all_gather"] += src.nbytes
    return _from_wire(out, mesh)


def scatter_wire(g: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The reverse of :func:`gather_wire`: the sum over the ranks of
    ``axes`` of each one's ``g``, this rank's block of dim 0 kept."""
    group = mesh.group_for(axes)
    if group is None:
        return g
    src = _to_wire(g, mesh)
    n = mesh.axes_size(axes)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    WIRE["all_gather"] += src.nbytes
    return _from_wire(out, mesh)


def exchange_wire(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Block ``j`` of dim 0 goes to rank ``j`` of ``axes``; block ``j``
    of the result came from rank ``j`` (``lax.all_to_all`` tiled over dim
    0, which is its own reverse); moved as bytes."""
    group = mesh.group_for(axes)
    if group is None:
        return x
    src = _to_wire(x, mesh)
    n = mesh.axes_size(axes)
    raw = src.reshape(n, -1).view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=group)
    WIRE["all_to_all"] += src.nbytes
    return _from_wire(out.view(src.dtype).view(src.shape), mesh)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return gather_wire(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return scatter_wire(g, ctx.mesh, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return exchange_wire(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return exchange_wire(g, ctx.mesh, ctx.axes), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = mesh.axes_size("model")
        blocks = gather_wire(x[None].contiguous(), mesh, ("model",))
        # [model, ..., k] -> [..., model * k]
        return blocks.movedim(0, -2).reshape(
            tuple(x.shape[:-1]) + (n * x.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        k = g.shape[-1] // ctx.mesh.axes_size("model")
        i = ctx.mesh.axis_index("model")
        return g[..., i * k:(i + 1) * k], None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g.clone(memory_format=torch.contiguous_format),
                         ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return model_sum(x.clone(memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_sum(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM
              ) -> torch.Tensor:
    """``x`` reduced over ``model`` in its own type, written into ``x``
    (no autograd); its bytes count under ``WIRE["tp_all_reduce"]``."""
    return all_reduce(x, mesh, ("model",), op=op,
                      wire=(WIRE, "tp_all_reduce"))


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` itself forward; backward, the sum over the ``model`` ranks of
    their gradients (an all-reduce in the gradient's type): where the
    ranks each compute on their own block of a layer's width from the
    same ``x``, ``x``'s gradient is the sum of theirs."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the ``model`` ranks of their ``x`` (an all-reduce in
    ``x``'s type, as XLA sums the partial products of a row-split matrix
    in their own type); backward the identity."""
    return _ReduceFromModel.apply(x, mesh)


def model_argmax(x: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(the maximum along the last dim, its index) of the tensor whose
    ``model`` block along that dim is this rank's ``x`` (rank ``i`` holds
    columns ``[i n, (i + 1) n)``, ``n = x.shape[-1]``), with no autograd:
    each rank's (max, global index) all-gathered over ``model`` (float32
    pairs, exact for indices below 2**24), the first rank holding the
    maximum taken, so a tie goes to the lowest index, as ``torch.argmax``
    breaks it.  The bytes count under ``WIRE["all_gather"]``."""
    n = x.shape[-1]
    if n * mesh.axes_size("model") > 2 ** 24:
        raise ValueError(f"a vocabulary of {n} x {mesh.axes_size('model')} "
                         f"indices does not fit float32 exactly")
    with torch.no_grad():
        i = x.argmax(-1, keepdim=True)
        v = torch.gather(x, -1, i).float()
        start = mesh.axis_index("model") * n
        pairs = torch.cat([v, (i + start).float()], -1)[None]
        pairs = gather_wire(pairs.contiguous(), mesh, ("model",))
        top = pairs[..., 0].argmax(0, keepdim=True)
        best = torch.take_along_dim(pairs, top[..., None], dim=0)[0]
    return best[..., 0].to(x.dtype), best[..., 1].long()


def all_gather(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) along ``axes`` concatenated
    along dim 0 in rank order; the gradient of this rank's ``x`` is the
    sum over the ranks of their gradients' block ``index`` (a
    reduce-scatter)."""
    return _AllGather.apply(x, mesh, mesh.mesh_axes(axes))


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every ``model`` rank's ``x`` concatenated along the last dim in
    rank order (rank ``i``'s columns ``[i n, (i + 1) n)``), for a layer
    that computes on its block of the columns and hands the whole to
    what every ``model`` rank computes alike (the sLSTM's ``h`` before
    its norm and FFN, the audio frames' projection before the encoder);
    the gradient of this rank's ``x`` is its block of the columns of the
    whole one, which every ``model`` rank holds alike (summing them would
    count it ``model`` times).  The bytes count under
    ``WIRE["all_gather"]``."""
    return _GatherFromModel.apply(x, mesh)


def all_to_all(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The tiled all-to-all over dim 0 (``x.shape[0]`` a multiple of the
    ranks of ``axes``); its gradient is the same exchange of the
    gradient."""
    return _AllToAll.apply(x, mesh, mesh.mesh_axes(axes))


# ------------------------------------------------ a mesh step's parameters
def without_axes(spec, shape, mesh: Mesh, keep) -> tuple:
    """(``spec`` with the axes ``keep`` left out, the shape of the block
    those axes alone cut from a whole leaf of ``shape``).  A dim split
    over several axes must name the kept ones first (outermost), so that
    the rest of its split is one contiguous run of the kept block."""
    keep = tuple(a for a in keep if mesh.shape.get(a, 1) > 1)
    if not keep:
        return spec, tuple(shape)
    entries, shape = list(spec), list(shape)
    for d, names in _split_dims(spec, len(shape), mesh):
        kept = tuple(a for a in names if a in keep)
        if not kept:
            continue
        if names[:len(kept)] != kept:
            raise ValueError(f"dim {d} of spec {spec} splits over {names}: "
                             f"the kept axes {kept} must lead it")
        rest = tuple(a for a in names if a not in keep)
        entries[d] = (rest if len(rest) > 1 else rest[0]) if rest else None
        shape[d] //= mesh.axes_size(kept)
    return P(*entries), tuple(shape)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, shape, mesh, batch_axes):
        ctx.spec, ctx.mesh, ctx.batch_axes = spec, mesh, batch_axes
        return gather_leaf(x, spec, shape, mesh)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_leaf(g, ctx.spec, ctx.mesh, ctx.batch_axes),
                None, None, None, None)


def gather_block(x: torch.Tensor, spec, shape, mesh: Mesh, batch_axes,
                 keep=()) -> torch.Tensor:
    """The whole leaf of ``shape`` from this rank's block ``x``
    (:func:`gather_leaf`), through autograd: the gradient of ``x`` is
    :func:`reduce_scatter_leaf` of the whole one over ``batch_axes``,
    the sum over the batch ranks cut to this rank's block.  Along the
    axes ``keep`` nothing is gathered (the result is the block those
    axes cut, :func:`without_axes`) and nothing is summed: the rank's
    gradient there is already its block's whole one (an MoE's own
    experts after the expert all-to-all's backward).  The bytes count
    under ``WIRE``'s ``gather`` and ``reduce_scatter``."""
    spec, shape = without_axes(spec, shape, mesh, keep)
    kept = mesh.mesh_axes(keep)
    axes = tuple(a for a in mesh.mesh_axes(batch_axes) if a not in kept)
    return _GatherBlock.apply(x, spec, shape, mesh, axes)


class BlockGather:
    """A mesh train step's parameter gather, handed to ``model.loss_fn``:
    ``gather(tree, prefix)`` is the subtree ``tree`` of this rank's
    blocks at path ``prefix`` of the parameter tree, each leaf whole
    (:func:`gather_block`); with ``unit=True`` ``tree`` is one group
    ``[g]`` of the stacked leaves at ``prefix`` (the stacks' leading
    group dim is never split, so its block is the unit's block).
    ``keep(path)`` names the axes a leaf is not gathered over."""

    def __init__(self, specs, shapes, mesh: Mesh, batch_axes, keep):
        self.specs = dict(tree_flatten_with_paths(specs))
        self.shapes = {p: tuple(s.shape)
                       for p, s in tree_flatten_with_paths(shapes)}
        self.mesh, self.batch_axes, self.keep = mesh, batch_axes, keep

    def __call__(self, tree, prefix: str = "", unit: bool = False):
        def one(path, x):
            spec, shape = self.specs[path], self.shapes[path]
            if unit:
                spec, shape = P(*tuple(spec)[1:]), shape[1:]
            return gather_block(x, spec, shape, self.mesh, self.batch_axes,
                                self.keep(path))
        return tree_map_with_path(one, tree, prefix)
