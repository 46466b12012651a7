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
    ``model`` group compute the same rows, the attention (the encoder's
    and the cross blocks' too), dense-FFN, RG-LRU, mLSTM, sLSTM and MoE
    layers and the frontends each on the rank's block of their heads,
    columns, width or experts, and the head and its cross-entropy (and a
    ``vocab_parallel`` embedding) on the rank's block of the vocabulary,
    where the JAX package's specs
    split them over ``model`` (:func:`tp_leaf`): those leaves are
    gathered over the batch axes alone, each ``model`` rank keeping its
    block, whose gradient is its own.  A tied table kept whole for the
    lookup is gathered whole; the head's gradient lands on the rank's
    rows of it, and its gather's backward keeps the rank's block.  An MoE layer
    groups tokens, drops slots and takes its aux loss over the global
    batch, exchanging ids and statistics with the other batch ranks, and
    under ``layout="fsdp"`` with ``moe_dispatch="a2a"`` exchanges its
    slots with the other ``model`` ranks (:mod:`repro_torch.models.moe`),
    whose experts it then gathers over their other axes only.  With
    ``accum_steps = n`` a rank's rows are its rows of each global
    microbatch in turn (:func:`local_batch`), and
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

The serve steps (:func:`make_prefill_step`, :func:`make_serve_step`, and
the port's :func:`make_decode_step`, which returns the logits for
sampling) run on one device or on a serving mesh of ``torch.distributed``
ranks under ``layout="tp"``, every shipped config
(:func:`check_serving_mesh`).  There a rank's parameters are
:func:`serve_params` (every leaf whole but the blocks the layers compute
on, each whole over the batch axes), its cache the block
:func:`cache_specs_for` gives it (:func:`init_cache_blocks`), its rows
of the batch those the batch axes give it (all of a batch that does not
split, ``ParallelConfig.whole_batch``), and the logits come back whole,
gathered over ``model`` where the vocabulary splits and over the batch
axes.

A training step is literally a two-stage Sphere job: stage 1 = local
fwd/bwd UDF over the pod's chunk of the batch, shuffle = the cross-pod
gradient reduction, stage 2 = optimizer UDF.
"""
from __future__ import annotations

import re
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model, moe, rglru, transformer, xlstm
from repro_torch.parallel import collectives, sharded
from repro_torch.parallel.sharding import (NamedSharding, ParallelConfig, P,
                                           batch_spec, param_specs_for,
                                           tp_block, validate_spec)
from repro_torch.train import optim
from repro_torch.utils.pytree import (tree_flatten_with_paths, tree_map,
                                      tree_map_with_path, tree_unflatten)

METRIC_KEYS = ("nll", "z_loss", "accuracy", "tokens", "aux_loss")
_EXPERTS = re.compile(r"moe/w[igo]$")
# the leaves of the decoder's and the encoder's stacks a layer computes on
# its model block (the self- and cross-attention, the dense FFN, the
# RG-LRU block, the mLSTM and sLSTM blocks, the MoE's experts), and of
# the head, the table and the frontends, by the widths that must split
_STACK = r"^(encoder/)?blocks/.*/"
_TP_LEAVES = ((re.compile(_STACK + r"x?attn/(wq|bq|wo)$"), ("heads",)),
              (re.compile(_STACK + r"x?attn/(wk|wv|bk|bv)$"),
               ("heads", "kv_heads")),
              (re.compile(_STACK + r"mlp/w[igo]$"), ("ffn",)),
              (re.compile(_STACK + r"rglru/(in_x|in_g|conv_w|a_param|out)$"),
               ("lru",)),
              (re.compile(_STACK + r"mlstm/(conv_w|out_norm|down|[qkv]/w)$"),
               ("xlstm",)),
              (re.compile(_STACK + r"slstm/[wb]_[ifzo]$"), ("xlstm",)),
              (re.compile(_STACK + r"moe/w[igo]$"), ("experts",)),
              (re.compile(r"^lm_head/w$"), ("vocab",)),
              (re.compile(r"^embed/w$"), ("vocab_parallel",)),
              (re.compile(r"^frontend/w1$"), ("frontend",)))


def tp_leaf(path: str, cfg: ModelConfig, pcfg: ParallelConfig) -> bool:
    """Whether the leaf at ``path`` is one whose ``model`` block a layer
    computes on (``sharding.tp_block`` of its widths: the self- and
    cross-attention's heads, and their kv heads for ``wk`` / ``wv``; the
    FFN's; the LRU width where ``rglru.lru_split`` splits it; the mLSTM's
    and sLSTM's heads where ``xlstm.head_split`` splits them; the experts
    where ``moe.ep_split`` splits them; the head's vocabulary, and the
    table's under ``embed_mode="vocab_parallel"``, where
    ``transformer.vocab_split`` splits it; the frontends' ``w1`` where
    ``transformer.frontend_split`` splits it), so that a rank keeps only
    that block along ``model``.  A table under ``embed_mode="gather"``
    stays whole (the lookup reads every row; a tied head takes a view of
    the rank's rows of it)."""
    vocab = transformer.vocab_split(cfg, pcfg)
    splits = {"heads": tp_block(pcfg, cfg.n_heads),
              "kv_heads": tp_block(pcfg, cfg.n_kv_heads),
              "ffn": tp_block(pcfg, cfg.d_ff),
              "lru": rglru.lru_split(cfg, pcfg),
              "xlstm": xlstm.head_split(cfg, pcfg),
              "frontend": transformer.frontend_split(cfg, pcfg),
              "experts": moe.ep_split(cfg, pcfg),
              "vocab": vocab,
              "vocab_parallel": vocab if pcfg.embed_mode == "vocab_parallel"
              else None}
    for pat, need in _TP_LEAVES:
        if pat.search(path):
            return all(splits[w] is not None for w in need)
    return False


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


def cache_specs_for(cache_tree, pcfg: ParallelConfig, cfg: ModelConfig):
    """PartitionSpecs for a decode cache / recurrent state tree of ``cfg``.

    Leaves are [G, B, ...]: group dim replicated, batch over (pod, data),
    then for KV caches heads over ``model`` when divisible else the sequence
    dim (flash-decoding), else whole; recurrent states shard their first
    model-divisible feature dim.  Under ``layout="tp"`` the blocks follow
    the port's layers where those compute whole or on another dim: an
    attention layer whose heads do not split (``sharding.tp_block``)
    computes whole, so its K / V (and a ring's ``kpos``) stay whole over
    ``model``; a cross block's ``xk`` / ``xv`` are the rank's kv heads
    where its heads and kv heads both split, else whole (it then reads
    its q heads' kv heads from them); a recurrent state is split where
    its layer computes on its block (``transformer.rec_split``): an
    RG-LRU state along the LRU width wherever ``model`` divides it (the
    JAX spec's first dim that ``model`` divides, as ``h`` and the conv
    window's width at ``model`` = 2, 5 or 16), the mLSTM's ``C`` / ``n``
    / ``m`` by heads and its ``conv`` by features, the sLSTM's states
    along ``d`` (the JAX spec wherever ``model`` divides the heads and
    not the conv window's 3 rows), and stays whole where it computes
    whole.
    """
    if pcfg.mesh is None:
        return tree_map(lambda s: P(), cache_tree)
    b = pcfg.data_axes if len(pcfg.data_axes) > 1 else pcfg.data_axes[0]
    msz = pcfg.model_size
    tp = pcfg.layout == "tp"
    whole_attn = tp and tp_block(pcfg, cfg.n_heads) is None
    whole_cross = whole_attn or tp and tp_block(pcfg, cfg.n_kv_heads) is None

    def leaf(path: str, s):
        name = path.split("/")[-1]
        shape = s.shape
        if name in ("k", "v", "xk", "xv"):
            g, bb, S, K, D = shape
            if whole_cross if name in ("xk", "xv") else whole_attn:
                spec = P(None, b, None, None, None)
            elif K % msz == 0:
                spec = P(None, b, None, "model", None)
            elif S % msz == 0:
                spec = P(None, b, "model", None, None)
            else:
                spec = P(None, b, None, None, None)
        elif name == "kpos":
            S = shape[2]
            spec = P(None, b, "model") if S % msz == 0 and not whole_attn \
                else P(None, b, None)
        elif tp and _layer_sym(path, cfg) in ("R", "m", "s"):
            # a recurrent state: whole, or the rank's block
            dims = [None] * len(shape)
            dims[1] = b
            split, cut = transformer.rec_split(_layer_sym(path, cfg), cfg,
                                               pcfg)
            if split is not None:   # cut's dims count from the batch dim
                dims[cut[name] % (len(shape) - 1) + 1] = "model"
            spec = P(*dims)
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


def _layer_sym(path: str, cfg: ModelConfig) -> str:
    """The block-pattern symbol of the layer a cache path lies in."""
    m = re.search(r"layer(\d+)/", path)
    return cfg.block_pattern[int(m.group(1))] if m else ""


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
    # an MoE's experts under the expert all-to-all, and the leaves the
    # tensor-parallel layers compute on their model block: each rank
    # reads its own block alone, so they are gathered over their other
    # axes only
    experts = ("model",) if moe.a2a_route(cfg, inner) else ()
    keep = {p: ("model",) if tp_leaf(p, cfg, inner)
            else experts if _EXPERTS.search(p) else ()
            for p, _ in tree_flatten_with_paths(pshapes)}
    gather = sharded.BlockGather(specs, pshapes, mesh, batch_axes,
                                 keep=keep.__getitem__)

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


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def check_serving_mesh(cfg: ModelConfig, pcfg: ParallelConfig) -> None:
    """Raise unless ``pcfg``'s mesh serves: ``layout="tp"``.  The JAX
    package cannot serve under ``layout="fsdp"`` either: its
    ``cache_specs_for`` names ``model`` twice in a KV cache's spec there
    and raises ``DuplicateSpecError``.  Every shipped config serves under
    ``tp``, as the JAX package's serve steps lower on any ``tp`` mesh:
    the self- and cross-attention (the encoder's too), the dense FFN and
    the MoE's experts compute on the rank's block of their heads, columns
    or experts where the ``model`` size divides them, else whole on every
    ``model`` rank, their caches with them (``cache_specs_for``); an
    RG-LRU layer computes on its slice of the width wherever ``model``
    divides it (``rglru.lru_split``), the mLSTM and sLSTM on the rank's
    heads wherever ``model`` divides them (``xlstm.head_split``), their
    states too, else whole; the frontends on the rank's columns
    (``transformer.frontend_split``); the head on the rank's block of
    the vocabulary where ``model`` divides it."""
    if pcfg.mesh is not None and pcfg.layout != "tp":
        raise NotImplementedError(
            f"the serving mesh runs layout='tp', not {pcfg.layout!r}: the "
            f"JAX package's own cache_specs_for raises DuplicateSpecError "
            f"under layout='fsdp' (the batch dim's axes and the heads' both "
            f"name 'model')")


def _batch_axes(pcfg: ParallelConfig) -> tuple:
    mesh = pcfg.mesh
    if mesh is None:
        return ()
    return mesh.mesh_axes(a for a in pcfg.data_axes if a in mesh.shape)


def serve_rows(x: torch.Tensor, pcfg: ParallelConfig):
    """(this rank's rows of the global ``x``, whether they are a block):
    the leading dim split over the batch axes where it divides them, as
    ``validate_spec`` keeps a cache's batch split; else every row (and
    without a mesh)."""
    axes = _batch_axes(pcfg)
    if not axes or x.shape[0] % pcfg.mesh.axes_size(axes):
        return x, False
    return sharded.batch_rows(x, pcfg.mesh, axes), True


def serve_params(cfg: ModelConfig, pcfg: ParallelConfig, params):
    """What a serving rank computes with, from its blocks ``params``
    (``param_specs_for``): each leaf the layers compute on a ``model``
    block (:func:`tp_leaf`) gathered over the batch axes alone, every
    other leaf gathered whole; once, when serving starts (no weight is
    gathered while it serves).  ``params`` itself without a mesh."""
    mesh = pcfg.mesh
    if mesh is None:
        return params
    shapes = dict(tree_flatten_with_paths(model.param_shapes(cfg)))
    specs = dict(tree_flatten_with_paths(
        param_specs_for(model.param_shapes(cfg), pcfg)))

    def one(path, x):
        keep = ("model",) if tp_leaf(path, cfg, pcfg) else ()
        spec, shape = sharded.without_axes(specs[path], shapes[path].shape,
                                           mesh, keep)
        return sharded.gather_leaf(x, spec, shape, mesh)
    with torch.inference_mode():
        return tree_map_with_path(one, params)


def init_cache_blocks(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
                      seq: int, *, cross_len: int = 0, device=None):
    """A zeroed decode cache of ``batch`` slots and ``seq`` positions
    (``model.init_cache`` on ``device``); on a mesh this rank's block of
    each leaf (:func:`cache_specs_for`), on the mesh's device."""
    from repro_torch.models.common import sds
    if pcfg.mesh is None:
        return model.init_cache(cfg, batch, seq, cross_len=cross_len,
                                device=device)
    mesh = pcfg.mesh
    shapes = model.cache_shapes(cfg, batch, seq, cross_len=cross_len)
    specs = cache_specs_for(shapes, pcfg, cfg)

    def block(s, spec):
        sl = sharded.block_slices(spec, s.shape, mesh)
        return sds(tuple(len(range(*c.indices(n)))
                         for c, n in zip(sl, s.shape)), s.dtype)
    return transformer._zero_state(tree_map(block, shapes, specs),
                                   mesh.device)


def _rows_pcfg(pcfg: ParallelConfig, split: bool) -> ParallelConfig:
    """``pcfg`` for a serve step's rows: ``whole_batch`` where the batch
    did not split over the batch axes (every rank holds it whole)."""
    if pcfg.mesh is None or split:
        return pcfg
    return pcfg.with_(whole_batch=True)


def _global_logits(logits, cfg: ModelConfig, pcfg: ParallelConfig,
                   split: bool):
    """A step's logits ``[B, Vp]`` in float32: a rank's block of the
    vocabulary gathered over ``model`` where it splits
    (``transformer.vocab_split``), then the rows over the batch axes where
    the batch was split over them."""
    logits = logits.float()
    n = transformer.vocab_split(cfg, pcfg)
    if n is not None:
        blocks = sharded.gather_wire(logits, pcfg.mesh, ("model",))
        logits = blocks.view((n[1],) + tuple(logits.shape)).movedim(
            0, -2).reshape(tuple(logits.shape[:-1]) + (-1,))
    if split:
        logits = sharded.gather_wire(logits, pcfg.mesh, _batch_axes(pcfg))
    return logits


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig,
                     max_len: int = 0):
    """Port-only: ``decode(params, cache, token [B, 1], pos [B]) ->
    (logits [B, Vp] float32, new_cache)``.  On a mesh ``token`` and
    ``pos`` are the global batch's (every rank holds them), ``params``
    are :func:`serve_params`, ``cache`` this rank's block of a cache of
    capacity ``max_len`` (:func:`cache_specs_for`); the rank decodes its
    rows, and the logits are gathered over the batch axes, so every rank
    returns the global batch's.  ``max_len`` is required on a mesh."""
    check_serving_mesh(cfg, pcfg)
    if pcfg.mesh is not None and not max_len:
        raise ValueError("make_decode_step on a mesh needs max_len, the "
                         "capacity its cache blocks were made with")

    def decode(params, cache, token, pos):
        rows, split = serve_rows(token, pcfg)
        logits, new_cache = model.decode_step(
            params, cache, rows, serve_rows(pos, pcfg)[0], cfg=cfg,
            pcfg=_rows_pcfg(pcfg, split), max_len=max_len)
        return _global_logits(logits, cfg, pcfg, split), new_cache
    return decode


def make_serve_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    max_len: int = 0):
    """Greedy decode step: (params, cache, token [B,1], pos [B]) ->
    (next_token [B,1], new_cache); on a mesh as :func:`make_decode_step`
    takes its arguments."""
    decode = make_decode_step(cfg, pcfg, max_len)

    def serve_step(params, cache, token, pos):
        logits, new_cache = decode(params, cache, token, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, new_cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig,
                      max_len: int = 0):
    """``prefill_step(params, batch) -> (last_logits float32, cache)``; on
    a mesh ``batch`` is the global batch, ``params`` :func:`serve_params`,
    the cache this rank's block (its rows, where the batch splits over
    the batch axes; a batch that does not split, as one prompt, runs
    whole on every rank) and the last logits the global batch's,
    gathered over the batch axes."""
    check_serving_mesh(cfg, pcfg)

    def prefill_step(params, batch):
        rows, split = {}, False
        for k, v in batch.items():
            rows[k], split = serve_rows(v, pcfg)
        logits, cache = model.prefill(params, rows, cfg=cfg,
                                      pcfg=_rows_pcfg(pcfg, split),
                                      max_len=max_len)
        return _global_logits(logits, cfg, pcfg, split), cache
    return prefill_step
