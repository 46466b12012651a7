"""Rank bodies of the port's LM-mesh tests (``test_torch_mesh_train.py``,
``test_torch_collectives.py``), and the inputs both packages share.

``repro_torch.launch.mesh.run_ranks`` spawns each rank and imports its
function from here by name, so this module imports only numpy, torch and
the port: no JAX, no ``conftest``.  Every rank builds its inputs from the
same seeds (the parameters by the port's ``init_params``, the batches
from numpy), runs on the CPU over gloo, and returns plain data that the
test process holds against the JAX package, which starts from the same
arrays (:func:`init_numpy`, :func:`lm_batch`).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

SEED = 0
B, T = 8, 16                     # the global batch of the step tests
LR, WARMUP, TOTAL = 1e-2, 2, 10  # the JAX package's sharded-step test's
# (arch, layouts): every dense shipped config at the tp layout (the JAX
# step's values do not depend on the layout); two of them at both
PJIT_CASES = {
    "qwen2.5-3b": ("tp", "fsdp"),
    "recurrentgemma-2b": ("tp", "fsdp"),
    "gemma3-12b": ("tp",),
    "qwen3-8b": ("tp",),
    "deepseek-7b": ("tp",),
    "llava-next-mistral-7b": ("tp",),
    "seamless-m4t-large-v2": ("tp",),
    "xlstm-1.3b": ("tp",),
}
MOE_ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
# the MoE step's (layout, moe_dispatch) on the (2, 2) mesh: the global
# grouping under tp, the expert all-to-all under fsdp
MOE_STEPS = (("tp", "einsum"), ("fsdp", "a2a"))
PODWISE_ARCH = "qwen2.5-3b"
# (c): a [4, 256] gradient, one row a pod
POD_SHAPE = (4, 256)


# (l): a tp mesh whose model size divides the LRU width but not the
# RG-LRU gates' 8 blocks: each rank's 16 columns cross the blocks of 6,
# so the layer gathers its conv output over model for the gates; 3 heads
# split over the 3 ranks, the FFN's 128 columns do not, and the local
# layers' ring of 48 slots splits over them for serving
LRU_SPLIT = "recurrentgemma-2b:lru48"
LRU_SPLIT_SHAPE = (1, 3)
# serving on the same (1, 3) mesh, one R, L and A layer each: 4 heads over
# 2 kv heads do not split over 3 ranks, so the attention computes whole
# with a whole cache; 3 heads over 1 kv head split, and the ring of 40
# slots does not, so it stays whole beside the heads' blocks (the full
# cache of 96 slots splits over the sequence)
HEADS_WHOLE = "recurrentgemma-2b:heads4"
RING_WHOLE = "recurrentgemma-2b:ring40"
_RLA = {"lru_width": 48, "local_window": 40, "block_pattern": ("R", "L", "A"),
        "n_layers": 3}
# a variant "<arch>:<tag>" is the reduced config with these fields
VARIANTS = {LRU_SPLIT: {"lru_width": 48, "n_heads": 3, "local_window": 48},
            HEADS_WHOLE: {**_RLA, "n_heads": 4, "n_kv_heads": 2},
            RING_WHOLE: {**_RLA, "n_heads": 3, "n_kv_heads": 1}}


def reduced(get_config, name: str):
    """``name``'s reduced twin by either package's ``get_config``, with
    its variant's fields (``VARIANTS``)."""
    return get_config(name.split(":")[0]).reduced().replace(
        **VARIANTS.get(name, {}))


def lm_cfg(arch: str):
    """The reduced float32 twin of ``arch`` (the port's config)."""
    from repro_torch.configs import get_config
    return reduced(get_config, arch).replace(param_dtype="float32",
                                             compute_dtype="float32")


def init_numpy(cfg, seed: int = SEED) -> dict:
    """{path: array}: the port's ``init_params`` at ``seed`` on the CPU."""
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_flatten_with_paths
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    return {p: x.numpy() for p, x in tree_flatten_with_paths(params)}


def nest(flat: dict) -> dict:
    """A nested dict from {'/'-joined path: leaf}."""
    out: dict = {}
    for path, x in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = x
    return out


def lm_batch(cfg, seed: int = 1, masked=((1, 5), (6, 11))) -> dict:
    """The global batch: ``[B, T]`` tokens, labels with the first ``n``
    of row ``r`` ignored (-1) for each ``(r, n)`` in ``masked``, so rows
    carry unequal token counts; an encoder-decoder's ``enc_frames``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = toks.copy()
    for r, n in masked:
        labels[r, :n] = -1
    out = {"inputs": toks, "labels": labels}
    if cfg.is_encoder_decoder:
        out["enc_frames"] = rng.normal(size=(B, T, cfg.d_model)) \
            .astype(np.float32)
    return out


# the pjit cases whose gathers and tensor-parallel sums are recorded
TP_LOGGED = ("recurrentgemma-2b", "qwen2.5-3b")
# podwise against pjit: each pod's rows hold the same valid tokens, so
# the pods' plain mean is the token-weighted mean
POD_MASKED = ((1, 5), (5, 5))
# microbatch accumulation on the (2, 2) mesh: (arch, layout, dispatch);
# lm_batch's masked rows 1 and 6 put 59 and 53 valid tokens in the two
# global microbatches, so their means differ from the global mean
ACCUM = 2
ACCUM_CASES = (("qwen2.5-3b", "tp", "einsum"), ("qwen2.5-3b", "fsdp", "einsum"),
               ("qwen3-moe-30b-a3b", "tp", "einsum"),
               ("qwen3-moe-30b-a3b", "fsdp", "a2a"))


def _flat_np(tree) -> dict:
    from repro_torch.utils.pytree import tree_flatten_with_paths
    return {p: x.detach().float().numpy() for p, x in
            tree_flatten_with_paths(tree)}


def _recorded(sharded, log: dict):
    """``sharded.gather_leaf`` wrapped to append to ``log["shapes"]`` the
    whole shape of each gather that hands bytes to the wire."""
    real = sharded.gather_leaf

    def gather_leaf(x, spec, shape, mesh):
        before = sharded.WIRE["gather"]
        out = real(x, spec, shape, mesh)
        if sharded.WIRE["gather"] > before:
            log["shapes"].append(tuple(shape))
        return out
    return real, gather_leaf


def _mesh_step(cfg, mesh, batch_np, log=None, **pcfg_kw):
    """One port train step on ``mesh`` from :func:`init_numpy`; returns
    (metrics, the whole updated parameters and first moments, each as
    {path: array}).  ``log`` (a dict) takes the step's bytes by ``WIRE``
    key and the shapes of its gathers (:func:`_recorded`)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models import model
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    pcfg = ParallelConfig(**{"mesh": mesh, "remat": "none", **pcfg_kw})
    pshapes = model.param_shapes(cfg)
    specs = param_specs_for(pshapes, pcfg)
    params = params_from_jax(nest(init_numpy(cfg)), specs=specs, mesh=mesh)
    ocfg = optim.AdamWConfig(lr=LR, error_feedback=(
        pcfg.compress_pod == "int8_ef"))
    opt = optim.init_state(params, ocfg)
    step = tstep.make_train_step(cfg, pcfg, ocfg,
                                 optim.warmup_cosine(LR, WARMUP, TOTAL))
    batch = tstep.local_batch(
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, pcfg)
    if log is None:
        params, opt, metrics = step(params, opt, batch)
    else:
        before = dict(sharded.WIRE)
        log["shapes"] = []
        real, sharded.gather_leaf = _recorded(sharded, log)
        try:
            params, opt, metrics = step(params, opt, batch)
        finally:
            sharded.gather_leaf = real
        log["wire"] = {k: v - before[k] for k, v in sharded.WIRE.items()}
    whole = sharded.gather_tree({"p": params, "m": opt["m"]},
                                {"p": specs, "m": specs},
                                {"p": pshapes, "m": pshapes}, mesh)
    return ({k: float(v) for k, v in metrics.items()}, _flat_np(whole["p"]),
            _flat_np(whole["m"]))


# ------------------------------------------------------------ (a), (b), (e)
def mesh_train_suite(rank: int, world: int):
    """Every pjit case on a ``(data, model) = (2, 2)`` mesh, the MoE
    configs at each of ``MOE_STEPS``; podwise ``none`` and pjit on
    ``(pod, data, model) = (2, 2, 1)``, and podwise ``none`` of the MoE
    configs."""
    from repro_torch.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    out = {"pjit": {}, "moe": {}}
    for arch, layouts in PJIT_CASES.items():
        cfg = lm_cfg(arch)
        for layout in layouts:
            log = None
            if layout == "tp" and arch in TP_LOGGED:
                log = out.setdefault("logs", {})["pjit", arch] = {}
            out["pjit"][arch, layout] = _mesh_step(
                cfg, mesh, lm_batch(cfg), log, layout=layout)
    for arch in MOE_ARCHS:
        cfg = lm_cfg(arch)
        for layout, dispatch in MOE_STEPS:
            out["moe"][arch, layout] = _mesh_step(
                cfg, mesh, lm_batch(cfg), layout=layout,
                moe_dispatch=dispatch)
    # under full remat the backward runs each unit's forward again, its
    # collectives too: every rank must issue them in the same order
    cfg = lm_cfg(MOE_ARCHS[0])
    out["moe_remat"] = {}
    for layout, dispatch in MOE_STEPS:
        log = out["logs"]["moe_remat", layout] = {}
        out["moe_remat"][layout] = _mesh_step(
            cfg, mesh, lm_batch(cfg), log, layout=layout,
            moe_dispatch=dispatch, remat="full")
    out["accum"] = {}
    for arch, layout, dispatch in ACCUM_CASES:
        cfg = lm_cfg(arch)
        log = out["logs"]["accum", arch, layout] = {}
        out["accum"][arch, layout] = _mesh_step(
            cfg, mesh, lm_batch(cfg), log, layout=layout,
            moe_dispatch=dispatch, accum_steps=ACCUM)
    pod = make_mesh_compat((2, 2, 1), ("pod", "data", "model"),
                           device="cpu")
    cfg = lm_cfg(PODWISE_ARCH)
    batch = lm_batch(cfg, masked=POD_MASKED)
    out["pod"] = {mode: _mesh_step(cfg, pod, batch, multi_pod=True,
                                   mode=mode)
                  for mode in ("pjit", "podwise")}
    out["pod"]["podwise_accum"] = _mesh_step(
        cfg, pod, batch, multi_pod=True, mode="podwise", accum_steps=ACCUM)
    out["pod_moe"] = {arch: _mesh_step(
        lm_cfg(arch), pod, lm_batch(lm_cfg(arch), masked=POD_MASKED),
        multi_pod=True, mode="podwise") for arch in MOE_ARCHS}
    out["gather_block"] = gather_block_cases(mesh)
    out["tp_collectives"] = tp_collective_case(mesh)
    # the serving mesh on (2, 2), (1, 4) and, on ranks 0 and 1, (1, 2)
    meshes = {(2, 2): mesh,
              (1, 4): make_mesh_compat((1, 4), ("data", "model"),
                                       device="cpu"),
              (1, 2): make_mesh_compat((1, 2), ("data", "model"),
                                       device="cpu", ranks=range(2))}
    pair = meshes[1, 2]
    out["serve"] = {}
    for arch, shape in SERVE_CASES:
        if meshes[shape] is not None:
            out["serve"][arch, shape] = serve_case(serve_cfg(arch),
                                                   meshes[shape])
    if pair is not None:
        out["seq_decode"] = seq_split_decode_case(pair)
    trio = make_mesh_compat(LRU_SPLIT_SHAPE, ("data", "model"),
                            device="cpu", ranks=range(3))
    if trio is not None:
        out["lru_split"] = lru_split_case(trio)
        out["serve_whole"] = {v: serve_case(serve_cfg(v), trio)
                              for v in (HEADS_WHOLE, RING_WHOLE)}
    out["launcher"] = _launcher_rank(rank, world)
    return out if rank == 0 else None


# (spec, whole shape, batch axes, axes kept): a leaf split over both
# axes, an expert stack kept whole over model (the a2a route), a
# replicated leaf (its backward an all-reduce), and a leaf split over
# model under tp, whose model ranks compute the same rows
GATHER_CASES = (
    (("data", "model"), (8, 6), ("data", "model"), ()),
    (("model", "data", None), (4, 6, 2), ("data", "model"), ("model",)),
    ((), (6,), ("data", "model"), ()),
    (("model", None), (4, 3), ("data",), ()),
)


def gather_block_cases(mesh) -> list:
    """Each of ``GATHER_CASES`` on this rank of the ``(2, 2)`` mesh: the
    gathered leaf against the whole one (or its block over the kept
    axes); the gradient of ``sum(gathered * C_r)`` for a cotangent
    ``C_r`` of rank ``r``'s own against ``reduce_scatter_leaf`` of
    ``C_r`` and against the sum of the ``C`` of the ranks that share
    this rank's block and rows' reduction, read off numpy (every rank
    makes every ``C`` from its seed)."""
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import P
    out = []
    for i, (spec, shape, batch, keep) in enumerate(GATHER_CASES):
        spec = P(*spec)
        whole = np.random.default_rng(10 + i).normal(size=shape) \
            .astype(np.float32)
        x = sharded.local_block(torch.from_numpy(whole), spec, mesh) \
            .clone().requires_grad_()
        y = sharded.gather_block(x, spec, shape, mesh, batch, keep)
        part, pshape = sharded.without_axes(spec, shape, mesh, keep)
        kept = sharded.block_slices(P(*[
            e if e in keep else None for e in spec]), shape, mesh)
        cots = [np.random.default_rng(100 * i + r).normal(size=pshape)
                .astype(np.float32) for r in range(mesh.size)]
        mine = torch.from_numpy(cots[mesh.rank])
        (y * mine).sum().backward()
        want = sharded.reduce_scatter_leaf(
            mine.clone(), part, mesh,
            tuple(a for a in batch if a not in keep))
        # the ranks whose gradients sum into this rank's block: those on
        # the same coordinates along every axis but the summed ones
        summed = [a for a in batch if a not in keep]
        dims = tuple(mesh.shape.values())
        me = np.unravel_index(mesh.rank, dims)
        peers = [r for r in range(mesh.size) if all(
            c == m for a, c, m in zip(mesh.axis_names,
                                      np.unravel_index(r, dims), me)
            if a not in summed)]
        total = torch.from_numpy(sum(cots[r] for r in peers))
        truth = sharded.block_slices(part, pshape, mesh)
        out.append({"forward": bool(torch.equal(
                        y.detach(), torch.from_numpy(whole)[kept])),
                    "shape": tuple(y.shape), "block": tuple(x.shape),
                    "grad": x.grad.numpy(), "rs": want.numpy(),
                    "truth": total[truth].numpy()})
    return out


# ------------------------------------------------------------ the MoE layer
MOE_ARCH = "qwen3-moe-30b-a3b"
# name: (mesh shape over (data, model), layout, moe_dispatch, capacity
# factor, (B, T), GROUP_SIZE): the expert all-to-all on (1, 2) and (2, 2)
# under fsdp, the global grouping of einsum and gather under tp, each
# also at a factor of 0.5 that drops slots, the 8 experts split 4 a model
# rank (also on (1, 2), one batch rank); under tp on (1, 3), whose 3 ranks
# do not divide the 8 experts, the layer whole on every rank; and gather
# under fsdp over 4 batch ranks whose 24 tokens straddle groups of 32
MOE_MESH_CASES = {
    "a2a-1x2": ((1, 2), "fsdp", "a2a", 1.25, (B, T), 4096),
    "a2a-1x2-drops": ((1, 2), "fsdp", "a2a", 0.5, (B, T), 4096),
    "a2a-2x2": ((2, 2), "fsdp", "a2a", 1.25, (B, T), 4096),
    "a2a-2x2-drops": ((2, 2), "fsdp", "a2a", 0.5, (B, T), 4096),
    "einsum-tp": ((2, 2), "tp", "einsum", 1.25, (B, T), 4096),
    "einsum-tp-drops": ((2, 2), "tp", "einsum", 0.5, (B, T), 4096),
    "gather-tp": ((2, 2), "tp", "gather", 1.25, (B, T), 4096),
    "gather-tp-drops": ((2, 2), "tp", "gather", 0.5, (B, T), 4096),
    "einsum-tp-1x2": ((1, 2), "tp", "einsum", 1.25, (B, T), 4096),
    "gather-tp-1x3-whole": ((1, 3), "tp", "gather", 1.25, (B, T), 4096),
    "gather-fsdp-straddle": ((2, 2), "fsdp", "gather", 1.25, (B, 12), 64),
}


def moe_inputs(cfg, shape, seed: int = 5) -> tuple:
    """(the MoE layer's parameters, x [B, T, d], a cotangent of the output)
    as float32 numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def normal(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)
    params = {"router": normal(d, e, scale=d ** -0.5),
              "wi": normal(e, d, f, scale=d ** -0.5),
              "wg": normal(e, d, f, scale=d ** -0.5),
              "wo": normal(e, f, d, scale=f ** -0.5)}
    return params, normal(*shape, d), normal(*shape, d)


def moe_mesh_suite(rank: int, world: int):
    """Every ``MOE_MESH_CASES`` case on this rank's rows: ``moe.apply``'s
    output and aux, and the gradients of ``sum(out * ct) + aux`` (the aux
    term weighted by 1 / the batch ranks, the token shares of equal
    rows) by ``x`` (its rows) and by each parameter (summed over the
    batch ranks).  Where ``moe.ep_split`` splits the experts the rank
    holds its block of ``wi`` / ``wg`` / ``wo`` alone, and their
    gradients are gathered over ``model``; the capacity each dispatch
    call was given (``C_l``) is recorded with the rank's model index."""
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import moe
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import ParallelConfig
    cfg = lm_cfg(MOE_ARCH)
    axes = ("data", "model")
    meshes = {(2, 2): make_mesh_compat((2, 2), axes, device="cpu"),
              (1, 2): make_mesh_compat((1, 2), axes, device="cpu",
                                       ranks=range(2)),
              (1, 3): make_mesh_compat((1, 3), axes, device="cpu",
                                       ranks=range(3))}
    out = {}
    saved = moe.CAPACITY_FACTOR, moe.GROUP_SIZE, moe._apply_einsum, \
        moe._apply_gather
    caps = []

    def recording(fn):
        def call(*args):
            caps.append(args[6])
            return fn(*args)
        return call
    for name, (shape, layout, dispatch, factor, bt, group) in \
            MOE_MESH_CASES.items():
        mesh = meshes[shape]
        if mesh is None:
            continue
        pcfg = ParallelConfig(mesh=mesh, layout=layout, moe_dispatch=dispatch)
        block = moe.ep_split(cfg, pcfg)
        p_np, x_np, ct_np = moe_inputs(cfg, bt)
        if block is not None:
            el = cfg.n_experts // block[1]
            p_np = {k: v[block[0] * el:(block[0] + 1) * el]
                    if k != "router" else v for k, v in p_np.items()}
        params = {k: torch.from_numpy(v).requires_grad_()
                  for k, v in p_np.items()}
        x = sharded.batch_rows(torch.from_numpy(x_np), mesh,
                               pcfg.data_axes).clone().requires_grad_()
        ct = sharded.batch_rows(torch.from_numpy(ct_np), mesh,
                                pcfg.data_axes)
        ranks = moe._batch_ranks(pcfg)
        batch_axes, size = (ranks.axes, ranks.size) if ranks else ((), 1)
        caps.clear()
        moe.CAPACITY_FACTOR, moe.GROUP_SIZE = factor, group
        moe._apply_einsum = recording(saved[2])
        moe._apply_gather = recording(saved[3])
        try:
            o, aux = moe.apply(params, x, cfg=cfg, pcfg=pcfg)
            ((o * ct).sum() + aux / size).backward()
        finally:
            (moe.CAPACITY_FACTOR, moe.GROUP_SIZE, moe._apply_einsum,
             moe._apply_gather) = saved
        grads = {}
        for k, p in params.items():
            g = sharded.all_reduce(p.grad, mesh, batch_axes)
            if block is not None and k != "router":
                g = sharded.gather_wire(g.contiguous(), mesh, ("model",))
            grads[k] = g.numpy()
        out[name] = {
            "index": ranks.index if ranks else 0, "out": o.detach().numpy(),
            "aux": float(aux), "gx": x.grad.numpy(), "grads": grads,
            "model_index": mesh.axis_index("model"), "block": block,
            "experts": tuple(p_np["wi"].shape), "caps": list(caps)}
    return out


# ------------------------------------------------------------ (c), (d)
def pod_grads(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=POD_SHAPE) \
        .astype(np.float32)


def collectives_suite(rank: int, world: int):
    """(c) ``cross_pod_mean`` over 4 pods, every mode, row ``rank`` of
    :func:`pod_grads` a pod; the bytes each mode hands to the wire.
    (d) ``global_norm`` of a tree's blocks on a ``(2, 2)`` mesh, a
    replicated leaf and one whose spec ``validate_spec`` dropped
    included."""
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel import collectives, sharded
    from repro_torch.parallel.sharding import P, validate_spec
    from repro_torch.train import optim
    pods = make_mesh_compat((world, 1, 1), ("pod", "data", "model"),
                            device="cpu")
    g = torch.from_numpy(pod_grads()[rank].copy())
    out = {}
    for mode in ("none", "bf16", "int8_ef"):
        before = collectives.WIRE["pod"]
        ef = {"w": torch.zeros_like(g)} if mode == "int8_ef" else None
        mean, ef2 = collectives.cross_pod_mean(
            {"w": g.clone()}, mesh=pods, compress=mode, ef_state=ef)
        out[mode] = (mean["w"].numpy(), None if ef2 is None
                     else ef2["w"].numpy(),
                     collectives.WIRE["pod"] - before)
    # the int8 residual carried into a second round
    mean, ef3 = collectives.cross_pod_mean(
        {"w": g.clone()}, mesh=pods, compress="int8_ef",
        ef_state={"w": torch.from_numpy(out["int8_ef"][1].copy())})
    out["int8_ef_2"] = (mean["w"].numpy(), ef3["w"].numpy())
    out["ratio"] = collectives.pod_efficiency_ratio(2.0, 1.0)
    # (d): whole leaves from one seed; each rank keeps its blocks
    grid = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
    rng = np.random.default_rng(3)
    whole = {"w": rng.normal(size=(8, 6)), "odd": rng.normal(size=(5, 4)),
             "scale": rng.normal(size=(6,)), "one": rng.normal(size=(1,))}
    whole = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in whole.items()}
    sizes = dict(grid.shape)
    specs = {"w": P("data", "model"), "scale": P(),
             "odd": validate_spec(P("data", "model"), (5, 4), sizes),
             "one": validate_spec(P("model"), (1,), sizes)}
    blocks = sharded.shard_tree(whole, specs, grid)
    out["norm"] = float(optim.global_norm(blocks, specs=specs, mesh=grid))
    out["norm_specs"] = {k: tuple(v) for k, v in specs.items()}
    out["block_shapes"] = {k: tuple(v.shape) for k, v in blocks.items()}
    regathered = sharded.gather_tree(blocks, specs, whole, grid)
    out["roundtrip"] = all(torch.equal(regathered[k], whole[k])
                           for k in whole)
    return out


# ------------------------------------------------------------ (f), (g)
def _trainer(cfg, mesh, tmp: Path, *, steps=2, ckpt_every=2, log_every=1,
             seed=0, tag="ck", tokens=20_000, seq=16, batch=4):
    """A Trainer on ``mesh`` (or one CPU device) over its own Sector
    cloud under ``tmp``: a corpus from seed 1, the checkpointer ``tag``."""
    from repro_torch.data import (DataPipeline, SectorTokenDataset,
                                  write_synthetic_corpus)
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
    from torch_mesh_ranks import cloud
    tmp.mkdir(parents=True, exist_ok=True)
    master, client = cloud(tmp, chunk_records=640)
    write_synthetic_corpus(client, "c", tokens, cfg.vocab_size, seed=1)
    ds = SectorTokenDataset(master, client, "c", seq_len=seq)
    pcfg = ParallelConfig(mesh=mesh, remat="none")
    pipe = DataPipeline(ds, batch=batch, pcfg=pcfg, device="cpu")
    return Trainer(cfg, pcfg, TrainerConfig(
        steps=steps, ckpt_every=ckpt_every, log_every=log_every, lr=1e-3,
        warmup=1, seed=seed), pipe, SectorCheckpointer(client, tag),
        device="cpu"), client


CKPT_ARCH = "qwen2.5-3b"


def ckpt_files(client, tag: str, step: int) -> dict:
    """{name: bytes} of one checkpoint's payload and manifest."""
    base = f"ckpt/{tag}/step_{step:08d}"
    return {n: client.download(n) for n in (base + ".bin",
                                            base + ".manifest.json")}


def upload(client, files: dict) -> None:
    for name, data in files.items():
        client.upload(name, data, replication=2)


def whole_tree(trainer) -> dict:
    """The trainer's {params, opt} as whole leaves {path: array}."""
    from repro_torch.parallel import sharded
    tree = trainer._tree()
    if trainer.mesh is not None:
        tree = sharded.gather_tree(tree, trainer._specs(),
                                   trainer._shapes(), trainer.mesh)
    return _flat_np(tree)


def ckpt_suite(rank: int, world: int, tmp: str, single_files: dict):
    """(f) on a ``(data, model) = (2, 1)`` mesh: train 2 steps and save
    (rank 0 writes); restore a checkpoint written on one device."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat((world, 1), ("data", "model"), device="cpu")
    cfg = get_config(CKPT_ARCH).reduced()
    tr, client = _trainer(cfg, mesh, Path(tmp) / f"w{rank}")
    tr.run(2)
    out = {"written": whole_tree(tr), "cursor": tr.pipeline.state_dict()}
    if rank == 0:
        out["files"] = ckpt_files(client, "ck", 2)
    # the reverse: a checkpoint written on one device, in this rank's
    # own cloud, restored onto the mesh
    tr2, client2 = _trainer(cfg, mesh, Path(tmp) / f"r{rank}",
                            tag="single")
    assert tr2.step_idx == 0
    upload(client2, single_files)
    tr2._build()
    out["restored_step"] = tr2.step_idx
    out["restored"] = whole_tree(tr2)
    out["restored_cursor"] = tr2.pipeline.state_dict()
    return out if rank == 0 else None


def elastic_suite(rank: int, world: int, tmp: str):
    """(g): the JAX package's three elastic scenarios (a lost rank, two,
    and giving up), each on a 2-rank mesh shrinking to 1; and the
    uninterrupted 12 steps on the 2-rank mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.train.elastic import ElasticController, HostFailure
    cfg = get_config("qwen2.5-3b").reduced().replace(
        param_dtype="float32", compute_dtype="float32")

    def make_mesh(n):
        return make_mesh_compat((n, 1), ("data", "model"), device="cpu",
                                ranks=range(n))

    out = {}
    for name, fail_at, max_restarts in (("restart", [6], 3),
                                        ("twice", [4, 8], 3),
                                        ("give_up", [2, 4, 6], 1)):
        tr, _ = _trainer(cfg, make_mesh(world), Path(tmp) / name / str(rank),
                         steps=12, ckpt_every=4, log_every=2, seq=32,
                         tokens=300_000)
        ctl = ElasticController(tr, make_mesh=make_mesh,
                                max_restarts=max_restarts)
        try:
            res = ctl.run_with_failures(12, fail_at=fail_at)
            out[name] = {"restarts": res["restarts"],
                         "final_step": res["final_step"],
                         "left_out": res.get("left_out", False),
                         "history": [(h["step"], h["loss"])
                                     for h in res["history"]]}
        except HostFailure as e:
            out[name] = {"raised": str(e)}
    tr, _ = _trainer(cfg, make_mesh(world), Path(tmp) / "whole" / str(rank),
                     steps=12, ckpt_every=4, log_every=2, seq=32,
                     tokens=300_000)
    out["whole"] = [(h["step"], h["loss"]) for h in tr.run(12)]
    return out


# ------------------------------------------------------------ on the card
def cuda_mesh_suite(rank: int, world: int):
    """On the card, ranks sharing it over gloo (host-staged):
    ``cross_pod_mean`` of every mode on CUDA tensors against the same
    call on the same values on the CPU; ``shard_tree`` / ``gather_tree``
    and ``global_norm`` of blocks on a ``(data, model) = (world, 1)``
    mesh."""
    import dataclasses

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel import collectives, sharded
    from repro_torch.parallel.sharding import P
    from repro_torch.train import optim
    pods = make_mesh_compat((world, 1, 1), ("pod", "data", "model"))
    cpu = dataclasses.replace(pods, device=torch.device("cpu"))
    g = np.random.default_rng(7).normal(size=(world, 3, 1000)) \
        .astype(np.float32)[rank]
    out = {"staged": pods.host_staged, "device": str(pods.device)}
    for mode in ("none", "bf16", "int8_ef"):
        res = []
        for mesh in (pods, cpu):
            x = torch.from_numpy(g.copy()).to(mesh.device)
            ef = {"w": torch.zeros_like(x)} if mode == "int8_ef" else None
            mean, ef2 = collectives.cross_pod_mean(
                {"w": x}, mesh=mesh, compress=mode, ef_state=ef)
            res.append((mean["w"].cpu().numpy(),
                        None if ef2 is None else ef2["w"].cpu().numpy()))
        out[mode] = res
    grid = make_mesh_compat((world, 1), ("data", "model"))
    whole = {"w": torch.randn(8, 6, generator=torch.Generator()
                              .manual_seed(2)),
             "b": torch.randn(5, generator=torch.Generator().manual_seed(3))}
    specs = {"w": P("data", "model"), "b": P()}
    blocks = sharded.shard_tree({k: v.cuda() for k, v in whole.items()},
                                specs, grid)
    back = sharded.gather_tree(blocks, specs, whole, grid)
    out["roundtrip"] = all(torch.equal(back[k].cpu(), whole[k])
                           for k in whole)
    out["on_card"] = all(x.is_cuda for x in back.values())
    out["norm"] = float(optim.global_norm(blocks, specs=specs, mesh=grid))
    out["whole_norm"] = float(optim.global_norm(whole))
    return out


# ------------------------------------------------------------ serving mesh
# the configs the serving mesh holds to the JAX package: the sequence-split
# ring caches and the RG-LRU width split, heads-split caches, and a
# heads-split cache whose ring kpos splits over the sequence
SERVE_ARCHS = ("recurrentgemma-2b", "qwen2.5-3b", "gemma3-12b")
# (arch, (data, model)): each on (2, 2) and (1, 2); qwen2.5-3b also on
# (1, 4), where its 2 kv heads do not split: whole K / V, a cache split
# over the sequence, 2 q heads a rank over one kv head.  The other
# families: the MoE's 8 experts 4 a model rank on (2, 2) and (1, 2); the
# encoder-decoder's encoder, decoder and cross blocks on 2 of 4 heads a
# rank (its 2 kv heads split, so do the cross caches); the xLSTM's mLSTM
# and sLSTM on 2 of 4 heads a rank, their states by heads
SERVE_CASES = [(a, s) for a in SERVE_ARCHS for s in ((2, 2), (1, 2))] \
    + [("qwen2.5-3b", (1, 4)), ("qwen3-moe-30b-a3b", (2, 2)),
       ("qwen3-moe-30b-a3b", (1, 2)), ("seamless-m4t-large-v2", (1, 2)),
       ("xlstm-1.3b", (1, 2))]
SERVE_B, SERVE_T = 4, 80        # the prefill batch, past the window of 64
SERVE_LEN = 96                  # the cache's capacity
SERVE_SLOTS, SERVE_NEW = 4, 6
SERVE_LENGTHS = (20, 70) * 3    # 6 requests over 4 slots
SERVE_FRAMES = 48               # an encoder-decoder's prefill batch frames
# its requests' frames: the pool's 96 rows, or 40, which write only their
# prefix of a recycled slot's rows (the fault both engines share)
SERVE_FRAME_LENGTHS = (SERVE_LEN, 40) * 3


def serve_cfg(arch: str):
    """:func:`lm_cfg` cut to one pattern unit where the reduced config
    repeats a unit of several layers (every layer kind stays)."""
    cfg = lm_cfg(arch)
    if cfg.pattern_len > 1 and cfg.n_groups > 1:
        cfg = cfg.replace(n_layers=cfg.pattern_len)
    return cfg


def serve_batch(cfg) -> np.ndarray:
    return np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_T)).astype(np.int32)


def serve_prompts(cfg) -> list:
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
            for n in SERVE_LENGTHS]


def serve_inputs(cfg) -> dict:
    """The prefill batch: :func:`serve_batch`'s tokens and an
    encoder-decoder's ``enc_frames`` ``[SERVE_B, SERVE_FRAMES, d]``."""
    out = {"inputs": serve_batch(cfg)}
    if cfg.is_encoder_decoder:
        out["enc_frames"] = np.random.default_rng(4).normal(
            size=(SERVE_B, SERVE_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def serve_request_frames(cfg) -> list:
    """Each of :func:`serve_prompts`' requests' ``enc_frames`` ``[1, F,
    d]`` (``SERVE_FRAME_LENGTHS``), None without an encoder."""
    if not cfg.is_encoder_decoder:
        return [None] * len(SERVE_LENGTHS)
    rng = np.random.default_rng(5)
    return [rng.normal(size=(1, n, cfg.d_model)).astype(np.float32)
            for n in SERVE_FRAME_LENGTHS]


def serve_case(cfg, mesh) -> dict:
    """The serve steps and the engine on ``mesh`` (``layout="tp"``) from
    :func:`init_numpy`'s blocks: the prefill's last logits of
    :func:`serve_inputs` (capacity ``SERVE_LEN``), one decode step's
    logits and greedy tokens from its cache, the greedy token streams of
    :func:`serve_prompts` (with :func:`serve_request_frames`), the
    prefill's cache blocks and the shapes of
    the pool's; the bytes the serve steps handed to each collective, and
    of those the bytes of ``sharded.all_gather``'s calls (the RG-LRU's
    conv output where its gate blocks do not split over ``model``)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models import model
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
    from repro_torch.serve import SamplerConfig, ServeEngine
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths
    pcfg = ParallelConfig(mesh=mesh)
    blocks = params_from_jax(nest(init_numpy(cfg)), specs=param_specs_for(
        model.param_shapes(cfg), pcfg), mesh=mesh)
    params = tstep.serve_params(cfg, pcfg, blocks)
    batch = {k: torch.from_numpy(v) for k, v in serve_inputs(cfg).items()}
    toks = batch["inputs"]
    pos = torch.full((SERVE_B,), SERVE_T, dtype=torch.int32)
    before = dict(sharded.WIRE)
    gathered, real_gather = [], sharded.all_gather

    def all_gather(x, mesh_, axes):
        gathered.append(x.nbytes)
        return real_gather(x, mesh_, axes)
    sharded.all_gather = all_gather
    try:
        with torch.inference_mode():
            logits, cache = tstep.make_prefill_step(cfg, pcfg, SERVE_LEN)(
                params, batch)
            dec, _ = tstep.make_decode_step(cfg, pcfg, SERVE_LEN)(
                params, cache, toks[:, -1:], pos)
            nxt, _ = tstep.make_serve_step(cfg, pcfg, SERVE_LEN)(
                params, cache, toks[:, -1:], pos)
    finally:
        sharded.all_gather = real_gather
    wire = {k: v - before[k] for k, v in sharded.WIRE.items()}
    eng = ServeEngine(cfg, blocks, pcfg, max_batch=SERVE_SLOTS,
                      max_len=SERVE_LEN, scfg=SamplerConfig())
    reqs = [eng.submit(p, max_new=SERVE_NEW, enc_frames=f) for p, f in
            zip(serve_prompts(cfg), serve_request_frames(cfg))]
    eng.run()
    return {"prefill": logits.numpy(), "decode": dec.numpy(),
            "next": nxt.numpy(), "tokens": [r.out for r in reqs],
            "wire": wire, "autograd_gather": sum(gathered),
            "cache": {p: x.numpy()
                      for p, x in tree_flatten_with_paths(cache)},
            "pool": {p: tuple(x.shape)
                     for p, x in tree_flatten_with_paths(eng.cache)}}


def tp_collective_case(mesh) -> dict:
    """``copy_to_model`` then each ``model`` rank's own product, then
    ``reduce_from_model``: the output and the gradients of ``sum(out *
    C)`` by ``x`` and by this rank's ``w``, beside the inputs every rank
    makes from one seed (``W`` holds each ``model`` rank's ``w``)."""
    from repro_torch.parallel import sharded
    rng = np.random.default_rng(21)
    x_np = rng.normal(size=(3, 5)).astype(np.float32)
    w_np = rng.normal(size=(2, 5, 4)).astype(np.float32)
    c_np = rng.normal(size=(3, 4)).astype(np.float32)
    i = mesh.axis_index("model")
    x = torch.from_numpy(x_np).requires_grad_()
    w = torch.from_numpy(w_np[i].copy()).requires_grad_()
    before = sharded.WIRE["tp_all_reduce"]
    out = sharded.reduce_from_model(sharded.copy_to_model(x, mesh) @ w, mesh)
    (out * torch.from_numpy(c_np)).sum().backward()
    return {"x": x_np, "W": w_np, "C": c_np, "index": i,
            "out": out.detach().numpy(), "gx": x.grad.numpy(),
            "gw": w.grad.numpy(),
            "wire": sharded.WIRE["tp_all_reduce"] - before}


def seq_split_decode_case(mesh) -> dict:
    """One decode step of a ring cache split over the sequence on the
    ``(1, 2)`` mesh against ``decode_attention`` on the whole cache, from
    one seed: 4 heads over 1 kv head, 64 slots, window 64.  Rank 0's
    block (slots 0-31) holds no key of row 0 (``kpos = -1``) and only
    keys outside the window of row 1; row 2's new token lands in it."""
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import ParallelConfig
    cfg = serve_cfg("recurrentgemma-2b")
    pcfg = ParallelConfig(mesh=mesh)
    rng = np.random.default_rng(22)
    B, S, D = 3, cfg.local_window, cfg.d_head
    H = cfg.n_heads
    pos = np.array([122, 160, 135], np.int32)
    # the positions each row holds, each at slot p % S
    held = (range(96, 122), list(range(64, 96)) + list(range(97, 128)),
            range(72, 135))
    kpos = np.full((B, S), -1, np.int32)
    for b, ps in enumerate(held):
        for q_pos in ps:
            kpos[b, q_pos % S] = q_pos
    whole = {"k": torch.from_numpy(rng.normal(size=(B, S, 1, D))
                                   .astype(np.float32)),
             "v": torch.from_numpy(rng.normal(size=(B, S, 1, D))
                                   .astype(np.float32)),
             "kpos": torch.from_numpy(kpos)}
    q = torch.from_numpy(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    kn = torch.from_numpy(rng.normal(size=(B, 1, 1, D)).astype(np.float32))
    vn = torch.from_numpy(rng.normal(size=(B, 1, 1, D)).astype(np.float32))
    p = torch.from_numpy(pos)
    i, n = mesh.axis_index("model"), 2
    new_whole = attention.update_cache(whole, kn, vn, p)
    want = attention.decode_attention(q, new_whole, p,
                                      window=cfg.local_window)
    block = {k: attention._seq_block(v, i, n).contiguous()
             for k, v in whole.items()}
    hm = H // n
    with torch.inference_mode():
        got, new_block = attention._decode_seq_split(
            q[:, :, i * hm:(i + 1) * hm], kn, vn, block, p, cfg=cfg,
            pcfg=pcfg, window=cfg.local_window, index=i, size=n)
    valid = (kpos >= 0) & (kpos <= pos[:, None]) \
        & (pos[:, None] - kpos < cfg.local_window)
    return {"got": got.numpy(), "want": want[:, :, i * hm:(i + 1) * hm]
            .numpy(), "index": i,
            "block_valid": valid[:, i * S // n:(i + 1) * S // n]
            .any(axis=1).tolist(),
            "cache": all(torch.equal(new_block[k], attention._seq_block(
                new_whole[k], i, n)) for k in whole)}


def lru_split_case(mesh) -> dict:
    """(l) ``LRU_SPLIT`` on ``mesh``, ``layout="tp"``: one train step
    (:func:`_mesh_step`, the bytes it handed to each collective) and the
    serve steps and engine (:func:`serve_case` at one pattern unit)."""
    from repro_torch.models import rglru
    from repro_torch.parallel.sharding import ParallelConfig
    log = {}
    step = _mesh_step(lm_cfg(LRU_SPLIT), mesh, lm_batch(lm_cfg(LRU_SPLIT)),
                      log, layout="tp")
    cfg = serve_cfg(LRU_SPLIT)
    return {"step": step, "wire": log["wire"],
            "split": rglru.lru_split(cfg, ParallelConfig(mesh=mesh)),
            "serve": serve_case(cfg, mesh)}


def _launcher_rank(rank: int, world: int) -> dict:
    """The serving launcher's rank body on the suite's 4 ranks (the
    ``(2, 2)`` mesh of ``--ranks 4``), with few requests."""
    from repro_torch.launch import serve as slaunch
    return slaunch._serve_rank(rank, world, [
        "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--ranks",
        str(world), "--requests", "4", "--max-new", "4"])


# ------------------------------------------------------------ the dry run
# train steps whose bytes a step by collective the dry run must count
# exactly: (arch, (data, model), layout, MoE dispatch)
DRYRUN_WIRE_CASES = (("qwen2.5-3b", (2, 1), "tp", "einsum"),
                     ("qwen2.5-3b", (1, 2), "tp", "einsum"),
                     ("qwen2.5-3b", (1, 2), "fsdp", "einsum"),
                     ("recurrentgemma-2b", (1, 2), "tp", "einsum"),
                     ("qwen3-moe-30b-a3b", (1, 2), "fsdp", "a2a"))


def dryrun_wire_suite(rank: int, world: int):
    """One train step of each of ``DRYRUN_WIRE_CASES`` on 2 gloo ranks
    (:func:`_mesh_step`, no remat): the bytes the rank handed to each
    collective, by ``sharded.WIRE`` key."""
    from repro_torch.launch.mesh import make_mesh_compat
    meshes = {shape: make_mesh_compat(shape, ("data", "model"), device="cpu")
              for shape in sorted({c[1] for c in DRYRUN_WIRE_CASES})}
    out = {}
    for arch, shape, layout, dispatch in DRYRUN_WIRE_CASES:
        cfg, log = lm_cfg(arch), {}
        _mesh_step(cfg, meshes[shape], lm_batch(cfg), log, layout=layout,
                   moe_dispatch=dispatch)
        out[arch, shape, layout] = log["wire"]
    return out


# ------------------------------------------------------------ the vocabulary
# the vocab-split cross-entropy on (1, 2) and (1, 4): [VOCAB_B, VOCAB_T]
# tokens over a padded vocabulary of VOCAB_VP, real_vocab 200 (the padding
# inside the last block of both meshes) and 150 (one block of (1, 4) all
# padding, another split by it); "exact" data (small integers: every
# product and sum exact, ties across blocks kept by any order) and
# "normal" data
VOCAB_MESHES = ((1, 2), (1, 4))
VOCAB_B, VOCAB_T, VOCAB_D, VOCAB_VP = 2, 8, 16, 256
VOCAB_REAL = (200, 150)
VOCAB_DATA = ("exact", "normal")
VOCAB_CHUNK = 4                 # the fused head's chunk: two a row
# labels on block edges (0, 63 | 64, 127 | 128, 149 | 150, 191 | 192),
# ignored ones, and the labels of the tie rows
VOCAB_LABELS = ((0, 63, 64, 127, -1, 128, 10, 70),
                (149, -1, 191, 192, 199, 1, 10, 255))
# (row, col, indices): rows whose maximum sits at several indices, in
# different blocks of both meshes; the tie goes to the lowest
VOCAB_TIES = ((0, 6, (10, 70, 130)), (0, 7, (10, 70)), (1, 6, (10, 140)),
              (1, 5, (1, 100)))
# the embedding's configs: tied with a scaled embedding, untied
VOCAB_EMBED_ARCHS = ("recurrentgemma-2b", "qwen3-8b")
VOCAB_TOKENS = ((0, 63, 64, 127, 128, 191, 192, 255),
                (5, 70, 130, 200, 64, 64, 0, 250))
# (1, 2) train steps whose gradients are held to one device: (arch,
# knobs); tied under gather (the head on a view of the whole table's
# rows), both heads, and both embeddings of either kind
VOCAB_STEPS = (("qwen2.5-3b", {}), ("qwen2.5-3b", {"fused_head": True}),
               ("qwen2.5-3b", {"embed_mode": "vocab_parallel"}),
               ("qwen3-8b", {"embed_mode": "vocab_parallel",
                             "fused_head": True}))


def vocab_data(kind: str, tied: bool = False, seed: int = 31) -> dict:
    """The cross-entropy's inputs: ``logits [B, T, Vp]`` with the ties of
    ``VOCAB_TIES``, ``x [B, T, D]`` and the head's ``w`` (``[Vp, D]``
    where ``tied``, else ``[D, Vp]``), ``labels``.  ``"exact"`` draws
    small integers (x in quarters): every logit exact in float32."""
    rng = np.random.default_rng(seed)
    wshape = (VOCAB_VP, VOCAB_D) if tied else (VOCAB_D, VOCAB_VP)
    if kind == "exact":
        logits = rng.integers(-6, 6, (VOCAB_B, VOCAB_T, VOCAB_VP))
        x = rng.integers(-4, 5, (VOCAB_B, VOCAB_T, VOCAB_D)) / 4
        w = rng.integers(-3, 4, wshape)
    else:
        logits = rng.normal(size=(VOCAB_B, VOCAB_T, VOCAB_VP)) * 3
        x = rng.normal(size=(VOCAB_B, VOCAB_T, VOCAB_D))
        w = rng.normal(size=wshape) / 4
    logits = logits.astype(np.float32)
    for b, t, idx in VOCAB_TIES:
        logits[b, t, list(idx)] = logits[b, t].max() + 1
    return {"logits": logits, "x": x.astype(np.float32),
            "w": w.astype(np.float32),
            "labels": np.asarray(VOCAB_LABELS, np.int32)}


def vocab_cotangent(shape) -> np.ndarray:
    """The embedding tests' cotangent of ``x``."""
    return np.random.default_rng(7).normal(size=tuple(shape)).astype(
        np.float32)


def _vocab_block(a: np.ndarray, mesh, dim: int) -> torch.Tensor:
    n = a.shape[dim] // mesh.shape["model"]
    i = mesh.axis_index("model")
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(i * n, (i + 1) * n), axis=dim))).requires_grad_()


def _vocab_ce_cases(mesh) -> dict:
    """The cross-entropy on this rank's block of the logits, and the head
    (``copy_to_model`` then the block's product) with both
    cross-entropies, tied and untied: the metrics, the gradients of the
    rank's block and of ``x``, the bytes by ``WIRE`` key."""
    from repro_torch.models import losses
    from repro_torch.parallel import sharded
    out = {}

    def metrics(m):
        return {k: float(v) for k, v in m.items()}

    for kind in VOCAB_DATA:
        for real in VOCAB_REAL:
            d = vocab_data(kind)
            block = _vocab_block(d["logits"], mesh, -1)
            before = dict(sharded.WIRE)
            loss, m = losses.cross_entropy(
                block, torch.from_numpy(d["labels"]), real_vocab=real,
                mesh=mesh)
            loss.backward()
            out["ce", kind, real] = {
                "loss": float(loss), "metrics": metrics(m),
                "grad": block.grad.numpy(),
                "wire": {k: v - before[k] for k, v in sharded.WIRE.items()}}
            for tied in (False, True):
                d = vocab_data(kind, tied)
                labels = torch.from_numpy(d["labels"])
                for fused in (False, True):
                    x = torch.from_numpy(d["x"]).requires_grad_()
                    w = _vocab_block(d["w"], mesh, 0 if tied else 1)
                    if fused:
                        loss, m = losses.fused_cross_entropy(
                            x, w, labels, real_vocab=real, transpose_w=tied,
                            chunk=VOCAB_CHUNK, mesh=mesh)
                    else:
                        h = sharded.copy_to_model(x, mesh)
                        logits = losses.head_product(h, w, tied)
                        loss, m = losses.cross_entropy(
                            logits, labels, real_vocab=real, mesh=mesh)
                    loss.backward()
                    out["head", kind, real, tied, fused] = {
                        "loss": float(loss), "metrics": metrics(m),
                        "gx": x.grad.numpy(), "gw": w.grad.numpy()}
    # model_argmax alone on the tie rows
    d = vocab_data("exact")
    v, i = sharded.model_argmax(_vocab_block(d["logits"], mesh, -1)
                                .detach(), mesh)
    out["argmax"] = {"max": v.numpy(), "index": i.numpy()}
    return out


def _vocab_embed_cases(mesh) -> dict:
    """``embed_mode="vocab_parallel"`` on this rank's rows of the table,
    in float32 and bf16: the embeddings and the gradient of ``sum(x *
    C)`` by the rank's block."""
    from repro_torch.models import transformer
    from repro_torch.parallel.sharding import ParallelConfig
    out = {}
    toks = torch.tensor(VOCAB_TOKENS, dtype=torch.int32)
    pcfg = ParallelConfig(mesh=mesh, embed_mode="vocab_parallel")
    for arch in VOCAB_EMBED_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = lm_cfg(arch).replace(param_dtype=dtype,
                                       compute_dtype=dtype)
            w = init_numpy(lm_cfg(arch))["embed/w"]
            block = _vocab_block(w, mesh, 0).detach().to(
                getattr(torch, dtype)).requires_grad_()
            x = transformer.embed({"embed": {"w": block}}, toks, cfg=cfg,
                                  pcfg=pcfg).float()
            (x * torch.from_numpy(vocab_cotangent(x.shape))).sum().backward()
            out[arch, dtype] = {"x": x.detach().numpy(),
                                "grad": block.grad.float().numpy()}
    return out


def _vocab_step_case(mesh, arch: str, knobs: dict) -> dict:
    """One ``tp`` train step of ``arch`` (float32, no remat) on ``mesh``
    from :func:`init_numpy`'s blocks, its gradient blocks recorded where
    AdamW receives them, whole by ``gather_tree``."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models import model
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths
    cfg = lm_cfg(arch)
    pcfg = ParallelConfig(mesh=mesh, remat="none", layout="tp", **knobs)
    pshapes = model.param_shapes(cfg)
    specs = param_specs_for(pshapes, pcfg)
    params = params_from_jax(nest(init_numpy(cfg)), specs=specs, mesh=mesh)
    ocfg = optim.AdamWConfig(lr=LR)
    opt = optim.init_state(params, ocfg)
    step = tstep.make_train_step(cfg, pcfg, ocfg,
                                 optim.warmup_cosine(LR, WARMUP, TOTAL))
    got = {}
    real = optim.apply_updates

    def held(params, grads, *a, **kw):
        got["grads"] = grads
        return real(params, grads, *a, **kw)

    batch = tstep.local_batch({k: torch.from_numpy(v) for k, v in
                               lm_batch(cfg).items()}, pcfg)
    optim.apply_updates = held
    try:
        _, _, metrics = step(params, opt, batch)
    finally:
        optim.apply_updates = real
    whole = sharded.gather_tree(got["grads"], specs, pshapes, mesh)
    return {"grads": _flat_np(whole), "loss": float(metrics["loss"]),
            "kept": sorted(p for p, _ in tree_flatten_with_paths(pshapes)
                           if tstep.tp_leaf(p, cfg, pcfg))}


def vocab_suite(rank: int, world: int):
    """The vocabulary over ``model`` on 4 gloo ranks: the cross-entropy
    and embedding cases on ``(1, 2)`` (ranks 0-1) and ``(1, 4)``, the
    train steps of ``VOCAB_STEPS`` on ``(1, 2)``; every rank's results."""
    from repro_torch.launch.mesh import make_mesh_compat
    meshes = {s: make_mesh_compat(s, ("data", "model"), device="cpu",
                                  ranks=range(s[1]))
              for s in VOCAB_MESHES}
    out = {"rank": rank}
    for shape, mesh in meshes.items():
        if mesh is None:
            continue
        out[shape] = {"index": mesh.axis_index("model"),
                      **_vocab_ce_cases(mesh), **{
                          ("embed",) + k: v
                          for k, v in _vocab_embed_cases(mesh).items()}}
    pair = meshes[1, 2]
    if pair is not None:
        out["steps"] = [_vocab_step_case(pair, a, k) for a, k in VOCAB_STEPS]
    return out


# ------------------------------------------------------------ tp recurrent
# the leaves a tensor-parallel recurrent layer or frontend keeps as its
# model block, and the dim the block cuts ("[qkv]" the mLSTM's q / k / v
# blocks)
TP_RECURRENT_CUTS = {
    "rglru": {"in_x": 1, "in_g": 1, "conv_w": 1, "a_param": 0, "out": 0},
    "mlstm": {"conv_w": 1, "q": 0, "k": 0, "v": 0, "out_norm": 0,
              "down": 0},
    "slstm": {**{f"w_{g}": 1 for g in "ifzo"}, **{f"b_{g}": 0
                                                  for g in "ifzo"}},
    "frontend": {"w1": 1}}
TP_RECURRENT_SEQ = 12           # tokens of the layers' prefill
TP_RECURRENT_LRU = 48           # the LRU width: blocks of 6


def tp_recurrent_cfgs() -> dict:
    """The reduced float32 configs of the tensor-parallel recurrent cases:
    an RG-LRU at width 48, the xLSTM (4 heads), llava's and seamless's
    frontends (d_model 64)."""
    return {"rglru": lm_cfg("recurrentgemma-2b").replace(
                lru_width=TP_RECURRENT_LRU),
            "xlstm": lm_cfg("xlstm-1.3b"),
            "vision": lm_cfg("llava-next-mistral-7b"),
            "audio": lm_cfg("seamless-m4t-large-v2")}


def _tp_leaf_block(name, path, x, index, size):
    """Rank ``index``'s block of the layer leaf ``path`` (its
    ``TP_RECURRENT_CUTS[name]`` entry, by the leaf's first key), else the
    whole leaf."""
    dim = TP_RECURRENT_CUTS[name].get(path.split("/")[0])
    if dim is None:
        return x
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n).contiguous()


def _tp_layer_case(name, cfg, fn, params, x, pcfg, index, size,
                   state=None, state_dims=None) -> dict:
    """``fn(params, x, pcfg, state)`` whole (no mesh) and on this rank's
    blocks: the largest differences, each of its reference's scale, of
    the output, of ``x``'s gradient, of each leaf's gradient (the rank's
    block of the whole one), and of the new state (the rank's block)."""
    from repro_torch.parallel.sharding import NO_PARALLEL
    from repro_torch.utils.pytree import (tree_flatten_with_paths,
                                          tree_unflatten)
    flat = tree_flatten_with_paths(params)
    rng = np.random.default_rng(41)

    def run(leaves, p_cfg, st):
        xs = x.clone().requires_grad_()
        ps = [v.clone().requires_grad_() for v in leaves]
        out, new = fn(tree_unflatten(params, ps), xs, p_cfg, st)
        cot = torch.from_numpy(rng.normal(size=tuple(out.shape))
                               .astype(np.float32))
        (out * cot).sum().backward()
        return out.detach(), xs.grad, [v.grad for v in ps], new

    whole = run([v for _, v in flat], NO_PARALLEL, state)
    rng = np.random.default_rng(41)
    cut_state = None if state is None else {
        k: v.chunk(size, dim=state_dims[k])[index].contiguous()
        for k, v in state.items()}
    mine = run([_tp_leaf_block(name, p, v, index, size) for p, v in flat],
               pcfg, cut_state)

    def rel(a, b):
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
    out = {"out": rel(mine[0], whole[0]), "x": rel(mine[1], whole[1])}
    for (path, _), g, w in zip(flat, mine[2], whole[2]):
        out["grad/" + path] = rel(g, _tp_leaf_block(name, path, w, index,
                                                    size))
    if state is not None:
        for k, v in mine[3].items():
            w = whole[3][k].chunk(size, dim=state_dims[k])[index]
            out["state/" + k] = rel(v.detach(), w.detach())
    return out


def _tp_recurrent_layers(mesh) -> dict:
    """Each tensor-parallel recurrent layer (and frontend) of
    :func:`tp_recurrent_cfgs` on ``mesh``'s ``model`` ranks against one
    process's whole layer (:func:`_tp_layer_case`): the RG-LRU in a
    prefill from zero states and then a decode step, the mLSTM (the same),
    the sLSTM, the vision projector spliced at 3 positions, the audio
    frames' projection."""
    from repro_torch.models import common, model, rglru, transformer, xlstm
    from repro_torch.parallel.sharding import NO_PARALLEL, ParallelConfig
    cfgs = tp_recurrent_cfgs()
    pcfg = ParallelConfig(mesh=mesh)
    index, size = mesh.axis_index("model"), mesh.axes_size("model")
    rng = np.random.default_rng(40)
    out = {}

    def seq(cfg, T=TP_RECURRENT_SEQ):
        return torch.from_numpy(rng.normal(size=(2, T, cfg.d_model))
                                .astype(np.float32))

    def layer_params(shapes):
        return common.materialize(shapes, torch.Generator().manual_seed(7),
                                  "cpu")

    def zero_state(cfg, sym):
        return transformer._zero_state(transformer._STATE_SHAPES[sym](cfg, 2),
                                       "cpu")

    layers = {"rglru": ("R", rglru.shapes, lambda p, x, c, s, cfg: rglru.apply(
                  p, x, cfg=cfg, state=s, pcfg=c)),
              "mlstm": ("m", xlstm.mlstm_shapes,
                        lambda p, x, c, s, cfg: xlstm.mlstm_apply(
                            p, x, cfg=cfg, state=s, pcfg=c)),
              "slstm": ("s", xlstm.slstm_shapes,
                        lambda p, x, c, s, cfg: xlstm.slstm_apply(
                            p, x, cfg=cfg, state=s, pcfg=c))}
    for name, (sym, shapes, call) in layers.items():
        cfg = cfgs["rglru" if name == "rglru" else "xlstm"]
        if transformer.rec_split(sym, cfg, pcfg)[0] is None:
            continue
        params = layer_params(shapes(cfg))
        dims = transformer.rec_split(sym, cfg, pcfg)[1]

        def fn(p, x, c, s, call=call, cfg=cfg):
            return call(p, x, c, s, cfg)
        out[name] = _tp_layer_case(name, cfg, fn, params, seq(cfg), pcfg,
                                   index, size)
        # a prefill from zero states, then a decode step from the whole
        # prefill's state
        x = seq(cfg)
        with torch.no_grad():
            state = call(params, x, NO_PARALLEL, zero_state(cfg, sym), cfg)[1]
        out[name + "/prefill"] = _tp_layer_case(
            name, cfg, fn, params, x, pcfg, index, size,
            state=zero_state(cfg, sym), state_dims=dims)
        out[name + "/decode"] = _tp_layer_case(
            name, cfg, fn, params, seq(cfg, 1), pcfg, index, size,
            state=state, state_dims=dims)
    vis, aud = cfgs["vision"], cfgs["audio"]
    if transformer.frontend_split(vis, pcfg) is not None:
        fp = layer_params(model.param_shapes(vis)["frontend"])
        pos = torch.tensor([[1, 4, 9]] * 2)
        patches = seq(vis, 3)

        def splice(p, x, c, s):
            return transformer.splice_patches({"frontend": p}, x, patches,
                                              pos, cfg=vis, pcfg=c), None
        out["vision"] = _tp_layer_case("frontend", vis, splice, fp, seq(vis),
                                       pcfg, index, size)
        fa = layer_params(model.param_shapes(aud)["frontend"])

        def frames(p, x, c, s):
            return transformer.project_frames({"frontend": p}, x, cfg=aud,
                                              pcfg=c), None
        out["audio"] = _tp_layer_case("frontend", aud, frames, fa, seq(aud),
                                      pcfg, index, size)
    return out


def _tp_collective_pieces(mesh) -> dict:
    """``xlstm.split_rms_norm`` and ``sharded.gather_from_model`` on this
    rank's 4 columns of a width of 4 x ``model``, against one process's
    whole ``rms_norm`` and identity: the output (the rank's columns, or
    the whole gathered) and the gradients of ``sum(tanh(out) * C)``
    (every rank's loss its own columns', or the whole one alike), each
    the largest difference of its reference's scale."""
    from repro_torch.models import common, xlstm
    from repro_torch.parallel import sharded
    index, size = mesh.axis_index("model"), mesh.axes_size("model")
    rng = np.random.default_rng(42)
    width = 4 * size
    x_np = rng.normal(size=(2, 5, width)).astype(np.float32)
    s_np = rng.normal(size=(width,)).astype(np.float32)
    c_np = rng.normal(size=(2, 5, width)).astype(np.float32)
    cols = slice(4 * index, 4 * (index + 1))
    C = torch.from_numpy(c_np)

    def rel(a, b):
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))

    xw = torch.from_numpy(x_np).requires_grad_()
    sw = torch.from_numpy(s_np).requires_grad_()
    want = common.rms_norm(xw, sw, 1e-6)
    (torch.tanh(want) * C).sum().backward()
    xr = torch.from_numpy(x_np[..., cols].copy()).requires_grad_()
    sr = torch.from_numpy(s_np[cols].copy()).requires_grad_()
    before = sharded.WIRE["tp_all_reduce"]
    got = xlstm.split_rms_norm(xr, sr, 1e-6, mesh)
    (torch.tanh(got) * C[..., cols]).sum().backward()
    out = {"norm": {"out": rel(got.detach(), want.detach()[..., cols]),
                    "x": rel(xr.grad, xw.grad[..., cols]),
                    "scale": rel(sr.grad, sw.grad[cols]),
                    "wire": sharded.WIRE["tp_all_reduce"] - before}}
    xw.grad = None
    (torch.tanh(xw) * C).sum().backward()
    before = sharded.WIRE["all_gather"]
    xr.grad = None
    whole = sharded.gather_from_model(xr, mesh)
    (torch.tanh(whole) * C).sum().backward()
    out["gather"] = {"out": rel(whole.detach(), xw.detach()),
                     "x": rel(xr.grad, xw.grad[..., cols]),
                     "wire": sharded.WIRE["all_gather"] - before,
                     "part_bytes": xr.nbytes}
    return out


def tp_recurrent_suite(rank: int, world: int):
    """On 3 ranks: the collective pieces and the layers on ``(data,
    model) = (1, 3)`` (the RG-LRU's gate blocks of 6 cut by slices of
    16), then on ranks 0 and 1 at ``(1, 2)`` (the RG-LRU's whole blocks,
    the xLSTM's 2 of 4 heads, the frontends' 32 of 64 columns); rank 0's
    results by mesh."""
    from repro_torch.launch.mesh import make_mesh_compat
    out = {}
    trio = make_mesh_compat((1, 3), ("data", "model"), device="cpu")
    out[3] = {"pieces": _tp_collective_pieces(trio),
              "layers": _tp_recurrent_layers(trio)}
    pair = make_mesh_compat((1, 2), ("data", "model"), device="cpu",
                            ranks=range(2))
    if pair is not None:
        out[2] = {"pieces": _tp_collective_pieces(pair),
                  "layers": _tp_recurrent_layers(pair)}
    return out if rank == 0 else None


# ------------------------------------------------------------ the ring
# gloo's sums, which the card's references of more than two model ranks
# follow (``chip_smoke.ring_sum``): groups of the first 2, 3 and 5 ranks,
# bf16 and float32, from a few elements to segments cut at
# ``chip_smoke.GLOO_SEGMENT_BYTES`` (24 MB of float32 make 25 segments
# over 5 ranks), and a length no rank count divides, all-reduced alone
# (12 MB of float32: the cap moves the segments' ends, and with them the
# rank that starts a few elements' sums)
RING_SIZES = (2, 3, 5)
RING_LENGTHS = (30, 3000, 6_000_000, 3_000_017)
# the tp step that ``chip_smoke.emulated_model_ranks`` emulates, on 5 and
# 2 ranks: recurrentgemma-2b's reduced twin in bf16 at widths 5 divides,
# cut to R, R, L as phase 28 cuts it (the LRU's 80 columns in gate
# blocks of 10: a rank's 16 of 5 cross them), one row of 32 tokens
RING_STEP_CFG = {"d_model": 80, "n_heads": 5, "n_kv_heads": 1,
                 "d_head": 16, "d_ff": 160, "lru_width": 80,
                 "vocab_size": 640, "block_pattern": ("R", "R", "L"),
                 "n_layers": 3, "local_window": 16}
RING_STEP_SEQ = 32


def ring_part(rank: int, n: int, dtype: str) -> torch.Tensor:
    """Rank ``rank``'s addend of ``n`` elements, of three magnitudes over
    the ranks, so that the order of the additions shows."""
    x = np.random.default_rng([rank, n]).normal(size=n) * 10.0 ** (rank % 3)
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _chip_smoke():
    import sys
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _ring_sums(rank: int) -> dict:
    """This rank's all-reduce and reduce-scatter (of a length the group
    divides) in each group of ``RING_SIZES`` it belongs to, against ``chip_smoke.ring_sum`` of every
    member's ``ring_part`` and against their sum in rank order: the
    number of elements that differ, by (size, dtype, length)."""
    import torch.distributed as dist
    cs = _chip_smoke()
    out = {}
    for size in RING_SIZES:
        group = dist.new_group(list(range(size)))   # every rank calls it
        if rank >= size:
            continue
        for dtype in ("bfloat16", "float32"):
            for n in RING_LENGTHS:
                parts = [ring_part(r, n, dtype) for r in range(size)]
                ring = cs.ring_sum(torch, parts)
                x = parts[rank].clone()
                dist.all_reduce(x, group=group)
                got = {"all_reduce": int((x != ring).sum()),
                       "rank_order": int((x != sum(parts[1:],
                                                   parts[0])).sum())}
                k = n // size
                if n % size == 0:
                    y = torch.empty(k, dtype=x.dtype)
                    dist.reduce_scatter_tensor(y, parts[rank].clone(),
                                               group=group)
                    got["reduce_scatter"] = int(
                        (y != ring[rank * k:(rank + 1) * k]).sum())
                out[size, dtype, n] = got
    return out


def _ring_step(mesh, size: int) -> dict:
    """One ``tp`` step of ``RING_STEP_CFG`` on ``mesh`` with phase 8's
    knobs (full remat, the fused head), its gradient whole as AdamW
    receives it; then, in this process, the same step off the mesh with
    its ``size`` ranks emulated (``chip_smoke.emulated_model_ranks``) on
    rank 0.  Returns both losses and the elements of each leaf that
    differ (rank 0; the others, nothing)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import param_specs_for
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths
    cs = _chip_smoke()
    cfg = get_config("recurrentgemma-2b").reduced().replace(**RING_STEP_CFG)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, RING_STEP_SEQ + 1)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}

    def init():
        return model.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
    pcfg = cs.mesh_lm_pcfg(mesh, layout="tp")
    pshapes = model.param_shapes(cfg)
    specs = param_specs_for(pshapes, pcfg)
    params = sharded.shard_tree(init(), specs, mesh)
    ocfg = optim.AdamWConfig(lr=LR)
    step = tstep.make_train_step(cfg, pcfg, ocfg,
                                 optim.warmup_cosine(LR, WARMUP, TOTAL))
    got, real = {}, optim.apply_updates

    def held(params, grads, *a, **kw):
        got["grads"] = grads
        return real(params, grads, *a, **kw)
    optim.apply_updates = held
    try:
        _, _, metrics = step(params, optim.init_state(params, ocfg),
                             tstep.local_batch(batch, pcfg))
    finally:
        optim.apply_updates = real
    whole = dict(tree_flatten_with_paths(
        sharded.gather_tree(got["grads"], specs, pshapes, mesh)))
    if torch.distributed.get_rank():
        return {}
    with cs.emulated_model_ranks(torch, size, "cpu"):
        (loss, _), grads = tstep._value_and_grad_accum(
            init(), batch, cfg=cfg, pcfg=cs.train_pcfg())
    return {"loss": float(metrics["loss"]), "emulated_loss": float(loss),
            "unequal": {p: int((g != whole[p]).sum()) for p, g in
                        tree_flatten_with_paths(grads)}}


def gloo_ring_suite(rank: int, world: int):
    """On 5 ranks: :func:`_ring_sums` on every rank, then
    :func:`_ring_step` on ``(data, model) = (1, 5)`` and on ranks 0 and 1
    at ``(1, 2)``.  Each rank's sums; rank 0's steps by ``model`` size."""
    from repro_torch.launch.mesh import make_mesh_compat
    out = {"sums": _ring_sums(rank), "steps": {}}
    five = make_mesh_compat((1, 5), ("data", "model"), device="cpu")
    step5 = _ring_step(five, 5)
    pair = make_mesh_compat((1, 2), ("data", "model"), device="cpu",
                            ranks=range(2))
    if pair is not None:
        step2 = _ring_step(pair, 2)
        if rank == 0:
            out["steps"] = {5: step5, 2: step2}
    return out
