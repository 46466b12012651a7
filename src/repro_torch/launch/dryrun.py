"""Dry run: one rank's step of every (arch x shape x mesh) cell, counted
on meta tensors.

The port of ``repro.launch.dryrun``.  The JAX package lowers and
compiles each cell's step on 256 or 512 stand-in host devices and reads
XLA's memory and cost analyses.  Here one process is rank 0 of a
stand-in default group of the mesh's size (the ``"fake"`` backend of
``torch.testing._internal.distributed.fake_pg``, whose collectives do
nothing), over which :func:`repro_torch.launch.mesh.make_production_mesh`
builds the real :class:`Mesh` and its groups on the ``meta`` device.
For each cell the dry run:

  1. makes meta stand-ins of rank 0's blocks of the parameters, the
     optimizer state (with ``ef`` under ``int8_ef``), the batch and the
     decode cache, by the port's spec trees (``param_specs_for``,
     ``opt_state_specs_for``, ``batch_specs_for``, ``cache_specs_for``,
     ``sharded.block_slices``);
  2. runs the port's own step on them, through ``make_train_step``,
     ``make_prefill_step`` or ``make_serve_step`` with the cell's knobs:
     every op is shape inference only, and each hand-written kernel
     takes its meta route, which counts the card's launch
     (``kernels/_meta.py``; the flash backward is the plain recompute,
     as the card runs it);
  3. counts, for rank 0:
     - ``memory``: ``argument_bytes`` (rank 0's blocks of the step's
       arguments, as XLA's ``memory_analysis`` counts a device's
       arguments), for a serve step ``serving_bytes`` (the same with the
       weights the rank serves with, ``serve_params``, in place of its
       blocks), ``output_bytes`` (what the step returns that it made),
       ``peak_bytes`` (the most bytes live at once: every stand-in and
       every storage an op made, tracked to its release, each rounded up
       as the CUDA caching allocator rounds a block) and ``temp_bytes``
       (the peak less the arguments);
     - ``cost``: ``flops`` (``torch.utils.flop_counter.FlopCounterMode``
       plus the kernels' own counts) and ``bytes accessed`` (every op's
       inputs and outputs as eager PyTorch moves them, views and empty
       allocations moving none, each kernel's own count in place of its
       meta route);
     - ``collectives``: the bytes this rank hands to each collective
       (``sharded.WIRE``, ``collectives.WIRE`` and ``core/spmd.py``'s
       exchanges), by kind and by the reach of its group: ``cross_pod``
       (a group spanning pods), ``intra_pod``, and ``inter_node`` /
       ``intra_node`` at ``GPUS_PER_NODE`` ranks a node;
     - ``kernels``: each hand-written kernel's launches, operations and
       bytes;
     - with ``--by-line``, ``memory["peak_by_line"]``: what is live at
       the peak, by the line of the port's code that made it (the
       innermost frame under ``src/repro_torch``), or by the autograd
       node that made it in the backward;
     - ``roofline``: the step's least time on an H100 from the data
       sheet's rates below;
  4. writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``.

A cell the port refuses (a ``NotImplementedError``) is written ``ok:
false`` with that error and, under ``refused``, the ROADMAP item it
names, or ``"reference"`` where it names none (the serving mesh under
``layout="fsdp"``, where the JAX package's own serve steps raise), as
the JAX run records a failed lowering.

Usage (no card needed; it models the card's route):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, both meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time
import traceback
import warnings
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import _meta
from repro_torch.launch.mesh import STANDIN_BACKEND, make_production_mesh
from repro_torch.models import model
from repro_torch.models.inputs import input_specs
from repro_torch.parallel import collectives, sharded
from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
from repro_torch.train import optim
from repro_torch.train import step as steps
from repro_torch.utils.pytree import tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# --- NVIDIA H100 SXM5 80 GB (roofline denominators), from NVIDIA's H100
# Tensor Core GPU data sheet and the HGX H100 platform ------------------
PEAK_FLOPS = 989e12          # dense BF16 tensor-core FLOP/s (SXM5)
HBM_BW = 3.35e12             # HBM3 bytes/s (SXM5)
HBM_BYTES = 80e9             # device memory
NVLINK_BW = 450e9            # NVLink 4: 900 GB/s a GPU, 450e9 B/s a direction
NET_BW = 50e9                # a 400 Gb/s NDR InfiniBand port a GPU, B/s
GPUS_PER_NODE = 8            # an HGX H100 node
ALLOC_GRAIN = 512            # the CUDA caching allocator's block rounding

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
# torch.distributed's collectives: (kind, index of the tensor handed in)
_COLLECTIVES = {"all_gather_into_tensor": ("all-gather", 1),
                "all_gather": ("all-gather", 1),
                "reduce_scatter_tensor": ("reduce-scatter", 1),
                "all_reduce": ("all-reduce", 0),
                "all_to_all_single": ("all-to-all", 1)}
_ITEM = re.compile(r"ROADMAP item (\d+\.\d+[a-z']*(?: part \d+)?)")

aten = torch.ops.aten
# ops that move no bytes: allocations left unfilled and aliases
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.detach.default,
             aten.alias.default, aten._unsafe_view.default,
             aten.lift_fresh.default}
# in-place ops that write their first argument without reading it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}


# ------------------------------------------------------------ the mesh
@contextlib.contextmanager
def standin_group(world: int):
    """This process as rank 0 of a default group of ``world`` ranks whose
    collectives do nothing (the ``"fake"`` backend over a ``FakeStore``);
    refuses to start beside an existing default group, and destroys its
    own when it ends, also on an error.  ``world == 1`` sets up nothing."""
    if world <= 1:
        yield
        return
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("the dry run sets up its own stand-in default "
                           "group, and one already exists")
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(STANDIN_BACKEND, store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ stand-ins
def block_shape(shape, spec, mesh) -> tuple:
    """The shape of rank 0's block of a leaf of ``shape`` under ``spec``."""
    if mesh is None:
        return tuple(shape)
    sl = sharded.block_slices(spec, shape, mesh)
    return tuple(len(range(*c.indices(n))) for c, n in zip(sl, shape))


def standins(shape_tree, spec_tree, mesh, whole: bool = False):
    """Meta tensors of rank 0's block of each leaf (of the whole leaf
    where ``whole``)."""
    def one(s, spec):
        shape = s.shape if whole else block_shape(s.shape, spec, mesh)
        return torch.empty(shape, dtype=s.dtype, device="meta")
    return tree_map(one, shape_tree, spec_tree)


def block_bytes(shape_tree, spec_tree, mesh) -> int:
    """Bytes of rank 0's blocks of a tree of TensorSpecs."""
    return sum(math.prod(block_shape(s.shape, p, mesh)) * s.dtype.itemsize
               for s, p in zip(tree_leaves(shape_tree),
                               tree_leaves(spec_tree)))


# ------------------------------------------------------------ counting
def _moved(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast dim counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _grain(n: int) -> int:
    return -(-n // ALLOC_GRAIN) * ALLOC_GRAIN


_PORT = str(Path(__file__).resolve().parents[1])
_NOT_A_SOURCE = ("launch/dryrun.py", "utils/pytree.py")



def _source_line() -> str:
    """The autograd node running an op in the backward, else ``path:line``
    (under ``src/repro_torch``) of the innermost frame of the port's code
    outside this module that is running it."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward {node.name()}"
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PORT) and not name.endswith(_NOT_A_SOURCE):
            return f"{os.path.relpath(name, _PORT)}:{f.f_lineno}"
        f = f.f_back
    return "elsewhere"


class Counter(TorchDispatchMode):
    """Counts the bytes every op moves (``moved``) and the bytes live at
    once: each storage an op makes is added (rounded to the allocator's
    grain) until its last reference goes (a finalizer on the storage),
    ``peak`` the most ever live beside ``base``, the stand-ins' bytes.
    With ``by_line`` it also keeps the live bytes by the line that made
    them (:func:`_source_line`) and ``peak_lines``, those at the peak."""

    def __init__(self, base_storages=(), by_line: bool = False):
        super().__init__()
        self.moved = 0
        self.live: dict = {}
        self.known = {id(s) for s in base_storages}
        self.base = sum(_grain(s.nbytes()) for s in base_storages)
        self.cur = self.peak = self.base
        self.counting = True
        self.lines = {} if by_line else None     # storage -> its line
        self.node = None            # the running backward node's number
        self.made_by: dict = {}     # storage -> the node that made it
        self.line_bytes: dict = {}
        self.peak_lines: dict = {}

    def _accumulates(self, args, kwargs) -> bool:
        """Whether ``add(a, b)`` in the backward is autograd adding the
        gradient ``b`` the running node just made to the buffer ``a`` an
        earlier node made (``InputBuffer::accumulate``), which the card
        adds in place: two dense tensors of one shape and type, ``a`` the
        whole of its storage."""
        if kwargs or len(args) != 2 or not all(isinstance(t, torch.Tensor)
                                               for t in args):
            return False
        a, b = args
        made = [self.made_by.get(id(t.untyped_storage())) for t in args]
        return (made[1] == self.node and made[0] not in (None, self.node)
                and a.shape == b.shape and a.dtype == b.dtype
                and a.is_contiguous()
                and a.untyped_storage().nbytes() == a.nbytes)

    def _free(self, key) -> None:
        n = self.live.pop(key)
        self.made_by.pop(key, None)
        self.cur -= n
        if self.lines is not None:
            self.line_bytes[self.lines.pop(key)] -= n

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self.live or key in self.known:
            return
        n = _grain(s.nbytes())
        self.live[key] = n
        if self.node is not None:
            self.made_by[key] = self.node
        self.cur += n
        if self.lines is not None:
            line = self.lines[key] = _source_line()
            self.line_bytes[line] = self.line_bytes.get(line, 0) + n
            if self.cur > self.peak:
                self.peak_lines = dict(self.line_bytes)
        self.peak = max(self.peak, self.cur)
        weakref.finalize(s, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under a dispatch mode autograd takes the out-of-place branches
        # meant for tensor subclasses, which the card does not take: its
        # index_backward writes its zeros in place (_index_put_impl_), and
        # a gradient buffer meeting a second gradient adds it in place
        # (InputBuffer::accumulate); counted as the card runs them
        node = torch._C._current_autograd_node()
        self.node = None if node is None else node._sequence_nr()
        if node is not None:
            if func is aten.index_put.default \
                    and node.name() == "IndexBackward0":
                func = aten.index_put_.default
            elif func is aten.add.Tensor and self._accumulates(args, kwargs):
                func = aten.add_.Tensor
        out = func(*args, **kwargs)
        outs = [t for t in _pt_leaves(out) if isinstance(t, torch.Tensor)]
        if self.counting and func not in _NO_BYTES and not func.is_view:
            ins = [t for t in _pt_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if func in _WRITE_ONLY:
                ins = ins[1:]
            self.moved += sum(_moved(t) for t in ins) \
                + sum(_moved(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


class WireLog:
    """Patches ``torch.distributed``'s collectives while it is entered
    to log ``(kind, ranks of the group, bytes handed in)`` of each call
    before the backend runs it."""

    def __init__(self):
        self.calls: list = []
        self._ranks: dict = {}

    def _group_ranks(self, group) -> tuple:
        key = id(group)
        if key not in self._ranks:
            self._ranks[key] = tuple(dist.get_process_group_ranks(
                group if group is not None else dist.group.WORLD))
        return self._ranks[key]

    def __enter__(self):
        self._saved = {name: getattr(dist, name) for name in _COLLECTIVES}
        for name, (kind, at) in _COLLECTIVES.items():
            setattr(dist, name, self._wrap(self._saved[name], kind, at))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)

    def _wrap(self, fn, kind, at):
        def logged(*args, **kwargs):
            t = args[at]
            self.calls.append((kind, self._group_ranks(kwargs.get("group")),
                               t.numel() * t.element_size()))
            return fn(*args, **kwargs)
        return logged


def _wire_totals(log: WireLog, world: int, npods: int) -> dict:
    out = {k: 0 for k in KINDS}
    out.update(cross_pod=0, intra_pod=0, inter_node=0, intra_node=0)
    stride = world // max(npods, 1)
    for kind, ranks, n in log.calls:
        out[kind] += n
        out["cross_pod" if npods > 1 and len({r // stride for r in ranks})
            > 1 else "intra_pod"] += n
        out["inter_node" if len({r // GPUS_PER_NODE for r in ranks}) > 1
            else "intra_node"] += n
    out["total"] = sum(out[k] for k in KINDS)
    return out


def _wire_snapshot() -> dict:
    return {**sharded.WIRE, **{f"cross_pod_mean_{k}": v
                               for k, v in collectives.WIRE.items()}}


def roofline(flops: float, hbm_bytes: float, intra_node: float,
             inter_node: float) -> dict:
    """Each resource's least seconds for the step on one H100 and the
    largest, which bounds the step."""
    t = {"flops_s": flops / PEAK_FLOPS, "hbm_s": hbm_bytes / HBM_BW,
         "nvlink_s": intra_node / NVLINK_BW, "network_s": inter_node / NET_BW}
    by = max(t, key=t.get)
    return {**t, "bound_s": t[by], "bound_by": by[:-2]}


# ------------------------------------------------------------ the cell
def make_pcfg(mesh, multi_pod: bool, knobs: Optional[dict]) -> ParallelConfig:
    """``ParallelConfig(mesh, multi_pod, **knobs)``, naming a knob the
    port's config lacks."""
    fields = {f.name for f in dataclasses.fields(ParallelConfig)}
    for k in knobs or {}:
        if k not in fields or k in ("mesh", "multi_pod"):
            raise ValueError(f"the port's ParallelConfig has no knob {k!r}")
    return ParallelConfig(mesh=mesh, multi_pod=multi_pod, **(knobs or {}))


def build_cell(cfg: ModelConfig, shape: ShapeConfig, pcfg: ParallelConfig,
               ocfg: optim.AdamWConfig, max_len: int = 0) -> dict:
    """The cell's step and its stand-ins: ``{"setup": fn () -> the
    weights a serving rank computes with, or None, "step": fn (*args),
    "args": the stand-ins handed to the step, "argument_bytes": rank 0's
    blocks of the arguments by their specs}``, and a serve step's
    ``"param_bytes"``, its parameters' share of those.  A serve step's
    cache holds ``max_len`` positions (default the shape's sequence)."""
    max_len = max_len or shape.seq_len
    mesh = pcfg.mesh
    pshapes = model.param_shapes(cfg)
    pspecs = param_specs_for(pshapes, pcfg)
    params = standins(pshapes, pspecs, mesh)
    arg_bytes = block_bytes(pshapes, pspecs, mesh)
    if shape.kind == "train":
        oshapes = optim.state_shapes(pshapes, ocfg)
        ospecs = steps.opt_state_specs_for(pshapes, pcfg, ocfg)
        if "ef" in ospecs:          # each pod's own residual: its block
            ospecs = {**ospecs, "ef": ospecs["master"]}
        btree = input_specs(cfg, shape)
        bspecs = steps.batch_specs_for(btree, pcfg)
        args = (params, standins(oshapes, ospecs, mesh),
                standins(btree, bspecs, mesh))
        fn = steps.make_train_step(cfg, pcfg, ocfg,
                                   optim.warmup_cosine(3e-4, 1000, 100_000))
        return {"setup": None, "step": fn, "args": args,
                "argument_bytes": arg_bytes
                + block_bytes(oshapes, ospecs, mesh)
                + block_bytes(btree, bspecs, mesh)}
    if shape.kind == "prefill":
        btree = input_specs(cfg, shape)
        bspecs = steps.batch_specs_for(btree, pcfg)
        fn = steps.make_prefill_step(cfg, pcfg, max_len=max_len)
        # the port's serve steps take the global batch (each rank its rows)
        # and weights gathered once, when serving starts (serve_params)
        args = (params, standins(btree, bspecs, mesh, whole=True))
        return {"setup": lambda: steps.serve_params(cfg, pcfg, params),
                "step": fn, "args": args, "param_bytes": arg_bytes,
                "argument_bytes": arg_bytes
                + block_bytes(btree, bspecs, mesh)}
    cross_len = max_len if cfg.is_encoder_decoder else 0
    ctree = model.cache_shapes(cfg, shape.global_batch, max_len,
                               cross_len=cross_len)
    cspecs = steps.cache_specs_for(ctree, pcfg, cfg)
    btree = input_specs(cfg, shape)
    bspecs = steps.batch_specs_for(btree, pcfg)
    fn = steps.make_serve_step(cfg, pcfg, max_len=max_len)
    batch = standins(btree, bspecs, mesh, whole=True)
    args = (params, standins(ctree, cspecs, mesh), batch["token"],
            batch["pos"])
    return {"setup": lambda: steps.serve_params(cfg, pcfg, params),
            "step": fn, "args": args, "param_bytes": arg_bytes,
            "argument_bytes": arg_bytes + block_bytes(ctree, cspecs, mesh)
            + block_bytes(btree, bspecs, mesh)}


def _storages(tree) -> list:
    seen, out = set(), []
    for t in _pt_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            if id(s) not in seen:
                seen.add(id(s))
                out.append(s)
    return out


def measure(cell: dict, mesh, by_line: bool = False) -> dict:
    """Run ``cell`` (:func:`build_cell`) once on its stand-ins and count
    it; returns the record's ``memory`` (with ``peak_by_line`` where
    ``by_line``: the 20 lines holding the most at the peak, beside the
    stand-ins' ``arguments``), ``cost``, ``collectives``, ``kernels``,
    ``roofline`` and ``timing``."""
    t0 = time.perf_counter()
    args = cell["args"]
    world = mesh.size if mesh is not None else 1
    npods = mesh.shape.get("pod", 1) if mesh is not None else 1
    counter = Counter(_storages(args), by_line)
    setup_log, log = WireLog(), WireLog()
    grad = torch.enable_grad if cell["setup"] is None \
        else torch.inference_mode
    with counter, grad():
        if cell["setup"] is not None:
            counter.counting = False
            with setup_log:
                args = (cell["setup"](),) + tuple(args[1:])
            counter.counting = True
        _meta.reset()
        wire0 = _wire_snapshot()
        t1 = time.perf_counter()
        with FlopCounterMode(display=False) as flop_mode, log:
            out = cell["step"](*args)
        step_s = time.perf_counter() - t1
    wire = {k: v - wire0[k] for k, v in _wire_snapshot().items()}
    kernels = {k: dict(v) for k, v in _meta.TALLY.items()}
    flops = flop_mode.get_total_flops() \
        + sum(k["ops"] for k in kernels.values())
    moved = counter.moved + sum(k["bytes"] for k in kernels.values())
    made = {id(s): s for s in _storages(out)
            if id(s) not in counter.known}
    argument = cell["argument_bytes"]
    serving = {} if cell["setup"] is None else {"serving_bytes": (
        argument - cell["param_bytes"]
        + sum(t.nbytes for t in tree_leaves(args[0])))}
    peak = counter.peak
    lines = {}
    if by_line:
        top = sorted(counter.peak_lines.items(), key=lambda kv: -kv[1])
        lines["peak_by_line"] = [["arguments", counter.base]] + [
            [line, n] for line, n in top[:20] if n]
    colls = _wire_totals(log, world, npods)
    colls["wire"] = wire
    colls["setup_total"] = _wire_totals(setup_log, world, npods)["total"]
    return {
        "memory": {"argument_bytes": argument,
                   "output_bytes": sum(_grain(s.nbytes())
                                       for s in made.values()),
                   "temp_bytes": peak - argument, "peak_bytes": peak,
                   **serving, **lines},
        "cost": {"flops": float(flops), "bytes accessed": float(moved)},
        "collectives": colls,
        "kernels": kernels,
        "roofline": roofline(flops, moved, colls["intra_node"],
                             colls["inter_node"]),
        "timing": {"build_s": t1 - t0, "step_s": step_s},
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             knobs: Optional[dict] = None, tag: str = "",
             save: bool = True, out_dir: Path = OUT_DIR,
             by_line: bool = False) -> dict:
    """One cell on its production mesh (16x16, or 2x16x16 across pods),
    recorded as the JAX package's ``run_cell`` records it; written to
    ``out_dir`` where ``save``; ``by_line`` as :func:`measure`."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag
                                                      else "")
    rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
           "mesh": mesh_name, "knobs": knobs or {}, "ok": False,
           "error": None, "refused": None}
    t0 = time.time()
    try:
        with standin_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            rec.update(count_step(cfg, shape, make_pcfg(mesh, multi_pod,
                                                        knobs),
                                  by_line=by_line))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded, as a failed lowering
        rec["error"] = f"{type(e).__name__}: {e}"
        item = _ITEM.search(str(e))
        if isinstance(e, NotImplementedError):
            rec["refused"] = item.group(1) if item else "reference"
        else:
            rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = time.time() - t0
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell_id}.json").write_text(json.dumps(rec, indent=1))
    return rec


def count_step(cfg: ModelConfig, shape: ShapeConfig,
               pcfg: ParallelConfig, max_len: int = 0,
               by_line: bool = False) -> dict:
    """:func:`measure` of ``shape``'s step of ``cfg`` under ``pcfg`` (its
    mesh a stand-in, or None for one device), with the optimizer
    ``run_cell`` gives the knobs; a serve step's cache of ``max_len``
    positions (default the shape's sequence)."""
    ocfg = optim.AdamWConfig(error_feedback=(pcfg.compress_pod
                                             == "int8_ef"))
    return measure(build_cell(cfg, shape, pcfg, ocfg, max_len), pcfg.mesh,
                   by_line)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every cell; both meshes")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--knob", action="append", default=[],
                    help="k=v ParallelConfig overrides (repeatable)")
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR,
                    help="where the records go (default "
                    "experiments/dryrun_torch)")
    ap.add_argument("--by-line", action="store_true",
                    help="record and print what is live at the peak by "
                    "the line that made it")
    args = ap.parse_args(argv)
    # the port's collectives call torch's older names, which warn
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")

    knobs = {}
    for kv in args.knob:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        elif v.isdigit():
            v = int(v)
        knobs[k] = v

    todo = []
    if args.all:
        for arch, shape in cells():
            todo.append((arch, shape, False))
            todo.append((arch, shape, True))
    else:
        todo.append((args.arch, args.shape, args.multi_pod))

    counts = {"ok": 0, "refused": 0, "failed": 0}
    refused_by: dict = {}
    for arch, shape, mp in todo:
        mesh_name = "2x16x16" if mp else "16x16"
        cell_id = f"{arch}__{shape}__{mesh_name}" + \
            (f"__{args.tag}" if args.tag else "")
        path = args.out_dir / f"{cell_id}.json"
        if args.skip_existing and path.exists():
            prior = json.loads(path.read_text())
            if prior.get("ok"):
                counts["ok"] += 1
                print(f"[skip] {cell_id} (ok)")
                continue
        rec = run_cell(arch, shape, multi_pod=mp, knobs=knobs, tag=args.tag,
                       out_dir=args.out_dir, by_line=args.by_line)
        if rec["ok"]:
            counts["ok"] += 1
            m, c = rec["memory"], rec["collectives"]
            print(f"[OK ] {cell_id} wall={rec['wall_s']:.1f}s "
                  f"flops/dev={rec['cost']['flops']:.3e} "
                  f"hbm_bytes/dev={rec['cost']['bytes accessed']:.3e} "
                  f"coll_bytes/dev={c['total']:.3e} (intra_node "
                  f"{c['intra_node']:.3e} inter_node {c['inter_node']:.3e} "
                  f"cross_pod {c['cross_pod']:.3e}) "
                  f"argument_bytes={m['argument_bytes']} "
                  + (f"serving_bytes={m['serving_bytes']} "
                     if "serving_bytes" in m else "")
                  + f"peak_bytes={m['peak_bytes']} "
                  f"({m['peak_bytes'] / HBM_BYTES:.3f} of 80 GB) "
                  f"roofline={rec['roofline']['bound_s']:.4e}s "
                  f"({rec['roofline']['bound_by']}; H100 SXM data sheet)")
            for line, n in m.get("peak_by_line", ()):
                print(f"      at the peak {n / 1e9:9.3f} GB  {line}")
        else:
            key = "refused" if rec["refused"] else "failed"
            counts[key] += 1
            if rec["refused"]:
                refused_by[rec["refused"]] = refused_by.get(
                    rec["refused"], 0) + 1
            status = f"REFUSED ({rec['refused']})" if rec["refused"] \
                else "FAIL"
            print(f"[{status}] {cell_id} wall={rec['wall_s']:.1f}s "
                  f"err={rec['error']}")
    print(f"{counts['ok']}/{len(todo)} cells OK, {counts['refused']} refused"
          + "".join(f" ({n} as the reference)" if i == "reference"
                    else f" ({n} item {i})"
                    for i, n in sorted(refused_by.items()))
          + f", {counts['failed']} failed")
    return 0 if counts["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
