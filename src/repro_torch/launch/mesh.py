"""Mesh builders over ``torch.distributed``, and a launcher of ranks.

The port of ``repro.launch.mesh``.  JAX builds a mesh over the devices
one controller sees; here every rank is a process of its own, so a mesh
is built over an initialised default process group, one per rank
(:class:`repro_torch.parallel.mesh_utils.Mesh`), with a process group
for every combination of its axes.  Nothing here touches a device or a
process group when the module is imported.

:func:`run_ranks` starts ``D`` ranks on this machine (spawned processes,
a ``file://`` store, a collective timeout) and returns what each
returned: the CPU tests run the mesh over gloo with it, and
``chip_smoke.py`` runs several ranks on one GPU.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.mesh_utils import Mesh

# how long a host exchange waits for the other ranks before it raises
HOST_TIMEOUT = datetime.timedelta(minutes=5)
# the dry run's stand-in default group (``launch/dryrun.py``): a backend
# whose collectives do nothing, over which a mesh's groups are built but
# no host group beside them
STANDIN_BACKEND = "fake"


def _rank_device(rank: int, device) -> torch.device:
    """``device``, or by default the GPU ``rank % device_count``; raises
    without a GPU (pass ``device="cpu"`` to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def _world() -> int:
    """Ranks of the default group; raises when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialised default process group "
            "(torch.distributed.init_process_group, or run_ranks)")
    return dist.get_world_size()


def _sub_groups(shape: tuple, members: list, me: int) -> dict:
    """For every combination of axes (indices, each of more than one
    rank) that spans neither one rank nor all of ``members``: the group
    of ``me``'s coordinates on the other axes.  Every rank creates every
    group, in the same order, member or not (``new_group`` is collective
    over the default group)."""
    n = len(shape)
    coords = [np.unravel_index(i, shape) for i in range(len(members))]
    out = {}
    for k in range(1, n + 1):
        for combo in itertools.combinations(range(n), k):
            size = math.prod(shape[i] for i in combo)
            if any(shape[i] == 1 for i in combo) \
                    or size in (1, len(members)):
                continue
            rest = [i for i in range(n) if i not in combo]
            parts: dict = {}
            for li, c in enumerate(coords):
                parts.setdefault(tuple(c[i] for i in rest), []) \
                    .append(members[li])
            for ranks in parts.values():
                g = dist.new_group(ranks)
                if me in ranks:
                    out[combo] = g
    return out


def make_mesh_compat(shape, axes, *, device=None, ranks=None
                     ) -> Optional[Mesh]:
    """A mesh of ``shape`` over ``axes`` (the JAX package's
    ``make_mesh_compat``) on the ranks ``ranks`` of the default group
    (default: every rank, in order), with a process group for every
    combination of axes (``Mesh.group_for``); over NCCL every rank also
    joins a gloo group for host exchanges (the dry run's stand-in group
    serves as its own).

    Every rank of the default group calls it with the same arguments,
    member or not, in the same order as its other meshes: creating a
    process group is collective.  A rank outside ``ranks`` gets None."""
    axes, shape = tuple(axes), tuple(int(s) for s in shape)
    world = _world()
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(axes) != len(shape) or math.prod(shape) != len(members):
        raise ValueError(f"a mesh of shape {shape} over axes {axes} needs "
                         f"{math.prod(shape)} ranks, not {len(members)}")
    if len(set(members)) != len(members) \
            or not all(0 <= r < world for r in members):
        raise ValueError(f"ranks {members} are not distinct ranks of a "
                         f"world of {world}")
    me, backend = dist.get_rank(), dist.get_backend()
    group = dist.group.WORLD if len(members) == world \
        else dist.new_group(members)
    host = None if backend == "gloo" else group \
        if backend == STANDIN_BACKEND else dist.new_group(
            members, backend="gloo", timeout=HOST_TIMEOUT)
    groups = {tuple(axes[i] for i in combo): g for combo, g in
              _sub_groups(shape, members, me).items()}
    if me not in members:
        return None
    return Mesh(axes, dict(zip(axes, shape)), group, members.index(me),
                len(members), _rank_device(me, device), backend,
                host, groups)


def make_flat_mesh(axis: str = "data", *, device=None) -> Mesh:
    """1-D mesh over every rank of the default group (Sphere SPMD jobs,
    sort benchmarks)."""
    return make_mesh_compat((_world(),), (axis,), device=device)


def make_debug_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production axis names over every rank of the default group,
    the ranks on ``data``: ``(n, 1)`` over ``("data", "model")``, or
    ``(1, n, 1)`` over ``("pod", "data", "model")``."""
    n = _world()
    if multi_pod:
        return make_mesh_compat((1, n, 1), ("pod", "data", "model"),
                                device=device)
    return make_mesh_compat((n, 1), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The JAX package's pod mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``
    across two pods; raises unless the default group has exactly that
    many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_available() \
            and dist.is_initialized() else 0
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a default group of {need} ranks, not "
                         f"{have}")
    return make_mesh_compat(shape, axes, device=device)


# ------------------------------------------------------------ ranks
def _rank_main(rank: int, world: int, init: str, timeout_s: float,
               fn: Callable, args: tuple, results) -> None:
    """One spawned rank: join the group, run ``fn``, report, leave.  The
    ranks share the machine's cores (as ``torchrun`` has them do): torch's
    CPU ops oversubscribed by ``world`` full thread pools run many times
    slower."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              timeout_s: float = 60.0, join_timeout_s: float = 600.0
              ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    a rank of a gloo group (several ranks may share one GPU), and return
    their results in rank order.

    ``fn`` and ``args`` are pickled by import path, so ``fn`` is a
    module-level function; its result should be plain data (numpy arrays,
    bytes, numbers).  Every child gets ``PYTHONHASHSEED=0``, so the
    ranks' plans, which follow Python's string hash, agree.  The
    group meets at a ``file://`` store in a fresh temporary directory (no
    port to collide with), and its collectives raise after ``timeout_s``
    rather than hang.  If any rank fails, or the ranks have not all
    finished after ``join_timeout_s``, every rank still running is killed
    and the error (with the rank's traceback) is raised here.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = f"file://{os.path.join(tmp, 'store')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, init, timeout_s, fn, tuple(args),
                               results))
             for r in range(world)]
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            os.environ.pop("PYTHONHASHSEED")
        else:
            os.environ["PYTHONHASHSEED"] = saved
    out: dict = {}
    deadline = time.monotonic() + join_timeout_s
    try:
        while len(out) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(out))} of "
                    f"{world} did not finish in {join_timeout_s:.0f} s")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(1.0)       # a last report may be in flight
                    if results.empty():
                        raise RuntimeError(
                            f"{dead[0].name} exited with code "
                            f"{dead[0].exitcode} and no report")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]

