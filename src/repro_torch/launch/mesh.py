"""Mesh builders over ``torch.distributed``, and a launcher of ranks.

The port of ``repro.launch.mesh``.  JAX builds a mesh over the devices
one controller sees; here every rank is a process of its own, so a mesh
is built over an initialised default process group, one per rank
(:class:`repro_torch.parallel.mesh_utils.Mesh`).  Nothing here touches a
device or a process group when the module is imported.

:func:`run_ranks` starts ``D`` ranks on this machine (spawned processes,
a ``file://`` store, a collective timeout) and returns what each
returned: the CPU tests run the mesh over gloo with it, and
``chip_smoke.py`` runs several ranks on one GPU.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh_utils import Mesh

MESH_QUEUE = "not ported yet (ROADMAP.md item 1.3c, the mesh)"
# how long a host exchange waits for the other ranks before it raises
HOST_TIMEOUT = datetime.timedelta(minutes=5)


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


def _group_mesh(axes: Sequence[str], shape: dict, device) -> Mesh:
    """A mesh over the default group; over NCCL, every rank also joins a
    gloo group for host exchanges (a collective call: every rank builds
    its meshes in the same order, as it runs the same program)."""
    rank, backend = dist.get_rank(), dist.get_backend()
    host = None if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=HOST_TIMEOUT)
    return Mesh(tuple(axes), shape, dist.group.WORLD, rank,
                dist.get_world_size(), _rank_device(rank, device), backend,
                host)


def make_flat_mesh(axis: str = "data", *, device=None) -> Mesh:
    """1-D mesh over every rank of the default group (Sphere SPMD jobs,
    sort benchmarks)."""
    return _group_mesh((axis,), {axis: _world()}, device)


def make_debug_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production axis names over every rank of the default group:
    ``("data", "model")`` with the ranks on ``data``."""
    if multi_pod:
        raise NotImplementedError(f"the multi-pod debug mesh is {MESH_QUEUE}")
    return _group_mesh(("data", "model"), {"data": _world(), "model": 1},
                       device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's 16x16 TPU pod mesh (2x16x16 across two pods)."""
    raise NotImplementedError(
        f"the {'2x16x16' if multi_pod else '16x16'} production mesh is "
        f"{MESH_QUEUE}")


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

