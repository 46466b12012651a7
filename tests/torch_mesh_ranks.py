"""Rank bodies of the port's mesh tests (``test_torch_spmd.py``,
``test_torch_mesh.py``).

``repro_torch.launch.mesh.run_ranks`` spawns each rank and imports its
function from here by name, so this module imports only numpy, torch and
the port: no JAX, no ``conftest`` (a spawned rank starts from a fresh
interpreter).  Every rank builds its inputs from the same seed, runs on
the CPU over gloo, and returns plain data (bytes, numpy arrays, dicts)
that the test process holds against the JAX package.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

REC = 100

# fused rounds: S = 8 slots (divisible by every D tested), ragged loads
# with empty slots (at D = 4 rank 1's whole block is empty in "hash-w4")
ROUND_CASES = {
    "hash-w4": dict(loads=[5, 7, 0, 0, 3, 0, 12, 4], W=4, part=("hash", 8),
                    n=6, rec=12, seed=9),
    "range-w8": dict(loads=[8, 3, 0, 14, 5, 9, 1, 11], W=8,
                     part=("range", 10), n=5, rec=12, seed=3),
    "hash-w8": dict(loads=[0, 17, 2, 6, 0, 9, 13, 1], W=8, part=("hash", 4),
                    n=11, rec=16, seed=5),
    "range-w4": dict(loads=[21, 0, 4, 9, 2, 0, 6, 15], W=4,
                     part=("range", 10), n=9, rec=12, seed=7),
}
SORT_M = 1024           # uint32 keys a rank
KM_N, KM_K, KM_DIM = 512, 4, 3


def ragged_round(loads, rec, seed):
    """One slot of random records per entry of ``loads`` (0 = empty)."""
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, rec, dtype=np.uint8).tobytes()
             for _ in range(k)] for k in loads]


def partitioner(case, slots, sh):
    """The case's partitioner from either package's shuffle module."""
    kind, nbytes = case["part"]
    if kind == "hash":
        return sh.hash_partitioner(key_bytes=nbytes)
    allrec = [r for s in slots for r in s]
    return sh.range_partitioner(sh.sample_boundaries(
        allrec or [b"\0" * case["rec"]], case["n"], key_bytes=nbytes))


def sort_keys(world: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, world * SORT_M, dtype=np.uint32)


def km_inputs(seed: int = 4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(KM_K, KM_DIM)) * 6
    pts = (centers[rng.integers(0, KM_K, KM_N)]
           + rng.normal(size=(KM_N, KM_DIM))).astype(np.float32)
    return pts, rng.normal(size=(KM_K, KM_DIM)).astype(np.float32) * 4


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


# ------------------------------------------------------------ spmd
def spmd_suite(rank: int, world: int):
    """Every ``core.spmd`` entry on this rank's blocks."""
    from repro_torch.core import kmeans as tkm
    from repro_torch.core import shuffle as tsh
    from repro_torch.core import spmd
    from repro_torch.core.records import RecordBatch, StackedBatch
    from repro_torch.launch.mesh import make_flat_mesh

    mesh = make_flat_mesh(device="cpu")
    out = {"rounds": {}}
    for name, c in ROUND_CASES.items():
        slots = ragged_round(c["loads"], c["rec"], c["seed"])
        part = partitioner(c, slots, tsh)
        stacked = StackedBatch.pack(
            [RecordBatch.from_records(s, device="cpu") if s
             else RecordBatch.empty(c["rec"], "cpu") for s in slots],
            pad_block=8)
        key_spec, bounds = part.scatter_spec(
            RecordBatch.empty(c["rec"], "cpu"), c["n"])
        parts, counts, hist = spmd.fused_scatter_round(
            spmd.local_block(stacked.data, mesh),
            spmd.local_block(stacked.n_valid, mesh), bounds,
            key_spec=key_spec, n_buckets=c["n"], n_workers=c["W"],
            mesh=mesh)
        wpd = c["W"] // world
        counts = counts.numpy()
        out["rounds"][name] = {
            "counts": counts, "hist": hist.numpy(),
            "parts": {rank * wpd + j:
                      parts[j, :counts[rank * wpd + j]].numpy().tobytes()
                      for j in range(wpd)}}
    keys = torch.from_numpy(sort_keys(world).view(np.int32)) \
        .view(torch.uint32)
    mine = spmd.local_block(keys, mesh)
    srt, valid = spmd.distributed_sort(mine, mesh)
    out["sort"] = (_u32(srt), valid.numpy())
    out["barrier"] = _u32(spmd.barrier_sort(mine, mesh))
    # sphere_map over two arrays, sphere_shuffle of int32 and uint32
    x = torch.arange(world * world * 6, dtype=torch.int32) \
        .reshape(world * world, 6) * 7919
    y = x.flip(0) + 3
    stage = spmd.sphere_map(lambda a, b: a * 2 - b, mesh)
    mapped = stage(spmd.local_block(x, mesh), spmd.local_block(y, mesh))
    out["map"] = spmd.gather_blocks(mapped, mesh).numpy()
    out["shuffle"] = spmd.sphere_shuffle(spmd.local_block(x, mesh), None,
                                         mesh).numpy()
    out["shuffle_u32"] = _u32(spmd.sphere_shuffle(
        spmd.local_block(x, mesh).view(torch.uint32), None, mesh))
    out["roundtrip"] = bool(torch.equal(
        spmd.gather_blocks(spmd.local_block(x, mesh), mesh), x))
    pts, cents = km_inputs()
    new_c, inertia = tkm.kmeans_step(
        spmd.local_block(torch.from_numpy(pts), mesh),
        torch.from_numpy(cents), mesh=mesh)
    out["kmeans"] = (new_c.numpy(), float(inertia))
    return out


# ------------------------------------------------------------ engine
def cloud(tmp, n_servers=6, chunk_records=300):
    from repro_torch import sector
    master = sector.SectorMaster(chunk_size=chunk_records * REC)
    sites = master.topology.sites
    for i in range(n_servers):
        master.register(sector.ChunkServer(f"s{i}", sites[i % len(sites)],
                                           tmp))
    master.acl.add_member("alice")
    master.acl.grant_write("alice")
    return master, sector.SectorClient(master, "alice", "chicago")


def tera_data(n: int = 2000, seed: int = 6) -> bytes:
    return np.random.default_rng(seed).bytes(n * REC)


def tera_bounds(data: bytes, sh, n_buckets: int = 6):
    sample = [data[i:i + REC] for i in range(0, min(len(data), 500 * REC),
                                             REC)]
    return sh.sample_boundaries(sample, n_buckets, key_bytes=10)


def _fields(rep) -> dict:
    """The report's fields but the wall clock and the dispatch count
    (each lowering counts its own dispatches)."""
    return {k: v for k, v in dataclasses.asdict(rep).items()
            if k not in ("partition_seconds", "device_dispatches")}


def _diff(a: dict, b: dict) -> dict:
    return {k: (a[k], b[k]) for k in a if a[k] != b[k]}


def _engine(tmp: Path, mesh, tracer=None):
    from repro_torch import core
    master, client = cloud(tmp)
    return core.SphereEngine(master, client, pad_block=64, device="cpu",
                             mesh=mesh, tracer=tracer), client


def _terasort_job(data, name="f"):
    from repro_torch import core
    from repro_torch.core import shuffle as sh
    return core.SphereJob("sort", name,
                          sh.terasort_stages(tera_bounds(data, sh), "array",
                                             6),
                          record_size=REC, backend="array")


def _paths(tracer):
    return sorted({sp.attrs.get("path") for sp in tracer.snapshot()
                   if sp.name == "shuffle-round"})


def own_chunks(plan, workers, rank: int, world: int) -> list:
    """The stage-0 chunks rank ``rank`` of ``world`` owns: the plan's
    ``(key, executor, nbytes)`` tasks with bytes, stable-sorted by their
    executor's place in ``workers``, in blocks of ``ceil(n / world)``."""
    order = sorted((t for t in plan if t[2] > 0),
                   key=lambda t: workers.index(t[1]))
    k = -(-len(order) // world)
    return [t[0] for t in order[rank * k:(rank + 1) * k]]


class _Reads:
    """What each run of one engine read: the chunks this rank fetched
    (the tracer's ``fetch-chunk`` spans, one per read attempt on a
    thread), the run's stage-0 plan (its simulated task spans) and the
    chunks of it this rank owns."""

    def __init__(self, tracer, workers, mesh):
        self.tracer, self.workers = tracer, list(workers)
        self.rank, self.world = ((0, 1) if mesh is None else
                                 (mesh.axis_index("data"),
                                  mesh.shape["data"]))
        self.mark = 0

    def take(self, stage0: str) -> dict:
        ev = self.tracer.snapshot()[self.mark:]
        self.mark += len(ev)
        plan = list({e.name: (e.name[len("task:"):],
                              e.track[len("worker:"):], e.attrs["nbytes"])
                     for e in ev
                     if e.clock == "sim" and e.name.startswith("task:")
                     and e.attrs.get("stage") == stage0}.values())
        return {"fetched": [e.attrs["key"] for e in ev
                            if e.name == "fetch-chunk"],
                "plan": [k for k, _, n in plan if n],
                "own": own_chunks(plan, self.workers, self.rank, self.world),
                "assigns": sum(1 for e in ev if e.name == "dispatch:udf"
                               and e.attrs.get("stage") == "assign")}


def _terasort(tmp: Path, mesh, data, replication=3, dead=None):
    """One TeraSort; ``dead`` names a server killed (and deregistered)
    after the upload."""
    from repro_torch.core.trace import Tracer
    tracer = Tracer()
    eng, client = _engine(tmp, mesh, tracer)
    client.upload("f", data, replication=replication)
    if dead is not None:
        eng.master.servers[dead].kill()
        eng.master.deregister(dead)
    reads = _Reads(tracer, eng._workers(), mesh)
    outs, rep = eng.run(_terasort_job(data))
    return outs, rep, _paths(tracer), reads.take("partition")


def _session(tmp: Path, mesh, data):
    """Two chained TeraSorts in one session; also counts the stage plans
    checked across ranks and the host exchanges they took."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.trace import Tracer
    tracer = Tracer()
    eng, client = _engine(tmp, mesh, tracer)
    client.upload("f", data, replication=2)
    sess = eng.session("f", record_size=REC, backend="array")
    plans = {"checked": 0, "exchanged": 0}
    check, gather = eng.__class__._check_plan, eng_mod.host_gather

    def counted_check(self, *a):
        plans["checked"] += 1
        return check(self, *a)

    def counted_gather(*a):
        plans["exchanged"] += 1
        return gather(*a)
    eng.__class__._check_plan = counted_check
    eng_mod.host_gather = counted_gather
    reads = _Reads(tracer, eng._workers(), mesh)
    try:
        o1, r1 = sess.run(_terasort_job(data))
        read1 = reads.take("partition")
        o2, r2 = sess.run(_terasort_job(data), input="chained")
        read2 = reads.take("partition")
    finally:
        eng.__class__._check_plan = check
        eng_mod.host_gather = gather
    return (o1, o2), (r1, r2), _paths(tracer), plans, (read1, read2)


def _stream(tmp: Path, mesh, files):
    """A sliding window of 2 over 3 arriving files: TeraSort and an
    identity job (no shuffle) on every window; each job's reads and the
    chunk cache's keys before and after it."""
    from repro_torch import core
    from repro_torch.core.trace import Tracer
    tracer = Tracer()
    eng, client = _engine(tmp, mesh, tracer)
    stream = eng.stream("s/", window=core.WindowPolicy.sliding(2),
                        record_size=REC, backend="array")
    ident = core.SphereJob("id", "s/", [core.SphereStage(
        "id", lambda rs: list(rs), batch_udf=lambda b: b, pad_value=0xFF)],
        record_size=REC, backend="array")
    reads = _Reads(tracer, eng._workers(), mesh)
    outs, reps, seen = [], [], []
    for i, blob in enumerate(files):
        client.upload(f"s/{i}", blob, replication=2)
        if stream.windows_formed:
            for job in (_terasort_job(b"".join(files), "s/"), ident):
                before = sorted(stream.executor._chunk_cache)
                o, r = stream.run(job)
                outs.append(o)
                reps.append(r)
                seen.append({**reads.take(job.stages[0].name),
                             "cached_before": before,
                             "cached": sorted(stream.executor._chunk_cache)})
    stream.close()
    return outs, reps, seen


KM_ITERS = 3


def km_points() -> np.ndarray:
    """8,000 float32 points of 4 dims in two clusters: 5 chunks of the
    engine cloud's 30,000 bytes."""
    rng = np.random.default_rng(2)
    return np.concatenate([rng.normal(c, 0.4, (4000, 4))
                           for c in (np.zeros(4), np.full(4, 7.0))]) \
        .astype(np.float32)


def _kmeans(tmp: Path, mesh):
    """``kmeans_sphere`` over ``km_points``: the centroids, the report's
    fields and what the iterations read."""
    from repro_torch.core.kmeans import encode_points, kmeans_sphere
    from repro_torch.core.trace import Tracer
    tracer = Tracer()
    eng, client = _engine(tmp, mesh, tracer)
    client.upload("pts", encode_points(km_points()), replication=2)
    reads = _Reads(tracer, eng._workers(), mesh)
    cents, rep = kmeans_sphere(eng, "pts", dim=4, k=2, iters=KM_ITERS,
                               backend="array")
    return cents, _fields(rep), reads.take("assign")


def _tera_case(dirs, key, mesh, data, **kw) -> dict:
    """One TeraSort case without and with the mesh, in this process."""
    outs, rep, paths, reads = _terasort(dirs[key], None, data, **kw)
    m_outs, m_rep, m_paths, m_reads = _terasort(dirs[key + "-m"], mesh,
                                                 data, **kw)
    return {"outs": m_outs, "same": m_outs == outs, "paths": (paths, m_paths),
            "diff": _diff(_fields(rep), _fields(m_rep)),
            "syncs": (m_rep.host_syncs, m_rep.shuffle_rounds),
            "dispatches": (rep.device_dispatches, m_rep.device_dispatches),
            "retried": (rep.retried, m_rep.retried),
            "reads": (reads, m_reads)}


def engine_suite(rank: int, world: int, tmp: str, with_streams: bool):
    """``SphereEngine(mesh=)`` against the meshless engine in this
    process: TeraSort, also with a dead server (replication 3) and with a
    lost chunk (replication 1, its server dead); with ``with_streams``
    also a chained session, a sliding-window stream and
    ``kmeans_sphere``.  Each case reports what the rank read."""
    from repro_torch.launch.mesh import make_flat_mesh

    mesh = make_flat_mesh(device="cpu")
    base = Path(tmp) / f"rank{rank}"
    dirs = {}
    for key in ("tera", "dead", "lost", "sess", "strm", "km"):
        for d in (key, key + "-m"):
            dirs[d] = base / d
            dirs[d].mkdir(parents=True)
    data = tera_data()
    res = {"terasort": _tera_case(dirs, "tera", mesh, data),
           "dead": _tera_case(dirs, "dead", mesh, data, dead="s2"),
           "lost": _tera_case(dirs, "lost", mesh, data, replication=1,
                              dead="s2")}
    if not with_streams:
        return res
    s_outs, s_reps, _, _, _ = _session(dirs["sess"], None, data)
    ms_outs, ms_reps, ms_paths, plans, reads = _session(dirs["sess-m"], mesh,
                                                        data)
    res["session"] = {
        "same": ms_outs == s_outs, "outs": ms_outs[1], "paths": ms_paths,
        "plans": plans, "reads": reads,
        "diff": [_diff(_fields(a), _fields(b))
                 for a, b in zip(s_reps, ms_reps)],
        "syncs": [(r.host_syncs, r.shuffle_rounds) for r in ms_reps]}
    files = [tera_data(700, seed=20 + i) for i in range(3)]
    st_outs, st_reps, _ = _stream(dirs["strm"], None, files)
    mst_outs, mst_reps, seen = _stream(dirs["strm-m"], mesh, files)
    res["stream"] = {
        "same": mst_outs == st_outs, "n": len(mst_outs), "reads": seen,
        "diff": [_diff(_fields(a), _fields(b))
                 for a, b in zip(st_reps, mst_reps)]}
    cents, fields, reads = _kmeans(dirs["km"], None)
    m_cents, m_fields, m_reads = _kmeans(dirs["km-m"], mesh)
    res["kmeans"] = {"cents": (cents, m_cents),
                     "diff": _diff(fields, m_fields),
                     "reads": (reads, m_reads)}
    return res


def mismatched_plans(rank: int, world: int, tmp: str):
    """Rank 1 uploads a longer file: the plans differ, and the engine
    must raise before any rank exchanges data."""
    from repro_torch.launch.mesh import make_flat_mesh

    mesh = make_flat_mesh(device="cpu")
    d = Path(tmp) / f"rank{rank}"
    d.mkdir(parents=True)
    data = tera_data(600 + 300 * rank)
    eng, client = _engine(d, mesh)
    client.upload("f", data, replication=3)
    eng.run(_terasort_job(data))
