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


def _terasort(tmp: Path, mesh, data):
    from repro_torch.core.trace import Tracer
    tracer = Tracer()
    eng, client = _engine(tmp, mesh, tracer)
    client.upload("f", data, replication=3)
    outs, rep = eng.run(_terasort_job(data))
    return outs, rep, _paths(tracer)


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
    try:
        o1, r1 = sess.run(_terasort_job(data))
        o2, r2 = sess.run(_terasort_job(data), input="chained")
    finally:
        eng.__class__._check_plan = check
        eng_mod.host_gather = gather
    return (o1, o2), (r1, r2), _paths(tracer), plans


def _stream(tmp: Path, mesh, files):
    """A sliding window of 2 over 3 arriving files: TeraSort and an
    identity job (no shuffle) on every window."""
    from repro_torch import core
    eng, client = _engine(tmp, mesh)
    stream = eng.stream("s/", window=core.WindowPolicy.sliding(2),
                        record_size=REC, backend="array")
    ident = core.SphereJob("id", "s/", [core.SphereStage(
        "id", lambda rs: list(rs), batch_udf=lambda b: b, pad_value=0xFF)],
        record_size=REC, backend="array")
    outs, reps = [], []
    for i, blob in enumerate(files):
        client.upload(f"s/{i}", blob, replication=2)
        if stream.windows_formed:
            for job in (_terasort_job(b"".join(files), "s/"), ident):
                o, r = stream.run(job)
                outs.append(o)
                reps.append(r)
    stream.close()
    return outs, reps


def _kmeans(tmp: Path, mesh):
    from repro_torch.core.kmeans import encode_points, kmeans_sphere
    eng, client = _engine(tmp, mesh)
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(c, 0.4, (300, 4))
                          for c in (np.zeros(4), np.full(4, 7.0))])
    client.upload("pts", encode_points(pts.astype(np.float32)),
                  replication=2)
    cents, _ = kmeans_sphere(eng, "pts", dim=4, k=2, iters=3,
                             backend="array")
    return cents


def engine_suite(rank: int, world: int, tmp: str, with_streams: bool):
    """``SphereEngine(mesh=)`` against the meshless engine in this
    process: TeraSort; with ``with_streams`` also a chained session, a
    sliding-window stream and ``kmeans_sphere``."""
    from repro_torch.launch.mesh import make_flat_mesh

    mesh = make_flat_mesh(device="cpu")
    base = Path(tmp) / f"rank{rank}"
    dirs = {}
    for key in ("tera", "tera-m", "sess", "sess-m", "strm", "strm-m",
                "km", "km-m"):
        dirs[key] = base / key
        dirs[key].mkdir(parents=True)
    data = tera_data()
    outs, rep, paths = _terasort(dirs["tera"], None, data)
    m_outs, m_rep, m_paths = _terasort(dirs["tera-m"], mesh, data)
    res = {"terasort": {
        "outs": m_outs, "same": m_outs == outs, "paths": (paths, m_paths),
        "diff": _diff(_fields(rep), _fields(m_rep)),
        "syncs": (m_rep.host_syncs, m_rep.shuffle_rounds),
        "dispatches": (rep.device_dispatches, m_rep.device_dispatches)}}
    if not with_streams:
        return res
    s_outs, s_reps, _, _ = _session(dirs["sess"], None, data)
    ms_outs, ms_reps, ms_paths, plans = _session(dirs["sess-m"], mesh, data)
    res["session"] = {
        "same": ms_outs == s_outs, "outs": ms_outs[1], "paths": ms_paths,
        "plans": plans,
        "diff": [_diff(_fields(a), _fields(b))
                 for a, b in zip(s_reps, ms_reps)],
        "syncs": [(r.host_syncs, r.shuffle_rounds) for r in ms_reps]}
    files = [tera_data(700, seed=20 + i) for i in range(3)]
    st_outs, st_reps = _stream(dirs["strm"], None, files)
    mst_outs, mst_reps = _stream(dirs["strm-m"], mesh, files)
    res["stream"] = {
        "same": mst_outs == st_outs, "n": len(mst_outs),
        "diff": [_diff(_fields(a), _fields(b))
                 for a, b in zip(st_reps, mst_reps)]}
    cents = _kmeans(dirs["km"], None)
    m_cents = _kmeans(dirs["km-m"], mesh)
    res["kmeans"] = (cents, m_cents)
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
