"""The port's TeraSort through ``SphereEngine`` against the JAX package,
plus the port's structural guarantees.

One TeraSort job (``terasort_stages``, range partitioner) runs through
the port's ``SphereEngine(device="cpu")`` and through the JAX engine on
its ``array`` and ``bytes`` backends, on identical Sector clouds built
from one numpy seed: outputs must be byte-identical and the
``SphereReport`` fields equal (``partition_seconds`` is wall clock and
``device_dispatches`` counts each lowering's own dispatches).  Then:
the port's verbatim copies match their reference files, the port
imports neither JAX nor ``repro``, and no path falls back silently.
"""
import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sector as jsector
import repro_torch.core as tcore
import repro_torch.sector as tsector
from repro.core import shuffle as jsh
from repro_torch.core import shuffle as tsh
from repro_torch.core.executor import _TracedUDF
from repro_torch.core.records import RecordBatch

REC = 100
ROOT = Path(__file__).resolve().parents[1]
# reports differ only in the wall clock and in how each lowering counts
# its device dispatches
_WALL_OR_LOWERING = {"partition_seconds", "device_dispatches"}
# fields only the array backends fill
_ARRAY_ONLY = {"udf_traces", "host_syncs"}


def _cloud(sector, tmp_path, n_servers=6, chunk_records=300):
    """``tests/conftest.py::make_cloud`` for either package's Sector."""
    master = sector.SectorMaster(chunk_size=chunk_records * REC)
    sites = master.topology.sites
    for i in range(n_servers):
        master.register(sector.ChunkServer(f"s{i}", sites[i % len(sites)],
                                           tmp_path))
    master.acl.add_member("alice")
    master.acl.grant_write("alice")
    return master, sector.SectorClient(master, "alice", "chicago")


def _data(n, seed=0):
    return np.random.default_rng(seed).bytes(n * REC)


def _run(which, tmp_path, data, n_buckets, *, n_servers=6,
         chunk_records=300, **engine_kw):
    """One TeraSort run: ``which`` is jax-array, jax-bytes or torch."""
    torch_side = which == "torch"
    sector = tsector if torch_side else jsector
    core = tcore if torch_side else jcore
    sh = tsh if torch_side else jsh
    backend = "bytes" if which == "jax-bytes" else "array"
    sub = tmp_path / f"{which}-{n_buckets}-{n_servers}-{len(data)}"
    sub.mkdir()
    master, client = _cloud(sector, sub, n_servers, chunk_records)
    client.upload("f", data, replication=3)
    sample = [data[i:i + REC] for i in range(0, min(len(data), 500 * REC),
                                             REC)]
    bounds = sh.sample_boundaries(sample, n_buckets, key_bytes=10)
    job = core.SphereJob("sort", "f",
                         sh.terasort_stages(bounds, backend, n_buckets),
                         record_size=REC, backend=backend)
    if torch_side:
        engine_kw.setdefault("device", "cpu")
    eng = core.SphereEngine(master, client, pad_block=64, **engine_kw)
    return eng.run(job)


def _fields(rep, skip):
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
            if f.name not in skip}


@pytest.mark.parametrize("n_buckets", [6, 16])
def test_terasort_matches_jax_backends(tmp_path, n_buckets):
    data = _data(2000, seed=n_buckets)
    outs, rep = _run("torch", tmp_path, data, n_buckets)
    j_outs, j_rep = _run("jax-array", tmp_path, data, n_buckets)
    b_outs, b_rep = _run("jax-bytes", tmp_path, data, n_buckets)
    assert outs == j_outs == b_outs
    assert sum(len(blob) for blob in outs) == len(data)
    for blob in outs:       # each worker's partition comes out sorted
        keys = [blob[i:i + 10] for i in range(0, len(blob), REC)]
        assert keys == sorted(keys)
    assert _fields(rep, _WALL_OR_LOWERING) == _fields(j_rep,
                                                      _WALL_OR_LOWERING)
    assert _fields(rep, _WALL_OR_LOWERING | _ARRAY_ONLY) == \
        _fields(b_rep, _WALL_OR_LOWERING | _ARRAY_ONLY)
    assert rep.udf_traces == {"partition": 1, "sort": 1}
    assert rep.host_syncs == rep.shuffle_rounds == 1


def test_unfused_rounds_give_same_bytes(tmp_path):
    data = _data(1500, seed=3)
    fused, f_rep = _run("torch", tmp_path, data, 6)
    loop, l_rep = _run("torch", _sub(tmp_path, "unfused"), data, 6,
                       fused_rounds=False)
    assert loop == fused
    assert l_rep.host_syncs == l_rep.shuffle_rounds == 1
    assert l_rep.udf_traces == {"partition": 1, "sort": 1}
    assert _fields(l_rep, _WALL_OR_LOWERING) == _fields(f_rep,
                                                        _WALL_OR_LOWERING)


def _sub(tmp_path, name):
    p = tmp_path / name
    p.mkdir()
    return p


def test_dispatches_constant_in_workers_and_tasks(tmp_path):
    """A fused round costs O(1) dispatches: doubling workers or tasks
    leaves ``device_dispatches`` unchanged."""
    base = _run("torch", tmp_path, _data(600, 1), 6, n_servers=3)[1]
    wide = _run("torch", tmp_path, _data(600, 1), 6, n_servers=6)[1]
    many = _run("torch", tmp_path, _data(1200, 1), 6, n_servers=3)[1]
    for rep in (base, wide, many):
        assert rep.shuffle_rounds == rep.host_syncs == 1
    assert base.device_dispatches == wide.device_dispatches \
        == many.device_dispatches == 4
    assert many.tasks > base.tasks


def test_chained_session_keeps_traces_and_syncs(tmp_path):
    master, client = _cloud(tsector, tmp_path)
    data = _data(900, seed=8)
    client.upload("f", data, replication=2)
    sample = [data[i:i + REC] for i in range(0, 300 * REC, REC)]
    job = tcore.SphereJob("sort", "f",
                          tsh.terasort_stages(
                              tsh.sample_boundaries(sample, 6), "array", 6),
                          record_size=REC, backend="array")
    sess = tcore.SphereEngine(master, client, pad_block=64,
                              device="cpu").session("f", record_size=REC,
                                                    backend="array")
    out1, rep1 = sess.run(job)
    out2, rep2 = sess.run(job, input="chained")
    assert out1 == out2
    for rep in (rep1, rep2):
        assert rep.host_syncs == rep.shuffle_rounds == 1


def _reduce_chain(core, sh, fold_masked):
    """The emit (reduce shuffle) -> mask-aware fold chain of
    ``tests/test_engine_backends.py``, for either package."""
    emit = core.SphereJob("emit", "f", [core.SphereStage(
        "emit", lambda rs: list(rs), batch_udf=lambda b: b, pad_value=0,
        partitioner=sh.reduce_partitioner())], record_size=8,
        backend="array")
    fold = core.SphereJob("fold", "f", [core.SphereStage(
        "fold", lambda rs: rs, masked_udf=fold_masked)], record_size=8,
        backend="array")
    return emit, fold


def test_chained_reduce_and_masked_fold_match_jax(tmp_path):
    """The reduce shuffle (which leaves the fused kernel round for the
    per-worker loop) and a mask-aware fold over the chained partials:
    same bytes and report fields as the JAX engine."""
    import jax
    import jax.numpy as jnp

    def j_fold(batch, mask, _params):
        arr = jax.lax.bitcast_convert_type(
            batch.data.reshape(batch.num_records, -1, 4), jnp.float32)
        arr = arr * mask.astype(jnp.float32)[:, None]
        raw = jax.lax.bitcast_convert_type(arr.sum(0, keepdims=True),
                                           jnp.uint8)
        return jcore.records.RecordBatch(raw.reshape(1, -1))

    def t_fold(batch, mask, _params):
        arr = batch.data.view(torch.float32) * mask.to(torch.float32)[:, None]
        return RecordBatch(arr.sum(0, keepdim=True).view(torch.uint8))

    vals = np.random.default_rng(7).integers(0, 1000, (40, 2)).astype("<f4")
    results = []
    for sector, core, sh, fold, kw in (
            (jsector, jcore, jsh, j_fold, {}),
            (tsector, tcore, tsh, t_fold, {"device": "cpu"})):
        sub = _sub(tmp_path, core.__name__)
        master = sector.SectorMaster(chunk_size=1000)
        for i, site in enumerate(master.topology.sites):
            master.register(sector.ChunkServer(f"s{i}", site, sub))
        master.acl.add_member("alice")
        master.acl.grant_write("alice")
        client = sector.SectorClient(master, "alice", "chicago")
        client.upload("f", vals.tobytes(), replication=2)
        emit, fold_job = _reduce_chain(core, sh, fold)
        sess = core.SphereEngine(master, client, **kw).session(
            "f", record_size=8, backend="array")
        sess.run(emit)
        results.append(sess.run(fold_job, input="chained"))
    (j_outs, j_rep), (outs, rep) = results
    assert outs == j_outs and len(outs) == 1
    np.testing.assert_array_equal(np.frombuffer(outs[0], "<f4"),
                                  vals.sum(0))
    assert _fields(rep, _WALL_OR_LOWERING) == _fields(j_rep,
                                                      _WALL_OR_LOWERING)


def test_vmapped_udf_matches_per_slot_loop():
    """The fused stage apply (torch.func.vmap over the slot axis) equals
    the per-slot loop, padding normalised to the pad byte first."""
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.integers(0, 4, size=(4, 64, 12),
                                         dtype=np.uint8))
    n_valid = np.array([64, 10, 0, 33], np.int32)
    traced = _TracedUDF("sort", lambda b: b.sort_by_key(10), pad_value=0xFF)
    got = traced.stacked(data, n_valid, 64)
    for i in range(4):
        want = traced(data[i], int(n_valid[i]))
        assert torch.equal(got[i], want)
    assert traced.traces == 2       # one stacked shape + one padded shape
    traced.stacked(data, n_valid, 64)
    assert traced.traces == 2


def test_vmapped_udf_without_batching_rule_raises():
    """An op vmap cannot batch raises; it is never looped per slot."""
    traced = _TracedUDF("bad", lambda b: RecordBatch(
        b.data[torch.nonzero(b.data[:, 0] >= 0)[:, 0]]), pad_value=0)
    with pytest.raises(RuntimeError):
        traced.stacked(torch.zeros((2, 8, 4), dtype=torch.uint8),
                       np.array([8, 3], np.int32), 8)


def test_default_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    master, client = _cloud(tsector, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.SphereEngine(master, client)
    # a mesh is a repro_torch Mesh (launch.mesh.make_flat_mesh)
    with pytest.raises(TypeError, match="Mesh"):
        tcore.SphereEngine(master, client, device="cpu", mesh=object())


# ------------------------------------------------- copies and imports
_VERBATIM = ["sector/chunk.py", "sector/acl.py", "sector/events.py",
             "sector/topology.py", "sector/transport.py", "sector/server.py",
             "sector/master.py", "sector/client.py", "sector/__init__.py",
             "sector/replication.py", "core/trace.py", "core/metrics.py",
             "core/planner.py", "core/job.py", "data/dataset.py",
             "data/synth.py"] + sorted(
    f"configs/{p.name}" for p in (ROOT / "src/repro/configs").glob("*.py"))


def _without_package_imports(path: Path, package: str) -> list:
    """Source lines minus every import statement of ``package``."""
    src = path.read_text()
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        if any(n == package or n.startswith(package + ".") for n in names):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [line for i, line in enumerate(src.splitlines(), 1)
            if i not in drop]


@pytest.mark.parametrize("rel", _VERBATIM)
def test_verbatim_copies_match_reference(rel):
    assert _without_package_imports(ROOT / "src/repro_torch" / rel,
                                    "repro_torch") == \
        _without_package_imports(ROOT / "src/repro" / rel, "repro")


def test_port_imports_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.sector\n"
            "import repro_torch.kernels.bucket_partition, repro_torch.convert\n"
            "import repro_torch.kernels.kmeans_assign, repro_torch.core.kmeans\n"
            "import repro_torch.sector.replication\n"
            "import repro_torch.models, repro_torch.serve, repro_torch.launch\n"
            "import repro_torch.launch.serve, repro_torch.configs\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.rg_lru_scan\n"
            "import repro_torch.train, repro_torch.data\n"
            "import repro_torch.launch.train, repro_torch.models.losses\n"
            "import repro_torch.core.spmd, repro_torch.launch.mesh\n"
            "import repro_torch.parallel.mesh_utils\n"
            "import repro_torch.parallel.sharding\n"
            "import repro_torch.parallel.sharded\n"
            "import repro_torch.parallel.collectives\n"
            "import repro_torch.train.elastic, repro_torch.train.step\n"
            "import repro_torch.launch.dryrun, repro_torch.kernels._meta\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_or_reference_import_in_port_sources():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_torch)|from\s+repro\b(?!_torch))", re.M)
    files = sorted((ROOT / "src/repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for rel in ("parallel/collectives.py", "parallel/sharded.py",
                "train/elastic.py", "launch/dryrun.py",
                "kernels/flash_attention/cost.py",
                "kernels/rg_lru_scan/cost.py"):
        assert ROOT / "src/repro_torch" / rel in files
    hits = [f"{f}: {m.group(0)}" for f in files
            for m in bad.finditer(f.read_text())]
    assert not hits
