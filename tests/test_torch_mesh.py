"""``SphereEngine(mesh=)`` end to end over gloo ranks on the CPU, against
the meshless port and the JAX package; the mesh builders and guards.

Each rank (``torch_mesh_ranks.engine_suite``) builds the same Sector
cloud from one seed under its own directory and runs every job twice in
one process, once without a mesh and once on a ``make_flat_mesh()``
engine; the test process holds the mesh run's bytes against the JAX
package's meshless array backend.  TeraSort has 6 workers, so at D = 2
the shuffle is the mesh round (``path="mesh"``) and at D = 4 it is
gathered and runs replicated (``path="mesh-gathered"``).  Required: the
outputs byte-identical, the ``SphereReport`` fields equal to the meshless
run's in the same process (but the wall clock and the dispatch count),
``host_syncs == shuffle_rounds`` and no more dispatches than the meshless
round.  Stage 0 is split over the ranks: each rank fetches exactly the
chunks of its own slots of the plan (``torch_mesh_ranks.own_chunks``
states the rule apart from the engine), the ranks' sets are disjoint and
cover the plan, also with a dead server and with a lost chunk.  At D = 2
also a chained session (its chained job fetches nothing), a
sliding-window stream (each window fetches a chunk it does not hold once,
on its owner; a rank's cache holds only its own chunks) and
``kmeans_sphere`` (centroids bit for bit; each rank assigns only its own
chunks).  Two ranks with different plans raise ``RuntimeError`` rather
than hang.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sector as jsector
import torch_mesh_ranks as ranks
from repro.core import kmeans as jkm
from repro.core import shuffle as jsh
from repro_torch.core import SphereEngine
from repro_torch.core.kmeans import kmeans_step
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.mesh import run_ranks
from repro_torch.parallel import mesh_utils


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    runs = {}

    def get(world):
        if world not in runs:
            tmp = tmp_path_factory.mktemp(f"mesh{world}")
            runs[world] = run_ranks(ranks.engine_suite, world,
                                    (str(tmp), world == 2),
                                    join_timeout_s=300)
        return runs[world]
    return get


def _jax_cloud(tmp_path):
    """The JAX package's Sector cloud of ``torch_mesh_ranks.cloud``."""
    master = jsector.SectorMaster(chunk_size=300 * ranks.REC)
    sites = master.topology.sites
    for i in range(6):
        master.register(jsector.ChunkServer(f"s{i}", sites[i % len(sites)],
                                            tmp_path))
    master.acl.add_member("alice")
    master.acl.grant_write("alice")
    return master, jsector.SectorClient(master, "alice", "chicago")


def _jax_terasort(tmp_path):
    """The JAX package's meshless array-backend TeraSort of the same
    cloud and data."""
    data = ranks.tera_data()
    master, client = _jax_cloud(tmp_path)
    client.upload("f", data, replication=3)
    job = jcore.SphereJob("sort", "f",
                          jsh.terasort_stages(ranks.tera_bounds(data, jsh),
                                              "array", 6),
                          record_size=ranks.REC, backend="array")
    return jcore.SphereEngine(master, client, pad_block=64).run(job)[0]


def _check_split(reads, once=True):
    """Each rank fetched exactly the chunks of its own slots (each once,
    with ``once``), and the ranks' sets are disjoint and cover the
    plan's stage-0 chunks."""
    plan = reads[0]["plan"]
    assert plan and all(r["plan"] == plan for r in reads)
    for rank, r in enumerate(reads):
        got = r["fetched"] if once else sorted(set(r["fetched"]))
        assert sorted(got) == sorted(r["own"]), f"rank {rank}: {r}"
    owns = [k for r in reads for k in r["own"]]
    assert sorted(owns) == sorted(plan)            # disjoint and covering
    assert len(reads) == 1 or all(len(r["own"]) < len(plan) for r in reads)


@pytest.mark.parametrize("world,path", [(2, "mesh"), (4, "mesh-gathered")])
def test_mesh_terasort_matches_meshless_and_jax(suite, world, path,
                                                tmp_path):
    want = _jax_terasort(tmp_path)
    assert b"".join(want) == b"".join(sorted(
        ranks.tera_data()[i:i + ranks.REC]
        for i in range(0, len(ranks.tera_data()), ranks.REC)))
    for rank, res in enumerate(suite(world)):
        t = res["terasort"]
        assert t["same"], f"rank {rank}: mesh outputs differ from meshless"
        assert t["outs"] == want
        assert t["paths"] == (["fused"], [path])
        assert t["diff"] == {}, f"rank {rank}: report fields {t['diff']}"
        syncs, rounds = t["syncs"]
        assert syncs == rounds == 1
        meshless, mesh = t["dispatches"]
        assert mesh <= meshless


@pytest.mark.parametrize("case", ["terasort", "dead", "lost"])
@pytest.mark.parametrize("world", [2, 4])
def test_mesh_stage0_reads_only_own_chunks(suite, world, case):
    """Stage 0 split over the ranks: the meshless engine reads every
    chunk, a mesh rank only its own slots' chunks; with a dead server
    (replication 3) and with a lost chunk (replication 1, its server
    dead) the outputs, the summed ``retried`` and every other report
    field equal the meshless run's."""
    res = suite(world)
    lost = case == "lost"
    _check_split([r[case]["reads"][0] for r in res[:1]], once=not lost)
    _check_split([r[case]["reads"][1] for r in res], once=not lost)
    for rank, r in enumerate(res):
        t = r[case]
        assert t["same"] and t["diff"] == {}, f"rank {rank}: {t['diff']}"
        assert t["syncs"] == (1, 1)
        meshless, mesh = t["retried"]
        assert mesh == meshless and (meshless > 0) == lost
    if lost:                   # the lost chunk's records are not in the output
        assert len(b"".join(res[0]["lost"]["outs"])) \
            < len(ranks.tera_data())


def test_mesh_session_chains_like_meshless(suite):
    _check_split([res["session"]["reads"][0] for res in suite(2)])
    for res in suite(2):
        s = res["session"]
        assert s["reads"][1]["fetched"] == []     # the chained job
        assert s["same"] and s["paths"] == ["mesh"]
        assert s["diff"] == [{}, {}]
        assert s["syncs"] == [(1, 1), (1, 1)]
        # two stages a run; the chained run repeats the sort stage's plan,
        # which the ranks agreed on already and do not exchange again
        assert s["plans"] == {"checked": 4, "exchanged": 3}
        blob = b"".join(s["outs"])
        recs = [blob[i:i + ranks.REC] for i in range(0, len(blob), ranks.REC)]
        assert recs == sorted(recs)


def test_mesh_stream_windows_like_meshless(suite):
    for res in suite(2):
        s = res["stream"]
        assert s["same"] and s["n"] == 4     # 2 windows x 2 jobs
        assert s["diff"] == [{}] * 4
    for job in range(4):
        reads = [res["stream"]["reads"][job] for res in suite(2)]
        owns = [k for r in reads for k in r["own"]]
        assert sorted(owns) == sorted(reads[0]["plan"])
        for rank, r in enumerate(reads):
            # a chunk the rank does not hold is fetched once, on its owner
            assert sorted(r["fetched"]) == sorted(
                set(r["own"]) - set(r["cached_before"])), (job, rank, r)
            assert r["cached"] == sorted(r["own"]), (job, rank, r)
    # the second window's jobs read its new file's chunks
    assert any(res["stream"]["reads"][2]["fetched"] for res in suite(2))


def test_mesh_kmeans_sphere_bit_identical(suite, tmp_path):
    """Each rank assigns only its own chunks; the centroids equal the
    meshless run's bit for bit and the JAX package's within
    ``tests/test_torch_kmeans.py``'s tolerance."""
    res = suite(2)
    meshless = res[0]["kmeans"]["reads"][0]
    assert len(meshless["plan"]) >= 4
    assert meshless["assigns"] == len(meshless["plan"]) * ranks.KM_ITERS
    reads = [r["kmeans"]["reads"][1] for r in res]
    _check_split(reads)
    for rank, (r, read) in enumerate(zip(res, reads)):
        cents, m_cents = r["kmeans"]["cents"]
        np.testing.assert_array_equal(cents, m_cents)
        assert r["kmeans"]["diff"] == {}, f"rank {rank}"
        assert read["assigns"] == len(read["own"]) * ranks.KM_ITERS
    assert sum(r["assigns"] for r in reads) == meshless["assigns"]
    master, client = _jax_cloud(tmp_path)
    client.upload("pts", jkm.encode_points(ranks.km_points()), replication=2)
    want, _ = jkm.kmeans_sphere(jcore.SphereEngine(master, client,
                                                   pad_block=64),
                                "pts", dim=4, k=2, iters=ranks.KM_ITERS,
                                backend="array")
    np.testing.assert_allclose(res[0]["kmeans"]["cents"][1], want,
                               rtol=1e-5, atol=1e-5)


def test_ranks_with_different_plans_raise(tmp_path):
    with pytest.raises(RuntimeError, match="planned differently"):
        run_ranks(ranks.mismatched_plans, 2, (str(tmp_path),),
                  timeout_s=30, join_timeout_s=120)


def test_run_ranks_reports_a_rank_error(tmp_path):
    """A rank that raises is reported with its traceback; the others are
    stopped, not left waiting."""
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed"):
        run_ranks(ranks.mismatched_plans, 2, ("/dev/null/x",),
                  timeout_s=20, join_timeout_s=120)


# ------------------------------------------------------ builders, guards
def test_host_gather_axis_keeps_one_axis(monkeypatch):
    """The split stage 0's host exchange keeps, in axis order, the ranks
    that differ from this one only along the axis (rank ``g``'s entry is
    ``[g]``; ranks are row-major over the mesh's axes)."""
    from repro_torch.core import spmd

    for shape, rank, axis, want in (
            ({"data": 2, "model": 3}, 4, "data", [1, 4]),
            ({"data": 2, "model": 3}, 4, "model", [3, 4, 5]),
            ({"pod": 2, "data": 2, "model": 2}, 5, "data", [5, 7]),
            ({"pod": 2, "data": 2, "model": 2}, 5, "pod", [1, 5]),
            ({"data": 4}, 2, "data", [0, 1, 2, 3])):
        size = int(np.prod(list(shape.values())))
        mesh = mesh_utils.Mesh(tuple(shape), shape, object(), rank, size,
                               "cpu", "gloo")
        monkeypatch.setattr(spmd, "host_gather",
                            lambda values, m, n=size: [[g] for g in range(n)])
        assert spmd.host_gather_axis([0], mesh, axis) == [[g] for g in want]


def test_mesh_builders_need_a_group_and_name_the_queue():
    """Every builder needs the default group; the production meshes name
    the ranks they need."""
    for build in (lmesh.make_flat_mesh, lmesh.make_debug_mesh):
        with pytest.raises(RuntimeError, match="process group"):
            build(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        lmesh.make_debug_mesh(multi_pod=True, device="cpu")
    for multi, need in ((False, "256 ranks"), (True, "512 ranks")):
        with pytest.raises(ValueError, match=need):
            lmesh.make_production_mesh(multi_pod=multi)


def test_mesh_utils():
    if torch.cuda.is_available():
        assert mesh_utils.single_device_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_utils.single_device_mesh()
    m = mesh_utils.single_device_mesh(device="cpu")
    assert m.shape["data"] == m.shape.get("model") == 1
    assert mesh_utils.mesh_axis_sizes(m) == {"data": 1, "model": 1}
    mesh_utils.validate_mesh(m, 1)
    with pytest.raises(ValueError):
        mesh_utils.validate_mesh(m, 2)
    grid = mesh_utils.Mesh(("data", "model"), {"data": 2, "model": 3},
                           object(), 4, 6, "cpu", "gloo")
    assert (grid.axis_index("data"), grid.axis_index("model")) == (1, 1)
    assert not grid.host_staged and grid.host_group is grid.group
    with pytest.raises(ValueError):
        mesh_utils.Mesh(("data",), {"data": 2}, None, 0, 2, "cpu", None)
    with pytest.raises(ValueError, match="host_group"):
        mesh_utils.Mesh(("data",), {"data": 2}, object(), 0, 2, "cuda:0",
                        "nccl")
    # groups by axis: the whole mesh, this rank alone, or one of its own
    g3 = mesh_utils.Mesh(("pod", "data", "model"),
                         {"pod": 2, "data": 2, "model": 1}, "all", 3, 4,
                         "cpu", "gloo", groups={("pod",): "p", ("data",): "d"})
    assert g3.mesh_axes(("model", "data", "pod")) == ("pod", "data")
    assert g3.group_for(("pod", "data", "model")) == "all"
    assert g3.group_for("model") is None
    assert (g3.group_for("pod"), g3.group_for("data")) == ("p", "d")
    assert (g3.axes_size(("pod", "data")), g3.axes_index(("pod", "data")),
            g3.axes_index(("data", "pod"))) == (4, 3, 3)
    with pytest.raises(KeyError):
        g3.mesh_axes("tensor")


def test_engine_and_step_take_a_mesh(tmp_path):
    master, client = ranks.cloud(tmp_path)
    one = mesh_utils.single_device_mesh(("data",), device="cpu")
    eng = SphereEngine(master, client, mesh=one)
    assert eng.mesh is one and eng.device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's device"):
        SphereEngine(master, client, mesh=one, device="cuda")
    with pytest.raises(TypeError):
        SphereEngine(master, client, device="cpu", mesh=object())
    pts = torch.randn(20, 3, generator=torch.Generator().manual_seed(0))
    c = pts[:2].clone()
    a, ia = kmeans_step(pts, c)
    b, ib = kmeans_step(pts, c, mesh=one)
    assert torch.equal(a, b) and torch.equal(ia, ib)
