"""SphereSession: job chaining over one planner/executor.

Covers the session reuse guarantees: chained jobs share one planner and
one Sector lookup (no duplicate metadata traffic), stage-0 chunks are
fetched once for the whole chain, speculation/straggler state resets at
job boundaries, chained input feeds the previous job's partitions into
the next job without touching Sector, and the two record backends still
produce identical SphereReports when driven through a session.

The reference's ``tests/test_session.py`` run on the port
(``repro_torch``) on the CPU: the same cases, every engine built with
``device="cpu"``, every cloud over the port's Sector, and k-means
params as torch tensors."""
import numpy as np
import pytest

from repro_torch.core import (SphereEngine, SphereJob, SpherePlanner,
                              SphereStage, TaskSpec)
from repro_torch.core.kmeans import encode_points, kmeans_sphere
from repro_torch.core.shuffle import sample_boundaries, terasort_stages


def make_cloud(tmp_path, chunk_size=64 * 1024, n_servers=6, user="alice"):
    """``tests/conftest.py::make_cloud`` over the port's Sector."""
    from repro_torch.sector import ChunkServer, SectorClient, SectorMaster

    master = SectorMaster(chunk_size=chunk_size)
    sites = master.topology.sites
    servers = [ChunkServer(f"s{i}", sites[i % len(sites)], tmp_path)
               for i in range(n_servers)]
    for s in servers:
        master.register(s)
    master.acl.add_member(user)
    master.acl.grant_write(user)
    client = SectorClient(master, user, "chicago")
    return master, servers, client


REC = 100


def _upload(client, name, n, seed=0, replication=2):
    rng = np.random.default_rng(seed)
    data = rng.bytes(n * REC)
    client.upload(name, data, replication=replication)
    return data


def _identity_job(backend):
    return SphereJob("id", "f",
                     [SphereStage("id", lambda rs: list(rs),
                                  batch_udf=lambda b: b, pad_value=0xFF)],
                     record_size=REC, backend=backend)


def _report_key(rep):
    return (rep.tasks, rep.retried, rep.speculated, rep.speculation_wins,
            rep.bytes_local, rep.bytes_moved, rep.partitioned_records,
            pytest.approx(rep.sim_seconds),
            [pytest.approx(s) for s in rep.stage_seconds])


@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_session_matches_engine_run(tmp_path, backend):
    """A session job is the same job: outputs and report counters equal a
    one-shot engine.run, and so does every later run of the chain (the
    cached lookup/plan re-charge identical counters)."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=60)
    eng = SphereEngine(master, client, device="cpu")
    ref_outs, ref_rep = eng.run(_identity_job(backend))

    sess = eng.session("f", record_size=REC, backend=backend)
    for _ in range(3):
        outs, rep = sess.run(_identity_job(backend))
        assert outs == ref_outs
        assert _report_key(rep) == _report_key(ref_rep)
    assert sess.jobs_run == 3


def test_chained_jobs_share_one_lookup_and_planner(tmp_path):
    """After the first chained job, later jobs touch the Sector master
    zero times (metadata lookup AND chunk reads are amortised across the
    chain) and keep the same planner instance; every unchained
    engine.run pays the lookups again."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=40)
    calls = []
    orig = master.lookup
    master.lookup = lambda *a, **k: calls.append(a) or orig(*a, **k)

    eng = SphereEngine(master, client, device="cpu")
    sess = eng.session("f", record_size=REC, backend="array")
    planner = sess.planner
    sess.run(_identity_job("array"))
    cold = len(calls)
    assert cold > 0
    for _ in range(2):
        sess.run(_identity_job("array"))
        assert sess.planner is planner
    assert len(calls) == cold  # no duplicate lookups across the chain

    eng.run(_identity_job("array"))
    assert len(calls) > cold   # the one-shot path re-looks-up


@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_session_fetches_each_chunk_once(tmp_path, backend):
    """cache_chunks: the chain pays the Sector read + decode host
    round-trip once per chunk, not once per job."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=40)
    reads = []
    orig = client.read_chunk
    client.read_chunk = lambda *a, **k: reads.append(a) or orig(*a, **k)

    eng = SphereEngine(master, client, device="cpu")
    sess = eng.session("f", record_size=REC, backend=backend)
    sess.run(_identity_job(backend))
    per_job = len(reads)
    assert per_job > 0
    for _ in range(2):
        sess.run(_identity_job(backend))
    assert len(reads) == per_job  # cached: no further Sector reads


def test_chained_input_feeds_next_job_without_sector(tmp_path):
    """run(job, input='chained') consumes the previous job's output
    partitions in place: the chained sort matches a single two-stage
    engine.run job byte-for-byte and performs zero Sector reads."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    data = _upload(client, "f", n=80, replication=3)
    sample = [data[i:i + REC] for i in range(0, 80 * REC, REC)]
    bounds = sample_boundaries(sample, 4, key_bytes=10)

    eng = SphereEngine(master, client, device="cpu")
    stages = terasort_stages(bounds, "array", 4)
    want, _ = eng.run(SphereJob("sort", "f", stages, record_size=REC,
                                backend="array"))

    sess = eng.session("f", record_size=REC, backend="array")
    sess.run(SphereJob("part", "f", stages[:1], record_size=REC,
                       backend="array"))
    reads = []
    orig = client.read_chunk
    client.read_chunk = lambda *a, **k: reads.append(a) or orig(*a, **k)
    got, _ = sess.run(SphereJob("sort2", "f", stages[1:], record_size=REC,
                                backend="array"), input="chained")
    assert reads == []
    assert got == want


def test_chained_without_previous_job_raises(tmp_path):
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=10)
    sess = SphereEngine(master, client, device="cpu").session("f", record_size=REC,
                                                backend="array")
    with pytest.raises(RuntimeError, match="chain"):
        sess.run(_identity_job("array"), input="chained")


def test_session_rejects_mismatched_jobs(tmp_path):
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=10)
    sess = SphereEngine(master, client, device="cpu").session("f", record_size=REC,
                                                backend="array")
    with pytest.raises(ValueError, match="backend"):
        sess.run(SphereJob("j", "f", [SphereStage("id", lambda rs: rs)],
                           record_size=REC, backend="bytes"))
    with pytest.raises(ValueError, match="session"):
        sess.run(SphereJob("j", "g", [SphereStage("id", lambda rs: rs,
                                                  batch_udf=lambda b: b)],
                           record_size=REC, backend="array"))


def test_planner_straggler_state_resets():
    """plan_stage records observed stragglers for the current job;
    reset_job_state forgets them at the job boundary."""
    p = SpherePlanner(speeds={"slow": 0.02, "fast": 1.0},
                      speculate_factor=1.5)
    tasks = [TaskSpec(f"c{i}", 1000, ("slow", "fast")) for i in range(40)]
    plan = p.plan_stage(tasks, ["slow", "fast"])
    assert plan.speculated > 0
    assert p.job_stragglers.get("slow", 0) > 0
    p.reset_job_state()
    assert p.job_stragglers == {}


def test_session_resets_straggler_state_between_jobs(tmp_path):
    """The shared planner's per-job speculation state must not ACCUMULATE
    across chained jobs: every job starts from a reset planner, and a job
    reusing the cached stage-0 plan replays exactly the observations that
    planning stage 0 made the first time — so after any number of jobs
    the state equals one job's worth, never a running total."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000,
                                         n_servers=2)
    _upload(client, "f", n=400, replication=2)
    slow = {servers[0].server_id: 0.02, servers[1].server_id: 1.0}
    eng = SphereEngine(master, client, device="cpu", speeds=slow, speculate_factor=1.5)
    sess = eng.session("f", record_size=REC, backend="array")
    _, rep = sess.run(_identity_job("array"))
    assert rep.speculated > 0
    snap = dict(sess.planner.job_stragglers)
    assert snap  # observed during stage-0 planning
    for _ in range(2):
        sess.run(_identity_job("array"))
        assert sess.planner.job_stragglers == snap  # replayed, not summed


def test_session_multistage_speculation_parity(tmp_path):
    """A chained multi-stage job with a straggling worker schedules
    exactly like a fresh engine.run every time — the cached stage-0 plan
    replays its straggler observations, so later-stage speculation sees
    the same per-job state."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000,
                                         n_servers=2)
    data = _upload(client, "f", n=200, replication=2)
    sample = [data[i:i + REC] for i in range(0, 200 * REC, REC)]
    bounds = sample_boundaries(sample, 2, key_bytes=10)
    slow = {servers[0].server_id: 0.02, servers[1].server_id: 1.0}
    eng = SphereEngine(master, client, device="cpu", speeds=slow, speculate_factor=1.5)

    def job():
        return SphereJob("sort", "f", terasort_stages(bounds, "array", 2),
                         record_size=REC, backend="array")

    want_outs, want_rep = eng.run(job())
    assert want_rep.speculated > 0
    sess = eng.session("f", record_size=REC, backend="array")
    for _ in range(3):
        outs, rep = sess.run(job())
        assert outs == want_outs
        assert _report_key(rep) == _report_key(want_rep)


def test_session_reports_agree_across_backends(tmp_path):
    """The planner-purity guarantee survives the session: a chained
    TeraSort run produces byte-identical outputs and identical scheduling
    reports on both backends."""
    results = {}
    for backend in ("bytes", "array"):
        sub = tmp_path / backend
        sub.mkdir()
        master, servers, client = make_cloud(sub, chunk_size=1000)
        data = _upload(client, "f", n=100, replication=3)
        sample = [data[i:i + REC] for i in range(0, 100 * REC, REC)]
        bounds = sample_boundaries(sample, 4, key_bytes=10)
        job = SphereJob("sort", "f", terasort_stages(bounds, backend, 4),
                        record_size=REC, backend=backend)
        sess = SphereEngine(master, client, device="cpu").session("f", record_size=REC,
                                                    backend=backend)
        sess.run(job)
        outs, rep = sess.run(job)  # second run: cached lookup/plan/chunks
        results[backend] = (outs, rep)
    assert results["bytes"][0] == results["array"][0]
    assert (_report_key(results["bytes"][1])
            == _report_key(results["array"][1]))


def test_session_invalidates_on_join_event(tmp_path):
    """A server-joined event auto-drops the cached lookup, placement and
    chunks: the next job re-derives them against the grown cluster — no
    manual refresh() call anywhere."""
    from repro_torch.sector import ChunkServer

    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    data = _upload(client, "f", n=30, replication=3)
    reads = []
    orig_read = client.read_chunk
    client.read_chunk = lambda *a, **k: reads.append(a) or orig_read(*a, **k)

    eng = SphereEngine(master, client, device="cpu")
    sess = eng.session("f", record_size=REC, backend="array")
    sess.run(_identity_job("array"))
    n_reads = len(reads)
    assert n_reads > 0
    sess.run(_identity_job("array"))
    assert len(reads) == n_reads        # all cached

    master.register(ChunkServer("late", "tokyo", tmp_path))  # join event
    assert len(sess._plan) == 0         # caches dropped by the event
    outs, rep = sess.run(_identity_job("array"))
    assert len(reads) == 2 * n_reads    # re-fetched after invalidation
    assert "late" in sess.workers
    want_outs, want_rep = eng.run(_identity_job("array"))
    assert outs == want_outs            # schedules like a fresh run
    assert _report_key(rep) == _report_key(want_rep)
    assert sorted(b"".join(outs)) == sorted(data)


def test_session_invalidates_on_death_event(tmp_path):
    """After a worker dies, the server-died event re-binds the session to
    the live worker set: it schedules exactly like a fresh engine.run on
    the shrunken cluster instead of planning onto the dead worker."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=60, replication=3)
    eng = SphereEngine(master, client, device="cpu")
    sess = eng.session("f", record_size=REC, backend="array")
    sess.run(_identity_job("array"))

    servers[1].kill()
    master.deregister(servers[1].server_id)  # death event -> auto-invalidate
    assert servers[1].server_id not in sess.workers
    outs, rep = sess.run(_identity_job("array"))
    want_outs, want_rep = eng.run(_identity_job("array"))
    assert outs == want_outs
    assert _report_key(rep) == _report_key(want_rep)


def test_session_refresh_is_deprecated_noop(tmp_path):
    """refresh() survives as a deprecated alias that warns and keeps the
    caches intact (invalidation is the event bus's job now)."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=20, replication=3)
    reads = []
    orig_read = client.read_chunk
    client.read_chunk = lambda *a, **k: reads.append(a) or orig_read(*a, **k)

    sess = SphereEngine(master, client, device="cpu").session("f", record_size=REC,
                                                backend="array")
    want, _ = sess.run(_identity_job("array"))
    n_reads = len(reads)
    with pytest.warns(DeprecationWarning, match="no-op"):
        sess.refresh()
    outs, _ = sess.run(_identity_job("array"))
    assert len(reads) == n_reads        # caches survived the no-op
    assert outs == want


def test_session_chunk_cache_survives_mutating_udf(tmp_path):
    """A bytes UDF that mutates its input list in place must not corrupt
    the session's chunk cache for later jobs in the chain."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    data = _upload(client, "f", n=30)

    def hostile_udf(records):
        out = list(records)
        records.sort()      # in-place mutation
        del records[1:]     # and truncation
        return out

    job = SphereJob("hostile", "f", [SphereStage("m", hostile_udf)],
                    record_size=REC, backend="bytes")
    sess = SphereEngine(master, client, device="cpu").session("f", record_size=REC,
                                                backend="bytes")
    want, _ = sess.run(job)
    assert sorted(b"".join(want)) == sorted(data)
    outs, _ = sess.run(job)  # served from cache: must be unchanged
    assert outs == want


def test_kmeans_session_traces_once_and_matches_rebuild(tmp_path):
    """k-means through one session: every stage UDF compiles exactly once
    across ALL iterations, and centroids match the re-plan/re-trace
    path.  The session leg drives the raw stage/params API so it can
    assert the strong form of trace-once — the per-stage wrapper objects
    themselves report one trace after five iterations — which the
    rebuild path cannot satisfy (it builds fresh wrappers per iteration,
    so its udf_traces == 1 is per-executor, not per-chain)."""
    import torch

    from repro_torch.core import SphereReport
    from repro_torch.core.kmeans import _fold_outputs, make_kmeans_stages

    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(c, 0.3, (200, 4))
                          for c in (np.zeros(4), np.full(4, 9.0))])
    res = {}

    def cloud(tag):
        sub = tmp_path / tag
        sub.mkdir()
        master, servers, client = make_cloud(sub, chunk_size=4096)
        client.upload("pts", encode_points(pts.astype(np.float32)),
                      replication=2)
        return SphereEngine(master, client, device="cpu")

    # rebuild baseline: fresh stages/planner/executor every iteration
    res[False], rep = kmeans_sphere(cloud("rebuild"), "pts", dim=4, k=2,
                                    iters=5, backend="array", session=False)
    assert rep.udf_traces == {"assign": 1, "fold": 1}

    # session leg: one stage pair, params updated per iteration
    eng = cloud("session")
    stages = make_kmeans_stages(4, 2, "array")
    job = SphereJob("kmeans", "pts", stages, record_size=16,
                    backend="array")
    sess = eng.session("pts", record_size=16, backend="array")
    centroids = np.random.default_rng(0).normal(size=(2, 4)) \
        .astype(np.float32)  # same init as kmeans_sphere(seed=0)
    rep = SphereReport()
    for _ in range(5):
        stages[0].params = torch.as_tensor(centroids)
        outs, rep = sess.run(job, rep)
        sums, counts = _fold_outputs(outs, 4, 2, "array")
        nz = counts > 0
        centroids[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    res[True] = centroids
    assert rep.udf_traces == {"assign": 1, "fold": 1}
    assert sess.jobs_run == 5
    # the same two wrapper objects served all five jobs, one trace each
    assert stages[0]._traced.traces == 1
    assert stages[1]._traced.traces == 1
    np.testing.assert_allclose(res[True], res[False], rtol=1e-4, atol=1e-4)


def test_kmeans_sphere_init_warm_start(tmp_path):
    """kmeans_sphere(init=...) overrides the seeded random init — the
    warm-start hook for chained window models: one iteration from a
    given model equals the numpy step from that model, and a mis-shaped
    init is rejected."""
    master, servers, client = make_cloud(tmp_path, chunk_size=4096)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(256, 4)).astype(np.float32)
    client.upload("pts", encode_points(pts), replication=2)
    eng = SphereEngine(master, client, device="cpu")

    init = np.array([[-1, -1, -1, -1], [1, 1, 1, 1]], np.float32)
    cents, _ = kmeans_sphere(eng, "pts", dim=4, k=2, iters=1,
                             backend="array", init=init)
    a = ((pts[:, None, :] - init[None]) ** 2).sum(-1).argmin(1)
    want = init.copy()
    for j in range(2):
        if (a == j).any():
            want[j] = pts[a == j].mean(0)
    np.testing.assert_allclose(cents, want, rtol=1e-4, atol=1e-4)

    with pytest.raises(ValueError, match="init shape"):
        kmeans_sphere(eng, "pts", dim=4, k=2, iters=1, backend="array",
                      init=np.zeros((3, 4), np.float32))


def test_unclosed_session_is_garbage_collected(tmp_path):
    """The event bus must not keep an unclosed session alive (the
    pre-stream idiom never called close()): dropping the last reference
    frees the session and its caches, and the dead subscription
    self-unsubscribes on the next event."""
    import gc
    import weakref

    from repro_torch.sector import ChunkServer

    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    _upload(client, "f", n=10)
    eng = SphereEngine(master, client, device="cpu")
    sess = eng.session("f", record_size=REC, backend="array")
    sess.run(_identity_job("array"))
    n_subs = len(master.events._subs)
    ref = weakref.ref(sess)
    del sess
    gc.collect()
    assert ref() is None                      # bus held no strong ref
    master.register(ChunkServer("late2", "tokyo", tmp_path))
    assert len(master.events._subs) < n_subs  # dead subs self-removed


@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_kmeans_session_converges(tmp_path, backend):
    master, servers, client = make_cloud(tmp_path, chunk_size=4096)
    rng = np.random.default_rng(0)
    true_c = np.array([[0, 0], [8, 8]], np.float32)
    pts = np.concatenate([rng.normal(c, 0.3, (150, 2)) for c in true_c]) \
        .astype(np.float32)
    client.upload("pts", encode_points(pts), replication=2)
    eng = SphereEngine(master, client, device="cpu")
    sess = eng.session("pts", record_size=8 if backend == "array" else 0,
                       backend=backend)
    cents, rep = kmeans_sphere(eng, "pts", dim=2, k=2, iters=6,
                               backend=backend, session=sess)
    cents = cents[np.argsort(cents[:, 0])]
    assert np.abs(cents - true_c).max() < 0.5
    assert sess.jobs_run == 6
