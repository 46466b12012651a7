"""Sphere Streams: windowed multi-file dataflow over the Sector event bus.

Covers the stream contract: window policies (tumbling / sliding /
count-based) over event-driven file arrivals, delta planning (a window
advance plans ONLY the new file's chunks — asserted on the
``SphereReport.planned_tasks`` / ``reused_tasks`` counters), chunk
decode-once across windows with exact retirement of expired files,
membership-event invalidation, and the acceptance workload: a
sliding-window warm-started streaming k-means over 8 arriving files with
``udf_traces == 1`` across the entire stream.

The reference's ``tests/test_stream.py`` run on the port
(``repro_torch``) on the CPU: the same cases, every engine built with
``device="cpu"`` and every cloud over the port's Sector."""
import numpy as np
import pytest

from repro_torch.core import (SphereEngine, SphereJob, SphereStage,
                              SphereStream, WindowPolicy)
from repro_torch.core.kmeans import StreamingKMeans, encode_points
from repro_torch.sector import ChunkServer


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


def _identity_job(backend, input_file="s/"):
    return SphereJob("id", input_file,
                     [SphereStage("id", lambda rs: list(rs),
                                  batch_udf=lambda b: b, pad_value=0xFF)],
                     record_size=REC, backend=backend)


# ----------------------------- window policies -------------------------------

def test_window_policy_shapes():
    files = [f"f{i}" for i in range(8)]

    tum = WindowPolicy.tumbling(3)
    assert [n for n in range(1, 9) if tum.fires(n)] == [3, 6]
    assert tum.window(files[:6]) == ("f3", "f4", "f5")

    sli = WindowPolicy.sliding(4)
    assert [n for n in range(1, 9) if sli.fires(n)] == [4, 5, 6, 7, 8]
    assert sli.window(files[:5]) == ("f1", "f2", "f3", "f4")

    sli2 = WindowPolicy.sliding(4, step=2)
    assert [n for n in range(1, 9) if sli2.fires(n)] == [4, 6, 8]

    cnt = WindowPolicy.count(2)
    assert [n for n in range(1, 6) if cnt.fires(n)] == [2, 4]
    assert cnt.window(files[:4]) == tuple(files[:4])  # landmark: all so far


def test_window_policy_validates():
    with pytest.raises(ValueError, match="kind"):
        WindowPolicy("hopping", 2, 1)
    with pytest.raises(ValueError, match="size"):
        WindowPolicy.sliding(0)
    with pytest.raises(ValueError, match="step"):
        WindowPolicy("sliding", 2, 0)


# --------------------------- window formation --------------------------------

@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_stream_windows_form_on_matching_uploads(tmp_path, backend):
    """file-created events matching the prefix advance the window; other
    uploads are invisible.  The window callback fires synchronously
    during the completing upload."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.sliding(2),
                        record_size=REC, backend=backend)
    seen = []
    stream.on_window(lambda s, idx, files: seen.append((idx, files)))

    _upload(client, "s/a", n=20)
    assert stream.windows_formed == 0 and seen == []
    _upload(client, "other/x", n=10)       # prefix mismatch: ignored
    _upload(client, "s/b", n=20)
    _upload(client, "s/c", n=20)
    assert stream._n_arrivals == 3
    assert stream.arrivals == ["s/b", "s/c"]  # trailing window extent only
    assert seen == [(0, ("s/a", "s/b")), (1, ("s/b", "s/c"))]
    assert stream.window_files == ("s/b", "s/c")


def test_stream_tumbling_and_count_windows(tmp_path):
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    tum = eng.stream("s/", window=WindowPolicy.tumbling(2),
                     record_size=REC, backend="array")
    cnt = eng.stream("s/", window=WindowPolicy.count(2),
                     record_size=REC, backend="array")
    tum_seen, cnt_seen = [], []
    tum.on_window(lambda s, i, f: tum_seen.append(f))
    cnt.on_window(lambda s, i, f: cnt_seen.append(f))
    for name in ("s/a", "s/b", "s/c", "s/d"):
        _upload(client, name, n=10)
    assert tum_seen == [("s/a", "s/b"), ("s/c", "s/d")]
    assert cnt_seen == [("s/a", "s/b"), ("s/a", "s/b", "s/c", "s/d")]


def test_stream_run_before_any_window_raises(tmp_path):
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    stream = SphereEngine(master, client, device="cpu").stream(
        "s/", window=WindowPolicy.sliding(2), record_size=REC,
        backend="array")
    with pytest.raises(RuntimeError, match="no window"):
        stream.run(_identity_job("array"))


# ----------------------------- delta planning --------------------------------

@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_stream_plans_only_the_delta(tmp_path, backend):
    """Window advance plans the new file's chunks ONLY: surviving files
    replay their cached group plans (reused_tasks), and the Sector
    master is looked up exactly once per file, ever."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    calls = []
    orig = master.lookup
    master.lookup = lambda *a, **k: calls.append(a) or orig(*a, **k)

    stream = eng.stream("s/", window=WindowPolicy.sliding(2),
                        record_size=REC, backend=backend)
    data_a = _upload(client, "s/a", n=20)   # 2 chunks
    data_b = _upload(client, "s/b", n=30)   # 3 chunks
    outs, rep = stream.run(_identity_job(backend))
    assert (rep.planned_tasks, rep.reused_tasks) == (5, 0)
    assert sorted(b"".join(outs)) == sorted(data_a + data_b)

    # same window again: everything replays, nothing re-plans
    _, rep2 = stream.run(_identity_job(backend))
    assert (rep2.planned_tasks, rep2.reused_tasks) == (0, 5)

    # new file: window (b, c) — only c's 4 chunks get planned
    data_c = _upload(client, "s/c", n=40)
    outs3, rep3 = stream.run(_identity_job(backend))
    assert (rep3.planned_tasks, rep3.reused_tasks) == (4, 3)
    assert sorted(b"".join(outs3)) == sorted(data_b + data_c)
    # the stream's metadata lookups (2-arg form; the client's per-read
    # lookups carry a site argument): exactly one per file, ever
    meta = [a[0] for a in calls if len(a) == 2]
    assert sorted(meta) == ["s/a", "s/b", "s/c"]


def test_stream_decodes_chunks_once_and_retires_expired(tmp_path):
    """Across the whole stream each chunk pays the Sector read + decode
    exactly once while it is windowed; expired files are evicted without
    touching the surviving files' cached (device-resident) chunks."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    reads = []
    orig = client.read_chunk
    client.read_chunk = lambda *a, **k: reads.append(a[0]) or orig(*a, **k)

    stream = eng.stream("s/", window=WindowPolicy.sliding(2),
                        record_size=REC, backend="array")
    _upload(client, "s/a", n=20)
    _upload(client, "s/b", n=30)
    stream.run(_identity_job("array"))
    assert len(reads) == 5
    stream.run(_identity_job("array"))
    assert len(reads) == 5                      # all cached

    b_chunks = {t.key for t in stream._file_tasks["s/b"]}
    b_cached = {k: stream.executor._chunk_cache[k] for k in b_chunks}
    _upload(client, "s/c", n=40)                # a expires, c enters
    assert set(stream.executor._chunk_cache) == b_chunks  # a evicted
    stream.run(_identity_job("array"))
    assert len(reads) == 5 + 4                  # only c's chunks read
    for k, batch in b_cached.items():
        assert stream.executor._chunk_cache[k] is batch  # untouched


def test_stream_matches_rebuild_per_window(tmp_path):
    """The delta-planned stream produces the same outputs and the same
    scheduling counters as a cold rebuild over the same window files —
    caching changes cost, never results."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.sliding(2),
                        record_size=REC, backend="array")
    _upload(client, "s/seed", n=20)
    for i, n in enumerate((20, 30, 40)):
        _upload(client, f"s/{i}", n=n)
        outs, rep = stream.run(_identity_job("array"))
        rebuild = SphereStream(eng, files=stream.window_files,
                               record_size=REC, backend="array")
        want_outs, want_rep = rebuild.run(_identity_job("array",
                                                        input_file=""))
        rebuild.close()
        assert outs == want_outs
        assert rep.stage_seconds[-1] == pytest.approx(
            want_rep.stage_seconds[-1])
        assert (rep.bytes_local, rep.bytes_moved) == \
            (want_rep.bytes_local, want_rep.bytes_moved)


# ------------------------------- chaining ------------------------------------

def test_stream_chained_state_is_per_window(tmp_path):
    """input='chained' consumes the previous job's partitions within a
    window; a window advance drops them (they mix expired data)."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.sliding(2),
                        record_size=REC, backend="array")
    a = _upload(client, "s/a", n=20)
    b = _upload(client, "s/b", n=20)
    stream.run(_identity_job("array"))
    outs, _ = stream.run(_identity_job("array"), input="chained")
    assert sorted(b"".join(outs)) == sorted(a + b)

    _upload(client, "s/c", n=20)    # window advances -> chained state gone
    with pytest.raises(RuntimeError, match="chain"):
        stream.run(_identity_job("array"), input="chained")


def test_stream_validates_jobs(tmp_path):
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    stream = SphereEngine(master, client, device="cpu").stream(
        "s/", window=WindowPolicy.sliding(1), record_size=REC,
        backend="array")
    _upload(client, "s/a", n=10)
    with pytest.raises(ValueError, match="backend"):
        stream.run(SphereJob("j", "s/", [SphereStage("id", lambda rs: rs)],
                             record_size=REC, backend="bytes"))
    with pytest.raises(ValueError, match="stream"):
        stream.run(_identity_job("array", input_file="t/"))


# --------------------------- membership events -------------------------------

def test_stream_invalidates_on_membership_change(tmp_path):
    """A server joining (or dying) drops every cached lookup/plan/chunk:
    the next run re-plans the whole window against the new cluster and
    still produces correct output."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.sliding(2),
                        record_size=REC, backend="array")
    a = _upload(client, "s/a", n=20, replication=3)
    b = _upload(client, "s/b", n=30, replication=3)
    stream.run(_identity_job("array"))
    assert len(stream._plan) == 2

    master.register(ChunkServer("late", "daejeon", tmp_path))
    assert len(stream._plan) == 0 and not stream._file_tasks
    outs, rep = stream.run(_identity_job("array"))
    assert (rep.planned_tasks, rep.reused_tasks) == (5, 0)  # full re-plan
    assert "late" in stream.workers
    assert sorted(b"".join(outs)) == sorted(a + b)

    servers[0].kill()
    master.deregister(servers[0].server_id)
    outs2, _ = stream.run(_identity_job("array"))
    assert servers[0].server_id not in stream.workers
    assert sorted(b"".join(outs2)) == sorted(a + b)


def test_last_worker_death_defers_bind_error_to_next_run(tmp_path):
    """Losing the LAST live worker must not blow up the master's failure
    sweep from inside the subscriber callback — the 'no live workers'
    error surfaces at the next run() instead, and a later join heals
    the stream."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000,
                                         n_servers=2)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.sliding(1),
                        record_size=REC, backend="array")
    _upload(client, "s/a", n=10, replication=2)
    stream.run(_identity_job("array"))

    for s in servers:
        s.kill()
        master.deregister(s.server_id)   # must not raise, even for the last
    with pytest.raises(RuntimeError, match="no live workers"):
        stream.run(_identity_job("array"))

    servers[0].revive()
    master.register(servers[0], now=1.0)  # join event re-opens the stream
    data = _upload(client, "s/b", n=10, replication=1)  # fresh window file
    outs, _ = stream.run(_identity_job("array"))
    assert sorted(b"".join(outs)) == sorted(data)


def test_closed_stream_stops_reacting(tmp_path):
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.sliding(1),
                        record_size=REC, backend="array")
    data = _upload(client, "s/a", n=10)
    outs, _ = stream.run(_identity_job("array"))
    stream.close()
    _upload(client, "s/b", n=10)                      # not observed
    assert stream.arrivals == ["s/a"]
    assert len(stream._plan) == 1                     # caches survive close
    assert sorted(b"".join(outs)) == sorted(data)


# --------------------------- streaming k-means -------------------------------

def _np_kmeans_windows(window_pts, k, iters, seed):
    """Numpy mirror of StreamingKMeans: warm-started window chain."""
    dim = window_pts[0].shape[1]
    c = np.random.default_rng(seed).normal(size=(k, dim)).astype(np.float32)
    models = []
    for pts in window_pts:
        for _ in range(iters):
            d2 = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
            a = d2.argmin(1)
            sums = np.zeros((k, dim))
            counts = np.zeros(k)
            np.add.at(sums, a, pts)
            np.add.at(counts, a, 1)
            nz = counts > 0
            c[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
        models.append(c.copy())
    return models


def test_streaming_kmeans_acceptance(tmp_path):
    """The acceptance workload: >= 8 arriving files through a
    sliding-window warm-started streaming k-means.  Every stage traces
    exactly once across ALL windows and iterations, per-window planning
    covers only the delta chunks, and each window's centroids match the
    numpy warm-start chain."""
    DIM, K, ITERS, WIN, FILES = 4, 3, 3, 4, 8
    # chunk = 4096 B = 256 records of 16 B; every file spans 3 chunks
    master, servers, client = make_cloud(tmp_path, chunk_size=4096)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("angle/w", window=WindowPolicy.sliding(WIN),
                        record_size=4 * DIM, backend="array")
    skm = StreamingKMeans(stream, DIM, K, iters=ITERS)

    rng = np.random.default_rng(7)
    centers = rng.normal(size=(K, DIM)) * 4
    file_pts, models, deltas = [], [], []

    def on_window(s, idx, files):
        before = (skm.report.planned_tasks, skm.report.reused_tasks)
        models.append(skm.fit_window())
        after = (skm.report.planned_tasks, skm.report.reused_tasks)
        deltas.append((after[0] - before[0], after[1] - before[1]))

    stream.on_window(on_window)
    for i in range(FILES):
        pts = np.concatenate(
            [rng.normal(c, 0.3, size=(200, DIM)) for c in centers]
        ).astype(np.float32)
        file_pts.append(pts)
        client.upload(f"angle/w{i:03d}", encode_points(pts), replication=2)

    n_windows = FILES - WIN + 1
    assert stream.windows_formed == n_windows == len(models)
    chunks_per_file = -(-200 * K * 4 * DIM // 4096)  # ceil
    assert chunks_per_file == 3

    # trace-once across the ENTIRE stream (all windows, all iterations)
    assert skm.report.udf_traces == {"assign": 1, "fold": 1}
    assert skm.stages[0]._traced.traces == 1
    assert skm.stages[1]._traced.traces == 1

    # delta planning: window 0 plans all 4 files; every later window
    # plans exactly the one new file's chunks, replaying the rest —
    # iterations after the first within a window reuse everything
    w = WIN * chunks_per_file
    assert deltas[0] == (w, (ITERS - 1) * w)
    for d in deltas[1:]:
        assert d == (chunks_per_file, (ITERS - 1) * w + (WIN - 1)
                     * chunks_per_file)

    # model correctness: the warm-started chain equals the numpy mirror
    window_pts = [np.concatenate(file_pts[i:i + WIN])
                  for i in range(n_windows)]
    want = _np_kmeans_windows(window_pts, K, ITERS, seed=0)
    for got, ref in zip(models, want):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_streaming_kmeans_backends_agree(tmp_path, backend):
    """Both record backends converge the streaming chain to the true
    cluster centers."""
    DIM, K = 2, 2
    master, servers, client = make_cloud(tmp_path, chunk_size=4096)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("w/", window=WindowPolicy.sliding(2),
                        record_size=4 * DIM if backend == "array" else 0,
                        backend=backend)
    skm = StreamingKMeans(stream, DIM, K, iters=5)
    stream.on_window(lambda s, i, f: skm.fit_window())

    rng = np.random.default_rng(0)
    true_c = np.array([[0, 0], [8, 8]], np.float32)
    for i in range(4):
        pts = np.concatenate([rng.normal(c, 0.3, (128, DIM))
                              for c in true_c]).astype(np.float32)
        client.upload(f"w/{i}", encode_points(pts), replication=2)

    assert skm.windows_fit == 3
    cents = skm.centroids[np.argsort(skm.centroids[:, 0])]
    assert np.abs(cents - true_c).max() < 0.5


# ----------------------------- timed windows ---------------------------------

def test_timed_policy_validates():
    with pytest.raises(ValueError, match="span_s"):
        WindowPolicy.timed(0.0)
    with pytest.raises(ValueError, match="grace_s"):
        WindowPolicy.timed(10.0, grace_s=-1.0)
    assert WindowPolicy.timed(10.0).fires(99) is False  # watermark-driven


def test_timed_windows_bucket_by_event_time(tmp_path):
    """Files land in event-time buckets; a bucket fires when the
    watermark passes its end, and empty spans form no window."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.timed(10.0),
                        record_size=REC)
    seen = []
    stream.on_window(lambda s, idx, files: seen.append((idx, files)))

    _upload_at(client, "s/a", at=5.0)        # bucket 0
    assert seen == []                        # watermark 5 < bucket end 10
    _upload_at(client, "s/b", at=20.0)       # bucket 2; watermark 20
    # bucket 0 fires with [a]; EMPTY bucket 1 is skipped, not a window
    assert seen == [(0, ("s/a",))]
    _upload_at(client, "s/c", at=35.0)       # bucket 3; watermark 35
    assert seen == [(0, ("s/a",)), (1, ("s/b",))]
    assert stream.windows_formed == 2
    stream.close()


def test_timed_grace_saves_in_grace_straggler(tmp_path):
    """The watermark trails the max event time by ``grace_s``, so a
    straggler landing inside the grace period still joins its bucket."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.timed(10.0, grace_s=5.0),
                        record_size=REC)
    seen = []
    stream.on_window(lambda s, idx, files: seen.append(files))

    _upload_at(client, "s/a", at=12.0)       # bucket 1; watermark 7
    _upload_at(client, "s/late", at=9.0)     # bucket 0 — saved by grace
    assert seen == [] and stream.late_dropped == 0
    _upload_at(client, "s/b", at=16.0)       # watermark 11: bucket 0 fires
    assert seen == [("s/late",)]
    stream.close()


def test_timed_late_file_dropped_and_counted(tmp_path):
    """A file whose bucket already fired is dropped loudly: counted in
    ``late_dropped``, never a member of any window."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.timed(10.0),
                        record_size=REC)
    seen = []
    stream.on_window(lambda s, idx, files: seen.append(files))

    _upload_at(client, "s/a", at=5.0)
    _upload_at(client, "s/b", at=25.0)       # fires bucket 0
    assert seen == [("s/a",)]
    _upload_at(client, "s/tardy", at=3.0)    # bucket 0 already gone
    assert stream.late_dropped == 1
    stream.advance_watermark(100.0)          # flush everything pending
    assert all("s/tardy" not in files for files in seen)
    stream.close()


def test_advance_watermark_flushes_and_validates(tmp_path):
    """``advance_watermark`` drives the watermark without a new arrival
    (end-of-stream flush); count-based streams reject it."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.timed(10.0, grace_s=5.0),
                        record_size=REC)
    seen = []
    stream.on_window(lambda s, idx, files: seen.append(files))
    _upload_at(client, "s/a", at=2.0)
    _upload_at(client, "s/b", at=4.0)
    assert seen == []
    stream.advance_watermark(50.0)
    assert seen == [("s/a", "s/b")]
    # moving time backwards is a no-op, not a rewind
    stream.advance_watermark(1.0)
    assert stream.watermark == pytest.approx(45.0)
    stream.close()

    counted = eng.stream("s/", window=WindowPolicy.sliding(2),
                         record_size=REC)
    with pytest.raises(ValueError, match="timed"):
        counted.advance_watermark(10.0)
    counted.close()


def test_timed_window_runs_jobs(tmp_path):
    """A timed window is a full SphereStream window: jobs run against
    exactly the files the watermark admitted."""
    master, servers, client = make_cloud(tmp_path, chunk_size=1000)
    eng = SphereEngine(master, client, device="cpu")
    stream = eng.stream("s/", window=WindowPolicy.timed(10.0),
                        record_size=REC, backend="bytes")
    data = {}
    data["s/a"] = _upload_at(client, "s/a", at=1.0)
    data["s/b"] = _upload_at(client, "s/b", at=8.0)
    stream.advance_watermark(30.0)
    assert stream.window_files == ("s/a", "s/b")
    out, rep = stream.run(_identity_job("bytes"))
    assert b"".join(out) and sum(len(b) for b in out) == \
        sum(len(d) for d in data.values())
    stream.close()


def _upload_at(client, name, at, n=20, seed=None):
    rng = np.random.default_rng(abs(hash(name)) % 2**32 if seed is None
                                else seed)
    data = rng.bytes(n * REC)
    client.upload(name, data, replication=2, at=at)
    return data
