"""The port's Angle k-means chain (``repro_torch.core.kmeans``, the
``kmeans_assign`` kernel package and the record float views) against the
JAX package.

The same numpy inputs, made from seeds, go through both packages on the
CPU; the port's ``kmeans_assign`` takes its plain version there and is
held against the JAX ``kmeans_assign`` (Pallas in interpret mode) and its
oracle.  Tolerances, each with its reason:

* assignment ids: equal wherever the reference's gap between the best and
  the second-best d2 exceeds ``1e-5 * (|x|^2 + |c|^2)`` (float32 sums in
  another order can swap a nearer tie), and everywhere for duplicated
  centroids (the lowest index wins an exact tie);
* d2: ``rtol = atol = 1e-4`` for float32 inputs, ``5e-2`` for bfloat16
  (``tests/test_kernels.py``'s bounds);
* partial sums and counts: ``1e-5`` (the summation order differs); counts
  of ``kmeans_partials_ref`` exact, on inputs whose every id is decided;
* centroids through Sphere: ``1e-5`` on the array backend, equal on the
  bytes backend (the same numpy UDFs on the same records);
* record bytes, ``udf_traces`` and ``SphereReport`` fields: equal.

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.sector as jsector
import repro_torch.core as tcore
import repro_torch.sector as tsector
from repro.core import kmeans as jkm
from repro.core.records import RecordBatch as JBatch
from repro.kernels.kmeans_assign import kmeans_assign as j_assign
from repro.kernels.kmeans_assign import kmeans_assign_partials as j_partials
from repro.kernels.kmeans_assign import kmeans_assign_ref as j_assign_ref
from repro_torch.convert import (centroids_from_numpy, points_from_numpy,
                                 record_batch_from_numpy)
from repro_torch.core import kmeans as tkm
from repro_torch.core.records import RecordBatch
from repro_torch.kernels.kmeans_assign import (kernel as tkernel,
                                               kmeans_assign,
                                               kmeans_assign_partials,
                                               kmeans_partials,
                                               kmeans_partials_ref)

# report fields that are wall clock, or count each lowering's own
# device dispatches
_WALL_OR_LOWERING = {"partition_seconds", "device_dispatches"}


def _fields(rep, skip=_WALL_OR_LOWERING):
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
            if f.name not in skip}


def _inputs(N, D, K, dtype, seed):
    """(JAX x, JAX c, port x, port c, float32 numpy x, float32 numpy c):
    the same values in both packages (bfloat16 rounds alike in both)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    c = rng.normal(size=(K, D)).astype(np.float32)
    jx, jc = jnp.asarray(x, dtype), jnp.asarray(c, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = points_from_numpy(x, device="cpu").to(tdt)
    tc = centroids_from_numpy(c, device="cpu").to(tdt)
    x32 = np.array(jx.astype(jnp.float32))
    c32 = np.array(jc.astype(jnp.float32))
    np.testing.assert_array_equal(tx.float().numpy(), x32)
    np.testing.assert_array_equal(tc.float().numpy(), c32)
    return jx, jc, tx, tc, x32, c32


def _decided(x32, c32):
    """Points whose reference d2 has a best-to-second gap above the
    stated margin — the ones whose id must agree exactly."""
    xx = (x32 * x32).sum(1)
    cc = (c32 * c32).sum(1)
    d2 = xx[:, None] - 2 * x32 @ c32.T + cc[None]
    if d2.shape[1] < 2:
        return np.ones(d2.shape[0], bool)
    two = np.sort(d2, 1)[:, :2]
    best = d2.argmin(1)
    return two[:, 1] - two[:, 0] > 1e-5 * (xx + cc[best])


@pytest.mark.parametrize("N,D,K,bn", [(100, 8, 4, 32), (513, 16, 7, 128),
                                      (64, 32, 16, 64), (1, 1, 1, 8),
                                      (300, 8, 10, 1024)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kmeans_assign_matches_jax(N, D, K, bn, dtype):
    jx, jc, tx, tc, x32, c32 = _inputs(N, D, K, dtype, seed=N + K)
    ids, d2 = kmeans_assign(tx, tc, block_n=bn)
    assert ids.dtype == torch.int32 and d2.dtype == torch.float32
    j_ids, j_d2 = j_assign(jx, jc, block_n=bn, interpret=True)
    r_ids, r_d2 = j_assign_ref(jx, jc)
    ok = _decided(x32, c32)
    assert ok.mean() > 0.9
    tol = 5e-2 if dtype == jnp.bfloat16 else 1e-4
    for want_ids, want_d2 in ((j_ids, j_d2), (r_ids, r_d2)):
        np.testing.assert_array_equal(ids.numpy()[ok],
                                      np.asarray(want_ids)[ok])
        np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2),
                                   rtol=tol, atol=tol)


def test_kmeans_assign_duplicated_centroids_lowest_index_wins():
    jx, jc, tx, tc, x32, c32 = _inputs(400, 8, 6, jnp.float32, seed=3)
    dup = c32.copy()
    dup[4] = dup[1]
    dup[5] = dup[1]
    ids, d2 = kmeans_assign(torch.from_numpy(x32), torch.from_numpy(dup))
    j_ids, _ = j_assign(jnp.asarray(x32), jnp.asarray(dup), interpret=True)
    assert not np.isin(ids.numpy(), [4, 5]).any()
    assert (ids.numpy() == 1).any()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


def test_kmeans_assign_no_points():
    ids, d2 = kmeans_assign(torch.zeros((0, 8)), torch.ones((10, 8)))
    assert ids.shape == d2.shape == (0,)


@pytest.mark.parametrize("masked", [False, True])
def test_kmeans_assign_partials_match_jax(masked):
    jx, jc, tx, tc, x32, c32 = _inputs(700, 8, 10, jnp.float32, seed=9)
    valid = np.random.default_rng(10).random(700) < 0.8 if masked else None
    sums, counts = kmeans_assign_partials(
        tx, tc, None if valid is None else torch.from_numpy(valid))
    j_sums, j_counts = j_partials(
        jx, jc, None if valid is None else jnp.asarray(valid),
        use_kernel=False)
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(counts.numpy(), np.asarray(j_counts),
                               rtol=1e-5, atol=1e-5)
    assert counts.sum() == (700 if valid is None else valid.sum())
    # use_kernel picks the route by device: on the CPU both are the plain
    # version, so the partials are the same either way
    k_sums, _ = kmeans_assign_partials(tx, tc, use_kernel=True)
    p_sums, _ = kmeans_assign_partials(tx, tc, use_kernel=False)
    assert torch.equal(k_sums, p_sums)


@pytest.mark.parametrize("block_n", [1, 128, 1024])
def test_kmeans_assign_partials_accept_block_n(block_n):
    """A call written against the JAX package, ``block_n`` included, runs
    and gives the same partials as without it, the JAX function's too
    (its Pallas kernel in interpret mode at that block)."""
    jx, jc, tx, tc, x32, c32 = _inputs(300, 8, 10, jnp.float32, seed=5)
    valid = np.random.default_rng(6).random(300) < 0.8
    tv = torch.from_numpy(valid)
    sums, counts = kmeans_assign_partials(tx, tc, tv, block_n=block_n)
    want = kmeans_assign_partials(tx, tc, tv)
    assert torch.equal(sums, want[0]) and torch.equal(counts, want[1])
    for use_kernel in (True, False):
        got = kmeans_assign_partials(tx, tc, tv, block_n=block_n,
                                     use_kernel=use_kernel)
        assert torch.equal(got[0], sums) and torch.equal(got[1], counts)
    j_sums, j_counts = j_partials(jx, jc, jnp.asarray(valid),
                                  block_n=block_n, use_kernel=True)
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


def test_kmeans_assign_refuses_other_devices():
    x = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kmeans_assign(x, torch.zeros((3, 2), device="meta"))
    with pytest.raises(ValueError, match=r"x \[N, D\]"):
        kmeans_assign(torch.zeros((4, 2)), torch.zeros((3, 5)))
    before = tkernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.kmeans_assign_ids(torch.zeros((4, 2)), torch.zeros((3, 2)),
                                  bn=1024)
    assert tkernel.launches == before
    assert tkernel.shared_bytes(10, 8) == 4 * (10 * 8 + 10)


def test_kmeans_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.build(tmp_path / "build")
    assert not any((tmp_path / "build").rglob("*.so"))


@pytest.mark.parametrize("N,D,K,dtype,mask", [
    (700, 8, 10, jnp.float32, None), (700, 8, 10, jnp.float32, "random"),
    (1001, 8, 10, jnp.float32, "random"), (513, 16, 7, jnp.bfloat16, "random"),
    (300, 3, 5, jnp.bfloat16, None), (257, 4, 1, jnp.float32, "random"),
    (300, 8, 10, jnp.float32, "none")])
def test_kmeans_partials_ref_matches_jax(N, D, K, dtype, mask):
    """The plain fused partials ``[K, D + 1]`` against the JAX package's
    ``kmeans_assign_partials``, with its Pallas kernel in interpret mode
    (``block_n=128``: N = 1001 and 513 leave a ragged last block) and with
    its oracle: masked and unmasked, an all-false mask, K = 1, bfloat16
    points.  Every id is decided here, so counts agree exactly."""
    jx, jc, tx, tc, x32, c32 = _inputs(N, D, K, dtype, seed=N + 7 * K)
    assert _decided(x32, c32).all()
    valid = {None: None, "none": np.zeros(N, bool),
             "random": np.random.default_rng(N).random(N) < 0.7}[mask]
    tv = None if valid is None else torch.from_numpy(valid)
    jv = None if valid is None else jnp.asarray(valid)
    table = kmeans_partials_ref(tx, tc, tv)
    assert table.shape == (K, D + 1) and table.dtype == torch.float32
    assert torch.equal(kmeans_partials(tx, tc, tv), table)
    sums, counts = kmeans_assign_partials(tx, tc, tv)
    assert torch.equal(sums, table[:, :D]) and torch.equal(counts,
                                                           table[:, D])
    for use_kernel in (True, False):
        j_sums, j_counts = j_partials(jx, jc, jv, block_n=128,
                                      use_kernel=use_kernel)
        np.testing.assert_allclose(table[:, :D].numpy(), np.asarray(j_sums),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(table[:, D].numpy(),
                                      np.asarray(j_counts))
    n_valid = N if valid is None else int(valid.sum())
    assert float(table[:, D].sum()) == n_valid
    if mask == "none":
        assert not table.any()


def test_kmeans_partials_kernel_refuses_what_it_cannot_take():
    """The fused wrapper raises ``ValueError`` before any launch on CPU
    tensors, non-contiguous or mismatched inputs, a bad mask and a table
    over the shared memory."""
    x = torch.zeros((6, 4))
    c = torch.zeros((3, 4))
    before = tkernel.partials_launches
    bad = [((x, c, None), "CUDA tensors"),
           ((torch.zeros((4, 6)).T, c, None), "contiguous"),
           ((x, torch.zeros((3, 5)), None), "dimensions"),
           ((x.to(torch.float64), c, None), "float32 or bfloat16"),
           ((x, c.to(torch.bfloat16), None), "float32 tensor"),
           ((x, c, torch.ones(5, dtype=torch.bool)), "valid"),
           ((x, c, torch.ones(6, dtype=torch.uint8)), "valid"),
           ((x, c, torch.ones(12, dtype=torch.bool)[::2]), "valid"),
           ((torch.zeros((6, 227)), torch.zeros((256, 227)), None),
            "shared memory")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            tkernel.kmeans_partials(*args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kmeans_partials(x.to("meta"), c.to("meta"), use_kernel=True)
    assert tkernel.partials_launches == before


def test_kmeans_partials_build_without_nvcc_raises(tmp_path, monkeypatch):
    """The fused entry lives in the same source: without ``nvcc`` its
    library cannot be built or loaded, and nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.load_library(tmp_path / "build")
    assert not any((tmp_path / "build").rglob("*.so"))


def test_points_views_match_jax():
    """to_points / from_points reinterpret the same bytes as the JAX
    package, for exact, padding-resident and misaligned batches."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(37, 6)).astype(np.float32)
    raw = np.frombuffer(pts.tobytes(), np.uint8).reshape(37, 24)
    jb = JBatch(jnp.asarray(raw), n_valid=30)
    tb = record_batch_from_numpy(raw, n_valid=30, device="cpu")
    np.testing.assert_array_equal(tb.to_points(6).numpy(),
                                  np.asarray(jb.to_points(6)))
    np.testing.assert_array_equal(tb.to_points(6).numpy(), pts[:30])
    back = RecordBatch.from_points(torch.from_numpy(pts))
    j_back = JBatch.from_points(jnp.asarray(pts))
    assert back.to_bytes() == j_back.to_bytes() == pts.tobytes()
    # a slice whose storage starts off the 4-byte grid is copied, not viewed
    flat = torch.from_numpy(np.concatenate([[7], raw.reshape(-1)])
                            .astype(np.uint8))
    odd = RecordBatch(flat[1:].view(37, 24))
    assert odd.data.storage_offset() == 1
    np.testing.assert_array_equal(odd.to_points(6).numpy(), pts)
    with pytest.raises(ValueError, match="record_size"):
        tb.to_points(5)


@pytest.mark.parametrize("name", ["encode_points", "decode_points",
                                  "_encode_partial", "_decode_partial",
                                  "_partial_width", "_fold_outputs"])
def test_numpy_codecs_are_verbatim(name):
    """The record codecs are numpy on both sides and carried over as they
    are."""
    assert inspect.getsource(getattr(tkm, name)) == \
        inspect.getsource(getattr(jkm, name))


# ------------------------------------------------------------ Sphere chain
def _cloud(sector, tmp_path, tag, chunk_size=4096, n_servers=6):
    sub = tmp_path / tag
    sub.mkdir()
    master = sector.SectorMaster(chunk_size=chunk_size)
    sites = master.topology.sites
    for i in range(n_servers):
        master.register(sector.ChunkServer(f"s{i}", sites[i % len(sites)],
                                           sub))
    master.acl.add_member("alice")
    master.acl.grant_write("alice")
    return master, sector.SectorClient(master, "alice", "chicago")


def _engines(tmp_path, tag, blob, name="pts", **cloud_kw):
    """(JAX engine, port engine) over identical clouds holding ``blob``."""
    out = []
    for sector, core, kw in ((jsector, jcore, {}),
                             (tsector, tcore, {"device": "cpu"})):
        master, client = _cloud(sector, tmp_path, f"{tag}-{core.__name__}",
                                **cloud_kw)
        client.upload(name, blob, replication=2)
        out.append(core.SphereEngine(master, client, **kw))
    return out


def _clusters(seed=0, n=200, dim=4):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, 0.3, (n, dim))
                           for c in (np.zeros(dim), np.full(dim, 9.0))]) \
        .astype(np.float32)


@pytest.mark.parametrize("backend,session", [("array", True),
                                             ("array", False),
                                             ("bytes", True),
                                             ("bytes", False)])
def test_kmeans_sphere_matches_jax(tmp_path, backend, session):
    pts = _clusters()
    j_eng, t_eng = _engines(tmp_path, f"{backend}{session}",
                            tkm.encode_points(pts))
    secs = []
    cents, rep = tkm.kmeans_sphere(t_eng, "pts", dim=4, k=2, iters=5,
                                   backend=backend, session=session,
                                   iter_seconds=secs)
    j_cents, j_rep = jkm.kmeans_sphere(j_eng, "pts", dim=4, k=2, iters=5,
                                       backend=backend, session=session)
    if backend == "array":
        np.testing.assert_allclose(cents, j_cents, rtol=1e-5, atol=1e-5)
        assert rep.udf_traces == j_rep.udf_traces == {"assign": 1, "fold": 1}
    else:
        np.testing.assert_array_equal(cents, j_cents)
    assert _fields(rep) == _fields(j_rep)
    assert len(secs) == 5 and all(s > 0 for s in secs)
    assert rep.locality_fraction > 0.8


def test_kmeans_session_traces_once(tmp_path):
    """The raw stage/params API through one session: each stage wrapper
    runs at one block shape across all five iterations, with params a
    float32 tensor on the engine's device (``tests/test_session.py``)."""
    pts = _clusters()
    _, t_eng = _engines(tmp_path, "raw", tkm.encode_points(pts))
    stages = tkm.make_kmeans_stages(4, 2, "array")
    job = tcore.SphereJob("kmeans", "pts", stages, record_size=16,
                          backend="array")
    sess = t_eng.session("pts", record_size=16, backend="array")
    centroids = np.random.default_rng(0).normal(size=(2, 4)) \
        .astype(np.float32)
    rep = tcore.SphereReport()
    for _ in range(5):
        stages[0].params = torch.from_numpy(centroids.copy())
        outs, rep = sess.run(job, rep)
        sums, counts = tkm._fold_outputs(outs, 4, 2, "array")
        nz = counts > 0
        centroids[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    assert rep.udf_traces == {"assign": 1, "fold": 1}
    assert sess.jobs_run == 5
    assert stages[0]._traced.traces == 1 and stages[1]._traced.traces == 1
    want, _ = tkm.kmeans_sphere(t_eng, "pts", dim=4, k=2, iters=5,
                                backend="array", session=False)
    np.testing.assert_allclose(centroids, want, rtol=1e-5, atol=1e-5)


def test_kmeans_sphere_init_warm_start(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(256, 4)).astype(np.float32)
    j_eng, t_eng = _engines(tmp_path, "init", tkm.encode_points(pts))
    init = np.array([[-1, -1, -1, -1], [1, 1, 1, 1]], np.float32)
    cents, _ = tkm.kmeans_sphere(t_eng, "pts", dim=4, k=2, iters=1,
                                 backend="array", init=init)
    j_cents, _ = jkm.kmeans_sphere(j_eng, "pts", dim=4, k=2, iters=1,
                                   backend="array", init=init)
    np.testing.assert_allclose(cents, j_cents, rtol=1e-5, atol=1e-5)
    a = ((pts[:, None, :] - init[None]) ** 2).sum(-1).argmin(1)
    want = np.stack([pts[a == j].mean(0) for j in range(2)])
    np.testing.assert_allclose(cents, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="init shape"):
        tkm.kmeans_sphere(t_eng, "pts", dim=4, k=2, iters=1,
                          backend="array", init=np.zeros((3, 4), np.float32))


@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_kmeans_session_converges(tmp_path, backend):
    """``tests/test_session.py``'s convergence case through a session the
    caller owns."""
    rng = np.random.default_rng(0)
    true_c = np.array([[0, 0], [8, 8]], np.float32)
    pts = np.concatenate([rng.normal(c, 0.3, (150, 2)) for c in true_c]) \
        .astype(np.float32)
    j_eng, t_eng = _engines(tmp_path, backend, tkm.encode_points(pts))
    got = []
    for eng, km in ((t_eng, tkm), (j_eng, jkm)):
        sess = eng.session("pts", record_size=8 if backend == "array" else 0,
                           backend=backend)
        cents, rep = km.kmeans_sphere(eng, "pts", dim=2, k=2, iters=6,
                                      backend=backend, session=sess)
        assert sess.jobs_run == 6
        got.append((cents, rep))
    (cents, rep), (j_cents, j_rep) = got
    np.testing.assert_allclose(cents, j_cents, rtol=1e-5, atol=1e-5)
    assert _fields(rep) == _fields(j_rep)
    cents = cents[np.argsort(cents[:, 0])]
    assert np.abs(cents - true_c).max() < 0.5


# ------------------------------------------------------------- streaming
def _stream_run(eng, core, km, client, file_pts, dim, k, iters, win):
    stream = eng.stream("angle/w", window=core.WindowPolicy.sliding(win),
                        record_size=4 * dim, backend="array")
    skm = km.StreamingKMeans(stream, dim, k, iters=iters)
    models, deltas = [], []

    def on_window(s, idx, files):
        before = (skm.report.planned_tasks, skm.report.reused_tasks)
        models.append(skm.fit_window())
        deltas.append((skm.report.planned_tasks - before[0],
                       skm.report.reused_tasks - before[1]))

    stream.on_window(on_window)
    for i, pts in enumerate(file_pts):
        client.upload(f"angle/w{i:03d}", km.encode_points(pts),
                      replication=2)
    return skm, models, deltas


def test_streaming_kmeans_matches_jax(tmp_path):
    """``tests/test_stream.py``'s acceptance workload: 8 arriving files
    through a sliding window of 4, warm-started; per-window centroids,
    delta planning and trace-once match the JAX package."""
    DIM, K, ITERS, WIN, FILES = 4, 3, 3, 4, 8
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(K, DIM)) * 4
    file_pts = [np.concatenate([rng.normal(c, 0.3, size=(200, DIM))
                                for c in centers]).astype(np.float32)
                for _ in range(FILES)]
    runs = []
    for sector, core, km, kw in ((jsector, jcore, jkm, {}),
                                 (tsector, tcore, tkm, {"device": "cpu"})):
        master, client = _cloud(sector, tmp_path, core.__name__)
        eng = core.SphereEngine(master, client, **kw)
        runs.append(_stream_run(eng, core, km, client, file_pts, DIM, K,
                                ITERS, WIN))
    (j_skm, j_models, j_deltas), (skm, models, deltas) = runs
    assert len(models) == len(j_models) == FILES - WIN + 1
    for got, want in zip(models, j_models):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert deltas == j_deltas
    assert skm.report.udf_traces == {"assign": 1, "fold": 1}
    assert skm.stages[0]._traced.traces == 1
    assert skm.stages[1]._traced.traces == 1
    assert _fields(skm.report) == _fields(j_skm.report)


@pytest.mark.parametrize("backend", ["bytes", "array"])
def test_streaming_kmeans_backends_agree(tmp_path, backend):
    DIM, K = 2, 2
    master, client = _cloud(tsector, tmp_path, backend)
    eng = tcore.SphereEngine(master, client, device="cpu")
    stream = eng.stream("w/", window=tcore.WindowPolicy.sliding(2),
                        record_size=4 * DIM if backend == "array" else 0,
                        backend=backend)
    skm = tkm.StreamingKMeans(stream, DIM, K, iters=5)
    stream.on_window(lambda s, i, f: skm.fit_window())
    rng = np.random.default_rng(0)
    true_c = np.array([[0, 0], [8, 8]], np.float32)
    for i in range(4):
        pts = np.concatenate([rng.normal(c, 0.3, (128, DIM))
                              for c in true_c]).astype(np.float32)
        client.upload(f"w/{i}", tkm.encode_points(pts), replication=2)
    assert skm.windows_fit == 3
    cents = skm.centroids[np.argsort(skm.centroids[:, 0])]
    assert np.abs(cents - true_c).max() < 0.5


# ------------------------------------------------------ the Angle scenario
@pytest.mark.parametrize("backend", ["array", "bytes"])
def test_angle_scenario_alerts(tmp_path, backend):
    """``examples/angle_kmeans.py`` through the port: sensor windows 0-5
    are normal traffic, 6-7 carry an injected cluster, and the drift of
    each window's k-means model raises alerts at exactly [6, 7]."""
    sites = ["chicago", "greenbelt", "pasadena", "tokyo"]
    DIM, K, WINDOWS = 6, 4, 8
    master = tsector.SectorMaster(chunk_size=96 * 1024)
    for i, site in enumerate(sites * 2):
        master.register(tsector.ChunkServer(f"s{i}", site, tmp_path))
    master.acl.add_member("angle")
    master.acl.grant_write("angle")
    client = tsector.SectorClient(master, "angle", "chicago")
    rng = np.random.default_rng(0)
    normal_centers = rng.normal(size=(K, DIM)) * 3
    engine = tcore.SphereEngine(master, client, device="cpu")
    record_size = 4 * DIM if backend == "array" else 0
    models = []
    for w in range(WINDOWS):
        pts = np.concatenate([rng.normal(c, 0.4, size=(400, DIM))
                              for c in normal_centers])
        if w >= 6:
            pts = np.concatenate([pts, rng.normal(12.0, 0.2,
                                                  size=(150, DIM))])
        file = f"angle/window_{w:03d}.f32"
        client.upload(file, tkm.encode_points(pts.astype(np.float32)),
                      replication=2)
        session = engine.session(file, record_size=record_size,
                                 backend=backend)
        cents, rep = tkm.kmeans_sphere(engine, file, dim=DIM, k=K + 1,
                                       iters=6, seed=1, backend=backend,
                                       session=session)
        assert session.jobs_run == 6
        if backend == "array":
            assert rep.udf_traces == {"assign": 1, "fold": 1}
        models.append(cents)
    baseline = np.stack(models[:4]).mean(0)

    def drift(m):
        d = np.linalg.norm(m[:, None] - baseline[None], axis=-1)
        return 0.5 * (d.min(0).mean() + d.min(1).mean())

    scores = [drift(m) for m in models]
    thresh = np.mean(scores[:6]) + 4 * np.std(scores[:6])
    assert [w for w, s in enumerate(scores) if s > thresh] == [6, 7]


# ------------------------------------------------------ single-device step
def test_kmeans_step_matches_jax():
    pts = _clusters(seed=5, n=300, dim=3)
    c = np.random.default_rng(6).normal(size=(4, 3)).astype(np.float32) * 5
    new_c, inertia = tkm.kmeans_step(torch.from_numpy(pts),
                                     torch.from_numpy(c))
    j_new, j_inertia = jkm.kmeans_step_jax(jnp.asarray(pts), jnp.asarray(c))
    np.testing.assert_allclose(new_c.numpy(), np.asarray(j_new),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(inertia), float(j_inertia), rtol=1e-5)
    with pytest.raises(TypeError, match="Mesh"):
        tkm.kmeans_step(torch.from_numpy(pts), torch.from_numpy(c),
                        mesh=object())
