"""The port's CUDA kernels on the card against their plain PyTorch
versions — ``bucket_dest``, ``bucket_partition`` (its words and rows
entries), ``kmeans_assign``,
``flash_attention`` and ``rg_lru_scan`` — and the paths built on them
(TeraSort through ``SphereEngine``, ``partition_batch`` /
``shuffle_batch``, k-means through ``kmeans_sphere``, LM prefill, decode,
``ServeEngine`` and a training step) against the same calls on the CPU;
the two LM kernels' gradients against autograd through their plain
versions on the card.

Every test here needs a CUDA device and skips itself without one (the
check runs inside the ``cuda`` fixture, never at import).  The module
imports neither JAX nor ``tests/conftest.py``'s helpers, so on a machine
with a card and no JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: exact equality for integer and byte data.  ``kmeans_assign``:
ids equal wherever the plain version's best-to-second d2 gap exceeds
``1e-5 * (|x|^2 + |c|^2)``, d2 within ``1e-5 * (|x|^2 + |c|^2) + 1e-6``
(float32 sums in another order), with float32 matrix products in full
precision (no TF32); its fused partials: counts exactly the masked
``bincount`` of the ids kernel's ids, sums within ``1e-5 * sum |x| +
1e-6`` of float64 one-hot sums over those ids (float32 sums in a fixed
order), the same bits from launch to launch; k-means centroids within
``1e-5``.
``flash_attention``: within 2e-5 in float32 and 2e-2 in bfloat16 of the
plain version (sums in another order; the bf16 kernel rounds p to bf16
before the product with V, the plain version keeps it in float32; the
bf16 output rounds once); in bfloat16 also within what rounding p allows
of ``chip_smoke.attention_rounded_p``, which rounds p as the kernel does
(``chip_smoke.rounded_p_excess``, plus 1e-4), and, where a row's keys lie
in one kv tile, within rtol 2**-8 (the output's rounding), atol 1e-3.
``rg_lru_scan``: exact (the kernel multiplies and adds with separate
roundings, as the plain loop does); its gradient within 1e-5 of the
gradients' scale of autograd through the loop, the flash gradient within
1e-5 (float32) / 1e-2 (bf16) of autograd through the plain version, and
a training step's loss within rtol 1e-5 and gradients within 1e-4 of
each leaf's scale of the CPU's.  LM prefill / decode logits on the
card within 1e-4 of the logits' scale of the CPU run in float32, and
greedy ``ServeEngine`` tokens identical.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.sector as tsector
from repro_torch.core import kmeans as tkm
from repro_torch.core import shuffle as tsh
from repro_torch.core.records import RecordBatch
from repro_torch.kernels.bucket_partition import (bucket_blocks_ref,
                                                  bucket_partition,
                                                  bucket_partition_ref,
                                                  bucket_partition_rows,
                                                  bucket_partition_rows_ref,
                                                  bucket_scatter)
from repro_torch.kernels.bucket_partition import kernel as tkernel
from repro_torch.kernels.kmeans_assign import kernel as kkernel
from repro_torch.kernels.kmeans_assign import (kmeans_assign_partials,
                                               kmeans_assign_ref,
                                               kmeans_partials)
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.rg_lru_scan import kernel as lkernel
from repro_torch.kernels.rg_lru_scan import lru_scan_ref
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.serve import SamplerConfig, ServeEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.requires_cuda
REC = 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _case(s, n, k, n_out, high, seed):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, high, (s, n, k), generator=g, dtype=torch.int64)
    bounds = torch.randint(0, high, (n_out - 1, k), generator=g,
                           dtype=torch.int64)
    counts = torch.randint(0, n + 1, (s,), generator=g, dtype=torch.int32)
    mask = (torch.rand((s, n), generator=g) < 0.7).to(torch.int32)
    return keys, bounds, counts, mask


@pytest.mark.parametrize("s,n,k,n_out,high,bn", [
    (3, 1000, 3, 5, 4, 64), (2, 777, 1, 2, 3, 101), (4, 50000, 4, 64, 5, 2048),
    (2, 3000, 3, 1000, 3, 257), (2, 70000, 3, 6, 2 ** 32, 2048)])
@pytest.mark.parametrize("validity", ["counts", "mask"])
def test_cuda_kernel_matches_plain(cuda, s, n, k, n_out, high, bn, validity):
    keys, bounds, counts, mask = (t.to(cuda) for t in
                                  _case(s, n, k, n_out, high, seed=n))
    before = tkernel.launches
    if validity == "counts":
        got = tkernel.bucket_dest_blocks(keys, bounds, counts, None,
                                         n_out=n_out, bn=bn)
        valid = torch.arange(n, device=cuda) < counts[:, None]
    else:
        got = tkernel.bucket_dest_blocks(keys, bounds, None, mask,
                                         n_out=n_out, bn=bn)
        valid = mask != 0
    torch.cuda.synchronize()
    assert tkernel.launches == before + 1
    want = bucket_blocks_ref(keys, bounds, valid, n_out, bn)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_kernel_refuses_what_it_cannot_take(cuda):
    keys, bounds, counts, _ = (t.to(cuda) for t in
                               _case(1, 64, 3, 1024, 4, seed=0))
    with pytest.raises(ValueError, match="n_out"):
        tkernel.bucket_dest_blocks(keys, bounds, counts, None, n_out=1024,
                                   bn=64)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.cat([keys, keys], dim=2)[..., :3]
        tkernel.bucket_dest_blocks(strided, bounds, counts, None, n_out=6,
                                   bn=64)


def test_cuda_scatter_matches_cpu(cuda):
    """bucket_scatter on the card equals the plain route on the CPU."""
    keys, bounds, _, _ = _case(1, 5000, 3, 7, 4, seed=1)
    bounds = bounds[torch.from_numpy(np.lexsort(bounds.numpy().T[::-1]))]
    data = torch.randint(0, 256, (5000, 8), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    args = (data, keys[0], bounds, 4321)
    out, hist = bucket_scatter(*args, n_buckets=7)
    c_out, c_hist = bucket_scatter(*(a.to(cuda) if torch.is_tensor(a) else a
                                     for a in args), n_buckets=7)
    assert torch.equal(c_out.cpu(), out) and torch.equal(c_hist.cpu(), hist)


def _terasort(tmp_path, data, device):
    master = tsector.SectorMaster(chunk_size=300 * REC)
    for i, site in enumerate(master.topology.sites):
        master.register(tsector.ChunkServer(f"s{i}", site, tmp_path))
    master.acl.add_member("alice")
    master.acl.grant_write("alice")
    client = tsector.SectorClient(master, "alice", "chicago")
    client.upload("f", data, replication=3)
    sample = [data[i:i + REC] for i in range(0, 500 * REC, REC)]
    job = tcore.SphereJob("sort", "f", tsh.terasort_stages(
        tsh.sample_boundaries(sample, 6), "array", 6), record_size=REC,
        backend="array")
    return tcore.SphereEngine(master, client, pad_block=64,
                              device=device).run(job)


def test_cuda_terasort_through_kernel(cuda, tmp_path):
    data = np.random.default_rng(4).bytes(3000 * REC)
    (tmp_path / "cpu").mkdir()
    (tmp_path / "cuda").mkdir()
    cpu_outs, cpu_rep = _terasort(tmp_path / "cpu", data, "cpu")
    before = tkernel.launches
    outs, rep = _terasort(tmp_path / "cuda", data, cuda)
    assert outs == cpu_outs
    assert tkernel.launches - before == rep.shuffle_rounds == rep.host_syncs
    assert rep.sim_seconds == cpu_rep.sim_seconds


@pytest.mark.parametrize("n,k,nb,high,bn", [
    (1000, 1, 2, 4, 64), (1000, 3, 6, 4, 101), (5000, 4, 16, 4, 2048),
    (70001, 3, 6, 2 ** 32, 2048), (3000, 3, 64, 3, 257), (1, 2, 3, 4, 1)])
def test_cuda_partition_kernel_matches_plain(cuda, n, k, nb, high, bn):
    g = torch.Generator().manual_seed(n + nb)
    keys = torch.randint(0, high, (n, k), generator=g, dtype=torch.int64)
    bounds = torch.randint(0, high, (nb - 1, k), generator=g,
                           dtype=torch.int64)
    want = bucket_partition_ref(keys, bounds, nb)
    before = tkernel.partition_launches
    got = bucket_partition(keys.to(cuda), bounds.to(cuda), n_buckets=nb,
                           block_n=bn)
    torch.cuda.synchronize()
    assert tkernel.partition_launches == before + 1
    for g_, w in zip(got, want):
        assert torch.equal(g_.cpu(), w)


def test_cuda_partition_kernel_overflow_ids(cuda):
    """At the kernel's own level: more boundary rows than buckets leave
    ids unclamped and count the overflow in no bin."""
    keys = torch.arange(0, 400, 5, dtype=torch.int64)[:, None]
    bounds = torch.tensor([[10], [20], [30], [250]], dtype=torch.int64)
    got = tkernel.bucket_partition_ids(keys.to(cuda), bounds.to(cuda),
                                       n_buckets=2, bn=32)
    want = bucket_partition_ref(keys, bounds, 2)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert int(want[0].max()) == 4 and int(want[1].sum()) == 5


ROW_SPECS = [("range", 4, 1, None), ("range", 4, 1, 4), ("range", 8, 2, None),
             ("range", 10, 3, None), ("range", 10, 3, 10),
             ("range", 6, 3, None), ("range", 16, 4, 16),
             ("range", 20, 5, None), ("range", 12, 3, 12),
             ("hash", 4), ("hash", 8), ("hash", 10)]


def _rows_case(n, width, offset, spec, nb, seed, high=2):
    """(flat bytes, records [n, width] viewed at ``offset`` into them,
    boundary rows): low-entropy bytes, and ``nb - 1`` boundaries taken from
    the records' own keys (uniform hash bounds for a hash spec)."""
    from repro_torch.core.records import extract_keys, uniform_hash_bounds
    g = torch.Generator().manual_seed(seed)
    flat = torch.randint(0, high, (n * width + offset,), generator=g,
                         dtype=torch.uint8)
    host = flat[offset:].view(n, width)
    if spec[0] == "hash":
        bounds = torch.from_numpy(
            uniform_hash_bounds(nb).astype(np.int64))[:, None]
    else:
        keys = extract_keys(host, spec)
        if n == 0:
            keys = torch.zeros((1, tkernel.key_layout(spec, width)[3]),
                               dtype=torch.int64)
        pick = keys[torch.randint(0, len(keys), (nb - 1,), generator=g)]
        bounds = pick[torch.from_numpy(np.lexsort(pick.numpy().T[::-1]))]
    return flat, host, bounds


@pytest.mark.parametrize("spec", ROW_SPECS, ids=str)
@pytest.mark.parametrize("width,offset", [(100, 0), (100, 1), (13, 0),
                                          (7, 0)])
def test_cuda_partition_rows_match_plain(cuda, spec, width, offset):
    """The rows entry over every key layout, 4-byte and byte loads (an odd
    width, a storage offset that is not 4-aligned), N = 0, 1 and a ragged
    N, exactly against its plain version."""
    for n in (0, 1, 3001):
        for nb in (2, 6, 16):
            flat, host, bounds = _rows_case(n, width, offset, spec, nb,
                                            seed=n + nb + width + offset)
            data = flat.to(cuda)[offset:].view(n, width)
            assert data.storage_offset() == offset
            before = tkernel.rows_launches
            got = tkernel.bucket_partition_rows(data, spec, bounds.to(cuda),
                                                n_buckets=nb)
            torch.cuda.synchronize()
            assert tkernel.rows_launches == before + (n > 0)
            want = bucket_partition_rows_ref(host, spec, bounds, nb)
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("bn", [None, 1, 7, 256, 100_000])
def test_cuda_partition_rows_block_cap(cuda, bn):
    """Any cap on the thread blocks gives the same ids, on full-range
    bytes and a ragged N, through the entry point as on the CPU."""
    spec = ("range", 10, 3, None)
    flat, host, bounds = _rows_case(70_001, REC, 0, spec, 6, seed=8,
                                    high=256)
    want = bucket_partition_rows(host, spec, bounds, n_buckets=6)
    got = bucket_partition_rows(host.to(cuda), spec, bounds.to(cuda),
                                n_buckets=6, block_n=bn)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_cuda_partition_rows_refuses_what_it_cannot_take(cuda):
    spec = ("range", 10, 3, None)
    data = torch.zeros((64, REC), dtype=torch.uint8, device=cuda)
    bounds = torch.zeros((5, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.bucket_partition_rows(data[:, ::2], spec, bounds,
                                      n_buckets=6)
    with pytest.raises(ValueError, match="words per row"):
        tkernel.bucket_partition_rows(data, ("range", 10, 3, 10), bounds,
                                      n_buckets=6)
    with pytest.raises(ValueError, match="shared memory"):
        tkernel.bucket_partition_rows(
            data, spec, torch.zeros((20_000, 3), dtype=torch.int64,
                                    device=cuda), n_buckets=6)


def test_cuda_partition_batch_matches_cpu(cuda):
    data = np.random.default_rng(6).bytes(4000 * REC)
    records = [data[i:i + REC] for i in range(0, len(data), REC)]
    part = tsh.range_partitioner(tsh.sample_boundaries(records[:500], 6))
    cpu = RecordBatch.from_bytes(data, REC, device="cpu")
    dev = RecordBatch.from_bytes(data, REC, device=cuda)
    ids, hist = tsh.partition_batch(cpu, part, 6)
    before = (tkernel.rows_launches, tkernel.partition_launches)
    c_ids, c_hist = tsh.partition_batch(dev, part, 6)
    pieces = tsh.shuffle_batch(dev, part, 6)
    assert (tkernel.rows_launches, tkernel.partition_launches) == \
        (before[0] + 2, before[1])
    assert c_ids.device.type == "cuda"
    assert torch.equal(c_ids.cpu(), ids) and torch.equal(c_hist.cpu(), hist)
    assert [p.to_bytes() for p in pieces] == \
        [p.to_bytes() for p in tsh.shuffle_batch(cpu, part, 6)]


def test_cuda_hash_partition_batch_matches_cpu(cuda):
    """The hash partitioner's route: one rows launch, no key rows, the
    CPU's ids; records at an odd width take the byte loads."""
    for width in (REC, 13):
        data = np.random.default_rng(width).bytes(5000 * width)
        part = tsh.hash_partitioner(10)
        ids, hist = tsh.partition_batch(
            RecordBatch.from_bytes(data, width, device="cpu"), part, 7)
        before = (tkernel.rows_launches, tkernel.partition_launches)
        c_ids, c_hist = tsh.partition_batch(
            RecordBatch.from_bytes(data, width, device=cuda), part, 7)
        assert (tkernel.rows_launches, tkernel.partition_launches) == \
            (before[0] + 1, before[1])
        assert torch.equal(c_ids.cpu(), ids)
        assert torch.equal(c_hist.cpu(), hist)


def _assign_case(n, d, k, dtype, seed, dup=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g).to(dtype)
    c = torch.randn((k, d), generator=g)
    if dup and k > 2:
        c[k - 1] = c[1]
    return x, c


def _check_assign(x, c, got, cuda):
    """ids exact where the plain version's top-two gap clears the margin,
    d2 within the stated tolerance — all against the plain version on the
    card."""
    xg, cg = x.to(cuda), c.to(cuda)
    want_ids, want_d2 = kmeans_assign_ref(xg, cg)
    x32, c32 = xg.float(), cg.float()
    xx = (x32 * x32).sum(1)
    cc = (c32 * c32).sum(1)
    scale = xx + cc[want_ids.long()]
    ids, d2 = got
    assert torch.all((d2 - want_d2).abs() <= 1e-5 * scale + 1e-6)
    if c.shape[0] > 1:
        full = xx[:, None] - 2 * (x32 @ c32.T) + cc[None]
        two = full.topk(2, dim=1, largest=False).values
        decided = two[:, 1] - two[:, 0] > 1e-5 * scale
    else:
        decided = torch.ones_like(ids, dtype=torch.bool)
    assert torch.equal(ids[decided], want_ids[decided])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k,bn", [(0, 8, 10, 1024), (1, 1, 1, 1024),
                                      (100003, 8, 10, 1024),
                                      (65536, 32, 100, 512), (777, 3, 5, 7)])
def test_cuda_kmeans_kernel_matches_plain(cuda, dtype, n, d, k, bn):
    x, c = _assign_case(n, d, k, dtype, seed=n + k, dup=True)
    before = kkernel.launches
    got = kkernel.kmeans_assign_ids(x.to(cuda), c.to(cuda), bn=bn)
    torch.cuda.synchronize()
    assert kkernel.launches == before + (1 if n else 0)
    if n:
        _check_assign(x, c, got, cuda)
        if k > 2:          # the duplicated last centroid never wins
            assert not bool((got[0] == k - 1).any())


def test_cuda_kmeans_kernel_shared_memory_limit(cuda):
    """A centroid table that fills a block's shared memory exactly runs;
    one float more is refused before launch."""
    k, d = 256, 226
    assert kkernel.shared_bytes(k, d) == kkernel.MAX_SHARED
    x, c = _assign_case(4096, d, k, torch.float32, seed=1)
    got = kkernel.kmeans_assign_ids(x.to(cuda), c.to(cuda), bn=1024)
    torch.cuda.synchronize()
    _check_assign(x, c, got, cuda)
    x, c = _assign_case(64, d + 1, k, torch.float32, seed=2)
    with pytest.raises(ValueError, match="shared memory"):
        kkernel.kmeans_assign_ids(x.to(cuda), c.to(cuda), bn=1024)


def _check_partials(x, c, valid, table):
    """The fused partials against the ids kernel's ids: exact counts, sums
    within the stated bound of float64 one-hot sums."""
    k, d = c.shape
    ids, _ = kkernel.kmeans_assign_ids(x, c, bn=1024)
    v = (torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
         if valid is None else valid)
    assert torch.equal(table[:, d], torch.bincount(
        ids[v].long(), minlength=k).float())
    oh = torch.nn.functional.one_hot(ids.long(), k).double() \
        * v.double()[:, None]
    x64 = x.double()
    err = (table[:, :d].double() - oh.T @ x64).abs()
    assert torch.all(err <= 1e-5 * (oh.T @ x64.abs()) + 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(0, 8, 10), (1, 1, 1), (777, 3, 5),
                                   (100003, 8, 10), (65536, 32, 100),
                                   (5000, 16, 7), (3000, 40, 6),
                                   (2000, 8, 200)])
@pytest.mark.parametrize("mask", [None, "random", "none"])
def test_cuda_kmeans_partials_match_ids_kernel(cuda, dtype, n, d, k, mask):
    """Every route of the fused kernel (private columns at small tables,
    a warp a block with the row in shared or device memory at wide ones,
    vector and element loads): one launch a call, deterministic, and in
    agreement with the ids kernel."""
    x, c = _assign_case(n, d, k, dtype, seed=n + d + k)
    x, c = x.to(cuda), c.to(cuda)
    g = torch.Generator().manual_seed(n + 1)
    valid = {None: None, "none": torch.zeros(n, dtype=torch.bool),
             "random": torch.rand(n, generator=g) < 0.7}[mask]
    valid = None if valid is None else valid.to(cuda)
    before = kkernel.partials_launches
    first = kkernel.kmeans_partials(x, c, valid)
    second = kkernel.kmeans_partials(x, c, valid)
    torch.cuda.synchronize()
    assert kkernel.partials_launches == before + (2 if n else 0)
    assert first.shape == (k, d + 1) and torch.equal(first, second)
    _check_partials(x, c, valid, first)
    if mask == "none" or n == 0:
        assert not first.any()
    assert torch.equal(kmeans_partials(x, c, valid), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kmeans_kernels_unaligned_points(cuda, dtype):
    """Points 4 or 2 bytes off the 16-byte grid take the element-wise
    load route: the same ids and d2 as an aligned copy, the same counts,
    and sums within the stated bound (the route walks the points in
    another order)."""
    x, c = _assign_case(100001, 8, 10, dtype, seed=5)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    odd = flat[1:].view(x.shape)
    odd.copy_(x.to(cuda))
    assert odd.data_ptr() % 16 != 0
    x, c = x.to(cuda), c.to(cuda)
    for got, want in zip(kkernel.kmeans_assign_ids(odd, c, bn=1024),
                         kkernel.kmeans_assign_ids(x, c, bn=1024)):
        assert torch.equal(got, want)
    table = kkernel.kmeans_partials(odd, c)
    assert torch.equal(table[:, 8], kkernel.kmeans_partials(x, c)[:, 8])
    _check_partials(odd, c, None, table)


@pytest.mark.parametrize("block_n", [1, 1024])
def test_cuda_kmeans_assign_partials_accept_block_n(cuda, block_n):
    """The JAX package's ``block_n`` is accepted on the card's route and
    changes nothing: the fused kernel sizes its own grid."""
    x, c = _assign_case(5000, 8, 10, torch.float32, seed=12)
    x, c = x.to(cuda), c.to(cuda)
    before = kkernel.partials_launches
    got = kmeans_assign_partials(x, c, block_n=block_n)
    want = kmeans_partials(x, c)
    assert kkernel.partials_launches == before + 2
    assert torch.equal(got[0], want[:, :8]) and torch.equal(got[1],
                                                            want[:, 8])


def test_cuda_kmeans_partials_shared_memory_limit(cuda):
    """The fused kernel takes every table the ids kernel takes, the full
    one with its row in device memory, and refuses one float more."""
    k, d = 256, 226
    x, c = _assign_case(4096, d, k, torch.float32, seed=1)
    x, c = x.to(cuda), c.to(cuda)
    valid = (torch.rand(4096, generator=torch.Generator().manual_seed(3))
             < 0.7).to(cuda)
    table = kkernel.kmeans_partials(x, c, valid)
    assert torch.equal(table, kkernel.kmeans_partials(x, c, valid))
    _check_partials(x, c, valid, table)
    x, c = _assign_case(64, d + 1, k, torch.float32, seed=2)
    with pytest.raises(ValueError, match="shared memory"):
        kkernel.kmeans_partials(x.to(cuda), c.to(cuda))


def test_cuda_kmeans_sphere_through_kernel(cuda, tmp_path):
    """k-means through the port's engine on the card: centroids of the CPU
    run, one fused partials launch per assign task and no ids kernel
    launch."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(c, 0.5, (3000, 8)) for c in
                          (np.zeros(8), np.full(8, 6.0), np.full(8, -5.0))]) \
        .astype(np.float32)
    results = {}
    for name, device in (("cpu", "cpu"), ("cuda", cuda)):
        sub = tmp_path / name
        sub.mkdir()
        master = tsector.SectorMaster(chunk_size=4096 * 32)
        for i, site in enumerate(master.topology.sites):
            master.register(tsector.ChunkServer(f"s{i}", site, sub))
        master.acl.add_member("a")
        master.acl.grant_write("a")
        client = tsector.SectorClient(master, "a", "chicago")
        client.upload("pts", tkm.encode_points(pts), replication=2)
        before = kkernel.partials_launches, kkernel.launches
        cents, rep = tkm.kmeans_sphere(
            tcore.SphereEngine(master, client, device=device), "pts",
            dim=8, k=3, iters=4, backend="array")
        results[name] = (cents, rep, kkernel.partials_launches - before[0],
                         kkernel.launches - before[1])
    (c_cpu, r_cpu, l_cpu, i_cpu), (c_dev, r_dev, l_dev, i_dev) = (
        results["cpu"], results["cuda"])
    np.testing.assert_allclose(c_dev, c_cpu, rtol=1e-5, atol=1e-5)
    n_chunks = -(-pts.nbytes // (4096 * 32))
    assert l_cpu == 0 and l_dev == 4 * n_chunks
    assert i_cpu == i_dev == 0
    assert r_dev.udf_traces == {"assign": 1, "fold": 1}
    assert r_dev.sim_seconds == r_cpu.sim_seconds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,K,D,causal,window", [
    (2, 64, 64, 2, 2, 32, True, 0), (2, 64, 64, 4, 2, 32, True, 24),
    (2, 50, 70, 2, 2, 32, False, 0), (2, 32, 96, 2, 1, 64, False, 24),
    (1, 300, 300, 10, 1, 256, True, 128), (1, 257, 257, 16, 2, 128, True, 0),
    (3, 1, 1, 4, 4, 16, True, 0), (1, 129, 129, 2, 1, 12, True, 0)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, B, T, S, H, K, D,
                                            causal, window):
    g = torch.Generator().manual_seed(T * 7 + D)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    before = fkernel.launches
    got = fkernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fkernel.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _close_to_rounded_p(got, q, k, v, causal, window):
    """The bf16 kernel's output against the oracle that rounds p to bf16:
    within what the two roundings allow (``chip_smoke.rounded_p_excess``)
    plus 1e-4."""
    err, excess = chip_smoke.rounded_p_excess(torch, got, q, k, v, causal,
                                              window)
    assert excess <= 1e-4, (err, excess)


@pytest.mark.parametrize("B,T,H,K,D,window", [
    (1, 63, 2, 1, 64, 0), (1, 64, 2, 1, 64, 0), (2, 64, 4, 2, 32, 24),
    (3, 40, 8, 8, 12, 0), (2, 64, 10, 1, 256, 0), (3, 17, 4, 2, 16, 5)])
def test_cuda_flash_attention_rounds_p(cuda, B, T, H, K, D, window):
    """Where all of a row's live keys lie in one 64-key tile, the kernel's
    running maximum is the row's, so its p are the oracle's: the output
    is the rounded-p oracle's within the output's own rounding (2**-8 of
    it) and 1e-3 (a p on a bf16 rounding edge may round the other way:
    up to 5.2e-4 at D = 256).  Keeping p in float32 leaves 1.45e-3 or
    more beyond the output's rounding in these cases."""
    g = torch.Generator().manual_seed(T * 13 + D + window)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(cuda)
               for shape in ((B, T, H, D), (B, T, K, D), (B, T, K, D)))
    got = fkernel.flash_attention_fwd(q, k, v, causal=True, window=window)
    want = chip_smoke.attention_rounded_p(torch, q, k, v, True, window)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,K,D,causal,window", [
    # T and S at the 64-key tile's and the 128-row block's edges
    (1, 63, 63, 2, 1, 64, True, 0), (1, 64, 64, 2, 1, 64, True, 0),
    (1, 65, 65, 2, 1, 64, True, 0), (1, 127, 127, 2, 2, 128, True, 0),
    (1, 128, 128, 2, 2, 128, True, 0), (1, 129, 129, 2, 2, 128, True, 0),
    (3, 65, 129, 8, 1, 16, False, 0), (1, 127, 129, 10, 1, 256, False, 0),
    # across a window edge: the window ends inside a tile, on its edge,
    # and one past it
    (1, 200, 200, 10, 1, 256, True, 63), (1, 200, 200, 10, 1, 256, True, 64),
    (1, 200, 200, 10, 1, 256, True, 65), (2, 129, 129, 4, 2, 12, True, 100),
    # head dims below the instance's width and GQA groups 1, 2, 8, 10
    (3, 100, 100, 8, 8, 12, True, 0), (2, 100, 100, 4, 2, 16, True, 30),
    (3, 70, 70, 8, 1, 64, True, 0), (1, 150, 150, 10, 1, 96, True, 0),
    (3, 130, 130, 10, 1, 256, True, 50), (1, 90, 90, 2, 1, 40, True, 0)])
def test_cuda_flash_attention_tile_edges(cuda, dtype, B, T, S, H, K, D,
                                         causal, window):
    g = torch.Generator().manual_seed(T * 13 + D + window)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    got = fkernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _close_to_rounded_p(got, q, k, v, causal, window)


@pytest.mark.parametrize("D", [64, 256])
def test_cuda_flash_attention_both_load_routes(cuda, D):
    """The bf16 kernel loads by TMA from 16-byte aligned tensors and by
    cp.async from 8-byte aligned ones, with the same result."""
    g = torch.Generator().manual_seed(D)
    shapes = ((1, 300, 10, D), (1, 300, 1, D), (1, 300, 1, D))
    dense = [torch.randn(s, generator=g).to(torch.bfloat16).to(cuda)
             for s in shapes]
    shifted = []
    for x in dense:               # the same values 8 bytes past a 16-byte line
        buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=cuda)
        y = buf[4:].view(x.shape)
        y.copy_(x)
        shifted.append(y)
    a = fkernel.flash_attention_fwd(*dense, causal=True, window=100)
    b = fkernel.flash_attention_fwd(*shifted, causal=True, window=100)
    want = flash_attention_ref(*dense, causal=True, window=100)
    torch.cuda.synchronize()
    for got in (a, b):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        _close_to_rounded_p(got, *dense, True, 100)


def test_cuda_flash_library_runs_on_wgmma(cuda):
    """The built library's SASS holds the Hopper tensor-core product."""
    assert fkernel.hgmma_count() > 0


def test_cuda_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.randn(1, 8, 2, 260, device=cuda)
    k = torch.randn(1, 8, 1, 260, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fkernel.flash_attention_fwd(q, k, k, causal=True, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        fkernel.flash_attention_fwd(q[..., :256], k[..., :256],
                                    k[..., :256], causal=True, window=0)
    q = torch.randn(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fkernel.flash_attention_fwd(q, q, q, causal=True, window=0)


@pytest.mark.parametrize("B,T,W", [
    (1, 3072, 2560), (4, 1, 2560), (2, 33, 64), (3, 8, 48), (1, 13, 1000),
    # T at 1, a stage of 64 steps less one, a stage, one more, and long
    (4, 1, 48), (2, 63, 48), (3, 64, 1000), (4, 65, 2560), (1, 3072, 48),
    (4, 3072, 1000), (2, 385, 2560),
    # W not a multiple of 4: the direct loop
    (3, 200, 13), (1, 70, 7)])
def test_cuda_rg_lru_scan_matches_plain_exactly(cuda, B, T, W):
    g = torch.Generator().manual_seed(B * 100 + T)
    a = (torch.rand((B, T, W), generator=g) * 0.299 + 0.7).to(cuda)
    b = (torch.randn((B, T, W), generator=g) * 0.1).to(cuda)
    h0 = torch.randn((B, W), generator=g).to(cuda)
    before = lkernel.launches
    h, hl = lkernel.lru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert lkernel.launches == before + 1
    rh, rhl = lru_scan_ref(a, b, h0)
    assert torch.equal(h, rh) and torch.equal(hl, rhl)


def test_cuda_rg_lru_scan_unaligned_exactly(cuda):
    """Tensors 4 bytes past a 16-byte line take the direct loop, not
    the TMA ring; the same values aligned take the ring, with the same
    result."""
    g = torch.Generator().manual_seed(5)
    B, T, W = 2, 300, 1000
    bufs = [torch.empty(B * T * W + 1, device=cuda) for _ in range(2)]
    a, b = (x[1:].view(B, T, W) for x in bufs)
    a.copy_(torch.rand((B, T, W), generator=g) * 0.299 + 0.7)
    b.copy_(torch.randn((B, T, W), generator=g) * 0.1)
    h0 = torch.randn((B, W), generator=g).to(cuda)
    rh, rhl = lru_scan_ref(a, b, h0)
    for args in ((a, b, h0), (a.clone(), b.clone(), h0)):
        h, hl = lkernel.lru_scan(*args)
        assert torch.equal(h, rh) and torch.equal(hl, rhl)


def _lm(name):
    """A reduced float32 config and its parameters on the CPU."""
    cfg = tconfigs.get_config(name).reduced().replace(
        param_dtype="float32", compute_dtype="float32")
    return cfg, tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "qwen2.5-3b"])
def test_cuda_prefill_and_decode_through_kernels(cuda, name):
    """Prefill (longer than the window) and decode steps on the card
    against the CPU run, with one flash_attention launch per attention
    layer of a prefill and one rg_lru_scan launch per R layer of each
    prefill and decode step."""
    cfg, p_cpu = _lm(name)
    p_dev = _to(p_cpu, cuda)
    n_attn = cfg.n_groups * sum(s in "AL" for s in cfg.block_pattern)
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 100)).astype(np.int32))
    out = {}
    with torch.inference_mode():
        for dev, params in (("cpu", p_cpu), ("cuda", p_dev)):
            f0, l0 = fkernel.launches, lkernel.launches
            logits, cache = tmodel.prefill(
                params, {"inputs": toks.to(dev)}, cfg=cfg, max_len=128)
            steps = [logits.cpu()]
            for i in range(3):
                lg, cache = tmodel.decode_step(
                    params, cache,
                    torch.tensor([[7 + i]], dtype=torch.int32, device=dev),
                    torch.tensor([100 + i], dtype=torch.int32, device=dev),
                    cfg=cfg)
                steps.append(lg.cpu())
            out[dev] = (steps, fkernel.launches - f0, lkernel.launches - l0)
    assert out["cpu"][1:] == (0, 0)
    assert out["cuda"][1:] == (n_attn, n_rec * 4)
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


def test_cuda_serve_engine_matches_cpu(cuda):
    cfg, p_cpu = _lm("recurrentgemma-2b")
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (90, 12, 70, 12, 90)]
    outs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", _to(p_cpu, cuda))):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=128,
                          scfg=SamplerConfig(temperature=0.0), device=dev)
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        assert all(r.done for r in reqs)
        assert all(s is None for s in eng.slot_req)
        outs[dev] = [r.out for r in reqs]
    assert outs["cuda"] == outs["cpu"]


# --------------------------------------------------------------- training
@pytest.mark.parametrize("B,T,W", [(1, 3072, 2560), (2, 65, 48), (3, 1, 13),
                                   (2, 200, 1000)])
def test_cuda_rg_lru_scan_backward_matches_plain(cuda, B, T, W):
    """The Function's backward on the card (the kernel on the
    time-reversed recurrence, one ``backward_launches`` a backward)
    against autograd through the plain loop on the card: within 1e-5 of
    the gradients' scale (the kernel's multiplies and adds are the loop's;
    autograd sums two contributions per step in its own order)."""
    from repro_torch.kernels.rg_lru_scan import ops as lru_ops
    g = torch.Generator().manual_seed(T + W)
    a = (torch.rand((B, T, W), generator=g) * 0.299 + 0.7).to(cuda)
    b, up = ((torch.randn((B, T, W), generator=g) * 0.1).to(cuda)
             for _ in range(2))
    h0, up_last = (torch.randn((B, W), generator=g).to(cuda)
                   for _ in range(2))
    grads = {}
    for fn in (lru_ops.rg_lru_scan, lru_scan_ref):
        ins = [t.clone().requires_grad_() for t in (a, b, h0)]
        f0, b0 = lkernel.launches, lkernel.backward_launches
        h, hl = fn(*ins)
        grads[fn] = torch.autograd.grad((h * up).sum() + (hl * up_last).sum(),
                                        ins)
        torch.cuda.synchronize()
        kernel_route = fn is lru_ops.rg_lru_scan
        assert (lkernel.launches - f0, lkernel.backward_launches - b0) == \
            ((1, 1) if kernel_route else (0, 0))
    for got, want in zip(grads[lru_ops.rg_lru_scan], grads[lru_scan_ref]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,K,D,window", [
    (2, 200, 4, 2, 64, 0), (2, 300, 10, 1, 256, 100), (1, 129, 2, 1, 12, 0)])
def test_cuda_flash_attention_backward_matches_plain(cuda, dtype, B, T, H,
                                                     K, D, window):
    """The Function's gradient on the card (the kernel forward, the plain
    version recomputed row by row in backward) against autograd through
    the whole-batch plain version: within 1e-5 (float32) / 1e-2 (bf16,
    the gradients round to bf16) of the gradients' scale."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    g = torch.Generator().manual_seed(T + D)
    q = torch.randn((B, T, H, D), generator=g).to(dtype).to(cuda)
    k, v = (torch.randn((B, T, K, D), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    up = torch.randn((B, T, H, D), generator=g).to(dtype).to(cuda)
    grads = {}
    for fn in (flash_ops.flash_attention, flash_attention_ref):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        f0 = fkernel.launches
        out = fn(*ins, causal=True, window=window)
        grads[fn] = torch.autograd.grad(out, ins, up)
        assert fkernel.launches - f0 == (fn is flash_ops.flash_attention)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in zip(grads[flash_ops.flash_attention],
                         grads[flash_attention_ref]):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * scale)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_cuda_train_step_through_kernels(cuda, remat):
    """Loss and every gradient of reduced recurrentgemma-2b (float32) on
    the card against the CPU, within 1e-4 of each leaf's scale, with the
    launches a step makes: one flash_attention forward per attention
    layer and one rg_lru_scan forward and one backward per R layer, and
    under full or selective ("dots") remat the forwards again for the
    recompute."""
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths
    cfg, p_cpu = _lm("recurrentgemma-2b")
    pcfg = ParallelConfig(mesh=None, remat=remat, fused_head=True,
                          head_chunk=32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 97))
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", _to(p_cpu, cuda))):
        batch = {"inputs": torch.from_numpy(toks[:, :-1].astype(np.int32)),
                 "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
        counts = (fkernel.launches, lkernel.launches,
                  lkernel.backward_launches)
        (loss, _), grads = tstep._value_and_grad_accum(
            params, _to(batch, dev), cfg=cfg, pcfg=pcfg)
        torch.cuda.synchronize()
        out[dev] = (loss.cpu(), [g.cpu() for _, g in
                                 tree_flatten_with_paths(grads)],
                    tuple(now - then for now, then in zip(
                        (fkernel.launches, lkernel.launches,
                         lkernel.backward_launches), counts)))
    n_attn = cfg.n_groups * sum(s in "AL" for s in cfg.block_pattern)
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    passes = 1 if remat == "none" else 2
    assert out["cpu"][2] == (0, 0, 0)
    assert out["cuda"][2] == (n_attn * passes, n_rec * passes, n_rec)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
