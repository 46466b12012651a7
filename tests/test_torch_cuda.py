"""The port's CUDA kernels on the card against their plain PyTorch
versions — ``bucket_dest``, ``bucket_partition`` (its words and rows
entries), ``kmeans_assign``,
``flash_attention`` and ``rg_lru_scan`` — and the paths built on them
(TeraSort through ``SphereEngine``, on one device and on a one-rank
NCCL mesh, ``partition_batch`` /
``shuffle_batch``, k-means through ``kmeans_sphere``, LM prefill, decode,
``ServeEngine`` and a training step; the encoder-decoder and vision
configs' prefill, decode and serving) against the same calls on the CPU;
the two LM kernels' gradients against autograd through their plain
versions on the card; the LM mesh's collectives on CUDA tensors over two
gloo ranks sharing the card.

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
greedy ``ServeEngine`` tokens identical.  The reduced xLSTM and MoE
stacks: logits on the card within 1e-4 of the scale plus three times
what the CPU run's own logits move under a one-ulp change of the
embeddings; the chunkwise mLSTM within rtol 1e-4 / atol 1e-5 of the
sequential oracle and the two MoE dispatch modes within the same of each
other (the JAX package's own tests' tolerances), the MoE routing equal to
the CPU's, the gather combine the same bits from run to run.
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


def _terasort(tmp_path, data, device, mesh=None):
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
    return tcore.SphereEngine(master, client, pad_block=64, device=device,
                              mesh=mesh).run(job)


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


def test_cuda_mesh_round_on_one_rank_nccl(cuda, tmp_path):
    """``spmd.fused_scatter_round`` on a one-rank NCCL mesh: one launch of
    the rows kernel, and the single-device round's bytes, counts and
    histogram; then TeraSort through ``SphereEngine(mesh=)`` gives the
    CPU run's bytes."""
    import torch.distributed as dist

    from repro_torch.core import spmd
    from repro_torch.core.records import StackedBatch
    from repro_torch.launch.mesh import make_flat_mesh

    rng = np.random.default_rng(8)
    loads = [37, 0, 250, 9, 128, 1]
    recs = [[rng.bytes(REC) for _ in range(k)] for k in loads]
    stacked = StackedBatch.pack(
        [RecordBatch.from_records(r, device=cuda) if r
         else RecordBatch.empty(REC, cuda) for r in recs], pad_block=64)
    part = tsh.range_partitioner(tsh.sample_boundaries(
        [r for rs in recs for r in rs], 6))
    key_spec, bounds = part.scatter_spec(RecordBatch.empty(REC, cuda), 6)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_flat_mesh()
        before = tkernel.rows_launches
        parts, counts, hist = spmd.fused_scatter_round(
            stacked.data, stacked.n_valid, bounds, key_spec=key_spec,
            n_buckets=6, n_workers=6, mesh=mesh)
        torch.cuda.synchronize()
        assert tkernel.rows_launches == before + 1
        rd = tsh.scatter_round_dispatch(
            stacked, part, 6, worker_names=[f"s{i}" for i in range(6)],
            slot_workers=np.arange(6), pad_block=64)
        want_hist = rd.hist.cpu().tolist()
        res = rd.harvest()
        assert counts.cpu().tolist() == res.counts.tolist()
        assert hist.cpu().tolist() == want_hist
        for w, c in enumerate(res.counts.tolist()):
            assert torch.equal(parts[w, :c].cpu(), res.data[w, :c].cpu())
        data = np.random.default_rng(4).bytes(3000 * REC)
        (tmp_path / "cpu").mkdir()
        (tmp_path / "mesh").mkdir()
        cpu_outs, _ = _terasort(tmp_path / "cpu", data, "cpu")
        before = tkernel.rows_launches
        outs, rep = _terasort(tmp_path / "mesh", data, None, mesh=mesh)
        assert outs == cpu_outs
        assert tkernel.rows_launches - before == rep.shuffle_rounds \
            == rep.host_syncs
    finally:
        dist.destroy_process_group()


def test_cuda_autograd_collectives_on_one_rank_nccl(cuda, tmp_path,
                                                   monkeypatch):
    """``sharded.all_gather`` and ``sharded.all_to_all`` (the MoE's
    collectives that autograd crosses) over a one-rank NCCL group: the
    forward and the backward are the identity, bit for bit, in bf16 and
    float32; each counts its bytes in ``sharded.WIRE``.  A one-rank mesh
    has no group of its axes (its collectives are skipped), so the mesh
    here is handed the world group to run them."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_flat_mesh
    from repro_torch.parallel import sharded
    from repro_torch.parallel.mesh_utils import Mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_flat_mesh()
        monkeypatch.setattr(Mesh, "group_for",
                            lambda self, axes: dist.group.WORLD)
        gen = torch.Generator().manual_seed(3)
        for dtype in (torch.bfloat16, torch.float32):
            for name, fn in (("all_gather", sharded.all_gather),
                             ("all_to_all", sharded.all_to_all)):
                x = torch.randn(4, 6, 5, generator=gen).to(dtype).to(cuda)
                up = torch.randn(4, 6, 5, generator=gen).to(dtype).to(cuda)
                x.requires_grad_()
                before = sharded.WIRE[name]
                y = fn(x, mesh, "data")
                (g,) = torch.autograd.grad(y, x, up)
                torch.cuda.synchronize()
                assert y.is_cuda and torch.equal(y, x.detach()), name
                assert torch.equal(g, up), name
                assert sharded.WIRE[name] - before == 2 * x.nbytes, name
    finally:
        dist.destroy_process_group()


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
    (3, 1, 1, 4, 4, 16, True, 0), (1, 129, 129, 2, 1, 12, True, 0),
    # the head ratios and widths of gemma3-12b (local and global),
    # deepseek-7b (MHA) and dbrx-132b
    (1, 300, 300, 16, 8, 256, True, 128), (1, 300, 300, 16, 8, 256, True, 0),
    (1, 257, 257, 32, 32, 128, True, 0), (1, 257, 257, 48, 8, 128, True, 0),
    # a tensor-parallel rank's heads on a (data, model) = (1, 2) mesh:
    # recurrentgemma-2b's 5 of 10 over its one kv head with the window,
    # qwen2.5-3b's 8 of 16 over its one of 2 kv heads
    (1, 300, 300, 5, 1, 256, True, 128), (1, 3072, 3072, 5, 1, 256, True, 2048),
    (1, 257, 257, 8, 1, 128, True, 0)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,K,D,causal", [
    # the encoder-decoder's and the vision backbone's serving routes,
    # scaled down from T = 3072 / S = 4096: the encoder's non-causal
    # self-attention, the decoder's causal one and its cross-attention
    # (T != S) at D = 64 with 16 heads, and GQA 32 / 8 at D = 128
    (1, 512, 512, 16, 16, 64, False), (1, 384, 384, 16, 16, 64, True),
    (1, 384, 512, 16, 16, 64, False), (1, 384, 384, 32, 8, 128, True)])
def test_cuda_flash_attention_serving_routes(cuda, dtype, B, T, S, H, K, D,
                                             causal):
    g = torch.Generator().manual_seed(T + S + D)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    got = fkernel.flash_attention_fwd(q, k, v, causal=causal, window=0)
    want = flash_attention_ref(q, k, v, causal=causal, window=0)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        _close_to_rounded_p(got, q, k, v, causal, 0)


@pytest.mark.parametrize("T,S", [(63, 129), (65, 64), (127, 65), (129, 63),
                                 (128, 192), (1, 200), (200, 1), (64, 257)])
def test_cuda_flash_attention_cross_lengths_at_tile_edges(cuda, T, S):
    """Non-causal, queries and keys of different lengths at the 128-row
    block's and the 64-key tile's edges, at D = 64 (the cross-attention's
    width): bf16 against the plain version and the rounded-p oracle,
    float32 against the plain version."""
    g = torch.Generator().manual_seed(T * 1000 + S)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
                   for shape in ((2, T, 4, 64), (2, S, 2, 64),
                                 (2, S, 2, 64)))
        got = fkernel.flash_attention_fwd(q, k, v, causal=False, window=0)
        want = flash_attention_ref(q, k, v, causal=False, window=0)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if dtype == torch.bfloat16:
            _close_to_rounded_p(got, q, k, v, False, 0)


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
    (3, 200, 13), (1, 70, 7),
    # a tensor-parallel rank's half of recurrentgemma-2b's LRU width
    (1, 3072, 1280), (4, 1, 1280)])
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


def test_cuda_encdec_prefill_decode_and_serve(cuda):
    """Reduced ``seamless-m4t-large-v2`` (float32): a prefill over 100
    tokens and 120 frames, then three decode steps over the cached cross
    K / V, on the card against the CPU within 1e-4 of the logits' scale;
    a prefill launches ``flash_attention`` once per encoder layer and
    twice per decoder layer (self and cross), a decode step never; and
    greedy ``ServeEngine`` tokens, with frames and without, as the CPU's."""
    cfg, p_cpu = _lm("seamless-m4t-large-v2")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 100))
                            .astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((1, 120, cfg.d_model))
                              .astype(np.float32))
    want_launches = cfg.n_enc_layers + 2 * cfg.n_layers
    out = {}
    with torch.inference_mode():
        for dev, params in (("cpu", p_cpu), ("cuda", _to(p_cpu, cuda))):
            f0 = fkernel.launches
            logits, cache = tmodel.prefill(
                params, {"inputs": toks.to(dev), "enc_frames": frames.to(dev)},
                cfg=cfg, max_len=128)
            n_prefill = fkernel.launches - f0
            steps = [logits.cpu()]
            for i in range(3):
                lg, cache = tmodel.decode_step(
                    params, cache,
                    torch.tensor([[7 + i]], dtype=torch.int32, device=dev),
                    torch.tensor([100 + i], dtype=torch.int32, device=dev),
                    cfg=cfg)
                steps.append(lg.cpu())
            out[dev] = (steps, n_prefill, fkernel.launches - f0)
    assert out["cpu"][1:] == (0, 0)
    assert out["cuda"][1:] == (want_launches, want_launches)
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (30, 12, 30)]
    given = [rng.standard_normal((1, 64, cfg.d_model)).astype(np.float32),
             None, rng.standard_normal((1, 40, cfg.d_model))
             .astype(np.float32)]
    served = {}
    for dev, params in (("cpu", p_cpu), ("cuda", _to(p_cpu, cuda))):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=64,
                          scfg=SamplerConfig(temperature=0.0), device=dev)
        reqs = [eng.submit(p, max_new=5, enc_frames=f)
                for p, f in zip(prompts, given)]
        eng.run()
        assert all(r.done for r in reqs)
        served[dev] = [r.out for r in reqs]
    assert served["cuda"] == served["cpu"]


def test_cuda_vision_prefill_with_patches(cuda):
    """Reduced ``llava-next-mistral-7b`` (float32): a prefill of 100
    tokens with the patches spliced in at distinct positions and three
    decode steps, on the card against the CPU within 1e-4 of the scale;
    ``splice_patches`` on the card is the CPU's plain scatter within 1e-5
    (float32 products in another order)."""
    from repro_torch.models import transformer as ttransformer
    from repro_torch.parallel.sharding import NO_PARALLEL
    cfg, p_cpu = _lm("llava-next-mistral-7b")
    rng = np.random.default_rng(5)
    P = cfg.frontend_positions
    batch = {"inputs": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (1, 100)).astype(np.int32)),
             "patch_embeds": torch.from_numpy(rng.standard_normal(
                 (1, P, cfg.d_model)).astype(np.float32)),
             "patch_pos": torch.from_numpy(rng.choice(100, (1, P), False)
                                           .astype(np.int32))}
    out = {}
    with torch.inference_mode():
        for dev, params in (("cpu", p_cpu), ("cuda", _to(p_cpu, cuda))):
            b = {k: v.to(dev) for k, v in batch.items()}
            x = ttransformer.embed(params, b["inputs"], cfg=cfg,
                                   pcfg=NO_PARALLEL)
            spliced = ttransformer.splice_patches(
                params, x, b["patch_embeds"], b["patch_pos"], cfg=cfg,
                pcfg=NO_PARALLEL)
            logits, cache = tmodel.prefill(params, b, cfg=cfg, max_len=128)
            steps = [logits.cpu()]
            for i in range(3):
                lg, cache = tmodel.decode_step(
                    params, cache,
                    torch.tensor([[7 + i]], dtype=torch.int32, device=dev),
                    torch.tensor([100 + i], dtype=torch.int32, device=dev),
                    cfg=cfg)
                steps.append(lg.cpu())
            out[dev] = (spliced.cpu(), steps)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


# --------------------------------------------------------------- training
@pytest.mark.parametrize("B,T,W", [(1, 3072, 2560), (1, 3072, 1280),
                                   (2, 65, 48), (3, 1, 13),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,K", [(2, 200, 300, 4, 2),
                                       (1, 130, 65, 16, 16)])
def test_cuda_flash_attention_backward_non_causal_cross(cuda, dtype, B, T, S,
                                                        H, K):
    """The Function's gradient on the routes seamless-m4t-large-v2 trains
    through: D = 64, non-causal, keys from another stream (S != T, the
    cross-attention over the encoder memory), against autograd through
    the whole-batch plain version, within the bounds of
    ``test_cuda_flash_attention_backward_matches_plain``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    g = torch.Generator().manual_seed(T + S)
    q, up = (torch.randn((B, T, H, 64), generator=g).to(dtype).to(cuda)
             for _ in range(2))
    k, v = (torch.randn((B, S, K, 64), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    grads = {}
    for fn in (flash_ops.flash_attention, flash_attention_ref):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        f0 = fkernel.launches
        out = fn(*ins, causal=False, window=0)
        grads[fn] = torch.autograd.grad(out, ins, up)
        assert fkernel.launches - f0 == (fn is flash_ops.flash_attention)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in zip(grads[flash_ops.flash_attention],
                         grads[flash_attention_ref]):
        assert got.shape == want.shape
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * scale)


def test_cuda_xlstm_unit_gradient_matches_cpu(cuda):
    """One pattern unit of reduced ``xlstm-1.3b`` (7 mLSTM layers and an
    sLSTM, float32, full remat, the fused head), as ``chip_smoke.py``'s
    phase 25 checks it at full width: the loss and every gradient on the
    card within 1e-3 (relative L2) of the CPU's, all finite, on 2 x 8
    tokens.  The row is short because the random-weight stack amplifies
    float32 rounding with its length: a one-ulp move of the embeddings
    moves the CPU's own gradients by at most 2.4e-4 of a leaf here, and
    by 2.9e-2 at 256 tokens.  The sLSTM's ``b_i`` gradient is zero in
    exact arithmetic (a shift of the input-gate bias moves the
    stabiliser by as much and leaves c, n and h = c / n as they are), so
    on either device it stays below 1e-5 of ``b_f``'s in norm."""
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths
    cfg, _ = _lm("xlstm-1.3b")
    cfg = cfg.replace(n_layers=cfg.pattern_len)
    p_cpu = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg = ParallelConfig(mesh=None, remat="full", fused_head=True,
                          head_chunk=64)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9))
    batch = {"inputs": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", _to(p_cpu, cuda))):
        (loss, _), grads = tstep._value_and_grad_accum(
            params, _to(batch, dev), cfg=cfg, pcfg=pcfg)
        out[dev] = (float(loss), {path: g.cpu().double() for path, g in
                                  tree_flatten_with_paths(grads)})
    (loss, got), (want_loss, want) = out["cuda"], out["cpu"]
    assert abs(loss - want_loss) <= 1e-3 * abs(want_loss)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert torch.isfinite(g).all(), path
        if path.endswith("slstm/b_i"):
            b_f = path.rsplit("/", 1)[0] + "/b_f"
            for tree in (got, want):
                assert float(tree[path].norm()) <= 1e-5 * float(
                    tree[b_f].norm()), path
            continue
        assert float((g - w).norm()) <= 1e-3 * float(w.norm()), path


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


# ------------------------------------------- the xLSTM and MoE families
def _one_ulp(params):
    """``params`` with every embedding entry moved by one float32 ulp (a
    sign drawn from a seed)."""
    e = params["embed"]["w"]
    sign = torch.from_numpy(np.random.default_rng(0).choice(
        [-1.0, 1.0], tuple(e.shape)).astype(np.float32))
    return dict(params, embed={"w": e * (1 + 2.0 ** -23 * sign)})


@pytest.mark.parametrize("name", ["xlstm-1.3b", "qwen3-moe-30b-a3b"])
def test_cuda_new_families_prefill_and_decode(cuda, name):
    """Reduced ``xlstm-1.3b`` / ``qwen3-moe-30b-a3b`` (float32): a
    prefill and three decode steps on the card against the CPU, within
    1e-4 of the logits' scale plus three times the CPU run's own spread
    (what its logits move when the embeddings move by one ulp: the
    reduced xLSTM stack at random weights amplifies float32 rounding to
    about 1e-3 of the scale); a prefill launches ``flash_attention`` once
    per attention layer (the MoE stack's 2, the xLSTM's 0) and
    ``rg_lru_scan`` never."""
    cfg, p_cpu = _lm(name)
    n_attn = cfg.n_groups * sum(s in "AL" for s in cfg.block_pattern)
    assert n_attn == (2 if name == "qwen3-moe-30b-a3b" else 0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 100)).astype(np.int32))
    out = {}
    with torch.inference_mode():
        for dev, params in (("cpu", p_cpu), ("ulp", _one_ulp(p_cpu)),
                            ("cuda", _to(p_cpu, cuda))):
            where = "cpu" if dev == "ulp" else dev
            f0, l0 = fkernel.launches, lkernel.launches
            logits, cache = tmodel.prefill(
                params, {"inputs": toks.to(where)}, cfg=cfg, max_len=128)
            prefill_launches = (fkernel.launches - f0, lkernel.launches - l0)
            steps = [logits.cpu()]
            for i in range(3):
                lg, cache = tmodel.decode_step(
                    params, cache,
                    torch.tensor([[7 + i]], dtype=torch.int32, device=where),
                    torch.tensor([100 + i], dtype=torch.int32,
                                 device=where), cfg=cfg)
                steps.append(lg.cpu())
            out[dev] = (steps, prefill_launches,
                        (fkernel.launches - f0, lkernel.launches - l0))
    assert out["cpu"][1:] == ((0, 0), (0, 0))
    assert out["cuda"][1:] == ((n_attn, 0), (n_attn, 0))
    for got, want, ulp in zip(out["cuda"][0], out["cpu"][0], out["ulp"][0]):
        spread = float((ulp - want).abs().max())
        torch.testing.assert_close(
            got, want, rtol=0,
            atol=1e-4 * float(want.abs().max()) + 3 * spread)


@pytest.mark.parametrize("T,chunk", [(64, 16), (96, 256), (33, 256)])
def test_cuda_mlstm_chunkwise_matches_sequential(cuda, T, chunk,
                                                 monkeypatch):
    """The chunkwise mLSTM on the card against the port's sequential
    oracle on the card (float32, the reduced config's block), within the
    JAX test's rtol 1e-4 / atol 1e-5: chunks of 16, of 32 (96 halved
    from 256) and of one token (an odd T)."""
    from repro_torch.models import common as tcommon
    from repro_torch.models import xlstm as txlstm
    monkeypatch.setattr(txlstm, "CHUNK", chunk)
    cfg, _ = _lm("xlstm-1.3b")
    p = tcommon.materialize(txlstm.mlstm_shapes(cfg),
                            torch.Generator().manual_seed(1), cuda)
    x = torch.randn((2, T, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(cuda)
    with torch.inference_mode():
        got, _ = txlstm.mlstm_apply(p, x, cfg=cfg)
        want = txlstm.mlstm_sequential_oracle(p, x, cfg=cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _moe_case(cuda, dtype, d=256, E=16, k=4, f=128, tokens=(2, 256)):
    from repro_torch.models import common as tcommon
    from repro_torch.models import moe as tmoe
    cfg = tconfigs.get_config("qwen3-moe-30b-a3b").replace(
        d_model=d, n_experts=E, top_k=k, moe_d_ff=f, param_dtype=dtype,
        compute_dtype=dtype)
    p = tcommon.materialize(tmoe.shapes(cfg), torch.Generator().manual_seed(3),
                            cuda)
    x = torch.randn(tokens + (d,), generator=torch.Generator().manual_seed(4)
                    ).to(getattr(torch, dtype)).to(cuda)
    return cfg, p, x


@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_cuda_moe_einsum_matches_gather(cuda, factor, monkeypatch):
    """The two dispatch modes on the card (float32) agree with no drops
    and at the default capacity (the same tokens dropped), within the
    JAX test's rtol 1e-4 / atol 1e-5; the routing equals the CPU's."""
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel.sharding import ParallelConfig
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", factor)
    cfg, p, x = _moe_case(cuda, "float32")
    with torch.inference_mode():
        oe, ae = tmoe.apply(p, x, cfg=cfg,
                            pcfg=ParallelConfig(moe_dispatch="einsum"))
        og, ag = tmoe.apply(p, x, cfg=cfg,
                            pcfg=ParallelConfig(moe_dispatch="gather"))
        xg = x.reshape(1, -1, cfg.d_model)
        route = tmoe._route(p, xg, cfg)
        route_cpu = tmoe._route(_to(p, "cpu"), xg.cpu(), cfg)
    torch.testing.assert_close(oe, og, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ae, ag, rtol=1e-6, atol=0)
    for got, want in zip(route[1:3], route_cpu[1:3]):   # eids, pos
        assert torch.equal(got.cpu(), want)


def test_cuda_moe_gather_combine_is_deterministic(cuda):
    """The gather route's combine sums each token's own slots (no atomic
    adds): two runs on the card give the same bits, in bf16 and
    float32."""
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel.sharding import ParallelConfig
    for dtype in ("bfloat16", "float32"):
        cfg, p, x = _moe_case(cuda, dtype, tokens=(4, 1024))
        pcfg = ParallelConfig(moe_dispatch="gather")
        with torch.inference_mode():
            runs = [tmoe.apply(p, x, cfg=cfg, pcfg=pcfg)[0]
                    for _ in range(2)]
        assert torch.equal(runs[0], runs[1]), dtype


def test_cuda_materialize_holds_no_float32_copy_of_a_leaf(cuda):
    """An expert leaf ``[4, 16, 2048, 768]`` in bf16 (201 MB; 403 MB in
    float32) is drawn a slice of its leading axis at a time: the peak
    above the start is the leaf and one float32 slice (101 MB), never
    the leaf in float32; the values are the fan-in-scaled normal's."""
    from repro_torch.models import common as tcommon
    spec = {"moe": {"wi": tcommon.sds((4, 16, 2048, 768), torch.bfloat16)}}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaf = tcommon.materialize(spec, torch.Generator().manual_seed(5),
                               cuda)["moe"]["wi"]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    slice_f32 = 16 * 2048 * 768 * 4
    assert leaf.dtype == torch.bfloat16
    assert peak <= leaf.nbytes + slice_f32 + (1 << 20), peak
    assert peak < 2 * leaf.nbytes, peak
    std = float(leaf.float().std())
    assert abs(std * 2048 ** 0.5 - 1.0) < 0.01, std


def test_cuda_mesh_collectives_host_staged(cuda):
    """Two gloo ranks sharing the card (``run_ranks``, host-staged):
    ``cross_pod_mean`` on CUDA tensors, every mode, gives the bits the
    same call gives on the CPU; ``shard_tree`` / ``gather_tree`` round
    trip on the card; ``global_norm`` of blocks is the whole tree's
    (rtol 1e-6: float32 sums in another order)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_train_ranks
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(torch_train_ranks.cuda_mesh_suite, 2, timeout_s=120,
                    join_timeout_s=300)
    for out in res:
        assert out["staged"] and out["device"].startswith("cuda")
        for mode in ("none", "bf16", "int8_ef"):
            (m_card, e_card), (m_cpu, e_cpu) = out[mode]
            assert np.array_equal(m_card, m_cpu), mode
            assert (e_card is None and e_cpu is None) \
                or np.array_equal(e_card, e_cpu), mode
        assert out["roundtrip"] and out["on_card"]
        np.testing.assert_allclose(out["norm"], out["whole_norm"], rtol=1e-6)


def test_cuda_mesh_accumulated_step_on_one_rank_nccl(cuda, tmp_path):
    """The mesh train step with ``accum_steps=2`` on a one-rank NCCL mesh
    (every gather and reduce-scatter the identity, each microbatch's
    token share 1) against the meshless accumulated step on the card,
    reduced recurrentgemma-2b in float32 under full remat, rows with
    unequal valid tokens: the loss and metrics within 1e-6, the updated
    parameters and first moments within 1e-6 of each leaf's scale (the
    global norm sums its leaves in another order), and the same kernel
    launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths
    cfg, p_cpu = _lm("recurrentgemma-2b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 65))
    labels = toks[:, 1:].astype(np.int32)
    labels[1, :20] = -1
    batch = {"inputs": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(labels)}
    ocfg = optim.AdamWConfig(lr=1e-2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    out = {}
    try:
        meshes = {"single": None,
                  "mesh": make_mesh_compat((1, 1), ("data", "model"))}
        for name, mesh in meshes.items():
            pcfg = ParallelConfig(mesh=mesh, remat="full", fused_head=True,
                                  head_chunk=32, accum_steps=2)
            params = _to(p_cpu, cuda)
            opt = optim.init_state(params, ocfg)
            step = tstep.make_train_step(cfg, pcfg, ocfg,
                                         optim.warmup_cosine(1e-2, 2, 10))
            before = (fkernel.launches, lkernel.launches,
                      lkernel.backward_launches)
            params, opt, metrics = step(
                params, opt, _to(tstep.local_batch(batch, pcfg), cuda))
            torch.cuda.synchronize()
            out[name] = (
                {k: float(v) for k, v in metrics.items()},
                [x.cpu() for _, x in tree_flatten_with_paths(
                    {"p": params, "m": opt["m"]})],
                tuple(now - then for now, then in zip(
                    (fkernel.launches, lkernel.launches,
                     lkernel.backward_launches), before)))
    finally:
        dist.destroy_process_group()
    (gm, got, gl), (wm, want, wl) = out["mesh"], out["single"]
    assert gl == wl and gl[0] > 0 and gl[2] > 0
    assert gm["tokens"] == wm["tokens"] == (4 * 64 - 20) / 2
    for k in ("loss", "nll", "z_loss", "accuracy", "grad_norm"):
        assert abs(gm[k] - wm[k]) <= 1e-6 * max(1.0, abs(wm[k])), k
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-6 * float(w.abs().max()))
