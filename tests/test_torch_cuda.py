"""The port's CUDA kernel on the card: ``bucket_dest`` against its plain
PyTorch version, and TeraSort through ``SphereEngine(device="cuda")``
against the same job on the CPU.

Every test here needs a CUDA device and skips itself without one (the
check runs inside the ``cuda`` fixture, never at import).  The module
imports neither JAX nor ``tests/conftest.py``'s helpers, so on a machine
with a card and no JAX it runs as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerance: exact equality (integer and byte data).
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.sector as tsector
from repro_torch.core import shuffle as tsh
from repro_torch.kernels.bucket_partition import (bucket_blocks_ref,
                                                  bucket_scatter)
from repro_torch.kernels.bucket_partition import kernel as tkernel

pytestmark = pytest.mark.requires_cuda
REC = 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
