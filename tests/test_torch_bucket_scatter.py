"""The port's bucket scatter (``repro_torch.kernels.bucket_partition`` and
the shuffle built on it) against the JAX package.

On the CPU the port's wrappers take the plain PyTorch version; they are
held against the JAX ``bucket_dest`` / ``bucket_scatter`` (Pallas in
interpret mode, as the JAX package's own tests run it) and the numpy
oracle ``bucket_scatter_ref`` on the cases ``tests/test_bucket_scatter.py``
covers.  Inputs come from one numpy seed and reach the port through
``repro_torch.convert``; the tolerance is exact equality.  Tests marked
``requires_cuda`` hold the CUDA kernel against the plain version on the
card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import shuffle as jsh
from repro.core.records import RecordBatch as JBatch
from repro.core.records import StackedBatch as JStacked
from repro.kernels.bucket_partition import bucket_dest as j_bucket_dest
from repro.kernels.bucket_partition import bucket_scatter as j_bucket_scatter
from repro.kernels.bucket_partition import bucket_scatter_ref
from repro_torch.convert import (bounds_from_numpy, record_batch_from_numpy,
                                 stacked_from_numpy)
from repro_torch.core import shuffle as tsh
from repro_torch.kernels.bucket_partition import bucket_dest, bucket_scatter
from repro_torch.kernels.bucket_partition import kernel as tkernel

PAD = 64


def _lexsorted_rows(rows):
    return rows[np.lexsort(rows.T[::-1])]


def _kernel_case(n, k, n_bounds, seed, high=4):
    """Low-entropy words force duplicate and boundary-equal keys; the
    payload carries a row counter so stability violations show."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, high, size=(n, k), dtype=np.uint32)
    bounds = _lexsorted_rows(
        rng.integers(0, high, size=(n_bounds, k), dtype=np.uint32))
    data = np.zeros((n, 8), np.uint8)
    data[:, :4] = rng.integers(0, 256, size=(n, 4), dtype=np.uint8)
    data[:, 4] = np.arange(n) % 256
    data[:, 5] = np.arange(n) // 256
    return data, keys, bounds


def _tkeys(keys):
    return torch.from_numpy(keys.astype(np.int64))


def _jax_dest(keys, bounds, n_valid, n_out, block_n):
    dest, hist = j_bucket_dest(jnp.asarray(keys), jnp.asarray(bounds),
                               jnp.asarray(n_valid), n_buckets=n_out,
                               block_n=block_n, interpret=True)
    return np.asarray(dest)[:keys.shape[0]], np.asarray(hist)


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("n_out", [2, 6, 16, 64])
@pytest.mark.parametrize("block_n", [7, 32, 101, None])
def test_dest_matches_jax(k, n_out, block_n):
    """dest and hist equal the JAX kernel's for any blocking (dest is
    fully determined by the contract), with a scalar n_valid."""
    n = 101
    data, keys, bounds = _kernel_case(n, k, n_out - 1, seed=k * n_out)
    nv = 77
    want_dest, want_hist = _jax_dest(keys, bounds, nv, n_out,
                                     block_n or n)
    dest, hist = bucket_dest(_tkeys(keys), bounds_from_numpy(bounds), nv,
                             n_buckets=n_out, block_n=block_n)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    assert sorted(dest.tolist()) == list(range(n))   # a permutation


@pytest.mark.parametrize("block_n", [16, 50, None])
def test_mask_validity_matches_jax(block_n):
    """Validity as a mask anywhere in the batch (stacked resident pieces
    keep their junk tails in place)."""
    n, n_out = 120, 5
    data, keys, bounds = _kernel_case(n, 3, n_out - 1, seed=11)
    mask = (np.random.default_rng(12).random(n) < 0.6).astype(np.int32)
    want_dest, want_hist = _jax_dest(keys, bounds, mask, n_out,
                                     block_n or n)
    dest, hist = bucket_dest(_tkeys(keys), bounds_from_numpy(bounds),
                             torch.from_numpy(mask), n_buckets=n_out,
                             block_n=block_n)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    assert int(hist.sum()) == int(mask.sum())


@pytest.mark.parametrize("n_out", [1, 3])
def test_n_out_clamp_matches_jax(n_out):
    """More boundaries than n_out - 1: overflow ids clamp onto the last
    real bucket, like the bytes reference's ``min(lo, n - 1)``."""
    n = 90
    data, keys, bounds = _kernel_case(n, 3, 8, seed=21 + n_out)
    want_dest, want_hist = _jax_dest(keys, bounds, n, n_out, 32)
    dest, hist = bucket_dest(_tkeys(keys), bounds_from_numpy(bounds), n,
                             n_buckets=n_out, block_n=32)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    np.testing.assert_array_equal(hist.numpy(), want_hist)


@pytest.mark.parametrize("block_n", [7, 32, 101])
def test_scatter_matches_jax_and_oracle(block_n):
    """Scattered bytes and hist against the JAX scatter and the numpy
    oracle (duplicate keys: stability shows in the row counter)."""
    n, nb = 101, 5
    data, keys, bounds = _kernel_case(n, 3, nb - 1, seed=block_n)
    out, hist = bucket_scatter(torch.from_numpy(data), _tkeys(keys),
                               bounds_from_numpy(bounds), n, n_buckets=nb,
                               block_n=block_n)
    j_out, j_hist = j_bucket_scatter(jnp.asarray(data), jnp.asarray(keys),
                                     jnp.asarray(bounds), n, n_buckets=nb,
                                     block_n=block_n, interpret=True)
    ref_out, ref_hist = bucket_scatter_ref(data, keys, bounds, nb)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(j_hist))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))


def test_dynamic_n_valid_reuse():
    """Rows past n_valid scatter to the tail and never enter hist."""
    data, keys, bounds = _kernel_case(128, 3, 3, seed=9)
    for nv in (128, 101, 50, 1, 0):
        out, hist = bucket_scatter(torch.from_numpy(data), _tkeys(keys),
                                   bounds_from_numpy(bounds), nv,
                                   n_buckets=4, block_n=32)
        assert int(hist.sum()) == nv
        if nv:
            ref_out, ref_hist = bucket_scatter_ref(data[:nv], keys[:nv],
                                                   bounds, 4)
            np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))
            np.testing.assert_array_equal(out.numpy()[:nv],
                                          np.asarray(ref_out))


def test_stacked_equals_per_slot():
    """The stacked form (one call over [s, n]) equals one call per slot,
    with per-slot counts and with a [s, n] mask."""
    s, n, nb = 4, 60, 6
    cases = [_kernel_case(n, 3, nb - 1, seed=70 + i) for i in range(s)]
    bounds = cases[0][2]
    data = np.stack([c[0] for c in cases])
    keys = np.stack([c[1] for c in cases])
    counts = np.array([60, 0, 33, 1], np.int32)
    out, hist = bucket_scatter(torch.from_numpy(data), _tkeys(keys),
                               bounds_from_numpy(bounds),
                               torch.from_numpy(counts), n_buckets=nb,
                               block_n=16)
    mask = np.arange(n)[None, :] < counts[:, None]
    m_out, m_hist = bucket_scatter(torch.from_numpy(data), _tkeys(keys),
                                   bounds_from_numpy(bounds),
                                   torch.from_numpy(mask), n_buckets=nb)
    for i in range(s):
        o, h = bucket_scatter(torch.from_numpy(data[i]), _tkeys(keys[i]),
                              bounds_from_numpy(bounds), int(counts[i]),
                              n_buckets=nb, block_n=16)
        np.testing.assert_array_equal(hist[i].numpy(), h.numpy())
        np.testing.assert_array_equal(m_hist[i].numpy(), h.numpy())
        c = int(counts[i])
        np.testing.assert_array_equal(out[i, :c].numpy(), o[:c].numpy())
        np.testing.assert_array_equal(m_out[i, :c].numpy(), o[:c].numpy())


def _random_records(n, rec, seed=0):
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, size=(n, rec), dtype=np.uint8).tobytes()
    return blob, [blob[i:i + rec] for i in range(0, n * rec, rec)]


def _assert_scatter_parity(records, blob, rec, part, n, **kw):
    """The port's scatter_batch pieces equal the bytes backend's buckets
    and the JAX scatter_batch's pieces."""
    kw.setdefault("pad_block", PAD)
    tpart = tsh.RangePartitioner(part.bnd) \
        if isinstance(part, jsh.RangePartitioner) else part
    tb = record_batch_from_numpy(
        np.frombuffer(blob, np.uint8).reshape(-1, rec), device="cpu")
    pieces = tsh.scatter_batch(tb, tpart, n, **kw)
    want = [[] for _ in range(max(n, 1))]
    for r in records:
        want[part(r, n)].append(r)
    assert [p.to_bytes() for p in pieces] == [b"".join(w) for w in want]
    jpieces = jsh.scatter_batch(JBatch.from_bytes(blob, rec), part, n, **kw)
    assert [p.to_bytes() for p in pieces] == [p.to_bytes() for p in jpieces]


def test_scatter_boundary_strictness_multiword():
    """Keys equal to a 3-word boundary and keys differing only in the
    zero-padded tail word, plus heavy duplicates."""
    b1 = b"\x40" * 10
    b2 = b"\x80" * 9 + b"\x00"
    part = jsh.range_partitioner([b1, b2])
    keys = ([b1] * 4 + [b1[:9] + b"\x3f"] * 3 + [b1[:9] + b"\x41"] * 3
            + [b2] * 4 + [b2[:9] + b"\x01"] * 2
            + [b"\x00" * 10] * 2 + [b"\xff" * 10] * 2)
    records = [k + bytes([i, i]) for i, k in enumerate(keys)]
    _assert_scatter_parity(records, b"".join(records), 12, part, 3)


def test_scatter_variable_length_boundaries():
    """Boundaries of differing byte lengths, one a zero-tailed prefix of
    another: the trailing length word reproduces bytes ordering."""
    bounds = [b"\x10\x20", b"\x10\x20\x00", b"\x10\x20\x00\x00\x00\x01",
              b"\x90\x10\x20\x30\x40"]
    part = jsh.range_partitioner(bounds)
    prefixes = [b"\x00\x00", b"\x10\x1f", b"\x10\x20", b"\x10\x21",
                b"\x90\x10", b"\xff\xff"]
    records = [p + bytes([i]) * 4 for i, p in enumerate(prefixes)]
    records += [b"\x10\x20\x00\x00\x00\x00", b"\x10\x20\x00\x00\x00\x01",
                b"\x90\x10\x20\x30\x40\x00"]
    _assert_scatter_parity(records, b"".join(records), 6, part, 5)


def test_scatter_stability_duplicate_keys():
    keys = [b"\x40" * 10, b"\x80" * 10, b"\x40" * 10, b"\x10" * 10]
    records = [k + bytes([i]) * 6 for i, k in enumerate(keys * 25)]
    part = jsh.range_partitioner([b"\x40" * 10, b"\x80" * 10])
    _assert_scatter_parity(records, b"".join(records), 16, part, 3)


@pytest.mark.parametrize("n_buckets", [1, 2, 5, 16])
def test_hash_scatter_matches(n_buckets):
    blob, records = _random_records(97, 100, seed=n_buckets)
    _assert_scatter_parity(records, blob, 100, jsh.hash_partitioner(8),
                           n_buckets)


@pytest.mark.parametrize("n_buckets,key_bytes", [(2, 4), (6, 10), (16, 10)])
def test_range_scatter_matches(n_buckets, key_bytes):
    blob, records = _random_records(333, 100, seed=7 * n_buckets)
    bounds = jsh.sample_boundaries(records[:200], n_buckets,
                                   key_bytes=key_bytes)
    _assert_scatter_parity(records, blob, 100,
                           jsh.range_partitioner(bounds), n_buckets)


def test_scatter_degenerate_paths():
    blob, records = _random_records(50, 10, seed=5)
    tb = record_batch_from_numpy(
        np.frombuffer(blob, np.uint8).reshape(-1, 10), device="cpu")
    (only,) = tsh.scatter_batch(tb, tsh.hash_partitioner(4), 1)
    assert only.to_bytes() == blob
    empty = tsh.scatter_batch(tsh.RecordBatch.empty(10, "cpu"),
                              tsh.hash_partitioner(4), 4)
    assert [p.num_records for p in empty] == [0] * 4
    pieces = tsh.scatter_batch(tb, tsh.reduce_partitioner(), 3)
    assert pieces[0].to_bytes() == blob
    assert [p.num_records for p in pieces[1:]] == [0, 0]
    # an arbitrary Python partitioner takes the host loop, same contract
    disp = tsh.scatter_dispatch(tb, lambda r, n: r[0] % n, 3)
    assert not disp.pending and disp.host_syncs == 1
    want = [[r for r in records if r[0] % 3 == b] for b in range(3)]
    assert [p.to_bytes() for p in disp.harvest()] == \
        [b"".join(w) for w in want]


def test_round_dispatch_matches_jax_round():
    """The fused round (stacked scatter + harvest regroup) on the port's
    plain route equals the JAX round: counts, origins and the regrouped
    bytes of every destination worker."""
    rng = np.random.default_rng(31)
    s, rows, width, nb = 5, 96, 100, 6
    data = rng.integers(0, 256, size=(s, rows, width), dtype=np.uint8)
    n_valid = np.array([96, 40, 0, 77, 5], np.int32)
    records = [data[i, j].tobytes() for i in range(s)
               for j in range(n_valid[i])]
    bounds = jsh.sample_boundaries(records, nb, key_bytes=10)
    workers = ["w0", "w1", "w2", "w3"]
    slot_workers = np.array([0, 0, 1, 2, 3])
    jres = jsh.scatter_round_dispatch(
        JStacked(jnp.asarray(data), n_valid), jsh.range_partitioner(bounds),
        nb, worker_names=workers, slot_workers=slot_workers,
        pad_block=PAD).harvest()
    rd = tsh.scatter_round_dispatch(
        stacked_from_numpy(data, n_valid, device="cpu"),
        tsh.range_partitioner(bounds), nb, worker_names=workers,
        slot_workers=slot_workers, pad_block=PAD)
    assert rd.dispatches == 1
    tres = rd.harvest()
    assert rd.host_syncs == 1
    np.testing.assert_array_equal(tres.counts, jres.counts)
    assert tres.origins == jres.origins
    jdata = [np.asarray(g) for _, g in jres.groups] if jres.groups \
        else [np.asarray(jres.data)]
    jdata = np.concatenate(jdata)
    for w in range(len(workers)):
        c = int(tres.counts[w])
        assert tres.data[w, :c].numpy().tobytes() == jdata[w, :c].tobytes()


def test_round_dispatch_ineligible_rounds():
    st = stacked_from_numpy(np.zeros((2, 8, 10), np.uint8), [3, 4],
                            device="cpu")
    for part, n in ((tsh.reduce_partitioner(), 3), (tsh.hash_partitioner(4),
                                                    1),
                    (lambda r, n: 0, 3)):
        assert tsh.scatter_round_dispatch(st, part, n,
                                          worker_names=["a", "b"]) is None


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version: any other device gets the
    kernel or an error, never the plain version."""
    keys = torch.zeros((4, 1), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucket_dest(keys, torch.zeros((1, 1), dtype=torch.int64,
                                      device="meta"), 4, n_buckets=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.bucket_dest_blocks(
            torch.zeros((1, 4, 1), dtype=torch.int64),
            torch.zeros((1, 1), dtype=torch.int64),
            torch.zeros((1,), dtype=torch.int32), None, n_out=2, bn=4)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing toolchain is a RuntimeError, not the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.build(tmp_path / "build")
    assert not any((tmp_path / "build").rglob("*.so"))


def test_kernel_build_dir(tmp_path, monkeypatch):
    """Builds land in the named directory, else in the checkout's
    build/; a package outside a checkout with none named raises."""
    monkeypatch.delenv(tkernel.BUILD_DIR_ENV, raising=False)
    assert tkernel.default_build_dir() == (tkernel.CHECKOUT / "build"
                                           / "repro_torch")
    monkeypatch.setenv(tkernel.BUILD_DIR_ENV, str(tmp_path / "b"))
    assert tkernel.default_build_dir() == tmp_path / "b"
    monkeypatch.delenv(tkernel.BUILD_DIR_ENV)
    monkeypatch.setattr(tkernel, "CHECKOUT", tmp_path / "site-packages")
    with pytest.raises(RuntimeError, match=tkernel.BUILD_DIR_ENV):
        tkernel.build()
