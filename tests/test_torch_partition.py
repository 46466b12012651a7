"""The port's ids-visible partition path — the ``bucket_partition`` entry
point and ``partition_batch`` / ``shuffle_batch`` with every partitioner —
against the JAX package.

On the CPU the port's ``bucket_partition`` takes the plain version; it is
held against the JAX ``bucket_partition`` (Pallas in interpret mode, as
the JAX package's own tests run it) and the big-integer oracle
``bucket_partition_ref`` over the sweeps of ``tests/test_kernels.py``.
``partition_batch`` and ``shuffle_batch`` are held against the JAX
functions and the per-record bytes partitioners on the cases of
``tests/test_shuffle_parity.py``.  The rows entry
``bucket_partition_rows`` (the key bytes read out of the records) is held
against the JAX ``bucket_partition`` fed by the JAX package's own key
extraction, over every key layout.  Inputs come from numpy seeds; the
tolerance is exact equality (integer and byte data).  The CUDA kernel is
held against the plain version on the card in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import shuffle as jsh
from repro.core.records import RecordBatch as JBatch
from repro.kernels.bucket_partition import bucket_partition as j_partition
from repro.kernels.bucket_partition import bucket_partition_ref as j_oracle
from repro_torch.convert import bounds_from_numpy, record_batch_from_numpy
from repro_torch.core import shuffle as tsh
from repro_torch.core.records import RecordBatch, scatter_by_ids
from repro_torch.core.records import extract_keys
from repro_torch.kernels.bucket_partition import (bucket_partition,
                                                  bucket_partition_ref,
                                                  bucket_partition_rows,
                                                  bucket_partition_rows_ref)
from repro_torch.kernels.bucket_partition import kernel as tkernel


def _tkeys(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def _both(keys, bounds, nb, bn):
    """(port ids, port hist, JAX ids, JAX hist) as int64 numpy arrays."""
    ids, hist = bucket_partition(_tkeys(keys), bounds_from_numpy(bounds),
                                 n_buckets=nb, block_n=bn)
    j_ids, j_hist = j_partition(jnp.asarray(keys), jnp.asarray(bounds),
                                n_buckets=nb, block_n=bn, interpret=True)
    assert ids.dtype == hist.dtype == torch.int32
    return (ids.numpy().astype(np.int64), hist.numpy().astype(np.int64),
            np.asarray(j_ids, np.int64), np.asarray(j_hist, np.int64))


@pytest.mark.parametrize("N,nb,bn", [(100, 4, 32), (2048, 16, 512),
                                     (777, 8, 256)])
def test_bucket_partition_sweep(N, nb, bn):
    rng = np.random.default_rng(N)
    keys = rng.integers(0, 1 << 30, size=N, dtype=np.uint32)
    bounds = np.sort(rng.integers(0, 1 << 30, size=nb - 1, dtype=np.uint32))
    ids, hist, j_ids, j_hist = _both(keys, bounds, nb, bn)
    r_ids, r_hist = j_oracle(keys, bounds, nb)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(hist, j_hist)
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    np.testing.assert_array_equal(hist, np.asarray(r_hist))
    assert int(hist.sum()) == N


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("N,nb,bn", [(100, 4, 32), (777, 8, 256)])
def test_bucket_partition_multiword_sweep(N, nb, bn, k):
    """Low word entropy (values 0..3) forces prefix ties, so later words
    and the strict-< rule decide buckets."""
    rng = np.random.default_rng(7 + k)
    keys = rng.integers(0, 4, size=(N, k), dtype=np.uint32)
    bounds = rng.integers(0, 4, size=(nb - 1, k), dtype=np.uint32)
    bounds = bounds[np.lexsort(bounds.T[::-1])]
    ids, hist, j_ids, j_hist = _both(keys, bounds, nb, bn)
    r_ids, r_hist = j_oracle(keys, bounds, nb)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(hist, j_hist)
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    np.testing.assert_array_equal(hist, np.asarray(r_hist))


def test_bucket_partition_equal_keys_are_strict():
    bounds = np.array([10, 20], np.uint32)
    keys = np.array([10, 20, 9, 11, 21], np.uint32)
    ids, _, j_ids, _ = _both(keys, bounds, 3, 8)
    assert ids.tolist() == j_ids.tolist() == [0, 1, 0, 1, 2]
    bounds2 = np.array([[1, 10], [1, 20]], np.uint32)
    keys2 = np.array([[1, 10], [1, 20], [0, 99], [1, 11], [2, 0]], np.uint32)
    ids2, _, j_ids2, _ = _both(keys2, bounds2, 3, 8)
    assert ids2.tolist() == j_ids2.tolist() == [0, 1, 0, 1, 2]


def test_bucket_partition_word_count_mismatch():
    with pytest.raises(ValueError, match="words per row"):
        bucket_partition(torch.zeros((4, 2), dtype=torch.int64),
                         torch.zeros((3, 3), dtype=torch.int64), n_buckets=4)


@pytest.mark.parametrize("nb", [2, 3, 4])
def test_bucket_partition_extra_boundary_rows(nb):
    """More boundary rows than ``n_buckets - 1``: the JAX kernel's
    boundary block holds only the first ``n_buckets - 1`` rows, so the
    rest take no part, and no id reaches ``n_buckets``."""
    keys = np.arange(0, 40, 5, dtype=np.uint32)
    bounds = np.array([10, 20, 30], np.uint32)
    ids, hist, j_ids, j_hist = _both(keys, bounds, nb, 4)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(hist, j_hist)
    assert ids.max() == nb - 1 and int(hist.sum()) == keys.size


def test_bucket_partition_refuses_short_tables_and_one_bucket():
    """Fewer boundary rows than ``n_buckets - 1`` would make the TPU
    kernel read past the table, and one bucket leaves it no boundary
    block: the port raises for both (the JAX function returns undefined
    ids for the first and fails to launch the second)."""
    keys = torch.arange(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="boundary rows"):
        bucket_partition(keys, torch.tensor([3, 5]), n_buckets=6)
    with pytest.raises(ValueError, match="boundary rows"):
        bucket_partition(keys, torch.tensor([3, 5]), n_buckets=1)


def test_bucket_partition_no_rows():
    """No rows: empty ids and a zero histogram (the JAX function cannot
    launch a zero-row grid)."""
    ids, hist = bucket_partition(torch.zeros((0, 3), dtype=torch.int64),
                                 torch.zeros((5, 3), dtype=torch.int64),
                                 n_buckets=6)
    assert ids.shape == (0,) and hist.tolist() == [0] * 6


def test_plain_version_counts_overflow_ids_in_no_bin():
    """The kernel's contract at its own level: ids are not clamped, and an
    id of ``n_buckets`` or more is counted in no bin."""
    keys = _tkeys(np.arange(0, 40, 5)[:, None])
    bounds = _tkeys(np.array([[10], [20], [30]]))
    ids, hist = bucket_partition_ref(keys, bounds, 2)
    assert ids.tolist() == [0, 0, 0, 1, 1, 2, 2, 3]
    assert hist.tolist() == [3, 2]


def test_wrappers_refuse_other_devices():
    keys = torch.zeros((4, 1), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucket_partition(keys, torch.zeros((1, 1), dtype=torch.int64,
                                           device="meta"), n_buckets=2)
    before = tkernel.partition_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.bucket_partition_ids(torch.zeros((4, 1), dtype=torch.int64),
                                     torch.zeros((1, 1), dtype=torch.int64),
                                     n_buckets=2, bn=4)
    assert tkernel.partition_launches == before


def test_partition_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.build_partition(tmp_path / "build")
    assert not any((tmp_path / "build").rglob("*.so"))


# ------------------------------------------------------ the rows entry
ROW_SPECS = [("range", 4, 1, None), ("range", 4, 1, 4), ("range", 8, 2, None),
             ("range", 10, 3, None), ("range", 10, 3, 10),
             ("range", 6, 3, None), ("range", 16, 4, 16),
             ("range", 20, 5, None), ("range", 12, 3, 12)]


def _rows_both(data, spec, nb, bounds=None):
    """(port ids, port hist) of ``bucket_partition_rows`` on the CPU, and
    the JAX ``bucket_partition`` (interpret mode) over the JAX package's
    own key extraction, with its oracle, as int64 numpy arrays; the bounds
    default to ``nb - 1`` of the records' own keys, sorted."""
    j_keys = np.asarray(jsh._extract_keys(jnp.asarray(data), spec))
    if bounds is None:
        rng = np.random.default_rng(nb)
        pick = j_keys[rng.integers(0, len(j_keys), nb - 1)]
        bounds = pick[np.lexsort(pick.reshape(nb - 1, -1).T[::-1])]
    ids, hist = bucket_partition_rows(torch.from_numpy(data), spec,
                                      bounds_from_numpy(bounds),
                                      n_buckets=nb)
    assert ids.dtype == hist.dtype == torch.int32
    j_ids, j_hist = j_partition(jnp.asarray(j_keys), jnp.asarray(bounds),
                                n_buckets=nb, block_n=128, interpret=True)
    r_ids, r_hist = j_oracle(j_keys, bounds, nb)
    for port, *others in ((ids, j_ids, r_ids), (hist, j_hist, r_hist)):
        for other in others:
            np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                          np.asarray(other, np.int64))
    return ids, hist, bounds


@pytest.mark.parametrize("spec", ROW_SPECS, ids=str)
@pytest.mark.parametrize("width", [100, 13, 7])
def test_bucket_partition_rows_range_parity(spec, width):
    """Range keys of 1-5 words, with and without the length word, a key
    longer than the record (clipped to it), low-entropy bytes so that
    boundaries tie with keys."""
    data = np.random.default_rng(width).integers(0, 2, (301, width),
                                                 dtype=np.uint8)
    for nb in (2, 6):
        ids, hist, bounds = _rows_both(data, spec, nb)
        want = bucket_partition_ref(extract_keys(torch.from_numpy(data),
                                                 spec),
                                    bounds_from_numpy(bounds), nb)
        assert torch.equal(ids, want[0]) and torch.equal(hist, want[1])


@pytest.mark.parametrize("key_bytes", [4, 8, 10])
@pytest.mark.parametrize("width", [100, 13, 7])
def test_bucket_partition_rows_hash_parity(key_bytes, width):
    data = np.random.default_rng(key_bytes).integers(0, 256, (301, width),
                                                     dtype=np.uint8)
    from repro_torch.core.records import uniform_hash_bounds
    for nb in (2, 7):
        ids, hist, _ = _rows_both(data, ("hash", key_bytes), nb,
                                  uniform_hash_bounds(nb))
        assert int(hist.sum()) == len(data)


def test_bucket_partition_rows_plain_version_and_views():
    """The entry point equals its plain version, also on a view whose
    storage offset is not 4-aligned; no rows give empty ids and a zero
    histogram; one row works."""
    spec = ("range", 10, 3, 10)
    flat = torch.from_numpy(np.random.default_rng(3).integers(
        0, 3, 1 + 200 * 100, dtype=np.uint8))
    view = flat[1:].view(200, 100)
    assert view.storage_offset() == 1
    bounds = extract_keys(view, spec)[::40].contiguous()
    got = bucket_partition_rows(view, spec, bounds, n_buckets=6)
    want = bucket_partition_rows_ref(view.contiguous(), spec, bounds, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ids, hist = bucket_partition_rows(view[:0], spec, bounds, n_buckets=6)
    assert ids.shape == (0,) and hist.tolist() == [0] * 6
    ids, hist = bucket_partition_rows(view[:1], spec, bounds, n_buckets=6)
    assert ids.tolist() == bucket_partition_ref(
        extract_keys(view[:1], spec), bounds[:5], 6)[0].tolist()


def test_bucket_partition_rows_refusals():
    data = torch.zeros((8, 12), dtype=torch.uint8)
    with pytest.raises(ValueError, match="words per row"):
        bucket_partition_rows(data, ("range", 10, 3, 10),
                              torch.zeros((3, 3), dtype=torch.int64),
                              n_buckets=4)
    with pytest.raises(ValueError, match="boundary rows"):
        bucket_partition_rows(data, ("hash", 4), torch.tensor([3, 5]),
                              n_buckets=6)
    with pytest.raises(ValueError, match="uint8"):
        bucket_partition_rows(data.to(torch.int32), ("hash", 4),
                              torch.tensor([3]), n_buckets=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucket_partition_rows(data.to("meta"), ("hash", 4),
                              torch.tensor([3], device="meta"), n_buckets=2)
    before = tkernel.rows_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.bucket_partition_rows(data, ("hash", 4),
                                      torch.zeros((1, 1), dtype=torch.int64),
                                      n_buckets=2)
    assert tkernel.rows_launches == before


@pytest.mark.parametrize("spec", ROW_SPECS + [("hash", 4), ("hash", 0)],
                         ids=str)
@pytest.mark.parametrize("width", [100, 13, 7])
def test_key_layout_matches_the_key_rows(spec, width):
    """The layout the rows kernel builds in registers has as many words as
    the key rows of ``records.extract_keys``."""
    data = torch.zeros((2, width), dtype=torch.uint8)
    hash_, kb, nkw, k, length = tkernel.key_layout(spec, width)
    assert k == extract_keys(data, spec).shape[1]
    assert kb <= width and nkw * 4 >= kb and hash_ == (spec[0] == "hash")


# ------------------------------------------- partition_batch / shuffle_batch
def _random_records(n, rec, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(n, rec), dtype=np.uint8)
    blob = data.tobytes()
    return blob, [blob[i:i + rec] for i in range(0, n * rec, rec)]


def _assert_parity(records, blob, rec, part, n, j_part=None, **kw):
    """Port ids/hist equal the JAX package's and the per-record bytes
    partitioner's, and shuffle_batch's pieces keep the bytes backend's
    append order, byte for byte against the JAX shuffle_batch."""
    j_part = part if j_part is None else j_part
    batch = RecordBatch.from_bytes(blob, rec, device="cpu")
    ids, hist = tsh.partition_batch(batch, part, n, **kw)
    j_batch = JBatch.from_bytes(blob, rec)
    j_ids, j_hist = jsh.partition_batch(j_batch, j_part, n)
    ref = [part(r, n) for r in records]
    assert ids.device == batch.device and ids.dtype == torch.int32
    assert ids.tolist() == np.asarray(j_ids).tolist() == ref
    assert hist.tolist() == np.asarray(j_hist).tolist() \
        == [ref.count(i) for i in range(n)]
    pieces = tsh.shuffle_batch(batch, part, n, **kw)
    j_pieces = jsh.shuffle_batch(j_batch, j_part, n)
    assert [p.to_bytes() for p in pieces] == \
        [p.to_bytes() for p in j_pieces] == \
        [b"".join(r for r, b in zip(records, ref) if b == i)
         for i in range(n)]
    assert [p.to_bytes() for p in scatter_by_ids(batch, ids, hist)] == \
        [p.to_bytes() for p in pieces]


@pytest.mark.parametrize("n_buckets", [1, 2, 5, 16])
@pytest.mark.parametrize("n_records,record_size", [
    (1, 8), (97, 100), (256, 12), (1000, 100)])
def test_hash_partitioner_parity(n_records, record_size, n_buckets):
    blob, records = _random_records(n_records, record_size,
                                    seed=n_records + n_buckets)
    _assert_parity(records, blob, record_size, tsh.hash_partitioner(8),
                   n_buckets, jsh.hash_partitioner(8))


@pytest.mark.parametrize("key_bytes", [4, 10])
@pytest.mark.parametrize("n_buckets", [1, 2, 6, 16])
@pytest.mark.parametrize("n_records,record_size", [
    (1, 8), (97, 100), (333, 10), (1000, 100)])
def test_range_partitioner_parity(n_records, record_size, n_buckets,
                                  key_bytes):
    blob, records = _random_records(n_records, record_size,
                                    seed=7 * n_records + n_buckets)
    bounds = tsh.sample_boundaries(records[:200], n_buckets,
                                   key_bytes=key_bytes)
    assert bounds == jsh.sample_boundaries(records[:200], n_buckets,
                                           key_bytes=key_bytes)
    _assert_parity(records, blob, record_size, tsh.range_partitioner(bounds),
                   n_buckets, jsh.range_partitioner(bounds))


@pytest.mark.parametrize("key_bytes", [4, 10])
def test_padded_tail_blocks(key_bytes):
    """Any block size gives the same ids: block_n is the kernel's tiling
    only (and a padding-resident batch partitions its valid rows)."""
    n, rec, nb = 101, 16, 4
    blob, records = _random_records(n, rec, seed=3 + key_bytes)
    if key_bytes == 4:
        part, j_part = tsh.hash_partitioner(4), jsh.hash_partitioner(4)
    else:
        bounds = tsh.sample_boundaries(records, nb, key_bytes=key_bytes)
        part = tsh.range_partitioner(bounds)
        j_part = jsh.range_partitioner(bounds)
    for block_n in (7, 32, 100, 101, 4096):
        _assert_parity(records, blob, rec, part, nb, j_part, block_n=block_n)
    data = np.frombuffer(blob, np.uint8).reshape(n, rec)
    padded = record_batch_from_numpy(np.concatenate([data, data[:27]]),
                                     n_valid=n, device="cpu")
    ids, hist = tsh.partition_batch(padded, part, nb)
    assert ids.tolist() == [part(r, nb) for r in records]


def test_single_bucket_short_circuits():
    blob, records = _random_records(50, 10, seed=5)
    batch = RecordBatch.from_bytes(blob, 10, device="cpu")
    before = tkernel.partition_launches, tkernel.rows_launches
    for part in (tsh.hash_partitioner(4), tsh.range_partitioner([]),
                 tsh.reduce_partitioner()):
        ids, hist = tsh.partition_batch(batch, part, 1)
        assert ids.tolist() == [0] * 50 and hist.tolist() == [50]
    ids, hist = tsh.partition_batch(batch, tsh.reduce_partitioner(), 4)
    assert ids.tolist() == [0] * 50 and hist.tolist() == [50, 0, 0, 0]
    ids, hist = tsh.partition_batch(batch, tsh.range_partitioner([]), 4)
    assert ids.tolist() == [0] * 50 and hist.tolist() == [50, 0, 0, 0]
    assert (tkernel.partition_launches, tkernel.rows_launches) == before


def test_duplicate_and_boundary_keys():
    bounds = [b"\x40\x00\x00\x00", b"\x80\x00\x00\x00"]
    keys = ([b"\x40\x00\x00\x00"] * 5 + [b"\x3f\xff\xff\xff"] * 3
            + [b"\x80\x00\x00\x00"] * 4 + [b"\x80\x00\x00\x01"] * 2
            + [b"\x00\x00\x00\x00"] * 2 + [b"\xff\xff\xff\xff"] * 2)
    records = [k + b"pad-data" for k in keys]
    _assert_parity(records, b"".join(records), 12,
                   tsh.range_partitioner(bounds), 3,
                   jsh.range_partitioner(bounds))


def test_duplicate_and_boundary_keys_multiword():
    b1 = b"\x40" * 10
    b2 = b"\x80" * 9 + b"\x00"
    keys = ([b1] * 4 + [b1[:9] + b"\x3f"] * 3 + [b1[:9] + b"\x41"] * 3
            + [b2] * 4 + [b2[:9] + b"\x01"] * 2
            + [b"\x00" * 10] * 2 + [b"\xff" * 10] * 2)
    records = [k + b"pp" for k in keys]
    _assert_parity(records, b"".join(records), 12,
                   tsh.range_partitioner([b1, b2]), 3,
                   jsh.range_partitioner([b1, b2]))


def test_more_boundaries_than_buckets_clamp():
    """Boundaries for 8 buckets used with 3: the overflow buckets clamp
    onto the last one and their counts fold into its histogram bin."""
    blob, records = _random_records(300, 12, seed=31)
    bounds = tsh.sample_boundaries(records, 8, key_bytes=10)
    _assert_parity(records, blob, 12, tsh.range_partitioner(bounds), 3,
                   jsh.range_partitioner(bounds))


def test_variable_length_boundaries_exact():
    bounds = [b"\x10\x20", b"\x10\x20\x00", b"\x10\x20\x00\x00\x00\x01",
              b"\x90\x10\x20\x30\x40"]
    prefixes = [b"\x00\x00", b"\x10\x1f", b"\x10\x20", b"\x10\x21",
                b"\x90\x10", b"\xff\xff"]
    records = [p + bytes([i]) * 4 for i, p in enumerate(prefixes)]
    records += [b"\x10\x20\x00\x00\x00\x00", b"\x10\x20\x00\x00\x00\x01",
                b"\x90\x10\x20\x30\x40\x00"]
    _assert_parity(records, b"".join(records), 6,
                   tsh.range_partitioner(bounds), 5,
                   jsh.range_partitioner(bounds))


def test_records_shorter_than_boundaries():
    bounds = [b"\x20\x20\x20\x20\x00\x00", b"\x80\x80\x80\x80\x80\x80"]
    records = [b"\x20\x20\x20\x20", b"\x20\x20\x20\x21", b"\x00\x00\x00\x00",
               b"\x80\x80\x80\x80", b"\xff\xff\xff\xff"]
    _assert_parity(records, b"".join(records), 4,
                   tsh.range_partitioner(bounds), 3,
                   jsh.range_partitioner(bounds))


def test_custom_callable_partitioner_fallback():
    """Arbitrary Python partitioners take the host loop: no kernel."""
    blob, records = _random_records(40, 8, seed=9)

    def part(r, n):
        return r[0] % n
    before = tkernel.partition_launches
    _assert_parity(records, blob, 8, part, 3)
    assert tkernel.partition_launches == before


def test_kernel_inputs_match_jax():
    """The word rows the kernels compare are the JAX package's."""
    blob, records = _random_records(64, 20, seed=13)
    batch = RecordBatch.from_bytes(blob, 20, device="cpu")
    j_batch = JBatch.from_bytes(blob, 20)
    bounds = tsh.sample_boundaries(records, 6, key_bytes=10) + [b"\x7f"]
    for part, j_part in ((tsh.hash_partitioner(8), jsh.hash_partitioner(8)),
                         (tsh.range_partitioner(sorted(bounds)),
                          jsh.range_partitioner(sorted(bounds)))):
        keys, bwords = part.kernel_inputs(batch, 6)
        j_keys, j_bwords = j_part.kernel_inputs(j_batch, 6)
        np.testing.assert_array_equal(keys.numpy(),
                                      np.asarray(j_keys).astype(np.int64))
        np.testing.assert_array_equal(bwords, j_bwords)


def test_build_key_covers_shared_header(tmp_path):
    """Both bucket sources share one key over every file of ``csrc/``, so
    an edit to the shared compare header rebuilds both."""
    import shutil

    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(tkernel.CSRC, csrc)
    key = _build.source_key(csrc / "bucket_dest.cu")
    assert key == _build.source_key(csrc / "bucket_partition.cu")
    header = csrc / "compare.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.source_key(csrc / "bucket_dest.cu") != key
