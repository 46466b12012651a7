"""Parity of the port's record layer (``repro_torch.core.records``) with
the JAX package's ``repro.core.records``.

The same numpy inputs, made from one seed, go through both packages on
the CPU — the port's through ``repro_torch.convert`` — and every key
view, sort and shape ladder must agree exactly (integer and byte data:
the tolerance is equality)."""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import records as jrec
from repro_torch.convert import record_batch_from_numpy, stacked_from_numpy
from repro_torch.core import records as trec


def _rows(n, width, seed, high=256):
    rng = np.random.default_rng(seed)
    return rng.integers(0, high, size=(n, width), dtype=np.uint8)


def _both(data, n_valid=None):
    return (jrec.RecordBatch(jnp.asarray(data), n_valid=n_valid),
            record_batch_from_numpy(data, n_valid, device="cpu"))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("key_bytes", [1, 3, 4, 7, 10, 16])
@pytest.mark.parametrize("n_words,length_word", [(None, None), (5, None),
                                                 (None, 10), (6, 7)])
def test_key_words_match(key_bytes, n_words, length_word):
    data = _rows(37, 12, seed=key_bytes)
    jb, tb = _both(data)
    want = jb.key_words(key_bytes, n_words=n_words, length_word=length_word)
    got = tb.key_words(key_bytes, n_words=n_words, length_word=length_word)
    assert got.dtype.is_floating_point is False
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("key_bytes", [0, 1, 4, 8, 10, 20])
def test_hash_keys_match(key_bytes):
    data = _rows(53, 12, seed=100 + key_bytes)
    jb, tb = _both(data)
    np.testing.assert_array_equal(tb.hash_keys_u32(key_bytes).numpy(),
                                  _np(jb.hash_keys_u32(key_bytes)))
    # the scalar reference agrees row by row
    for r in range(5):
        assert int(tb.hash_keys_u32(key_bytes)[r]) == trec.fnv1a32(
            data[r, :key_bytes].tobytes())


@pytest.mark.parametrize("width", [1, 2, 3, 4, 6])
def test_keys_u32_match(width):
    data = _rows(29, 3, seed=width)   # record narrower than some widths
    jb, tb = _both(data)
    np.testing.assert_array_equal(tb.keys_u32(width).numpy(),
                                  _np(jb.keys_u32(width)))


def test_uniform_hash_bounds_and_fnv_match():
    for n in (1, 2, 5, 16):
        np.testing.assert_array_equal(trec.uniform_hash_bounds(n),
                                      jrec.uniform_hash_bounds(n))
    for blob in (b"", b"a", b"sphere", bytes(range(40))):
        assert trec.fnv1a32(blob) == jrec.fnv1a32(blob)


@pytest.mark.parametrize("key_bytes", [1, 4, 10, 12])
def test_sort_by_key_duplicates_and_ff_padding(key_bytes):
    """Low-entropy keys force duplicate keys (ties keep input order) and
    all-0xFF rows stand in for normalised padding, which must sort last
    — after any real all-0xFF key, in input order."""
    data = _rows(300, 16, seed=key_bytes, high=3)
    data[:, key_bytes:] = np.arange(300, dtype=np.uint16)[:, None] % 251
    data[::7, :key_bytes] = 0xFF
    jb, tb = _both(data)
    want = np.asarray(jb.sort_by_key(key_bytes).data)
    got = tb.sort_by_key(key_bytes).data.numpy()
    np.testing.assert_array_equal(got, want)


def test_sort_by_key_padding_resident_batch():
    """A padding-resident batch sorts its valid prefix only: the junk
    tail never interleaves."""
    data = _rows(64, 12, seed=5)
    jb, tb = _both(data, n_valid=40)
    got = tb.sort_by_key(10)
    assert got.num_records == 40
    np.testing.assert_array_equal(got.data.numpy(),
                                  np.asarray(jb.sort_by_key(10).data))


def test_row_ladders_match():
    for floor in (1, 4, 64, 256, 4096):
        for n in list(range(0, 300)) + [4095, 4096, 4097, 5000, 640000,
                                        1_000_003]:
            assert trec._pow2_rows(n, floor) == jrec._pow2_rows(n, floor)
            assert trec._quarter_rows(n, floor) == jrec._quarter_rows(n,
                                                                      floor)


def test_stacked_pack_unpack_match():
    counts = [50, 0, 17, 64, 3]
    jbs, tbs = [], []
    for i, c in enumerate(counts):
        jb, tb = _both(_rows(c, 10, seed=40 + i))
        jbs.append(jb)
        tbs.append(tb)
    for block in (None, 64, 100):
        js = jrec.StackedBatch.pack(jbs, block=block, pad_block=16)
        ts = trec.StackedBatch.pack(tbs, block=block, pad_block=16)
        np.testing.assert_array_equal(ts.n_valid, js.n_valid)
        np.testing.assert_array_equal(ts.data.numpy(), np.asarray(js.data))
        for jsl, tsl in zip(js.unpack(), ts.unpack()):
            assert tsl.num_records == jsl.num_records
            assert tsl.to_bytes() == jsl.to_bytes()


def test_stacked_from_numpy_slots():
    data = _rows(3 * 8, 6, seed=9).reshape(3, 8, 6)
    st = stacked_from_numpy(data, [8, 2, 0], device="cpu")
    assert st.num_records == 10 and st.nbytes == 60
    assert st.slot(1).to_bytes() == data[1, :2].tobytes()
    assert st.slot(2).num_records == 0


def test_restructuring_matches():
    """concat / concat_block / block / take / pad_to / compact agree with
    the reference on padding-resident inputs."""
    a, b = _rows(20, 8, seed=1), _rows(30, 8, seed=2)
    ja, ta = _both(a, n_valid=12)
    jb, tb = _both(b)
    assert trec.RecordBatch.concat([ta, tb]).to_bytes() == \
        jrec.RecordBatch.concat([ja, jb]).to_bytes()
    assert trec.RecordBatch.concat([ta]) is ta
    tcb = trec.RecordBatch.concat_block([ta, tb], 64)
    jcb = jrec.RecordBatch.concat_block([ja, jb], 64)
    assert tcb.num_records == jcb.num_records == 42
    np.testing.assert_array_equal(tcb.data.numpy(), np.asarray(jcb.data))
    for rows in (12, 16, 40):
        np.testing.assert_array_equal(ta.block(rows).numpy()[:12],
                                      np.asarray(ja.block(rows))[:12])
        assert ta.block(rows).shape == ja.block(rows).shape
    idx = np.array([3, 0, 11, 3])
    assert ta.take(idx).to_bytes() == ja.take(idx).to_bytes()
    assert ta.pad_to(16, 0xAB).to_bytes() == ja.pad_to(16, 0xAB).to_bytes()
    assert ta.compact().to_bytes() == ja.compact().to_bytes()
    assert ta.nbytes == ja.nbytes and ta.padded_rows == ja.padded_rows


def test_scatter_by_ids_matches():
    data = _rows(40, 6, seed=3)
    jb, tb = _both(data)
    ids = np.random.default_rng(4).integers(0, 4, size=40).astype(np.int32)
    hist = np.bincount(ids, minlength=4).astype(np.int32)
    got = [p.to_bytes() for p in trec.scatter_by_ids(tb, ids, hist)]
    want = [p.to_bytes() for p in jrec.scatter_by_ids(jb, ids, hist)]
    assert got == want


def test_from_bytes_round_trip_and_default_device(monkeypatch):
    blob = _rows(9, 10, seed=6).tobytes()
    tb = trec.RecordBatch.from_bytes(blob, 10, device="cpu")
    assert tb.to_bytes() == blob and tb.to_records()[2] == blob[20:30]
    assert trec.RecordBatch.from_bytes(b"", 10, device="cpu").num_records == 0
    with pytest.raises(ValueError):
        trec.RecordBatch.from_bytes(blob[:-1], 10, device="cpu")
    # the default device is CUDA, and its absence is an error — never a
    # silent move to the CPU
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trec.RecordBatch.from_bytes(blob, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        record_batch_from_numpy(_rows(2, 2, seed=0))
