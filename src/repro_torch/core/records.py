"""Array-native record batches for the Sphere engine, on torch tensors.

The port of ``repro.core.records``: a ``RecordBatch`` packs fixed-size
records into one ``uint8 [n, width]`` tensor so that key extraction,
partitioning (through the ``bucket_partition`` kernel) and record
movement are single vectorised tensor operations on the device.

Conventions shared with the bytes reference path and the JAX package:

* **Range keys** are rows of big-endian 32-bit words covering a record's
  key prefix (``key_words`` — the tail word is zero-padded, and an
  optional trailing length word breaks ties exactly like Python's
  shorter-prefix-sorts-first rule).  Comparing word rows
  lexicographically is identical to comparing the byte prefixes.
* **Hash keys** are FNV-1a 32-bit over the first ``key_bytes`` bytes —
  ``fnv1a32`` is the scalar reference, ``hash_keys_u32`` the vectorised
  twin; buckets come from counting the ``uniform_hash_bounds`` below it.

Key words are carried as ``int64`` holding values in ``[0, 2**32)``:
torch on the CPU supports neither ``<`` nor ``<<`` on ``uint32``, and
int64 compares those values in the same order as uint32 would.  The
functions below take ``[..., width]`` data, so one code path serves a
2-D batch and a stacked ``[slots, rows, width]`` round alike.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

FNV_OFFSET32 = 0x811C9DC5
FNV_PRIME32 = 0x01000193
_U32 = 0xFFFFFFFF


def fnv1a32(data: bytes) -> int:
    """Scalar FNV-1a 32-bit — the reference for ``hash_keys_u32``."""
    h = FNV_OFFSET32
    for b in data:
        h = ((h ^ b) * FNV_PRIME32) & _U32
    return h


def uniform_hash_bounds(n_buckets: int) -> np.ndarray:
    """Sorted uint32 thresholds splitting hash space into n equal ranges.

    ``bucket(h) = #{i : bounds[i] < h}`` — the same "count boundaries
    below the key" rule the bucket_partition kernel computes, so one
    kernel serves both hash and range partitioning.
    """
    return np.array([(((i + 1) << 32) // n_buckets) - 1
                     for i in range(n_buckets - 1)], dtype=np.uint32)


# ------------------------------------------------------------ key views
def _be_word(d: torch.Tensor) -> torch.Tensor:
    """Big-endian int64 word of a ``[..., 4]`` uint8 tensor."""
    w = d.to(torch.int64)
    return ((w[..., 0] << 24) | (w[..., 1] << 16)
            | (w[..., 2] << 8) | w[..., 3])


def _pad_cols(d: torch.Tensor, cols: int) -> torch.Tensor:
    """``d`` with ``cols`` zero columns appended on the last axis."""
    if cols <= 0:
        return d
    return torch.cat([d, d.new_zeros(d.shape[:-1] + (cols,))], dim=-1)


def key_words_of(data: torch.Tensor, key_bytes: int) -> List[torch.Tensor]:
    """Big-endian int64 words covering the first key_bytes bytes of each
    row of ``data [..., width]``; the tail word is zero-padded so payload
    bytes past key_bytes never leak into the key."""
    kb = min(key_bytes, data.shape[-1])
    d = _pad_cols(data[..., :kb], (-kb) % 4)
    return [_be_word(d[..., i:i + 4]) for i in range(0, kb, 4)]


def key_rows_of(data: torch.Tensor, key_bytes: int, *,
                n_words: int | None = None,
                length_word: int | None = None) -> torch.Tensor:
    """``[..., k]`` int64 key rows for the multi-word kernel (see
    :meth:`RecordBatch.key_words`)."""
    words = key_words_of(data, key_bytes)
    zeros = data.new_zeros(data.shape[:-1], dtype=torch.int64)
    if n_words is not None:
        words += [zeros] * (n_words - len(words))
    if not words:
        words.append(zeros)
    if length_word is not None:
        words.append(torch.full_like(zeros, length_word))
    return torch.stack(words, dim=-1)


def hash_keys_of(data: torch.Tensor, key_bytes: int) -> torch.Tensor:
    """Vectorised FNV-1a 32-bit over the first key_bytes of each row, as
    int64 (the mask after each multiply keeps the 32-bit wrap)."""
    h = data.new_full(data.shape[:-1], FNV_OFFSET32, dtype=torch.int64)
    for j in range(min(key_bytes, data.shape[-1])):
        h = ((h ^ data[..., j].to(torch.int64)) * FNV_PRIME32) & _U32
    return h


@dataclass(frozen=True)
class RecordBatch:
    """Fixed-width records packed as a uint8 [rows, record_size] tensor.

    A batch may be *padding-resident*: ``n_valid`` (when set) says only
    the first ``n_valid`` rows are real records and the tail rows are
    shape padding whose CONTENT IS JUNK — never normalised, never
    inspected.  Every consumer of a possibly-padded batch either slices
    the valid prefix, normalises the tail to the stage's pad byte before
    a UDF sees it, or routes it to the scatter kernel's trash bucket.
    ``n_valid is None`` means every row is real.
    """

    data: torch.Tensor
    n_valid: Optional[int] = None

    def __post_init__(self):
        if self.data.ndim != 2:
            raise ValueError(f"RecordBatch data must be 2-D, "
                             f"got shape {tuple(self.data.shape)}")
        if self.n_valid is not None:
            if not 0 <= self.n_valid <= self.data.shape[0]:
                raise ValueError(f"n_valid {self.n_valid} outside "
                                 f"[0, {self.data.shape[0]}]")
            if self.n_valid == self.data.shape[0]:
                # a fully-valid batch IS an exact batch
                object.__setattr__(self, "n_valid", None)

    # ------------------------------------------------------------ shape
    @property
    def num_records(self) -> int:
        """Real (valid) records — NOT the padded row count."""
        return self.n_valid if self.n_valid is not None \
            else self.data.shape[0]

    @property
    def padded_rows(self) -> int:
        """Physical rows of the resident block, padding included."""
        return self.data.shape[0]

    @property
    def record_size(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        """Valid payload bytes — padding is free."""
        return self.num_records * self.data.shape[1]

    # ---------------------------------------------------- padding views
    @property
    def valid_data(self) -> torch.Tensor:
        """The [num_records, record_size] valid prefix (a view)."""
        return self.data if self.n_valid is None else self.data[:self.n_valid]

    def compact(self) -> "RecordBatch":
        """An exact batch holding only the valid rows (self when already
        exact)."""
        return self if self.n_valid is None \
            else RecordBatch(self.data[:self.n_valid])

    def block(self, n_rows: int) -> torch.Tensor:
        """A [n_rows, record_size] block whose first ``num_records`` rows
        are the valid records — tail content is JUNK (reused resident
        padding, or zeros when the block grows)."""
        n = self.num_records
        if n > n_rows:
            raise ValueError(f"cannot fit {n} records in a {n_rows}-row "
                             f"block")
        rows = self.data.shape[0]
        if rows >= n_rows:
            return self.data[:n_rows]
        return torch.cat([self.data,
                          self.data.new_zeros((n_rows - rows,
                                               self.record_size))])

    # ------------------------------------------------------------ codecs
    @staticmethod
    def from_bytes(blob: bytes, record_size: int,
                   device=None) -> "RecordBatch":
        """Decode ``blob`` into a batch on ``device`` (default CUDA)."""
        device = resolve_device(device)
        if record_size <= 0:
            raise ValueError("array backend needs a fixed record_size > 0")
        if len(blob) % record_size:
            raise ValueError(f"blob of {len(blob)} bytes is not a multiple "
                             f"of record_size {record_size}")
        if not blob:
            return RecordBatch.empty(record_size, device=device)
        with warnings.catch_warnings():
            # the view aliases the immutable blob only until the copy below
            warnings.simplefilter("ignore", UserWarning)
            host = torch.frombuffer(blob, dtype=torch.uint8)
        host = host.view(-1, record_size)
        data = host.clone() if device.type == "cpu" else host.to(device)
        return RecordBatch(data)

    @staticmethod
    def from_records(records: Sequence[bytes], device=None) -> "RecordBatch":
        if not records:
            raise ValueError("cannot infer record_size from zero records")
        width = len(records[0])
        if any(len(r) != width for r in records):
            raise ValueError("RecordBatch requires uniform record size")
        return RecordBatch.from_bytes(b"".join(records), width, device=device)

    def to_bytes(self) -> bytes:
        # valid rows only — padding never leaks into materialised output
        return self.valid_data.cpu().numpy().tobytes()

    def to_records(self) -> List[bytes]:
        raw = self.valid_data.cpu().numpy()
        return [raw[i].tobytes() for i in range(self.num_records)]

    # ------------------------------------------------------ restructuring
    @staticmethod
    def empty(record_size: int, device=None) -> "RecordBatch":
        return RecordBatch(torch.zeros((0, record_size), dtype=torch.uint8,
                                       device=resolve_device(device)))

    @staticmethod
    def concat(batches: Sequence["RecordBatch"]) -> "RecordBatch":
        """Concatenate valid records.  A single non-empty input returns
        ITSELF (no copy — and a padding-resident batch stays resident)."""
        if not batches:
            raise ValueError("cannot concat zero batches")
        nonempty = [b for b in batches if b.num_records]
        if not nonempty:
            return batches[0]
        if len(nonempty) == 1:
            return nonempty[0]
        return RecordBatch(torch.cat([b.valid_data for b in nonempty]))

    @staticmethod
    def concat_block(batches: Sequence["RecordBatch"], n_rows: int
                     ) -> "RecordBatch":
        """Concatenate valid records straight into an ``n_rows`` block
        (zeros tail, padding-resident).  A single non-empty input already
        at ``n_rows`` rows returns ITSELF."""
        if not batches:
            raise ValueError("cannot concat zero batches")
        nonempty = [b for b in batches if b.num_records]
        if len(nonempty) == 1 and nonempty[0].padded_rows == n_rows:
            return nonempty[0]
        nrec = sum(b.num_records for b in nonempty)
        if nrec > n_rows:
            raise ValueError(f"cannot fit {nrec} records in a {n_rows}-row "
                             f"block")
        ref = batches[0].data
        parts = [b.valid_data for b in nonempty]
        if nrec < n_rows:
            parts.append(ref.new_zeros((n_rows - nrec, ref.shape[1])))
        return RecordBatch(torch.cat(parts), n_valid=nrec)

    def take(self, idx) -> "RecordBatch":
        """Gather rows by index (valid rows form the block's prefix, so
        indices < ``num_records`` address the same records on exact and
        padding-resident batches alike)."""
        idx = torch.as_tensor(idx, device=self.data.device).to(torch.int64)
        return RecordBatch(self.data.index_select(0, idx))

    def pad_to(self, n_rows: int, pad_value: int = 0) -> "RecordBatch":
        """Right-pad with MATERIALISED ``pad_value`` rows up to ``n_rows``
        and return an exact batch."""
        n = self.num_records
        if n_rows < n:
            raise ValueError(f"cannot pad {n} records down to {n_rows}")
        if n_rows == n:
            return self.compact()
        fill = self.data.new_full((n_rows - n, self.record_size), pad_value)
        return RecordBatch(torch.cat([self.valid_data, fill]))

    # --------------------------------------------------------------- keys
    # Key views are BLOCK-level: they cover every physical row, padding
    # included (the scatter kernel trash-buckets rows past n_valid).
    def keys_u32(self, width: int = 4) -> torch.Tensor:
        """Big-endian value (int64 in [0, 2**32)) of each record's first
        ``width`` (<= 4) bytes, zero-padded."""
        w = min(width, 4, self.record_size)
        return _be_word(_pad_cols(self.data[:, :w], 4 - w))

    def hash_keys_u32(self, key_bytes: int) -> torch.Tensor:
        """Vectorised FNV-1a 32-bit over each record's first key_bytes."""
        return hash_keys_of(self.data, key_bytes)

    def key_words(self, key_bytes: int, *, n_words: int | None = None,
                  length_word: int | None = None) -> torch.Tensor:
        """[n, k] big-endian int64 key rows for the multi-word kernel.

        ``n_words`` right-pads with zero columns (aligning a batch against
        a wider boundary table); ``length_word`` appends one constant
        trailing word so variable-length boundary strings compare exactly
        like Python ``bytes``.
        """
        return key_rows_of(self.data, key_bytes, n_words=n_words,
                           length_word=length_word)

    def sort_by_key(self, key_bytes: int) -> "RecordBatch":
        """Stable sort by the full key prefix (lexicographic, any length).

        One stable sort per key word, last word first: each pass keeps
        the order of the passes before it among equal words, so the
        result is the lexicographic order with ties in input order.
        Works under ``torch.func.vmap`` (the fused stage apply)."""
        base = self.compact()
        order = None
        for w in reversed(key_words_of(base.data, key_bytes)):
            if order is not None:
                w = w.index_select(0, order)
            step = torch.sort(w, stable=True).indices
            order = step if order is None else order.index_select(0, step)
        if order is None:
            return base
        return RecordBatch(base.data.index_select(0, order))


def _pow2_rows(n: int, floor: int) -> int:
    """Smallest padded row count >= n from the {2^k, 1.5 * 2^k} ladder,
    floored at ``floor``."""
    target = max(floor, 2)
    while target < n:
        if target + target // 2 >= n:
            return target + target // 2
        target *= 2
    return target


def _quarter_rows(n: int, floor: int) -> int:
    """Smallest padded row count >= n from the quarter-octave
    {2^k, 1.25*2^k, 1.5*2^k, 1.75*2^k} ladder, floored at ``floor`` —
    the once-per-stage block shape (junk tail <= ~25%)."""
    base = max(floor, 4)
    while base * 2 < n:
        base *= 2
    if n <= base:
        return base
    for num in (5, 6, 7):
        cand = base * num // 4
        if cand >= n:
            return cand
    return base * 2


@dataclass(frozen=True)
class StackedBatch:
    """A whole round's worth of batches as ONE device tensor.

    ``data`` is uint8 [n_slots, block, width]: one slot per task/worker
    of a fused engine round, every slot padded to the same ``block`` row
    count.  ``n_valid`` is a HOST [n_slots] int32 vector of real row
    counts — slot tails are junk padding, and keeping the counts on the
    host means shape queries never touch the device.
    """

    data: torch.Tensor
    n_valid: np.ndarray

    def __post_init__(self):
        if self.data.ndim != 3:
            raise ValueError(f"StackedBatch data must be 3-D, "
                             f"got shape {tuple(self.data.shape)}")
        nv = np.asarray(self.n_valid, dtype=np.int32)
        if nv.shape != (self.data.shape[0],):
            raise ValueError(f"n_valid shape {nv.shape} != "
                             f"({self.data.shape[0]},)")
        if nv.size and (int(nv.min()) < 0
                        or int(nv.max()) > self.data.shape[1]):
            raise ValueError(f"n_valid outside [0, {self.data.shape[1]}]")
        object.__setattr__(self, "n_valid", nv)

    # ------------------------------------------------------------ shape
    @property
    def n_slots(self) -> int:
        return self.data.shape[0]

    @property
    def block_rows(self) -> int:
        return self.data.shape[1]

    @property
    def record_size(self) -> int:
        return self.data.shape[2]

    @property
    def num_records(self) -> int:
        return int(self.n_valid.sum())

    @property
    def nbytes(self) -> int:
        return self.num_records * self.record_size

    # ------------------------------------------------------- conversions
    def slot(self, i: int) -> RecordBatch:
        """Slot ``i`` as a padding-resident RecordBatch (a view)."""
        return RecordBatch(self.data[i], n_valid=int(self.n_valid[i]))

    def unpack(self) -> List[RecordBatch]:
        return [self.slot(i) for i in range(self.n_slots)]

    @staticmethod
    def pack(batches: Sequence[RecordBatch], block: int | None = None,
             pad_block: int = 4096) -> "StackedBatch":
        """Stack batches into one [s, block, width] tensor; ``block``
        defaults to the quarter-octave ladder shape of the largest batch
        (floored at ``pad_block``)."""
        if not batches:
            raise ValueError("cannot stack zero batches")
        width = batches[0].record_size
        if any(b.record_size != width for b in batches):
            raise ValueError("StackedBatch requires uniform record size")
        n_valid = np.fromiter((b.num_records for b in batches), np.int32,
                              count=len(batches))
        if block is None:
            block = _quarter_rows(max(int(n_valid.max()), 1), pad_block)
        data = torch.stack([b.block(block) for b in batches])
        return StackedBatch(data, n_valid)


def scatter_by_ids(batch: RecordBatch, ids, hist) -> List[RecordBatch]:
    """Split a batch into per-bucket batches given (ids, hist): one
    stable host argsort of the bucket ids, then one gather per bucket —
    record order within a bucket matches the bytes backend's append
    order."""
    ids_np = np.asarray(ids)
    hist_np = np.asarray(hist)
    order = np.argsort(ids_np, kind="stable")
    pieces = np.split(order, np.cumsum(hist_np)[:-1])
    return [batch.take(p) for p in pieces]
