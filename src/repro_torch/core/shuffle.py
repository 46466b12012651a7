"""Partitioners for the Sphere shuffle — bytes reference + array backend.

The port of ``repro.core.shuffle``.  Each partitioner is a callable
``(record: bytes, n: int) -> int`` (the bytes reference path, unchanged
engine protocol) and additionally exposes

* ``kernel_inputs(batch, n)`` — the (keys, bounds) word rows the bucket
  kernels compare;
* ``bucket_ids(batch, n)`` — ids + histogram via the
  ``bucket_partition_rows`` kernel, which reads the key bytes out of the
  records (the analysis path: :func:`partition_batch` /
  :func:`shuffle_batch`, where the ids come back to the caller);
* ``scatter_spec(batch, n)`` — the static key spec and boundary words the
  device scatter compares.

* :func:`scatter_dispatch` / :func:`scatter_batch` — the per-worker
  engine shuffle: the ``bucket_scatter`` kernel lands records
  bucket-contiguously ON DEVICE (stable counting scatter), and the only
  host sync is the final [n] histogram that slices the result into
  per-bucket batches.  ``scatter_dispatch`` enqueues that work and defers
  the histogram sync into :meth:`ScatterDispatch.harvest`, so a caller
  shuffling many batches pays ONE barrier per shuffle round.
* :func:`scatter_round_dispatch` — the fused round: every slot of a
  stacked stage output scattered by ONE kernel launch, then one
  regrouping gather onto destination workers at harvest.

The kernel's rule is ``bucket = #{i : bounds[i] < key}``; both
partitioners phrase their bytes-side decision with exactly that rule so
the two paths agree record-for-record.  Of the reference's two round
lowerings only the stacked one is ported: it runs the CUDA kernel on the
card and the plain version on the CPU.  (The reference's "segmented +
host invert" lowering exists only for XLA:CPU's costs.)
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.records import (RecordBatch, StackedBatch,  # noqa: F401
                                      _pow2_rows, _quarter_rows, extract_keys,
                                      fnv1a32, hash_keys_of, key_rows_of,
                                      scatter_by_ids, uniform_hash_bounds)
from repro_torch.kernels.bucket_partition import (bucket_partition_rows,
                                                  bucket_scatter)


def _all_in_bucket0(nrec: int, n: int, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, hist) that put all ``nrec`` records in bucket 0 of ``n``."""
    ids = torch.zeros((nrec,), dtype=torch.int32, device=device)
    hist = torch.zeros((max(n, 1),), dtype=torch.int32, device=device)
    hist[0] = nrec
    return ids, hist


def _kernel_partition(data: torch.Tensor, key_spec, bounds_u32: np.ndarray,
                      n: int, *, block_n: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bucket_partition_rows over the records ``data [N, width]`` with
    degenerate-shape handling.

    ``key_spec`` is the partitioner's static key spec and ``bounds_u32``
    its boundary words, ``[n_bounds]`` or ``[n_bounds, k]``.  The kernel
    needs at least one boundary; n == 1 (or an empty boundary list) means
    every record lands in bucket 0.  When there are more boundaries than
    n - 1 the tail buckets are clamped onto n - 1, mirroring the
    ``min(lo, n - 1)`` in the bytes reference.  Returns ``(ids [N] int32,
    hist [n] int32)`` on the records' device.
    """
    nrec = data.shape[0]
    if nrec == 0 or n <= 1 or len(bounds_u32) == 0:
        return _all_in_bucket0(nrec, n, data.device)
    nb = len(bounds_u32) + 1
    ids, hist = bucket_partition_rows(
        data, key_spec, _bounds_tensor(bounds_u32, data.device),
        n_buckets=nb, block_n=block_n)
    if nb > n:  # clamp overflow buckets, fold their histogram tail
        ids = ids.clamp_max(n - 1)
        tail = hist[n - 1:].sum().to(torch.int32)
        hist = hist[:n].clone()
        hist[n - 1] = tail
    return ids, hist


class HashPartitioner:
    """FNV-1a hash of the first ``key_bytes`` bytes -> uniform bucket."""

    def __init__(self, key_bytes: int = 8):
        self.key_bytes = key_bytes
        self._bounds: Dict[int, List[int]] = {}

    def _bounds_for(self, n: int) -> List[int]:
        if n not in self._bounds:
            self._bounds[n] = uniform_hash_bounds(n).tolist()
        return self._bounds[n]

    def __call__(self, record: bytes, n: int) -> int:
        h = fnv1a32(record[:self.key_bytes])
        return bisect_left(self._bounds_for(n), h)

    def kernel_inputs(self, batch: RecordBatch, n: int
                      ) -> Tuple[torch.Tensor, np.ndarray]:
        """(keys, bounds) word rows for the bucket kernels."""
        return batch.hash_keys_u32(self.key_bytes), uniform_hash_bounds(n)

    def scatter_spec(self, batch: RecordBatch, n: int):
        """(static key spec, bounds) for the device scatter, or None when
        every record belongs in bucket 0."""
        if n <= 1:
            return None
        return ("hash", self.key_bytes), uniform_hash_bounds(n)

    def bucket_ids(self, batch: RecordBatch, n: int, *,
                   block_n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _kernel_partition(batch.data, ("hash", self.key_bytes),
                                 uniform_hash_bounds(n), n, block_n=block_n)


class RangePartitioner:
    """TeraSort-style: bucket by key position among sorted boundaries."""

    def __init__(self, boundaries: Sequence[bytes]):
        self.bnd = list(boundaries)

    def __call__(self, record: bytes, n: int) -> int:
        bnd = self.bnd
        key = record[:len(bnd[0])] if bnd else record
        lo, hi = 0, len(bnd)
        while lo < hi:
            mid = (lo + hi) // 2
            if key > bnd[mid]:
                lo = mid + 1
            else:
                hi = mid
        return min(lo, n - 1)

    def bounds_words(self, n_words: int, lengths: bool) -> np.ndarray:
        """Boundaries as [n-1, k] big-endian uint32 word rows, zero-padded
        to ``n_words`` words, plus a trailing byte-length word when
        ``lengths`` is set (the variable-length tiebreak)."""
        rows = []
        for b in self.bnd:
            padded = b[:4 * n_words].ljust(4 * n_words, b"\0")
            row = [int.from_bytes(padded[4 * i:4 * i + 4], "big")
                   for i in range(n_words)]
            if lengths:
                row.append(len(b))
            rows.append(row)
        return np.array(rows, dtype=np.uint32)

    def _word_spec(self, record_size: int):
        """(static key spec, bounds) of the word rows both bucket kernels
        compare.

        A record's comparison key is its first len(bnd[0]) bytes (clipped
        to the record) as rows of big-endian words; when any boundary
        length differs from that key length the zero-padded words can tie
        where the byte strings differ, so a trailing length word
        reproduces bytes ordering exactly."""
        key_len = min(len(self.bnd[0]), record_size)
        width = max(key_len, max(len(b) for b in self.bnd))
        n_words = max(1, -(-width // 4))
        need_len = any(len(b) != key_len for b in self.bnd)
        return (("range", key_len, n_words, key_len if need_len else None),
                self.bounds_words(n_words, lengths=need_len))

    def kernel_inputs(self, batch: RecordBatch, n: int
                      ) -> Tuple[torch.Tensor, np.ndarray]:
        """(keys, bounds) word rows for the bucket kernels."""
        if not self.bnd:
            return batch.keys_u32(4), np.empty(0)
        key_spec, bounds = self._word_spec(batch.record_size)
        return extract_keys(batch.data, key_spec), bounds

    def bucket_ids(self, batch: RecordBatch, n: int, *,
                   block_n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.bnd:
            return _all_in_bucket0(batch.num_records, n, batch.device)
        key_spec, bounds = self._word_spec(batch.record_size)
        return _kernel_partition(batch.data, key_spec, bounds, n,
                                 block_n=block_n)

    def scatter_spec(self, batch: RecordBatch, n: int):
        """(static key spec, bounds) for the device scatter, or None when
        every record belongs in bucket 0 (see :meth:`_word_spec`)."""
        if not self.bnd or n <= 1:
            return None
        return self._word_spec(batch.record_size)


class ReducePartitioner:
    """Every record to bucket 0 — the reduction shuffle (e.g. k-means
    partials folding on one worker); resolves without a kernel call, so
    reduce stages stay off the per-record host loop that an arbitrary
    ``lambda r, n: 0`` would take."""

    def __call__(self, record: bytes, n: int) -> int:
        return 0

    def bucket_ids(self, batch: RecordBatch, n: int, *,
                   block_n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _all_in_bucket0(batch.num_records, n, batch.device)


def hash_partitioner(key_bytes: int = 8) -> HashPartitioner:
    return HashPartitioner(key_bytes)


def reduce_partitioner() -> ReducePartitioner:
    return ReducePartitioner()


def range_partitioner(boundaries: Sequence[bytes]) -> RangePartitioner:
    return RangePartitioner(boundaries)


def _host_partition(batch: RecordBatch, partitioner, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-record host loop — the correctness path for partitioners the
    kernel cannot express."""
    ids = np.fromiter((partitioner(r, n) for r in batch.to_records()),
                      np.int32, count=batch.num_records)
    return ids, np.bincount(ids, minlength=n).astype(np.int32)


def partition_batch(batch: RecordBatch, partitioner, n: int, *,
                    block_n: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [N] int32, hist [n] int32)`` on the batch's device for a
    batch under any engine partitioner.

    Array-aware partitioners go through the ``bucket_partition_rows``
    kernel (one launch on the card, no key rows built); arbitrary ``(record, n) -> int`` callables
    take the per-record host loop, so the array backend stays correct for
    custom partitioners.  ``block_n`` caps the kernel's thread blocks at
    ``ceil(N / block_n)`` (default: as many blocks as the card holds at
    once).
    """
    batch = batch.compact()  # analysis keys are host-visible: no junk rows
    if hasattr(partitioner, "bucket_ids"):
        return partitioner.bucket_ids(batch, n, block_n=block_n)
    ids, hist = _host_partition(batch, partitioner, n)
    return (torch.from_numpy(ids).to(batch.device),
            torch.from_numpy(hist).to(batch.device))


def shuffle_batch(batch: RecordBatch, partitioner, n: int, *,
                  block_n: Optional[int] = None) -> List[RecordBatch]:
    """Partition + host-driven scatter: one kernel call, one host
    argsort, n gathers.  The engine uses :func:`scatter_batch` (fully
    device-resident) instead; this path remains for custom callable
    partitioners and as the ids-visible reference."""
    ids, hist = partition_batch(batch, partitioner, n, block_n=block_n)
    return scatter_by_ids(batch, ids, hist)


def _single_bucket_pieces(batch: RecordBatch, n: int) -> List[RecordBatch]:
    return [batch] + [RecordBatch.empty(batch.record_size, batch.device)
                      for _ in range(max(n, 1) - 1)]


def _bounds_tensor(bounds: np.ndarray, device) -> torch.Tensor:
    """uint32 boundary words as an int64 tensor on ``device``."""
    return torch.from_numpy(np.asarray(bounds).astype(np.int64)).to(device)


def _sync(t: torch.Tensor) -> np.ndarray:
    """The one device-to-host copy a round pays."""
    return t.cpu().numpy()


@dataclass
class ScatterDispatch:
    """The in-flight half of a dispatch-then-sync shuffle.

    :func:`scatter_dispatch` returns one of these per batch after
    enqueueing all device work (pad, key extraction, kernel, epilogue,
    row move) WITHOUT blocking.  ``out`` holds the bucket-contiguous rows
    and ``hist`` the pending [n] counts; a caller with many batches
    fetches every dispatch's ``hist`` in one barrier and calls
    :meth:`harvest` with the synced values.  Degenerate/fallback shapes
    resolve at dispatch time into ``pieces``, and ``host_syncs`` records
    any sync the fallback already paid (1 for the per-record host loop).
    """

    n: int                                          # bucket count
    pieces: Optional[List[RecordBatch]] = None      # resolved at dispatch
    out: Optional[torch.Tensor] = None              # scattered rows
    hist: Optional[torch.Tensor] = None             # pending [n] counts
    host_syncs: int = field(default=0)              # syncs paid at dispatch

    @property
    def pending(self) -> bool:
        """True when the histogram must reach the host before slicing."""
        return self.pieces is None

    def harvest(self, synced: Optional[np.ndarray] = None
                ) -> List[RecordBatch]:
        """Per-bucket batches.  ``synced`` is the already-fetched [n]
        histogram; omitted, the dispatch syncs its own."""
        if self.pieces is not None:
            return self.pieces
        hist = _sync(self.hist) if synced is None else np.asarray(synced)
        offsets = np.concatenate([[0], np.cumsum(hist)])
        self.pieces = [RecordBatch(self.out[offsets[i]:offsets[i + 1]])
                       for i in range(self.n)]
        return self.pieces


def scatter_dispatch(batch: RecordBatch, partitioner, n: int, *,
                     pad_block: int = 4096, block_n: int | None = None
                     ) -> ScatterDispatch:
    """Enqueue the device-resident shuffle of one batch; never blocks.

    The batch is placed in a shape-ladder block (floored at
    ``pad_block``; a padding-resident batch at a usable shape is reused
    as-is, junk tail included); key extraction, the ``bucket_scatter``
    kernel and its epilogue run with the real row count as the kernel's
    validity, so records land bucket-contiguously without the bucket ids
    ever reaching the host.  Within a bucket records keep input order.
    Degenerate shapes take a zero-kernel shortcut; partitioners without
    ``scatter_spec`` fall back to the host loop + host argsort.
    """
    nrec = batch.num_records
    if n <= 1:
        return ScatterDispatch(n, pieces=[batch])
    if nrec == 0:
        empty = [RecordBatch.empty(batch.record_size, batch.device)
                 for _ in range(n)]
        return ScatterDispatch(n, pieces=empty)
    if isinstance(partitioner, ReducePartitioner):
        return ScatterDispatch(n, pieces=_single_bucket_pieces(batch, n))
    if not hasattr(partitioner, "scatter_spec"):
        ids, hist = _host_partition(batch, partitioner, n)
        return ScatterDispatch(n, pieces=scatter_by_ids(batch, ids, hist),
                               host_syncs=1)
    spec = partitioner.scatter_spec(batch, n)
    if spec is None:
        return ScatterDispatch(n, pieces=_single_bucket_pieces(batch, n))
    key_spec, bounds = spec
    data = batch.block(_pow2_rows(nrec, min(pad_block, 1 << 20)))
    out, hist = bucket_scatter(data, extract_keys(data, key_spec),
                               _bounds_tensor(bounds, data.device), nrec,
                               n_buckets=n, block_n=block_n)
    return ScatterDispatch(n, out=out, hist=hist)


def scatter_batch(batch: RecordBatch, partitioner, n: int, *,
                  pad_block: int = 4096, block_n: int | None = None
                  ) -> List[RecordBatch]:
    """Device-resident shuffle: batch in, n bucket-sliced batches out
    (dispatch + immediate harvest, one host sync)."""
    return scatter_dispatch(batch, partitioner, n, pad_block=pad_block,
                            block_n=block_n).harvest()


def scatter_pieces_dispatch(pieces: Sequence[RecordBatch], partitioner,
                            n: int, *, pad_block: int = 4096,
                            block_n: int | None = None) -> ScatterDispatch:
    """Enqueue one worker's stage output — its list of resident pieces —
    as a single scatter; never blocks.  A single piece goes straight to
    :func:`scatter_dispatch`; several pieces are concatenated into the
    shape-ladder block the scatter pads to anyway (one copy), so the
    valid rows keep piece order."""
    if len(pieces) == 1:
        return scatter_dispatch(pieces[0], partitioner, n,
                                pad_block=pad_block, block_n=block_n)
    kernelish = (n > 1 and not isinstance(partitioner, ReducePartitioner)
                 and getattr(partitioner, "scatter_spec", None) is not None)
    nrec = sum(p.num_records for p in pieces)
    if kernelish and nrec:
        batch = RecordBatch.concat_block(
            pieces, _pow2_rows(nrec, min(pad_block, 1 << 20)))
    else:
        batch = RecordBatch.concat(list(pieces))
    return scatter_dispatch(batch, partitioner, n, pad_block=pad_block,
                            block_n=block_n)


# --------------------------------------------------------------------------
# Fused worker-axis round: the whole shuffle of a stage — every slot's key
# extraction, kernel pass and row move — as O(1) dispatches over a
# StackedBatch, instead of one dispatch per worker.

def _regroup_take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The round's regrouping gather: ONE index_select of the flattened
    ``[s * rows, width]`` source at the ``[W, block2]`` global row
    positions."""
    s, rows, width = src.shape
    flat = src.reshape(s * rows, width).index_select(0, idx.reshape(-1))
    return flat.reshape(idx.shape[0], idx.shape[1], width)


@dataclass
class FusedRoundResult:
    """The regrouped output of one fused shuffle round.

    ``data`` is uint8 [n_workers, block2, width]: destination worker
    ``w``'s resident partition occupies slot ``w`` — its buckets
    ``{b : b % n_workers == w}`` concatenated in ascending bucket order,
    records within a bucket in (slot-major, then input) order — exactly
    the order the bytes backend's per-worker append loop produces.
    ``counts`` is the host [n_workers] valid-row vector (``data`` tails
    are junk) and ``origins[b]`` maps origin worker name to the bytes
    bucket ``b`` drew from it — the planner's movement pricing input.
    ``groups`` may instead hold ``(w_start, stack)`` pairs covering
    consecutive worker ranges (with ``data`` None); the port's harvest
    always returns one stack, and ``place_buckets`` takes either form.
    ``data is None`` with no ``groups`` means the round carried no
    records.  A mesh round (``spmd.fused_scatter_round``) sets ``mesh``:
    its ``data`` is then the rank's block of workers, ``counts`` still
    every worker's.
    """

    data: Optional[torch.Tensor]
    counts: np.ndarray
    origins: List[Dict[str, int]]
    dispatches: int = 0
    groups: Optional[List[Tuple[int, torch.Tensor]]] = None
    mesh: Optional[object] = None

    @property
    def record_size(self) -> int:
        if self.data is not None:
            return self.data.shape[2]
        if self.groups:
            return self.groups[0][1].shape[2]
        return 0


@dataclass
class StackedRoundDispatch:
    """The in-flight half of a FUSED shuffle round.

    :func:`scatter_round_dispatch` enqueues the whole round's device
    work — one stacked scatter regardless of worker or task count —
    whose row move already left every slot bucket-contiguous in ``src``;
    ``hist`` is the pending [s, n] per-slot histogram, the one array the
    round syncs.  :meth:`harvest` turns the synced histogram into row
    positions and finishes with ONE gather that lands every destination
    worker's regrouped partition in a single stacked tensor.
    """

    n: int                           # bucket count
    worker_names: List[str]          # destination ring (bucket b -> b % W)
    slot_workers: np.ndarray         # [s] origin ring index per slot
    rows: int                        # padded rows per slot
    width: int
    pad_block: int
    src: torch.Tensor                # [s, rows, width] scattered slots
    hist: torch.Tensor               # [s, n] per-slot bucket counts
    dispatches: int = 0
    host_syncs: int = 0

    def harvest(self, synced: Optional[np.ndarray] = None
                ) -> FusedRoundResult:
        """Regroup the round onto destination workers.  ``synced`` is the
        already-fetched [s, n] histogram; omitted, the dispatch syncs its
        own (counted in :attr:`host_syncs`)."""
        if synced is None:
            synced = _sync(self.hist)
            self.host_syncs += 1
        W, B, rows = len(self.worker_names), self.n, self.rows
        hist_sb = np.asarray(synced)[:, :B].astype(np.int64)
        off_sb = np.cumsum(hist_sb, axis=1) - hist_sb      # exclusive
        seg_pos: List[List[np.ndarray]] = [[] for _ in range(B)]
        origin_counts = np.zeros((B, W), np.int64)
        for b in range(B):
            for s in range(hist_sb.shape[0]):
                c = int(hist_sb[s, b])
                if c:
                    start = s * rows + int(off_sb[s, b])
                    seg_pos[b].append(
                        np.arange(start, start + c, dtype=np.int64))
                    origin_counts[b, self.slot_workers[s]] += c
        origins = [
            {self.worker_names[w]: int(origin_counts[b, w]) * self.width
             for w in np.nonzero(origin_counts[b])[0]}
            for b in range(B)]
        counts = np.zeros(W, np.int64)
        hist_total = origin_counts.sum(axis=1)
        for b in range(B):
            counts[b % W] += hist_total[b]
        nmax = int(counts.max()) if W else 0
        if nmax == 0:
            return FusedRoundResult(None, counts, origins, 0)
        # the regrouped stack gets its own quarter-ladder row count
        block2 = _quarter_rows(nmax, min(self.pad_block, 256))
        # each worker's buckets ascending, slot order within a bucket,
        # input order within a slot — the bytes backend's append order;
        # junk tail positions point at row 0 (counts marks the prefixes)
        idx = np.zeros((W, block2), np.int64)
        for w in range(W):
            fill = 0
            for b in range(w, B, W):
                for gpos in seg_pos[b]:
                    idx[w, fill:fill + gpos.size] = gpos
                    fill += gpos.size
        data = _regroup_take(self.src,
                             torch.from_numpy(idx).to(self.src.device))
        return FusedRoundResult(data, counts, origins, 1)


def scatter_round_dispatch(stacked: StackedBatch, partitioner, n: int, *,
                           worker_names: Sequence[str],
                           slot_workers=None, pad_block: int = 4096,
                           block_n: int | None = None
                           ) -> Optional[StackedRoundDispatch]:
    """Enqueue a WHOLE round's shuffle over a stacked slot axis; never
    blocks.  Returns ``None`` when the round cannot stay on the fused
    kernel path (single bucket, reduce shuffle, host-loop partitioner,
    empty stack) — the caller falls back to the per-worker dispatch loop.

    ``slot_workers[i]`` names (by index into ``worker_names``) the worker
    whose stage output slot ``i`` holds, for movement accounting; slots
    must be ordered worker-major so the regrouped record order matches
    the bytes backend's append order record-for-record.  Key extraction
    runs over the whole stack, then ONE ``bucket_scatter`` call —
    one kernel launch on the card — scatters every slot."""
    s, rows, width = stacked.data.shape
    if n <= 1 or s == 0 or rows == 0 \
            or isinstance(partitioner, ReducePartitioner) \
            or getattr(partitioner, "scatter_spec", None) is None:
        return None
    device = stacked.data.device
    # partitioners are immutable after construction, so the per-round
    # (key spec, device bounds) pair is cached on the instance
    cached = getattr(partitioner, "_round_spec_cache", None)
    if cached is not None and cached[0] == (n, width, device):
        _, key_spec, bounds_dev = cached
    else:
        spec = partitioner.scatter_spec(RecordBatch.empty(width, device), n)
        if spec is None:
            return None
        key_spec, bounds = spec
        bounds_dev = _bounds_tensor(bounds, device)
        try:
            partitioner._round_spec_cache = ((n, width, device), key_spec,
                                             bounds_dev)
        except AttributeError:
            pass                       # __slots__ partitioner: skip cache
    W = len(worker_names)
    if slot_workers is None:
        slot_workers = np.arange(s, dtype=np.int64) % max(W, 1)
    else:
        slot_workers = np.asarray(slot_workers, dtype=np.int64)
    n_valid = torch.from_numpy(stacked.n_valid).to(device)
    src, hist = bucket_scatter(stacked.data,
                               extract_keys(stacked.data, key_spec),
                               bounds_dev, n_valid, n_buckets=n,
                               block_n=block_n)
    return StackedRoundDispatch(
        n=n, worker_names=list(worker_names), slot_workers=slot_workers,
        rows=rows, width=width, pad_block=pad_block, src=src, hist=hist,
        dispatches=1)


def terasort_stages(bounds: Sequence[bytes], backend: str, n_buckets: int,
                    key_bytes: int = 10) -> list:
    """The canonical TeraSort stage pair (partition+shuffle, then sort)
    on either record backend."""
    from repro_torch.core.job import SphereStage
    part = range_partitioner(bounds)
    if backend == "array":
        # pad_value=0xff declares both batch UDFs pad-stable, so the
        # executor pads to a fixed block shape: identity keeps padding
        # rows at the tail, and the stable sort sends all-0xff padding
        # keys to the end (ties with a real all-0xff key keep the real
        # record first — input order).
        return [
            SphereStage("partition", batch_udf=lambda b: b,
                        partitioner=part, n_buckets=n_buckets,
                        pad_value=0xFF),
            SphereStage("sort",
                        batch_udf=lambda b: b.sort_by_key(key_bytes),
                        pad_value=0xFF),
        ]
    return [
        SphereStage("partition", lambda rs: list(rs),
                    partitioner=part, n_buckets=n_buckets),
        SphereStage("sort",
                    lambda rs: sorted(rs, key=lambda r: r[:key_bytes])),
    ]


def sample_boundaries(records: Sequence[bytes], n_buckets: int,
                      key_bytes: int = 10) -> List[bytes]:
    """Sample keys to build balanced range boundaries (TeraSort pre-pass).
    When ``n_buckets > len(records)`` some boundaries repeat; the index is
    clamped at both ends so the result is always sorted."""
    keys = sorted(r[:key_bytes] for r in records)
    if not keys or n_buckets <= 1:
        return []
    step = len(keys) / n_buckets
    return [keys[min(max(int(step * i) - 1, 0), len(keys) - 1)]
            for i in range(1, n_buckets)]
