"""Sphere data plane: per-backend executors (planner/executor split).

The port of ``repro.core.executor``.  An executor owns everything that
touches record data — fetching chunks from Sector (with bounded
retries), running stage UDFs on the worker the planner chose,
bucketizing stage output for the shuffle, and materialising the final
per-bucket blobs.  The planner never sees a record; the executor never
makes a placement decision.

* :class:`BytesExecutor` — the per-record Python reference.  A worker's
  partition is a list of ``bytes`` records.

* :class:`ArrayExecutor` — the device-resident backend on torch tensors.
  A worker's partition is ONE :class:`RecordBatch` that stays on the
  executor's device across stages, with host bytes touched only when
  reading Sector chunks (stage 0) and materialising final outputs.
  Pad-stable stage UDFs run on a fixed block shape per stage, and with
  ``fused_rounds`` a whole round — every task's UDF apply (one
  ``torch.func.vmap`` call over a stacked slot axis), every worker's
  bucket scatter (one kernel launch) and the regrouping onto destination
  workers (one gather) — is O(1) device dispatches with one host sync.

Both executors report identical shuffle flows (per-bucket origin bytes),
so the planner charges movement from each bucket's *actual* origin
workers and simulated time agrees across backends for the same job.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.job import SphereJob, SphereStage
from repro_torch.core.planner import SphereReport, StagePlan
from repro_torch.core.records import RecordBatch, StackedBatch
from repro_torch.core.shuffle import (FusedRoundResult, _quarter_rows,
                                      _sync, scatter_pieces_dispatch,
                                      scatter_round_dispatch)
from repro_torch.core.trace import NULL_TRACER
from repro_torch.device import resolve_device
from repro_torch.sector.server import ServerDown

# per-bucket origin accounting: origins[i][worker] = bytes of bucket i
# that were produced on that worker
Origins = List[Dict[str, int]]


class _ExecutorBase:
    def __init__(self, client, workers: Sequence[str], max_retries: int = 3,
                 cache_chunks: bool = False, prefetch: bool = True,
                 prefetch_depth: int = 1, tracer=None):
        self.client = client
        self.workers = list(workers)
        self.max_retries = max_retries
        self.prefetch = prefetch
        self.prefetch_depth = max(1, prefetch_depth)
        # wall-clock span tracer (NULL_TRACER = record nothing, but
        # spans still time themselves — the one timing idiom)
        self.tracer = tracer or NULL_TRACER
        # session mode: decoded stage-0 chunks stay resident, keyed by
        # chunk id; cleared by clear_chunk_cache()
        self._chunk_cache: Optional[Dict[str, object]] = \
            {} if cache_chunks else None

    def clear_chunk_cache(self) -> None:
        if self._chunk_cache is not None:
            self._chunk_cache.clear()

    def evict_chunks(self, keys) -> None:
        """Drop specific cached chunks (stream window retirement)."""
        if self._chunk_cache is not None:
            for k in keys:
                self._chunk_cache.pop(k, None)

    def _fetch_chunk(self, key: str, rep: SphereReport) -> Optional[bytes]:
        """Read a stage-0 chunk, retrying over surviving replicas."""
        for _ in range(self.max_retries):
            try:
                return self.client.read_chunk(key)
            except (IOError, ServerDown):
                rep.retried += 1
                self.client.run_repair()
        return None

    def _stage0_input(self, job: SphereJob, key: str, rep: SphereReport):
        """Decoded stage-0 input for one chunk task, through the session
        chunk cache when enabled.  None when every replica is gone."""
        if self._chunk_cache is not None and key in self._chunk_cache:
            return self._chunk_cache[key]
        with self.tracer.span("fetch-chunk", track="fetch",
                              attrs={"key": key}) as sp:
            blob = self._fetch_chunk(key, rep)
            if blob is None:
                sp.set_attrs(lost=True)
                return None
            decoded = self._decode_chunk(job, blob)
        if self._chunk_cache is not None:
            self._chunk_cache[key] = decoded
        return decoded

    # ------------------------------------------------- stage-0 prefetch
    def _stage0_batches(self, job: SphereJob, tasks, rep: SphereReport
                        ) -> Iterator[tuple]:
        """Yield ``(task, decoded_input)`` for the stage-0 task list with
        a ``prefetch_depth``-deep fetch+decode pipeline: ONE producer
        thread walks the chunks strictly in task order, pushing decoded
        inputs into a bounded queue the caller drains, so host I/O of up
        to ``prefetch_depth`` chunks overlaps device work.  A failed read
        is replayed on the MAIN thread through :meth:`_stage0_input`'s
        retry loop, so ``rep.retried`` and repair behaviour are
        bit-identical with prefetching off.  The producer's host-to-device
        copy runs on the default stream and returns once the data is on
        the device, so the consumer's kernels read complete pieces."""
        if not self.prefetch or len(tasks) <= 1:
            for t in tasks:
                yield t, self._stage0_input(job, t.key, rep)
            return
        q: "queue.Queue[tuple]" = queue.Queue(maxsize=self.prefetch_depth)

        def produce():
            for t in tasks:
                if self._chunk_cache is not None \
                        and t.key in self._chunk_cache:
                    q.put(("cache", None))
                    continue
                try:
                    with self.tracer.span("fetch-chunk", track="prefetch",
                                          attrs={"key": t.key}):
                        payload = self._decode_chunk(
                            job, self.client.read_chunk(t.key))
                    q.put(("ok", payload))
                except (IOError, ServerDown):
                    q.put(("retry", None))
                except BaseException as err:  # noqa: BLE001 — re-raised
                    q.put(("error", err))
                    return

        th = threading.Thread(target=produce, daemon=True,
                              name="sphere-prefetch")
        th.start()
        for t in tasks:
            kind, payload = q.get()
            if kind == "ok":
                if self._chunk_cache is not None:
                    self._chunk_cache[t.key] = payload
                yield t, payload
            elif kind in ("cache", "retry"):
                yield t, self._stage0_input(job, t.key, rep)
            else:
                raise payload
        th.join()


class BytesExecutor(_ExecutorBase):
    """Reference data plane: partitions are lists of Python bytes."""

    def empty_parts(self) -> Dict[str, List[bytes]]:
        return {w: [] for w in self.workers}

    def part_sizes(self, parts) -> Dict[str, int]:
        return {w: sum(len(r) for r in parts[w]) for w in self.workers}

    def _decode_chunk(self, job: SphereJob, blob: bytes) -> List[bytes]:
        return job.split_records(blob)

    def run_stage(self, job: SphereJob, stage: SphereStage, plan: StagePlan,
                  parts, rep: SphereReport, *, first_stage: bool
                  ) -> Dict[str, List[bytes]]:
        out: Dict[str, List[bytes]] = {w: [] for w in self.workers}
        if first_stage:
            source = self._stage0_batches(job, plan.tasks, rep)
        else:
            source = ((t, parts.get(t.key)) for t in plan.tasks)
        for t, records in source:
            if not records:
                continue
            if first_stage and self._chunk_cache is not None:
                # hand UDFs a copy: an in-place-mutating UDF (sort,
                # pop) must not corrupt the cache for later jobs
                records = list(records)
            # stage-0 chunks land wherever they were computed; a later
            # stage's partition keeps its OWNER slot
            dst = t.executor if first_stage else t.key
            out[dst].extend(stage.apply_bytes(records))
        return out

    def bucketize(self, stage: SphereStage, out, n: int, rep: SphereReport
                  ) -> Tuple[List[List[bytes]], Origins]:
        """Reference shuffle: one partitioner call per Python record.
        Pure host work — ``rep.host_syncs`` stays 0."""
        buckets: List[List[bytes]] = [[] for _ in range(n)]
        origins: Origins = [{} for _ in range(n)]
        rep.shuffle_rounds += 1
        with self.tracer.span("shuffle-round", track="shuffle",
                              attrs={"backend": "bytes",
                                     "buckets": n}) as sp:
            for w in self.workers:
                for r in out[w]:
                    b = stage.partitioner(r, n)
                    buckets[b].append(r)
                    origins[b][w] = origins[b].get(w, 0) + len(r)
                    rep.partitioned_records += 1
        rep.partition_seconds += sp.wall_seconds
        return buckets, origins

    def place_buckets(self, buckets, parts) -> None:
        for w in self.workers:
            parts[w] = []
        for i, bucket in enumerate(buckets):
            parts[self.workers[i % len(self.workers)]].extend(bucket)

    def set_parts(self, parts, out) -> None:
        for w in self.workers:
            parts[w] = out[w]

    def outputs(self, parts) -> List[bytes]:
        return [b"".join(parts[w]) for w in self.workers if parts[w]]


def _shape_sig(x):
    """Shapes of the tensors in a nested params structure — the part of a
    call's signature a trace depends on."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    if isinstance(x, (list, tuple)):
        return tuple(_shape_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _shape_sig(v)) for k, v in sorted(x.items()))
    return type(x).__name__


class _TracedUDF:
    """A pad-stable (or mask-aware) stage UDF with the reference's trace
    accounting.

    PyTorch runs eagerly, so a "trace" here is the first call at each
    distinct (entry point, padded shape): ``traces == 1`` certifies that
    every task of the stage ran at one fixed block shape, exactly as the
    JAX package's jit compiled once — so ``rep.udf_traces`` agrees with
    the reference.

    Every entry point normalises the block's padding tail to the stage's
    pad byte on the device before the UDF sees it.  The fused entry
    points run the per-slot UDF over the stacked slot axis with
    ``torch.func.vmap``, so user UDFs keep the one-``RecordBatch``
    contract; vmap's per-slot loop fallback is switched off for the
    call, so an op without a batching rule raises instead of silently
    running slot by slot."""

    def __init__(self, name: str, udf, *, masked: bool = False,
                 pad_value: int = 0):
        self.name = name
        self.udf = udf
        self.masked = masked
        self.pad_value = pad_value
        self.traces = 0
        self._seen: set = set()

    def _note(self, sig) -> None:
        if sig not in self._seen:
            self._seen.add(sig)
            self.traces += 1

    def _check(self, out) -> torch.Tensor:
        if not isinstance(out, RecordBatch):
            raise TypeError(f"stage {self.name!r} UDF must return "
                            f"a RecordBatch, got {type(out).__name__}")
        return out.data

    def _normalize(self, data: torch.Tensor, n_valid):
        """(mask, block with padding rows set to the stage pad byte) —
        junk tails must never reach a UDF."""
        mask = torch.arange(data.shape[0], device=data.device) < n_valid
        pad = torch.tensor(self.pad_value, dtype=data.dtype,
                           device=data.device)
        return mask, torch.where(mask[:, None], data, pad)

    def _call_padded(self, data: torch.Tensor, n_valid) -> torch.Tensor:
        _, norm = self._normalize(data, n_valid)
        return self._check(self.udf(RecordBatch(norm)))

    def _vmapped(self, data3: torch.Tensor, n_valids) -> torch.Tensor:
        n_valids = torch.as_tensor(n_valids, device=data3.device)
        enabled = torch._C._functorch._is_vmap_fallback_enabled()
        torch._C._functorch._set_vmap_fallback_enabled(False)
        try:
            return vmap(self._call_padded)(data3, n_valids)
        finally:
            torch._C._functorch._set_vmap_fallback_enabled(enabled)

    def stacked(self, data3: torch.Tensor, n_valids, target: int
                ) -> torch.Tensor:
        """Stacked [s, rows, width] input (a previous fused round's
        resident partitions); rows are sliced or zero-grown to
        ``target`` before the vmapped body."""
        self._note(("stacked", tuple(data3.shape), target))
        s, rows, width = data3.shape
        if rows > target:
            data3 = data3[:, :target]
        elif rows < target:
            data3 = torch.cat([data3, data3.new_zeros(
                (s, target - rows, width))], dim=1)
        return self._vmapped(data3, n_valids)

    def stack_pieces(self, pieces: Sequence[torch.Tensor], n_valids,
                     target: int) -> torch.Tensor:
        """Per-task 2-D pieces (stage-0 decoded chunks) stacked into one
        [s, target, width] block — each piece sliced or zero-grown to
        ``target`` rows — before the vmapped body."""
        self._note(("pieces", tuple(tuple(p.shape) for p in pieces),
                    target))
        width = pieces[0].shape[1]
        data3 = pieces[0].new_zeros((len(pieces), target, width))
        for i, p in enumerate(pieces):
            r = min(p.shape[0], target)
            data3[i, :r] = p[:r]
        return self._vmapped(data3, n_valids)

    def __call__(self, data: torch.Tensor, n_valid, params=None
                 ) -> torch.Tensor:
        """One task's block: ``udf(batch)``, or ``udf(batch, mask,
        params)`` for a mask-aware stage."""
        if self.masked:
            self._note(("masked", tuple(data.shape), _shape_sig(params)))
            mask, norm = self._normalize(data, n_valid)
            return self._check(self.udf(RecordBatch(norm), mask, params))
        self._note(("padded", tuple(data.shape)))
        return self._call_padded(data, n_valid)


class _SlotRef:
    """One worker's partition as a VIEW into a round-stacked tensor: it
    answers the host-side shape queries from the host count vector, and
    :meth:`batch` gives the slot as a padding-resident RecordBatch only
    when a non-fused consumer needs one."""

    __slots__ = ("stacked", "idx")

    def __init__(self, stacked: StackedBatch, idx: int):
        self.stacked = stacked
        self.idx = idx

    @property
    def num_records(self) -> int:
        return int(self.stacked.n_valid[self.idx])

    @property
    def record_size(self) -> int:
        return self.stacked.record_size

    @property
    def nbytes(self) -> int:
        return self.num_records * self.record_size

    def batch(self) -> RecordBatch:
        return self.stacked.slot(self.idx)


def _as_batch(part) -> Optional[RecordBatch]:
    """A parts-dict value as a RecordBatch (None stays None)."""
    return part.batch() if isinstance(part, _SlotRef) else part


@dataclass
class _StackedOut:
    """A fused run_stage result: the whole stage output as ONE
    StackedBatch, plus each slot's origin worker (index into the
    executor's worker ring).  Slots are ordered worker-major, the
    iteration order of the per-worker dict path."""

    stacked: StackedBatch
    slot_workers: np.ndarray

    def to_worker_dict(self, workers: Sequence[str]
                       ) -> Dict[str, List[RecordBatch]]:
        """Downgrade to the per-worker pieces dict (used when the
        following shuffle cannot stay on the fused kernel path)."""
        out: Dict[str, List[RecordBatch]] = {w: [] for w in workers}
        for i in range(self.stacked.n_slots):
            if self.stacked.n_valid[i]:
                out[workers[int(self.slot_workers[i])]].append(
                    self.stacked.slot(i))
        return out


class ArrayExecutor(_ExecutorBase):
    """Device-resident data plane: one RecordBatch per worker partition,
    on ``device`` (default CUDA; raises without it)."""

    def __init__(self, client, workers: Sequence[str], max_retries: int = 3,
                 pad_block: int = 4096, cache_chunks: bool = False,
                 prefetch: bool = True, timing_sync: bool = False,
                 fused_rounds: bool = True, mesh=None,
                 prefetch_depth: int = 1, tracer=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "the multi-GPU mesh round is not ported yet (core/spmd.py)")
        super().__init__(client, workers, max_retries,
                         cache_chunks=cache_chunks, prefetch=prefetch,
                         prefetch_depth=prefetch_depth, tracer=tracer)
        self.device = resolve_device(device)
        self.pad_block = pad_block
        self.fused_rounds = fused_rounds
        # benchmark honesty knob: synchronise the device before starting
        # and stopping the partition_seconds clock.  A timing-only
        # barrier, excluded from the host_syncs data-plane accounting.
        self.timing_sync = timing_sync

    def _timing_barrier(self) -> None:
        if self.timing_sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def empty_parts(self) -> Dict[str, Optional[RecordBatch]]:
        return {w: None for w in self.workers}

    def part_sizes(self, parts) -> Dict[str, int]:
        return {w: (parts[w].nbytes if parts[w] is not None else 0)
                for w in self.workers}

    def _decode_chunk(self, job: SphereJob, blob: bytes) -> RecordBatch:
        return RecordBatch.from_bytes(blob, job.record_size,
                                      device=self.device)

    # --------------------------------------------------------- UDF apply
    def _traced_for(self, stage: SphereStage, udf, *,
                    masked: bool = False) -> _TracedUDF:
        pad_value = stage.pad_value or 0
        # the wrapper lives ON the stage object: same-named stages keep
        # their own wrappers, and a stage re-run across a session chain
        # keeps its trace accounting
        traced = getattr(stage, "_traced", None)
        if traced is None or traced.udf is not udf \
                or traced.pad_value != pad_value:
            traced = _TracedUDF(stage.name, udf, masked=masked,
                                pad_value=pad_value)
            stage._traced = traced
        return traced

    def _note_traces(self, stage: SphereStage, traced: _TracedUDF,
                     rep: SphereReport) -> None:
        rep.note_udf_traces(stage.name, traced.traces)

    def _apply_masked(self, stage: SphereStage, batch: RecordBatch,
                      target: int, rep: SphereReport) -> RecordBatch:
        """Mask-aware reduction path: the UDF gets the stage's fixed
        block (padding normalised), a validity mask, and the stage's
        current params; its output is returned whole."""
        traced = self._traced_for(stage, stage.masked_udf, masked=True)
        with self.tracer.span("dispatch:udf", track="dispatch",
                              attrs={"stage": stage.name, "rows": target}):
            out = traced(batch.block(target), batch.num_records,
                         stage.params)
        rep.device_dispatches += 1
        self._note_traces(stage, traced, rep)
        return RecordBatch(out)

    def _apply_padded(self, stage: SphereStage, batch: RecordBatch,
                      target: int, rep: SphereReport) -> RecordBatch:
        """Pad-stable path: the UDF runs on the stage's fixed block and
        its output STAYS at block shape (a padding-resident batch)."""
        traced = self._traced_for(stage, stage.batch_udf)
        n = batch.num_records
        with self.tracer.span("dispatch:udf", track="dispatch",
                              attrs={"stage": stage.name, "rows": target}):
            out = traced(batch.block(target), n)
        rep.device_dispatches += 1
        self._note_traces(stage, traced, rep)
        if out.shape[0] != target:
            raise ValueError(
                f"stage {stage.name!r} declares pad_value but its batch_udf "
                f"changed the row count ({target} -> {out.shape[0]}); "
                f"pad-stable UDFs must map padding rows to tail padding")
        return RecordBatch(out, n_valid=n)

    def _apply_compat(self, stage: SphereStage,
                      batch: RecordBatch) -> RecordBatch:
        """Shape-polymorphic UDFs see exact batches; a stage with only a
        bytes UDF runs over the decoded records."""
        if stage.batch_udf is not None:
            return stage.apply_batch(batch)
        records = stage.apply_bytes(batch.to_records())
        if not records:
            return RecordBatch.empty(batch.record_size, self.device)
        return RecordBatch.from_records(records, device=self.device)

    def _stage_block_shape(self, job: SphereJob, plan: StagePlan, parts,
                           first_stage: bool) -> int:
        """Fixed block shape for a pad-stable stage: the stage's largest
        task rounded up on the quarter-octave ladder, floored at
        pad_block — from the plan's task sizes / resident partitions, so
        no batch has to be fetched to compute it."""
        max_rows = 0
        for t in plan.tasks:
            if first_stage:
                rows = t.nbytes // job.record_size
            else:
                batch = parts.get(t.key)
                rows = batch.num_records if batch is not None else 0
            max_rows = max(max_rows, rows)
        if not max_rows:
            return 0
        return _quarter_rows(max_rows, self.pad_block)

    def run_stage(self, job: SphereJob, stage: SphereStage, plan: StagePlan,
                  parts, rep: SphereReport, *, first_stage: bool):
        masked = stage.masked_udf is not None
        pad_stable = (stage.batch_udf is not None
                      and stage.pad_value is not None)
        target = (self._stage_block_shape(job, plan, parts, first_stage)
                  if masked or pad_stable else 0)
        if self.fused_rounds and pad_stable and target and plan.tasks:
            fused = self._run_stage_fused(job, stage, plan, parts, rep,
                                          first_stage, target)
            if fused is not None:
                return fused
        out: Dict[str, List[RecordBatch]] = {w: [] for w in self.workers}
        if first_stage:
            source = self._stage0_batches(job, plan.tasks, rep)
        else:
            source = ((t, _as_batch(parts.get(t.key))) for t in plan.tasks)
        for t, batch in source:
            if batch is None or not batch.num_records:
                continue
            # same owner-slot rule as the bytes executor
            dst = t.executor if first_stage else t.key
            if masked:
                out[dst].append(self._apply_masked(stage, batch, target, rep))
            elif pad_stable and target:
                out[dst].append(self._apply_padded(stage, batch, target, rep))
            else:
                with self.tracer.span("dispatch:udf", track="dispatch",
                                      attrs={"stage": stage.name,
                                             "rows": batch.num_records}):
                    out[dst].append(self._apply_compat(stage,
                                                       batch.compact()))
                rep.device_dispatches += 1
        return out

    def _check_stacked(self, stage: SphereStage, out, s: int, target: int
                       ) -> None:
        if out.ndim != 3 or out.shape[0] != s or out.shape[1] != target:
            raise ValueError(
                f"stage {stage.name!r} declares pad_value but its batch_udf "
                f"changed the row count ({target} -> {out.shape[1]}); "
                f"pad-stable UDFs must map padding rows to tail padding")

    def _aligned_stacked(self, parts) -> Optional[StackedBatch]:
        """The previous fused round's StackedBatch, when every worker's
        resident part is exactly its slot of ONE stack (the steady state
        of chained fused rounds)."""
        base: Optional[StackedBatch] = None
        for i, w in enumerate(self.workers):
            p = parts.get(w)
            if p is None:
                continue
            if not isinstance(p, _SlotRef) or p.idx != i:
                return None
            if base is None:
                base = p.stacked
            elif p.stacked is not base:
                return None
        if base is None or base.n_slots != len(self.workers):
            return None
        return base

    def _run_stage_fused(self, job: SphereJob, stage: SphereStage,
                         plan: StagePlan, parts, rep: SphereReport,
                         first_stage: bool, target: int):
        """The whole stage as ONE vmapped UDF dispatch over a stacked
        slot axis.  Slots collect worker-major (the chunk's executor at
        stage 0, the partition's OWNER later; plan order within a
        worker).  Returns None when the stage must take the per-task
        path (a task placed on an unknown worker)."""
        windex = {w: i for i, w in enumerate(self.workers)}
        if any(t.executor not in windex for t in plan.tasks):
            return None
        traced = self._traced_for(stage, stage.batch_udf)
        if not first_stage:
            stacked = self._aligned_stacked(parts)
            if stacked is not None:
                # steady state: the resident stack IS the stage input
                with self.tracer.span("dispatch:udf-fused", track="dispatch",
                                      attrs={"stage": stage.name,
                                             "slots": stacked.n_slots,
                                             "rows": target}):
                    out = traced.stacked(stacked.data, stacked.n_valid,
                                         target)
                rep.device_dispatches += 1
                self._note_traces(stage, traced, rep)
                self._check_stacked(stage, out, stacked.n_slots, target)
                return _StackedOut(
                    StackedBatch(out, stacked.n_valid),
                    np.arange(stacked.n_slots, dtype=np.int64))
        items: List[Tuple[int, RecordBatch]] = []
        if first_stage:
            for t, batch in self._stage0_batches(job, plan.tasks, rep):
                if batch is not None and batch.num_records:
                    items.append((windex[t.executor], batch))
        else:
            for t in plan.tasks:
                batch = _as_batch(parts.get(t.key))
                if batch is not None and batch.num_records:
                    items.append((windex[t.key], batch))
        if not items:
            # nothing to run (falling back to the per-task loop would
            # replay the stage-0 fetches, double-counting retries)
            return {w: [] for w in self.workers}
        items.sort(key=lambda p: p[0])          # stable: worker-major
        n_valid = np.fromiter((b.num_records for _, b in items), np.int32,
                              count=len(items))
        slot_workers = np.fromiter((i for i, _ in items), np.int64,
                                   count=len(items))
        pieces = [b.data for _, b in items]
        with self.tracer.span("dispatch:udf-fused", track="dispatch",
                              attrs={"stage": stage.name,
                                     "slots": len(pieces), "rows": target}):
            out = traced.stack_pieces(pieces, n_valid, target)
        rep.device_dispatches += 1
        self._note_traces(stage, traced, rep)
        self._check_stacked(stage, out, len(pieces), target)
        return _StackedOut(StackedBatch(out, n_valid), slot_workers)

    # ----------------------------------------------------------- shuffle
    def _bucketize_fused(self, stage: SphereStage, out: _StackedOut, n: int,
                         rep: SphereReport):
        """One fused shuffle round: one stacked scatter, one host sync of
        the [s, n] histogram, one regrouping gather — regardless of task
        or worker count.  Returns None when the round cannot stay on the
        fused kernel path (the caller downgrades to the per-worker
        loop)."""
        rd = scatter_round_dispatch(out.stacked, stage.partitioner, n,
                                    worker_names=self.workers,
                                    slot_workers=out.slot_workers,
                                    pad_block=self.pad_block)
        if rd is None:
            return None
        rep.shuffle_rounds += 1
        with self.tracer.span("shuffle-round", track="shuffle",
                              attrs={"backend": "array", "path": "fused",
                                     "buckets": n}) as sp:
            rep.device_dispatches += rd.dispatches
            synced = _sync(rd.hist)                  # the round's ONE sync
            rep.host_syncs += 1
            if self.tracer.enabled:
                self.tracer.instant("host-sync", track="host-sync",
                                    attrs={"where": "fused-harvest"})
            result = rd.harvest(synced)
            rep.device_dispatches += result.dispatches
            rep.partitioned_records += out.stacked.num_records
            self._timing_barrier()
        rep.partition_seconds += sp.wall_seconds
        return result, result.origins

    def bucketize(self, stage: SphereStage, out, n: int, rep: SphereReport
                  ) -> Tuple[List[List[RecordBatch]], Origins]:
        """Dispatch-then-sync array shuffle.

        With ``fused_rounds`` the stage output arrives stacked and the
        whole round runs through :func:`scatter_round_dispatch`.
        Otherwise phase 1 enqueues each worker's scatter without
        blocking (:func:`scatter_pieces_dispatch`), and phase 2 fetches
        every pending histogram behind ONE barrier and slices each
        worker's per-bucket pieces — so a kernel-path shuffle round costs
        exactly one host sync, ``rep.host_syncs == rep.shuffle_rounds``.
        Degenerate batches (reduce rounds, single bucket) resolve at
        dispatch time; the host-loop fallback pays its sync at dispatch
        and says so."""
        # start-of-timing barrier (benchmarks only): partition_seconds
        # measures the shuffle round alone
        self._timing_barrier()
        if isinstance(out, _StackedOut):
            fused = self._bucketize_fused(stage, out, n, rep)
            if fused is not None:
                return fused
            # ineligible round (reduce partitioner, single bucket):
            # downgrade to the per-worker loop
            out = out.to_worker_dict(self.workers)
        buckets: List[List[RecordBatch]] = [[] for _ in range(n)]
        origins: Origins = [{} for _ in range(n)]
        rep.shuffle_rounds += 1
        with self.tracer.span("shuffle-round", track="shuffle",
                              attrs={"backend": "array",
                                     "path": "per-worker",
                                     "buckets": n}) as sp:
            round_: List[Tuple[str, int, object]] = []
            for w in self.workers:                  # phase 1: dispatch all
                pieces = out[w]
                if not pieces:
                    continue
                disp = scatter_pieces_dispatch(pieces, stage.partitioner, n,
                                               pad_block=self.pad_block)
                rep.host_syncs += disp.host_syncs
                if disp.host_syncs and self.tracer.enabled:
                    self.tracer.instant(
                        "host-sync", track="host-sync",
                        attrs={"where": "dispatch-fallback", "worker": w,
                               "count": disp.host_syncs})
                rep.device_dispatches += 1          # the worker's scatter
                round_.append((w, sum(p.num_records for p in pieces), disp))
            pending = [d for (_, _, d) in round_ if d.pending]
            if pending:                             # phase 2: one barrier
                synced = _sync(torch.stack([d.hist for d in pending]))
                rep.host_syncs += 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "host-sync", track="host-sync",
                        attrs={"where": "round-barrier",
                               "dispatches": len(pending)})
                for d, s in zip(pending, synced):
                    d.harvest(synced=s)
                    rep.device_dispatches += d.n    # per-bucket slices
            for w, nrec, disp in round_:
                for i, piece in enumerate(disp.harvest()):
                    if piece.num_records:
                        buckets[i].append(piece)
                        origins[i][w] = piece.nbytes
                rep.partitioned_records += nrec
            self._timing_barrier()
        rep.partition_seconds += sp.wall_seconds
        return buckets, origins

    def place_buckets(self, buckets, parts) -> None:
        # bucket i lives on worker i % len(workers); a destination holding
        # several buckets keeps them in bucket order (matching the bytes
        # path's append order), merged into one device-resident batch
        if isinstance(buckets, FusedRoundResult):
            # the fused round already regrouped on the device: slot i of
            # the stacked result IS worker i's merged partition — parts
            # hold zero-copy views into the stack
            if buckets.groups is not None:
                for w0, arr in buckets.groups:
                    g = StackedBatch(arr,
                                     buckets.counts[w0:w0 + arr.shape[0]])
                    for j in range(arr.shape[0]):
                        parts[self.workers[w0 + j]] = (
                            _SlotRef(g, j) if int(g.n_valid[j]) else None)
                return
            if buckets.data is None:
                for w in self.workers:
                    parts[w] = None
                return
            stacked = StackedBatch(buckets.data, buckets.counts)
            for i, w in enumerate(self.workers):
                parts[w] = (_SlotRef(stacked, i)
                            if int(stacked.n_valid[i]) else None)
            return
        incoming: Dict[str, List[RecordBatch]] = {w: [] for w in self.workers}
        for i, pieces in enumerate(buckets):
            incoming[self.workers[i % len(self.workers)]].extend(pieces)
        for w in self.workers:
            parts[w] = (RecordBatch.concat(incoming[w])
                        if incoming[w] else None)

    def set_parts(self, parts, out) -> None:
        if isinstance(out, _StackedOut):
            # partitionerless stage: each worker keeps its own slots
            slots: Dict[str, List[int]] = {w: [] for w in self.workers}
            for s, wi in enumerate(out.slot_workers):
                if int(out.stacked.n_valid[s]):
                    slots[self.workers[int(wi)]].append(s)
            for w in self.workers:
                own = slots[w]
                if not own:
                    parts[w] = None
                elif len(own) == 1:
                    parts[w] = _SlotRef(out.stacked, own[0])
                else:
                    parts[w] = RecordBatch.concat(
                        [out.stacked.slot(s) for s in own])
            return
        for w in self.workers:
            parts[w] = RecordBatch.concat(out[w]) if out[w] else None

    def outputs(self, parts) -> List[bytes]:
        # the ONLY host materialisation of record data after stage 0
        return [_as_batch(parts[w]).to_bytes() for w in self.workers
                if parts[w] is not None and parts[w].num_records]


def make_executor(backend: str, client, workers: Sequence[str], *,
                  max_retries: int = 3, pad_block: int = 4096,
                  cache_chunks: bool = False, prefetch: bool = True,
                  prefetch_depth: int = 1, timing_sync: bool = False,
                  fused_rounds: bool = True, mesh=None, tracer=None,
                  device=None):
    if backend == "array":
        return ArrayExecutor(client, workers, max_retries=max_retries,
                             pad_block=pad_block, cache_chunks=cache_chunks,
                             prefetch=prefetch, prefetch_depth=prefetch_depth,
                             timing_sync=timing_sync,
                             fused_rounds=fused_rounds, mesh=mesh,
                             tracer=tracer, device=device)
    return BytesExecutor(client, workers, max_retries=max_retries,
                         cache_chunks=cache_chunks, prefetch=prefetch,
                         prefetch_depth=prefetch_depth, tracer=tracer)
