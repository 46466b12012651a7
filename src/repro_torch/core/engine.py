"""Sphere engine: locality-aware scheduling, load balancing, stragglers,
fault tolerance (paper §4) — the thin orchestrator over the
planner/executor split.

Per the paper, Sphere provides: locating data, moving data **only if
required**, locating/managing compute, load balancing, and fault tolerance;
parallelisation is implicit.  The execution model:

  * compute workers are the Sector chunk servers themselves (compute sits
    on the storage cloud — "data waits for the task");
  * the **planner** (:mod:`repro.core.planner`) is pure: it schedules each
    chunk task on a replica holder when one has capacity (zero movement),
    else on the least-loaded worker; speculatively re-executes observed
    stragglers on idle replicas (earliest copy wins); and prices the
    shuffle from the actual per-bucket origin flows — all in simulated
    time, with no access to record data;
  * the **executor** (:mod:`repro.core.executor`) is the data plane: it
    fetches chunks (bounded retries over surviving replicas — Sector's
    replication guarantee), runs UDFs for real on the planned workers,
    and bucketizes stage output.  ``backend="bytes"`` is the per-record
    reference; ``backend="array"`` keeps each worker's partition as one
    device-resident RecordBatch across stages and traces pad-stable
    stage UDFs once;
  * between stages, records are bucketed by the stage partitioner and
    buckets move to their owning worker over the simulated WAN — the
    Sphere shuffle, charged from each bucket's real origin workers.

Iterative / multi-job workloads run through a :class:`SphereSession` —
one planner + one executor amortised across a *chain* of jobs over the
same dataset (the paper's "a stream of jobs over the same data" use
case, dominant for the Angle data-mining workload).  The session runs
the Sector chunk lookup once, computes replica placement (the stage-0
plan) once, keeps stage-0 chunks and job output partitions
device-resident between jobs, and preserves the executor's traced-UDF
cache so a stage re-run every iteration compiles exactly once.

A session is the single-file special case of a
:class:`repro.core.stream.SphereStream` — the windowed multi-file
generalization that subscribes to a Sector path prefix on the master's
event bus and plans only the per-window delta (see
:mod:`repro.core.stream`).  Both invalidate automatically on
``server-joined`` / ``server-died`` events; the old manual
``SphereSession.refresh()`` is a deprecated no-op.

UDF outputs are correct Python bytes while time is fully simulated, so
unit tests assert both output correctness and scheduling properties
(locality fraction, speculation wins, retry counts) — and because the
planner only sees task *sizes*, every scheduling counter and simulated
second agrees across the two backends for the same job.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

from repro_torch.core.job import SphereJob
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.planner import (PROCESS_RATE, SphereReport, TaskSpec)
from repro_torch.core.stream import SphereStream, WindowPolicy
from repro_torch.core.trace import NULL_TRACER, Tracer
from repro_torch.device import resolve_device
from repro_torch.sector.client import SectorClient
from repro_torch.sector.master import SectorMaster
from repro_torch.sector.transport import simulate_transfer

__all__ = ["SphereEngine", "SphereSession", "SphereStream", "SphereReport",
           "WindowPolicy", "PROCESS_RATE", "Tracer", "MetricsRegistry"]


class SphereEngine:
    def __init__(self, master: SectorMaster, client: SectorClient,
                 speeds: Optional[Dict[str, float]] = None,
                 speculate_factor: float = 1.8, max_retries: int = 3,
                 pad_block: int = 4096, prefetch: bool = True,
                 prefetch_depth: int = 1, timing_sync: bool = False,
                 fused_rounds: bool = True, mesh=None,
                 contention_aware: bool = True, offload: bool = False,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "the multi-GPU mesh round is not ported yet (core/spmd.py)")
        # the torch device every array-backend executor keeps records on;
        # None means CUDA, and raises when no CUDA device is present
        self.device = resolve_device(device)
        self.master = master
        self.client = client
        # observability plane: a recording Tracer threads spans through
        # every planner/executor/stream this engine builds and turns the
        # master's bus events into timeline instants; the default
        # NULL_TRACER records nothing and costs nothing.  The metrics
        # registry mirrors every report the engine's runs write.
        self.tracer = tracer or NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if self.tracer.enabled:
            self.master.tracer = self.tracer
            self.tracer.attach_bus(master.events)
        self.speeds = speeds or {}
        self.speculate_factor = speculate_factor
        self.max_retries = max_retries
        self.pad_block = pad_block
        # contention_aware: planners built by this engine's sessions and
        # streams price cross-site transfers with per-link capacity
        # accounting (tasks sharing a wide-area wave queue on it) rather
        # than as private parallel links; the contention-blind estimate
        # is kept available (off) for the WAN benchmark's comparison.
        # offload: let the planner place stage tasks on non-replica
        # workers when the priced cross-site fetch still wins (default
        # off = the paper's locality-first placement).
        self.contention_aware = contention_aware
        self.offload = offload
        # prefetch: overlap stage-0 chunk fetch+decode of the next
        # ``prefetch_depth`` tasks with the dispatch of task i
        # (result-identical at any depth — off only for A/B tests and
        # debugging).  timing_sync: block on shuffled pieces before
        # stopping the partition_seconds clock — the benchmark-honesty
        # knob; leave off in production, where eager timers would
        # serialise the async data plane they measure.
        self.prefetch = prefetch
        self.prefetch_depth = prefetch_depth
        self.timing_sync = timing_sync
        # fused_rounds: run each array-backend round (UDF applies +
        # scatter + regrouping) over a stacked worker axis in O(1)
        # compiled dispatches; with ``mesh`` the stacked round lowers
        # through shard_map with an all_to_all exchange (spmd module).
        self.fused_rounds = fused_rounds
        self.mesh = mesh

    # ------------------------------------------------------------- helpers
    def _workers(self) -> List[str]:
        return sorted(sid for sid in self.master.ring.servers()
                      if self.master.servers[sid].alive)

    def _move_time(self, nbytes: int, src: str, dst: str) -> float:
        link = self.master.topology.link(self.master.servers[src].site,
                                         self.master.servers[dst].site)
        return simulate_transfer(nbytes, link, self.client.protocol).seconds

    def _link_of(self, src: str, dst: str):
        """Physical path a worker-to-worker transfer rides — the
        planner's per-link capacity-accounting key (None = uncontended
        intra-site movement).  Workers at the same site pair share a
        key, so their transfers queue on the one wide-area wave."""
        return self.master.topology.link_key(self.master.servers[src].site,
                                             self.master.servers[dst].site)

    # ------------------------------------------------- benchmark hooks
    def _schedule_view(self, tasks: List[TaskSpec]) -> List[TaskSpec]:
        """What replica placement the scheduler sees (overridden by the
        Hadoop-style comparison engine to hide locality)."""
        return tasks

    def _stage_barrier_seconds(self, stage_output_nbytes: int) -> float:
        """Extra materialisation cost after a stage (0 for Sphere; the
        Hadoop-style engine charges a write+read barrier here)."""
        return 0.0

    # ------------------------------------------------------------ sessions
    def session(self, input_file: str, *, record_size: int = 0,
                backend: str = "bytes", cache_chunks: bool = True
                ) -> "SphereSession":
        """Open a job-chaining session over ``input_file`` (one planner,
        one executor, one Sector lookup for the whole chain)."""
        return SphereSession(self, input_file, record_size=record_size,
                             backend=backend, cache_chunks=cache_chunks)

    def stream(self, prefix: str, *, window: Optional[WindowPolicy] = None,
               record_size: int = 0, backend: str = "bytes",
               cache_chunks: bool = True) -> SphereStream:
        """Open a windowed multi-file stream subscribed to every Sector
        file whose name starts with ``prefix`` (see
        :mod:`repro.core.stream`)."""
        return SphereStream(self, prefix, window=window,
                            record_size=record_size, backend=backend,
                            cache_chunks=cache_chunks)

    # ----------------------------------------------------------------- run
    def run(self, job: SphereJob, report: Optional[SphereReport] = None
            ) -> Tuple[List[bytes], SphereReport]:
        """Execute all stages. Returns (per-bucket output blobs, report).

        One-shot form: builds a throwaway session (fresh planner, fresh
        executor, no cross-job caches) — iterative callers should hold a
        :meth:`session` instead.
        """
        session = SphereSession(self, job.input_file,
                                record_size=job.record_size,
                                backend=job.backend, cache_chunks=False)
        try:
            return session.run(job, report)
        finally:
            session.close()


class SphereSession(SphereStream):
    """One planner + one executor shared by a chain of Sphere jobs.

    The per-job engine path re-derives everything on every ``run``:
    Sector metadata lookup, replica placement, a cold executor whose
    pad-stable/mask-aware UDFs must re-trace.  A session hoists all of
    that to the chain level:

      * the Sector chunk lookup for ``input_file`` runs once, lazily, and
        the resulting stage-0 task specs are reused by every job that
        reads the file;
      * replica placement for stage 0 (the dominant planning cost) is
        computed once — the planner is deterministic over task sizes, so
        the cached plan is exactly what re-planning would produce, and
        its counters are re-charged to each job's report;
      * the executor persists: stage-0 chunks are fetched and decoded
        once (``cache_chunks``), traced UDFs stay compiled (a stage
        object re-run each iteration reports ``udf_traces == 1`` across
        the whole chain), and each job's output partitions stay
        device-resident;
      * ``run(job, input="chained")`` feeds the previous job's output
        partitions straight into the next job's stage 0 — no host
        round-trip, no Sector traffic;
      * speculation/straggler observations reset at every job boundary
        (:meth:`SpherePlanner.reset_job_state`), so behaviour per job is
        identical to a fresh engine run.

    Implementation-wise this is a :class:`SphereStream` pinned to one
    file: the window never advances, so the incremental stage-0 plan has
    exactly one group for the whole chain.  Membership changes
    (``server-joined`` / ``server-died`` on the master's event bus)
    invalidate the cached lookup/plan/chunks automatically — chained
    partitions too, since they are keyed to the old membership.
    """

    _kind = "session"

    def __init__(self, engine: SphereEngine, input_file: str, *,
                 record_size: int = 0, backend: str = "bytes",
                 cache_chunks: bool = True):
        super().__init__(engine, record_size=record_size, backend=backend,
                         cache_chunks=cache_chunks, files=(input_file,))
        self.input_file = input_file

    def refresh(self) -> None:
        """Deprecated no-op.  Sessions subscribe to the master's event
        bus and invalidate automatically when membership changes; there
        is nothing left to refresh by hand."""
        warnings.warn(
            "SphereSession.refresh() is deprecated and now a no-op: "
            "sessions invalidate automatically on server-joined/"
            "server-died events from the Sector master's event bus",
            DeprecationWarning, stacklevel=2)
