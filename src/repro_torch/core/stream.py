"""Sphere Streams: windowed multi-file dataflow over the Sector event bus.

The paper's flagship application, Angle, continuously mines TCP-flow
feature windows *as they land in Sector* — the companion papers
(arXiv:0808.3019, arXiv:0809.1181) describe Sphere UDFs applied
incrementally to a growing, windowed collection of Sector files, with
compute following the data across the wide-area topology.

:class:`SphereStream` is that workload's engine-side half: a multi-file
generalization of :class:`repro.core.engine.SphereSession` that

* subscribes to a Sector path prefix (e.g. ``angle/window_``) on the
  master's event bus: every ``file-created`` whose path matches is an
  *arrival*;
* maintains a window policy (:class:`WindowPolicy` — tumbling, sliding,
  count-based, or event-**timed** with a simulated-clock watermark and a
  late-arrival grace period, for files landing at different sites at
  different times) over the arrival sequence; when the policy fires, the
  stream's current window becomes the policy's file set and the optional
  ``on_window`` callback runs — synchronously, during the upload that
  completed the window, which is exactly "the data waits for the task";
* plans **only the delta** when the window advances: a file entering the
  window gets one Sector lookup and one locality-scheduled group plan
  (:class:`repro.core.planner.IncrementalPlan`), files that stay keep
  their cached plan *and* their decoded device-resident chunks, and
  files that expire are retired — plan group dropped, chunks evicted —
  without touching surviving state.  ``SphereReport.planned_tasks`` /
  ``reused_tasks`` count the split, so the delta guarantee is testable;
* keeps per-window reduce state warm: the stage objects (and therefore
  their traced UDFs) outlive windows, so a streaming k-means re-fitting
  every window reports ``udf_traces == 1`` across the entire stream and
  warm-starts each window's centroids from the previous window's.

Membership events (``server-joined`` / ``server-died``) invalidate the
stream automatically: cached lookups, plans and chunks are keyed to the
old membership and are dropped, and the executor re-binds to the live
workers — the event-driven replacement for the old manual
``SphereSession.refresh()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.executor import make_executor
from repro_torch.core.job import SphereJob
from repro_torch.core.planner import (IncrementalPlan, SpherePlanner, SphereReport,
                                TaskSpec)
from repro_torch.core.trace import NULL_TRACER, link_track
from repro_torch.sector.events import weak_subscribe

__all__ = ["SphereStream", "WindowPolicy"]

# on_window callback: (stream, window_index, window_files)
WindowCallback = Callable[["SphereStream", int, Tuple[str, ...]], None]


# the weakref-subscription helper grew up and moved to the event bus
# module (the replication daemon needs it too); re-exported here for
# backwards compatibility with callers that imported the private name
_weak_subscribe = weak_subscribe


@dataclass(frozen=True)
class WindowPolicy:
    """Which arrivals form a window, and when windows fire.

    ``size`` is the window extent in files (``None`` = every arrival so
    far — a growing landmark window); ``step`` is how many arrivals pass
    between firings.  The classic shapes are classmethods:

    * ``tumbling(size)``   — non-overlapping: fires every ``size``
      arrivals over the latest ``size`` files;
    * ``sliding(size, step=1)`` — overlapping: fires every ``step``
      arrivals (once ``size`` have arrived) over the latest ``size``;
    * ``count(every=1)``   — count-based landmark: fires every ``every``
      arrivals over *all* files so far;
    * ``timed(span_s, grace_s=0.0)`` — EVENT-time tumbling windows on
      the simulated clock, for files landing at different sites at
      different times: arrival ``i`` belongs to bucket
      ``int(event_time // span_s)``, and a bucket fires once the
      *watermark* — the latest event time seen, minus the ``grace_s``
      late-arrival allowance — passes the bucket's end.  Buckets fire
      in order; a file whose bucket already fired is counted as late
      and dropped (``SphereStream.late_dropped``), never silently
      merged into the wrong window.  Count-based ``fires``/``window``
      do not apply to timed policies (windowing is driven by
      event time, not arrival count).
    """
    kind: str
    size: Optional[int]
    step: int
    span_s: float = 0.0     # timed windows: event-time extent, seconds
    grace_s: float = 0.0    # timed windows: late-arrival allowance, seconds

    def __post_init__(self):
        if self.kind not in ("tumbling", "sliding", "count", "time"):
            raise ValueError(f"unknown window kind {self.kind!r}")
        if self.size is not None and self.size < 1:
            raise ValueError("window size must be >= 1")
        if self.step < 1:
            raise ValueError("window step must be >= 1")
        if self.kind == "time":
            if self.span_s <= 0:
                raise ValueError("timed window span_s must be > 0")
            if self.grace_s < 0:
                raise ValueError("timed window grace_s must be >= 0")

    @classmethod
    def tumbling(cls, size: int) -> "WindowPolicy":
        return cls("tumbling", size, size)

    @classmethod
    def sliding(cls, size: int, step: int = 1) -> "WindowPolicy":
        return cls("sliding", size, step)

    @classmethod
    def count(cls, every: int = 1) -> "WindowPolicy":
        return cls("count", None, every)

    @classmethod
    def timed(cls, span_s: float, grace_s: float = 0.0) -> "WindowPolicy":
        return cls("time", None, 1, span_s, grace_s)

    def fires(self, n_arrivals: int) -> bool:
        """Does the ``n_arrivals``-th arrival complete a window?
        (Count-based policies only; timed windows fire on watermark.)"""
        if self.kind == "time":
            return False
        if self.size is None:
            return n_arrivals % self.step == 0
        return (n_arrivals >= self.size
                and (n_arrivals - self.size) % self.step == 0)

    def window(self, arrivals: Sequence[str]) -> Tuple[str, ...]:
        """The file set of the window ending at the latest arrival."""
        if self.size is None:
            return tuple(arrivals)
        return tuple(arrivals[-self.size:])


class SphereStream:
    """One planner + one executor shared by every window of a stream.

    See the module docstring for the model.  Jobs run against the
    *current* window with :meth:`run`, exactly like a session: stage 0
    reads the window's files through the merged incremental plan and the
    shared chunk cache, later stages plan fresh per job, and
    ``input="chained"`` consumes the previous job's output partitions
    (chained state is per-window — it is dropped when the window
    advances).  :class:`repro.core.engine.SphereSession` is the
    single-file special case: a stream pinned to one file with no
    subscription-driven window advance.
    """

    _kind = "stream"

    def __init__(self, engine, prefix: Optional[str] = None, *,
                 window: Optional[WindowPolicy] = None,
                 record_size: int = 0, backend: str = "bytes",
                 cache_chunks: bool = True, files: Sequence[str] = ()):
        self.engine = engine
        self.prefix = prefix
        self.window_policy = window or WindowPolicy.count(1)
        self.record_size = record_size
        self.backend = backend
        self._cache_chunks = cache_chunks
        # contention-aware engines hand the planner the physical-path
        # mapping so cross-site transfers queue per link; blind engines
        # (and engines predating the knob) plan with private links
        link_of = (engine._link_of
                   if getattr(engine, "contention_aware", False)
                   and hasattr(engine, "_link_of") else None)
        self.tracer = getattr(engine, "tracer", None) or NULL_TRACER
        self.planner = SpherePlanner(speeds=engine.speeds,
                                     speculate_factor=engine.speculate_factor,
                                     move_time=engine._move_time,
                                     link_of=link_of,
                                     offload=getattr(engine, "offload",
                                                     False),
                                     tracer=self.tracer)
        self._plan = IncrementalPlan()           # one group per window file
        self._file_tasks: Dict[str, List[TaskSpec]] = {}
        self._stragglers: Dict[str, Dict[str, int]] = {}
        self._parts = None                       # last job's output partitions
        self._window_cb: Optional[WindowCallback] = None
        # arrivals holds only what the policy can still use: the full
        # history for landmark count() windows, the trailing `size` for
        # bounded windows (a stream runs indefinitely — it must not
        # accumulate every file name ever seen).  _arrived is the O(1)
        # dedup set, trimmed in lockstep (Sector file names are unique —
        # create_file raises on a duplicate — so dedup only guards
        # against a re-published event for a still-windowed file);
        # _n_arrivals is the lifetime count driving fires().
        self.arrivals: List[str] = []
        self._arrived: set = set()
        self._n_arrivals = 0
        # timed-window state (kind == "time"): files buffered per
        # event-time bucket until the watermark passes the bucket's end;
        # buckets fire strictly in order starting at _next_bucket, and a
        # unique file landing in an already-fired bucket bumps
        # late_dropped instead of joining a window.
        self._timed_pending: Dict[int, List[str]] = {}
        self._max_event_time = float("-inf")
        self._next_bucket = 0
        self.late_dropped = 0
        self.window_files: Tuple[str, ...] = tuple(files)
        self.windows_formed = 0
        self.jobs_run = 0
        self.closed = False
        self._needs_bind = False
        self._bind_cluster()
        bus = engine.master.events
        self._subs = [_weak_subscribe(bus, self, "_on_membership_event",
                                      types=("server-joined",
                                             "server-died"))]
        if prefix is not None:
            self._subs.append(_weak_subscribe(bus, self, "_on_file_event",
                                              types=("file-created",),
                                              prefix=prefix))

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Unsubscribe from the event bus (idempotent).  A closed stream
        keeps its caches and can still run jobs; it just stops reacting
        to cluster events."""
        for sub in self._subs:
            self.engine.master.events.unsubscribe(sub)
        self._subs = []
        self.closed = True

    def __enter__(self) -> "SphereStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _bind_cluster(self) -> None:
        self._workers = self.engine._workers()
        if not self._workers:
            raise RuntimeError("no live workers")
        self.executor = make_executor(self.backend, self.engine.client,
                                      self._workers,
                                      max_retries=self.engine.max_retries,
                                      pad_block=self.engine.pad_block,
                                      cache_chunks=self._cache_chunks,
                                      prefetch=self.engine.prefetch,
                                      prefetch_depth=getattr(
                                          self.engine, "prefetch_depth", 1),
                                      timing_sync=self.engine.timing_sync,
                                      fused_rounds=getattr(
                                          self.engine, "fused_rounds", True),
                                      mesh=getattr(self.engine, "mesh", None),
                                      tracer=self.tracer,
                                      device=self.engine.device)
        self._needs_bind = False

    @property
    def workers(self) -> List[str]:
        """Live workers this stream is bound to, re-derived lazily after
        a membership event invalidated the binding."""
        if self._needs_bind:
            self._bind_cluster()
        return self._workers

    # ------------------------------------------------------------- events
    def on_window(self, callback: WindowCallback) -> "SphereStream":
        """Register the per-window callback, invoked synchronously as
        ``callback(stream, window_index, window_files)`` whenever the
        policy fires (i.e. during the upload that completed a window)."""
        self._window_cb = callback
        return self

    def _on_file_event(self, event) -> None:
        name = event.path
        if self.closed or name in self._arrived:
            return
        if self.window_policy.kind == "time":
            self._on_timed_arrival(name, event)
            return
        self._arrived.add(name)
        self.arrivals.append(name)
        self._n_arrivals += 1
        size = self.window_policy.size
        if size is not None and len(self.arrivals) > size:
            del self.arrivals[:-size]
            self._arrived = set(self.arrivals)
        if self.window_policy.fires(self._n_arrivals):
            self._advance(self.window_policy.window(self.arrivals))

    # ------------------------------------------------------ timed windows
    def _on_timed_arrival(self, name: str, event) -> None:
        """Event-time windowing: bucket the arrival by the file's real
        landing time (``event_time`` in the event detail — the master's
        published ``time`` is its monotonic clock, which would clamp a
        late landing forward and hide its lateness), then flush every
        bucket the watermark has passed."""
        pol = self.window_policy
        self._arrived.add(name)  # late files dedup + count exactly once
        t = float(event.detail.get("event_time", event.time))
        bucket = int(t // pol.span_s)
        if bucket < self._next_bucket:
            self.late_dropped += 1
            return
        self._n_arrivals += 1
        self._timed_pending.setdefault(bucket, []).append(name)
        if t > self._max_event_time:
            self._max_event_time = t
        self._flush_watermark()

    @property
    def watermark(self) -> float:
        """Current event-time watermark: the latest landing time seen,
        minus the grace allowance (``-inf`` before any timed arrival)."""
        return self._max_event_time - self.window_policy.grace_s

    def advance_watermark(self, now: float) -> None:
        """Declare that simulated time has reached ``now`` even though
        no file said so (the stream's clock only advances on arrivals):
        fires every pending timed bucket whose end the new watermark
        passes.  Callers use this to flush the final window(s) of a
        bounded run, or to time out a quiet period."""
        if self.window_policy.kind != "time":
            raise ValueError("advance_watermark applies to timed "
                             "windows only")
        if now > self._max_event_time:
            self._max_event_time = float(now)
        self._flush_watermark()

    def _flush_watermark(self) -> None:
        pol = self.window_policy
        watermark = self._max_event_time - pol.grace_s
        while (self._next_bucket + 1) * pol.span_s <= watermark:
            files = self._timed_pending.pop(self._next_bucket, None)
            self._next_bucket += 1
            if files:  # empty event-time spans form no window
                self._advance(tuple(files))

    def _advance(self, new_window: Tuple[str, ...]) -> None:
        for f in self.window_files:
            if f not in new_window:
                self._retire_file(f)
        # chained partitions are per-window state: the window changed
        self._parts = None
        self.window_files = tuple(new_window)
        self.windows_formed += 1
        if self.tracer.enabled:
            self.tracer.instant("stream:window-advance", track="stream",
                                attrs={"window": self.windows_formed - 1,
                                       "files": len(new_window)})
        if self._window_cb is not None:
            self._window_cb(self, self.windows_formed - 1, self.window_files)

    def _retire_file(self, name: str) -> None:
        """Expire one file: drop its plan group and evict its decoded
        chunks.  Surviving files' state is untouched."""
        tasks = self._file_tasks.pop(name, None)
        if tasks:
            self.executor.evict_chunks(t.key for t in tasks)
        self._plan.retire(name)
        self._stragglers.pop(name, None)
        if self.tracer.enabled:
            self.tracer.instant("stream:evict-file", track="stream",
                                attrs={"file": name,
                                       "chunks": len(tasks or ())})

    def _on_membership_event(self, event) -> None:
        if not self.closed:
            self._invalidate()

    def _invalidate(self) -> None:
        """Membership changed: every cached lookup, plan and chunk was
        keyed to the old cluster.  Drop them now, but re-bind to the
        live workers lazily at the next :meth:`run` — the death of the
        LAST worker must not blow up the master's failure sweep from
        inside an event callback; it surfaces as "no live workers" to
        the next caller instead.  Traced stage UDFs live on the stage
        objects, not the executor, so re-running a job after
        invalidation re-plans and re-fetches but does NOT re-trace."""
        self._plan = IncrementalPlan()
        self._file_tasks = {}
        self._stragglers = {}
        self._parts = None
        self._needs_bind = True

    # -------------------------------------------------------------- plans
    def _ensure_planned(self, rep: SphereReport) -> None:
        """Extend the incremental plan to cover the current window: only
        files without a cached group pay a Sector lookup + placement."""
        master = self.engine.master
        for f in self.window_files:
            if f in self._plan:
                rep.reused_tasks += len(self._plan.groups[f].tasks)
                continue
            tasks = self._file_tasks.get(f)
            if tasks is None:
                metas = master.lookup(f, self.engine.client.user)
                tasks = [TaskSpec(m.chunk_id, m.size,
                                  tuple(s for s in m.locations
                                        if s in master.servers
                                        and master.servers[s].alive))
                         for m in metas]
                self._file_tasks[f] = tasks
            plan, contrib = self.planner.extend_plan(
                self._plan, f, self.engine._schedule_view(tasks),
                self.workers)
            self._stragglers[f] = contrib
            rep.planned_tasks += len(plan.tasks)
            if self.tracer.enabled:
                self.tracer.instant("stream:plan-extend", track="stream",
                                    attrs={"file": f,
                                           "planned": len(plan.tasks)})

    # ----------------------------------------------------------- validate
    @property
    def _job_input(self) -> Optional[str]:
        """What a job's ``input_file`` must name (None = not checked):
        the subscription prefix, or the pinned file of a single-file
        stream/session."""
        if self.prefix is not None:
            return self.prefix
        if len(self.window_files) == 1:
            return self.window_files[0]
        return None

    @property
    def job_input_name(self) -> str:
        """A valid ``SphereJob.input_file`` for jobs run on this stream."""
        return self._job_input or ""

    def _validate(self, job: SphereJob, input: str) -> None:
        if input not in ("file", "chained"):
            raise ValueError(f"unknown {self._kind} input {input!r}; "
                             f"choose 'file' or 'chained'")
        if job.backend != self.backend:
            raise ValueError(f"job backend {job.backend!r} != {self._kind} "
                             f"backend {self.backend!r}")
        if job.record_size != self.record_size:
            raise ValueError(f"job record_size {job.record_size} != "
                             f"{self._kind} record_size {self.record_size}")
        if (input == "file" and self._job_input is not None
                and job.input_file != self._job_input):
            raise ValueError(f"job reads {job.input_file!r} but this "
                             f"{self._kind} chains over {self._job_input!r}")
        chunk = self.engine.master.chunk_size
        if job.record_size and chunk % job.record_size:
            raise ValueError(
                f"chunk_size {chunk} must be a multiple of "
                f"record_size {job.record_size} (records must not straddle "
                f"chunk boundaries)")

    # ----------------------------------------------------------------- run
    def run(self, job: SphereJob, report: Optional[SphereReport] = None, *,
            input: str = "file") -> Tuple[List[bytes], SphereReport]:
        """Execute one job against the current window.  ``input="file"``
        reads the window's Sector files through the cached delta plans
        and chunk cache; ``"chained"`` consumes the previous job's output
        partitions in place (dropped when the window advances).  Returns
        (per-bucket output blobs, report)."""
        self._validate(job, input)
        rep = report or SphereReport()
        tracer = self.tracer
        metrics = getattr(self.engine, "metrics", None)
        if metrics is not None and rep.__dict__.get("_metrics") is None:
            # mirror this report's counters into the engine's registry;
            # the unique per-bind ``run`` label keeps two reports (e.g.
            # a chained A/B pair) on distinct series
            rep.bind_metrics(metrics, kind=self._kind,
                             backend=self.backend,
                             **metrics.next_run_labels())
        workers = self.workers
        planner, executor = self.planner, self.executor
        planner.reset_job_state()
        with tracer.span(f"job:{job.name}", track="control",
                         attrs={"kind": self._kind,
                                "backend": self.backend,
                                "input": input}):
            return self._run_stages(job, rep, input, workers,
                                    planner, executor, tracer)

    def _run_stages(self, job: SphereJob, rep: SphereReport, input: str,
                    workers, planner, executor, tracer
                    ) -> Tuple[List[bytes], SphereReport]:
        if input == "chained":
            if self._parts is None:
                raise RuntimeError("no previous job output to chain from")
            parts = self._parts
            sizes = executor.part_sizes(parts)
            tasks = [TaskSpec(w, sz, (w,))
                     for w, sz in sizes.items() if sz]
            first = False
        else:
            if not self.window_files:
                raise RuntimeError(
                    f"no window formed yet on this {self._kind} (waiting "
                    f"for file-created events matching {self.prefix!r})")
            self._ensure_planned(rep)
            parts = executor.empty_parts()
            tasks = []
            first = True

        for stage in job.stages:
            with tracer.span(f"plan:{stage.name}", track="control",
                             attrs={"first": first}):
                if first:
                    plan = self._plan.merged()
                    # replay the straggler observations planning each
                    # window file's group made, so later stages of every
                    # job over this window see exactly the per-job state
                    # a fresh plan would produce
                    for contrib in self._stragglers.values():
                        for w, c in contrib.items():
                            planner.job_stragglers[w] = \
                                planner.job_stragglers.get(w, 0) + c
                else:
                    plan = planner.plan_stage(
                        self.engine._schedule_view(tasks), workers)
                self.engine._check_plan(stage.name, plan)
            rep.tasks += len(plan.tasks)
            rep.bytes_local += plan.bytes_local
            rep.bytes_moved += plan.bytes_moved
            rep.speculated += plan.speculated
            rep.speculation_wins += plan.speculation_wins
            rep.link_wait_seconds += plan.link_wait
            t_stage = plan.seconds
            if tracer.enabled:
                # simulated-clock timeline: one span per task on its
                # executing worker's track, one per reserved transfer on
                # its physical link's track, all offset to the job's
                # running simulated clock
                offset = rep.sim_seconds
                for p in plan.tasks:
                    end = offset + p.finish
                    begin = max(offset, end - planner._proc_time(
                        p.executor, p.nbytes))
                    tracer.add_span(
                        f"task:{p.key}", track=f"worker:{p.executor}",
                        t0=begin, t1=end, clock="sim",
                        attrs={"nbytes": p.nbytes, "planned": p.worker,
                               "stage": stage.name})
                for key, tkey, begin, end in plan.transfers:
                    tracer.add_span(
                        f"xfer:{tkey}", track=link_track(key),
                        t0=offset + begin, t1=offset + end, clock="sim",
                        attrs={"task": tkey, "stage": stage.name})

            with tracer.span(f"exec:{stage.name}", track="control",
                             attrs={"tasks": len(plan.tasks)}):
                out = executor.run_stage(job, stage, plan, parts, rep,
                                         first_stage=first)
            if stage.partitioner is not None:
                with tracer.span(f"shuffle:{stage.name}", track="control"):
                    n = stage.n_buckets or len(workers)
                    buckets, origins = executor.bucketize(stage, out, n,
                                                          rep)
                    # bucket i lives on worker i % len(workers); charge
                    # the movement of each fragment from its actual
                    # origin worker
                    flows = [(src, workers[i % len(workers)], nbytes)
                             for i, origin in enumerate(origins)
                             for src, nbytes in origin.items()]
                    t_shuffle, moved, local = planner.plan_shuffle(flows)
                    rep.bytes_moved += moved
                    rep.bytes_local += local
                    t_stage += t_shuffle
                    executor.place_buckets(buckets, parts)
            else:
                executor.set_parts(parts, out)

            sizes = executor.part_sizes(parts)
            t_stage += self.engine._stage_barrier_seconds(sum(sizes.values()))
            rep.observe_stage(t_stage)
            rep.sim_seconds += t_stage
            first = False
            # next stage's tasks are the current partitions (local to owner)
            tasks = [TaskSpec(w, sz, (w,))
                     for w, sz in sizes.items() if sz]

        moved_total = rep.bytes_moved + rep.bytes_local
        rep.locality_fraction = (rep.bytes_local / moved_total
                                 if moved_total else 1.0)
        self._parts = parts
        self.jobs_run += 1
        return executor.outputs(parts), rep
