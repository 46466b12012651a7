"""Sphere control plane: pure locality/speculation planner (paper §4).

``SpherePlanner`` is the scheduling half of the engine's planner/executor
split.  It decides *where* every task runs and *how long* the stage takes
in simulated time — locality first, then least-(estimated)-loaded, with
speculative re-execution of observed stragglers on replicas — without
touching any data.  Its only effect is the returned :class:`StagePlan`,
so scheduling behaviour is unit-testable with no Sector cloud at all:
callers inject ``move_time(nbytes, src_worker, dst_worker)`` and per-
worker ``speeds``; identical inputs always produce identical plans.

Scheduling uses ESTIMATED speeds (uniform — the scheduler does not know a
node is slow until it runs); execution reveals actual speeds, and
speculation re-runs the surprises on replicas.  This mirrors the paper's
load balancing: replicas exist precisely so slow nodes can be routed
around after the fact.

Wide-area contention (the paper's whole premise is scheduling over shared
10 Gbps waves, §5/Table 1) enters through two opt-in knobs:

* ``link_of(src_worker, dst_worker)`` maps a transfer to the *physical
  path* it rides (``None`` = uncontended; the engine wires this to
  :meth:`repro.sector.topology.Topology.link_key`).  When set, every
  cross-worker move reserves time on a per-link
  :class:`~repro.sector.topology.LinkSchedule`: transfers sharing a wave
  queue behind each other instead of being priced as if each had a
  private link, in ``plan_stage`` candidate scoring, in
  ``plan_shuffle``'s flow merge, and in
  :meth:`IncrementalPlan.merged`'s transfer-group ready-time merge.
* ``offload=True`` widens stage placement from replica-holders-only to
  every worker, with the cross-site fetch priced into the candidate
  score — the WAN scenario where remote capacity is worth renting *if*
  the link can carry the bytes in time.

Both default off, in which case planning is bit-identical to the
contention-blind behaviour (every pre-existing test and benchmark sees
the same plans).  :meth:`SpherePlanner.price_plan` re-prices any fixed
assignment under *this* planner's link model — how the WAN benchmark
charges a contention-blind plan its true, queued cost.

The data-plane half (fetching chunks, running UDFs, bucketizing records)
lives in :mod:`repro.core.executor`; :class:`repro.core.engine.SphereEngine`
glues the two together.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.trace import NULL_TRACER
from repro_torch.sector.topology import LinkSchedule

PROCESS_RATE = 400e6  # bytes/s of UDF processing on a speed-1.0 worker

# simulated seconds to move nbytes between two workers' sites
MoveTime = Callable[[int, str, str], float]
# physical path a worker-to-worker transfer rides (None = uncontended)
LinkOf = Callable[[str, str], Optional[Hashable]]

# SphereReport fields mirrored 1:1 into a bound MetricsRegistry as
# ``sphere.<field>`` counters (the numeric accumulate-only fields);
# locality_fraction mirrors as a gauge, stage_seconds as a histogram
# (via observe_stage) and udf_traces as per-stage gauges (via
# note_udf_traces).
_MIRRORED_COUNTERS = frozenset({
    "sim_seconds", "bytes_moved", "bytes_local", "tasks", "speculated",
    "speculation_wins", "retried", "partition_seconds",
    "partitioned_records", "planned_tasks", "reused_tasks",
    "shuffle_rounds", "host_syncs", "device_dispatches",
    "link_wait_seconds"})


@dataclass
class SphereReport:
    sim_seconds: float = 0.0
    bytes_moved: int = 0
    bytes_local: int = 0
    tasks: int = 0
    speculated: int = 0
    speculation_wins: int = 0
    retried: int = 0
    locality_fraction: float = 1.0
    stage_seconds: List[float] = field(default_factory=list)
    # REAL wall-clock spent computing bucket assignments + scattering
    # records in shuffles (everything else above is simulated time) —
    # the bytes-vs-array backend comparison the benchmarks report.
    partition_seconds: float = 0.0
    partitioned_records: int = 0
    # array backend: number of distinct shapes each pad-stable stage UDF
    # was traced with (1 = the jit-once guarantee held for that stage)
    udf_traces: Dict[str, int] = field(default_factory=dict)
    # streams/sessions: stage-0 tasks that got FRESH replica placement
    # this run vs. tasks replayed from a cached per-file plan — the
    # delta-planning guarantee ("only new chunks are planned") is
    # asserted on these two counters.
    planned_tasks: int = 0
    reused_tasks: int = 0
    # overlap accounting for the dispatch-then-sync shuffle: shuffle
    # rounds executed, and how often the data plane blocked the host on
    # the device during them.  The array backend harvests every worker
    # batch's histogram behind ONE barrier, so a kernel-path shuffle
    # round costs exactly one host sync (host_syncs == shuffle_rounds —
    # not workers x rounds); reduce/degenerate rounds resolve with zero
    # syncs, and the bytes backend never syncs a device at all.
    shuffle_rounds: int = 0
    host_syncs: int = 0
    # array backend: compiled device dispatches issued by the data plane's
    # hot loop (stage UDF applies in run_stage + scatter/harvest work in
    # bucketize).  The fused-round invariant is asserted on this counter:
    # with ``fused_rounds`` a kernel-path shuffle round costs O(1)
    # dispatches (one stacked UDF call, a bounded shard fan of scatter
    # calls, one regrouping gather) regardless of task or worker count,
    # where the per-task/per-worker loop costs O(tasks + workers).
    device_dispatches: int = 0
    # contention-aware planning: simulated seconds transfers spent
    # QUEUED behind other transfers on shared wide-area links (0.0 when
    # the planner runs contention-blind or every move rode a private
    # path).  The gap between a contention-blind estimate and reality.
    link_wait_seconds: float = 0.0

    # ------------------------------------------------------ metrics mirror
    def bind_metrics(self, registry, **labels) -> "SphereReport":
        """Mirror this report into ``registry``: from now on every
        counter-field mutation forwards its delta to the matching
        ``sphere.<field>`` series, so registry reads and report fields
        are two views of one write path (the report's current values
        are seeded first — binding mid-run loses nothing).  Labels
        identify this report's series; the engine adds a unique ``run``
        label per binding so chained reports never collide."""
        object.__setattr__(self, "_metrics", registry)
        object.__setattr__(self, "_metric_labels", dict(labels))
        for name in _MIRRORED_COUNTERS:
            v = getattr(self, name)
            if v:
                registry.counter(f"sphere.{name}", **labels).inc(v)
        registry.gauge("sphere.locality_fraction",
                       **labels).set(self.locality_fraction)
        for s in self.stage_seconds:
            registry.histogram("sphere.stage_seconds", **labels).observe(s)
        for stage, n in self.udf_traces.items():
            registry.gauge("sphere.udf_traces", stage=stage,
                           **labels).set(n)
        return self

    @property
    def metric_labels(self) -> Dict[str, str]:
        """Labels this report's mirrored series carry ({} if unbound)."""
        return dict(getattr(self, "_metric_labels", {}))

    def __setattr__(self, name: str, value) -> None:
        m = self.__dict__.get("_metrics")
        if m is not None:
            if name in _MIRRORED_COUNTERS:
                delta = value - self.__dict__.get(name, 0)
                if delta:
                    m.counter(f"sphere.{name}",
                              **self._metric_labels).inc(delta)
            elif name == "locality_fraction":
                m.gauge("sphere.locality_fraction",
                        **self._metric_labels).set(value)
        object.__setattr__(self, name, value)

    def observe_stage(self, seconds: float) -> None:
        """Record one stage's simulated makespan (the ONE write path for
        ``stage_seconds`` — list append + histogram observation)."""
        self.stage_seconds.append(seconds)
        m = self.__dict__.get("_metrics")
        if m is not None:
            m.histogram("sphere.stage_seconds",
                        **self._metric_labels).observe(seconds)

    def note_udf_traces(self, stage: str, traces: int) -> None:
        """Record a stage UDF's distinct traced shapes (max-aggregated
        per stage name: a retracing stage must not be masked by a later
        same-named stage that traced once)."""
        self.udf_traces[stage] = max(self.udf_traces.get(stage, 0), traces)
        m = self.__dict__.get("_metrics")
        if m is not None:
            m.gauge("sphere.udf_traces", stage=stage,
                    **self._metric_labels).set(self.udf_traces[stage])


@dataclass(frozen=True)
class TaskSpec:
    """One schedulable unit of work: a chunk (stage 0) or a worker's
    partition (later stages), with the replica holders the scheduler may
    place it on for free."""
    key: str
    nbytes: int
    locs: Tuple[str, ...]


@dataclass(frozen=True)
class TaskPlan:
    key: str
    nbytes: int
    locs: Tuple[str, ...]
    worker: str        # originally scheduled worker
    executor: str      # final executing worker (differs when a
                       # speculative copy on a replica won the race)
    finish: float      # simulated completion time within the stage


@dataclass(frozen=True)
class StagePlan:
    """Immutable result of planning one stage.

    ``link_seconds``/``link_wait`` are populated only by a
    contention-aware planner (``link_of`` set): ``link_seconds`` is the
    per-physical-link busy time this plan's transfers occupy, as sorted
    ``(link_key, seconds)`` pairs — what :meth:`IncrementalPlan.merged`
    sums across groups to find a shared bottleneck — and ``link_wait``
    is the total time transfers sat queued behind other transfers.
    Contention-blind plans carry the defaults, so equality between two
    blind plans is unchanged from before the fields existed.

    ``transfers`` records each cross-worker move's reservation on its
    physical link — ``(link_key, task_key, begin, end)`` in simulated
    seconds — exactly as :meth:`LinkSchedule.reserve` granted it.  The
    tracer turns these into per-link timeline spans; moves riding a
    ``None`` (uncontended) path are not recorded.
    """
    tasks: Tuple[TaskPlan, ...]
    seconds: float          # stage makespan (max task finish)
    bytes_local: int
    bytes_moved: int
    speculated: int
    speculation_wins: int
    link_seconds: Tuple[Tuple[Hashable, float], ...] = ()
    link_wait: float = 0.0
    transfers: Tuple[Tuple[Hashable, str, float, float], ...] = ()


def _sorted_link_items(busy: Dict[Hashable, float]
                       ) -> Tuple[Tuple[Hashable, float], ...]:
    """Deterministic ordering for link-busy pairs (keys may be any
    hashable, so sort on repr)."""
    return tuple(sorted(busy.items(), key=lambda kv: repr(kv[0])))


class IncrementalPlan:
    """A stage-0 plan grown per task *group* (one group per Sector file).

    Streams extend the plan when a file enters the window — only the new
    group is locality-scheduled — and ``retire`` a group when its file
    leaves, without touching the surviving groups.  That makes per-window
    planning cost proportional to the *delta*, not the window, and makes
    retirement exact (a group's plan never depended on its neighbours).

    Each group is planned independently from a clean per-job state, so
    the merged view treats groups as running in parallel on *workers*:
    the merged makespan starts from the max of group makespans.  What
    groups can NOT do in parallel is occupy the same wide-area link:
    when the planner is contention-aware each group plan carries its
    per-link busy time, and ``merged`` raises the makespan to the
    busiest shared link's total across groups (transfer-group ready-time
    merging — two groups each needing 1 s of the same wave take 2 s, two
    groups on disjoint waves still take max).  With a contention-blind
    planner every group's ``link_seconds`` is empty and the merge
    reduces to the old max-of-makespans exactly.  Cross-group contention
    for a *worker* remains unmodelled — the price of
    extend-don't-rebuild.
    """

    def __init__(self):
        self.groups: Dict[str, StagePlan] = {}  # insertion-ordered

    def __contains__(self, key: str) -> bool:
        return key in self.groups

    def __len__(self) -> int:
        return len(self.groups)

    def add(self, key: str, plan: StagePlan) -> None:
        if key in self.groups:
            raise ValueError(f"group {key!r} already planned")
        self.groups[key] = plan

    def retire(self, key: str) -> Optional[StagePlan]:
        """Drop one group (its file left the window).  Surviving groups
        are untouched.  Returns the retired plan, if any."""
        return self.groups.pop(key, None)

    def merged(self) -> StagePlan:
        """The whole window's stage-0 plan: group tasks concatenated in
        arrival order, counters summed, makespan = max over group
        makespans, raised to the busiest shared link's summed busy time
        (see class docstring)."""
        groups = list(self.groups.values())
        busy: Dict[Hashable, float] = {}
        for g in groups:
            for key, secs in g.link_seconds:
                busy[key] = busy.get(key, 0.0) + secs
        makespan = max((g.seconds for g in groups), default=0.0)
        queued = max(busy.values(), default=0.0)
        return StagePlan(
            tuple(t for g in groups for t in g.tasks),
            max(makespan, queued),
            sum(g.bytes_local for g in groups),
            sum(g.bytes_moved for g in groups),
            sum(g.speculated for g in groups),
            sum(g.speculation_wins for g in groups),
            _sorted_link_items(busy),
            sum(g.link_wait for g in groups),
            # per-group reservation times (each group planned from a
            # clean link schedule, so spans from different groups may
            # overlap on a shared track — see OBSERVABILITY.md)
            tuple(tr for g in groups for tr in g.transfers))


class SpherePlanner:
    """See the module docstring for the scheduling model.

    Constructor contract:

    * ``speeds`` — worker -> relative speed (1.0 default); ACTUAL speeds
      revealed at execution, never used for placement estimates.
    * ``speculate_factor`` — a task finishing later than this multiple of
      the stage median gets a speculative copy on a replica.
    * ``move_time(nbytes, src_worker, dst_worker)`` — simulated seconds
      for one transfer ALONE on its path (the transport model); queueing
      on shared paths is this planner's job, not ``move_time``'s.
    * ``link_of(src_worker, dst_worker)`` — physical-path identity for
      capacity accounting; ``None``-returning pairs (and a ``None``
      callable, the default) are priced uncontended.
    * ``offload`` — let stages place tasks on non-replica workers when
      the priced fetch still wins; default ``False`` keeps the paper's
      locality-first placement (moves only when no replica is live).

    With ``link_of=None`` and ``offload=False`` every method produces
    bit-identical plans to the pre-contention planner.
    """

    def __init__(self, *, speeds: Optional[Dict[str, float]] = None,
                 speculate_factor: float = 1.8,
                 move_time: Optional[MoveTime] = None,
                 link_of: Optional[LinkOf] = None,
                 offload: bool = False, tracer=None):
        self.speeds = dict(speeds or {})
        self.speculate_factor = speculate_factor
        self._move_time = move_time or (lambda nbytes, src, dst: 0.0)
        self._link_of = link_of
        self.offload = offload
        self.tracer = tracer or NULL_TRACER
        # per-JOB speculation state: worker -> count of tasks observed
        # straggling on it so far in the current job.  Later stages of the
        # same job avoid speculating *onto* these workers when another
        # replica is available; a session running a chain of jobs through
        # one planner resets this at every job boundary so one job's slow
        # node never biases the next job's placement.
        self.job_stragglers: Dict[str, int] = {}

    def reset_job_state(self) -> None:
        """Forget per-job speculation/straggler observations (called by
        the engine/session at each job boundary)."""
        self.job_stragglers.clear()

    def extend_plan(self, inc: IncrementalPlan, key: str,
                    tasks: Sequence[TaskSpec], workers: Sequence[str]
                    ) -> Tuple[StagePlan, Dict[str, int]]:
        """Plan ONE new group and add it to ``inc`` — the extend half of
        extend-don't-rebuild.  The group is planned from a clean per-job
        straggler state (group plans must not depend on arrival order),
        and the planner's current job state is saved and restored, so
        extending mid-job never perturbs the running job.  Link
        occupancy likewise starts clean per group; the CROSS-group link
        bill is settled later by :meth:`IncrementalPlan.merged`, which
        is what keeps a group's plan independent of its neighbours (the
        retirement-exactness guarantee) while still charging shared
        bottlenecks.  Returns the group plan plus the straggler
        observations planning it produced, for the caller to replay at
        each later job boundary."""
        saved = self.job_stragglers
        self.job_stragglers = {}
        try:
            plan = self.plan_stage(tasks, workers)
            contrib = dict(self.job_stragglers)
        finally:
            self.job_stragglers = saved
        inc.add(key, plan)
        return plan, contrib

    def _speed(self, worker: str) -> float:
        return self.speeds.get(worker, 1.0)

    def _proc_time(self, worker: str, nbytes: int) -> float:
        return nbytes / (PROCESS_RATE * self._speed(worker))

    def _key_of(self, src: str, dst: str) -> Optional[Hashable]:
        return self._link_of(src, dst) if self._link_of is not None else None

    # ------------------------------------------------------------- stage
    def plan_stage(self, tasks: Sequence[TaskSpec], workers: Sequence[str]
                   ) -> StagePlan:
        """Place every task, then speculate on observed stragglers.

        Contention-blind + locality-only (the default knobs) takes the
        legacy path; either knob routes through the link-aware scheduler.
        """
        with self.tracer.span("planner:plan-stage", track="planner") as sp:
            if self._link_of is None and not self.offload:
                plan = self._plan_stage_blind(tasks, workers)
            else:
                plan = self._plan_stage_aware(tasks, workers)
            if self.tracer.enabled:
                sp.set_attrs(tasks=len(plan.tasks),
                             sim_seconds=plan.seconds,
                             bytes_local=plan.bytes_local,
                             bytes_moved=plan.bytes_moved,
                             speculated=plan.speculated,
                             links_reserved=len(plan.transfers),
                             link_wait=plan.link_wait)
        return plan

    def _plan_stage_blind(self, tasks: Sequence[TaskSpec],
                          workers: Sequence[str]) -> StagePlan:
        """Pre-contention scheduler, preserved bit-for-bit: each move is
        priced alone on its path and charged to the destination worker's
        queue; placement never leaves the replica set while any replica
        is live."""
        est_ready = {w: 0.0 for w in workers}
        act_ready = {w: 0.0 for w in workers}
        bytes_local = bytes_moved = 0

        # --- schedule: locality first, then least-(estimated)-loaded ----
        scheduled: List[Tuple[TaskSpec, str, float]] = []
        for t in sorted(tasks, key=lambda t: -t.nbytes):
            live = [w for w in t.locs if w in est_ready]
            candidates = live or list(workers)
            w = min(candidates,
                    key=lambda x: est_ready[x] + t.nbytes / PROCESS_RATE)
            move = 0.0
            if w in live:
                bytes_local += t.nbytes
            else:
                src = live[0] if live else workers[0]
                move = self._move_time(t.nbytes, src, w)
                bytes_moved += t.nbytes
            est_ready[w] += move + t.nbytes / PROCESS_RATE
            fin = act_ready[w] + move + self._proc_time(w, t.nbytes)
            act_ready[w] = fin
            scheduled.append((t, w, fin))

        plans, seconds, speculated, wins = self._speculate(scheduled,
                                                           act_ready)
        return StagePlan(tuple(plans), seconds, bytes_local, bytes_moved,
                         speculated, wins)

    def _plan_stage_aware(self, tasks: Sequence[TaskSpec],
                          workers: Sequence[str]) -> StagePlan:
        """Link-aware scheduler: a cross-worker fetch reserves time on
        its physical path, so two fetches sharing a wave serialize and
        the SECOND one's candidate score already includes the wait.
        A transfer starts when BOTH its physical path and its
        destination worker are free (the destination receives serially —
        without that, stacking every task on one worker would look
        nearly free), and the destination's compute follows the
        transfer; source workers are not charged (transfers are pulls of
        resident data).  On a ``None`` path the link never queues, so
        the accounting reduces to the blind model's per-destination
        ``move + proc`` exactly.  With ``offload`` every
        worker is a candidate; otherwise only replica holders are (the
        legacy rule), but moves that DO happen still queue."""
        est_ready = {w: 0.0 for w in workers}
        act_ready = {w: 0.0 for w in workers}
        est_links = LinkSchedule()
        act_links = LinkSchedule()
        link_busy: Dict[Hashable, float] = {}
        link_wait = 0.0
        bytes_local = bytes_moved = 0
        transfers: List[Tuple[Hashable, str, float, float]] = []
        worker_list = list(workers)

        scheduled: List[Tuple[TaskSpec, str, float]] = []
        for t in sorted(tasks, key=lambda t: -t.nbytes):
            live = [w for w in t.locs if w in est_ready]
            if self.offload and worker_list:
                candidates = worker_list
            else:
                candidates = live or worker_list
            proc_est = t.nbytes / PROCESS_RATE
            src0 = live[0] if live else (worker_list[0] if worker_list
                                         else "")

            def est_fin(x: str) -> float:
                if x in live:
                    return est_ready[x] + proc_est
                move = self._move_time(t.nbytes, src0, x)
                _, t_end = est_links.peek(self._key_of(src0, x),
                                          est_ready[x], move)
                return t_end + proc_est

            w = min(candidates, key=est_fin)
            if w in live:
                bytes_local += t.nbytes
                est_ready[w] += proc_est
                fin = act_ready[w] + self._proc_time(w, t.nbytes)
            else:
                move = self._move_time(t.nbytes, src0, w)
                key = self._key_of(src0, w)
                bytes_moved += t.nbytes
                _, e_end = est_links.reserve(key, est_ready[w], move)
                est_ready[w] = e_end + proc_est
                a_begin, a_end = act_links.reserve(key, act_ready[w], move)
                link_wait += a_begin - act_ready[w]
                if key is not None:
                    link_busy[key] = link_busy.get(key, 0.0) + move
                    transfers.append((key, t.key, a_begin, a_end))
                fin = a_end + self._proc_time(w, t.nbytes)
            act_ready[w] = fin
            scheduled.append((t, w, fin))

        plans, seconds, speculated, wins = self._speculate(scheduled,
                                                           act_ready)
        return StagePlan(tuple(plans), seconds, bytes_local, bytes_moved,
                         speculated, wins, _sorted_link_items(link_busy),
                         link_wait, tuple(transfers))

    def _speculate(self, scheduled: List[Tuple[TaskSpec, str, float]],
                   act_ready: Dict[str, float]
                   ) -> Tuple[List[TaskPlan], float, int, int]:
        """Speculative re-execution of (observed) stragglers — shared by
        both schedulers.  Speculative copies run on replicas, so they
        move no bytes and touch no link."""
        fins = sorted(f for _, _, f in scheduled)
        median = fins[len(fins) // 2] if fins else 0.0
        speculated = wins = 0
        plans: List[TaskPlan] = []
        for t, w, fin in scheduled:
            best_w, best_fin = w, fin
            if fin > self.speculate_factor * median:
                self.job_stragglers[w] = self.job_stragglers.get(w, 0) + 1
                alts = [x for x in t.locs if x != w and x in act_ready]
                # known stragglers are poor speculation targets: try clean
                # replicas first, fall back to the full list otherwise
                clean = [x for x in alts if x not in self.job_stragglers]
                for alt in clean or alts:
                    alt_fin = act_ready[alt] + self._proc_time(alt, t.nbytes)
                    speculated += 1
                    if alt_fin < best_fin:
                        best_w, best_fin = alt, alt_fin
                        act_ready[alt] = alt_fin
                        wins += 1
                        break
            plans.append(TaskPlan(t.key, t.nbytes, t.locs, w, best_w,
                                  best_fin))
        seconds = max((p.finish for p in plans), default=0.0)
        return plans, seconds, speculated, wins

    # ----------------------------------------------------------- pricing
    def price_plan(self, plan: StagePlan, workers: Sequence[str]
                   ) -> StagePlan:
        """Re-price a FIXED assignment under this planner's link model.

        Keeps every task on ``plan``'s chosen executor and replays the
        stage through a fresh :class:`LinkSchedule` and fresh worker
        queues, in the same largest-first service order planning uses.
        This is how two planning policies are compared honestly: plan
        with each policy, then price both plans under the same
        (contention-aware) model — a contention-blind plan's optimistic
        ``seconds`` is replaced by what its transfers would really take
        queued on shared waves.  Speculation counters pass through
        unchanged (the assignment, including speculative winners, is
        what is being priced)."""
        worker_set = set(workers)
        ready: Dict[str, float] = {w: 0.0 for w in workers}
        links = LinkSchedule()
        link_busy: Dict[Hashable, float] = {}
        link_wait = 0.0
        bytes_local = bytes_moved = 0
        transfers: List[Tuple[Hashable, str, float, float]] = []
        repriced: List[TaskPlan] = []
        for p in sorted(plan.tasks, key=lambda p: -p.nbytes):
            w = p.executor
            ready.setdefault(w, 0.0)
            live = [x for x in p.locs if x in worker_set]
            if w in live:
                bytes_local += p.nbytes
                fin = ready[w] + self._proc_time(w, p.nbytes)
            else:
                src = live[0] if live else (workers[0] if workers else w)
                move = self._move_time(p.nbytes, src, w)
                key = self._key_of(src, w)
                begin, end = links.reserve(key, ready[w], move)
                link_wait += begin - ready[w]
                if key is not None:
                    link_busy[key] = link_busy.get(key, 0.0) + move
                    transfers.append((key, p.key, begin, end))
                bytes_moved += p.nbytes
                fin = end + self._proc_time(w, p.nbytes)
            ready[w] = fin
            repriced.append(TaskPlan(p.key, p.nbytes, p.locs, p.worker, w,
                                     fin))
        seconds = max((p.finish for p in repriced), default=0.0)
        priced = StagePlan(tuple(repriced), seconds, bytes_local, bytes_moved,
                           plan.speculated, plan.speculation_wins,
                           _sorted_link_items(link_busy), link_wait,
                           tuple(transfers))
        if self.tracer.enabled:
            self.tracer.instant("planner:price", track="planner",
                                attrs={"tasks": len(priced.tasks),
                                       "sim_seconds": priced.seconds,
                                       "link_wait": priced.link_wait,
                                       "links_reserved": len(transfers)})
        return priced

    # ----------------------------------------------------------- shuffle
    def plan_shuffle(self, flows: Sequence[Tuple[str, str, int]]
                     ) -> Tuple[float, int, int]:
        """Time + movement for a shuffle given its actual record flows.

        ``flows`` holds one ``(src_worker, dst_worker, nbytes)`` entry per
        bucket fragment — the bytes of each bucket that originated on each
        worker, as observed by the executor.  Fragments staying on their
        origin worker are local (no movement, no time).  Cross-worker
        flows riding DISTINCT physical paths transfer in parallel, so
        they cost the max of their move times; flows whose ``link_of``
        maps to the same path serialize, so each shared path costs the
        SUM of its flows' move times and the shuffle completes when the
        busiest path drains.  A contention-blind planner (no ``link_of``)
        treats every flow as a distinct path — the pre-contention
        behaviour, unchanged.  Returns (seconds, bytes_moved,
        bytes_local).
        """
        seconds = 0.0
        moved = local = 0
        busy: Dict[Hashable, float] = {}
        for src, dst, nbytes in flows:
            if not nbytes:
                continue
            if src == dst:
                local += nbytes
                continue
            moved += nbytes
            mt = self._move_time(nbytes, src, dst)
            key = self._key_of(src, dst)
            if key is None:
                seconds = max(seconds, mt)
            else:
                busy[key] = busy.get(key, 0.0) + mt
        if busy:
            seconds = max(seconds, max(busy.values()))
        return seconds, moved, local
