"""Sphere tracing plane: spans, instants, and Perfetto-ready export.

The Sector/Sphere papers make monitoring a first-class master component
(the master "maintains the metadata ... and monitors the slave nodes");
this module is the reproduction's equivalent: a span tracer threaded
through the planner, executor, stream/session and Sector master so a
whole job — every per-task span, every shuffle round, every host sync,
every bus event — is inspectable on one timeline instead of being
summed away into end-of-job aggregates.

Two clock domains coexist, and every span/instant belongs to exactly one:

* ``wall``  — real host seconds (``time.perf_counter`` relative to the
  tracer's construction).  The data plane lives here: chunk fetches,
  UDF dispatches, shuffle rounds, host-sync markers.
* ``sim``   — the engine's simulated seconds.  The control plane lives
  here: per-task execution spans on ``worker:*`` tracks, transfer
  reservations on ``link:*`` tracks, Sector bus events.

:meth:`Tracer.export_chrome` writes Chrome trace-event JSON (the format
Perfetto and ``chrome://tracing`` open directly): one *process* per
clock domain, one *thread* (track) per worker / physical link / lane,
complete ("X") events for spans and instant ("i") events for markers.
Timestamps are microseconds within their domain.

Zero-cost-when-off contract: the default tracer everywhere is
:data:`NULL_TRACER`, whose :meth:`~NullTracer.span` returns a minimal
timer object (the data plane still reads ``wall_seconds`` off it — one
timing idiom whether tracing is on or not) and records nothing; every
other method is a no-op.  Neither tracer ever touches a device or adds
a host sync: span metadata rides the data plane's existing
one-sync-per-round harvest.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, Hashable, List, Optional, Tuple

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]

WALL = "wall"
SIM = "sim"
_CLOCKS = (WALL, SIM)

# Chrome trace-event pids, one per clock domain (Perfetto renders each
# pid as its own process group with an independent time axis origin)
_PID = {SIM: 1, WALL: 2}
_PID_NAME = {SIM: "sim-clock", WALL: "wall-clock"}


class Span:
    """One traced operation: explicit start/end, a parent link, a track,
    timestamps in ONE clock domain, and free-form attributes.

    Used as a context manager for wall-clock spans (``t0``/``t1`` are
    captured on enter/exit); already-closed spans (the planner's
    simulated-time task and transfer spans) are appended via
    :meth:`Tracer.add_span` with both timestamps supplied."""

    __slots__ = ("name", "track", "clock", "span_id", "parent_id",
                 "t0", "t1", "attrs", "kind", "_tracer")

    def __init__(self, name: str, track: str, clock: str, span_id: int,
                 parent_id: Optional[int], attrs: Optional[dict],
                 tracer: Optional["Tracer"] = None, kind: str = "span"):
        self.name = name
        self.track = track
        self.clock = clock
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.kind = kind                      # "span" | "instant"
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self._tracer = tracer

    @property
    def wall_seconds(self) -> float:
        """Measured duration (valid after exit; wall-clock spans)."""
        return (self.t1 or 0.0) - (self.t0 or 0.0)

    def set_attrs(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if self.t0 is None:
            self.t0 = self._tracer._now()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self._tracer._now()
        self._tracer._close(self)


class _NullSpan:
    """The disabled tracer's span: a bare wall-clock timer.  Records
    nothing anywhere, but still measures, so call sites read
    ``wall_seconds`` identically whether tracing is on or off."""

    __slots__ = ("t0", "t1")

    @property
    def wall_seconds(self) -> float:
        return (self.t1 or 0.0) - (self.t0 or 0.0)

    def set_attrs(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()


class NullTracer:
    """The default, zero-cost tracer: every hook is a no-op (spans still
    time themselves — see :class:`_NullSpan`)."""

    enabled = False

    def span(self, name: str, *, track: str = "control",
             parent: Optional[int] = None,
             attrs: Optional[dict] = None) -> _NullSpan:
        return _NullSpan()

    def add_span(self, name: str, *, track: str, t0: float, t1: float,
                 clock: str = SIM, parent: Optional[int] = None,
                 attrs: Optional[dict] = None) -> None:
        return None

    def instant(self, name: str, *, track: str, t: Optional[float] = None,
                clock: str = WALL, attrs: Optional[dict] = None) -> None:
        return None

    def attach_bus(self, bus, *, replay: bool = True):
        return None

    def export_chrome(self, path: str) -> dict:
        raise RuntimeError("tracing is disabled (NullTracer); construct "
                           "the engine with tracer=Tracer() to record")


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer.  Thread-safe appends (the executor's stage-0
    prefetch thread emits fetch spans concurrently with the main
    thread); the implicit parent stack is thread-local, so a producer
    thread's spans parent to its own enclosing span or none at all,
    never to another thread's."""

    enabled = True

    def __init__(self):
        self._epoch = time.perf_counter()
        self._events: List[Span] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._open = 0

    # ---------------------------------------------------------- recording
    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, *, track: str = "control",
             parent: Optional[int] = None,
             attrs: Optional[dict] = None) -> Span:
        """A wall-clock span, used as a context manager.  ``parent``
        defaults to the innermost open span on this thread."""
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1]
        sp = Span(name, track, WALL, next(self._ids), parent,
                  dict(attrs) if attrs else None, tracer=self)
        stack.append(sp.span_id)
        with self._lock:
            self._open += 1
        return sp

    def _close(self, sp: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] == sp.span_id:
            stack.pop()
        elif sp.span_id in stack:          # exited out of order: still drop
            stack.remove(sp.span_id)
        with self._lock:
            self._open -= 1
            self._events.append(sp)

    def add_span(self, name: str, *, track: str, t0: float, t1: float,
                 clock: str = SIM, parent: Optional[int] = None,
                 attrs: Optional[dict] = None) -> Span:
        """Append an already-closed span (simulated-clock spans are
        computed after the fact from the planner's task finish times)."""
        if clock not in _CLOCKS:
            raise ValueError(f"unknown clock {clock!r}; choose {_CLOCKS}")
        stack = self._stack()
        if parent is None and stack and clock == WALL:
            parent = stack[-1]
        sp = Span(name, track, clock, next(self._ids), parent,
                  dict(attrs) if attrs else None)
        sp.t0, sp.t1 = float(t0), float(t1)
        with self._lock:
            self._events.append(sp)
        return sp

    def instant(self, name: str, *, track: str, t: Optional[float] = None,
                clock: str = WALL, attrs: Optional[dict] = None) -> Span:
        """A zero-duration marker (host syncs, bus events, window
        advances)."""
        if clock not in _CLOCKS:
            raise ValueError(f"unknown clock {clock!r}; choose {_CLOCKS}")
        at = self._now() if t is None else float(t)
        sp = Span(name, track, clock, next(self._ids), None,
                  dict(attrs) if attrs else None, kind="instant")
        sp.t0 = sp.t1 = at
        with self._lock:
            self._events.append(sp)
        return sp

    # ----------------------------------------------------------- event bus
    def attach_bus(self, bus, *, replay: bool = True):
        """Turn every :class:`~repro.sector.events.EventBus` event into a
        zero-duration instant on the simulated-clock ``events`` track.
        With ``replay`` (default) the bus's bounded history is replayed
        first, so a tracer attached after the cloud was built still
        shows the recent control-plane past.  Returns the subscription."""
        if replay:
            for ev in bus.replay():
                self._bus_instant(ev)
        return bus.subscribe(self._bus_instant)

    def _bus_instant(self, ev) -> None:
        attrs = {"seq": ev.seq, "path": ev.path}
        for k, v in ev.detail.items():
            if isinstance(v, (int, float, str, bool)):
                attrs[k] = v
        self.instant(f"event:{ev.type}", track="events", t=ev.time,
                     clock=SIM, attrs=attrs)

    # -------------------------------------------------------------- export
    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._events)

    def count(self, name: Optional[str] = None) -> int:
        """Recorded events, optionally filtered by exact name (tests)."""
        evs = self.snapshot()
        return len(evs) if name is None else \
            sum(1 for e in evs if e.name == name)

    def counts_by_name(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.snapshot():
            out[e.name] = out.get(e.name, 0) + 1
        return out

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON: one process per clock domain, one
        thread per track, events sorted by timestamp within each track
        (the monotonicity :mod:`scripts.check_trace` validates).  When
        ``path`` is given the document is also written there.  Returns
        the document."""
        events = self.snapshot()
        # stable track ids: (clock, track) in first-appearance order
        tids: Dict[Tuple[str, str], int] = {}
        per_track: Dict[Tuple[str, str], List[Span]] = {}
        for sp in events:
            key = (sp.clock, sp.track)
            if key not in tids:
                tids[key] = len(tids) + 1
                per_track[key] = []
            per_track[key].append(sp)

        doc_events: List[dict] = []
        for clock in (SIM, WALL):
            if any(k[0] == clock for k in tids):
                doc_events.append({"name": "process_name", "ph": "M",
                                   "pid": _PID[clock],
                                   "args": {"name": _PID_NAME[clock]}})
        for (clock, track), tid in tids.items():
            doc_events.append({"name": "thread_name", "ph": "M",
                               "pid": _PID[clock], "tid": tid,
                               "args": {"name": track}})
        for key, spans in per_track.items():
            clock, _track = key
            spans.sort(key=lambda s: (s.t0, s.span_id))
            for sp in spans:
                ev = {"name": sp.name, "pid": _PID[clock],
                      "tid": tids[key],
                      "ts": round(sp.t0 * 1e6, 3),
                      "args": {"id": sp.span_id}}
                if sp.parent_id is not None:
                    ev["args"]["parent"] = sp.parent_id
                if sp.attrs:
                    ev["args"].update(sp.attrs)
                if sp.kind == "instant":
                    ev["ph"] = "i"
                    ev["s"] = "t"          # thread-scoped marker
                else:
                    ev["ph"] = "X"
                    ev["dur"] = round((sp.t1 - sp.t0) * 1e6, 3)
                doc_events.append(ev)

        with self._lock:
            open_spans = self._open
        doc = {
            "traceEvents": doc_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "open_spans": open_spans,
                "spans": sum(1 for e in events if e.kind == "span"),
                "instants": sum(1 for e in events if e.kind == "instant"),
                "clock_domains": {
                    SIM: "simulated engine seconds (pid 1)",
                    WALL: "host perf_counter seconds since tracer "
                          "construction (pid 2)",
                },
            },
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, default=repr)
        return doc


def link_track(key: Hashable) -> str:
    """Canonical track name for a physical link's reservation spans."""
    return f"link:{key}"
