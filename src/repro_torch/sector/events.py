"""Sector event bus: master-side control-plane notifications.

The paper's Sector master already *reacts* to cluster change (heartbeat
loss drops a server from the ring and enqueues re-replication); the
companion papers' Angle workload additionally needs downstream consumers
— Sphere sessions and streams — to react too: new feature files land
continuously and compute must follow the data.  ``EventBus`` is the
mechanism: :class:`repro.sector.master.SectorMaster` publishes

* ``file-created``      — a file's chunks are fully committed (``path``
  is the file name; the client notifies at the end of ``upload``);
* ``server-joined``     — a chunk server registered;
* ``server-died``       — a server deregistered (graceful leave or
  heartbeat-timeout failure);
* ``chunk-replicated``  — one replica of a chunk committed (uploads and
  repair both land here; ``detail["replicas"]`` is the new count);

and subscribers are plain synchronous callbacks driven by the simulated
clock — no threads, so tests and examples stay deterministic.

Ordering guarantees (the property streams rely on):

* ``publish`` assigns a monotonic global sequence number (``event.seq``)
  at publish time;
* events are delivered to subscribers in subscription order, events in
  seq order;
* a publish *from inside* a callback (e.g. a repair subscriber that
  re-registers a standby server when it sees ``server-died``) is queued
  and delivered after the current event finishes its delivery round —
  breadth-first, so delivery order always equals publish order even
  under re-entrancy, and a "simultaneous" join+death (same simulated
  time) is observed by every subscriber in the same order.
"""
from __future__ import annotations

import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterable, List, Optional

FILE_CREATED = "file-created"
SERVER_JOINED = "server-joined"
SERVER_DIED = "server-died"
CHUNK_REPLICATED = "chunk-replicated"

EVENT_TYPES = (FILE_CREATED, SERVER_JOINED, SERVER_DIED, CHUNK_REPLICATED)


@dataclass(frozen=True)
class SectorEvent:
    """One bus event. ``path`` names the subject (file name, server id or
    chunk id); ``time`` is the simulated clock at publish."""
    seq: int
    type: str
    time: float
    path: str = ""
    detail: Dict[str, object] = field(default_factory=dict)


Callback = Callable[[SectorEvent], None]


@dataclass
class Subscription:
    """A registered callback with optional type / path-prefix filters.
    ``types=None`` matches every type; ``prefix=None`` every path."""
    callback: Callback
    types: Optional[frozenset]
    prefix: Optional[str]
    active: bool = True

    def matches(self, event: SectorEvent) -> bool:
        return (self.active
                and (self.types is None or event.type in self.types)
                and (self.prefix is None
                     or event.path.startswith(self.prefix)))


class EventBus:
    def __init__(self, history: int = 256):
        self._subs: List[Subscription] = []
        self._seq = 0
        self._queue: Deque[SectorEvent] = deque()
        self._delivering = False
        # bounded recent-event log: tests and doctors read it, nothing in
        # the data path depends on it
        self.history: Deque[SectorEvent] = deque(maxlen=history)

    # ------------------------------------------------------------ subscribe
    def subscribe(self, callback: Callback, *,
                  types: Optional[Iterable[str]] = None,
                  prefix: Optional[str] = None) -> Subscription:
        """Register ``callback`` for events matching the filters.  Types
        are validated against the protocol — a typo'd type would
        otherwise just never fire."""
        tset: Optional[frozenset] = None
        if types is not None:
            tset = frozenset(types)
            unknown = tset - set(EVENT_TYPES)
            if unknown:
                raise ValueError(f"unknown event types {sorted(unknown)}; "
                                 f"choose from {EVENT_TYPES}")
        sub = Subscription(callback, tset, prefix)
        self._subs.append(sub)
        return sub

    # ---------------------------------------------------------- introspection
    def replay(self, *, since_seq: int = -1,
               types: Optional[Iterable[str]] = None,
               prefix: Optional[str] = None) -> List[SectorEvent]:
        """Recent events from the bounded history ring, oldest first, in
        seq order — the late-joiner API: a subscriber attaching after
        the cloud was built (a tracer, a doctor) replays the recent
        control-plane past before subscribing for the future.  Filters
        match :meth:`subscribe`'s (``types`` validated the same way);
        ``since_seq`` returns only events with ``seq > since_seq``, so a
        consumer can resume from the last seq it saw.  Events older than
        the ring's bound are gone — the ring is a window, not a log."""
        tset: Optional[frozenset] = None
        if types is not None:
            tset = frozenset(types)
            unknown = tset - set(EVENT_TYPES)
            if unknown:
                raise ValueError(f"unknown event types {sorted(unknown)}; "
                                 f"choose from {EVENT_TYPES}")
        return [ev for ev in self.history
                if ev.seq > since_seq
                and (tset is None or ev.type in tset)
                and (prefix is None or ev.path.startswith(prefix))]

    def unsubscribe(self, sub: Subscription) -> None:
        sub.active = False
        try:
            self._subs.remove(sub)
        except ValueError:
            pass

    # -------------------------------------------------------------- publish
    def publish(self, type: str, *, time: float = 0.0, path: str = "",
                **detail) -> SectorEvent:
        """Publish one event and synchronously deliver it (and anything
        published re-entrantly from callbacks) in seq order."""
        if type not in EVENT_TYPES:
            raise ValueError(f"unknown event type {type!r}; "
                             f"choose from {EVENT_TYPES}")
        ev = SectorEvent(self._seq, type, time, path, detail)
        self._seq += 1
        self.history.append(ev)
        self._queue.append(ev)
        if self._delivering:
            return ev  # re-entrant: the outer delivery loop drains it
        # A raising subscriber must not corrupt the bus: the drain always
        # completes (remaining subscribers and queued re-entrant events
        # still see everything, in order — otherwise a stale event would
        # leak into the FRONT of the next unrelated publish), and the
        # first error re-raises to the publisher afterwards.
        self._delivering = True
        errors: List[BaseException] = []
        try:
            while self._queue:
                cur = self._queue.popleft()
                # snapshot: a callback may (un)subscribe mid-delivery
                for sub in list(self._subs):
                    if sub.matches(cur):
                        try:
                            sub.callback(cur)
                        except Exception as e:  # noqa: BLE001
                            errors.append(e)
        finally:
            self._delivering = False
            # normally the drain emptied the queue; after a BaseException
            # (KeyboardInterrupt through a long on_window callback) the
            # aborted remainder must not leak into the front of the next
            # unrelated publish — drop it
            self._queue.clear()
        if errors:
            raise errors[0]
        return ev


def weak_subscribe(bus: EventBus, owner, method_name: str, **filters
                   ) -> Subscription:
    """Subscribe ``owner.method_name`` through a weakref: the bus must
    never keep its subscribers (streams with their executor/chunk
    caches, replication daemons) alive.  An owner that was never
    explicitly closed gets garbage-collected normally, and its dead
    subscription self-unsubscribes on the next matching event."""
    ref = weakref.ref(owner)
    box = {}

    def callback(event):
        target = ref()
        if target is None:
            bus.unsubscribe(box["sub"])
            return
        getattr(target, method_name)(event)

    box["sub"] = bus.subscribe(callback, **filters)
    return box["sub"]
