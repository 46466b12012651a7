"""Replication daemon: event-driven repair + periodic scan (paper §3).

In production this runs in the master's background thread; here it is a
synchronous step function driven by the simulated clock so tests and the
fault-tolerance examples can advance time deterministically.

Repair is primarily *event-driven*: the daemon subscribes to the
master's ``server-died`` bus events (graceful deregistration and
heartbeat-timeout failures alike) and runs repair the moment a death is
published — replicas are restored during the event delivery, not up to
``scan_interval`` simulated seconds later at the next poll.  The
periodic :meth:`tick` scan remains as the backstop for damage that emits
no event (silent corruption found by :meth:`verify_all`, repairs that
could not complete earlier for lack of live targets).

Where repaired replicas LAND is the master's policy, not the daemon's:
``run_repair`` executes ``master.repair_plan()`` verbatim, so a master
constructed with ``llpr_placement=True`` steers re-replication toward
sites with high effective bandwidth from the surviving copy
(LLPR-weighted rendezvous — see
:meth:`repro.sector.master.SectorMaster.place_llpr`) with no changes
here.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.sector.client import SectorClient
from repro_torch.sector.events import SERVER_DIED, weak_subscribe
from repro_torch.sector.master import SectorMaster


@dataclass
class ReplicationDaemon:
    master: SectorMaster
    client: SectorClient
    scan_interval: float = 10.0
    _last_scan: float = 0.0
    # subscribe to server-died and repair immediately (default); False
    # restores the pure polling daemon for A/B tests of repair latency
    event_driven: bool = True
    event_repairs: int = 0

    def __post_init__(self):
        if self.event_driven:
            self._sub = weak_subscribe(self.master.events, self,
                                       "_on_server_died",
                                       types=(SERVER_DIED,))

    def _on_server_died(self, event) -> None:
        tracer = self.master.tracer
        if tracer is None:
            self.event_repairs += self.client.run_repair()
            return
        with tracer.span("replication-repair", track="master",
                         attrs={"died": event.path}) as sp:
            repaired = self.client.run_repair()
            sp.set_attrs(repaired=repaired)
        self.event_repairs += repaired

    def tick(self, now: float) -> dict:
        """Advance the daemon: detect failures, repair under-replication.

        With ``event_driven`` the ``check_failures`` call publishes
        ``server-died`` for every newly detected timeout, so repair for
        those runs *inside* this call via the subscription (counted in
        ``event_repairs``); the interval scan then only catches leftover
        under-replication."""
        report = {"failed": [], "repaired": 0}
        report["failed"] = self.master.check_failures(now)
        if now - self._last_scan >= self.scan_interval:
            self._last_scan = now
            report["repaired"] = self.client.run_repair()
        return report

    def verify_all(self) -> dict:
        """Checksum-verify every replica (background scrubbing)."""
        ok, bad = 0, 0
        for ck in self.master.chunks.values():
            for sid in list(ck.locations):
                srv = self.master.servers.get(sid)
                if srv is None or not srv.verify_chunk(ck.chunk_id, ck.digest):
                    ck.locations.discard(sid)
                    if len(ck.locations) < self.master._repl(ck.file):
                        self.master.under_replicated.add(ck.chunk_id)
                    bad += 1
                else:
                    ok += 1
        return {"ok": ok, "bad": bad}
