"""Network topology: sites, links, capacity accounting, and the testbeds.

The paper's testbed (§5.1): sites joined by 10 Gbps wide-area links with up
to 200 ms RTT; each site is a small Opteron cluster.  ``Topology`` carries
per-site-pair (bandwidth, RTT, loss), a distance function used for
nearest-replica reads and locality-aware compute placement, and — since the
contention-aware planner landed — the *identity* of each physical path
(:meth:`Topology.link_key`) plus an LLPR-style achievable-rate query
(:meth:`Topology.effective_bandwidth_bps`), so schedulers can price what a
transfer will actually get on a shared long-fat link rather than the raw
provisioned rate.

Two concrete instances ship:

* :data:`TERAFLOW_TESTBED` — the paper's 6-site Teraflow cloud (Table 1);
* :data:`OPEN_CLOUD_TESTBED` — the 4-site Open Cloud Testbed successor
  (arXiv:0907.4810: Baltimore/JHU, Chicago/StarLight, Chicago/UIC, San
  Diego/Calit2 on 10 Gbps wide-area waves), the shape
  ``benchmarks/wan_scenario.py`` and ``examples/wan_terasort.py`` run on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple


@dataclass(frozen=True)
class Link:
    """One physical path between two sites.

    Contract:

    * ``bandwidth_bps`` — raw provisioned link rate in **bits/second**
      (10 Gbps testbed waves are ``10e9``).  This is the line rate, NOT
      what a transfer achieves: protocol behaviour under ``rtt_s``/``loss``
      decides that (see :func:`repro.sector.transport.udt_throughput` and
      :meth:`Topology.effective_bandwidth_bps`).
    * ``rtt_s`` — round-trip time in **seconds** (the paper's furthest
      pair is ~0.2 s).  Distance/nearest-replica ordering keys on this.
    * ``loss`` — per-packet loss probability in ``[0, 1)``; long-haul
      residual loss is what separates UDT from TCP on these paths.

    Instances are frozen and hashable so they can key caches; a ``Link``
    carries no utilisation state — occupancy lives in
    :class:`LinkSchedule`, keyed by :meth:`Topology.link_key`.
    """
    bandwidth_bps: float   # raw link bandwidth, bits/s
    rtt_s: float           # round-trip time, seconds
    loss: float            # packet loss probability


# Canonical identity of a physical path: an unordered site pair for WAN
# links, None for intra-site movement (the LAN is not a modelled shared
# bottleneck — the per-host rate cap in the transport model bounds it).
LinkKey = Optional[Tuple[str, str]]


class LinkSchedule:
    """Per-link capacity accounting on the simulated clock.

    The transport model prices a transfer *alone* on a link; the planner
    needs the cost of a transfer behind the other transfers already
    scheduled on the same physical path.  A ``LinkSchedule`` tracks, per
    :data:`LinkKey`, the simulated time at which the link next falls
    idle, and serialises reservations on it — the FIFO single-wave model
    (one flow at a time at full effective rate), which for equal-rate
    flows has the same total-completion time as a fair-share model but
    stays deterministic and O(1) per reservation.

    Invariants:

    * ``reserve(key, start, duration)`` returns ``(begin, finish)`` with
      ``begin >= start``, ``begin >= `` every earlier reservation's
      finish on ``key``, and ``finish == begin + duration``;
    * a ``None`` key is never queued: the transfer begins at ``start``
      (uncontended — intra-site, or contention tracking disabled);
    * ``peek`` is ``reserve`` without the state change (used by the
      planner's candidate scoring before it commits a placement);
    * schedules are cheap throwaway objects — one per planned stage (or
      per re-pricing pass), never shared across independent plans.
    """

    def __init__(self) -> None:
        self._free: Dict[Hashable, float] = {}

    def free_at(self, key: Hashable) -> float:
        """Simulated time at which ``key`` next falls idle (0.0 if the
        link has no reservations yet)."""
        return self._free.get(key, 0.0)

    def peek(self, key: LinkKey, start: float,
             duration: float) -> Tuple[float, float]:
        """``reserve`` without committing: what (begin, finish) *would*
        this transfer get right now?"""
        if key is None:
            return start, start + duration
        begin = max(start, self._free.get(key, 0.0))
        return begin, begin + duration

    def reserve(self, key: LinkKey, start: float,
                duration: float) -> Tuple[float, float]:
        """Occupy ``key`` for ``duration`` simulated seconds, no earlier
        than ``start``, behind every existing reservation.  Returns the
        granted ``(begin, finish)`` and advances the link's free time."""
        begin, finish = self.peek(key, start, duration)
        if key is not None:
            self._free[key] = finish
        return begin, finish


@dataclass
class Topology:
    sites: List[str]
    links: Dict[Tuple[str, str], Link] = field(default_factory=dict)
    local: Link = Link(10e9, 0.0002, 1e-7)  # intra-site LAN
    # Fallback for site pairs with no configured link — e.g. a server
    # joining from a site the testbed config predates.  Placement and
    # transfers must keep working when membership grows, so ``link``
    # falls back to this deliberately pessimistic commodity WAN path
    # (1 Gbps, 250 ms RTT, lossy — strictly worse than every provisioned
    # testbed route) instead of raising KeyError; the cost model then
    # naturally steers locality-aware scheduling and nearest-replica
    # reads away from the unprovisioned route.  Every query on this
    # class — ``link``, ``distance``, ``link_key``,
    # ``effective_bandwidth_bps`` — shares the one fallback, so no
    # topology query ever raises for an unknown site.
    default_wan: Link = Link(1e9, 0.250, 5.1e-4)

    def link(self, a: str, b: str) -> Link:
        """The physical path between sites ``a`` and ``b``.

        Symmetric (``link(a, b) is link(b, a)`` for provisioned pairs);
        ``a == b`` returns the intra-site LAN; unknown pairs return
        ``default_wan`` (never raises — see the field comment)."""
        if a == b:
            return self.local
        got = self.links.get((a, b)) or self.links.get((b, a))
        return got if got is not None else self.default_wan

    def link_key(self, a: str, b: str) -> LinkKey:
        """Canonical identity of the path between two sites — the key
        per-link capacity accounting (:class:`LinkSchedule`) queues on.

        ``None`` for ``a == b`` (intra-site movement is uncontended in
        the model: the end-host rate cap, not the LAN, is the local
        bottleneck).  Cross-site pairs map to the *unordered* pair, so
        ``a->b`` and ``b->a`` transfers contend for the same wave —
        matching :meth:`link`'s symmetric lookup.  Unknown pairs get
        their own key (each unprovisioned route is its own commodity
        path), consistent with :meth:`link`'s fallback."""
        if a == b:
            return None
        return (a, b) if a <= b else (b, a)

    def add(self, a: str, b: str, bandwidth_bps: float, rtt_s: float,
            loss: float) -> None:
        self.links[(a, b)] = Link(bandwidth_bps, rtt_s, loss)

    def distance(self, a: str, b: str) -> float:
        """Smaller is closer: RTT-dominated metric (paper reads choose
        the nearest replica).  Delegates to :meth:`link`, so unknown
        sites see the same ``default_wan`` fallback instead of raising —
        ``distance`` and ``link`` can never disagree about which path a
        site pair is on (regression-tested in ``tests/test_sector.py``).
        """
        return self.link(a, b).rtt_s

    def effective_bandwidth_bps(self, a: str, b: str,
                                protocol: str = "udt") -> float:
        """LLPR-style achievable rate between two sites, in **bits/s**.

        What one steady-state flow of ``protocol`` actually gets on
        ``link(a, b)`` — the raw wave derated by end-host capacity and
        the protocol's loss x RTT behaviour, i.e. the model behind the
        paper's Table 1 (``llpr = effective / local effective``).  This
        is the number bandwidth-aware decisions weight on:
        LLPR-weighted replica placement
        (:meth:`repro.sector.master.SectorMaster.place_llpr`) and the
        planner's transfer pricing both consume it rather than
        ``bandwidth_bps``.  Intra-site pairs return the local
        effective rate (the end-host cap), never ``inf``."""
        # deferred import: transport imports Link from this module
        from repro_torch.sector.transport import tcp_throughput, udt_throughput
        fn = tcp_throughput if protocol == "tcp" else udt_throughput
        return fn(self.link(a, b))

    def neighbours(self, site: str) -> List[str]:
        return sorted(self.sites, key=lambda s: self.distance(site, s))


def _teraflow() -> Topology:
    """The paper's testbed: Chicago, Pasadena, McLean/Greenbelt, Tokyo,
    Daejeon on 10 Gbps links. RTTs approximate the published geography
    (furthest pair ~200 ms)."""
    t = Topology(sites=["chicago", "pasadena", "greenbelt", "mclean",
                        "tokyo", "daejeon"])
    wan = 10e9
    rtts = {
        ("chicago", "pasadena"): 0.055,
        ("chicago", "greenbelt"): 0.020,
        ("chicago", "mclean"): 0.022,
        ("chicago", "tokyo"): 0.130,
        ("chicago", "daejeon"): 0.165,
        ("pasadena", "greenbelt"): 0.070,
        ("pasadena", "mclean"): 0.072,
        ("pasadena", "tokyo"): 0.110,
        ("pasadena", "daejeon"): 0.145,
        ("greenbelt", "mclean"): 0.004,
        ("greenbelt", "tokyo"): 0.150,
        ("greenbelt", "daejeon"): 0.200,
        ("mclean", "tokyo"): 0.150,
        ("mclean", "daejeon"): 0.195,
        ("tokyo", "daejeon"): 0.035,
    }
    for (a, b), rtt in rtts.items():
        # long-haul paths see more residual loss than the LAN (~2e-3/s of
        # RTT matches the Table-1 efficiency ordering)
        loss = 1e-5 + rtt * 2e-3
        t.add(a, b, wan, rtt, loss)
    return t


TERAFLOW_TESTBED = _teraflow()


def _open_cloud() -> Topology:
    """The Open Cloud Testbed (arXiv:0907.4810): four racks — Johns
    Hopkins (Baltimore), StarLight (Chicago), UIC (Chicago), Calit2 (San
    Diego) — joined by dedicated 10 Gbps wide-area paths.  The two
    Chicago sites are a metro hop apart; Baltimore-San Diego is the
    long transcontinental pair."""
    t = Topology(sites=["baltimore", "starlight", "uic", "calit2"])
    wan = 10e9
    rtts = {
        ("starlight", "uic"): 0.002,       # Chicago metro
        ("baltimore", "starlight"): 0.022,
        ("baltimore", "uic"): 0.023,
        ("starlight", "calit2"): 0.060,
        ("uic", "calit2"): 0.061,
        ("baltimore", "calit2"): 0.075,
    }
    for (a, b), rtt in rtts.items():
        loss = 1e-5 + rtt * 2e-3           # same residual-loss model
        t.add(a, b, wan, rtt, loss)
    return t


OPEN_CLOUD_TESTBED = _open_cloud()
