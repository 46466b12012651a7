"""UDT vs TCP transport models — reproduces the paper's LLPR behaviour.

The paper's enabling protocol is UDT [Gu & Grossman 2007]: a rate-based,
application-level reliable transport that keeps long-fat links full where
TCP's AIMD collapses. We model both protocols faithfully enough to
reproduce Table 1:

* **TCP (Reno-style AIMD)** — steady-state throughput follows the Mathis
  bound  ``min(C, MSS / (RTT * sqrt(2p/3)))``, plus slow-start ramp. On a
  10 Gbps / 200 ms / lossy path this is catastrophically below link rate —
  the reason the paper built UDT.

* **UDT (rate-based)** — the sender probes to the fair share of link
  capacity with a fixed rate-control interval (SYN = 0.01 s), independent of
  RTT; random loss triggers a brief multiplicative back-off of 1/9 (per the
  UDT congestion-control paper) but recovery does not scale with RTT. We
  model efficiency as a function of loss and the protocol/framing overhead.

Both models are deterministic discrete-event simulations over segments, so
tests can assert exact invariants (monotonicity in loss/RTT, UDT >= TCP on
long fat networks, LLPR in the paper's 0.6-1.0 band).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.sector.topology import Link

MSS = 1500 * 8            # bits
UDT_SYN = 0.01            # UDT rate-control interval (s)
HEADER_OVERHEAD = 0.028   # IP+UDP/TCP+framing overhead fraction
HOST_RATE = 630e6         # end-host (disk/NIC/CPU) cap, bits/s — the
                          # paper's 2007 Opteron nodes peak at ~615 Mb/s
                          # locally (Table 1), so LLPR is measured against
                          # this host bottleneck, not the 10 Gb/s link.


@dataclass(frozen=True)
class TransferResult:
    seconds: float
    throughput_bps: float
    protocol: str


def tcp_throughput(link: Link, flows: int = 1) -> float:
    """Steady-state Reno throughput (Mathis) for ``flows`` parallel flows."""
    cap = min(link.bandwidth_bps * (1 - HEADER_OVERHEAD), HOST_RATE)
    if link.loss <= 0:
        return cap
    per_flow = MSS / (link.rtt_s * math.sqrt(2 * link.loss / 3))
    return min(cap, flows * per_flow)


def udt_throughput(link: Link) -> float:
    """UDT steady state: rate-based probing holds the path near the host
    rate. A loss event costs a transient 1/9 rate cut whose detection takes
    an RTT (NAK) and whose re-probe takes a few SYN intervals, so:

        eff = 1 / (1 + events_per_s * (rtt + 4*SYN) / 9)

    — efficiency falls with loss*RTT but never collapses the way AIMD does
    (the cut is 1/9 and recovery is rate-based, not window-halving).
    """
    cap = min(link.bandwidth_bps * (1 - HEADER_OVERHEAD), HOST_RATE)
    events_per_s = link.loss * cap / MSS
    penalty = events_per_s * (link.rtt_s + 4 * UDT_SYN) / 9.0
    eff = 1.0 / (1.0 + penalty)
    window_limit = (12 * 1024 * 1024 * 8) / link.rtt_s  # 12MB flow window
    return min(cap * eff, window_limit)


def simulate_transfer(nbytes: int, link: Link, protocol: str = "udt",
                      flows: int = 1, warm: bool = False) -> TransferResult:
    """Deterministic transfer-time model incl. startup ramp.

    ``warm=True`` models a persistent data connection (Sector reuses the UDT
    connection for every chunk of a session — §3 step 4), skipping the
    handshake/slow-start ramp."""
    bits = nbytes * 8
    if protocol == "tcp":
        rate = tcp_throughput(link, flows)
        # slow start: ~log2(W) RTTs to reach steady window
        bdp = rate * link.rtt_s
        ramp = 0.0 if warm else \
            link.rtt_s * max(1.0, math.log2(max(bdp / MSS, 2.0)))
        t = ramp + bits / rate
    elif protocol == "udt":
        rate = udt_throughput(link)
        ramp = 0.0 if warm else 2 * link.rtt_s + 4 * UDT_SYN
        t = ramp + bits / rate
    else:
        raise ValueError(protocol)
    return TransferResult(t, bits / t, protocol)


def llpr(nbytes: int, wan: Link, lan: Link, protocol: str = "udt") -> float:
    """Long-distance to Local Performance Ratio (paper §5.2)."""
    t_wan = simulate_transfer(nbytes, wan, protocol).seconds
    t_lan = simulate_transfer(nbytes, lan, protocol).seconds
    return t_lan / t_wan
