"""Sector master: metadata index + Chord-style consistent-hash placement.

The paper's routing layer locates the node holding metadata for a named
entity; Sector currently uses Chord [Stoica et al. 2001]. In a TPU job the
membership set is static-ish and a master can answer lookups in O(1), but we
keep the *consistent-hash ring* (with virtual nodes) for chunk->server
placement because it preserves Chord's key property we still need: **minimal
data movement under elastic membership change** — when a server joins or
dies, only ~1/n of chunk assignments move (tested).

Failure handling: servers heartbeat on a simulated clock; missing heartbeats
mark a server dead, drop it from the ring, and enqueue re-replication for
every chunk that lost a replica (paper §3: "Automatic services ensure that
after a failure drops a replica, an additional replica is created").
"""
from __future__ import annotations

import bisect
import hashlib
import math
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.sector.acl import CommunityACL
from repro_torch.sector.chunk import CHUNK_SIZE, ChunkMeta, FileMeta
from repro_torch.sector.events import (CHUNK_REPLICATED, FILE_CREATED,
                                 SERVER_DIED, SERVER_JOINED, EventBus)
from repro_torch.sector.server import ChunkServer
from repro_torch.sector.topology import TERAFLOW_TESTBED, Topology

V_NODES = 64  # virtual nodes per server


def _h(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes."""

    def __init__(self):
        self._points: List[int] = []
        self._owner: Dict[int, str] = {}

    def add(self, server_id: str) -> None:
        for v in range(V_NODES):
            p = _h(f"{server_id}@{v}")
            if p in self._owner:
                continue
            bisect.insort(self._points, p)
            self._owner[p] = server_id

    def remove(self, server_id: str) -> None:
        for v in range(V_NODES):
            p = _h(f"{server_id}@{v}")
            if self._owner.get(p) == server_id:
                del self._owner[p]
                i = bisect.bisect_left(self._points, p)
                if i < len(self._points) and self._points[i] == p:
                    self._points.pop(i)

    def servers(self) -> Set[str]:
        return set(self._owner.values())

    def place(self, key: str, n: int,
              site_of: Optional[Dict[str, str]] = None) -> List[str]:
        """Walk the ring clockwise from hash(key); prefer distinct sites
        (rack/DC-aware replica placement) then fill with distinct servers."""
        if not self._points:
            return []
        start = bisect.bisect_left(self._points, _h(key)) % len(self._points)
        chosen: List[str] = []
        sites_used: Set[str] = set()
        # pass 1: distinct sites
        for i in range(len(self._points)):
            s = self._owner[self._points[(start + i) % len(self._points)]]
            if s in chosen:
                continue
            site = site_of.get(s) if site_of else None
            if site is not None and site in sites_used:
                continue
            chosen.append(s)
            sites_used.add(site)
            if len(chosen) == n:
                return chosen
        # pass 2: any distinct server
        for i in range(len(self._points)):
            s = self._owner[self._points[(start + i) % len(self._points)]]
            if s not in chosen:
                chosen.append(s)
                if len(chosen) == n:
                    break
        return chosen


class SectorMaster:
    def __init__(self, topology: Topology = TERAFLOW_TESTBED,
                 default_replication: int = 3,
                 heartbeat_timeout: float = 30.0,
                 chunk_size: int = CHUNK_SIZE,
                 llpr_placement: bool = False):
        self.topology = topology
        self.default_replication = default_replication
        self.heartbeat_timeout = heartbeat_timeout
        self.chunk_size = chunk_size
        # llpr_placement: weight replica placement by each candidate
        # site's EFFECTIVE bandwidth from the writing site (the LLPR
        # model, Table 1) instead of pure hash order — replicas still
        # spread across distinct sites, but well-connected sites win
        # proportionally more of them.  Off by default: the paper's
        # baseline placement is topology-blind consistent hashing, and
        # the hash ring's minimal-movement guarantee is what most tests
        # pin down.
        self.llpr_placement = llpr_placement
        self.ring = HashRing()
        self.servers: Dict[str, ChunkServer] = {}
        self.files: Dict[str, FileMeta] = {}
        self.chunks: Dict[str, ChunkMeta] = {}
        self.acl = CommunityACL()
        self._heartbeat: Dict[str, float] = {}
        self.under_replicated: Set[str] = set()
        # control-plane notifications: Sphere sessions/streams subscribe
        # for membership invalidation and windowed file arrival
        self.events = EventBus()
        self.clock = 0.0  # last simulated time the master observed
        # observability: an engine built with a recording tracer assigns
        # it here (duck-typed — sector must not import core.trace, the
        # dependency runs the other way); None = no tracing
        self.tracer = None

    def _tick(self, now: Optional[float] = None) -> float:
        if now is not None:
            self.clock = max(self.clock, now)
        return self.clock

    # ------------------------------------------------------------ membership
    def register(self, server: ChunkServer, now: float = 0.0) -> None:
        self.servers[server.server_id] = server
        self.ring.add(server.server_id)
        self._heartbeat[server.server_id] = now
        self.events.publish(SERVER_JOINED, time=self._tick(now),
                            path=server.server_id, site=server.site)

    def deregister(self, server_id: str, now: Optional[float] = None) -> None:
        """Graceful leave (or confirmed failure): drop from ring, flag every
        chunk that lost a replica."""
        self.ring.remove(server_id)
        self._heartbeat.pop(server_id, None)
        lost = 0
        for ck in self.chunks.values():
            if server_id in ck.locations:
                ck.locations.discard(server_id)
                lost += 1
                if len(ck.locations) < self._repl(ck.file):
                    self.under_replicated.add(ck.chunk_id)
        self.events.publish(SERVER_DIED, time=self._tick(now),
                            path=server_id, replicas_lost=lost,
                            under_replicated=len(self.under_replicated))

    def heartbeat(self, server_id: str, now: float) -> None:
        self._tick(now)
        if server_id in self.servers:
            self._heartbeat[server_id] = now

    def check_failures(self, now: float) -> List[str]:
        """Mark servers with stale heartbeats dead. Returns the failed ids."""
        self._tick(now)
        dead = [s for s, t in self._heartbeat.items()
                if now - t > self.heartbeat_timeout]
        for s in dead:
            self.deregister(s, now)
        return dead

    def _site_of(self) -> Dict[str, str]:
        return {sid: srv.site for sid, srv in self.servers.items()
                if sid in self.ring.servers()}

    def _repl(self, file: str) -> int:
        fm = self.files.get(file)
        return fm.replication if fm else self.default_replication

    # ------------------------------------------------------------- metadata
    def create_file(self, name: str, size: int, owner: str,
                    replication: Optional[int] = None) -> FileMeta:
        self.acl.check_write(owner)
        if name in self.files:
            raise FileExistsError(name)
        repl = replication or self.default_replication
        n_chunks = max(1, -(-size // self.chunk_size))
        fm = FileMeta(name, size, n_chunks, owner, repl)
        for i in range(n_chunks):
            cid = ChunkMeta.make_id(name, i)
            fm.chunk_ids.append(cid)
            self.chunks[cid] = ChunkMeta(cid, name, i, 0, "")
        self.files[name] = fm
        return fm

    def place_llpr(self, key: str, n: int, src_site: str) -> List[str]:
        """LLPR-weighted rendezvous placement: ``n`` servers for ``key``,
        favouring sites with high effective bandwidth from ``src_site``.

        Weighted rendezvous hashing: every live server draws a
        deterministic pseudo-uniform ``u`` from ``hash(key, server)``
        and scores ``-w / ln(u)`` with ``w`` the LLPR effective
        bandwidth (:meth:`Topology.effective_bandwidth_bps`) from the
        writing site to the server's site; highest scores win.  This
        keeps consistent hashing's properties — per-key deterministic,
        minimal reshuffling when membership changes — while making a
        site's share of replicas proportional to its ``w`` (the
        exponential-race property of the score).  Like
        :meth:`HashRing.place`, distinct sites are preferred before
        servers double up within a site."""
        site_of = self._site_of()
        scored: List[Tuple[float, str]] = []
        for s in sorted(site_of):
            u = (_h(f"{key}|{s}") + 1) / float(2 ** 64 + 1)  # in (0, 1)
            w = self.topology.effective_bandwidth_bps(src_site, site_of[s])
            scored.append((-w / math.log(u), s))
        scored.sort(key=lambda t: (-t[0], t[1]))
        chosen: List[str] = []
        sites_used: Set[str] = set()
        for _, s in scored:  # pass 1: distinct sites, by score
            if site_of[s] in sites_used:
                continue
            chosen.append(s)
            sites_used.add(site_of[s])
            if len(chosen) == n:
                return chosen
        for _, s in scored:  # pass 2: any distinct server, by score
            if s not in chosen:
                chosen.append(s)
                if len(chosen) == n:
                    break
        return chosen

    def placement(self, chunk_id: str,
                  src_site: Optional[str] = None) -> List[str]:
        """Replica set for one chunk.  ``src_site`` (the writing
        client's site) only matters under ``llpr_placement``, where it
        anchors the effective-bandwidth weights; hash-ring placement
        ignores it, so existing callers are unaffected."""
        ck = self.chunks[chunk_id]
        n = self._repl(ck.file)
        if self.llpr_placement and src_site is not None:
            replicas = self.place_llpr(chunk_id, n, src_site)
        else:
            replicas = self.ring.place(chunk_id, n, self._site_of())
        if self.tracer is not None:
            self.tracer.instant(
                "master:placement", track="master", t=self.clock,
                clock="sim",
                attrs={"chunk": chunk_id,
                       "policy": ("llpr" if self.llpr_placement
                                  and src_site is not None else "ring"),
                       "replicas": len(replicas)})
        return replicas

    def commit_chunk(self, chunk_id: str, server_id: str, size: int,
                     digest: str) -> None:
        ck = self.chunks[chunk_id]
        ck.locations.add(server_id)
        ck.size = size
        ck.digest = digest
        if len(ck.locations) >= self._repl(ck.file):
            self.under_replicated.discard(chunk_id)
        self.events.publish(CHUNK_REPLICATED, time=self._tick(),
                            path=chunk_id, server=server_id,
                            replicas=len(ck.locations))

    def file_complete(self, name: str, now: Optional[float] = None) -> None:
        """Publish ``file-created``: every chunk of ``name`` is committed
        and readers may start.  The upload client calls this last, so the
        event always trails the file's ``chunk-replicated`` events —
        a stream woken by it can plan and read immediately.

        The event's ``time`` is the master's monotonic clock, which
        clamps a late-reported landing forward; the RAW landing time
        rides in ``detail["event_time"]`` so event-time consumers
        (timed stream windows) can see lateness the clock hides."""
        fm = self.files[name]
        t = self._tick(now)
        self.events.publish(FILE_CREATED, time=t, path=name,
                            size=fm.size, chunks=fm.n_chunks,
                            event_time=(float(now) if now is not None
                                        else t))

    # --------------------------------------------------------------- lookup
    def lookup(self, name: str, user: str = "public",
               client_site: Optional[str] = None) -> List[ChunkMeta]:
        """Paper §3 session, steps 1-2: resolve a name to chunk locations,
        nearest replica first."""
        self.acl.check_read(user, name)
        if name not in self.files:
            raise FileNotFoundError(name)
        out = []
        for cid in self.files[name].chunk_ids:
            ck = self.chunks[cid]
            locs = sorted(
                ck.locations,
                key=lambda s: self.topology.distance(
                    client_site or "", self.servers[s].site)
                if client_site else 0.0)
            meta = ChunkMeta(ck.chunk_id, ck.file, ck.index, ck.size,
                             ck.digest, ck.version, set(ck.locations))
            meta.locations = locs  # ordered for the client
            out.append(meta)
        return out

    # ---------------------------------------------------------- re-replicate
    def repair_plan(self) -> List[Tuple[str, str, str]]:
        """[(chunk_id, src_server, dst_server)] to restore replication.

        Destinations come from the active placement policy: hash-ring
        order normally, LLPR-weighted rendezvous (anchored at the
        surviving replica's site — that is where the repair bytes flow
        from) under ``llpr_placement``.  The :class:`ReplicationDaemon`
        executes this plan verbatim, so flipping the knob redirects
        re-replication toward well-connected sites with no daemon
        changes."""
        plan = []
        site_of = self._site_of()
        for cid in sorted(self.under_replicated):
            ck = self.chunks[cid]
            live = [s for s in ck.locations
                    if s in self.servers and self.servers[s].alive]
            if not live:
                continue  # data loss: nothing to copy from (tested)
            need = self._repl(ck.file) - len(live)
            if self.llpr_placement:
                ranked = self.place_llpr(cid, self._repl(ck.file) + need,
                                         self.servers[live[0]].site)
            else:
                ranked = self.ring.place(cid, self._repl(ck.file) + need,
                                         site_of)
            candidates = [s for s in ranked if s not in ck.locations]
            for dst in candidates[:need]:
                plan.append((cid, live[0], dst))
        if self.tracer is not None:
            self.tracer.instant(
                "master:repair-plan", track="master", t=self.clock,
                clock="sim",
                attrs={"moves": len(plan),
                       "under_replicated": len(self.under_replicated)})
        return plan

    def stats(self) -> dict:
        return {
            "servers": len(self.ring.servers()),
            "files": len(self.files),
            "chunks": len(self.chunks),
            "under_replicated": len(self.under_replicated),
            "bytes": sum(f.size for f in self.files.values()),
        }
