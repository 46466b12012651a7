"""Sector client: upload / download through the master + chunk servers.

Follows the paper's data-access session (§3):
  1. connect to a known server / master, request locations of a named entity;
  2. master resolves via the routing layer, returns locations;
  3. client opens a data connection to the best location;
  4. bulk transfer runs over UDT (simulated transport cost model).

The client accounts simulated wide-area transfer time for every movement, so
benchmarks can report LLPR and data-locality savings without real WANs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.sector.chunk import checksum
from repro_torch.sector.master import SectorMaster
from repro_torch.sector.server import ServerDown
from repro_torch.sector.transport import simulate_transfer


@dataclass
class TransferLog:
    bytes_moved: int = 0
    sim_seconds: float = 0.0
    transfers: int = 0
    by_protocol: Dict[str, int] = field(default_factory=dict)

    def add(self, nbytes: int, seconds: float, protocol: str) -> None:
        self.bytes_moved += nbytes
        self.sim_seconds += seconds
        self.transfers += 1
        self.by_protocol[protocol] = self.by_protocol.get(protocol, 0) + 1


class SectorClient:
    def __init__(self, master: SectorMaster, user: str = "public",
                 site: str = "chicago", protocol: str = "udt"):
        self.master = master
        self.user = user
        self.site = site
        self.protocol = protocol
        self.log = TransferLog()
        self._warm: set = set()  # persistent data connections (§3 step 4)

    # ------------------------------------------------------------------ I/O
    def _move(self, nbytes: int, src_site: str, dst_site: str) -> float:
        link = self.master.topology.link(src_site, dst_site)
        pair = (src_site, dst_site)
        res = simulate_transfer(nbytes, link, self.protocol,
                                warm=pair in self._warm)
        self._warm.add(pair)
        self.log.add(nbytes, res.seconds, self.protocol)
        return res.seconds

    def upload(self, name: str, data: bytes,
               replication: Optional[int] = None,
               at: Optional[float] = None) -> None:
        """Write ``name`` through the chunk pipeline.  ``at`` is the
        simulated landing time forwarded to ``file_complete`` — timed
        stream windows bucket the file by it (omitted = the master's
        current clock).  The client's own site anchors LLPR-weighted
        placement when the master runs with that policy."""
        fm = self.master.create_file(name, len(data), self.user, replication)
        csz = self.master.chunk_size
        for i, cid in enumerate(fm.chunk_ids):
            blob = data[i * csz:(i + 1) * csz]
            targets = self.master.placement(cid, src_site=self.site)
            if not targets:
                raise RuntimeError("no live chunk servers")
            # pipeline: client -> first replica -> next replica (chain)
            prev_site = self.site
            for sid in targets:
                srv = self.master.servers[sid]
                self._move(len(blob), prev_site, srv.site)
                digest = srv.write_chunk(cid, blob)
                self.master.commit_chunk(cid, sid, len(blob), digest)
                prev_site = srv.site
        # every chunk committed: wake file-created subscribers (streams)
        self.master.file_complete(name, now=at)

    def download(self, name: str) -> bytes:
        metas = self.master.lookup(name, self.user, self.site)
        out = []
        for meta in metas:
            blob = None
            for sid in meta.locations:  # nearest replica first
                srv = self.master.servers.get(sid)
                if srv is None:
                    continue
                try:
                    blob = srv.read_chunk(meta.chunk_id)
                except (ServerDown, FileNotFoundError):
                    continue
                if checksum(blob) != meta.digest:  # corrupt replica
                    blob = None
                    continue
                self._move(len(blob), srv.site, self.site)
                break
            if blob is None:
                raise IOError(f"all replicas of {meta.chunk_id} unavailable")
            out.append(blob)
        return b"".join(out)

    def read_chunk(self, chunk_id: str) -> bytes:
        ck = self.master.chunks[chunk_id]
        metas = self.master.lookup(ck.file, self.user, self.site)
        meta = next(m for m in metas if m.chunk_id == chunk_id)
        for sid in meta.locations:
            srv = self.master.servers.get(sid)
            if srv is None:
                continue
            try:
                blob = srv.read_chunk(chunk_id)
            except (ServerDown, FileNotFoundError):
                continue
            self._move(len(blob), srv.site, self.site)
            return blob
        raise IOError(f"all replicas of {chunk_id} unavailable")

    # ----------------------------------------------------------- replication
    def run_repair(self) -> int:
        """Execute the master's re-replication plan. Returns #copies made."""
        n = 0
        for cid, src, dst in self.master.repair_plan():
            s_srv = self.master.servers[src]
            d_srv = self.master.servers[dst]
            try:
                blob = s_srv.read_chunk(cid)
            except (ServerDown, FileNotFoundError):
                continue
            self._move(len(blob), s_srv.site, d_srv.site)
            digest = d_srv.write_chunk(cid, blob)
            self.master.commit_chunk(cid, dst, len(blob), digest)
            n += 1
        return n
