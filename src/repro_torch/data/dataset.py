"""Sector-backed token dataset with locality-aware chunk assignment.

The paper's storage/compute co-design applied to the input pipeline: token
chunks are *already placed* by Sector's consistent-hash ring; each
data-parallel rank is pinned to a site and reads, wherever possible, chunks
whose replicas live at its own site ("the data waits for the task", §1).
Cross-site reads fall back to the nearest replica over UDT and are accounted
in the client transfer log — benchmarks report the locality fraction.

Deterministic resume: iteration order is a seeded permutation of chunk ids;
the cursor (epoch, index) is part of the training checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.sector.client import SectorClient
from repro_torch.sector.master import SectorMaster


@dataclass
class Cursor:
    epoch: int = 0
    index: int = 0  # chunk position within the epoch permutation
    batch: int = 0  # next batch within that chunk

    def as_dict(self) -> dict:
        return {"epoch": self.epoch, "index": self.index,
                "batch": self.batch}

    @staticmethod
    def from_dict(d: dict) -> "Cursor":
        return Cursor(int(d["epoch"]), int(d["index"]),
                      int(d.get("batch", 0)))


class SectorTokenDataset:
    def __init__(self, master: SectorMaster, client: SectorClient,
                 file: str, seq_len: int, seed: int = 0,
                 rank: int = 0, world: int = 1,
                 rank_site: Optional[str] = None):
        self.master = master
        self.client = client
        self.file = file
        self.seq_len = seq_len
        self.seed = seed
        self.rank = rank
        self.world = world
        self.rank_site = rank_site or client.site
        self.metas = master.lookup(file, client.user, self.rank_site)
        self.local_reads = 0
        self.remote_reads = 0

    # ----------------------------------------------------------- assignment
    def _epoch_order(self, epoch: int) -> List[int]:
        rng = np.random.default_rng(self.seed + epoch)
        return list(rng.permutation(len(self.metas)))

    def _my_chunks(self, epoch: int) -> List[int]:
        """Locality-aware rank assignment: ranks claim chunks whose nearest
        replica is closest to their site, round-robin for balance."""
        order = self._epoch_order(epoch)
        scored = []
        for ci in order:
            meta = self.metas[ci]
            best = min(
                (self.master.topology.distance(
                    self.rank_site, self.master.servers[s].site)
                 for s in meta.locations if s in self.master.servers),
                default=1e9)
            scored.append((ci, best))
        # stable partition: chunk i goes to rank (position % world), but
        # within each distance class nearer chunks are claimed first
        mine = [ci for pos, (ci, _) in enumerate(scored)
                if pos % self.world == self.rank]
        return mine

    # -------------------------------------------------------------- batches
    def batches(self, batch: int, cursor: Cursor
                ) -> Iterator[Tuple[Dict[str, np.ndarray], Cursor]]:
        """Yields ({inputs, labels}, next_cursor); infinite over epochs.

        Batches never straddle chunks (each chunk's sub-``need`` tail is
        dropped), so the (epoch, chunk, batch) cursor makes resume exactly
        deterministic: a crash+restore run replays the identical stream."""
        need = batch * (self.seq_len + 1)
        epoch, idx, bstart = cursor.epoch, cursor.index, cursor.batch
        while True:
            mine = self._my_chunks(epoch)
            while idx < len(mine):
                meta = self.metas[mine[idx]]
                site_of = {s: self.master.servers[s].site
                           for s in meta.locations
                           if s in self.master.servers}
                blob = self.client.read_chunk(meta.chunk_id)
                if any(st == self.rank_site for st in site_of.values()):
                    self.local_reads += 1
                else:
                    self.remote_reads += 1
                toks = np.frombuffer(blob, np.uint32)
                nb = len(toks) // need
                for j in range(bstart, nb):
                    take = toks[j * need:(j + 1) * need] \
                        .reshape(batch, self.seq_len + 1)
                    nxt = Cursor(epoch, idx, j + 1) if j + 1 < nb \
                        else Cursor(epoch, idx + 1, 0)
                    yield ({"inputs": take[:, :-1].astype(np.int32),
                            "labels": take[:, 1:].astype(np.int32)}, nxt)
                bstart = 0
                idx += 1
            epoch, idx = epoch + 1, 0

    @property
    def locality_fraction(self) -> float:
        tot = self.local_reads + self.remote_reads
        return self.local_reads / tot if tot else 1.0
