"""Device feed: host batches -> tensors on the training device, with
lookahead.

The port of ``repro.data.pipeline``.  One process feeds one device: each
batch from the dataset becomes ``int32`` tensors on ``device`` (default
CUDA, or the mesh's).  On the card a batch goes through pinned host
memory and a ``non_blocking`` copy, so the copy of the next batch
overlaps the step that runs; prefetch depth 2 also overlaps the
host-side chunk reads.  On a mesh (``pcfg.mesh``) every rank reads the
same global batch from Sector with the same cursor and keeps its rows
(the JAX package places the global batch with ``batch_spec(pcfg,
None)``: the leading dim split over the data axes), in the order the
train step takes them (``train.step.local_batch``: its rows of each
global microbatch in turn).
"""
from __future__ import annotations

from collections import deque
from typing import Iterator

import torch

from repro_torch.data.dataset import Cursor, SectorTokenDataset
from repro_torch.device import mesh_device
from repro_torch.parallel.sharding import ParallelConfig


class DataPipeline:
    def __init__(self, dataset: SectorTokenDataset, batch: int,
                 pcfg: ParallelConfig, prefetch: int = 2, device=None):
        self.dataset = dataset
        self.batch = batch
        self.pcfg = pcfg
        self.prefetch = prefetch
        self.device = mesh_device(pcfg.mesh, device)
        self.cursor = Cursor()

    def _place(self, host_batch: dict) -> dict:
        # imported here: the train package imports this module
        from repro_torch.train.step import local_batch
        out = {}
        rows = local_batch({k: torch.from_numpy(v)
                            for k, v in host_batch.items()}, self.pcfg)
        for k, t in rows.items():
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        return out

    def __iter__(self) -> Iterator[dict]:
        gen = self.dataset.batches(self.batch, self.cursor)
        queue: deque = deque()
        while True:
            while len(queue) < self.prefetch:
                host, cur = next(gen)
                queue.append((self._place(host), cur))
            placed, cur = queue.popleft()
            self.cursor = cur
            yield placed

    # resume support
    def state_dict(self) -> dict:
        return self.cursor.as_dict()

    def load_state_dict(self, d: dict) -> None:
        self.cursor = Cursor.from_dict(d)
