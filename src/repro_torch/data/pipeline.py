"""Device feed: host batches -> tensors on the training device, with
lookahead.

The port of ``repro.data.pipeline``.  One process feeds one device: each
batch from the dataset becomes ``int32`` tensors on ``device`` (default
CUDA).  On the card a batch goes through pinned host memory and a
``non_blocking`` copy, so the copy of the next batch overlaps the step
that runs; prefetch depth 2 also overlaps the host-side chunk reads.  A
mesh is not ported (``ROADMAP.md`` item 1.3c): ``pcfg`` is kept for the
JAX package's signature.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator

import torch

from repro_torch.data.dataset import Cursor, SectorTokenDataset
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import ParallelConfig


class DataPipeline:
    def __init__(self, dataset: SectorTokenDataset, batch: int,
                 pcfg: ParallelConfig, prefetch: int = 2, device=None):
        self.dataset = dataset
        self.batch = batch
        self.pcfg = pcfg
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.cursor = Cursor()

    def _place(self, host_batch: dict) -> dict:
        out = {}
        for k, v in host_batch.items():
            t = torch.from_numpy(v)
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
