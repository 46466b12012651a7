"""Serving engine with continuous batching over a fixed slot pool.

The port of ``repro.serve.engine``.  Decode runs as one batched step over
``max_batch`` slots; requests stream in and out of slots (continuous
batching).  Prefill runs each admitted prompt alone (batch 1) at its own
length, and its cache is written into the pooled ``[G, B, ...]`` cache at
the slot index, in place (the JAX package returns a new pool): every
leaf of the slot, whatever its type (the bf16 KV caches, the float32
RG-LRU / mLSTM / sLSTM states), is overwritten whole, so a recycled slot
keeps nothing of its last request.  The one exception is the JAX
package's own: an encoder-decoder's cross K / V pool holds ``max_len``
memory rows, and a request whose frames are fewer writes only their
prefix (``dynamic_update_slice``), leaving the rest of the slot's rows
to the last request, which decode then attends (``ROADMAP.md`` §3).
Finished slots (EOS or token budget) are recycled immediately.

On a serving mesh (``pcfg.mesh``: one ``torch.distributed`` rank per
process, ``layout="tp"``, ``train.step.check_serving_mesh``) ``params``
are this rank's blocks (``param_specs_for``).  The engine gathers once,
when it starts, every leaf but those the layers compute on a ``model``
block, and those over the batch axes alone (``step.serve_params``); it
gathers no weight while it serves.  Its cache is its block of the pool
(``step.cache_specs_for``): its slots, over the batch axes, and along
``model`` its kv heads, or its block of the sequence, or its slice of
the RG-LRU width.  Every rank runs the same loop over the same queue.
A batch-1 prefill runs on every rank (one prompt does not split over the
batch axes), each ``model`` group computing it on its blocks, and only
the ranks whose slots hold the request keep its cache.  A decode step
runs each rank's slots; the logits are gathered over the batch axes,
and every rank samples from the same values with its generator seeded
0, so every rank's slot bookkeeping is the same.  The prefill and
decode run through ``step.make_prefill_step`` / ``make_decode_step``.

Everything runs under ``torch.inference_mode()``.  Each request carries
host-clock stamps (``time.perf_counter``): ``t_submit``, ``t_admit``
(its prefill starts) and ``t_first`` (its first token is on the host).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import NO_PARALLEL, ParallelConfig
from repro_torch.serve.sampler import SamplerConfig, sample
from repro_torch.train import step as steps
from repro_torch.utils.pytree import tree_leaves, tree_map


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 32
    enc_frames: Optional[np.ndarray] = None
    out: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params,
                 pcfg: ParallelConfig = NO_PARALLEL,
                 max_batch: int = 4, max_len: int = 256,
                 eos_id: int = -1,
                 scfg: SamplerConfig = SamplerConfig(),
                 device=None):
        """``params`` must lie on ``device`` (default CUDA; on a mesh the
        mesh's device, and ``params`` are this rank's blocks); sampling
        draws from a generator on ``device`` seeded 0 (the JAX package's
        ``PRNGKey(0)``)."""
        mesh = pcfg.mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        leaf = tree_leaves(params)[0]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params are on {leaf.device}, the engine on "
                             f"{self.device}")
        steps.check_serving_mesh(cfg, pcfg)
        self.cfg = cfg
        self.params = steps.serve_params(cfg, pcfg, params)
        self.pcfg = pcfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.scfg = scfg
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        cross = max_len if cfg.is_encoder_decoder else 0
        with torch.inference_mode():
            self.cache = steps.init_cache_blocks(
                cfg, pcfg, max_batch, max_len, cross_len=cross,
                device=self.device)
        # the pool's slots this rank holds (all of them off a mesh)
        self._held = steps.serve_rows(torch.arange(max_batch),
                                      pcfg)[0].tolist()
        self._prefill = steps.make_prefill_step(cfg, pcfg, max_len)
        self._decode = steps.make_decode_step(cfg, pcfg, max_len)
        self.pos = np.zeros(max_batch, np.int32)
        self.tok = np.zeros(max_batch, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._rid = 0

    @staticmethod
    def _insert(pool, new, slot: int) -> None:
        """Write a batch-1 cache ``new`` ([G, 1, ...] leaves) into the
        pool's ([G, B, ...] leaves) slot, in place, at offset 0 of every
        further axis: a leaf shorter than the pool's fills its prefix, as
        the JAX package's ``dynamic_update_slice`` does."""
        def put(a, b):
            prefix = tuple(slice(0, n) for n in b.shape[2:])
            a[(slice(None), slice(slot, slot + 1)) + prefix].copy_(b)
        tree_map(put, pool, new)

    # ------------------------------------------------------------- requests
    def submit(self, prompt: List[int], max_new: int = 32,
               enc_frames: Optional[np.ndarray] = None) -> Request:
        """Queue a request; ``enc_frames`` ``[1, F, d_model]`` (F at most
        ``max_len``) are an encoder-decoder's encoder input, zeros of
        ``max_len`` frames when left out."""
        req = Request(self._rid, [int(t) for t in prompt], max_new,
                      enc_frames, t_submit=time.perf_counter())
        self._rid += 1
        self.queue.append(req)
        return req

    @torch.inference_mode()
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            req.t_admit = time.perf_counter()
            batch = {"inputs": torch.tensor([req.prompt], dtype=torch.int32,
                                            device=self.device)}
            if self.cfg.is_encoder_decoder:
                frames = req.enc_frames
                if frames is None:
                    frames = np.zeros((1, self.max_len, self.cfg.d_model),
                                      np.float32)
                # bf16 whatever the compute type, as the JAX engine does
                batch["enc_frames"] = torch.as_tensor(frames).to(
                    self.device).to(torch.bfloat16)
            last_logits, cache1 = self._prefill(self.params, batch)
            if slot in self._held:
                self._insert(self.cache, cache1, slot - self._held[0])
            tok = int(sample(last_logits, self.generator, self.scfg)[0])
            req.t_first = time.perf_counter()
            req.out.append(tok)
            self.slot_req[slot] = req
            self.pos[slot] = len(req.prompt)
            self.tok[slot] = tok

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> int:
        """One batched decode step. Returns #active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tok = torch.from_numpy(self.tok[:, None].copy()).to(self.device)
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        logits, self.cache = self._decode(self.params, self.cache, tok, pos)
        nxt = sample(logits, self.generator, self.scfg).cpu().numpy()
        for slot in active:
            req = self.slot_req[slot]
            t = int(nxt[slot])
            req.out.append(t)
            self.pos[slot] += 1
            self.tok[slot] = t
            if t == self.eos_id or len(req.out) >= req.max_new or \
                    self.pos[slot] >= self.max_len - 1:
                req.done = True
                self.slot_req[slot] = None  # recycle immediately
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
