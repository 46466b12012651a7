"""The training loop: Sector data -> Sphere-staged step -> Sector
checkpoints.

The port of ``repro.train.trainer`` on one device (default CUDA).  The
initial parameters come from ``model.init_params(cfg,
torch.Generator().manual_seed(seed), device)``; a checkpoint found
through ``checkpointer`` (in the JAX package's format) replaces them, the
optimizer state and the data cursor, copied into the tensors in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.train import optim
from repro_torch.train.checkpoint import SectorCheckpointer
from repro_torch.train.step import make_train_step
from repro_torch.utils.pytree import tree_leaves


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    lr: float = 3e-4
    warmup: int = 20
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 tcfg: TrainerConfig, pipeline: DataPipeline,
                 checkpointer: Optional[SectorCheckpointer] = None,
                 device=None):
        self.cfg = cfg
        self.pcfg = pcfg
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.ckpt = checkpointer
        self.device = resolve_device(device)
        self.ocfg = optim.AdamWConfig(
            lr=tcfg.lr,
            error_feedback=(pcfg.compress_pod == "int8_ef"))
        self.lr_fn = optim.warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.history: List[Dict] = []
        self.step_idx = 0
        self._build()

    def _build(self) -> None:
        self._step = make_train_step(self.cfg, self.pcfg, self.ocfg,
                                     self.lr_fn)
        self.params = model.init_params(
            self.cfg, torch.Generator().manual_seed(self.tcfg.seed),
            self.device)
        self.opt = optim.init_state(self.params, self.ocfg)
        self.restore_latest()

    def restore_latest(self) -> bool:
        """Load the newest readable checkpoint, if any, into the
        parameters, the optimizer state and the pipeline's cursor.  The
        checkpoint is read to the host and copied leaf by leaf, so the
        device never holds two copies of the state."""
        if self.ckpt is None:
            return False
        restored = self.ckpt.restore_latest({
            "params": model.param_shapes(self.cfg),
            "opt": optim.state_shapes(model.param_shapes(self.cfg),
                                      self.ocfg)})
        if restored is None:
            return False
        with torch.no_grad():
            for dst, src in zip(
                    tree_leaves({"params": self.params, "opt": self.opt}),
                    tree_leaves({"params": restored["params"],
                                 "opt": restored["opt"]})):
                dst.copy_(src)
        self.step_idx = restored["step"]
        if "cursor" in restored.get("extra", {}):
            self.pipeline.load_state_dict(restored["extra"]["cursor"])
        return True

    def run(self, steps: Optional[int] = None) -> List[Dict]:
        n = steps or self.tcfg.steps
        it = iter(self.pipeline)
        t0 = time.time()
        for _ in range(n):
            batch = next(it)
            self.params, self.opt, metrics = self._step(
                self.params, self.opt, batch)
            self.step_idx += 1
            if self.step_idx % self.tcfg.log_every == 0 or \
                    self.step_idx == n:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = self.step_idx
                rec["wall_s"] = time.time() - t0
                self.history.append(rec)
            if self.ckpt is not None and \
                    self.step_idx % self.tcfg.ckpt_every == 0:
                self.save_checkpoint()
        return self.history

    def save_checkpoint(self) -> None:
        self.ckpt.save(self.step_idx, {
            "params": self.params, "opt": self.opt,
            "extra": {"cursor": self.pipeline.state_dict()},
        })
