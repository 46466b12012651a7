"""The training loop: Sector data -> Sphere-staged step -> Sector
checkpoints.

The port of ``repro.train.trainer`` on one device (default CUDA) or on
a mesh (``pcfg.mesh``, one ``torch.distributed`` rank per process).  The
initial parameters come from ``model.init_params(cfg,
torch.Generator().manual_seed(seed), device)``: on a mesh every rank
makes the same whole tree, leaf by leaf, and keeps its blocks
(:mod:`repro_torch.parallel.sharded`), so a mesh run starts where the
single-device run starts.  A checkpoint found through ``checkpointer``
(in the JAX package's format) replaces them, the optimizer state and
the data cursor, copied into the tensors in place.

On a mesh a checkpoint holds whole leaves: ``save_checkpoint`` gathers
them on every rank and rank 0 writes them; ``restore_latest`` has rank 0
read them and send each leaf to the other ranks, which keep their
blocks.  So a checkpoint written on any mesh restores on any other, and
on one device; only rank 0's checkpointer is read or written.  The
podwise mode's ``ef`` residual differs from pod to pod: a checkpoint
keeps pod 0's.  ``_build`` may run again after ``pcfg`` takes a new
mesh (:mod:`repro_torch.train.elastic`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import mesh_device
from repro_torch.models import model
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import P, ParallelConfig, param_specs_for
from repro_torch.train import optim
from repro_torch.train.checkpoint import SectorCheckpointer
from repro_torch.train.step import make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_leaves


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
        self._device = device
        self.ocfg = optim.AdamWConfig(
            lr=tcfg.lr,
            error_feedback=(pcfg.compress_pod == "int8_ef"))
        self.lr_fn = optim.warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.history: List[Dict] = []
        self.step_idx = 0
        self._build()

    @property
    def mesh(self):
        return self.pcfg.mesh

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def _build(self) -> None:
        """The step, the parameters from the seed and a fresh state (this
        rank's blocks on a mesh), then the newest checkpoint, if any."""
        self.device = mesh_device(self.mesh, self._device)
        self.pipeline.pcfg = self.pcfg       # its rows follow the mesh
        self._step = make_train_step(self.cfg, self.pcfg, self.ocfg,
                                     self.lr_fn)
        self.params = self.opt = None        # free the old mesh's blocks
        pshapes = model.param_shapes(self.cfg)
        self.specs = param_specs_for(pshapes, self.pcfg)
        keep = None
        if self.mesh is not None:
            flat = dict(tree_flatten_with_paths(self.specs))

            def keep(path, x):
                return sharded.local_block(x, flat[path], self.mesh)
        self.params = model.init_params(
            self.cfg, torch.Generator().manual_seed(self.tcfg.seed),
            self.device, keep=keep)
        self.opt = optim.init_state(self.params, self.ocfg)
        self.restore_latest()

    def _tree(self) -> dict:
        return {"params": self.params, "opt": self.opt}

    def _specs(self) -> dict:
        """Each leaf's spec in the checkpointed tree: the state's trees
        (``ef`` included) are blocked as their parameters."""
        opt = {k: (P() if k == "step" else self.specs) for k in self.opt}
        return {"params": self.specs, "opt": opt}

    def _shapes(self) -> dict:
        pshapes = model.param_shapes(self.cfg)
        return {"params": pshapes,
                "opt": optim.state_shapes(pshapes, self.ocfg)}

    def restore_latest(self) -> bool:
        """Load the newest readable checkpoint, if any, into the
        parameters, the optimizer state and the pipeline's cursor.  The
        checkpoint is read to the host and copied leaf by leaf, so the
        device never holds two copies of the state.  On a mesh rank 0
        reads it and sends it, leaf by leaf, over the mesh's host group;
        each rank copies its block."""
        restored = None
        if self.ckpt is not None and self.rank == 0:
            restored = self.ckpt.restore_latest(self._shapes())
        head = [None if restored is None else
                (restored["step"], restored.get("extra", {}))]
        if self.mesh is not None and self.mesh.group is not None:
            dist.broadcast_object_list(
                head, src=dist.get_global_rank(self.mesh.host_group, 0),
                group=self.mesh.host_group)
        if head[0] is None:
            return False
        step, extra = head[0]
        flat = tree_leaves({"params": restored["params"],
                            "opt": restored["opt"]}) if restored else None
        with torch.no_grad():
            for i, (dst, spec, like) in enumerate(zip(
                    tree_leaves(self._tree()), tree_leaves(self._specs()),
                    tree_leaves(self._shapes()))):
                src = flat[i].to(like.dtype) if restored else torch.empty(
                    like.shape, dtype=like.dtype)
                if self.mesh is not None:
                    if self.mesh.group is not None:
                        dist.broadcast(
                            src, src=dist.get_global_rank(
                                self.mesh.host_group, 0),
                            group=self.mesh.host_group)
                    src = sharded.local_block(src, spec, self.mesh)
                dst.copy_(src)
        self.step_idx = step
        if "cursor" in extra:
            self.pipeline.load_state_dict(extra["cursor"])
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
        """Save through the checkpointer; on a mesh every rank gathers the
        whole leaves (a collective) and rank 0 writes them."""
        tree = self._tree()
        if self.mesh is not None:
            tree = sharded.gather_tree(tree, self._specs(), self._shapes(),
                                       self.mesh)
        if self.rank == 0:
            self.ckpt.save(self.step_idx, {
                **tree, "extra": {"cursor": self.pipeline.state_dict()}})
