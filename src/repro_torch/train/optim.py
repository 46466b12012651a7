"""AdamW (from scratch) with fp32 master weights, + LR schedules.

The port of ``repro.train.optim`` on one device.  The state is the JAX
package's tree: ``step`` (int32), and ``m`` / ``v`` / ``master``, float32
trees shaped like the parameters.  ``apply_updates`` updates the
parameters and the state **in place** under ``torch.no_grad()`` (the JAX
package returns new trees): a step allocates only per-leaf temporaries,
not a second copy of the 16 bytes a parameter the state and weights
take.  The learning rate, the clip factor and the bias corrections stay
on the device as 0-dim tensors, so a step does not wait for the host.

``error_feedback`` adds ``ef``, the float32 residual of the cross-pod
``int8_ef`` compression (zeros initially), shaped like the parameters.

On a mesh every tree here holds the rank's blocks
(:mod:`repro_torch.parallel.sharded`) and the update runs on them
unchanged: only the gradient's global norm needs the whole tree, and
``global_norm`` takes it from the blocks when given their specs and
mesh.  Each leaf is updated a chunk of ``CHUNK`` elements at a time, so a
step's temporaries are a few chunks however large the leaf (the tied
embedding of 655M parameters would otherwise take ten of its own size in
float32); the update is elementwise, so the values do not change.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch

from repro_torch.models.common import sds
from repro_torch.utils.pytree import (tree_flatten_with_paths, tree_leaves,
                                      tree_map)

# elements of a leaf updated at once
CHUNK = 2 ** 24


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # int8_ef cross-pod compression keeps a residual tree in the state
    error_feedback: bool = False


def warmup_cosine(lr: float, warmup: int, total: int) -> Callable:
    """``f(step)``: linear warm-up over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; float32, on the device of a tensor
    ``step``."""
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * (step + 1) / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f


def state_shapes(param_tree, ocfg: AdamWConfig) -> Dict:
    """TensorSpec tree for the optimizer state."""
    def f32(s):
        return sds(s.shape, torch.float32)
    out = {
        "step": sds((), torch.int32),
        "m": tree_map(f32, param_tree),
        "v": tree_map(f32, param_tree),
        "master": tree_map(f32, param_tree),
    }
    if ocfg.error_feedback:
        out["ef"] = tree_map(f32, param_tree)
    return out


def init_state(params, ocfg: AdamWConfig):
    """Zero moments (and residuals) and an fp32 copy of ``params``, on
    their device."""
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    out = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }
    if ocfg.error_feedback:
        out["ef"] = tree_map(zeros, params)
    return out


def global_norm(tree, *, specs=None, mesh=None) -> torch.Tensor:
    """The norm of the whole tree.  On a mesh (``specs`` the tree's
    PartitionSpecs) ``tree`` holds this rank's blocks: their squares are
    summed over the mesh, each block once
    (``sharded.global_norm_sq``)."""
    if mesh is not None:
        from repro_torch.parallel.sharded import global_norm_sq
        return torch.sqrt(global_norm_sq(tree, specs, mesh))
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def _update(p, g, m, v, w, decay: bool, clip, lr, c1, c2,
            ocfg: AdamWConfig) -> None:
    """The AdamW update of one chunk of a leaf, in place."""
    gf = g.float() * clip
    m.mul_(ocfg.b1).add_((1 - ocfg.b1) * gf)
    v.mul_(ocfg.b2).add_((1 - ocfg.b2) * torch.square(gf))
    del gf
    upd = (m / c1) / (torch.sqrt(v / c2) + ocfg.eps)
    if decay:
        upd = upd + ocfg.weight_decay * w
    w.sub_(lr * upd)
    del upd
    p.copy_(w)


def _decay_mask(path: str) -> bool:
    """Weight decay only on matrices (skip norms/biases/1-D gates)."""
    leaf = path.rsplit("/", 1)[-1]
    return not (leaf in ("scale",) or leaf.startswith("b")
                or leaf.endswith("_norm") or leaf == "a_param")


@torch.no_grad()
def apply_updates(params, grads, state, ocfg: AdamWConfig,
                  lr_fn: Callable, *, specs=None, mesh=None):
    """One AdamW step, in place. Returns (params, state, metrics): the
    same ``params`` and ``state`` objects, updated.  On a mesh the trees
    are blocks (``specs``, ``mesh``: :func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, specs=specs, mesh=mesh)
    if ocfg.grad_clip:
        clip = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
    else:
        clip = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = lr_fn(state["step"])
    b1, b2 = ocfg.b1, ocfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    flat_p = tree_flatten_with_paths(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"])
    flat_w = tree_leaves(state["master"])
    for (path, p), g, m, v, w in zip(flat_p, flat_g, flat_m, flat_v,
                                     flat_w):
        decay = _decay_mask(path)
        g = g.reshape(-1)
        p, m, v, w = (t.view(-1) for t in (p, m, v, w))
        for i in range(0, p.numel(), CHUNK):
            _update(p[i:i + CHUNK], g[i:i + CHUNK], m[i:i + CHUNK],
                    v[i:i + CHUNK], w[i:i + CHUNK], decay, clip, lr, c1, c2,
                    ocfg)

    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
