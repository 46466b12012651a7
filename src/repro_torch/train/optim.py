"""AdamW (from scratch) with fp32 master weights, + LR schedules.

The port of ``repro.train.optim`` on one device.  The state is the JAX
package's tree: ``step`` (int32), and ``m`` / ``v`` / ``master``, float32
trees shaped like the parameters.  ``apply_updates`` updates the
parameters and the state **in place** under ``torch.no_grad()`` (the JAX
package returns new trees): a step allocates only per-leaf temporaries,
not a second copy of the 16 bytes a parameter the state and weights
take.  The learning rate, the clip factor and the bias corrections stay
on the device as 0-dim tensors, so a step does not wait for the host.

The ``error_feedback`` residual of the cross-pod ``int8_ef`` compression
serves the podwise mode only, which needs a mesh (``ROADMAP.md`` item
1.3c): asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch

from repro_torch.models.common import sds
from repro_torch.utils.pytree import (tree_flatten_with_paths, tree_leaves,
                                      tree_map)


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


def _no_error_feedback(ocfg: AdamWConfig) -> None:
    if ocfg.error_feedback:
        raise NotImplementedError(
            "error_feedback (int8_ef cross-pod compression) belongs to the "
            "podwise mode, which needs a mesh: not ported yet (ROADMAP.md "
            "item 1.3c, the mesh)")


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
    _no_error_feedback(ocfg)

    def f32(s):
        return sds(s.shape, torch.float32)
    return {
        "step": sds((), torch.int32),
        "m": tree_map(f32, param_tree),
        "v": tree_map(f32, param_tree),
        "master": tree_map(f32, param_tree),
    }


def init_state(params, ocfg: AdamWConfig):
    """Zero moments and an fp32 copy of ``params``, on their device."""
    _no_error_feedback(ocfg)
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def _decay_mask(path: str) -> bool:
    """Weight decay only on matrices (skip norms/biases/1-D gates)."""
    leaf = path.rsplit("/", 1)[-1]
    return not (leaf in ("scale",) or leaf.startswith("b")
                or leaf.endswith("_norm") or leaf == "a_param")


@torch.no_grad()
def apply_updates(params, grads, state, ocfg: AdamWConfig,
                  lr_fn: Callable):
    """One AdamW step, in place. Returns (params, state, metrics): the
    same ``params`` and ``state`` objects, updated."""
    _no_error_feedback(ocfg)
    step = state["step"] + 1
    gnorm = global_norm(grads)
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
        gf = g.float() * clip
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        del gf
        upd = (m / c1) / (torch.sqrt(v / c2) + ocfg.eps)
        if _decay_mask(path):
            upd = upd + ocfg.weight_decay * w
        w.sub_(lr * upd)
        del upd
        p.copy_(w)

    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
