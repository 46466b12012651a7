"""The train step builder: the port of ``repro.train.step`` on one
device.

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the JAX package's ``pjit`` mode on one device, a
forward and backward through autograd followed by the AdamW update, in
place.  The ``podwise`` mode (a manual ``pod`` axis and the explicit,
optionally compressed cross-pod gradient reduction), ``multi_pod`` and
the sharding-spec trees the JAX launcher jits with need a mesh: they
raise ``NotImplementedError`` until the mesh is ported (``ROADMAP.md``
item 1.3c).  The serve-step builders are not ported: the port's
``ServeEngine`` calls ``model.prefill`` / ``model.decode_step`` itself.

A training step is a two-stage Sphere job: stage 1 = the
local fwd/bwd UDF over the batch, stage 2 = the optimizer UDF.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.train import optim
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_unflatten

MESH_QUEUE = "needs a mesh: not ported yet (ROADMAP.md item 1.3c, the mesh)"
METRIC_KEYS = ("nll", "z_loss", "accuracy", "tokens", "aux_loss")


def _no_mesh(what: str):
    raise NotImplementedError(f"{what} {MESH_QUEUE}")


# ---------------------------------------------------------------------------
# Sharding spec trees: mesh only
# ---------------------------------------------------------------------------

def batch_specs_for(batch_tree, pcfg: ParallelConfig):
    _no_mesh("batch_specs_for")


def opt_state_specs_for(param_tree, pcfg: ParallelConfig,
                        ocfg: optim.AdamWConfig):
    _no_mesh("opt_state_specs_for")


def cache_specs_for(cache_tree, pcfg: ParallelConfig):
    _no_mesh("cache_specs_for")


def to_shardings(spec_tree, mesh):
    _no_mesh("to_shardings")


def train_state_specs(cfg: ModelConfig, pcfg: ParallelConfig,
                      ocfg: optim.AdamWConfig, batch_tree):
    _no_mesh("train_state_specs")


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _loss_and_grads(leaves, template, batch, *, cfg, pcfg):
    """(loss, metrics, grads) of ``model.loss_fn`` at the parameters
    ``leaves`` (in tree order), all detached."""
    params = tree_unflatten(template, leaves)
    loss, metrics = model.loss_fn(params, batch, cfg=cfg, pcfg=pcfg)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _value_and_grad_accum(params, batch, *, cfg, pcfg):
    """fwd/bwd with optional gradient accumulation over microbatches.
    Returns ((loss, metrics), grads), ``grads`` shaped like ``params``.

    Gradients are taken with respect to detached aliases of the parameter
    tensors (the same storage, no copy), so the parameters themselves need
    not require grad and the update may write them in place.  With
    ``accum_steps > 1`` the global batch is split along dim 0 and run
    microbatch by microbatch, accumulating fp32 grads: activation memory
    divides by ``accum_steps``."""
    leaves = [p.detach().requires_grad_() for _, p in
              tree_flatten_with_paths(params)]
    n = pcfg.accum_steps
    if n <= 1:
        loss, metrics, grads = _loss_and_grads(leaves, params, batch,
                                               cfg=cfg, pcfg=pcfg)
        return (loss, metrics), tree_unflatten(params, grads)

    micro = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])
             for k, x in batch.items()}
    acc_g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    dev = acc_g[0].device
    acc_l = torch.zeros((), dtype=torch.float32, device=dev)
    acc_m = {k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in METRIC_KEYS}
    for i in range(n):
        loss, metrics, grads = _loss_and_grads(
            leaves, params, {k: x[i] for k, x in micro.items()}, cfg=cfg,
            pcfg=pcfg)
        for a, g in zip(acc_g, grads):
            a.add_(g.float() / n)
        acc_l = acc_l + loss / n
        acc_m = {k: acc_m[k] + metrics[k] / n for k in acc_m}
    return (acc_l, acc_m), tree_unflatten(params, acc_g)


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: optim.AdamWConfig, lr_fn: Callable):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` in place."""
    if pcfg.mode not in ("pjit", "podwise"):
        raise ValueError(pcfg.mode)
    if pcfg.mode == "podwise":
        _no_mesh("the podwise train step (a manual pod axis)")
    if pcfg.multi_pod:
        _no_mesh("multi_pod training")

    def step(params, opt_state, batch):
        (loss, metrics), grads = _value_and_grad_accum(
            params, batch, cfg=cfg, pcfg=pcfg)
        new_params, new_opt, om = optim.apply_updates(
            params, grads, opt_state, ocfg, lr_fn)
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    return step
