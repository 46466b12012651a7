"""Shared model primitives: RMSNorm, RoPE, activations, param materialization.

The port of ``repro.models.common``.  Every sub-module exposes
``shapes(cfg) -> nested dict of TensorSpec``; ``materialize(shapes,
generator, device)`` turns that into real tensors (fan-in scaled normal
init) and is the ONLY place parameters are allocated.  The rules are the
JAX package's; the random numbers come from ``torch.Generator`` and so
differ from ``jax.random``'s: parity tests carry the JAX package's
parameters across (``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.utils.pytree import tree_map_with_path


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def to_dtype(dtype) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32", ...) as a torch
    dtype; a torch dtype passes through."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (the port's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(s) for s in shape), to_dtype(dtype))


# ---------------------------------------------------------------------------
# Parameter materialization
# ---------------------------------------------------------------------------

# elements drawn at once when a leaf is filled slice by slice: 64 MiB of
# float32 (a bigger slice of the leading axis is drawn alone)
DRAW_ELEMS = 2 ** 24


def _init_leaf(path: str, spec: TensorSpec, gen: torch.Generator,
               device) -> torch.Tensor:
    """Fan-in-scaled normal init; norms/scales init to 1, biases/gates to 0.

    A leaf of more than one dimension is allocated in its own dtype and
    filled a block of its leading axis at a time (as many slices as fit in
    ``DRAW_ELEMS``, at least one), each block drawn in float32 and scaled,
    so no leaf is ever held whole in float32: the MoE experts' ``[48, 128,
    2048, 768]`` leaf alone would take 38.65 GB so."""
    name = path.rsplit("/", 1)[-1]
    shape, dtype = spec.shape, spec.dtype
    if name in ("scale",) or name.endswith("_norm"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name.startswith("b") or name in ("bias",) or name.endswith("_bias"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "a_param":  # RG-LRU recurrence parameter (see rglru.py)
        # initialised so that a = exp(-8*sigmoid(a_param)) spans ~(0.9, 0.999)
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device) * (0.999 - 0.9) + 0.9
        inner = torch.clamp(-torch.log(u) / 8.0, 1e-6, 1 - 1e-6)
        return torch.log(inner / (1 - inner)).to(dtype)
    if len(shape) == 0:
        return torch.zeros(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    if len(shape) == 1:
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_ELEMS // math.prod(shape[1:]))
    for i in range(0, shape[0], rows):
        # one float32 block alive at a time: drawn, scaled in place and
        # copied into the leaf's dtype within one statement
        out[i:i + rows].copy_(torch.randn(
            (min(rows, shape[0] - i),) + shape[1:], generator=gen,
            dtype=torch.float32, device=device).mul_(std))
    return out


def materialize(shape_tree, generator: torch.Generator, device, keep=None):
    """Instantiate a tree of TensorSpecs into tensors on ``device``.

    One seed is drawn from ``generator``; each leaf's own generator (on
    ``device``) is seeded with it and a *stable* hash of the leaf's path
    (crc32), as the JAX package folds the path into its key, so a leaf's
    values do not depend on which other leaves the tree holds.  ``keep(path,
    leaf)``, where given, replaces each leaf as soon as it is made (a mesh
    rank keeps its block of it)."""
    device = torch.device(device)
    base = int(torch.randint(0, 2 ** 31, (1,), generator=generator))

    def leaf(path, spec):
        gen = torch.Generator(device=device)
        gen.manual_seed(base * (2 ** 31) + zlib.crc32(path.encode()) % (2 ** 31))
        x = _init_leaf(path, spec, gen, device)
        return x if keep is None else keep(path, x)

    return tree_map_with_path(leaf, shape_tree)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def activation(name: str):
    if name in ("silu", "swish"):
        return F.silu
    if name in ("gelu", "geglu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float) -> torch.Tensor:
    exponent = np.arange(0, d_head, 2, dtype=np.float32) / d_head
    return torch.from_numpy(np.asarray(1.0 / (theta**exponent),
                                       np.float32))  # [d_head/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta).to(x.device)  # [d/2]
    angles = positions[..., None].float() * freqs  # [..., T, d/2]
    angles = angles[..., None, :]  # [..., T, 1, d/2] broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (recurrent blocks)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B, T, C]; w: [W, C].

    When ``state`` ([B, W-1, C], trailing context) is given, runs in streaming
    mode and returns (y, new_state); otherwise zero-pads on the left.
    """
    width = w.shape[0]
    T = x.shape[-2]
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (width - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=-2)  # [B, T+W-1, C]
    y = xp[..., 0:T, :] * w[0][None, None, :]
    for i in range(1, width):
        y = y + xp[..., i:i + T, :] * w[i][None, None, :]
    if state is None:
        return y.to(x.dtype)
    new_state = xp[..., -(width - 1):, :] if width > 1 else state
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Block-diagonal linear (xLSTM qkv, RG-LRU gates)
# ---------------------------------------------------------------------------

def block_diag_shapes(n_blocks: int, dim: int, out_per_block: int,
                      dtype) -> Dict:
    if dim % n_blocks:
        raise ValueError(f"dim {dim} is not a multiple of {n_blocks} blocks")
    return {"w": sds((n_blocks, dim // n_blocks, out_per_block), dtype)}


def block_diag_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., dim] -> [..., n_blocks * out_per_block]."""
    nb, ib, ob = params["w"].shape
    xs = x.reshape(x.shape[:-1] + (nb, ib))
    y = torch.einsum("...ni,nio->...no", xs, params["w"])
    return y.reshape(x.shape[:-1] + (nb * ob,))
