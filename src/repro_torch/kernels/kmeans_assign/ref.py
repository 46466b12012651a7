"""Plain PyTorch version of the kmeans_assign kernel.

The same arithmetic as ``csrc/kmeans_assign.cu`` and the JAX package's
oracle: ``d2 = |x|^2 - 2 x.c + |c|^2`` in float32, then the argmin (the
first minimum wins a tie) and the minimum.  The wrappers in :mod:`.ops`
use it for tensors on the CPU; on the card it is the yardstick the kernel
is held to, and then needs float32 matrix products in full precision
(``torch.backends.cuda.matmul.allow_tf32 = False``, the default), or
near-tie argmins differ.
"""
from __future__ import annotations

import torch


def kmeans_assign_ref(x: torch.Tensor, c: torch.Tensor):
    """``(ids [n] int32, d2 [n] float32)`` for ``x [n, d]``, ``c [k, d]``."""
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    d2 = ((x * x).sum(1)[:, None] - 2 * (x @ c.T)
          + (c * c).sum(1)[None])
    best = d2.min(1)
    return best.indices.to(torch.int32), best.values
