"""Plain PyTorch versions of the kmeans_assign kernels.

The same arithmetic as ``csrc/kmeans_assign.cu`` and the JAX package's
oracle: ``d2 = |x|^2 - 2 x.c + |c|^2`` in float32, then the argmin (the
first minimum wins a tie) and the minimum; the partials are the JAX
package's one-hot products over those ids.  The wrappers in :mod:`.ops`
use them for tensors on the CPU; on the card they are the yardstick the
kernels are held to, and then need float32 matrix products in full
precision (``torch.backends.cuda.matmul.allow_tf32 = False``, the
default), or near-tie argmins differ.
"""
from __future__ import annotations

from typing import Optional

import torch


def kmeans_assign_ref(x: torch.Tensor, c: torch.Tensor):
    """``(ids [n] int32, d2 [n] float32)`` for ``x [n, d]``, ``c [k, d]``."""
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    d2 = ((x * x).sum(1)[:, None] - 2 * (x @ c.T)
          + (c * c).sum(1)[None])
    best = d2.min(1)
    return best.indices.to(torch.int32), best.values


def kmeans_partials_ref(x: torch.Tensor, c: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``[k, d + 1]`` float32: per centroid the sum of its points ++ their
    count, over the rows of ``x [n, d]`` whose bool ``valid [n]`` is True
    (all rows when None), ids from :func:`kmeans_assign_ref`."""
    ids, _ = kmeans_assign_ref(x, c)
    oh = torch.nn.functional.one_hot(ids.long(), c.shape[0]) \
        .to(torch.float32)
    if valid is not None:
        oh = oh * valid.to(torch.float32)[:, None]
    return torch.cat([oh.T @ x.to(torch.float32), oh.sum(0)[:, None]], dim=1)
