"""Entry points of the k-means assignment: ``kmeans_assign``,
``kmeans_partials`` and ``kmeans_assign_partials``.

The port of ``repro.kernels.kmeans_assign.ops``.  The route follows the
points' device: CUDA tensors go through the hand-written kernels
(:func:`.kernel.kmeans_assign_ids`, :func:`.kernel.kmeans_partials`) or
raise; CPU tensors take the plain versions (:mod:`.ref`); any other
device raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.kmeans_assign import kernel as _kernel
from repro_torch.kernels.kmeans_assign.ref import (kmeans_assign_ref,
                                                   kmeans_partials_ref)


def kmeans_assign(x: torch.Tensor, c: torch.Tensor, *, block_n: int = 1024
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [N] int32, d2 [N] float32)``: each point's nearest centroid
    (the lowest index on a tie) and its squared distance, for points
    ``x [N, D]`` and centroids ``c [K, D]`` in float32 or bfloat16,
    computed in float32.  On the card at most ``ceil(N / block_n)``
    thread blocks walk the points; the plain version has no blocks."""
    if x.ndim != 2 or c.ndim != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"need x [N, D] and c [K, D], got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    dev = x.device.type
    if dev == "cuda":
        return _kernel.kmeans_assign_ids(
            x.contiguous(), c.to(device=x.device,
                                 dtype=torch.float32).contiguous(),
            bn=block_n)
    if dev != "cpu":
        raise ValueError(f"kmeans_assign runs on cuda or cpu, not {dev}")
    return kmeans_assign_ref(x, c)


def kmeans_partials(x: torch.Tensor, c: torch.Tensor,
                    valid: Optional[torch.Tensor] = None, *,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """``[K, D + 1]`` float32 partials for the Sphere assign stage: per
    centroid the sum of its points ++ their count.

    ``x [N, D]`` points (possibly padded to a fixed block shape),
    ``c [K, D]`` centroids, ``valid`` an optional bool ``[N]`` mask (True =
    real point) so padding rows add nothing.  Points on the card go
    through the fused kernel (:func:`.kernel.kmeans_partials`: one pass,
    no one-hot) unless ``use_kernel`` is False, which asks for the plain
    version on any device (``None`` means "the kernel when ``x`` is on
    CUDA"); CPU tensors always take the plain version."""
    if x.ndim != 2 or c.ndim != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"need x [N, D] and c [K, D], got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    dev = x.device.type
    if use_kernel is None:
        use_kernel = dev == "cuda"
    if use_kernel and dev == "cuda":
        return _kernel.kmeans_partials(
            x.contiguous(),
            c.to(device=x.device, dtype=torch.float32).contiguous(),
            None if valid is None else valid.to(torch.bool).contiguous())
    if use_kernel and dev != "cpu":
        raise ValueError(f"kmeans_partials runs on cuda or cpu, not {dev}")
    return kmeans_partials_ref(x, c, valid)


def kmeans_assign_partials(x: torch.Tensor, c: torch.Tensor,
                           valid: Optional[torch.Tensor] = None, *,
                           block_n: int = 1024,
                           use_kernel: Optional[bool] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-centroid ``(sums [K, D] float32, counts [K] float32)``: views
    of :func:`kmeans_partials`' table.  ``block_n`` is accepted so that a
    call written against the JAX package runs, and is ignored: the fused
    kernel sizes its own grid from the card's occupancy."""
    table = kmeans_partials(x, c, valid, use_kernel=use_kernel)
    d = x.shape[1]
    return table[:, :d], table[:, d]
