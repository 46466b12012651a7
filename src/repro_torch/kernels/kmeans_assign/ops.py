"""Entry points of the k-means assignment: ``kmeans_assign`` and
``kmeans_assign_partials``.

The port of ``repro.kernels.kmeans_assign.ops``.  The route follows the
points' device: CUDA tensors go through the hand-written kernel
(:func:`.kernel.kmeans_assign_ids`) or raise; CPU tensors take the plain
version (:mod:`.ref`); any other device raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.kmeans_assign import kernel as _kernel
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref


def kmeans_assign(x: torch.Tensor, c: torch.Tensor, *, block_n: int = 1024
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [N] int32, d2 [N] float32)``: each point's nearest centroid
    (the lowest index on a tie) and its squared distance, for points
    ``x [N, D]`` and centroids ``c [K, D]`` in float32 or bfloat16,
    computed in float32.  ``block_n`` is the points a thread block walks
    on the card; the plain version has no blocks."""
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


def kmeans_assign_partials(x: torch.Tensor, c: torch.Tensor,
                           valid: Optional[torch.Tensor] = None, *,
                           block_n: int = 1024,
                           use_kernel: Optional[bool] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-centroid ``(sums [K, D] float32, counts [K] float32)`` partials
    for the Sphere assign stage.

    ``x [N, D]`` points (possibly padded to a fixed block shape),
    ``c [K, D]`` centroids, ``valid`` an optional bool ``[N]`` mask (True =
    real point) so padding rows add nothing.  Nearest-centroid ids come
    from :func:`kmeans_assign` — the kernel for points on the card —
    unless ``use_kernel`` is False, which asks for the plain version on
    any device (``None`` means "the kernel when ``x`` is on CUDA").  The
    one-hot products ``oh.T @ x`` stay plain tensor ops, as the JAX
    package leaves them outside its kernel.
    """
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if use_kernel:
        ids, _ = kmeans_assign(x, c, block_n=block_n)
    else:
        ids, _ = kmeans_assign_ref(x, c)
    oh = torch.nn.functional.one_hot(ids.long(), c.shape[0]) \
        .to(torch.float32)
    if valid is not None:
        oh = oh * valid.to(torch.float32)[:, None]
    sums = oh.T @ x.to(torch.float32)
    counts = oh.sum(0)
    return sums, counts
