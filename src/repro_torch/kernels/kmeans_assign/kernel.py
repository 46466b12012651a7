"""Build, load and launch the CUDA kmeans_assign kernel
(``csrc/kmeans_assign.cu``).

The port's counterpart of the Pallas ``_kernel`` launch in
``repro.kernels.kmeans_assign.kernel``.  The source is built by
:mod:`repro_torch.kernels._build` (``nvcc`` for ``sm_90a``, cached by the
hash of ``csrc/``) and bound here with ``ctypes``.

``launches`` counts the launches made by :func:`kmeans_assign_ids`, and
nothing else adds to it, so a run can show that its assign stage went
through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu"
MAX_SHARED = _build.MAX_SHARED

launches = 0


def shared_bytes(k: int, d: int) -> int:
    """Shared memory a block needs: the ``[k, d]`` float32 centroid table
    and ``|c|^2``."""
    return 4 * (k * d + k)


def build(build_dir: Optional[Path] = None) -> Path:
    """Build the source (see :func:`_build.build`); returns the library's
    path."""
    return _build.build(SOURCE, build_dir)


def load_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The kernel library, built into ``build_dir`` on first use."""
    return _build.load(SOURCE, "kmeans_assign_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p], build_dir)


def kmeans_assign_ids(x: torch.Tensor, c: torch.Tensor, *, bn: int):
    """Launch the kernel: ``(ids [n] int32, d2 [n] float32)`` for points
    ``x [n, d]`` (float32 or bfloat16) and centroids ``c [k, d]`` float32
    on one CUDA device; each thread block walks ``bn`` points."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be a 2-D float32 or bfloat16 tensor, got "
                         f"{x.ndim}-D {x.dtype}")
    if c.device != x.device or c.ndim != 2 or c.dtype != torch.float32:
        raise ValueError(f"c must be a 2-D float32 tensor on {x.device}, "
                         f"got {c.ndim}-D {c.dtype} on {c.device}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("x and c must be contiguous")
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d:
        raise ValueError(f"points have {d} dimensions but centroids "
                         f"have {c.shape[1]}")
    if k < 1 or d < 1 or n >= 2 ** 31 or bn < 1:
        raise ValueError(f"unsupported shape: {n} points x {d}, {k} "
                         f"centroids, block {bn}")
    smem = shared_bytes(k, d)
    if smem > MAX_SHARED:
        raise ValueError(f"centroid table too large for shared memory "
                         f"({smem} bytes > {MAX_SHARED})")
    ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    d2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return ids, d2
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.kmeans_assign_launch(
            x.data_ptr(), c.data_ptr(), ids.data_ptr(), d2.data_ptr(),
            n, d, k, bn, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return ids, d2
