"""Build, load and launch the CUDA kmeans_assign kernels
(``csrc/kmeans_assign.cu``).

The port's counterpart of the Pallas ``_kernel`` launch in
``repro.kernels.kmeans_assign.kernel`` (:func:`kmeans_assign_ids`) and of
the one-hot partials the JAX package builds around it
(:func:`kmeans_partials`, one pass over the points).  The source is built
by :mod:`repro_torch.kernels._build` (``nvcc`` for ``sm_90a``, cached by
the hash of ``csrc/``) and bound here with ``ctypes``.

``launches`` counts the launches made by :func:`kmeans_assign_ids`,
``partials_launches`` the passes over the points made by
:func:`kmeans_partials` (each followed by one launch of the small kernel
that sums the per-block rows), and nothing else adds to either, so a run
can show that its assign stage went through the kernel.
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
partials_launches = 0


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
    lib = _build.load(SOURCE, "kmeans_assign_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p], build_dir)
    if lib.kmeans_partials_launch.argtypes is None:
        for name, args in (
                ("kmeans_partials_blocks",
                 [ctypes.c_void_p] + [ctypes.c_int] * 4
                 + [ctypes.POINTER(ctypes.c_int)]),
                ("kmeans_partials_launch",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _check_inputs(x: torch.Tensor, c: torch.Tensor):
    """(n, d, k) of points ``x`` and centroids ``c`` the kernels take, or
    ``ValueError``; the device is checked last."""
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be a 2-D float32 or bfloat16 tensor, got "
                         f"{x.ndim}-D {x.dtype}")
    if c.ndim != 2 or c.dtype != torch.float32:
        raise ValueError(f"c must be a 2-D float32 tensor, got {c.ndim}-D "
                         f"{c.dtype}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("x and c must be contiguous")
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d:
        raise ValueError(f"points have {d} dimensions but centroids "
                         f"have {c.shape[1]}")
    if k < 1 or d < 1 or n >= 2 ** 31:
        raise ValueError(f"unsupported shape: {n} points x {d}, {k} "
                         f"centroids")
    smem = shared_bytes(k, d)
    if smem > MAX_SHARED:
        raise ValueError(f"centroid table too large for shared memory "
                         f"({smem} bytes > {MAX_SHARED})")
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"the CUDA kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {c.device}")
    return n, d, k


def kmeans_assign_ids(x: torch.Tensor, c: torch.Tensor, *, bn: int):
    """Launch the ids kernel: ``(ids [n] int32, d2 [n] float32)`` for
    points ``x [n, d]`` (float32 or bfloat16) and centroids ``c [k, d]``
    float32 on one CUDA device; at most ``ceil(n / bn)`` thread blocks
    walk the points."""
    global launches
    n, d, k = _check_inputs(x, c)
    if bn < 1:
        raise ValueError(f"unsupported block: {bn}")
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


def kmeans_partials(x: torch.Tensor, c: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the partials kernel: ``[k, d + 1]`` float32, per centroid
    the sum of the points nearest to it (ids as :func:`kmeans_assign_ids`
    gives them, bit for bit) and, in the last column, their count, over
    the points whose ``valid`` (bool ``[n]``; all points when None) is
    True.  Counts are exact below 2**24 points; the sums are taken in a
    fixed order, so the same inputs give the same bits."""
    global partials_launches
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != x.shape[:1]
                              or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool "
                         f"[{x.shape[0]}] tensor, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    n, d, k = _check_inputs(x, c)
    if valid is not None and valid.device != x.device:
        raise ValueError(f"valid must be on {x.device}, not {valid.device}")
    out = torch.empty((k, d + 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.zero_()
    lib = load_library()
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        nb = ctypes.c_int(0)
        err = lib.kmeans_partials_blocks(x.data_ptr(), n, d, k, bf16,
                                         ctypes.byref(nb))
        if err == 0:
            part = torch.empty((nb.value, k * (d + 1)), dtype=torch.float32,
                               device=x.device)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.kmeans_partials_launch(
                x.data_ptr(), c.data_ptr(),
                None if valid is None else valid.data_ptr(),
                part.data_ptr(), out.data_ptr(), n, d, k, nb.value, bf16,
                stream)
    if err != 0:
        raise RuntimeError(f"kmeans_partials kernel launch failed: "
                           f"cudaError_t {err}")
    partials_launches += 1
    return out
