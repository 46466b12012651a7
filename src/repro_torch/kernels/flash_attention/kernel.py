"""Build, load and launch the CUDA flash_attention kernel
(``csrc/flash_attention.cu``).

The port's counterpart of the Pallas ``_kernel`` launch in
``repro.kernels.flash_attention.kernel`` (``flash_attention_hm``).  The
source is built by :mod:`repro_torch.kernels._build` (``nvcc`` for
``sm_90a``, cached by the hash of ``csrc/``) and bound here with
``ctypes``.  The kernel reads the model's ``[B, T, H, D]`` layout
directly, so no head-major copy is made.  Bfloat16 tensors take the
tensor-core kernel (its launcher picks the head width and whether tiles
come by TMA or by ``cp.async``); float32 tensors take the SIMT kernel.

``launches`` counts the launches made by :func:`flash_attention_fwd`, and
nothing else adds to it, so a run can show that its attention went
through the kernel.  On ``meta`` tensors it counts where the card would
launch, and launches nothing (the dry run).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, _meta
from repro_torch.kernels.flash_attention.cost import flash_cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256

launches = 0


def build(build_dir: Optional[Path] = None) -> Path:
    """Build the source (see :func:`_build.build`); returns the library's
    path."""
    return _build.build(SOURCE, build_dir)


def load_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The kernel library, built into ``build_dir`` on first use."""
    return _build.load(SOURCE, "flash_attention_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                       build_dir)


def hgmma_count(build_dir: Optional[Path] = None) -> int:
    """How many ``HGMMA`` (wgmma) instructions the built library's SASS
    holds (``cuobjdump -sass``)."""
    return _build.sass(build(build_dir)).count("HGMMA")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int) -> torch.Tensor:
    """Launch the kernel: ``o [B, T, H, D]`` for contiguous ``q [B, T, H,
    D]`` and ``k, v [B, S, K, D]`` of one type (float32 or bfloat16) on
    one CUDA device, with ``H`` a multiple of ``K`` and ``D`` a multiple
    of 4 up to 256.  On ``meta`` tensors (the dry run) nothing is
    launched: ``o`` of the kernel's shape, and the launch's operations
    and bytes (``cost.flash_cost``) recorded in ``kernels._meta``."""
    global launches
    meta = q.device.type == "meta"
    if q.device.type != "cuda" and not meta:
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4 or t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D {q.dtype} "
                             f"tensor on {q.device}, got {t.ndim}-D "
                             f"{t.dtype} on {t.device}")
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, D) or v.shape != k.shape:
        raise ValueError(f"need q [B, T, H, D] and k, v [B, S, K, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if K < 1 or H % K or D % 4 or not 4 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"unsupported heads {H} / kv heads {K} / head dim "
                         f"{D} (H a multiple of K, D a multiple of 4 up to "
                         f"{MAX_HEAD_DIM})")
    if B >= 65536 or H >= 65536 or max(q.numel(), k.numel()) >= 2 ** 62 \
            or window < 0:
        raise ValueError(f"unsupported shape {tuple(q.shape)}, "
                         f"{tuple(k.shape)} or window {window}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if S == 0:
        return o.zero_()
    if meta:
        launches += 1
        _meta.record("flash_attention", *flash_cost(
            q.shape, k.shape, q.element_size(), causal, window))
        return o
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, S,
            H, K, D, int(causal), int(window), 1.0 / math.sqrt(D),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return o
