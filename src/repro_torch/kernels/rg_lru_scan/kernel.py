"""Build, load and launch the CUDA rg_lru_scan kernel
(``csrc/rg_lru_scan.cu``).

The port's counterpart of the Pallas ``_kernel`` launch in
``repro.kernels.rg_lru_scan.kernel`` (``lru_scan``).  The source is built
by :mod:`repro_torch.kernels._build` (``nvcc`` for ``sm_90a``, cached by
the hash of ``csrc/``) and bound here with ``ctypes``.  At prefill the
kernel streams a and b through a ring in shared memory filled by TMA;
otherwise (decode, odd widths) one thread a channel loads them directly;
the launcher chooses.

``launches`` counts the launches made by :func:`lru_scan` (the
forward), ``backward_launches`` those made by :func:`lru_scan_backward`
(the same kernel on the time-reversed recurrence of the gradient), and
nothing else adds to either, so a run can show that its recurrence and
its gradient went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rg_lru_scan.cu"

launches = 0
backward_launches = 0


def build(build_dir: Optional[Path] = None) -> Path:
    """Build the source (see :func:`_build.build`); returns the library's
    path."""
    return _build.build(SOURCE, build_dir)


def load_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The kernel library, built into ``build_dir`` on first use."""
    return _build.load(SOURCE, "rg_lru_scan_launch",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p], build_dir)


def _run(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Check the inputs and launch the kernel; returns ``(h, h_last,
    launched)``."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{a.device}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.device != a.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {a.device}, got {t.dtype} on {t.device}")
    if a.ndim != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                         a.shape[2]):
        raise ValueError(f"need a, b [B, T, W] and h0 [B, W], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    B, T, W = a.shape
    if B >= 65536 or W >= 2 ** 31 or a.numel() >= 2 ** 62:
        raise ValueError(f"unsupported shape {tuple(a.shape)}")
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if a.numel() == 0:
        return h, h_last.copy_(h0), False
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rg_lru_scan_launch(a.data_ptr(), b.data_ptr(),
                                     h0.data_ptr(), h.data_ptr(),
                                     h_last.data_ptr(), B, T, W, stream)
    if err != 0:
        raise RuntimeError(f"rg_lru_scan kernel launch failed: "
                           f"cudaError_t {err}")
    return h, h_last, True


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Launch the kernel: ``(h [B, T, W], h_last [B, W])`` float32 for
    ``a, b [B, T, W]`` and ``h0 [B, W]``, contiguous float32 tensors on
    one CUDA device."""
    global launches
    h, h_last, launched = _run(a, b, h0)
    launches += launched
    return h, h_last


def lru_scan_backward(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """:func:`lru_scan` for the gradient's recurrence: the caller passes
    the time-reversed coefficients and upstream gradients
    (:func:`.ops.rg_lru_scan_backward`); counted in ``backward_launches``."""
    global backward_launches
    h, h_last, launched = _run(a, b, h0)
    backward_launches += launched
    return h, h_last
