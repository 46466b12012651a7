"""Build, load and launch the CUDA bucket_dest kernel (``csrc/bucket_dest.cu``).

The port's counterpart of the Pallas ``_scatter_kernel`` launch in
``repro.kernels.bucket_partition.kernel``.  The source is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and bound with ``ctypes``; the build runs at first use and is cached by
the source's hash under :func:`default_build_dir`: ``$REPRO_TORCH_BUILD_DIR``
when it is set, else ``build/repro_torch/`` of the checkout the package
is imported from.  A missing ``nvcc``, a failed build or a package outside
a checkout with no build directory named raises ``RuntimeError`` — there
is no fallback to the plain version for CUDA tensors.

``launches`` counts the kernel launches made by :func:`bucket_dest_blocks`
(and nothing else), so a run can show that its shuffle went through the
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "bucket_dest.cu"
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
# the checkout holding src/repro_torch, when the package is imported from it
CHECKOUT = Path(__file__).resolve().parents[4]
LIB_NAME = "libbucket_partition.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_COLS = 1024          # n_out + 1 buckets, trash included
MAX_WORDS = 16           # key words per row
MAX_SLOTS = 65535        # grid y
MAX_SHARED = 232448      # bytes of shared memory a block may use (H100)
_WARPS = 8               # kThreads / 32 in the source

launches = 0
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``),
    else ``PATH``; raises ``RuntimeError`` when there is none."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cannot build the bucket_dest CUDA kernel: nvcc "
                           "not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def default_build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` when set, else ``build/repro_torch`` of
    the checkout; raises ``RuntimeError`` for a package installed outside
    a checkout with the variable unset."""
    named = os.environ.get(BUILD_DIR_ENV)
    if named:
        return Path(named)
    if not ((CHECKOUT / "pyproject.toml").is_file()
            and (CHECKOUT / "src" / "repro_torch").is_dir()):
        raise RuntimeError(f"repro_torch is not imported from a checkout: "
                           f"set {BUILD_DIR_ENV} to a directory for its "
                           f"CUDA kernel builds")
    return CHECKOUT / "build" / "repro_torch"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the source into ``build_dir/<source hash>/`` (default
    :func:`default_build_dir`) unless it is already there; returns the
    library's path.  ``nvcc``'s report (registers, shared memory, spills)
    is kept beside it in ``build.log``."""
    src = SOURCE.read_bytes()
    if build_dir is None:
        build_dir = default_build_dir()
    out_dir = Path(build_dir) / hashlib.sha256(src).hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)          # atomic publish when two processes build at once
    return lib


def load_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The built kernel library, compiled into ``build_dir`` (see
    :func:`build`) on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(build_dir)))
        fn = lib.bucket_dest_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, keys on {device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor, got "
                         f"{t.ndim}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bucket_dest_blocks(keys: torch.Tensor, bounds: torch.Tensor,
                       n_valid: Optional[torch.Tensor],
                       mask: Optional[torch.Tensor], *, n_out: int,
                       bn: int):
    """Launch the kernel: ``(ids [s, n] int32, rank [s, n] int32,
    bhist [s, nb, n_out + 1] int32)`` for ``keys [s, n, k]`` int64 and
    ``bounds [n_bounds, k]`` int64 on one CUDA device, with validity from
    exactly one of ``n_valid [s]`` int32 or ``mask [s, n]`` int32."""
    global launches
    if keys.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{keys.device}")
    dev = keys.device
    _check(keys, "keys", torch.int64, 3, dev)
    s, n, k = keys.shape
    _check(bounds, "bounds", torch.int64, 2, dev)
    if bounds.shape[1] != k:
        raise ValueError(f"keys have {k} words per row but bounds have "
                         f"{bounds.shape[1]}")
    if (n_valid is None) == (mask is None):
        raise ValueError("pass exactly one of n_valid and mask")
    if n_valid is not None:
        _check(n_valid, "n_valid", torch.int32, 1, dev)
        if n_valid.shape[0] != s:
            raise ValueError(f"n_valid has {n_valid.shape[0]} slots, "
                             f"keys {s}")
    else:
        _check(mask, "mask", torch.int32, 2, dev)
        if tuple(mask.shape) != (s, n):
            raise ValueError(f"mask shape {tuple(mask.shape)} != {(s, n)}")
    if not 1 <= n_out < MAX_COLS:
        raise ValueError(f"the CUDA kernel takes 1 <= n_out <= "
                         f"{MAX_COLS - 1} buckets, got {n_out}")
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_WORDS} key words, "
                         f"got {k}")
    if s > MAX_SLOTS or n >= 2 ** 31 or bn < 1:
        raise ValueError(f"unsupported shape: {s} slots x {n} rows, "
                         f"block {bn}")
    smem = 4 * (bounds.shape[0] * k + (n_out + 1) * (_WARPS + 1))
    if smem > MAX_SHARED:
        raise ValueError(f"boundary table too large for shared memory "
                         f"({smem} bytes)")
    nb = -(-n // bn)
    ids = torch.empty((s, n), dtype=torch.int32, device=dev)
    rank = torch.empty((s, n), dtype=torch.int32, device=dev)
    bhist = torch.empty((s, nb, n_out + 1), dtype=torch.int32, device=dev)
    if s == 0 or n == 0:
        return ids, rank, bhist
    lib = load_library()
    # the launch runs on the keys' device, which is current only for the
    # call: the caller's current device is restored afterwards
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bucket_dest_launch(
            keys.data_ptr(), bounds.data_ptr(),
            n_valid.data_ptr() if n_valid is not None else None,
            mask.data_ptr() if mask is not None else None,
            ids.data_ptr(), rank.data_ptr(), bhist.data_ptr(),
            s, n, k, bounds.shape[0], n_out, bn, stream)
    if err != 0:
        raise RuntimeError(f"bucket_dest kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return ids, rank, bhist
