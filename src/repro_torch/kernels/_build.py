"""Build and load the port's CUDA kernels: one helper for every kernel.

Each kernel source ``<kernel>/csrc/<name>.cu`` is compiled on its own by
``nvcc`` for ``sm_90a`` into ``lib<name>.so``, a shared library with a
plain C interface, loaded once with ``ctypes``; the kernel's
``kernel.py`` names its launch function and argument types.  The build
runs at first use and is cached under ``<build dir>/<key>/``, where the
key hashes every file of the source's ``csrc/`` directory (a header
shared by two sources included) and the compiler flags, so an edit to
any of them rebuilds.
The build directory is ``$REPRO_TORCH_BUILD_DIR`` when it is set, else
``build/repro_torch/`` of the checkout the package is imported from.

A missing ``nvcc``, a failed build or a package outside a checkout with
no build directory named raises ``RuntimeError``: there is no fallback to
a kernel's plain version for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
# the checkout holding src/repro_torch, when the package is imported from it
CHECKOUT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# bytes of shared memory one block may use on an H100 (opt-in maximum)
MAX_SHARED = 232448

_libs: Dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``),
    else ``PATH``; raises ``RuntimeError`` when there is none."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cannot build the CUDA kernels: nvcc not found "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def sass(lib: Path) -> str:
    """The SASS of a built library, as ``cuobjdump -sass`` (beside
    ``nvcc``) prints it."""
    tool = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True)
    return proc.stdout


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


def source_key(source: Path) -> str:
    """Hash of every file under the source's directory, by name and
    content, and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    csrc = source.parent
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(csrc)).encode() + b"\0")
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(source: Path, build_dir: Optional[Path] = None) -> Path:
    """Compile ``source`` into ``build_dir/<key>/lib<stem>.so`` (default
    :func:`default_build_dir`) unless it is already there; returns the
    library's path.  ``nvcc``'s report (registers, shared memory, spills)
    is kept beside it in ``<stem>.log``."""
    source = Path(source)
    out_dir = Path(build_dir if build_dir is not None
                   else default_build_dir()) / source_key(source)
    lib = out_dir / f"lib{source.stem}.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, check=False)
    (out_dir / f"{source.stem}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)          # atomic publish when two processes build at once
    return lib


def load(source: Path, fn_name: str, argtypes: list,
         build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The library of ``source``, built into ``build_dir`` and loaded on
    first use, with its launch function ``fn_name`` declared to take
    ``argtypes`` and return a ``cudaError_t`` as an int."""
    if source not in _libs:
        lib = ctypes.CDLL(str(build(source, build_dir)))
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[source] = lib
    return _libs[source]
