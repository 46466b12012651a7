"""Build, load and launch the CUDA bucket kernels (``csrc/*.cu``).

The port's counterparts of the two Pallas launches in
``repro.kernels.bucket_partition.kernel``: ``bucket_dest.cu`` for
``_scatter_kernel`` (the shuffle's stable counting scatter) and
``bucket_partition.cu`` for ``_kernel`` (the ids-visible partition pass),
with two entries: one over int64 key words, the TPU kernel's contract
(:func:`bucket_partition_ids`), and one that reads the key bytes straight
out of the records (:func:`bucket_partition_rows`).  Both sources include
the compare of ``csrc/compare.cuh``.  Each source is built
by :mod:`repro_torch.kernels._build` (``nvcc`` for ``sm_90a``, cached by
the hash of ``csrc/``) into a library of its own, bound here with
``ctypes``.

``launches`` counts the launches made by :func:`bucket_dest_blocks`,
``partition_launches`` those made by :func:`bucket_partition_ids` and
``rows_launches`` those made by :func:`bucket_partition_rows`; nothing
else adds to them, so a run can show which path went through which
kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "bucket_dest.cu"
PARTITION_SOURCE = CSRC / "bucket_partition.cu"

MAX_COLS = 1024          # n_out + 1 buckets, trash included
MAX_WORDS = 16           # key words per row
MAX_SLOTS = 65535        # grid y
MAX_SHARED = _build.MAX_SHARED
_WARPS = 8               # kThreads / 32 in bucket_dest.cu

launches = 0
partition_launches = 0
rows_launches = 0


def build(build_dir: Optional[Path] = None) -> Path:
    """Build ``bucket_dest.cu`` (see :func:`_build.build`); returns the
    library's path."""
    return _build.build(SOURCE, build_dir)


def build_partition(build_dir: Optional[Path] = None) -> Path:
    """Build ``bucket_partition.cu``; returns the library's path."""
    return _build.build(PARTITION_SOURCE, build_dir)


def load_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The bucket_dest library, built into ``build_dir`` on first use."""
    return _build.load(SOURCE, "bucket_dest_launch",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p], build_dir)


def load_partition_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The bucket_partition library (both entries), built into
    ``build_dir`` on first use."""
    lib = _build.load(PARTITION_SOURCE, "bucket_partition_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p], build_dir)
    rows = lib.bucket_partition_rows_launch
    if rows.argtypes is None:
        rows.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                         + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
        rows.restype = ctypes.c_int
    return lib


def key_layout(key_spec, width: int):
    """``(hash, kb, nkw, k, length word)`` of a static key spec over
    records of ``width`` bytes, as ``records.key_rows_of`` /
    ``hash_keys_of`` lay the key out: ``("hash", key_bytes)`` is one FNV-1a
    word over ``kb = min(key_bytes, width)`` bytes; ``("range", key_len,
    n_words, length_word)`` is ``nkw`` big-endian words over the first
    ``kb = min(key_len, width)`` bytes, zero-padded, then the length word
    when it is not None (``k = nkw + 1``)."""
    if key_spec[0] == "hash":
        return 1, min(key_spec[1], width), 1, 1, 0
    if key_spec[0] != "range":
        raise ValueError(f"unknown key spec {key_spec!r}")
    _, key_len, n_words, length_word = key_spec
    kb = min(key_len, width)
    nkw = max(-(-kb // 4), n_words or 0, 1)
    if length_word is None:
        return 0, kb, nkw, nkw, 0
    return 0, kb, nkw, nkw + 1, length_word


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


def _partition_checks(n: int, k: int, bounds: torch.Tensor, n_buckets: int,
                      bn: Optional[int]) -> None:
    if bounds.shape[1] != k:
        raise ValueError(f"keys have {k} words per row but bounds have "
                         f"{bounds.shape[1]}")
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_WORDS} key words, "
                         f"got {k}")
    if n_buckets < 1 or n >= 2 ** 31 or (bn is not None and bn < 1):
        raise ValueError(f"unsupported shape: {n} rows, {n_buckets} "
                         f"buckets, block {bn}")
    smem = 4 * (bounds.shape[0] * k + n_buckets)
    if smem > MAX_SHARED:
        raise ValueError(f"boundary table and histogram too large for "
                         f"shared memory ({smem} bytes)")


def bucket_partition_ids(keys: torch.Tensor, bounds: torch.Tensor, *,
                         n_buckets: int, bn: int):
    """Launch the partition kernel's words entry: ``(ids [n] int32, hist
    [n_buckets] int32)`` for ``keys [n, k]`` and ``bounds [n_bounds, k]``
    int64 words on one CUDA device.  ``ids`` are not clamped; ``hist``
    counts only the ids below ``n_buckets``.  At most ``ceil(n / bn)``
    thread blocks walk the rows."""
    global partition_launches
    if keys.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{keys.device}")
    dev = keys.device
    _check(keys, "keys", torch.int64, 2, dev)
    n, k = keys.shape
    _check(bounds, "bounds", torch.int64, 2, dev)
    _partition_checks(n, k, bounds, n_buckets, bn)
    ids = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return ids, torch.zeros((n_buckets,), dtype=torch.int32, device=dev)
    hist = torch.empty((n_buckets,), dtype=torch.int32, device=dev)
    lib = load_partition_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bucket_partition_launch(
            keys.data_ptr(), bounds.data_ptr(), ids.data_ptr(),
            hist.data_ptr(), n, k, bounds.shape[0], n_buckets, -(-n // bn),
            stream)
    if err != 0:
        raise RuntimeError(f"bucket_partition kernel launch failed: "
                           f"cudaError_t {err}")
    partition_launches += 1
    return ids, hist


def bucket_partition_rows(data: torch.Tensor, key_spec, bounds: torch.Tensor,
                          *, n_buckets: int, bn: Optional[int] = None):
    """Launch the partition kernel's rows entry: ``(ids [n] int32, hist
    [n_buckets] int32)`` for records ``data [n, width]`` uint8 (contiguous,
    at any storage offset) under a static ``key_spec`` (see
    :func:`key_layout`) and ``bounds [n_bounds, k]`` int64 words on one
    CUDA device.  The key words are built from the record bytes inside the
    kernel.  ``ids`` and ``hist`` as :func:`bucket_partition_ids`; at most
    ``ceil(n / bn)`` thread blocks walk the rows when ``bn`` is given,
    else as many as the card holds at once."""
    global rows_launches
    if data.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{data.device}")
    dev = data.device
    _check(data, "data", torch.uint8, 2, dev)
    n, width = data.shape
    _check(bounds, "bounds", torch.int64, 2, dev)
    hash_, kb, nkw, k, length_word = key_layout(key_spec, width)
    if width >= 2 ** 31 or not 0 <= length_word < 2 ** 31:
        raise ValueError(f"unsupported record width {width} or length "
                         f"word {length_word}")
    _partition_checks(n, k, bounds, n_buckets, bn)
    ids = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return ids, torch.zeros((n_buckets,), dtype=torch.int32, device=dev)
    hist = torch.empty((n_buckets,), dtype=torch.int32, device=dev)
    lib = load_partition_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bucket_partition_rows_launch(
            data.data_ptr(), width, hash_, kb, nkw, k, length_word,
            bounds.data_ptr(), ids.data_ptr(), hist.data_ptr(), n,
            bounds.shape[0], n_buckets, 0 if bn is None else -(-n // bn),
            stream)
    if err != 0:
        raise RuntimeError(f"bucket_partition_rows kernel launch failed: "
                           f"cudaError_t {err}")
    rows_launches += 1
    return ids, hist
