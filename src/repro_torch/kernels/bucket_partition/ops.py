"""Entry points of the bucket scatter: ``bucket_dest`` and ``bucket_scatter``.

The port of ``repro.kernels.bucket_partition.ops`` (and of the epilogue in
its ``kernel.py``), stacked over an optional leading slot axis so one
call serves a whole shuffle round.  The route follows the tensors'
device: CUDA tensors go through the hand-written kernel
(:func:`.kernel.bucket_dest_blocks`) or raise; CPU tensors take the plain
version (:mod:`.ref`); any other device raises.

**Contract** (as in the JAX package).  Keys and boundaries are rows of
``k`` big-endian 32-bit words, carried as int64, compared
lexicographically; a row's bucket is ``#{j : bounds[j] < key}`` clamped
to ``n_buckets - 1``.  Rows that are not real — past a scalar/per-slot
``n_valid``, or zero in a validity mask — go to a trash bucket after
every real bucket.  Within a bucket rows keep their input order, so the
first ``hist.sum()`` rows of the scatter are the real records,
bucket-contiguous and stable.  ``dest`` depends only on this contract,
never on the block size.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.bucket_partition import kernel as _kernel
from repro_torch.kernels.bucket_partition.ref import (bucket_blocks_ref,
                                                      dest_from_blocks)

# rows per thread block on the card (the TPU kernel's accelerator block)
ACCEL_BLOCK_N = 2048


def _stacked_inputs(keys, bounds, n_valid):
    """Normalise to ``keys [s, n, k]`` int64, ``bounds [n_bounds, k]``
    int64 on the keys' device, and exactly one of ``counts [s]`` /
    ``mask [s, n]`` int32.  Returns them plus whether the input was
    stacked."""
    if keys.ndim not in (2, 3):
        raise ValueError(f"keys must be [n, k] or [s, n, k], got "
                         f"{tuple(keys.shape)}")
    stacked = keys.ndim == 3
    keys3 = (keys if stacked else keys[None]).to(torch.int64).contiguous()
    s, n, k = keys3.shape
    bounds = torch.as_tensor(bounds, device=keys.device).to(torch.int64)
    if bounds.ndim == 1:
        bounds = bounds[:, None]
    if bounds.shape[1] != k:
        raise ValueError(f"keys have {k} words per row but bounds have "
                         f"{bounds.shape[1]}")
    nv = torch.as_tensor(n_valid, device=keys.device)
    if nv.ndim == (1 if stacked else 0):         # row counts
        counts, mask = nv.reshape(s).to(torch.int32).contiguous(), None
    elif tuple(nv.shape) == ((s, n) if stacked else (n,)):
        counts, mask = None, nv.reshape(s, n).to(torch.int32).contiguous()
    else:
        raise ValueError(f"n_valid of shape {tuple(nv.shape)} is neither a "
                         f"row count nor a validity mask for keys "
                         f"{tuple(keys.shape)}")
    return keys3, bounds.contiguous(), counts, mask, stacked


def _blocks(keys3, bounds, counts, mask, n_out: int, bn: int):
    """(ids, rank, bhist) by the device's route."""
    dev = keys3.device.type
    if dev == "cuda":
        return _kernel.bucket_dest_blocks(keys3, bounds, counts, mask,
                                          n_out=n_out, bn=bn)
    if dev != "cpu":
        raise ValueError(f"bucket_dest runs on cuda or cpu, not {dev}")
    if mask is not None:
        valid = mask != 0
    else:
        rows = torch.arange(keys3.shape[1], device=keys3.device)
        valid = rows < counts[:, None]
    return bucket_blocks_ref(keys3, bounds, valid, n_out, bn)


def bucket_dest(keys: torch.Tensor, bounds, n_valid, *, n_buckets: int,
                block_n: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destinations of the stable counting scatter, without moving data.

    ``keys``: ``[n, k]`` or stacked ``[s, n, k]`` int64 words;
    ``bounds``: ``[n_bounds(, k)]`` boundary words; ``n_valid``: a row
    count (scalar, or ``[s]`` when stacked) or a validity mask of the
    keys' leading shape.  Returns ``(dest, hist)`` of shapes ``[(s,) n]``
    and ``[(s,) n_buckets]``: ``dest`` is a permutation of ``[0, n)``
    per slot.  ``block_n`` defaults to 2048 rows on the card and to the
    whole batch on the CPU.
    """
    keys3, bounds, counts, mask, stacked = _stacked_inputs(keys, bounds,
                                                           n_valid)
    if block_n is None:
        block_n = (ACCEL_BLOCK_N if keys3.device.type == "cuda"
                   else max(keys3.shape[1], 1))
    ids, rank, bhist = _blocks(keys3, bounds, counts, mask, n_buckets,
                               block_n)
    dest, total = dest_from_blocks(ids, rank, bhist, block_n)
    hist = total[:, :n_buckets]
    return (dest, hist) if stacked else (dest[0], hist[0])


def _row_view(data: torch.Tensor) -> torch.Tensor:
    """``data [m, width]`` uint8 rows as int32 words where the layout
    allows — the row move then copies 4-byte elements, not bytes."""
    if (data.shape[1] % 4 == 0 and data.is_contiguous()
            and data.storage_offset() % 4 == 0):
        return data.view(torch.int32)
    return data


def bucket_scatter(data: torch.Tensor, keys: torch.Tensor, bounds, n_valid,
                   *, n_buckets: int, block_n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable scatter of ``data [(s,) n, width]`` uint8 records into
    bucket-contiguous order: ``(out, hist)`` where ``out[(i,) :hist.sum()]``
    holds the real records, bucket ``b`` in rows
    ``[sum(hist[:b]), sum(hist[:b + 1]))``, input order within a bucket.
    The move inverts the destination permutation and gathers the rows.
    """
    dest, hist = bucket_dest(keys, bounds, n_valid, n_buckets=n_buckets,
                             block_n=block_n)
    stacked = data.ndim == 3
    data3 = data if stacked else data[None]
    s, n, width = data3.shape
    if tuple(dest.reshape(-1, n).shape) != (s, n):
        raise ValueError(f"data has shape {tuple(data.shape)} but keys "
                         f"have {tuple(keys.shape)}")
    offsets = torch.arange(s, device=dest.device)[:, None] * n
    flat = (dest.reshape(s, n) + offsets).reshape(-1)
    perm = torch.empty_like(flat)
    perm[flat] = torch.arange(flat.numel(), device=flat.device)
    rows = _row_view(data3.reshape(s * n, width).contiguous())
    out = rows.index_select(0, perm).view(torch.uint8).reshape(s, n, width)
    return (out, hist) if stacked else (out[0], hist)
