"""Entry points of the bucket kernels: ``bucket_partition``,
``bucket_partition_rows``, ``bucket_dest`` and ``bucket_scatter``.

The port of ``repro.kernels.bucket_partition.ops`` (and of the epilogue in
its ``kernel.py``); the scatter is stacked over an optional leading slot
axis so one call serves a whole shuffle round.  The route follows the
tensors' device: CUDA tensors go through the hand-written kernels
(:func:`.kernel.bucket_partition_ids`, :func:`.kernel.bucket_partition_rows`,
:func:`.kernel.bucket_dest_blocks`) or raise; CPU tensors take the plain versions (:mod:`.ref`); any other
device raises.

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
from repro_torch.kernels.bucket_partition.ref import (
    bucket_blocks_ref, bucket_partition_ref, bucket_partition_rows_ref,
    dest_from_blocks)

# rows per thread block on the card (the TPU kernel's accelerator block)
ACCEL_BLOCK_N = 2048


def bucket_partition(keys: torch.Tensor, bounds, *, n_buckets: int,
                     block_n: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [N] int32, hist [n_buckets] int32)`` for key rows ``keys [N]``
    or ``[N, k]`` (int64 words in ``[0, 2**32)``) against boundary rows
    ``bounds [n_buckets - 1(, k)]``.

    As in the JAX package, ``ids`` are ``#{j : bounds[j] < key}`` and are
    not clamped, and only the first ``n_buckets - 1`` boundary rows take
    part (the TPU kernel's boundary block); fewer rows than that, or
    ``n_buckets < 2``, raise ``ValueError`` (the TPU kernel would read past
    the table).  ``block_n`` is the rows a thread block walks on the card
    (default 2048; at most ``ceil(N / block_n)`` blocks walk the rows); the
    plain version has no blocks.  No rows give empty ids and a zero
    histogram.
    """
    if keys.ndim not in (1, 2):
        raise ValueError(f"keys must be [N] or [N, k], got "
                         f"{tuple(keys.shape)}")
    keys = keys if keys.ndim == 2 else keys[:, None]
    bounds = torch.as_tensor(bounds, device=keys.device).to(torch.int64)
    if bounds.ndim == 1:
        bounds = bounds[:, None]
    if keys.shape[1] != bounds.shape[1]:
        raise ValueError(f"keys have {keys.shape[1]} words per row but "
                         f"bounds have {bounds.shape[1]}")
    if n_buckets < 2 or bounds.shape[0] < n_buckets - 1:
        raise ValueError(f"{n_buckets} buckets need {n_buckets - 1} "
                         f"boundary rows (at least one), got "
                         f"{bounds.shape[0]}")
    keys = keys.to(torch.int64).contiguous()
    bounds = bounds[:n_buckets - 1].contiguous()
    dev = keys.device.type
    if dev == "cuda":
        return _kernel.bucket_partition_ids(
            keys, bounds, n_buckets=n_buckets,
            bn=ACCEL_BLOCK_N if block_n is None else block_n)
    if dev != "cpu":
        raise ValueError(f"bucket_partition runs on cuda or cpu, not {dev}")
    return bucket_partition_ref(keys, bounds, n_buckets)


def bucket_partition_rows(data: torch.Tensor, key_spec, bounds, *,
                          n_buckets: int, block_n: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [N] int32, hist [n_buckets] int32)`` for records ``data [N,
    width]`` uint8 under the static ``key_spec`` — ``("hash", key_bytes)``
    or ``("range", key_len, n_words, length_word)``, the specs of the
    partitioners' ``scatter_spec`` — against boundary word rows ``bounds
    [n_buckets - 1(, k)]``.

    The same ids and histogram as :func:`bucket_partition` over
    ``records.extract_keys(data, key_spec)``, but on the card the kernel
    reads the key bytes out of the records itself: no key rows are built.
    The same boundary rules; ``block_n`` caps the thread blocks on the
    card at ``ceil(N / block_n)`` (default: as many as the card holds at
    once); the plain version has no blocks.
    """
    if data.ndim != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be [N, width] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    k = _kernel.key_layout(key_spec, data.shape[1])[3]
    bounds = torch.as_tensor(bounds, device=data.device).to(torch.int64)
    if bounds.ndim == 1:
        bounds = bounds[:, None]
    if bounds.shape[1] != k:
        raise ValueError(f"the key spec gives {k} words per row but bounds "
                         f"have {bounds.shape[1]}")
    if n_buckets < 2 or bounds.shape[0] < n_buckets - 1:
        raise ValueError(f"{n_buckets} buckets need {n_buckets - 1} "
                         f"boundary rows (at least one), got "
                         f"{bounds.shape[0]}")
    bounds = bounds[:n_buckets - 1].contiguous()
    dev = data.device.type
    if dev == "cuda":
        return _kernel.bucket_partition_rows(
            data.contiguous(), key_spec, bounds, n_buckets=n_buckets,
            bn=block_n)
    if dev != "cpu":
        raise ValueError(f"bucket_partition_rows runs on cuda or cpu, not "
                         f"{dev}")
    return bucket_partition_rows_ref(data, key_spec, bounds, n_buckets)


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
