"""Plain PyTorch versions of the bucket kernels, and the shared epilogue.

:func:`bucket_blocks_ref` computes what ``csrc/bucket_dest.cu`` computes
— bucket ids, intra-block stable ranks and per-block histograms — with
ordinary tensor ops: a word-by-word lexicographic compare against every
boundary, and a one-hot running count (cumsum) for the rank.
:func:`bucket_partition_ref` computes what ``csrc/bucket_partition.cu``
computes — unclamped ids and one histogram — with the same compare, and
:func:`bucket_partition_rows_ref` what its rows entry computes: the key
words extracted from the records by ``core/records.py``, then the same.  The
wrappers in :mod:`.ops` use them for tensors on the CPU; on the card they
are the yardsticks the kernels are held to.  :func:`dest_from_blocks` is
the epilogue both routes of the scatter share.
"""
from __future__ import annotations

import torch


def count_below_ref(keys: torch.Tensor, bounds: torch.Tensor
                    ) -> torch.Tensor:
    """``[...]`` int64 ``#{j : bounds[j] < key}`` for ``keys [..., k]`` and
    ``bounds [n_bounds, k]``, int64 words in ``[0, 2**32)`` compared
    lexicographically — the compare of ``csrc/compare.cuh``."""
    k = keys.shape[-1]
    lt = torch.zeros(keys.shape[:-1] + (bounds.shape[0],), dtype=torch.bool,
                     device=keys.device)
    eq = torch.ones_like(lt)
    for w in range(k):
        kw = keys[..., w, None]            # [..., 1]
        bw = bounds[:, w]                  # [n_bounds]
        lt |= eq & (bw < kw)
        eq &= bw == kw
    return lt.sum(-1)


def bucket_ids_ref(keys: torch.Tensor, bounds: torch.Tensor,
                   valid: torch.Tensor, n_out: int) -> torch.Tensor:
    """[s, n] int64 bucket ids: ``min(#{j : bounds[j] < key}, n_out - 1)``
    for real rows, the trash bucket ``n_out`` for the rest.

    ``keys [s, n, k]`` and ``bounds [n_bounds, k]`` are int64 words in
    ``[0, 2**32)``; ``valid [s, n]`` is bool."""
    ids = count_below_ref(keys, bounds).clamp_max(n_out - 1)
    return torch.where(valid, ids, n_out)


def bucket_partition_ref(keys: torch.Tensor, bounds: torch.Tensor,
                         n_buckets: int):
    """``(ids [n] int32, hist [n_buckets] int32)`` — what
    ``csrc/bucket_partition.cu`` computes: unclamped ids
    ``#{j : bounds[j] < key}`` for ``keys [n, k]``, and their histogram
    with ids of ``n_buckets`` or more counted in no bin."""
    ids = count_below_ref(keys, bounds)
    kept = ids[ids < n_buckets]
    hist = torch.bincount(kept, minlength=n_buckets)
    return ids.to(torch.int32), hist.to(torch.int32)


def bucket_partition_rows_ref(data: torch.Tensor, key_spec,
                              bounds: torch.Tensor, n_buckets: int):
    """``(ids [n] int32, hist [n_buckets] int32)`` — what the rows entry of
    ``csrc/bucket_partition.cu`` computes for records ``data [n, width]``
    uint8 under the static ``key_spec`` (``("hash", key_bytes)`` or
    ``("range", key_len, n_words, length_word)``): the key words of
    ``records.extract_keys``, then :func:`bucket_partition_ref`."""
    # imported here: core.shuffle imports this package, so a module-level
    # import of repro_torch.core would close a cycle
    from repro_torch.core.records import extract_keys
    return bucket_partition_ref(extract_keys(data, key_spec), bounds,
                                n_buckets)


def bucket_blocks_ref(keys: torch.Tensor, bounds: torch.Tensor,
                      valid: torch.Tensor, n_out: int, bn: int):
    """``(ids [s, n] int32, rank [s, n] int32, bhist [s, nb, n_out + 1]
    int32)`` — the kernel's outputs for blocks of ``bn`` rows."""
    ids = bucket_ids_ref(keys, bounds, valid, n_out)
    s, n = ids.shape
    nb = -(-n // bn)
    # rows past n (the ragged last block) take an extra bucket that is
    # dropped from the histogram
    padded = torch.full((s, nb * bn), n_out + 1, dtype=torch.int64,
                        device=ids.device)
    padded[:, :n] = ids
    padded = padded.view(s, nb, bn, 1)
    cols = torch.arange(n_out + 2, device=ids.device)
    csum = (padded == cols).to(torch.int32).cumsum(2, dtype=torch.int32)
    rank = (csum.gather(3, padded) - 1).view(s, nb * bn)[:, :n]
    bhist = csum[:, :, -1, :n_out + 1]
    return ids.to(torch.int32), rank.contiguous(), bhist.contiguous()


def dest_from_blocks(ids: torch.Tensor, rank: torch.Tensor,
                     bhist: torch.Tensor, bn: int):
    """The epilogue: ``(dest [s, n] int64, total [s, n_out + 1] int64)``.

    ``dest[r] = start of bucket ids[r] + count of that bucket in earlier
    blocks + rank[r]`` — a permutation of ``[0, n)`` per slot that puts
    real rows bucket-contiguously, in input order within a bucket, below
    the trash bucket."""
    s, n = ids.shape
    n_cols = bhist.shape[2]
    ids = ids.to(torch.int64)
    bhist = bhist.to(torch.int64)
    total = bhist.sum(1)                                # [s, n_cols]
    starts = total.cumsum(1) - total
    blk_excl = (bhist.cumsum(1) - bhist).reshape(s, -1)  # [s, nb * n_cols]
    block_of = torch.arange(n, device=ids.device) // bn
    before = blk_excl.gather(1, block_of * n_cols + ids)
    return starts.gather(1, ids) + before + rank, total


def bucket_dest_ref(keys: torch.Tensor, bounds: torch.Tensor,
                    valid: torch.Tensor, n_out: int, bn: int):
    """``(dest [s, n], hist [s, n_out])`` by the plain version."""
    ids, rank, bhist = bucket_blocks_ref(keys, bounds, valid, n_out, bn)
    dest, total = dest_from_blocks(ids, rank, bhist, bn)
    return dest, total[:, :n_out]
