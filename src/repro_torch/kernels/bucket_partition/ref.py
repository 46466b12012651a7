"""Plain PyTorch version of the bucket_dest kernel, and the shared epilogue.

:func:`bucket_blocks_ref` computes what ``csrc/bucket_dest.cu`` computes
— bucket ids, intra-block stable ranks and per-block histograms — with
ordinary tensor ops: a word-by-word lexicographic compare against every
boundary, and a one-hot running count (cumsum) for the rank.  The
wrappers in :mod:`.ops` use it for tensors on the CPU; on the card it is
the yardstick the kernel is held to.  :func:`dest_from_blocks` is the
epilogue both routes share.
"""
from __future__ import annotations

import torch


def bucket_ids_ref(keys: torch.Tensor, bounds: torch.Tensor,
                   valid: torch.Tensor, n_out: int) -> torch.Tensor:
    """[s, n] int64 bucket ids: ``min(#{j : bounds[j] < key}, n_out - 1)``
    for real rows, the trash bucket ``n_out`` for the rest.

    ``keys [s, n, k]`` and ``bounds [n_bounds, k]`` are int64 words in
    ``[0, 2**32)``; ``valid [s, n]`` is bool."""
    s, n, k = keys.shape
    n_bounds = bounds.shape[0]
    lt = torch.zeros((s, n, n_bounds), dtype=torch.bool, device=keys.device)
    eq = torch.ones_like(lt)
    for w in range(k):
        kw = keys[..., w, None]            # [s, n, 1]
        bw = bounds[:, w]                  # [n_bounds]
        lt |= eq & (bw < kw)
        eq &= bw == kw
    ids = lt.sum(-1).clamp_max(n_out - 1)
    return torch.where(valid, ids, n_out)


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
