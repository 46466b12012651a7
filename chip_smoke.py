#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--records N] [--points P] [--seed S]

Every phase must pass; any failure exits non-zero and nothing is caught
and passed over.

1. **Set-up.**  Prints the card's name and power limit as ``nvidia-smi``
   reports them, then builds every CUDA kernel from the sources in this
   checkout in one fresh build (one ``nvcc`` per source, all started
   together) and prints the build seconds and ``ptxas``'s register report
   of each.  The ``flash_attention`` library's SASS (``cuobjdump -sass``)
   must hold ``HGMMA`` (wgmma, Hopper's tensor-core product); the count is
   printed.
2. **Kernels.**  Holds each kernel against its plain PyTorch version on
   the card, and times both at the shape its path gives it (CUDA events
   around one call queued behind a device sleep, so the host's enqueue
   time is not counted; median of 20 after 3 warm-ups) beside the least
   time the card could take:
   - ``bucket_dest`` (and the ``bucket_dest`` / ``bucket_scatter`` entry
     points on it), exact, at the TeraSort stack ``[16, 655360]``, k=3,
     6 buckets;
   - ``bucket_partition``'s two entries, exact ids and histogram: the
     words entry at ``[10000000, 3]`` int64 words, 6 buckets; the rows
     entry, which reads the keys out of the records, over every key layout
     (range keys of 1-5 words with and without the length word, a key
     longer than the record, hash keys of 4, 8 and 10 bytes), widths 100,
     13 and 7, a storage offset that is not 4-aligned, N = 0, 1 and a
     ragged N, and timed at 10,000,000 records of 100 bytes (10-byte keys,
     k = 3, 6 buckets) beside the bound, the floors of the 32-byte sectors
     and 64-byte memory atoms its keys touch, and the route it replaced
     (the key rows built by plain torch, then the words entry);
   - ``kmeans_assign``, ids exact where the plain version's best-to-second
     gap exceeds ``1e-5 * (|x|^2 + |c|^2)`` and d2 within
     ``1e-5 * (|x|^2 + |c|^2) + 1e-6``, at ``[2097152, 8]``, K=10.  The
     plain version runs in full float32: TF32 is switched off for matrix
     products (``torch.backends.cuda.matmul.allow_tf32 = False``,
     ``torch.set_float32_matmul_precision("highest")``);
   - ``kmeans_partials``, the same source's fused entry (per-centroid sums
     and counts of one pass, every route: small and wide tables, vector
     and element loads, the shared-memory limit; float32 and bf16; masked
     and not): the same bits from two launches, counts exactly the masked
     ``bincount`` of ``kmeans_assign``'s ids and sums within
     ``1e-5 * sum |x| + 1e-6`` of float64 one-hot sums over them, and over
     the points whose id is decided, counts equal to the plain version's
     and sums within the same bound; at ``[2097152, 8]``, K=10, a full
     mask.
3. **TeraSort** through the port's ``SphereEngine`` on CUDA: ``--records``
   100-byte records (default 10,000,000, 1.0 GB) with random 10-byte keys
   and payload from ``--seed``, uploaded to Sector in record-aligned 64 MB
   chunks (640,000 records), replication 3, one chunk server per Teraflow
   site; 6 buckets from ``sample_boundaries``.  The outputs, concatenated
   in worker order, must be byte-identical to a numpy oracle (a stable
   lexsort of the keys, which must have no ties); ``bucket_dest`` must
   launch exactly once per shuffle round, with one host sync per round.
4. **partition_batch** on the TeraSort data on the card, through the range
   partitioner of the same boundaries: ids must equal a numpy oracle of
   ``#{bounds < key}``, the histogram the per-bucket record counts of the
   TeraSort outputs, and ``shuffle_batch``'s pieces, each sorted by key
   and concatenated, the oracle order; the rows entry of
   ``bucket_partition`` must launch exactly once per call and the words
   entry never.  One more ``partition_batch`` and the words route it
   replaced run under ``torch.profiler`` (device busy time and idle
   share), and ``shuffle_batch``'s host steps are timed one by one.
5. **k-means**, the paper's Table 2 workload (§5.3) at its largest scale:
   ``--points`` float32 points (default 100,000,000), D=8, K=10, 5
   iterations, a mixture of K Gaussian clusters from ``--seed``, uploaded
   to Sector in the default 64 MiB chunks (2,097,152 points each),
   replication 2, one chunk server per Teraflow site, and run by
   ``kmeans_sphere`` through one session.  The centroids must match a
   float64 numpy Lloyd oracle (same seeded init, same keep-empty rule)
   within ``rtol = atol = 1e-3``; ``udf_traces`` must be one per stage,
   ``kmeans_partials`` must launch once per assign task and iteration and
   the ids entry never.  One more iteration runs under
   ``torch.profiler``.

6. **LM kernels.**  ``recurrentgemma-2b`` at its full config (26 layers,
   ``d_model`` 2560, vocab 256,000, bf16) with parameters from ``--seed``
   on the card; one prefill of the 3,072-token prompt captures the q / k /
   v of its first local-attention layer and the a / b / h0 of its first
   RG-LRU layer.  Each kernel is held against its plain version on those
   activations and on a sweep of small cases, and timed as in phase 2
   beside its bound and, for attention, beside
   ``torch.nn.functional.scaled_dot_product_attention`` (timed only as a
   yardstick):
   - ``flash_attention`` (bf16: wgmma with TMA loads; float32: the SIMT
     kernel), local: q ``[1, 3072, 10, 256]``, k / v ``[1, 3072, 1,
     256]``, bf16, causal, window 2048; global (Qwen2.5-3B's shape): q
     ``[1, 3072, 16, 128]``, k / v ``[1, 3072, 2, 128]``, causal; within
     2e-5 in float32 and 2e-2 in bf16 (the bf16 kernel rounds p to bf16
     before the product with V, the plain version keeps it in float32),
     and in bf16 also within what rounding p allows, plus 1e-4, of
     ``attention_rounded_p``, which rounds p as the kernel does (see
     ``rounded_p_excess``); TFLOP/s of the live pairs and the ratio to the
     library's time at both shapes;
   - ``rg_lru_scan`` (at prefill a ring in shared memory per warp of 32
     channels filled by TMA; at decode one thread a channel), exact,
     at prefill ``[1, 3072, 2560]`` and decode ``[4, 1, 2560]``, and at
     the ring's stage edges; TB/s and the ratio to the bound at both.
7. **Serving** through the port's ``ServeEngine`` (``max_batch=4``,
   ``max_len=4096``, greedy): 8 requests of 32 new tokens, prompts of
   3,072 and 2,500 tokens (longer than the window) and six lengths drawn
   from ``--seed`` in 16-512.  Every request must finish with 32
   in-vocabulary tokens and every slot be recycled; ``flash_attention``
   must launch exactly 8 times a prefill and ``rg_lru_scan`` 18 times a
   prefill and a decode step; the two long prompts' last prefill logits
   must match a reference prefill on the card in which both kernels are
   swapped for their plain versions (inside this script only) within
   ``5e-2`` of the reference logits' largest magnitude.  Prints time to
   first token, prefill and steady decode tokens/s, peak device memory,
   one decode step under ``torch.profiler`` (device busy time and idle
   share), and one prefill of the 3,072-token prompt under
   ``torch.profiler`` (device time by kernel: where the time to first
   token goes).
8. **Training** the full ``recurrentgemma-2b`` through the port's
   ``Trainer`` (fresh parameters from ``--seed``: the serving tensors
   were made for inference; fp32 AdamW state on the card), with full
   remat and the fused head (chunks of 512 tokens), at batch 2 x 3,072
   tokens (past the 2,048 window), on a synthetic corpus from ``--seed``
   of exactly one batch written to Sector, so the ``SectorTokenDataset``
   / ``DataPipeline`` feed that batch every step.  Checks: (a) one
   step's loss and every gradient leaf by the kernel route against the
   same step under ``plain_kernels()`` (loss within 1e-2; each leaf a
   relative error of at most 0.1 and a cosine of at least 0.99); (b) the
   scan's time-reversed backward through the kernel against autograd
   through the plain loop on the captured first RG-LRU layer ``[1, 3072,
   2560]``, within 1e-5 of the gradients' scale, both timed; (c) over 4
   steps at the JAX package's default learning rate and warm-up the loss
   falls and stays finite; (d) a Sector checkpoint round trip at
   ``cfg.reduced()`` on the card: saved at step 2, restored into a new
   ``Trainer`` bit for bit, its step-3 loss within 1e-3 of an
   uninterrupted run's; (e) the launches of the 4 steps exactly: under
   full remat 16 ``flash_attention`` a step (8 local layers, forward and
   recompute), 36 ``rg_lru_scan`` forward (18 R layers twice) and 18
   backward (``kernel.backward_launches``).  Prints each step's loss,
   grad norm, seconds (host clock, synchronised) and tokens/s, the peak
   device memory, the plain flash backward's time a step, one more step
   under ``torch.profiler`` (device busy, idle share, device time by
   class of kernel, by launching op and by kernel), and the AdamW
   update's device time (CUDA events, one more step).

The line before the last is one JSON object describing every kernel; the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the rest of the repository beside this
script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RECORD, KEY = 100, 10
CHUNK_RECORDS = 640_000                 # 64,000,000-byte chunks
N_BUCKETS = 6
MAIN_SLOTS, MAIN_ROWS = 16, 655_360     # the stage-0 stack at 10M records
PART_ROWS = 10_000_000                  # partition_batch over 10M records
DIM, K, ITERS = 8, 10, 5                # benchmarks/table2_kmeans.py
ASSIGN_ROWS = 2_097_152                 # points in one 64 MiB chunk
# H100 SXM data-sheet peaks (NVIDIA): HBM bandwidth, and the 32-bit
# non-tensor rate used as the ceiling for integer compares and float32
# FMAs
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_PER_S = 989e12                # dense bf16 tensor-core rate
SLEEP_CYCLES = 2_000_000                # ~1 ms of device sleep before a timed call
PKG = "src/repro_torch/kernels"
KERNELS = {
    "bucket_dest": (f"{PKG}/bucket_partition/csrc/bucket_dest.cu",
                    "src/repro/kernels/bucket_partition/kernel.py:138"),
    "bucket_partition": (f"{PKG}/bucket_partition/csrc/bucket_partition.cu",
                         "src/repro/kernels/bucket_partition/kernel.py:70"),
    # the same source's rows entry: the TPU kernel and the key extraction
    # XLA fuses in front of it (src/repro/core/shuffle.py _extract_keys)
    "bucket_partition_rows": (
        f"{PKG}/bucket_partition/csrc/bucket_partition.cu",
        "src/repro/kernels/bucket_partition/kernel.py:70"),
    "kmeans_assign": (f"{PKG}/kmeans_assign/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kernel.py:19"),
    # the same source's fused entry: the TPU kernel and the one-hot
    # partials around it (src/repro/kernels/kmeans_assign/ops.py)
    "kmeans_partials": (f"{PKG}/kmeans_assign/csrc/kmeans_assign.cu",
                        "src/repro/kernels/kmeans_assign/kernel.py:19"),
    "flash_attention": (f"{PKG}/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:29"),
    "rg_lru_scan": (f"{PKG}/rg_lru_scan/csrc/rg_lru_scan.cu",
                    "src/repro/kernels/rg_lru_scan/kernel.py:23"),
    # the same kernel on the gradient's time-reversed recurrence (the
    # JAX package differentiates an associative scan; the Pallas kernel
    # has no gradient)
    "rg_lru_scan_backward": (f"{PKG}/rg_lru_scan/csrc/rg_lru_scan.cu",
                             "src/repro/kernels/rg_lru_scan/kernel.py:23"),
}
LM_ARCH = "recurrentgemma-2b"
LONG_PROMPTS = (3072, 2500)             # longer than the 2,048 window
N_REQUESTS, MAX_NEW, SERVE_SLOTS, SERVE_LEN = 8, 32, 4, 4096
LOGIT_TOL = 5e-2                        # of the reference's largest |logit|
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 3072, 4
HEAD_CHUNK = 512
# (a): the kernel route against plain_kernels() on one batch.  Only the
# attention forward differs (the bf16 kernel rounds p to bf16, the plain
# version keeps it in float32), in 8 of 26 layers: the loss within 1e-2
# (the bf16 logits round by 2**-9 of themselves; a loss near 12.5 moves
# by up to about 0.02 at worst), and each gradient leaf within a relative
# (Frobenius) error of 0.1 and a cosine of at least 0.99
TRAIN_LOSS_TOL, GRAD_REL_TOL, GRAD_COS_MIN = 1e-2, 0.1, 0.99
# (b): the scan's backward against autograd through the plain loop, of
# the gradients' largest magnitude (the same multiplies and adds; autograd
# adds a step's two contributions in its own order)
SCAN_GRAD_TOL = 1e-5
RESUME_LOSS_TOL = 1e-3                  # (d): the resumed step-3 loss


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, warmup: int = 3, runs: int = 20) -> float:
    """Median device time of ``fn()`` in milliseconds: CUDA events around
    one call, queued behind a device sleep so that the host's time to
    enqueue the call is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int, ops_per_s: float = PEAK_OPS_PER_S):
    """(least time in ms, what bounds it) for moving ``n_bytes`` through
    device memory and doing ``n_ops`` operations at ``ops_per_s`` (default
    the 32-bit rate)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(name, worst, ms, plain, bound, by, library=None):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": library}


def spans_line(tracer) -> str:
    """Wall seconds per span name.  Device work is asynchronous, so it
    lands in the span that waits for it."""
    totals: dict = {}
    for sp in tracer.snapshot():
        if sp.kind == "span" and sp.clock == "wall":
            totals[sp.name] = totals.get(sp.name, 0.0) + sp.wall_seconds
    return " ".join(f"{name}={sec:.4f}" for name, sec in sorted(totals.items()))


def cloud(tmp: Path, chunk_size=None):
    """A Sector master with one chunk server per Teraflow site."""
    from repro_torch.sector import ChunkServer, SectorClient, SectorMaster
    master = (SectorMaster() if chunk_size is None
              else SectorMaster(chunk_size=chunk_size))
    for i, site in enumerate(master.topology.sites):
        master.register(ChunkServer(f"s{i}", site, tmp))
    master.acl.add_member("u")
    master.acl.grant_write("u")
    return master, SectorClient(master, "u", "chicago")


# ------------------------------------------------------------ phase 1
def build_all(build_dir: Path) -> None:
    """One fresh build of every kernel source, one nvcc each, in parallel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_partition import kernel as bkernel
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.kmeans_assign import kernel as kkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    shutil.rmtree(build_dir, ignore_errors=True)

    def one(src):
        t = time.perf_counter()
        lib = _build.build(ROOT / src, build_dir)
        return lib, time.perf_counter() - t

    sources = sorted({src for src, _ in KERNELS.values()})
    t = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(one, sources)))
    print(f"build: {len(built)} sources ({len(KERNELS)} kernels) in "
          f"{time.perf_counter() - t:.2f}s")
    for src, (lib, sec) in built.items():
        print(f"build: {src}: {lib.relative_to(ROOT)} in {sec:.2f}s")
        print((lib.parent / f"{Path(src).stem}.log").read_text().strip())
    n_hgmma = fkernel.hgmma_count(build_dir)
    print(f"build: flash_attention SASS holds {n_hgmma} HGMMA instructions")
    check(n_hgmma > 0, "the flash_attention library has no HGMMA (wgmma) "
                       "instruction")
    bkernel.load_library(build_dir)
    bkernel.load_partition_library(build_dir)
    kkernel.load_library(build_dir)
    fkernel.load_library(build_dir)
    lkernel.load_library(build_dir)


# ------------------------------------------------------------ phase 2
def dest_phase(torch):
    from repro_torch.convert import bounds_from_numpy
    from repro_torch.core import shuffle
    from repro_torch.core.records import extract_keys
    from repro_torch.kernels.bucket_partition import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    worst = 0

    def compare(keys, bounds, counts, mask, n_out, bn, data=None):
        nonlocal worst
        valid = (mask != 0 if mask is not None else
                 torch.arange(keys.shape[1], device=dev) < counts[:, None])
        got = kernel.bucket_dest_blocks(keys, bounds, counts, mask,
                                        n_out=n_out, bn=bn)
        want = ref.bucket_blocks_ref(keys, bounds, valid, n_out, bn)
        for name, g, w in zip(("ids", "rank", "bhist"), got, want):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            worst = max(worst, err)
            check(err == 0, f"bucket_dest {name} differs from the plain "
                            f"version (n_out={n_out}, bn={bn}, max err {err})")
        nv = mask if mask is not None else counts
        dest, hist = ops.bucket_dest(keys, bounds, nv, n_buckets=n_out,
                                     block_n=bn)
        r_dest, r_hist = ref.bucket_dest_ref(keys, bounds, valid, n_out, bn)
        check(torch.equal(dest, r_dest) and torch.equal(hist, r_hist),
              f"bucket_dest differs from the plain version (n_out={n_out})")
        if data is not None:
            out, _ = ops.bucket_scatter(data, keys, bounds, nv,
                                        n_buckets=n_out, block_n=bn)
            want_out = torch.empty_like(data)
            s = data.shape[0]
            want_out[torch.arange(s, device=dev)[:, None], r_dest] = data
            check(torch.equal(out, want_out),
                  f"bucket_scatter bytes differ (n_out={n_out})")

    def rand_case(s, n, k, n_bounds, high):
        keys = torch.randint(0, high, (s, n, k), generator=gen,
                             dtype=torch.int64)
        rows = torch.randint(0, high, (n_bounds, k), generator=gen,
                             dtype=torch.int64)
        counts = torch.randint(0, n + 1, (s,), generator=gen,
                               dtype=torch.int32)
        mask = (torch.rand((s, n), generator=gen) < 0.7).to(torch.int32)
        data = torch.randint(0, 256, (s, n, 8), generator=gen,
                             dtype=torch.uint8)
        return [t.to(dev) for t in (keys, rows, counts, mask, data)]

    n_cases = 0
    # low-entropy words: boundary-equal keys, multi-word ties, duplicates
    for k in (1, 3, 4):
        for n_out in (2, 6, 16, 64):
            for bn in (7, 32, 101, 2048):
                keys, bounds, counts, mask, data = rand_case(3, 1000, k,
                                                             n_out - 1, 4)
                compare(keys, bounds, counts, None, n_out, bn, data)
                compare(keys, bounds, None, mask, n_out, bn, data)
                n_cases += 2
    # the n_out clamp: more boundaries than buckets
    keys, bounds, counts, mask, data = rand_case(2, 900, 3, 9, 4)
    for n_out in (1, 3):
        compare(keys, bounds, counts, None, n_out, 32, data)
        n_cases += 1
    # a wide bucket table
    keys, bounds, counts, mask, data = rand_case(2, 3000, 3, 999, 3)
    compare(keys, bounds, counts, None, 1000, 257, data)
    n_cases += 1
    # variable-length boundaries and zero-tail ties through the shuffle's
    # own key extraction (the trailing length word), against bytes order
    bnd = [b"\x10\x20", b"\x10\x20\x00", b"\x10\x20\x00\x00\x00\x01",
           b"\x40" * 10, b"\x80" * 9 + b"\x00"]
    part = shuffle.range_partitioner(bnd)
    prefixes = [b"\x00\x00", b"\x10\x1f", b"\x10\x20", b"\x10\x21",
                b"\x10\x20\x00\x00\x00\x00", b"\x10\x20\x00\x00\x00\x01",
                b"\x40" * 10, b"\x40" * 9 + b"\x41", b"\x80" * 9 + b"\x00",
                b"\x80" * 9 + b"\x01", b"\xff" * 10]
    records = [(p + bytes(12))[:12] for p in prefixes for _ in range(37)]
    batch = shuffle.RecordBatch.from_records(records, device=dev)
    pieces = shuffle.scatter_batch(batch, part, 6, pad_block=64)
    want = [[r for r in records if part(r, 6) == b] for b in range(6)]
    check([p.to_bytes() for p in pieces] == [b"".join(w) for w in want],
          "variable-length boundary scatter differs from bytes order")
    n_cases += 1

    # 64 buckets on random record keys
    dgen = torch.Generator(device=dev).manual_seed(4321)
    data = torch.randint(0, 256, (MAIN_SLOTS, 65_536, RECORD), generator=dgen,
                         dtype=torch.uint8, device=dev)
    spec, bwords = shuffle.range_partitioner(sorted(
        bytes(r) for r in np.random.default_rng(5).integers(
            0, 256, (63, KEY), dtype=np.uint8))).scatter_spec(
        shuffle.RecordBatch.empty(RECORD, dev), 64)
    keys = extract_keys(data, spec).contiguous()
    bounds = bounds_from_numpy(bwords).to(dev)
    counts = torch.full((MAIN_SLOTS,), 60_000, dtype=torch.int32, device=dev)
    compare(keys, bounds, counts, None, 64, ops.ACCEL_BLOCK_N, data)
    n_cases += 1

    # the main path's shape: 16 slots x 655,360 rows, k=3, 6 buckets
    data = torch.randint(0, 256, (MAIN_SLOTS, MAIN_ROWS, RECORD),
                         generator=dgen, dtype=torch.uint8, device=dev)
    sample = [bytes(r) for r in data[0, :5000, :KEY].cpu().numpy()]
    part = shuffle.range_partitioner(
        shuffle.sample_boundaries(sample, N_BUCKETS, KEY))
    spec, bwords = part.scatter_spec(shuffle.RecordBatch.empty(RECORD, dev),
                                     N_BUCKETS)
    keys = extract_keys(data, spec).contiguous()
    bounds = bounds_from_numpy(bwords).to(dev)
    counts = torch.tensor([640_000] * 15 + [400_000], dtype=torch.int32,
                          device=dev)
    bn = ops.ACCEL_BLOCK_N
    compare(keys, bounds, counts, None, N_BUCKETS, bn, data)
    n_cases += 1
    torch.cuda.synchronize()

    valid = torch.arange(MAIN_ROWS, device=dev) < counts[:, None]
    ids, rank, bhist = kernel.bucket_dest_blocks(keys, bounds, counts, None,
                                                 n_out=N_BUCKETS, bn=bn)
    kernel_ms = timed_ms(torch, lambda: kernel.bucket_dest_blocks(
        keys, bounds, counts, None, n_out=N_BUCKETS, bn=bn))
    plain_ms = timed_ms(torch, lambda: ref.bucket_blocks_ref(
        keys, bounds, valid, N_BUCKETS, bn))
    # the bytes the function needs: k 32-bit words of key for each real
    # row (rows that are not real go to the trash bucket unread), ids and
    # rank out for every row, the block histograms, the row counts and the
    # boundary words.  The int64 carriage of the words is the port's
    # choice: the kernel as built reads twice the key bytes (`carried`).
    rows = MAIN_SLOTS * MAIN_ROWS
    real = int(counts.sum())
    n_bounds, k = bounds.shape
    fixed = rows * 8 + 4 * (bhist.numel() + counts.numel() + n_bounds * k)
    k_bytes = real * 4 * k + fixed
    key_bytes = real * KEY + fixed          # the 10 key bytes alone
    carried = real * 8 * k + fixed
    k_ops = real * n_bounds * k * 2
    k_bound, k_by = bound_ms(k_bytes, k_ops)
    key_bound, _ = bound_ms(key_bytes, k_ops)
    scatter_ms = timed_ms(torch, lambda: ops.bucket_scatter(
        data, keys, bounds, counts, n_buckets=N_BUCKETS))
    out, hist = ops.bucket_scatter(data, keys, bounds, counts,
                                   n_buckets=N_BUCKETS)
    # every row in and out (the output is a permutation of all rows, the
    # trash included), the histogram, the counts and the boundary words;
    # the key words are made from the rows, so they are not counted
    s_bytes = (data.nbytes + out.nbytes + hist.nbytes + counts.nbytes
               + 4 * n_bounds * k)
    s_bound, _ = bound_ms(s_bytes, k_ops)
    print(f"kernel bucket_dest [{MAIN_SLOTS}, {MAIN_ROWS}] k={k} "
          f"n_out={N_BUCKETS} real_rows={real}: kernel_ms={kernel_ms:.4f} "
          f"bound_ms={k_bound:.4f} ({k_bytes} bytes, 32-bit key words) "
          f"key_bytes_bound_ms={key_bound:.4f} ({key_bytes} bytes) "
          f"carried_bytes={carried} "
          f"({carried / (kernel_ms * 1e-3) / 1e12:.3f} TB/s) "
          f"plain_ms={plain_ms:.4f} cases={n_cases} max_abs_err={worst}")
    print(f"bucket_scatter (kernel + epilogue + row move) "
          f"[{MAIN_SLOTS}, {MAIN_ROWS}, {RECORD}]: scatter_ms="
          f"{scatter_ms:.4f} bound_ms={s_bound:.4f} ({s_bytes} bytes)")
    return row("bucket_dest", worst, kernel_ms, plain_ms, k_bound, k_by)


def key_floor_bytes(ptr: int, n: int, width: int, kb: int, grain: int
                    ) -> int:
    """Bytes of the ``grain``-byte blocks of device memory that the first
    ``kb`` bytes of ``n`` records of ``width`` bytes from address ``ptr``
    touch: what the memory must move to read the keys alone."""
    first = ptr % grain + np.arange(n, dtype=np.int64) * width
    return int(((first + kb - 1) // grain - first // grain + 1).sum()) * grain


def rows_cases(torch, dev, gen):
    """``(data, key_spec, bounds, n_buckets)`` cases of the rows entry:
    range keys of k = 1..5 words with and without the length word, a key
    longer than the record (clipped), hash keys of 4, 8 and 10 bytes;
    widths 100, 13 and 7; a view whose storage offset is not 4-aligned;
    N = 0, 1 and a ragged N.  Low-entropy bytes and boundaries taken from
    the records' own keys give boundary ties and multi-word ties."""
    from repro_torch.core.records import extract_keys, uniform_hash_bounds
    from repro_torch.kernels.bucket_partition.kernel import key_layout

    def sampled_bounds(data, spec, nb):
        keys = extract_keys(data, spec)
        if not len(keys):
            return torch.zeros((nb - 1, key_layout(spec, data.shape[1])[3]),
                               dtype=torch.int64)
        pick = keys[torch.randint(0, len(keys), (nb - 1,), generator=gen)]
        return pick[torch.from_numpy(np.lexsort(pick.numpy().T[::-1]))]

    specs = [("range", 4, 1, None), ("range", 4, 1, 4),
             ("range", 8, 2, None), ("range", 10, 3, None),
             ("range", 10, 3, 10), ("range", 6, 3, None),
             ("range", 16, 4, 16), ("range", 20, 5, None),
             ("range", 12, 3, 12),         # longer than a 7-byte record
             ("hash", 4), ("hash", 8), ("hash", 10)]
    for width in (100, 13, 7):
        for offset in ((0, 1) if width == 100 else (0,)):
            for n in (3001, 1, 0):
                flat = torch.randint(0, 2, (n * width + offset,),
                                     generator=gen, dtype=torch.uint8)
                host = flat[offset:].view(n, width)
                data = flat.to(dev)[offset:].view(n, width)
                for spec in specs:
                    for nb in (2, 6, 16):
                        if spec[0] == "hash":
                            bounds = torch.from_numpy(uniform_hash_bounds(
                                nb).astype(np.int64))[:, None]
                        else:
                            bounds = sampled_bounds(host, spec, nb)
                        yield data, spec, bounds.to(dev), nb


def partition_phase(torch):
    """Both entries of bucket_partition.cu against their plain versions;
    returns their two rows."""
    from repro_torch.convert import bounds_from_numpy
    from repro_torch.core import shuffle
    from repro_torch.core.records import extract_keys
    from repro_torch.kernels.bucket_partition import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    worst = worst_rows = 0
    n_cases = n_rows = 0

    def differ(name, got, want, what):
        err = 0
        for g, w in zip(got, want):
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        check(err == 0, f"{name} {what} differs from the plain version (max "
                        f"err {err})")
        return err

    def compare(keys, bounds, n_buckets, bn, entry=True):
        nonlocal worst, n_cases
        got = kernel.bucket_partition_ids(keys, bounds, n_buckets=n_buckets,
                                          bn=bn)
        want = ref.bucket_partition_ref(keys, bounds, n_buckets)
        worst = max(worst, differ(
            "bucket_partition", got, want, f"(n={keys.shape[0]}, k="
            f"{keys.shape[1]}, nb={n_buckets}, bn={bn})"))
        if entry:
            ids, hist = ops.bucket_partition(keys, bounds,
                                             n_buckets=n_buckets, block_n=bn)
            check(torch.equal(ids, want[0]) and torch.equal(hist, want[1]),
                  f"ops.bucket_partition differs (nb={n_buckets})")
        n_cases += 1

    def compare_rows(data, spec, bounds, n_buckets, bn=None):
        nonlocal worst_rows, n_rows
        got = kernel.bucket_partition_rows(data, spec, bounds,
                                           n_buckets=n_buckets, bn=bn)
        want = ref.bucket_partition_rows_ref(data, spec, bounds, n_buckets)
        worst_rows = max(worst_rows, differ(
            "bucket_partition_rows", got, want, f"(shape "
            f"{tuple(data.shape)}, offset {data.storage_offset()}, "
            f"spec {spec}, nb={n_buckets}, bn={bn})"))
        ids, hist = ops.bucket_partition_rows(data, spec, bounds,
                                              n_buckets=n_buckets,
                                              block_n=bn)
        check(torch.equal(ids, want[0]) and torch.equal(hist, want[1]),
              f"ops.bucket_partition_rows differs ({spec}, nb={n_buckets})")
        n_rows += 1

    def rand(shape, high):
        return torch.randint(0, high, shape, generator=gen,
                             dtype=torch.int64).to(dev)

    # low-entropy words: boundary ties, multi-word ties, duplicates;
    # a ragged N (not a multiple of any block)
    for k in (1, 3, 4):
        for nb in (2, 6, 16, 64):
            for bn in (7, 256, 2048):
                keys, bounds = rand((3001, k), 4), rand((nb - 1, k), 4)
                bounds = bounds[torch.from_numpy(np.lexsort(
                    bounds.cpu().numpy().T[::-1])).to(dev)]
                compare(keys, bounds, nb, bn)
    # N = 0 and one row
    compare(rand((0, 3), 4), rand((5, 3), 4), 6, 2048)
    compare(rand((1, 3), 4), rand((5, 3), 4), 6, 2048)
    # overflow ids: more boundary rows than buckets, at the kernel's own
    # level (unclamped ids, counted in no bin)
    keys, bounds = rand((5000, 3), 4), rand((9, 3), 4)
    for nb in (2, 4):
        compare(keys, bounds, nb, 128, entry=False)
    # full-range 32-bit words
    compare(rand((70_001, 3), 2 ** 32), rand((5, 3), 2 ** 32), 6, 2048)
    # the rows entry: every key layout, width, alignment and size above
    for data, spec, bounds, nb in rows_cases(torch, dev, gen):
        compare_rows(data, spec, bounds, nb)
    torch.cuda.synchronize()

    # the path's shape: 10,000,000 records of 100 bytes, their 10-byte
    # keys as k = 3 words, 6 buckets
    dgen = torch.Generator(device=dev).manual_seed(77)
    data = torch.randint(0, 256, (PART_ROWS, RECORD), generator=dgen,
                         dtype=torch.uint8, device=dev)
    sample = sorted(bytes(r) for r in data[:100_000, :KEY].cpu().numpy())
    part = shuffle.range_partitioner(
        shuffle.sample_boundaries(sample, N_BUCKETS, KEY))
    spec, bwords = part.scatter_spec(shuffle.RecordBatch(data), N_BUCKETS)
    bounds = bounds_from_numpy(bwords).to(dev)
    keys = extract_keys(data, spec).contiguous()
    bn = ops.ACCEL_BLOCK_N
    compare(keys, bounds, N_BUCKETS, bn)
    compare_rows(data, spec, bounds, N_BUCKETS)
    # a storage offset that is not 4-aligned takes the byte loads
    compare_rows(data.view(-1)[1:1 + (PART_ROWS - 1) * RECORD].view(
        PART_ROWS - 1, RECORD), spec, bounds, N_BUCKETS)
    words_ms = timed_ms(torch, lambda: kernel.bucket_partition_ids(
        keys, bounds, n_buckets=N_BUCKETS, bn=bn))
    words_plain_ms = timed_ms(torch, lambda: ref.bucket_partition_ref(
        keys, bounds, N_BUCKETS))
    rows_ms = timed_ms(torch, lambda: kernel.bucket_partition_rows(
        data, spec, bounds, n_buckets=N_BUCKETS))
    rows_plain_ms = timed_ms(torch, lambda: ref.bucket_partition_rows_ref(
        data, spec, bounds, N_BUCKETS))
    # the route the partition path took before the rows entry: the key
    # rows built by plain torch, then the words entry
    old_ms = timed_ms(torch, lambda: ops.bucket_partition(
        extract_keys(data, spec), bounds, n_buckets=N_BUCKETS))
    n_bounds, k = bounds.shape
    small = 4 * (N_BUCKETS + n_bounds * k)
    p_ops = PART_ROWS * n_bounds * k * 2
    # words: 32-bit key words in, ids out, the histogram and the bounds
    p_bytes = PART_ROWS * (4 * k + 4) + small
    p_bound, p_by = bound_ms(p_bytes, p_ops)
    carried = PART_ROWS * (8 * k + 4)
    # rows: the 10 key bytes of each record in, ids out; and the floors
    # of the 32-byte sectors and the 64-byte memory atoms the keys touch
    r_bytes = PART_ROWS * (KEY + 4) + small
    r_bound, r_by = bound_ms(r_bytes, p_ops)
    sector = key_floor_bytes(data.data_ptr(), PART_ROWS, RECORD, KEY, 32) \
        + PART_ROWS * 4 + small
    atom = key_floor_bytes(data.data_ptr(), PART_ROWS, RECORD, KEY, 64) \
        + PART_ROWS * 4 + small
    sector_ms, atom_ms = bound_ms(sector, p_ops)[0], bound_ms(atom, p_ops)[0]
    print(f"kernel bucket_partition [{PART_ROWS}, {k}] n_buckets="
          f"{N_BUCKETS}: kernel_ms={words_ms:.4f} bound_ms={p_bound:.4f} "
          f"({p_bytes} bytes, 32-bit key words) carried_bytes={carried} "
          f"({carried / (words_ms * 1e-3) / 1e12:.3f} TB/s) "
          f"plain_ms={words_plain_ms:.4f} cases={n_cases} "
          f"max_abs_err={worst}")
    print(f"kernel bucket_partition_rows [{PART_ROWS}, {RECORD}] B k={k} "
          f"n_buckets={N_BUCKETS}: kernel_ms={rows_ms:.4f} "
          f"bound_ms={r_bound:.4f} ({r_bytes} bytes) "
          f"sector_floor_ms={sector_ms:.4f} ({sector} bytes) "
          f"atom_floor_ms={atom_ms:.4f} ({atom} bytes, "
          f"{atom / (rows_ms * 1e-3) / 1e12:.3f} TB/s, "
          f"{rows_ms / atom_ms:.2f}x the atom floor) "
          f"old_route_ms={old_ms:.4f} (key rows + words entry) "
          f"words_ms={words_ms:.4f} plain_ms={rows_plain_ms:.4f} "
          f"cases={n_rows} max_abs_err={worst_rows}")
    return (row("bucket_partition", worst, words_ms, words_plain_ms, p_bound,
                p_by),
            row("bucket_partition_rows", worst_rows, rows_ms, rows_plain_ms,
                r_bound, r_by))


def assign_phase(torch):
    """Both kmeans_assign entries against their plain versions; returns
    their two rows."""
    from repro_torch.kernels.kmeans_assign import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    worst = worst_p = 0.0
    n_cases = n_partials = 0

    def case(n, d, k, dtype, dup=False):
        x = torch.randn((n, d), generator=gen).to(dtype).to(dev)
        c = torch.randn((k, d), generator=gen)
        if dup and k > 2:
            c[k - 1] = c[1]
        return x, c.to(dev)

    def decided_points(x, c, want_ids):
        """Points whose plain best-to-second gap exceeds the margin, the
        ones whose id must agree exactly."""
        x32 = x.float()
        xx = (x32 * x32).sum(1)
        cc = (c * c).sum(1)
        scale = xx + cc[want_ids.long()]
        if c.shape[0] < 2 or not x.shape[0]:
            return torch.ones_like(want_ids, dtype=torch.bool), scale
        full = xx[:, None] - 2 * (x32 @ c.T) + cc[None]
        two = full.topk(2, dim=1, largest=False).values
        return two[:, 1] - two[:, 0] > 1e-5 * scale, scale

    def compare(x, c, bn=1024):
        nonlocal worst, n_cases
        ids, d2 = kernel.kmeans_assign_ids(x, c, bn=bn)
        want_ids, want_d2 = ref.kmeans_assign_ref(x, c)
        decided, scale = decided_points(x, c, want_ids)
        if x.shape[0]:
            err = (d2 - want_d2).abs()
            worst = max(worst, float(err.max()))
            check(bool(torch.all(err <= 1e-5 * scale + 1e-6)),
                  f"kmeans_assign d2 beyond tolerance {tuple(x.shape)} "
                  f"K={c.shape[0]} {x.dtype}: max err {float(err.max())}")
        bad = int((ids[decided] != want_ids[decided]).sum())
        check(bad == 0, f"kmeans_assign ids differ at {bad} decided points "
                        f"{tuple(x.shape)} K={c.shape[0]} {x.dtype}")
        got = ops.kmeans_assign(x, c, block_n=bn)
        check(torch.equal(got[0], ids) and torch.equal(got[1], d2),
              "ops.kmeans_assign differs from the kernel")
        n_cases += 1
        return ids

    def compare_partials(x, c, valid):
        """The fused partials: the same bits twice; counts exactly the
        masked bincount of the ids kernel's ids and sums within 1e-5 *
        sum |x| + 1e-6 of float64 one-hot sums over them; and, over the
        decided points, counts equal to the plain version's and sums
        within the same bound of them."""
        nonlocal worst_p, n_partials
        k, d = c.shape
        where = f"{tuple(x.shape)} K={k} {x.dtype} mask={valid is not None}"
        table = kernel.kmeans_partials(x, c, valid)
        check(torch.equal(table, kernel.kmeans_partials(x, c, valid)),
              f"kmeans_partials differs between two launches {where}")
        check(torch.equal(table, ops.kmeans_partials(x, c, valid)),
              "ops.kmeans_partials differs from the kernel")
        ids, _ = kernel.kmeans_assign_ids(x, c, bn=1024)
        v = (torch.ones(x.shape[0], dtype=torch.bool, device=dev)
             if valid is None else valid)
        check(torch.equal(table[:, d], torch.bincount(
            ids[v].long(), minlength=k).float()),
            f"kmeans_partials counts differ from the ids kernel's {where}")
        oh = torch.nn.functional.one_hot(ids.long(), k).double() \
            * v.double()[:, None]
        err = (table[:, :d].double() - oh.T @ x.double()).abs()
        check(bool(torch.all(err <= 1e-5 * (oh.T @ x.double().abs())
                             + 1e-6)),
              f"kmeans_partials sums beyond tolerance {where}: max err "
              f"{float(err.max()) if err.numel() else 0.0}")
        want_ids, _ = ref.kmeans_assign_ref(x, c)
        sure = v & decided_points(x, c, want_ids)[0]
        got = kernel.kmeans_partials(x, c, sure)
        plain = ref.kmeans_partials_ref(x, c, sure)
        check(torch.equal(got[:, d], plain[:, d]),
              f"kmeans_partials counts differ from the plain version "
              f"{where}")
        oh = torch.nn.functional.one_hot(want_ids.long(), k).float() \
            * sure.float()[:, None]
        p_err = (got[:, :d] - plain[:, :d]).abs()
        check(bool(torch.all(p_err <= 1e-5 * (oh.T @ x.float().abs())
                             + 1e-6)),
              f"kmeans_partials sums differ from the plain version {where}")
        if p_err.numel():
            worst_p = max(worst_p, float(p_err.max()))
        n_partials += 1

    for dtype in (torch.float32, torch.bfloat16):
        for n, d, k, bn in ((0, 8, 10, 1024), (1, 1, 1, 1024),
                            (100_003, 8, 10, 1024), (65_536, 32, 100, 512),
                            (777, 3, 5, 7), (5000, 16, 7, 256),
                            (3000, 40, 6, 64), (2000, 8, 200, 1024)):
            x, c = case(n, d, k, dtype, dup=True)
            ids = compare(x, c, bn)
            check(k <= 2 or not bool((ids == k - 1).any()),
                  "a duplicated centroid won over its lower twin")
            compare_partials(x, c, None)
            compare_partials(x, c, torch.rand(n, generator=gen).to(dev)
                             < 0.7)
    # 16-byte misaligned points: the element-wise load route
    x, c = case(100_001, 8, 10, torch.float32)
    odd = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    odd.copy_(x)
    check(all(torch.equal(g, w) for g, w in zip(
        kernel.kmeans_assign_ids(odd, c, bn=1024),
        kernel.kmeans_assign_ids(x, c, bn=1024))),
        "misaligned points change the ids kernel's output")
    # the element route walks the points in another order, so only the
    # counts are bit for bit
    check(torch.equal(kernel.kmeans_partials(odd, c)[:, DIM],
                      kernel.kmeans_partials(x, c)[:, DIM]),
          "misaligned points change the partials' counts")
    compare(odd, c)
    compare_partials(odd, c, None)
    # the shared-memory limit: exactly full runs, one float more raises
    kd = (256, 226)
    check(kernel.shared_bytes(*kd) == kernel.MAX_SHARED,
          "the limit case does not fill shared memory")
    x, c = case(4096, kd[1], kd[0], torch.float32)
    compare(x, c)
    compare_partials(x, c, torch.rand(4096, generator=gen).to(dev) < 0.7)
    x, c = case(64, kd[1] + 1, kd[0], torch.float32)
    for entry in (lambda: kernel.kmeans_assign_ids(x, c, bn=1024),
                  lambda: kernel.kmeans_partials(x, c)):
        try:
            entry()
        except ValueError:
            pass
        else:
            fail("kmeans_assign took a centroid table over the shared "
                 "memory")
    torch.cuda.synchronize()

    # the path's launch shape: one 64 MiB chunk of points, K=10, every
    # row valid (a full chunk)
    x, c = case(ASSIGN_ROWS, DIM, K, torch.float32)
    valid = torch.ones(ASSIGN_ROWS, dtype=torch.bool, device=dev)
    compare(x, c)
    compare_partials(x, c, valid)
    kernel_ms = timed_ms(torch, lambda: kernel.kmeans_assign_ids(
        x, c, bn=1024))
    plain_ms = timed_ms(torch, lambda: ref.kmeans_assign_ref(x, c))
    part_ms = timed_ms(torch, lambda: kernel.kmeans_partials(x, c, valid))
    part_plain_ms = timed_ms(torch, lambda: ref.kmeans_partials_ref(
        x, c, valid))
    # |x|^2 and x.c as FMAs (2 operations each), and the compare-and-add
    a_ops = ASSIGN_ROWS * (2 * DIM * (K + 1) + 2 * K)
    # ids: points and centroids in, ids and d2 out
    a_bytes = x.nbytes + c.nbytes + ASSIGN_ROWS * 8
    a_bound, a_by = bound_ms(a_bytes, a_ops)
    # partials: points, mask and centroids in, [K, D + 1] out; and the
    # D + 1 adds of each point into its centroid's cells
    p_bytes = x.nbytes + valid.nbytes + c.nbytes + K * (DIM + 1) * 4
    p_ops = a_ops + ASSIGN_ROWS * 2 * (DIM + 1)
    p_bound, p_by = bound_ms(p_bytes, p_ops)
    print(f"kernel kmeans_assign [{ASSIGN_ROWS}, {DIM}] K={K}: "
          f"kernel_ms={kernel_ms:.4f} bound_ms={a_bound:.4f} "
          f"({a_bytes} bytes, {a_ops} operations) "
          f"({a_bytes / (kernel_ms * 1e-3) / 1e12:.3f} TB/s, "
          f"{kernel_ms / a_bound:.2f}x the bound) "
          f"plain_ms={plain_ms:.4f} cases={n_cases} max_abs_err={worst:.3e}")
    print(f"kernel kmeans_partials [{ASSIGN_ROWS}, {DIM}] K={K}: "
          f"kernel_ms={part_ms:.4f} bound_ms={p_bound:.4f} "
          f"({p_bytes} bytes, {p_ops} operations) "
          f"({p_bytes / (part_ms * 1e-3) / 1e12:.3f} TB/s, "
          f"{part_ms / p_bound:.2f}x the bound) "
          f"plain_ms={part_plain_ms:.4f} cases={n_partials} "
          f"max_abs_err={worst_p:.3e}")
    return (row("kmeans_assign", worst, kernel_ms, plain_ms, a_bound, a_by),
            row("kmeans_partials", worst_p, part_ms, part_plain_ms, p_bound,
                p_by))


# ------------------------------------------------------------ phase 3
def terasort_path(torch, n_records: int, seed: int, device="cuda"):
    """TeraSort through the port's engine.  Returns (bucket_dest launches,
    report, outputs, data, oracle order, boundaries, tracer)."""
    from repro_torch.core import SphereEngine, SphereJob
    from repro_torch.core.shuffle import sample_boundaries, terasort_stages
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels.bucket_partition import kernel

    rng = np.random.default_rng(seed)
    t = time.perf_counter()
    data = np.frombuffer(rng.bytes(n_records * RECORD), np.uint8) \
        .reshape(n_records, RECORD)
    # the oracle: a stable lexsort of the 10-byte keys, which must have
    # no ties (so the sorted order is unique)
    k_hi = data[:, :8].copy().view(">u8")[:, 0]
    k_lo = data[:, 8:10].copy().view(">u2")[:, 0]
    order = np.lexsort((k_lo, k_hi))
    ties = (k_hi[order][1:] == k_hi[order][:-1]) \
        & (k_lo[order][1:] == k_lo[order][:-1])
    check(not ties.any(), "random keys have ties; pick another --seed")
    print(f"terasort: data + oracle {time.perf_counter() - t:.2f}s")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        master, client = cloud(tmp, CHUNK_RECORDS * RECORD)
        t = time.perf_counter()
        client.upload("tera", data.tobytes(), replication=3)
        upload_s = time.perf_counter() - t
        step = max(1, n_records // 100_000)
        sample = [data[i, :KEY].tobytes() for i in range(0, n_records, step)]
        bounds = sample_boundaries(sample, N_BUCKETS, key_bytes=KEY)
        job = SphereJob("terasort", "tera",
                        terasort_stages(bounds, "array", N_BUCKETS, KEY),
                        record_size=RECORD, backend="array")
        tracer = Tracer()
        engine = SphereEngine(master, client, device=device,
                              timing_sync=True, tracer=tracer)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernel.launches = 0
        t = time.perf_counter()
        outs, rep = engine.run(job)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = kernel.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    print(f"terasort: {n_records} records x {RECORD} B: "
          f"upload_s={upload_s:.3f} run_wall_s={wall_s:.3f} "
          f"partition_seconds={rep.partition_seconds:.4f} "
          f"rec_per_s={n_records / wall_s:.0f} "
          f"sim_seconds={rep.sim_seconds:.3f} "
          f"max_memory_allocated={peak} "
          f"shuffle_rounds={rep.shuffle_rounds} host_syncs={rep.host_syncs} "
          f"device_dispatches={rep.device_dispatches} "
          f"udf_traces={rep.udf_traces} launches={launches}")
    print(f"terasort: host-clock spans (s): {spans_line(tracer)}")
    return launches, rep, outs, data, order, bounds


def check_terasort(launches, rep, outs, data, order) -> bytes:
    check(rep.shuffle_rounds >= 1, "the job ran no shuffle round")
    check(launches == rep.shuffle_rounds,
          f"bucket_dest launched {launches} times for "
          f"{rep.shuffle_rounds} shuffle rounds")
    check(rep.host_syncs == rep.shuffle_rounds,
          f"host_syncs {rep.host_syncs} != shuffle_rounds "
          f"{rep.shuffle_rounds}")
    check(len(outs) == N_BUCKETS, f"{len(outs)} output partitions")
    got = b"".join(outs)
    check(len(got) == data.nbytes, f"{len(got)} output bytes, expected "
                                   f"{data.nbytes}")
    want = data[order].tobytes()
    check(got == want, "sorted output differs from the numpy oracle")
    return want


# ------------------------------------------------------------ phase 4
def partition_path(torch, data, bounds, device="cuda"):
    """partition_batch and shuffle_batch on the TeraSort records.  Returns
    ((rows entry, words entry) launches, calls, ids, hist, pieces' sorted
    bytes)."""
    from repro_torch.core.records import RecordBatch
    from repro_torch.core.shuffle import (partition_batch, range_partitioner,
                                          shuffle_batch)
    from repro_torch.kernels.bucket_partition import kernel

    batch = RecordBatch.from_bytes(data.tobytes(), RECORD, device=device)
    part = range_partitioner(bounds)
    if device == "cuda":
        torch.cuda.synchronize()
    kernel.rows_launches = kernel.partition_launches = 0
    t = time.perf_counter()
    ids, hist = partition_batch(batch, part, N_BUCKETS)
    pieces = shuffle_batch(batch, part, N_BUCKETS)
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = (kernel.rows_launches, kernel.partition_launches)
    t = time.perf_counter()
    sorted_bytes = b"".join(p.sort_by_key(KEY).to_bytes() for p in pieces)
    print(f"partition_batch + shuffle_batch: {batch.num_records} records: "
          f"wall_s={wall_s:.4f} hist={hist.tolist()} launches={launches} "
          f"(sort check {time.perf_counter() - t:.2f}s)")
    del pieces
    if device == "cuda":
        profile_partition(torch, batch, part)
    return launches, 2, ids.cpu().numpy(), hist.cpu().numpy(), sorted_bytes


def profile_partition(torch, batch, part) -> None:
    """One partition_batch under ``torch.profiler`` beside the route it
    replaced (the key rows built by plain torch, then the words entry),
    each after a warm call: device busy time against the host clock of
    the call, and the largest device consumers; then shuffle_batch's host
    steps (``records.scatter_by_ids``) timed one by one.  A measurement
    only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.records import extract_keys
    from repro_torch.core.shuffle import _bounds_tensor, partition_batch
    from repro_torch.kernels.bucket_partition import ops

    def words_route():
        spec, bwords = part.scatter_spec(batch, N_BUCKETS)
        return ops.bucket_partition(extract_keys(batch.data, spec),
                                    _bounds_tensor(bwords, batch.device),
                                    n_buckets=N_BUCKETS)

    for name, fn in (("words route (key rows + words entry)", words_route),
                     ("partition_batch (rows entry)",
                      lambda: partition_batch(batch, part, N_BUCKETS))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
        if not busy_ms:
            print(f"partition: profiled {name}: the profiler saw no device "
                  f"time; device busy share not measured")
            continue
        top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
        print(f"partition: profiled {name}: {wall_ms:.3f} ms on the host "
              f"clock, device busy {busy_ms:.3f} ms (idle share "
              f"{1 - busy_ms / wall_ms:.3f}) in "
              f"{sum(e.count for e in on_card)} device ops; largest: "
              + "; ".join(f"{e.key[:50]} x{e.count} "
                          f"{e.self_device_time_total / 1e3:.3f} ms"
                          for e in top))

    ids, hist = partition_batch(batch, part, N_BUCKETS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids_np, hist_np = ids.cpu().numpy(), hist.cpu().numpy()
    t1 = time.perf_counter()
    order = np.argsort(ids_np, kind="stable")
    t2 = time.perf_counter()
    pieces = [batch.take(p)
              for p in np.split(order, np.cumsum(hist_np)[:-1])]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"partition: shuffle_batch's host steps: ids and hist to the host "
          f"{t1 - t0:.4f} s, stable argsort of {len(ids_np)} ids "
          f"{t2 - t1:.4f} s, {len(pieces)} takes {t3 - t2:.4f} s")


def check_partition(launches, calls, ids, hist, sorted_bytes, data, bounds,
                    outs, want) -> None:
    check(launches[0] == calls, f"bucket_partition_rows launched "
                                f"{launches[0]} times for {calls} calls")
    check(launches[1] == 0, f"the partition path launched the words entry "
                            f"{launches[1]} times")
    key_hi = data[:, :8].copy().view(">u8")[:, 0]
    key_lo = data[:, 8:10].copy().view(">u2")[:, 0]
    oracle = np.zeros(len(data), np.int64)
    for b in bounds:
        b_hi = np.frombuffer(b[:8], ">u8")[0]
        b_lo = np.frombuffer(b[8:10], ">u2")[0]
        oracle += (b_hi < key_hi) | ((b_hi == key_hi) & (b_lo < key_lo))
    check(np.array_equal(ids, np.minimum(oracle, N_BUCKETS - 1)),
          "partition_batch ids differ from the numpy oracle")
    counts = [len(o) // RECORD for o in outs]
    check(hist.tolist() == counts, f"partition_batch hist {hist.tolist()} "
                                   f"!= TeraSort bucket counts {counts}")
    check(sorted_bytes == want,
          "shuffle_batch pieces, sorted, differ from the oracle order")


# ------------------------------------------------------------ phase 5
def make_points(n_points: int, seed: int) -> np.ndarray:
    """A mixture of K Gaussian clusters, float32, made in slices."""
    rng = np.random.default_rng([seed, 2])
    centers = rng.normal(size=(K, DIM)) * 4.0
    pts = np.empty((n_points, DIM), np.float32)
    step = 1 << 22
    for i in range(0, n_points, step):
        m = min(step, n_points - i)
        pts[i:i + m] = centers[rng.integers(0, K, m)]
        pts[i:i + m] += rng.standard_normal((m, DIM), dtype=np.float32)
    return pts


def _lloyd_partials(x32: np.ndarray, c64: np.ndarray):
    """(sums [K, DIM], counts [K]) of one slice of points in float64; the
    argmin keeps the lowest index on a tie, as the kernel does."""
    x = x32.astype(np.float64)
    d2 = (c64 * c64).sum(1) - 2 * (x @ c64.T)    # |x|^2 is common to a row
    best, a = d2[:, 0].copy(), np.zeros(len(x), np.int64)
    for j in range(1, K):
        nearer = d2[:, j] < best
        best[nearer] = d2[nearer, j]
        a[nearer] = j
    oh = np.zeros((len(x), K))
    oh[np.arange(len(x)), a] = 1.0
    return oh.T @ x, np.bincount(a, minlength=K)


def lloyd_oracle(pts: np.ndarray, seed: int, iters: int) -> np.ndarray:
    """Float64 Lloyd iterations from kmeans_sphere's seeded init, with its
    keep-empty-centroid rule, over slices of the points on every host
    core (numpy releases the interpreter lock inside each operation)."""
    c = np.random.default_rng(seed).normal(size=(K, DIM)).astype(np.float32)
    step = 1 << 21
    slices = [pts[i:i + step] for i in range(0, len(pts), step)]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for _ in range(iters):
            c64 = c.astype(np.float64)
            sums = np.zeros((K, DIM))
            counts = np.zeros(K)
            for s_part, n_part in pool.map(
                    lambda x: _lloyd_partials(x, c64), slices):
                sums += s_part
                counts += n_part
            nz = counts > 0
            c[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    return c


def profile_iteration(torch, engine, session, cents, steady_s: float
                      ) -> None:
    """One more k-means iteration in the same session, under
    ``torch.profiler``: the device's busy time per steady iteration (the
    sum of its kernels and copies on the one stream), its idle share
    against the median unprofiled iteration, and the largest device
    consumers.  A measurement only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.kmeans import kmeans_sphere
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kmeans_sphere(engine, "angle/points.f32", dim=DIM, k=K, iters=1,
                      backend="array", session=session, init=cents)
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if not busy_ms:
        print("kmeans: profiled iteration: the profiler saw no device "
              "time; device busy share not measured")
        return
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    print(f"kmeans: profiled iteration: device busy {busy_ms:.3f} ms "
          f"against a steady iteration of {steady_s * 1e3:.3f} ms "
          f"(idle share {1 - busy_ms / (steady_s * 1e3):.3f}); largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms"
                      for e in top))


def kmeans_path(torch, n_points: int, seed: int, device="cuda"):
    """k-means through one session.  Returns ((kmeans_partials,
    kmeans_assign) launches, assign tasks a run, centroids, report,
    points)."""
    from repro_torch.core import SphereEngine
    from repro_torch.core.kmeans import encode_points, kmeans_sphere
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels.kmeans_assign import kernel

    t = time.perf_counter()
    pts = make_points(n_points, seed)
    print(f"kmeans: data {time.perf_counter() - t:.2f}s")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_km_"))
    try:
        master, client = cloud(tmp)
        t = time.perf_counter()
        client.upload("angle/points.f32", encode_points(pts), replication=2)
        upload_s = time.perf_counter() - t
        n_chunks = master.files["angle/points.f32"].n_chunks
        tracer = Tracer()
        engine = SphereEngine(master, client, device=device, tracer=tracer)
        session = engine.session("angle/points.f32", record_size=4 * DIM,
                                 backend="array")
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernel.partials_launches = kernel.launches = 0
        iter_s: list = []
        t = time.perf_counter()
        cents, rep = kmeans_sphere(engine, "angle/points.f32", dim=DIM, k=K,
                                   iters=ITERS, seed=seed, backend="array",
                                   session=session, iter_seconds=iter_s)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = (kernel.partials_launches, kernel.launches)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        spans = spans_line(tracer)
        if device == "cuda":
            profile_iteration(torch, engine, session, cents,
                              statistics.median(iter_s[1:]))
        session.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steady = sum(iter_s[1:])
    print(f"kmeans: {n_points} points x {DIM} K={K} iters={ITERS} "
          f"chunks={n_chunks}: upload_s={upload_s:.3f} "
          f"run_wall_s={wall_s:.3f} iter_s="
          f"{[round(s, 4) for s in iter_s]} "
          f"points_per_s_iters_1_4="
          f"{n_points * (ITERS - 1) / steady if steady else 0:.0f} "
          f"sim_seconds={rep.sim_seconds:.3f} max_memory_allocated={peak} "
          f"tasks={rep.tasks} shuffle_rounds={rep.shuffle_rounds} "
          f"host_syncs={rep.host_syncs} "
          f"device_dispatches={rep.device_dispatches} "
          f"udf_traces={rep.udf_traces} launches={launches}")
    print(f"kmeans: host-clock spans (s): {spans}")
    return launches, n_chunks, cents, rep, pts


def check_kmeans(launches, n_chunks, cents, rep, pts, seed) -> float:
    check(rep.udf_traces == {"assign": 1, "fold": 1},
          f"udf_traces {rep.udf_traces}")
    check(launches[0] == ITERS * n_chunks,
          f"kmeans_partials launched {launches[0]} times for {ITERS} "
          f"iterations x {n_chunks} assign tasks")
    check(launches[1] == 0, f"the k-means path launched the ids kernel "
                            f"{launches[1]} times")
    t = time.perf_counter()
    want = lloyd_oracle(pts, seed, ITERS)
    err = float(np.abs(cents - want).max())
    print(f"kmeans: oracle {time.perf_counter() - t:.2f}s, centroids max "
          f"abs err {err:.3e}")
    check(np.allclose(cents, want, rtol=1e-3, atol=1e-3),
          f"k-means centroids differ from the float64 oracle (max abs "
          f"err {err})")
    return err


# ------------------------------------------------------------ phases 6-7
@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def plain_kernels():
    """Both LM kernels' launchers swapped for their plain versions (the
    scan's backward launcher too): the reference runs of the logit check
    and of the gradient check, set up here and nowhere else."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.kernels.rg_lru_scan.ref import lru_scan_ref

    def attn(q, k, v, *, causal, window):
        return flash_attention_ref(q, k, v, causal=causal, window=window)

    with patched(fkernel, "flash_attention_fwd", attn), \
            patched(lkernel, "lru_scan", lru_scan_ref), \
            patched(lkernel, "lru_scan_backward", lru_scan_ref):
        yield


def lm_model(torch, seed: int, cfg=None, device="cuda"):
    """The LM config (default: recurrentgemma-2b's full config) and its
    parameters from ``seed`` on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.utils.pytree import tree_leaves
    cfg = cfg or get_config(LM_ARCH)
    t = time.perf_counter()
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               device)
    if device == "cuda":
        torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"lm: {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.param_dtype}: {n} parameters "
          f"({sum(p.nbytes for p in tree_leaves(params))} bytes) in "
          f"{time.perf_counter() - t:.2f}s")
    return cfg, params


def serve_prompts(cfg, seed: int, long=LONG_PROMPTS, short=(16, 513)):
    """The long prompts, then six lengths drawn from ``seed`` in
    ``short``; tokens drawn from ``seed``."""
    rng = np.random.default_rng([seed, 3])
    lengths = list(long) + [int(n) for n in rng.integers(
        short[0], short[1], N_REQUESTS - len(long))]
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def capture_activations(torch, cfg, params, prompt, max_len=SERVE_LEN):
    """One prefill of ``prompt``; returns the inputs of its first
    ``flash_attention`` and first ``rg_lru_scan`` launch (the first L and
    the first R layer) and the prefill's seconds."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.models import model
    got = {}
    real_attn, real_scan = fkernel.flash_attention_fwd, lkernel.lru_scan

    def attn(q, k, v, *, causal, window):
        got.setdefault("attn", (q.clone(), k.clone(), v.clone(), causal,
                                window))
        return real_attn(q, k, v, causal=causal, window=window)

    def scan(a, b, h0):
        got.setdefault("scan", (a.clone(), b.clone(), h0.clone()))
        return real_scan(a, b, h0)

    dev = params["embed"]["w"].device
    with patched(fkernel, "flash_attention_fwd", attn), \
            patched(lkernel, "lru_scan", scan), torch.inference_mode():
        t = time.perf_counter()
        model.prefill(params, {"inputs": torch.tensor([prompt], device=dev)},
                      cfg=cfg, max_len=max_len)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    print(f"lm: capture prefill of {len(prompt)} tokens (the first, cold) "
          f"{time.perf_counter() - t:.3f}s")
    return got


def _sdpa_mask(torch, T, S, window, dev):
    tpos = torch.arange(T, device=dev)[:, None]
    spos = torch.arange(S, device=dev)[None, :]
    mask = spos <= tpos
    if window:
        mask &= tpos - spos < window
    return mask


def _rounded_p(torch, q, k, v, causal, window):
    """``(o, w)``, float32 ``[B, T, H, D]``: ``o`` as
    :func:`attention_rounded_p`; ``w = sum_j p_j |v_j| / l``, the size a
    one-bf16-step change of every p can move ``o`` by."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (x.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
              for x in (k, v))
    s = qf @ kf.transpose(2, 3) / math.sqrt(D)
    tpos = torch.arange(T, device=q.device)[:, None]
    spos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= spos <= tpos
    if window:
        mask &= tpos - spos < window
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vf) / l
    w = (p @ vf.abs()) / l
    return o.transpose(1, 2), w.transpose(1, 2)


def attention_rounded_p(torch, q, k, v, causal, window):
    """The bf16 flash kernel's numerics in plain PyTorch, float32 out:
    q ``[B, T, H, D]``, k / v ``[B, S, K, D]``; scores, the row maximum
    and the row sum in float32, masked scores -1e30; the unnormalised p
    (relative to the row maximum) rounded to v's type before its float32
    product with v, then divided by the sum of the unrounded p.  For
    float32 inputs it is the plain version's function."""
    return _rounded_p(torch, q, k, v, causal, window)[0]


def rounded_p_excess(torch, got, q, k, v, causal, window):
    """``(max |got - o|, excess)`` for the bf16 kernel's output ``got``
    against ``o`` of :func:`attention_rounded_p`.  The kernel rounds each
    p relative to its running maximum, the oracle relative to the row's,
    so a p may lie one bf16 step (2**-8 of it) apart, and the output
    rounds once more (2**-8 of it): ``excess`` is the largest
    ``|got - o| - 2**-8 * (|o| + w)``, what is left for float32 sums in
    another order.  Where a row's live keys lie in one 64-key tile the
    two maxima agree and ``|got - o| <= 2**-8 * |o|`` up to that."""
    o, w = _rounded_p(torch, q, k, v, causal, window)
    diff = (got.float() - o).abs()
    return (float(diff.max()),
            float((diff - 2 ** -8 * (o.abs() + w)).max()))


def flash_phase(torch, captured):
    """flash_attention against its plain version: a sweep of small cases,
    the captured local layer, random inputs at the local and the global
    shape; timings at both shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    worst = worst_rounded = 0.0
    worst_excess = -1.0
    n_cases = 0

    def compare(q, k, v, causal, window):
        nonlocal worst, worst_rounded, worst_excess, n_cases
        got = kernel.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
        check(bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol)),
              f"flash_attention beyond tolerance {tuple(q.shape)} "
              f"{tuple(k.shape)} {q.dtype} causal={causal} window={window}: "
              f"max err {err}")
        if q.dtype == torch.bfloat16:
            err_r, excess = rounded_p_excess(torch, got, q, k, v, causal,
                                             window)
            check(excess <= 1e-4,
                  f"flash_attention beyond what rounding p allows of the "
                  f"rounded-p oracle {tuple(q.shape)} {tuple(k.shape)} "
                  f"causal={causal} window={window}: max err {err_r}, "
                  f"{excess} beyond")
            worst_rounded = max(worst_rounded, err_r)
            worst_excess = max(worst_excess, excess)
        check(torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                              window=window), got),
              "ops.flash_attention differs from the kernel")
        worst = max(worst, err)
        n_cases += 1
        return got

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)

    for dtype in (torch.float32, torch.bfloat16):
        for B, T, S, H, K, D, causal, window in (
                (2, 64, 64, 2, 2, 32, True, 0), (2, 64, 64, 4, 2, 32, True, 24),
                (2, 50, 70, 2, 2, 32, False, 0),
                (2, 32, 96, 2, 1, 64, False, 24),
                (1, 333, 333, 10, 1, 256, True, 100),
                (1, 257, 257, 16, 2, 128, True, 0),
                (3, 1, 1, 4, 4, 16, True, 0), (1, 129, 129, 2, 1, 12, True, 0)):
            compare(rand((B, T, H, D), dtype), rand((B, S, K, D), dtype),
                    rand((B, S, K, D), dtype), causal, window)
    q, k, v, causal, window = captured["attn"]
    compare(q, k, v, causal, window)
    torch.cuda.synchronize()
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]

    def times(q, k, v, window, mask):
        ms = timed_ms(torch, lambda: kernel.flash_attention_fwd(
            q, k, v, causal=True, window=window))
        plain = timed_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window))
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def lib():
            if mask is None:
                return F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float() - ref.flash_attention_ref(
            q, k, v, causal=True, window=window).float()).abs().max())
        return ms, plain, timed_ms(torch, lib), lib_err

    def pairs(T, window):
        return sum(min(t + 1, window) if window else t + 1 for t in range(T))

    # the path's local layer: the captured activations
    mask = _sdpa_mask(torch, T, S, window, dev)
    ms, plain, lib, lib_err = times(q, k, v, window, mask)
    live = pairs(T, window)
    f_ops = 4 * D * H * live
    f_bytes = 2 * q.nbytes + k.nbytes + v.nbytes
    f_bound, f_by = bound_ms(f_bytes, f_ops, PEAK_BF16_PER_S)
    fp32_floor = f_ops / PEAK_OPS_PER_S * 1e3
    print(f"kernel flash_attention local q {list(q.shape)} k/v "
          f"{list(k.shape)} {q.dtype} window={window}: kernel_ms={ms:.4f} "
          f"bound_ms={f_bound:.4f} ({live} live pairs, {f_ops} operations at "
          f"989 TFLOP/s bf16; {f_bytes} bytes) "
          f"fp32_rate_floor_ms={fp32_floor:.4f} "
          f"({f_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s) plain_ms={plain:.4f} "
          f"sdpa_ms={lib:.4f} (max err vs plain {lib_err:.3e}; "
          f"{lib / ms:.3f}x the kernel's speed) "
          f"cases={n_cases} max_abs_err={worst:.3e} "
          f"bf16_max_abs_err_vs_rounded_p={worst_rounded:.3e} "
          f"(beyond what rounding p allows: {worst_excess:.3e})")
    # Qwen2.5-3B's global layer shape, random inputs
    gq, gk, gv = (rand(shape, torch.bfloat16) for shape in (
        (1, T, 16, 128), (1, T, 2, 128), (1, T, 2, 128)))
    compare(gq, gk, gv, True, 0)
    g_ms, g_plain, g_lib, g_lib_err = times(gq, gk, gv, 0, None)
    g_ops = 4 * 128 * 16 * pairs(T, 0)
    g_bound, _ = bound_ms(2 * gq.nbytes + gk.nbytes + gv.nbytes, g_ops,
                          PEAK_BF16_PER_S)
    print(f"kernel flash_attention global q {list(gq.shape)} k/v "
          f"{list(gk.shape)} bf16 causal: kernel_ms={g_ms:.4f} "
          f"bound_ms={g_bound:.4f} ({g_ops} operations) "
          f"fp32_rate_floor_ms={g_ops / PEAK_OPS_PER_S * 1e3:.4f} "
          f"({g_ops / (g_ms * 1e-3) / 1e12:.2f} TFLOP/s) "
          f"plain_ms={g_plain:.4f} sdpa_ms={g_lib:.4f} (max err vs plain "
          f"{g_lib_err:.3e}; {g_lib / g_ms:.3f}x the kernel's speed); "
          f"all {n_cases} cases: max_abs_err={worst:.3e} "
          f"bf16_max_abs_err_vs_rounded_p={worst_rounded:.3e} "
          f"(beyond what rounding p allows: {worst_excess:.3e})")
    return row("flash_attention", worst, ms, plain, f_bound, f_by, lib)


def lru_phase(torch, captured):
    """rg_lru_scan against its plain version, exactly: small cases, the
    captured first R layer of the long prefill and a decode step;
    timings at the prefill and the decode shape."""
    from repro_torch.kernels.rg_lru_scan import kernel, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    n_cases = 0

    def compare(a, b, h0):
        nonlocal n_cases
        got = kernel.lru_scan(a, b, h0)
        want = ref.lru_scan_ref(a, b, h0)
        for name, g, w in zip(("h", "h_last"), got, want):
            err = float((g - w).abs().max()) if g.numel() else 0.0
            check(err == 0, f"rg_lru_scan {name} differs from the plain "
                            f"version {tuple(a.shape)}: max err {err}")
        check(all(torch.equal(x, y) for x, y in
                  zip(ops.rg_lru_scan(a, b, h0), got)),
              "ops.rg_lru_scan differs from the kernel")
        n_cases += 1

    def rand(B, T, W):
        a = torch.rand((B, T, W), generator=gen) * 0.299 + 0.7
        b = torch.randn((B, T, W), generator=gen) * 0.1
        return a.to(dev), b.to(dev), torch.randn((B, W), generator=gen).to(dev)

    for shape in ((1, 16, 32), (2, 33, 64), (3, 8, 48), (1, 13, 1000),
                  (4, 1, 2560), (2, 0, 8), (2, 63, 48), (1, 64, 2560),
                  (3, 65, 1000), (1, 200, 13)):
        compare(*rand(*shape))
    a, b, h0 = captured["scan"]
    compare(a, b, h0)
    torch.cuda.synchronize()
    out = {}
    for label, args in (("prefill", (a, b, h0)),
                        ("decode", rand(4, 1, a.shape[2]))):
        ms = timed_ms(torch, lambda: kernel.lru_scan(*args))
        plain = timed_ms(torch, lambda: ref.lru_scan_ref(*args))
        x = args[0]
        n_bytes = 3 * x.nbytes + 2 * args[2].nbytes
        bnd, by = bound_ms(n_bytes, 2 * x.numel())
        out[label] = (ms, plain, bnd, by)
        print(f"kernel rg_lru_scan {label} {list(x.shape)}: "
              f"kernel_ms={ms:.4f} bound_ms={bnd:.6f} ({n_bytes} bytes) "
              f"({n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
              f"{ms / bnd:.2f}x the bound) plain_ms={plain:.4f}"
              + (f" cases={n_cases} max_abs_err=0" if label == "prefill"
                 else ""))
    ms, plain, bnd, by = out["prefill"]
    return row("rg_lru_scan", 0.0, ms, plain, bnd, by)


def serve_path(torch, cfg, params, prompts, max_len=SERVE_LEN,
               max_new=MAX_NEW, slots=SERVE_SLOTS, device="cuda"):
    """The requests through the port's ServeEngine, one host-clock time
    per step.  Returns (engine, requests, [(seconds, admitted, active)],
    (flash_attention, rg_lru_scan) launches, [(prompt length, last
    prefill logits)], peak device memory)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.models import model
    from repro_torch.serve import SamplerConfig, ServeEngine

    eng = ServeEngine(cfg, params, max_batch=slots, max_len=max_len,
                      scfg=SamplerConfig(temperature=0.0), device=device)
    last_logits = []
    real_prefill = model.prefill

    def prefill(params, batch, **kw):
        logits, cache = real_prefill(params, batch, **kw)
        last_logits.append((batch["inputs"].shape[1],
                            logits[0].float().cpu()))
        return logits, cache

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps = []
    fkernel.launches = 0
    lkernel.launches = 0
    with patched(model, "prefill", prefill):
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        while eng.queue or any(r is not None for r in eng.slot_req):
            queued = len(eng.queue)
            t = time.perf_counter()
            active = eng.step()
            steps.append((time.perf_counter() - t, queued - len(eng.queue),
                          active))
    launches = (fkernel.launches, lkernel.launches)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return eng, reqs, steps, launches, last_logits, peak


def report_serve(reqs, steps, launches, peak) -> float:
    """Print the serving metrics; returns the median steady step's
    seconds."""
    prefill_s = [r.t_first - r.t_admit for r in reqs]
    steady = [(sec, act) for sec, adm, act in steps if adm == 0]
    steady_s = sum(sec for sec, _ in steady)
    print(f"serve: {len(reqs)} requests x {reqs[0].max_new} new tokens, "
          f"prompts {[len(r.prompt) for r in reqs]}, {len(steps)} decode "
          f"steps ({len(steady)} steady): "
          f"ttft_long_s={reqs[0].t_first - reqs[0].t_submit:.4f} "
          f"(prompt {len(reqs[0].prompt)}) prefill_s="
          f"{[round(s, 4) for s in prefill_s]} prefill_tok_per_s="
          f"{sum(len(r.prompt) for r in reqs) / sum(prefill_s):.1f} "
          f"decode_tok_per_s_steady="
          f"{sum(act for _, act in steady) / steady_s:.1f} "
          f"steady_step_ms_median="
          f"{statistics.median(s for s, _ in steady) * 1e3:.3f} "
          f"max_memory_allocated={peak} launches flash_attention="
          f"{launches[0]} rg_lru_scan={launches[1]}")
    return statistics.median(sec for sec, _ in steady)


def check_serve(cfg, eng, reqs, steps, launches, max_new=MAX_NEW) -> None:
    for r in reqs:
        check(r.done and len(r.out) == max_new,
              f"request {r.rid} finished {r.done} with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"request {r.rid} has tokens outside the vocabulary")
    check(all(s is None for s in eng.slot_req), "a slot was not recycled")
    n_attn = cfg.n_groups * sum(s in "AL" for s in cfg.block_pattern)
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    want = (n_attn * len(reqs), n_rec * (len(reqs) + len(steps)))
    check(launches == want,
          f"launches (flash_attention, rg_lru_scan) {launches}, expected "
          f"{want} for {len(reqs)} prefills and {len(steps)} decode steps")


def check_logits(torch, cfg, params, prompts, last_logits,
                 max_len=SERVE_LEN) -> float:
    """The long prompts' last prefill logits against a reference prefill
    with both kernels swapped for their plain versions."""
    from repro_torch.models import model
    served = dict(last_logits)
    worst = 0.0
    dev = params["embed"]["w"].device
    for prompt in prompts[:len(LONG_PROMPTS)]:
        with plain_kernels(), torch.inference_mode():
            t = time.perf_counter()
            want, _ = model.prefill(
                params, {"inputs": torch.tensor([prompt], device=dev)},
                cfg=cfg, max_len=max_len)
            want = want[0].float().cpu()
            sec = time.perf_counter() - t
        got = served[len(prompt)]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        worst = max(worst, err / scale)
        print(f"serve: prompt {len(prompt)}: last logits vs the plain "
              f"reference max abs diff {err:.4e} (scale {scale:.4e}, "
              f"ratio {err / scale:.3e}, tolerance {LOGIT_TOL}); argmax "
              f"{int(got.argmax())} vs {int(want.argmax())}; reference "
              f"prefill {sec:.2f}s")
        check(err <= LOGIT_TOL * scale,
              f"prompt {len(prompt)}: served logits differ from the plain "
              f"reference by {err} (scale {scale})")
    return worst


def profile_decode(torch, eng, steady_s: float) -> None:
    """One more steady decode step over four short requests, under
    ``torch.profiler``: the device's busy time, its idle share against
    the served run's median steady step, and the largest consumers.  A
    measurement only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    for _ in range(eng.max_batch):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, 16).tolist(),
                   max_new=8)
    eng.step()                      # admit the four
    eng.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    eng.run()
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if not busy_ms:
        print("serve: profiled decode step: the profiler saw no device "
              "time; device busy share not measured")
        return
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    print(f"serve: profiled decode step ({eng.max_batch} active): device "
          f"busy {busy_ms:.3f} ms against a steady step of "
          f"{steady_s * 1e3:.3f} ms (idle share "
          f"{1 - busy_ms / (steady_s * 1e3):.3f}; the profiled step took "
          f"{wall * 1e3:.3f} ms); largest: "
          + "; ".join(f"{e.key[:50]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms"
                      for e in top))


def profile_prefill(torch, cfg, params, prompt, max_len=SERVE_LEN) -> None:
    """One more prefill of ``prompt`` (after a warm one) under
    ``torch.profiler``: the device's busy time against the host clock,
    and the device time of the largest kernels.  A measurement only: the
    checked run is over."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model
    dev = params["embed"]["w"].device
    batch = {"inputs": torch.tensor([prompt], device=dev)}
    with torch.inference_mode():
        model.prefill(params, batch, cfg=cfg, max_len=max_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            model.prefill(params, batch, cfg=cfg, max_len=max_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if not busy_ms:
        print("lm: profiled prefill: the profiler saw no device time; "
              "breakdown not measured")
        return
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    ours = {name: sum(e.self_device_time_total for e in on_card
                      if tag in e.key) / 1e3
            for name, tag in (("flash_attention", "flash_tc_kernel"),
                              ("rg_lru_scan", "lru_ring_kernel"))}
    print(f"lm: profiled prefill of {len(prompt)} tokens: {wall * 1e3:.3f} "
          f"ms on the host clock, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f}); "
          + " ".join(f"{name} {ms:.3f} ms ({ms / busy_ms:.3f})"
                     for name, ms in ours.items())
          + "; largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.self_device_time_total / 1e3 / busy_ms:.3f})"
                      for e in top))


# ------------------------------------------------------------ phase 8
def train_pcfg():
    """The training knobs of phase 8: full remat, the fused head."""
    from repro_torch.parallel.sharding import ParallelConfig
    return ParallelConfig(mesh=None, remat="full", fused_head=True,
                          head_chunk=HEAD_CHUNK)


def train_data(torch, tmp: Path, cfg, seed: int, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, n_tokens=None, device="cuda"):
    """A Sector cloud holding a synthetic corpus from ``seed`` (default:
    exactly one batch of ``batch`` x (``seq`` + 1) tokens, so every epoch
    is that batch); returns (client, dataset, pipeline)."""
    from repro_torch.data import (DataPipeline, SectorTokenDataset,
                                  write_synthetic_corpus)
    master, client = cloud(tmp)
    write_synthetic_corpus(client, "corpus/train.u32",
                           n_tokens or batch * (seq + 1), cfg.vocab_size,
                           seed=seed)
    ds = SectorTokenDataset(master, client, "corpus/train.u32", seq_len=seq)
    return client, ds, DataPipeline(ds, batch=batch, pcfg=train_pcfg(),
                                    device=device)


def scan_backward_phase(torch, captured):
    """(b): the scan's gradient through the kernel (the time-reversed
    recurrence) against autograd through the plain loop, on the captured
    first RG-LRU layer's ``a, b, h0`` with upstream gradients from a fixed
    seed; both timed."""
    from repro_torch.kernels.rg_lru_scan import ops, ref
    a, b, h0 = captured["scan"]
    gen = torch.Generator().manual_seed(19)
    up = torch.randn(a.shape, generator=gen).to(a.device)
    up_last = torch.randn(h0.shape, generator=gen).to(a.device)
    graphs = {}
    for name, fn in (("kernel", ops.rg_lru_scan), ("plain", ref.lru_scan_ref)):
        ins = [t.clone().requires_grad_() for t in (a, b, h0)]
        h, h_last = fn(*ins)
        graphs[name] = (h, h_last, ins)
    got, want = (torch.autograd.grad(graphs[n][:2], graphs[n][2],
                                     (up, up_last), retain_graph=True)
                 for n in ("kernel", "plain"))
    scale = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(worst <= SCAN_GRAD_TOL * scale,
          f"rg_lru_scan backward differs from autograd through the plain "
          f"loop by {worst} (scale {scale})")
    h = graphs["kernel"][0].detach()
    ms = timed_ms(torch, lambda: ops.rg_lru_scan_backward(a, h, h0, up,
                                                          up_last))
    h_p, hl_p, ins_p = graphs["plain"]
    plain = timed_ms(torch, lambda: torch.autograd.grad(
        (h_p, hl_p), ins_p, (up, up_last), retain_graph=True),
        warmup=1, runs=3)
    # reads a, h, g and h0, g_last; writes da, db and dh0
    n_bytes = 5 * a.nbytes + 3 * h0.nbytes
    bnd, by = bound_ms(n_bytes, 3 * a.numel())
    print(f"kernel rg_lru_scan backward {list(a.shape)}: time-reversed "
          f"kernel + elementwise ms={ms:.4f} bound_ms={bnd:.6f} ({n_bytes} "
          f"bytes; {ms / bnd:.2f}x the bound) plain autograd ms={plain:.4f} "
          f"max_abs_err={worst:.3e} (gradient scale {scale:.3e}, tolerance "
          f"{SCAN_GRAD_TOL} of it)")
    return row("rg_lru_scan_backward", worst, ms, plain, bnd, by)


def grad_check(torch, cfg, seed: int, batch, device="cuda") -> None:
    """(a): one step's loss and gradients by the kernel route against the
    same step with ``plain_kernels()``, on the same batch and
    parameters."""
    from repro_torch.models import model
    from repro_torch.train import step
    from repro_torch.utils.pytree import tree_flatten_with_paths
    params = model.init_params(cfg, torch.Generator().manual_seed(seed),
                               device)
    out = {}
    for route in ("kernel", "plain"):
        t = time.perf_counter()
        with (plain_kernels() if route == "plain"
              else contextlib.nullcontext()):
            (loss, _), grads = step._value_and_grad_accum(
                params, batch, cfg=cfg, pcfg=train_pcfg())
        out[route] = (float(loss), tree_flatten_with_paths(grads))
        print(f"train: gradient check, {route} route: loss "
              f"{out[route][0]:.6f} in {time.perf_counter() - t:.2f}s")
    worst_rel, worst_cos, worst_leaf = 0.0, 1.0, ""
    for (path, g), (_, w) in zip(out["kernel"][1], out["plain"][1]):
        g, w = g.double(), w.double()
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        cos = float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))
        if rel > worst_rel:
            worst_rel, worst_leaf = rel, path
        worst_cos = min(worst_cos, cos)
        check(rel <= GRAD_REL_TOL and cos >= GRAD_COS_MIN,
              f"gradient of {path}: kernel route against plain route "
              f"relative error {rel}, cosine {cos}")
    d_loss = abs(out["kernel"][0] - out["plain"][0])
    print(f"train: gradient check over {len(out['kernel'][1])} leaves: loss "
          f"diff {d_loss:.3e} (tolerance {TRAIN_LOSS_TOL}); worst relative "
          f"error {worst_rel:.3e} ({worst_leaf}; tolerance {GRAD_REL_TOL}), "
          f"worst cosine {worst_cos:.6f} (at least {GRAD_COS_MIN})")
    check(d_loss <= TRAIN_LOSS_TOL, f"loss by the kernel route "
          f"{out['kernel'][0]} against the plain route {out['plain'][0]}")


def train_path(torch, cfg, seed: int, tmp: Path, seq=TRAIN_SEQ,
               device="cuda"):
    """The port's ``Trainer`` on one batch repeated (a one-batch corpus in
    Sector): ``TRAIN_STEPS`` AdamW steps at the JAX package's default
    learning rate and warm-up.  Returns (trainer, history, (flash, scan,
    scan backward) launches, peak device memory)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
    client, _, pipe = train_data(torch, tmp, cfg, seed, seq=seq,
                                 device=device)
    t = time.perf_counter()
    # the checkpointer restores nothing here and never saves: zlib over
    # the 43 GB of full-width state would take minutes (check (d) makes
    # the round trip at the reduced config)
    trainer = Trainer(cfg, train_pcfg(),
                      TrainerConfig(steps=TRAIN_STEPS, ckpt_every=2 ** 62,
                                    log_every=1, seed=seed),
                      pipe, SectorCheckpointer(client, "train"),
                      device=device)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    print(f"train: Trainer built (parameters from --seed and the AdamW "
          f"state on {device}) in {time.perf_counter() - t:.2f}s")
    fkernel.launches = lkernel.launches = lkernel.backward_launches = 0
    hist = trainer.run(TRAIN_STEPS)
    launches = (fkernel.launches, lkernel.launches,
                lkernel.backward_launches)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    return trainer, hist, launches, peak


def report_train(cfg, hist, launches, peak, seq=TRAIN_SEQ) -> float:
    """Print each step's loss, grad norm, seconds and tokens/s; returns
    the median step's seconds."""
    tokens = TRAIN_BATCH * seq
    prev, secs = 0.0, []
    for rec in hist:
        secs.append(rec["wall_s"] - prev)
        prev = rec["wall_s"]
        print(f"train: step {rec['step']}: loss={rec['loss']:.6f} "
              f"nll={rec['nll']:.6f} grad_norm={rec['grad_norm']:.4f} "
              f"lr={rec['lr']:.3e} step_s={secs[-1]:.4f} "
              f"tokens_per_s={tokens / secs[-1]:.1f}")
    print(f"train: {cfg.name}, batch {TRAIN_BATCH} x "
          f"{seq}, remat full, fused head (chunk {HEAD_CHUNK}): "
          f"median step {statistics.median(secs):.4f}s "
          f"({tokens / statistics.median(secs):.1f} tokens/s), steps after "
          f"the first {[round(s, 4) for s in secs[1:]]}; "
          f"max_memory_allocated={peak}; launches a run of {len(hist)} "
          f"steps: flash_attention={launches[0]} rg_lru_scan={launches[1]} "
          f"rg_lru_scan backward={launches[2]}")
    return statistics.median(secs)


def check_train(cfg, hist, launches) -> None:
    """(c) the loss falls on the repeated batch, finite; (e) the exact
    launches: under full remat each attention layer's forward runs twice
    a step (forward, recompute) and each R layer's scan twice forward and
    once backward."""
    losses = [rec["loss"] for rec in hist]
    check(all(math.isfinite(x) for x in losses)
          and all(math.isfinite(rec["grad_norm"]) for rec in hist),
          f"training losses or grad norms not finite: {losses}")
    check(losses[-1] < losses[0],
          f"the loss did not fall on the repeated batch: {losses}")
    n_attn = cfg.n_groups * sum(s in "AL" for s in cfg.block_pattern)
    n_rec = cfg.n_groups * cfg.block_pattern.count("R")
    want = (2 * n_attn * len(hist), 2 * n_rec * len(hist),
            n_rec * len(hist))
    check(launches == want,
          f"training launches (flash_attention, rg_lru_scan, rg_lru_scan "
          f"backward) {launches}, expected {want}")


def profile_train_step(torch, trainer, step_s: float) -> None:
    """One more training step under ``torch.profiler``: device busy time,
    idle share against the median unprofiled step, device time by kernel.
    A measurement only: the checked run is over."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    if not busy_ms:
        print("train: profiled step: the profiler saw no device time; "
              "breakdown not measured")
        return
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]
    # device time by class of kernel, read from the kernels' names: the
    # first class whose tags a name holds takes it
    classes = (("flash_attention", ("flash_tc_kernel",)),
               ("rg_lru_scan", ("lru_ring_kernel", "lru_direct_kernel")),
               ("bf16 products (cuBLAS)", ("nvjet",)),
               ("float32 products", ("sgemm", "gemm_f32")),
               ("elementwise", ("elementwise_kernel",)),
               ("reductions", ("reduce_kernel",)),
               ("other", ("",)))
    by_class = dict.fromkeys((name for name, _ in classes), 0.0)
    for e in on_card:
        name = next(n for n, tags in classes if any(t in e.key for t in tags))
        by_class[name] += e.self_device_time_total / 1e3
    print(f"train: profiled step: {wall * 1e3:.3f} ms on the host clock, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f}; against the median step "
          f"{1 - busy_ms / (step_s * 1e3):.3f}); by class: "
          + "; ".join(f"{name} {ms:.3f} ms ({ms / busy_ms:.4f})"
                      for name, ms in by_class.items())
          + "; largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.self_device_time_total / 1e3 / busy_ms:.3f})"
                      for e in top))
    # the same device time by the host-side op that launched it
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    print("train: profiled step: device time by launching op: "
          + "; ".join(f"{e.key} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.self_device_time_total / 1e3 / busy_ms:.3f})"
                      for e in ops))


def time_adamw(torch, trainer) -> None:
    """The AdamW update alone on the full model's state, with CUDA events,
    from the gradients of one more forward and backward.  A measurement
    only: it takes one more optimizer step."""
    from repro_torch.train import optim, step
    from repro_torch.utils.pytree import tree_leaves
    _, grads = step._value_and_grad_accum(
        trainer.params, next(iter(trainer.pipeline)), cfg=trainer.cfg,
        pcfg=trainer.pcfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    optim.apply_updates(trainer.params, grads, trainer.opt, trainer.ocfg,
                        trainer.lr_fn)
    stop.record()
    stop.synchronize()
    n = sum(p.numel() for p in tree_leaves(trainer.params))
    print(f"train: AdamW update of {n} parameters: "
          f"{start.elapsed_time(stop):.3f} ms on the device, "
          f"{(time.perf_counter() - t) * 1e3:.3f} ms on the host clock")


def time_flash_backward(torch, cfg) -> None:
    """The flash Function's backward (the plain version recomputed row by
    row) at the training shape, once per attention layer a step."""
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator().manual_seed(23)
    B, T = TRAIN_BATCH, TRAIN_SEQ
    q, g = (torch.randn((B, T, cfg.n_heads, cfg.d_head), generator=gen)
            .to(torch.bfloat16).cuda() for _ in range(2))
    k, v = (torch.randn((B, T, cfg.n_kv_heads, cfg.d_head), generator=gen)
            .to(torch.bfloat16).cuda() for _ in range(2))
    ms = timed_ms(torch, lambda: ops.flash_attention_backward(
        q, k, v, g, causal=True, window=cfg.local_window), warmup=1, runs=5)
    n_attn = cfg.n_groups * sum(s in "AL" for s in cfg.block_pattern)
    print(f"train: flash_attention backward (plain recompute, row by row) "
          f"q {list(q.shape)} window {cfg.local_window}: {ms:.4f} ms a call, "
          f"{n_attn} a step: {n_attn * ms:.3f} ms a step")


def resume_check(torch, cfg, seed: int, tmp: Path, device="cuda") -> None:
    """(d): a Sector checkpoint round trip at ``cfg.reduced()`` on the
    card: a run saves at step 2, a new ``Trainer`` restores it (the tree
    bit-identical) and takes step 3, whose loss must equal step 3 of an
    uninterrupted run."""
    from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
    from repro_torch.utils.pytree import tree_leaves
    small = cfg.reduced()
    tcfg = TrainerConfig(steps=3, ckpt_every=2, log_every=1, lr=1e-3,
                         warmup=1, seed=seed)

    def trainer(sub, ckpt: bool):
        client, _, pipe = train_data(torch, tmp / sub, small, seed, seq=128,
                                     n_tokens=20_000, device=device)
        return Trainer(small, train_pcfg(), tcfg, pipe,
                       SectorCheckpointer(client, "r") if ckpt else None,
                       device=device), client

    whole, _ = trainer("whole", False)
    want = whole.run(3)[-1]["loss"]
    first, client = trainer("resume", True)
    first.run(2)
    again = Trainer(small, train_pcfg(), tcfg,
                    train_data(torch, tmp / "again", small, seed, seq=128,
                               n_tokens=20_000, device=device)[2],
                    SectorCheckpointer(client, "r"), device=device)
    check(again.step_idx == 2, f"restored step {again.step_idx}, not 2")
    check(again.pipeline.state_dict() == first.pipeline.state_dict(),
          "the restored data cursor differs")
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves({"p": first.params, "o": first.opt}),
        tree_leaves({"p": again.params, "o": again.opt})))
    check(same, "the restored tree is not bit-identical to the saved one")
    got = again.run(1)[-1]["loss"]
    print(f"train: checkpoint round trip ({small.name}, step 2 through "
          f"Sector): tree bit-identical; step-3 loss {got:.6f} against "
          f"{want:.6f} uninterrupted (diff {abs(got - want):.3e}, "
          f"tolerance {RESUME_LOSS_TOL})")
    check(abs(got - want) <= RESUME_LOSS_TOL,
          f"resumed step-3 loss {got} against {want}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=10_000_000)
    ap.add_argument("--points", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    # the plain versions run in full float32 (no TF32 matrix products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # phase 1: set-up
    t0 = time.perf_counter()
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    build_all(ROOT / "build" / "repro_torch")

    # phase 2: every kernel against its plain version on the card
    rows = {r["name"]: r for r in (dest_phase(torch), *partition_phase(torch),
                                   *assign_phase(torch))}
    print(f"kernels checked at {time.perf_counter() - t0:.1f}s")

    # phases 3-5: the paths, each counting only its own launches
    launches, rep, outs, data, order, bounds = terasort_path(
        torch, args.records, args.seed)
    want = check_terasort(launches, rep, outs, data, order)
    rows["bucket_dest"]["launches"] = launches
    del order, rep
    p_launches, calls, ids, hist, sorted_bytes = partition_path(torch, data,
                                                                bounds)
    check_partition(p_launches, calls, ids, hist, sorted_bytes, data, bounds,
                    outs, want)
    rows["bucket_partition_rows"]["launches"], \
        rows["bucket_partition"]["launches"] = p_launches
    del data, outs, want, ids, sorted_bytes
    print(f"terasort and partition paths done at "
          f"{time.perf_counter() - t0:.1f}s")
    k_launches, n_chunks, cents, k_rep, pts = kmeans_path(
        torch, args.points, args.seed)
    check_kmeans(k_launches, n_chunks, cents, k_rep, pts, args.seed)
    rows["kmeans_partials"]["launches"], rows["kmeans_assign"]["launches"] \
        = k_launches
    del cents, k_rep, pts
    torch.cuda.empty_cache()
    print(f"k-means path done at {time.perf_counter() - t0:.1f}s")

    # phase 6: the LM kernels on the full model's activations
    cfg, params = lm_model(torch, args.seed)
    prompts = serve_prompts(cfg, args.seed)
    captured = capture_activations(torch, cfg, params, prompts[0])
    with torch.inference_mode():
        rows["flash_attention"] = flash_phase(torch, captured)
        rows["rg_lru_scan"] = lru_phase(torch, captured)
    scan_inputs = {"scan": captured["scan"]}     # phase 8's (b)
    del captured
    torch.cuda.empty_cache()
    print(f"LM kernels checked at {time.perf_counter() - t0:.1f}s")

    # phase 7: serving
    eng, reqs, steps, lm_launches, last_logits, peak = serve_path(
        torch, cfg, params, prompts)
    check_serve(cfg, eng, reqs, steps, lm_launches)
    steady_s = report_serve(reqs, steps, lm_launches, peak)
    check_logits(torch, cfg, params, prompts, last_logits)
    profile_decode(torch, eng, steady_s)
    profile_prefill(torch, cfg, params, prompts[0])
    # the serving tensors were made for inference: training builds its own
    del eng, reqs, steps, last_logits, params
    torch.cuda.empty_cache()
    print(f"serving done at {time.perf_counter() - t0:.1f}s")

    # phase 8: training
    from repro_torch.data.dataset import Cursor
    rows["rg_lru_scan_backward"] = scan_backward_phase(torch, scan_inputs)
    del scan_inputs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        _, ds, _ = train_data(torch, tmp / "grad", cfg, args.seed)
        host, _ = next(ds.batches(TRAIN_BATCH, Cursor()))
        grad_check(torch, cfg, args.seed,
                   {k: torch.from_numpy(v).cuda() for k, v in host.items()})
        torch.cuda.empty_cache()
        time_flash_backward(torch, cfg)
        trainer, hist, t_launches, t_peak = train_path(torch, cfg, args.seed,
                                                       tmp / "train")
        check_train(cfg, hist, t_launches)
        step_s = report_train(cfg, hist, t_launches, t_peak)
        profile_train_step(torch, trainer, step_s)
        time_adamw(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
        resume_check(torch, cfg, args.seed, tmp / "resume")
    for name, by_path in (
            ("flash_attention", {"serve": lm_launches[0],
                                 "train": t_launches[0]}),
            ("rg_lru_scan", {"serve": lm_launches[1],
                             "train": t_launches[1]}),
            ("rg_lru_scan_backward", {"train": t_launches[2]})):
        rows[name]["launches"] = sum(by_path.values())
        rows[name]["launches_by_path"] = by_path
    # the k-means path runs the fused entry and the partition path the
    # rows entry; the ids and words entries, held and timed in phase 2,
    # are on no path
    for r in rows.values():
        check(r["launches"] > 0
              or r["name"] in ("kmeans_assign", "bucket_partition"),
              f"its path never launched {r['name']}")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
