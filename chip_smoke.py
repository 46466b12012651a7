#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--records N] [--seed S]

Three phases; any failure exits non-zero and nothing is caught and
passed over.

1. **Set-up.**  Prints the card's name and power limit as
   ``nvidia-smi`` reports them, then builds every CUDA kernel of the main
   path from the sources in this checkout (a fresh ``nvcc`` build) and
   prints the build seconds and ``ptxas``'s register report.
2. **Kernels.**  Holds the CUDA ``bucket_dest`` kernel, and the
   ``bucket_dest`` / ``bucket_scatter`` entry points built on it, against
   the plain PyTorch version on the card — exact equality of ids, ranks,
   block histograms, destinations and scattered bytes — on the cases the
   CPU tests cover, at the main path's shape ``[16, 655360]`` (k=3,
   6 buckets) and with 64 buckets.  At the main-path shape it times the
   kernel and the plain version (CUDA events, median of 20 runs after 3
   warm-ups) beside the least time the card could take.
3. **Main path.**  TeraSort through the port's ``SphereEngine`` on CUDA:
   ``--records`` 100-byte records (default 10,000,000, 1.0 GB) with random
   10-byte keys and payload from ``--seed``, uploaded to Sector in
   record-aligned 64 MB chunks (640,000 records), replication 3, one
   chunk server per Teraflow site; 6 buckets from ``sample_boundaries``.
   The outputs, concatenated in worker order, must be byte-identical to
   a numpy oracle (a stable lexsort of the keys, which must have no
   ties); the kernel's launch count must rise by exactly one per shuffle
   round, with one host sync per round.

The line before the last is one JSON object describing every kernel of
the path; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the rest of the repository beside this
script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RECORD, KEY = 100, 10
CHUNK_RECORDS = 640_000                 # 64,000,000-byte chunks
N_BUCKETS = 6
MAIN_SLOTS, MAIN_ROWS = 16, 655_360     # the stage-0 stack at 10M records
# H100 SXM data-sheet peaks (NVIDIA): HBM bandwidth, and the 32-bit
# non-tensor rate used as the ceiling for the kernel's integer compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/kernels/bucket_partition/csrc/bucket_dest.cu"
REPLACES = "src/repro/kernels/bucket_partition/kernel.py:138"


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
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int):
    """(least time in ms, what bounds it) for moving ``n_bytes`` through
    device memory and doing ``n_ops`` 32-bit operations."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2
def kernel_phase(torch, modules):
    from repro_torch.convert import bounds_from_numpy
    kernel, ops, ref, shuffle = modules
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
            check(err == 0, f"kernel {name} differs from the plain version "
                            f"(n_out={n_out}, bn={bn}, max err {err})")
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
    keys = shuffle._extract_keys(data, spec).contiguous()
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
    keys = shuffle._extract_keys(data, spec).contiguous()
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
          f"plain_ms={plain_ms:.4f} "
          f"check_launches={kernel.launches} cases={n_cases} "
          f"max_abs_err={worst}")
    print(f"bucket_scatter (kernel + epilogue + row move) "
          f"[{MAIN_SLOTS}, {MAIN_ROWS}, {RECORD}]: scatter_ms="
          f"{scatter_ms:.4f} bound_ms={s_bound:.4f} ({s_bytes} bytes)")
    return {"name": "bucket_dest", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "launches": None, "max_abs_err": worst,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": None}


# ------------------------------------------------------------ phase 3
def main_path(torch, kernel, n_records: int, seed: int) -> None:
    from repro_torch.core import SphereEngine, SphereJob
    from repro_torch.core.shuffle import sample_boundaries, terasort_stages
    from repro_torch.core.trace import Tracer
    from repro_torch.sector import ChunkServer, SectorClient, SectorMaster

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
    print(f"main: data + oracle {time.perf_counter() - t:.2f}s")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        master = SectorMaster(chunk_size=CHUNK_RECORDS * RECORD)
        for i, site in enumerate(master.topology.sites):
            master.register(ChunkServer(f"s{i}", site, tmp))
        master.acl.add_member("u")
        master.acl.grant_write("u")
        client = SectorClient(master, "u", "chicago")
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
        engine = SphereEngine(master, client, device="cuda",
                              timing_sync=True, tracer=tracer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.launches = 0
        t = time.perf_counter()
        outs, rep = engine.run(job)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = kernel.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    check(rep.shuffle_rounds >= 1, "the job ran no shuffle round")
    check(launches == rep.shuffle_rounds,
          f"bucket_dest launched {launches} times for "
          f"{rep.shuffle_rounds} shuffle rounds")
    check(rep.host_syncs == rep.shuffle_rounds,
          f"host_syncs {rep.host_syncs} != shuffle_rounds "
          f"{rep.shuffle_rounds}")
    check(len(outs) == N_BUCKETS, f"{len(outs)} output partitions")
    t = time.perf_counter()
    got = b"".join(outs)
    check(len(got) == data.nbytes, f"{len(got)} output bytes, expected "
                                   f"{data.nbytes}")
    check(got == data[order].tobytes(),
          "sorted output differs from the numpy oracle")
    print(f"main: check {time.perf_counter() - t:.2f}s")
    print(f"main: TeraSort {n_records} records x {RECORD} B: "
          f"upload_s={upload_s:.3f} run_wall_s={wall_s:.3f} "
          f"partition_seconds={rep.partition_seconds:.4f} "
          f"rec_per_s={n_records / wall_s:.0f} "
          f"sim_seconds={rep.sim_seconds:.3f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"shuffle_rounds={rep.shuffle_rounds} host_syncs={rep.host_syncs} "
          f"device_dispatches={rep.device_dispatches} "
          f"udf_traces={rep.udf_traces} launches={launches}")
    # where the host clock went: wall seconds per span name.  Device work
    # is asynchronous, so it lands in the span that waits for it (the
    # shuffle round's histogram copy, the outputs' copy to the host).
    totals: dict = {}
    for sp in tracer.snapshot():
        if sp.kind == "span" and sp.clock == "wall":
            totals[sp.name] = totals.get(sp.name, 0.0) + sp.wall_seconds
    print("main: host-clock spans (s): " + " ".join(
        f"{name}={sec:.4f}" for name, sec in sorted(totals.items())))
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import shuffle
    from repro_torch.kernels.bucket_partition import kernel, ops, ref

    # phase 1: set-up
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    build_dir = ROOT / "build" / "repro_torch"
    shutil.rmtree(build_dir, ignore_errors=True)
    t = time.perf_counter()
    lib = kernel.build(build_dir)
    kernel.load_library(build_dir)
    print(f"build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t:.2f}s")
    print((lib.parent / "build.log").read_text().strip())

    # phase 2: every kernel against its plain version on the card
    row = kernel_phase(torch, (kernel, ops, ref, shuffle))

    # phase 3: the main path, counting only its own launches
    row["launches"] = main_path(torch, kernel, args.records, args.seed)
    check(row["launches"] > 0, "the main path never launched bucket_dest")

    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
