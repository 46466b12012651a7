#!/usr/bin/env python3
"""Probe the launch shape of ``bucket_partition.cu`` on one CUDA card.

    python3 scripts/probe_bucket_rows.py [--parent PATH] [--out DIR]

Builds the source once per variant of its launch shape — threads a
block (the source's ``kThreads``) and 4-byte or byte loads of the key
(byte loads: the source's alignment test patched to false) — each from a
patched copy under ``--out``, with one ``nvcc`` per variant, all started
together, then times both entries at
the partition path's shape (10,000,000 records of 100 bytes, a 10-byte
range key as k = 3 words, 6 buckets) and the rows entry under an 8-byte
hash key, each held exactly against its plain version.  ``--parent``
names an older ``bucket_partition.cu`` whose words entry (bn = 2048) is
timed beside them.  Times are ``chip_smoke.timed_ms`` (CUDA events,
median of 20).  Prints one line a variant and the card's name and power
limit; exits non-zero on a mismatch or without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/bucket_partition/csrc/bucket_partition.cu"
THREADS = re.compile(r"constexpr int kThreads = \d+;")
VEC_TEST = "reinterpret_cast<uintptr_t>(data) % 4 == 0 && width % 4 == 0"
# (threads, byte loads); the first is the source's own
VARIANTS = [(1024, 0), (128, 0), (256, 0), (512, 0), (1024, 1)]
L2_FETCH = 5                # CU_LIMIT_MAX_L2_FETCH_GRANULARITY
ROWS, WIDTH, KEY, N_BUCKETS = 10_000_000, 100, 10, 6


def variant(threads: int, byte_loads: int) -> str:
    """The source with its launch shape replaced; raises when the text it
    patches is not there."""
    text = SOURCE.read_text()
    text, found = THREADS.subn(f"constexpr int kThreads = {threads};", text)
    if found != 1 or text.count(VEC_TEST) != 1:
        raise RuntimeError(f"{SOURCE.name} no longer holds the kThreads "
                           f"constant and the alignment test it patches")
    return text.replace(VEC_TEST, "false") if byte_loads else text


def build(src: Path, out: Path, text=None) -> Path:
    """Builds ``src``, or ``text`` written beside the library in ``out``
    (``src``'s directory stays on the include path), into ``out``."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    if text is not None:
        (out / src.name).write_text(text)
    lib = out / "libprobe.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                           "-I", str(src.parent), "-o", str(lib),
                           str(out / src.name if text is not None else src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stderr}")
    return lib


def bind(path: Path, rows_entry: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.bucket_partition_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    if rows_entry:
        lib.bucket_partition_rows_launch.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def l2_fetch(value=None) -> int:
    """The current context's L2 fetch granularity hint in bytes, first set
    to ``value`` when given (``cuCtxSetLimit`` of ``libcuda``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuCtxSetLimit.argtypes = [ctypes.c_int, ctypes.c_size_t]
    cuda.cuCtxGetLimit.argtypes = [ctypes.POINTER(ctypes.c_size_t),
                                   ctypes.c_int]
    if value is not None:
        chip_smoke.check(cuda.cuCtxSetLimit(L2_FETCH, value) == 0,
                         f"cuCtxSetLimit({value}) failed")
    got = ctypes.c_size_t()
    chip_smoke.check(cuda.cuCtxGetLimit(ctypes.byref(got), L2_FETCH) == 0,
                     "cuCtxGetLimit failed")
    return got.value


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "probe")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    from repro_torch.convert import bounds_from_numpy
    from repro_torch.core import shuffle
    from repro_torch.core.records import key_rows_of
    from repro_torch.kernels.bucket_partition import kernel, ref
    print(chip_smoke.card_line())

    jobs = {v: (SOURCE, args.out / "t{}_b{}".format(*v), variant(*v))
            for v in VARIANTS}
    if args.parent is not None:
        jobs["parent"] = (args.parent, args.out / "parent")
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    data = torch.randint(0, 256, (ROWS, WIDTH), generator=gen,
                         dtype=torch.uint8, device=dev)
    sample = sorted(bytes(r) for r in data[:100_000, :KEY].cpu().numpy())
    part = shuffle.range_partitioner(
        shuffle.sample_boundaries(sample, N_BUCKETS, KEY))
    spec, bwords = part._word_spec(WIDTH)
    bounds = bounds_from_numpy(bwords).to(dev)
    keys = key_rows_of(data, KEY, n_words=3).contiguous()
    hash_spec = ("hash", 8)
    hbounds = bounds_from_numpy(
        shuffle.uniform_hash_bounds(N_BUCKETS)).to(dev)[:, None].contiguous()
    cases = {"range": (spec, bounds), "hash": (hash_spec, hbounds)}
    want = {name: ref.bucket_partition_rows_ref(data, s, b, N_BUCKETS)
            for name, (s, b) in cases.items()}
    ids = torch.empty(ROWS, dtype=torch.int32, device=dev)
    hist = torch.empty(N_BUCKETS, dtype=torch.int32, device=dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def words(lib, bn):
        err = lib.bucket_partition_launch(
            keys.data_ptr(), bounds.data_ptr(), ids.data_ptr(),
            hist.data_ptr(), ROWS, 3, N_BUCKETS - 1, N_BUCKETS, bn, stream())
        chip_smoke.check(err == 0, f"words launch failed: {err}")

    def rows(lib, name):
        s, b = cases[name]
        hash_, kb, nkw, k, length = kernel.key_layout(s, WIDTH)
        err = lib.bucket_partition_rows_launch(
            data.data_ptr(), WIDTH, hash_, kb, nkw, k, length, b.data_ptr(),
            ids.data_ptr(), hist.data_ptr(), ROWS, b.shape[0], N_BUCKETS, 0,
            stream())
        chip_smoke.check(err == 0, f"rows launch failed: {err}")

    def same(name, what):
        torch.cuda.synchronize()
        w = want[name]
        chip_smoke.check(torch.equal(ids, w[0]) and torch.equal(hist, w[1]),
                         f"{what} differs from the plain version ({name})")

    for v, path in libs.items():
        if v == "parent":
            lib = bind(path, False)
            words(lib, 2048)
            same("range", "parent words entry")
            ms = chip_smoke.timed_ms(torch, lambda: words(lib, 2048))
            print(f"probe parent words entry [{ROWS}, 3]: words_ms={ms:.4f}")
            continue
        lib = bind(path, True)
        words(lib, 0)
        same("range", f"words entry {v}")
        t_words = chip_smoke.timed_ms(torch, lambda: words(lib, 0))
        times = {}
        for name in cases:
            rows(lib, name)
            same(name, f"rows entry {v}")
            times[name] = chip_smoke.timed_ms(torch, lambda: rows(lib, name))
        print(f"probe threads={v[0]} byte_loads={v[1]}: "
              f"rows_range_ms={times['range']:.4f} "
              f"rows_hash_ms={times['hash']:.4f} words_ms={t_words:.4f}")

    # the rows entry of the first variant under each L2 fetch granularity
    lib = bind(libs[VARIANTS[0]], True)
    default = l2_fetch()
    for value in (32, 64, 128, default):
        got = l2_fetch(value)
        ms = chip_smoke.timed_ms(torch, lambda: rows(lib, "range"))
        same("range", f"rows entry at L2 fetch {got}")
        print(f"probe {VARIANTS[0]} L2 fetch granularity {got} B (default "
              f"{default}): rows_range_ms={ms:.4f}")


if __name__ == "__main__":
    main()
