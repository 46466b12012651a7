#!/usr/bin/env python3
"""Stage 0 of ``chip_smoke.py``'s phase 9(b) on gloo ranks sharing one card,
measured on the engine of a chosen source tree.

    python3 scripts/mesh_stage0.py [--src DIR] [--label NAME] [--out FILE]
                                   [--worlds 3 4] [--records N] [--seed S]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and runs this checkout's ``chip_smoke.stage0_rank`` on each world: the
TeraSort of a rank's own cloud of 2,000,000 records in 13 chunks, then
``kmeans_sphere`` over 12 x 2,097,152 points on the meshless engine and on
the mesh, measured and not checked.  To hold an older commit's engine
against this one in one call, unpack it into a directory that
``.gitignore`` lists (``git archive <commit> | tar -x -C build/parent``)
and run the script on both trees: parent, change, change, parent.

Prints one JSON line a world, with the card's name and power limit
(``nvidia-smi``), and appends it to ``--out`` when given:
for each rank the stage-0 chunks fetched and the plan's, the seconds of
the fetch spans and of ``exec:partition`` (host clock), the peak device
memory after stage 0 and over the TeraSort, the TeraSort wall, and the
k-means ``kmeans_partials`` launches, chunks fetched and walls.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summary(res: dict) -> dict:
    tera, km = res["terasort"], res["kmeans"]
    return {"fetched": len(tera["fetched"]), "plan": len(tera["plan"]),
            "fetch_s": tera["fetch_s"], "stage0_s": tera["stage0_s"],
            "peak_after_stage0": tera["peak0"], "peak": tera["peak"],
            "wall_s": tera["wall_s"], "sorted": tera["same"],
            "launches": tera["launches"],
            "km_chunks": km["chunks"],
            "km_launches": km["mesh"]["launches"][0],
            "km_fetched": len(km["mesh"]["fetched"]),
            "km_wall_s": km["mesh"]["wall_s"],
            "km_meshless_launches": km["meshless"]["launches"][0],
            "km_meshless_wall_s": km["meshless"]["wall_s"],
            "km_same_report": km["mesh"]["fields"] == km["meshless"]["fields"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worlds", type=int, nargs="+", default=[3, 4])
    ap.add_argument("--records", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]

    import torch
    if not torch.cuda.is_available():
        sys.exit("mesh_stage0: no CUDA device")
    import chip_smoke as cs
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        sys.exit(f"mesh_stage0: repro_torch came from {repro_torch.__file__}")
    from repro_torch.kernels.bucket_partition import kernel as bkernel
    from repro_torch.kernels.kmeans_assign import kernel as kkernel
    from repro_torch.launch.mesh import run_ranks
    # built here, before the ranks start, so they only load them
    bkernel.load_library()
    bkernel.load_partition_library()
    kkernel.load_library()
    card = cs.card_line()
    for world in args.worlds:
        t = time.perf_counter()
        res = run_ranks(cs.stage0_rank, world,
                        (args.seed, args.records,
                         cs.MESH_KM_CHUNKS * cs.ASSIGN_ROWS),
                        timeout_s=300, join_timeout_s=600)
        line = json.dumps({"tree": args.label or str(src), "world": world,
                           "card": card,
                           "seconds": time.perf_counter() - t,
                           "ranks": [summary(r) for r in res]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
