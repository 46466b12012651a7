"""Training launcher.

    python -m repro_torch.launch.train --arch recurrentgemma-2b --steps 3
    python -m repro_torch.launch.train --arch qwen2.5-3b --smoke --device cpu

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default CUDA, which raises without a card).  ``--smoke`` runs the
config's reduced twin without remat; without it the full config runs
with full remat, on one device.  The driver stands up a complete
wide-area deployment in-process: Sector servers at every testbed site, a
synthetic corpus uploaded through the cloud, the locality-aware data
pipeline, Sector-replicated checkpoints, and the Sphere-staged train
step.  ``--multi-pod``, ``--mode podwise`` and a ``--compress`` other
than ``none`` need a mesh and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.configs import get_config, list_archs
from repro_torch.data import (DataPipeline, SectorTokenDataset,
                              write_synthetic_corpus)
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.sector import ChunkServer, SectorClient, SectorMaster
from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
from repro_torch.train.step import MESH_QUEUE


def build_cloud(root: str, chunk_size: int = 256 * 1024,
                n_servers: int = 6):
    """A Sector master with ``n_servers`` chunk servers over the testbed
    sites, storing under ``root``, and a client with write access."""
    master = SectorMaster(chunk_size=chunk_size)
    sites = master.topology.sites
    for i in range(n_servers):
        master.register(ChunkServer(f"s{i}", sites[i % len(sites)], root))
    master.acl.add_member("trainer")
    master.acl.grant_write("trainer")
    client = SectorClient(master, "trainer", "chicago")
    return master, client


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tokens", type=int, default=2_000_000)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="pjit", choices=["pjit", "podwise"])
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.multi_pod or args.mode != "pjit" or args.compress != "none":
        raise NotImplementedError(
            f"--multi-pod, --mode podwise and --compress {MESH_QUEUE}")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(mesh=None, remat="none" if args.smoke else "full")

    with tempfile.TemporaryDirectory(prefix="sector_") as root:
        master, client = build_cloud(root)
        write_synthetic_corpus(client, "corpus/train.u32", args.tokens,
                               cfg.vocab_size)
        ds = SectorTokenDataset(master, client, "corpus/train.u32",
                                seq_len=args.seq)
        pipe = DataPipeline(ds, batch=args.batch, pcfg=pcfg, device=device)
        ckpt = SectorCheckpointer(client, f"{args.arch}-train")
        tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                             log_every=max(args.steps // 10, 1), lr=args.lr)
        trainer = Trainer(cfg, pcfg, tcfg, pipe, ckpt, device=device)
        hist = trainer.run()
        for rec in hist:
            print(f"step {rec['step']:5d} loss={rec['loss']:.4f} "
                  f"lr={rec['lr']:.2e} gnorm={rec['grad_norm']:.2f} "
                  f"wall={rec['wall_s']:.1f}s")
        print(f"data locality: {ds.locality_fraction:.2f}; "
              f"sector stats: {master.stats()}; device: {device}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hist, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
