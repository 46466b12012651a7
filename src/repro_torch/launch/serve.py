"""Serving launcher: continuous-batching engine over a slot pool.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --smoke --device cpu
    python -m repro_torch.launch.serve --arch llava-next-mistral-7b
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b

Every config runs: the ``A`` / ``L`` / ``R`` / ``m`` / ``s`` layers, dense
or MoE FFNs, the encoder-decoder (its requests carry no frames, so the
engine feeds zeros, as the JAX engine does) and the vision backbone
(text prompts: the engine splices no patches, nor does the JAX
engine).  The port of ``repro.launch.serve``, with the same flags plus
``--device`` (default CUDA, which raises without a card).  ``--smoke``
runs the config's reduced twin; without it the full config runs on one
device, with no mesh.  Parameters are random from seed 0, as the JAX
launcher makes them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.serve import SamplerConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(mesh=None)

    params = model.init_params(cfg, torch.Generator().manual_seed(0), device)
    eng = ServeEngine(cfg, params, pcfg, max_batch=args.max_batch,
                      max_len=args.max_len,
                      scfg=SamplerConfig(temperature=args.temperature,
                                         top_k=40),
                      device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, min(32, args.max_len // 2)))
        prompt = list(rng.integers(0, cfg.vocab_size, plen))
        reqs.append(eng.submit(prompt, max_new=args.max_new))
    eng.run()
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in reqs)
    for r in reqs[:4]:
        print(f"req {r.rid}: prompt_len={len(r.prompt)} -> {r.out[:8]}...")
    print(f"{len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, continuous batching over "
          f"{args.max_batch} slots on {device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
