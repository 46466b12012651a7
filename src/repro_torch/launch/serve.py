"""Serving launcher: continuous-batching engine over a slot pool.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b --smoke --device cpu
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --smoke --device cpu
    python -m repro_torch.launch.serve --arch llava-next-mistral-7b
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke --device cpu --ranks 4

Every config runs: the ``A`` / ``L`` / ``R`` / ``m`` / ``s`` layers, dense
or MoE FFNs, the encoder-decoder (its requests carry no frames, so the
engine feeds zeros, as the JAX engine does) and the vision backbone
(text prompts: the engine splices no patches, nor does the JAX
engine).  The port of ``repro.launch.serve``, with the same flags plus
``--device`` (default CUDA, which raises without a card) and
``--ranks``.  ``--smoke`` runs the config's reduced twin.  Parameters
are random from seed 0, as the JAX launcher makes them.

Without ``--ranks`` the config runs on one device, with no mesh.  The
JAX launcher serves a full config on its production mesh; here
``--ranks N`` (even) serves on a mesh of ``N`` ranks started by
``launch.mesh.run_ranks`` (gloo; on one card, ranks sharing it stage
their collectives through the host) at ``(data, model) = (N / 2, 2)``,
``layout="tp"``: ``--ranks 2`` is ``(1, 2)``, ``--ranks 4`` is ``(2,
2)``.  Each rank makes only its blocks of the parameters, and the
engine serves on them (``serve/engine.py``); every config serves there
(``train/step.py`` ``check_serving_mesh``).  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_compat, run_ranks
from repro_torch.models import model
from repro_torch.parallel import sharded
from repro_torch.parallel.sharding import ParallelConfig, param_specs_for
from repro_torch.serve import SamplerConfig, ServeEngine
from repro_torch.utils.pytree import tree_flatten_with_paths


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of a serving mesh, even: (data, model) = "
                         "(ranks / 2, 2), layout tp (default 1: one "
                         "device, no mesh)")
    return ap


def _serve(args, mesh=None) -> dict:
    """One process's run: on ``mesh`` (this rank's) or one device."""
    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(mesh=mesh)
    keep = None
    if mesh is not None:       # each leaf's block, as it is made
        specs = dict(tree_flatten_with_paths(
            param_specs_for(model.param_shapes(cfg), pcfg)))

        def keep(path, x):
            return sharded.local_block(x, specs[path], mesh)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device,
                               keep=keep)
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
    return {"dt": time.time() - t0, "device": str(device),
            "reqs": [(r.rid, len(r.prompt), list(r.out)) for r in reqs]}


def _serve_rank(rank: int, world: int, argv) -> dict:
    """A rank of a mesh run (``run_ranks``)."""
    args = _parser().parse_args(argv)
    mesh = make_mesh_compat((world // 2, 2), ("data", "model"),
                            device=args.device)
    return _serve(args, mesh)


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.ranks > 1:
        if args.ranks % 2:
            raise SystemExit(f"--ranks {args.ranks}: the serving mesh is "
                             f"(ranks / 2, 2), so ranks must be even")
        argv = sys.argv[1:] if argv is None else list(argv)
        out = run_ranks(_serve_rank, args.ranks, (argv,), timeout_s=600,
                        join_timeout_s=3600)[0]
        where = (f"a ({args.ranks // 2}, 2) (data, model) mesh of "
                 f"{args.ranks} ranks, layout tp, on {out['device']}")
    else:
        out = _serve(args)
        where = out["device"]
    reqs, dt = out["reqs"], out["dt"]
    total_new = sum(len(o) for _, _, o in reqs)
    for rid, plen, o in reqs[:4]:
        print(f"req {rid}: prompt_len={plen} -> {o[:8]}...")
    print(f"{len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, continuous batching over "
          f"{args.max_batch} slots on {where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
