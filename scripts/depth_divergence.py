#!/usr/bin/env python3
"""How far two roundings of one model part by the end of its stack, by depth.

    PYTHONPATH=src python scripts/depth_divergence.py

On the CPU (where the attention is the plain version), a few minutes.
The port's LM stacks at random weights (``model.init_params`` from seed
0), cut in width (d_model 256) and run at several depths:

- ``xlstm-1.3b`` in float32: the full forward's logits at row S-2 against
  a prefill of S-1 tokens (chunks of 256 against chunks of one token: the
  same arithmetic in another order), S = 64;
- ``qwen3-moe-30b-a3b`` (16 experts, top-4) and ``qwen2.5-3b`` in bf16:
  the last prefill logits of a 512-token prompt with the plain attention
  (p in float32) against the same model whose attention rounds p to bf16
  as the bf16 flash kernel does (``chip_smoke.attention_rounded_p``).

Each line prints the largest difference over the largest magnitude.  What
grows with depth is the stack's own sensitivity to rounding, not an error
of either route: it says how deep an end-to-end comparison of two
roundings can go before it measures the random weights.

    python3 scripts/depth_divergence.py --card

On one CUDA card (the kernels built as ``chip_smoke.py`` builds them),
about three minutes: the same question for gradients, at full width and
from seed 0, read and not held (every check only prints):

- ``xlstm-1.3b``'s first pattern unit in float32, card against CPU
  (``chip_smoke.xlstm_card_check``) on one row of 8 to 512 tokens;
- one bf16 step of ``seamless-m4t-large-v2`` (2 x 3,072 tokens and
  frames) at 1, 4 and 24 layers and ``llava-next-mistral-7b`` (with
  patches) at 1, 4 and 12: the flash kernel's route against
  ``chip_smoke.tile_p_attention`` (a plain version rounding p as the
  kernel does), and at the deepest also against ``plain_kernels()``
  (``chip_smoke.grad_check``).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import model  # noqa: E402


def ratio(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / a.abs().max())


def tokens(n: int, vocab: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (1, n)).astype(np.int32)).to(device)


def xlstm_drift(depth: int, device, S: int = 64) -> float:
    cfg = get_config("xlstm-1.3b").replace(
        n_layers=depth, d_model=256, n_heads=4, n_kv_heads=4, d_head=64,
        vocab_size=512, param_dtype="float32", compute_dtype="float32")
    p = model.init_params(cfg, torch.Generator().manual_seed(0), device)
    toks = tokens(S, cfg.vocab_size, device)
    with torch.inference_mode():
        full, _ = model.forward(p, {"inputs": toks}, cfg=cfg)
        last, _ = model.prefill(p, {"inputs": toks[:, :S - 1]}, cfg=cfg,
                                max_len=S)
    return ratio(full[:, S - 2], last)


def rounded_p_drift(arch: str, depth: int, device, T: int = 512) -> float:
    kw = dict(n_layers=depth, d_model=256, n_heads=8, n_kv_heads=2,
              d_head=32, vocab_size=512)
    if arch == "qwen3-moe-30b-a3b":
        kw.update(n_experts=16, top_k=4, moe_d_ff=128)
    else:
        kw.update(d_ff=512)
    cfg = get_config(arch).replace(**kw)
    p = model.init_params(cfg, torch.Generator().manual_seed(0), device)
    toks = tokens(T, cfg.vocab_size, device)

    def rounded(q, k, v, *, causal, window):
        return chip_smoke.attention_rounded_p(torch, q, k, v, causal,
                                              window).to(q.dtype)

    with torch.inference_mode():
        plain, _ = model.prefill(p, {"inputs": toks}, cfg=cfg, max_len=T)
        with chip_smoke.patched(flash_ops, "flash_attention", rounded):
            other, _ = model.prefill(p, {"inputs": toks}, cfg=cfg, max_len=T)
    return ratio(plain, other)


def card_readings() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    chip_smoke.check = lambda cond, msg: None    # readings, not checks
    print(chip_smoke.card_line(), flush=True)
    chip_smoke.build_all(ROOT / "build" / "repro_torch")
    for seq in (8, 16, 32, 64, 128, 512):
        chip_smoke.xlstm_card_check(torch, get_config("xlstm-1.3b"), 0,
                                    seq=seq)
    for arch, depths in (("seamless-m4t-large-v2", (1, 4, 24)),
                         ("llava-next-mistral-7b", (1, 4, 12))):
        for depth in depths:
            cfg = chip_smoke.family_depth(get_config(arch), depth)
            batch = chip_smoke.family_batch(torch, cfg, 0)
            refs = [chip_smoke.tile_p_attention]
            if depth == depths[-1]:
                refs.append(chip_smoke.plain_kernels)
            for ref in refs:
                chip_smoke.grad_check(torch, cfg, 0, batch, reference=ref,
                                      label=f"{arch} bf16 {depth} layers")
            del batch
            chip_smoke.fresh_card(torch, "depth_divergence")


def main() -> None:
    if sys.argv[1:] == ["--card"]:
        card_readings()
        return
    dev = torch.device("cpu")
    for depth in (8, 16, 48):
        print(f"xlstm-1.3b float32, {depth} layers: forward vs prefill "
              f"{xlstm_drift(depth, dev):.3e}", flush=True)
    for arch in ("qwen3-moe-30b-a3b", "qwen2.5-3b"):
        for depth in (1, 4, 12, 48):
            print(f"{arch} bf16, {depth} layers: plain vs rounded-p "
                  f"attention {rounded_p_drift(arch, depth, dev):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
