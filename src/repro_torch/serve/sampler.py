"""Token sampling: greedy / temperature / top-k (the port of
``repro.serve.sampler``), with randomness from a ``torch.Generator``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = full softmax


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           scfg: SamplerConfig) -> torch.Tensor:
    """logits: [B, V] -> tokens [B] int32.  ``generator`` lives on the
    logits' device; greedy decoding does not use it."""
    if scfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lf = logits.float() / scfg.temperature
    if scfg.top_k:
        kth = torch.topk(lf, scfg.top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, -1e30), lf)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)
