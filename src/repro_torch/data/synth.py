"""Synthetic token corpora written into Sector.

Deterministic zipfian token streams with planted n-gram structure (so a
~100M-param model trained for a few hundred steps shows a real loss drop,
not just noise).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sector.client import SectorClient


def synthetic_tokens(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # zipfian unigrams
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n_tokens, p=probs).astype(np.uint32)
    # plant deterministic bigram structure: after token t comes (t*7+3)%vocab
    # with 50% probability — gives the model something learnable.
    follow = (np.arange(vocab, dtype=np.uint64) * 7 + 3) % vocab
    mask = rng.random(n_tokens) < 0.5
    toks[1:][mask[1:]] = follow[toks[:-1][mask[1:]]].astype(np.uint32)
    return toks


def write_synthetic_corpus(client: SectorClient, name: str, n_tokens: int,
                           vocab: int, seed: int = 0,
                           replication: int = 2) -> int:
    toks = synthetic_tokens(n_tokens, vocab, seed)
    client.upload(name, toks.tobytes(), replication=replication)
    return n_tokens
