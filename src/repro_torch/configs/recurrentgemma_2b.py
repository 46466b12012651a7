"""recurrentgemma-2b — RG-LRU recurrent blocks + local attention.

[arXiv:2402.19427 (Griffin); hf-verified] 26L d_model=2560 10H (MQA kv=1)
d_ff=7680 vocab=256000.

Griffin/RecurrentGemma interleaves two RG-LRU residual blocks with one
local-MQA block (recurrent:attention = 2:1) and ends the stack on recurrent
blocks. 26 layers do not factor into (R,R,A) units exactly, so we scan
2 groups of a 13-layer unit with 9 R + 4 A per unit (attention every third
block, recurrent tail) — 18 R : 8 A overall, preserving the published ~2:1
ratio and tail placement while keeping the HLO scan-compact.
"""
from repro_torch.configs.base import ModelConfig

_UNIT = ("R", "R", "L", "R", "R", "L", "R", "R", "L", "R", "R", "L", "R")

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid-rglru",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab_size=256000,
    rope_theta=10000.0,
    local_window=2048,
    block_pattern=_UNIT,
    lru_width=2560,
    conv1d_width=4,
    act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2402.19427",
    notes="RG-LRU + local MQA (window 2048); bounded decode state -> "
    "long_500k runnable. 'L' layers are local sliding-window MQA.",
)
