"""qwen3-8b — dense decoder-only with qk_norm, GQA kv=8.

[hf:Qwen/Qwen3-8B; hf-verified] 36L d_model=4096 32H (GQA kv=8)
d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=("A",),
    act="silu",
    source="hf:Qwen/Qwen3-8B",
    notes="qk-norm (per-head RMSNorm on q and k), no QKV bias.",
)
