"""deepseek-7b — llama-architecture dense decoder-only.

[arXiv:2401.02954; hf-verified] 30L d_model=4096 32H (kv=32, i.e. MHA)
d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10000.0,
    block_pattern=("A",),
    act="silu",
    source="arXiv:2401.02954",
    notes="LLaMA architecture; full MHA (kv=32).",
)
