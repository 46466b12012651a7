"""dbrx-132b — MoE, 16 experts top-4, fine-grained.

[hf:databricks/dbrx-base; unverified tier] 40L d_model=6144 48H (GQA kv=8)
per-expert d_ff=10752 vocab=100352, 16 experts top-4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab_size=100352,
    rope_theta=500_000.0,
    block_pattern=("A",),
    n_experts=16,
    top_k=4,
    moe_d_ff=10752,
    act="silu",
    source="hf:databricks/dbrx-base",
    notes="Largest assigned arch (~132B total, ~36B active).",
)
