"""qwen3-moe-30b-a3b — MoE, 128 experts top-8, fine-grained experts.

[hf:Qwen/Qwen3-30B-A3B; hf-verified] 48L d_model=2048 32H (GQA kv=4)
per-expert d_ff=768, vocab=151936, 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=0,  # every FFN is MoE
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=("A",),
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    act="silu",
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="Fine-grained 128-expert MoE; q_dim=4096 from d_model=2048 "
    "(head_dim decoupled). Sphere-shuffle == MoE all_to_all dispatch.",
)
