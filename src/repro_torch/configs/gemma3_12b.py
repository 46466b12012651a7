"""gemma3-12b — dense with 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family; unverified tier]
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
Pattern unit: 5 local sliding-window layers then 1 global layer.
Gemma3 uses d_head=256 (not d_model/n_heads) per the public config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab_size=262144,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    local_window=1024,
    block_pattern=("L", "L", "L", "L", "L", "A"),
    act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    source="hf:google/gemma-3-12b-pt (shape per assignment)",
    notes="5:1 local:global; qk-norm; GeGLU; tied + scaled embeddings; "
    "long_500k runnable (only 1/6 layers keep a full KV cache).",
)
