"""llava-next-mistral-7b — VLM: Mistral-7B backbone + anyres patch frontend stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified tier]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Per the assignment the modality frontend is a STUB: ``input_specs()``
provides precomputed anyres patch embeddings (2880 positions =
24x24 base grid x 5 anyres tiles) which the backbone scatters into the
token-embedding stream at the given positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    block_pattern=("A",),
    act="silu",
    frontend="vision_patches",
    frontend_positions=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    notes="Backbone only; anyres vision tower stubbed to patch embeddings.",
)
