"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio frontend stub).

[arXiv:2308.11596; hf-verified] 24L (decoder) d_model=1024 16H (kv=16, MHA)
d_ff=8192 vocab=256206; encoder is 24L as well.

The speech frontend (conformer feature extractor) is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings
[B, S_frames, d_model] fed straight to the text/unit encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio-encdec",
    n_layers=24,            # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10000.0,
    block_pattern=("A",),
    is_encoder_decoder=True,
    n_enc_layers=24,
    act="gelu",
    frontend="audio_frames",
    frontend_positions=0,   # the whole encoder input is frames
    source="arXiv:2308.11596 (SeamlessM4T v2)",
    notes="Enc-dec; decode uses self-attn KV cache + cross-attn cache over "
    "encoder memory. Audio frontend stubbed to frame embeddings.",
)
