"""xlstm-1.3b — sLSTM + mLSTM blocks, attention-free.

[arXiv:2405.04517; unverified tier] 48L d_model=2048 4H vocab=50304, d_ff=0
(projection factors live inside the blocks). Public 1.3B xLSTM uses a
7:1 mLSTM:sLSTM ratio -> pattern unit (m,m,m,m,m,m,m,s) x 6 groups.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_head=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=1.3333,
    conv1d_width=4,
    act="gelu",
    source="arXiv:2405.04517 (xLSTM[7:1] 1.3B)",
    notes="Attention-free; O(1) decode state; long_500k natural fit. "
    "mLSTM trains via chunkwise-parallel scan, decodes recurrently.",
)
