"""Base model/shape configuration for the Sector/Sphere LM framework.

Every assigned architecture is expressed as a single frozen ``ModelConfig``.
The config is deliberately rich enough to cover all six families in the
assignment pool:

  dense          -- llama/qwen-style decoder-only transformers (GQA, RoPE)
  moe            -- dense backbone with MoE FFN (top-k routing, EP sharding)
  vlm            -- dense LM backbone + vision-patch frontend stub
  audio-encdec   -- encoder-decoder transformer + audio-frame frontend stub
  xlstm          -- sLSTM + mLSTM recurrent blocks (attention-free)
  hybrid-rglru   -- RG-LRU recurrent blocks interleaved with local attention

The *shape* configs (train_4k / prefill_32k / decode_32k / long_500k) are the
assigned input-shape set shared by all LM-family architectures.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (a dry-run / roofline cell column)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """A complete architecture description.

    ``block_pattern`` describes one *pattern unit* of layers which is stacked
    ``n_layers / len(block_pattern)`` times and lowered as a ``lax.scan`` over
    the stacked groups (keeps the HLO compact for 512-device compiles).

    Pattern symbols:
      "A"  full (global) causal attention + FFN
      "L"  local sliding-window attention + FFN
      "R"  RG-LRU recurrent block + FFN         (recurrentgemma)
      "m"  mLSTM block                          (xlstm)
      "s"  sLSTM block                          (xlstm)
    """

    name: str
    family: str  # dense | moe | vlm | audio-encdec | xlstm | hybrid-rglru

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0   # per-layer-type theta (0 = same as global)
    local_window: int = 0           # sliding-window size for "L" layers
    block_pattern: Tuple[str, ...] = ("A",)
    logit_softcap: float = 0.0      # gemma-style final logit soft-capping
    attn_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert FFN width
    router_aux_coef: float = 0.001  # load-balancing loss coefficient

    # --- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_is_causal: bool = False

    # --- recurrent (xlstm / rglru) -------------------------------------------
    lru_width: int = 0              # RG-LRU recurrence width (rglru)
    conv1d_width: int = 4
    mlstm_proj_factor: float = 2.0  # mLSTM up-projection factor
    mlstm_qkv_blocksize: int = 4    # block-diagonal q/k/v projection blocks
    slstm_proj_factor: float = 1.3333

    # --- embeddings / norm / act ---------------------------------------------
    norm_eps: float = 1e-6
    act: str = "silu"               # silu | gelu | geglu handled in mlp.py
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma-style sqrt(d_model) embed scaling

    # --- modality frontend stub ----------------------------------------------
    frontend: str = ""              # "" | "vision_patches" | "audio_frames"
    frontend_positions: int = 0     # patch/frame embeddings provided per sample

    # --- dtype policy ---------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- documentation --------------------------------------------------------
    source: str = ""
    notes: str = ""

    # ------------------------------------------------------------------ helpers
    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.pattern_len == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern of length {self.pattern_len}"
        )
        return self.n_layers // self.pattern_len

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (MXU/TP alignment)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def is_attention_free(self) -> bool:
        return all(b in ("m", "s", "R") for b in self.block_pattern)

    @property
    def supports_long_context_decode(self) -> bool:
        """True when the arch decodes 500k context without a full-attention
        KV cache in every layer (sub-quadratic / windowed / stateful)."""
        full_attn_layers = sum(1 for b in self.block_pattern if b == "A")
        return full_attn_layers < self.pattern_len or self.is_attention_free

    def moe_layer(self, symbol: str) -> bool:
        return self.family == "moe" and symbol in ("A", "L")

    # -------------------------------------------------------------- param count
    def param_count(self) -> int:
        """Exact parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # token embedding
        if not self.tie_embeddings:
            total += v * d  # lm head

        def attn_params() -> int:
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            if self.qk_norm:
                p += 2 * self.d_head
            return p

        def ffn_params(width: int) -> int:
            # gated (SwiGLU/GeGLU): gate + up + down
            return 3 * d * width

        def moe_params() -> int:
            return d * self.n_experts + self.n_experts * 3 * d * self.moe_d_ff

        def rglru_params() -> int:
            w = self.lru_width or d
            # in-proj (x,gate) + conv1d + lru gates (a,x per-channel input proj)
            return 2 * d * w + self.conv1d_width * w + 2 * (w * (w // 8) + w) + w * d

        def mlstm_params() -> int:
            inner = int(d * self.mlstm_proj_factor)
            bs = self.mlstm_qkv_blocksize
            # up-proj (x & z branches) + causal conv + block-diagonal qkv +
            # scalar i/f gates (Linear(3*inner -> n_heads)) + outnorm + down
            return (
                2 * d * inner
                + self.conv1d_width * inner
                + 3 * inner * bs
                + 2 * 3 * inner * self.n_heads
                + inner
                + inner * d
            )

        def slstm_params() -> int:
            # 4 gates (i,f,z,o): dense input proj + block-diag recurrent
            # (n_heads blocks) + bias; then gated FFN at slstm_proj_factor.
            hd = d // self.n_heads
            gates = 4 * (d * d + d * hd + d)
            ffn = 3 * d * int(d * self.slstm_proj_factor)
            return gates + ffn

        per_pattern = 0
        for sym in self.block_pattern:
            if sym in ("A", "L"):
                per_pattern += attn_params()
                if self.family == "moe":
                    per_pattern += moe_params()
                else:
                    per_pattern += ffn_params(self.d_ff)
                per_pattern += 2 * d  # 2 rmsnorms
            elif sym == "R":
                per_pattern += rglru_params() + ffn_params(self.d_ff) + 2 * d
            elif sym == "m":
                per_pattern += mlstm_params() + d
            elif sym == "s":
                per_pattern += slstm_params() + d
            else:
                raise ValueError(sym)

        total += per_pattern * self.n_groups
        total += d  # final norm
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder layers add cross-attn
            enc = (attn_params() + ffn_params(self.d_ff) + 2 * d) * self.n_enc_layers
            xattn = (attn_params() + d) * self.n_layers
            total += enc + xattn
        if self.frontend == "vision_patches":
            total += 2 * d * d  # 2-layer MLP projector (stub, but real params)
        if self.frontend == "audio_frames":
            total += d * d  # frame projector
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        expert_p = self.n_experts * 3 * self.d_model * self.moe_d_ff
        active_expert_p = self.top_k * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = self.n_layers
        return full - n_moe_layers * (expert_p - active_expert_p)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------- reduced config
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        pat = self.block_pattern
        return self.replace(
            name=self.name + "-smoke",
            n_layers=len(pat) * min(2, self.n_groups),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            n_enc_layers=2 if self.is_encoder_decoder else 0,
            lru_width=64 if self.lru_width else 0,
            local_window=min(self.local_window, 64) if self.local_window else 0,
            frontend_positions=min(self.frontend_positions, 8),
        )


def assert_valid(cfg: ModelConfig) -> None:
    assert cfg.n_layers % cfg.pattern_len == 0, cfg.name
    assert cfg.n_heads % max(cfg.n_kv_heads, 1) == 0, cfg.name
    if cfg.family == "moe":
        assert cfg.n_experts > 0 and cfg.top_k > 0 and cfg.moe_d_ff > 0
    if cfg.is_encoder_decoder:
        assert cfg.n_enc_layers > 0
