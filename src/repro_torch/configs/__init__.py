"""Architecture registry: ``get_config("<arch-id>")`` and the shape table.

Arch ids match the assignment exactly (``--arch <id>`` on every launcher).
"""
from __future__ import annotations

from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    assert_valid,
)

from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma

ARCHS = {
    c.name: c
    for c in (
        _qwen25,
        _deepseek,
        _gemma3,
        _qwen3,
        _qwen3moe,
        _dbrx,
        _llava,
        _seamless,
        _xlstm,
        _rgemma,
    )
}

for _c in ARCHS.values():
    assert_valid(_c)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def cells():
    """All (arch, shape) dry-run cells, honouring the long_500k skip rule.

    ``long_500k`` requires sub-quadratic attention: run only for archs whose
    decode state is bounded (windowed / recurrent); skip for pure
    full-attention stacks (recorded in DESIGN.md §Arch-applicability).
    """
    out = []
    for name, cfg in sorted(ARCHS.items()):
        for shape in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K):
            if shape.name == "long_500k" and not cfg.supports_long_context_decode:
                continue
            out.append((name, shape.name))
    return out


__all__ = [
    "ARCHS",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "get_config",
    "list_archs",
    "cells",
]
