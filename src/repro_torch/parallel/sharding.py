"""The parallel configuration the LM path reads, on one device.

The port of the part of ``repro.parallel.sharding`` that the serving path
reaches: ``ParallelConfig`` with the JAX package's fields and defaults
(``moe_dispatch`` ``"einsum"``, ``"gather"`` or ``"a2a"``, which runs
``"gather"`` without a mesh, as in the JAX package),
``NO_PARALLEL``, and the sharding hints ``constrain`` / ``batch_spec`` /
``heads_spec``, which do nothing on one device.  The LM path's mesh is
not ported yet (``ROADMAP.md`` item 1.3c): a ``ParallelConfig`` given one
raises.  (The Sphere data plane runs on a mesh: ``SphereEngine(mesh=)``,
:mod:`repro_torch.core.spmd`.)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution + optimization knobs (the hillclimb surface)."""

    mesh: Optional[object] = None
    multi_pod: bool = False
    # --- optimization knobs (baseline values are paper-faithful) -----------
    mode: str = "pjit"                 # "pjit" | "podwise" (manual pod axis)
    remat: str = "full"                # "none" | "full" | "dots"
    moe_dispatch: str = "einsum"       # "einsum" (GShard) | "gather" | "a2a"
    compress_pod: str = "none"         # "none" | "bf16" | "int8_ef"
    attn_impl: str = "scan"            # "scan" | "rect" | "triangular" | "pallas"
    q_chunk: int = 2048
    kv_chunk: int = 2048
    donate: bool = True
    scan_layers: bool = True
    # --- beyond-paper optimizations (each a §Perf iteration) ---------------
    layout: str = "tp"                 # "tp" (FSDPxTP) | "fsdp" (ZeRO-3)
    fused_head: bool = False           # chunked CE fused with the LM head
    head_chunk: int = 512              # token chunk for the fused head
    embed_mode: str = "gather"         # "gather" | "vocab_parallel"
    accum_steps: int = 1               # gradient-accumulation microbatches
    lru_chunk: int = 0                 # RG-LRU: chunk the associative scan
    cache_write: str = "masked"        # "masked" | "scatter"
    # --- measurement (roofline) mode ----------------------------------------
    unroll_scans: bool = False         # python-loop the inner scans

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port runs the LM path on one device: a mesh is not "
                "ported yet (ROADMAP.md item 1.3c)")

    @property
    def data_axes(self) -> Tuple[str, ...]:
        base = ("pod", "data") if self.multi_pod else ("data",)
        if self.layout == "fsdp":
            base = base + ("model",)
        return base

    @property
    def axis_sizes(self):
        return {}

    @property
    def model_size(self) -> int:
        return 1

    @property
    def data_size(self) -> int:
        return 1

    def with_(self, **kw) -> "ParallelConfig":
        return replace(self, **kw)


NO_PARALLEL = ParallelConfig(mesh=None)


def batch_spec(pcfg: ParallelConfig, *trailing):
    """No spec on one device."""
    return None


def heads_spec(pcfg: ParallelConfig, n_heads: int, *, batch_dims=1,
               trailing=1):
    """No spec on one device."""
    return None


def constrain(x, pcfg: ParallelConfig, spec):
    """Identity: one device holds every tensor whole."""
    return x
