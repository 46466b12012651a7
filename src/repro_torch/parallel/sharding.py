"""Sharding policy: logical rules mapping parameter paths -> PartitionSpec.

The port of ``repro.parallel.sharding``.  The production mesh is
``("data", "model")`` within a pod and ``("pod", "data", "model")``
across pods. Policy (paper-faithful wide-area design):

  * parameters / optimizer state: FSDP over ``data`` x TP/EP over ``model``,
    **replicated over ``pod``** — the cross-pod ("wide-area") hop carries only
    the once-per-step gradient reduction, never bulk weights;
  * activations: batch over ``(pod, data)``, heads/ffn over ``model``;
  * KV caches: batch over ``(pod, data)``; heads over ``model`` when the head
    count divides, else the sequence dim (flash-decoding style), else
    replicated.

A spec says which block of a leaf each rank keeps
(:mod:`repro_torch.parallel.sharded` cuts and joins the blocks).  The
activation hints (``constrain``) are the identity: a rank's tensors are
already its own.  Where the JAX specs split heads or FFN columns over
``model`` (:func:`tp_block`), the attention, dense-FFN and RG-LRU layers
compute on the rank's block of their width and sum over ``model``
(``sharded.copy_to_model`` / ``reduce_from_model``); everything else is
computed whole.  The mesh is a
:class:`repro_torch.parallel.mesh_utils.Mesh`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

from repro_torch.utils.pytree import tree_map, tree_map_with_path


class PartitionSpec(tuple):
    """One entry per leading dim of a leaf: ``None`` (whole), a mesh axis
    name, or a tuple of names (the dim split over their product,
    row-major); dims past the entries are whole (``jax.sharding.
    PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec bound to its mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


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
    layout: str = "tp"                 # "tp" (FSDPxTP) | "fsdp" (ZeRO-3:
                                       # batch over data AND model)
    fused_head: bool = False           # chunked CE fused with the LM head
    head_chunk: int = 512              # token chunk for the fused head
    embed_mode: str = "gather"         # "gather" | "vocab_parallel"
    accum_steps: int = 1               # gradient-accumulation microbatches
    lru_chunk: int = 0                 # RG-LRU: chunk the associative scan
    cache_write: str = "masked"        # "masked" | "scatter"
    whole_batch: bool = False          # port-only: every rank holds the
                                       # whole batch (a serving mesh's
                                       # batch that does not split)
    # --- measurement (roofline) mode ----------------------------------------
    unroll_scans: bool = False         # python-loop the inner scans

    def __post_init__(self):
        from repro_torch.parallel.mesh_utils import Mesh
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch Mesh "
                            f"(launch.mesh.make_mesh_compat), got "
                            f"{type(self.mesh).__name__}")

    @property
    def data_axes(self) -> Tuple[str, ...]:
        base = ("pod", "data") if self.multi_pod else ("data",)
        if self.layout == "fsdp":
            base = base + ("model",)
        return base

    @property
    def axis_sizes(self):
        if self.mesh is None:
            return {}
        return dict(self.mesh.shape)

    @property
    def model_size(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def data_size(self) -> int:
        s = self.axis_sizes.get("data", 1)
        if self.multi_pod:
            s *= self.axis_sizes.get("pod", 1)
        return s

    def with_(self, **kw) -> "ParallelConfig":
        return replace(self, **kw)


NO_PARALLEL = ParallelConfig(mesh=None)


def batch_spec(pcfg: ParallelConfig, *trailing) -> P:
    """Batch dim over the data axes; trailing entries appended verbatim.

    Under the fsdp layout the model axis belongs to the batch dim, so any
    trailing "model" (TP) annotation is dropped."""
    if pcfg.mesh is None:
        return P()
    if pcfg.layout == "fsdp":
        trailing = tuple(None if t == "model" else t for t in trailing)
    return P(pcfg.data_axes if len(pcfg.data_axes) > 1 else pcfg.data_axes[0],
             *trailing)


def _divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def heads_spec(pcfg: ParallelConfig, n_heads: int, *, batch_dims=1, trailing=1):
    """Spec for [batch, (seq), heads, d_head]-shaped activations."""
    if pcfg.mesh is None:
        return None
    axes = [pcfg.data_axes if len(pcfg.data_axes) > 1 else pcfg.data_axes[0]]
    axes += [None] * (batch_dims - 1)
    use_tp = pcfg.layout == "tp" and _divisible(n_heads, pcfg.model_size)
    axes += ["model" if use_tp else None]
    axes += [None] * trailing
    return P(*axes)


def tp_block(pcfg: ParallelConfig, width: int) -> Optional[Tuple[int, int]]:
    """(this rank's coordinate along ``model``, the ``model`` size) where
    the JAX activation specs split ``width`` (heads, FFN columns, the LRU
    width) over ``model``, else None: the test of ``heads_spec``, a
    mesh whose ``model`` axis has several ranks, ``layout="tp"`` and a
    width that the ``model`` size divides.  The rank's slice of the width
    is ``[index * width / size, (index + 1) * width / size)``."""
    if pcfg.mesh is None or pcfg.model_size <= 1 or pcfg.layout != "tp" \
            or not _divisible(width, pcfg.model_size):
        return None
    return pcfg.mesh.axis_index("model"), pcfg.model_size


def kv_cache_spec(pcfg: ParallelConfig, n_kv: int, seq: int) -> P:
    """Spec for a [B, S, K, D] KV cache (leading group dim handled by caller).

    Heads over ``model`` when divisible, else sequence (flash-decoding
    partial-softmax), else replicated over model.
    """
    if pcfg.mesh is None:
        return P()
    b = pcfg.data_axes if len(pcfg.data_axes) > 1 else pcfg.data_axes[0]
    if _divisible(n_kv, pcfg.model_size):
        return P(b, None, "model", None)
    if _divisible(seq, pcfg.model_size):
        return P(b, "model", None, None)
    return P(b, None, None, None)


def validate_spec(spec: P, shape, sizes: dict) -> P:
    """Drop spec axes that do not divide the corresponding dim."""
    dims = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            dims.append(None if i >= len(shape) else ax)
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        total = 1
        for n in names:
            total *= sizes.get(n, 1)
        dims.append(ax if shape[i] % total == 0 else None)
    return P(*dims)


def constrain(x, pcfg: ParallelConfig, spec):
    """Identity: the JAX package's ``with_sharding_constraint`` places an
    activation; a rank's tensors here are already the ones it computes
    on."""
    return x


# ---------------------------------------------------------------------------
# Parameter path -> PartitionSpec rules
# ---------------------------------------------------------------------------
# Paths are '/'-joined key paths into the param tree. Leading "blocks/u<i>/"
# (and "encoder/blocks/u<i>/") segments carry a stacked group dim, handled by
# prefixing the matched spec with None.
#
# Order matters: first match wins.

_RULES: Tuple[Tuple[str, P], ...] = (
    # embeddings / head: vocab over model, d_model over data (FSDP)
    (r"embed/w$", P("model", "data")),
    (r"lm_head/w$", P("data", "model")),
    # attention projections
    (r"attn/wq$", P("data", "model")),
    (r"attn/wk$", P("data", "model")),
    (r"attn/wv$", P("data", "model")),
    (r"attn/wo$", P("model", "data")),
    (r"attn/b[qkv]$", P("model")),
    (r"attn/(q_norm|k_norm)$", P(None)),
    # dense FFN
    (r"mlp/w(i|g)$", P("data", "model")),
    (r"mlp/wo$", P("model", "data")),
    # MoE: experts over model (EP), FSDP over data
    (r"moe/router$", P("data", None)),
    (r"moe/w(i|g)$", P("model", "data", None)),
    (r"moe/wo$", P("model", None, "data")),
    # RG-LRU block
    (r"rglru/in_[xg]$", P("data", "model")),
    (r"rglru/out$", P("model", "data")),
    (r"rglru/conv_w$", P(None, "model")),
    (r"rglru/(gate_a|gate_x)/w$", P(None, None, "model")),
    (r"rglru/a_param$", P("model")),
    # mLSTM block
    (r"mlstm/up$", P("data", "model")),
    (r"mlstm/down$", P("model", "data")),
    (r"mlstm/conv_w$", P(None, "model")),
    (r"mlstm/(q|k|v)/w$", P("model", None, None)),
    (r"mlstm/(igate|fgate)/w$", P("model", None)),
    (r"mlstm/(igate|fgate)/b$", P(None)),
    (r"mlstm/out_norm$", P("model")),
    # sLSTM block
    (r"slstm/w_(i|f|z|o)$", P("data", "model")),
    (r"slstm/r_(i|f|z|o)$", P(None, None, "model")),
    (r"slstm/b_(i|f|z|o)$", P("model")),
    # frontend projectors
    (r"frontend/.*w.$", P("data", "model")),
    # norms, biases, anything 1-D: replicated
    (r".*", P()),
)


def _spec_for_path(path: str, leading_group_dim: bool) -> P:
    for pat, spec in _RULES:
        if re.search(pat, path):
            if leading_group_dim and len(spec) > 0:
                return P(None, *spec)
            if leading_group_dim:
                return P(None)
            return spec
    raise AssertionError("unreachable")


def spec_matches(path: str, spec_len: int) -> P:
    """Public helper for tests."""
    return _spec_for_path(path, False)


def param_specs_for(shape_tree, pcfg: ParallelConfig):
    """Tree of PartitionSpecs parallel to the param tree.

    Leaves under ``blocks/`` (scan-stacked) get a leading None for the group
    dim. Specs are validated for divisibility against the mesh — any axis
    whose size does not divide falls back to None (replicated) on that dim,
    so every arch lowers on every mesh (e.g. 10-head recurrentgemma on
    model=16).
    """
    sizes = pcfg.axis_sizes

    def leaf(path: str, leaf_spec):
        grouped = "blocks/" in path
        spec = _spec_for_path(path, grouped)
        if pcfg.mesh is None:
            return P()
        # validate divisibility per dim
        dims = []
        for i, ax in enumerate(spec):
            if ax is None:
                dims.append(None)
                continue
            names = ax if isinstance(ax, tuple) else (ax,)
            total = 1
            for n in names:
                total *= sizes.get(n, 1)
            if leaf_spec.shape[i] % total == 0:
                dims.append(ax)
            else:
                dims.append(None)
        return P(*dims)

    return tree_map_with_path(leaf, shape_tree)


def shardings_for(shape_tree, pcfg: ParallelConfig):
    """NamedSharding tree (or None when mesh-less)."""
    if pcfg.mesh is None:
        return None
    return tree_map(lambda s: NamedSharding(pcfg.mesh, s),
                    param_specs_for(shape_tree, pcfg))
