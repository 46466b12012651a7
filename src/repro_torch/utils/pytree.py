"""Helpers for the port's parameter and cache trees.

The JAX package keeps parameters, decode caches and recurrent states as
pytrees; the port keeps them as nested dicts of tensors with the same
keys.  Paths are the '/'-joined keys, visited in sorted key order, as
``jax.tree_util`` flattens a dict, so a leaf's path names the same leaf
in both packages.
"""
from __future__ import annotations

from typing import Callable, List, Tuple


def tree_flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """Returns [(path_str, leaf), ...] in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        out.extend(tree_flatten_with_paths(tree[key], path))
    return out


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """Map fn(path_str, leaf) over a nested dict."""
    if not isinstance(tree, dict):
        return fn(prefix, tree)
    return {key: tree_map_with_path(fn, sub,
                                    f"{prefix}/{key}" if prefix else str(key))
            for key, sub in tree.items()}


def tree_map(fn: Callable, tree, *rest):
    """Map fn(leaf, *leaves) over nested dicts of the same structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {key: tree_map(fn, sub, *(r[key] for r in rest))
            for key, sub in tree.items()}


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]
