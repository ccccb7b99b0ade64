"""Nested dicts and lists of tensors (the parameter trees), flattened in
key order (dicts) and in order (lists), as ``jax.tree_util`` flattens
them. Tuples are leaves: a logical-axes tuple is one leaf."""

from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict or list, depth first, dicts in sorted key
    order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """A nested dict (or list) of the same keys with ``fn`` applied to each
    leaf."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, item) for item in tree]
    return fn(tree)
