"""Nested dicts of tensors (the parameter trees), flattened in key order."""

from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict, depth first in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """A nested dict of the same keys with ``fn`` applied to each leaf."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)
