"""Logical-axis sharding rules → DTensor placements.

The port of ``ray_tpu/parallel/sharding.py``. Params and activations
carry *logical* axis names which a rule table maps onto mesh axes, as
there; where the reference hands the result to GSPMD as a
``NamedSharding``, this hands it to DTensor as a ``DeviceMesh`` plus one
placement per mesh dim, and ``jax.device_put`` becomes
``distribute_tensor``, ``with_sharding_constraint`` ``redistribute``.

A spec is a plain tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of names (the dim split over several axes, the
first outermost, as JAX splits it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

from ray_tpu_torch.parallel.mesh import AXIS_ORDER

# Default rule table for transformer models. Each logical axis maps to a
# mesh axis (or tuple of axes, or None = replicated).
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),
    ("sequence", "sp"),
    ("embed", "fsdp"),          # ZeRO-3 style parameter sharding
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
    ("norm", None),
)


def rules_dict(rules: Sequence[tuple[str, Any]] | None = None) -> dict[str, Any]:
    return dict(DEFAULT_RULES if rules is None else rules)


def logical_to_spec(logical_axes: Sequence[str | None],
                    rules: Sequence[tuple[str, Any]] | None = None) -> tuple:
    """Map logical axis names to a spec via the rule table. A mesh axis
    is used by the first logical axis that claims it; later ones leave it
    out (and are replicated when nothing of theirs is left)."""
    table = rules_dict(rules)
    spec = []
    used: set[str] = set()
    for name in logical_axes:
        if name is None:
            spec.append(None)
            continue
        mesh_axes = table.get(name)
        if mesh_axes is None:
            spec.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        free = tuple(a for a in mesh_axes if a not in used)
        used.update(free)
        if not free:
            spec.append(None)
        elif len(free) == 1:
            spec.append(free[0])
        else:
            spec.append(free)
    return tuple(spec)


def placements(mesh: DeviceMesh, spec: Sequence) -> list[Placement]:
    """One placement per mesh dim: tensor dim ``i`` over mesh axis ``a``
    is ``Shard(i)`` at ``a``'s mesh dim, every other mesh dim
    ``Replicate()``.

    DTensor splits a tensor dim over its mesh dims left to right, so a
    dim over several axes must name them in the mesh's order (then the
    first is outermost, as in JAX); another order raises rather than
    being permuted in silence."""
    names = tuple(mesh.mesh_dim_names or ())
    order = AXIS_ORDER + tuple(a for a in names if a not in AXIS_ORDER)
    out: list[Placement] = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        unknown = [a for a in axes if a not in order]
        if unknown:
            raise ValueError(f"mesh axes {unknown} of spec {tuple(spec)} are "
                             f"not in the mesh {names}")
        ranks = [order.index(a) for a in axes]
        if ranks != sorted(ranks) or len(set(ranks)) != len(ranks):
            raise ValueError(
                f"spec entry {axes} for dim {dim} is not in the mesh's axis "
                f"order {order}")
        # A canonical axis missing from the mesh has size 1: it shards
        # nothing.
        for mesh_dim in (names.index(a) for a in axes if a in names):
            if out[mesh_dim] != Replicate():
                raise ValueError(f"mesh axis {names[mesh_dim]!r} is used "
                                 f"twice in spec {tuple(spec)}")
            out[mesh_dim] = Shard(dim)
    return out


def partial_over(mesh: DeviceMesh, at: Sequence[Placement],
                 axes: Sequence[str]) -> list[Placement]:
    """``at`` with ``Partial()`` at the mesh dim of each axis in ``axes``
    (those the mesh has): the placements of a value, such as a gradient
    inside ``local_map``, of which each rank on those axes holds a
    partial sum."""
    names = mesh.mesh_dim_names or ()
    return [Partial() if a in axes else p for a, p in zip(names, at)]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec."""

    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> list[Placement]:
        return placements(self.mesh, self.spec)


def named_sharding(mesh: DeviceMesh, *logical_axes: str | None,
                   rules: Sequence[tuple[str, Any]] | None = None
                   ) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical_axes, rules))


def constrain(x: torch.Tensor, mesh: DeviceMesh, *logical_axes: str | None,
              rules: Sequence[tuple[str, Any]] | None = None) -> DTensor:
    """``with_sharding_constraint`` by logical axis names: a DTensor is
    redistributed, a plain (global) tensor distributed."""
    target = placements(mesh, logical_to_spec(logical_axes, rules))
    if isinstance(x, DTensor):
        return x.redistribute(mesh, target)
    return distribute_tensor(x, mesh, target)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(mesh: DeviceMesh, logical_tree: Any,
                   rules: Sequence[tuple[str, Any]] | None = None) -> Any:
    """Map a tree (nested dicts) of logical-axis tuples to the same tree
    of ``NamedSharding``s."""
    if _is_axes(logical_tree):
        return NamedSharding(mesh, logical_to_spec(logical_tree, rules))
    return {key: tree_shardings(mesh, value, rules)
            for key, value in logical_tree.items()}


def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{key!r}]" for key in path)


def _leaves_with_path(tree: Any, path: tuple = ()) -> list:
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _leaves_with_path(tree[key], path + (key,))]
    return [(path, tree)]


def infer_param_logical_axes(params: Any) -> Any:
    """Heuristic logical axes for a param tree, keyed by path + rank.

    Used when a model doesn't carry explicit partitioning metadata:
    - rank-1 arrays (biases, norm scales) → replicated
    - rank-2 arrays → ("embed", "mlp"-or-"vocab"-or-"heads" by name)
    - rank-3 arrays (attention qkv) → ("embed", "heads", None)
    """

    def classify(path, leaf):
        name = _keystr(path).lower()
        if leaf.ndim <= 1:
            return tuple([None] * leaf.ndim)
        if leaf.ndim == 2:
            if "embed" in name and "token" in name or "vocab" in name:
                return ("vocab", "embed")
            if any(k in name for k in ("out_proj", "o_proj", "down")):
                return ("mlp", "embed")
            return ("embed", "mlp")
        if leaf.ndim == 3:
            return ("embed", "heads", None)
        if leaf.ndim == 4:
            return (None, None, None, None)
        return tuple([None] * leaf.ndim)

    axes = {path: classify(path, leaf)
            for path, leaf in _leaves_with_path(params)}

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {key: rebuild(value, path + (key,))
                    for key, value in tree.items()}
        return axes[path]

    return rebuild(params)


def _map_with_axes(fn, tree: Any, logical: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _map_with_axes(fn, value, logical[key])
                for key, value in tree.items()}
    return fn(tree, logical)


def shard_params(params: Any, mesh: DeviceMesh, logical_axes: Any | None = None,
                 rules: Sequence[tuple[str, Any]] | None = None) -> Any:
    """Place a parameter tree onto the mesh per the rules (each leaf a
    global tensor, the same on every rank)."""
    if logical_axes is None:
        logical_axes = infer_param_logical_axes(params)
    return _map_with_axes(
        lambda x, axes: distribute_tensor(
            x, mesh, placements(mesh, logical_to_spec(axes, rules))),
        params, logical_axes)
