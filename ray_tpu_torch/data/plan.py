"""Logical plan for ray_tpu_torch.data (the port of ``ray_tpu/data/plan.py``).

Reference: python/ray/data/_internal/logical/ (logical operators +
optimizer rules) and _internal/planner/. The package keeps one
load-bearing optimization from the reference: **operator fusion** —
consecutive one-to-one block transforms are composed into a single
function so each input block flows through the whole chain inside one
task (one scheduling hop, no intermediate materialization).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.data.block import Block


@dataclass
class ReadTask:
    """A deferred read producing one block (reference: datasource.ReadTask)."""

    fn: Callable[[], Block]
    metadata: dict = field(default_factory=dict)


class LogicalOp:
    name = "op"


@dataclass
class InputData(LogicalOp):
    """Leaf: deferred read tasks and/or already-materialized block refs."""

    read_tasks: list[ReadTask] | None = None
    block_refs: list[Any] | None = None
    name: str = "Input"

    def num_inputs(self) -> int:
        if self.read_tasks is not None:
            return len(self.read_tasks)
        return len(self.block_refs or [])


@dataclass
class MapBlocks(LogicalOp):
    """One-to-one block transform; fusable with neighbors.

    ``needs_index=True`` ops receive ``fn(block, block_index)`` — used by
    seeded per-block randomness (random_sample) so every block draws an
    independent stream from the same user seed.
    """

    fn: Callable[[Block], Block]
    name: str = "Map"
    needs_index: bool = False
    # Optimizer metadata: row_preserving ops keep exactly one output row
    # per input row (limits may move before them); kind/cols tag typed
    # transforms ("project" carries its column list) for rewrite rules.
    row_preserving: bool = False
    kind: str = ""
    cols: "list[str] | None" = None


@dataclass
class AllToAll(LogicalOp):
    """Barrier op: consumes all upstream block refs, emits new ones.

    ``fn(block_refs, ctx) -> list[block_refs]`` runs on the driver and
    orchestrates an exchange (split tasks + merge tasks).
    """

    fn: Callable[[list, Any], list]
    name: str = "AllToAll"


@dataclass
class Limit(LogicalOp):
    limit: int = 0
    name: str = "Limit"


def fuse_stages(ops: list[LogicalOp]) -> list[LogicalOp]:
    """Compose adjacent MapBlocks into one (reference: the fusion rule in
    data/_internal/logical/rules/operator_fusion.py)."""
    fused: list[LogicalOp] = []
    for op in ops:
        if (isinstance(op, MapBlocks) and fused
                and isinstance(fused[-1], MapBlocks)):
            prev = fused.pop()

            def chained(block: Block, idx: int = 0, _a=prev.fn, _b=op.fn,
                        _ai=prev.needs_index, _bi=op.needs_index) -> Block:
                block = _a(block, idx) if _ai else _a(block)
                return _b(block, idx) if _bi else _b(block)

            fused.append(MapBlocks(
                chained, name=f"{prev.name}->{op.name}",
                needs_index=prev.needs_index or op.needs_index,
                row_preserving=prev.row_preserving and op.row_preserving))
        else:
            fused.append(op)
    return fused
