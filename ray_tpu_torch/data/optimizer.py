"""Rule-based logical-plan optimizer for ray_tpu_torch.data (the port of
``ray_tpu/data/optimizer.py``).

Reference: python/ray/data/_internal/logical/optimizers.py (the
LogicalOptimizer applies rules until fixpoint) and
_internal/logical/rules/ (operator fusion, limit pushdown, projection
handling). Rules here rewrite the flat op list:

- ``LimitPushdownRule``: adjacent limits collapse to the smaller one,
  and a Limit moves BEFORE row-preserving transforms so downstream
  stages process only the blocks the limit keeps.
- ``ProjectionMergeRule``: consecutive column projections collapse into
  the final (narrowest) one, so dropped columns are never materialized
  twice.
- ``OperatorFusionRule``: consecutive one-to-one block transforms
  compose into a single function (one scheduling hop per block) —
  including across ops the pushdown rules just re-ordered.

The optimizer records which rules fired; execution stats surface them
(``ExecutionStats.applied_rules``).
"""

from __future__ import annotations

from ray_tpu_torch.data.plan import Limit, LogicalOp, MapBlocks, fuse_stages


class Rule:
    """One rewrite; ``apply`` returns (new_ops, changed)."""

    name = "rule"

    def apply(self, ops: list[LogicalOp]) -> tuple[list[LogicalOp], bool]:
        raise NotImplementedError


class LimitPushdownRule(Rule):
    """Reference: _internal/logical/rules/limit_pushdown.py."""

    name = "LimitPushdown"

    def apply(self, ops: list[LogicalOp]) -> tuple[list[LogicalOp], bool]:
        out = list(ops)
        changed = False
        i = 0
        while i < len(out) - 1:
            a, b = out[i], out[i + 1]
            if isinstance(a, Limit) and isinstance(b, Limit):
                out[i:i + 2] = [Limit(limit=min(a.limit, b.limit))]
                changed = True
                continue
            if (isinstance(a, MapBlocks) and isinstance(b, Limit)
                    and a.row_preserving):
                # Swap: limiting first is equivalent for row-preserving
                # transforms and strictly less work.
                out[i], out[i + 1] = b, a
                changed = True
                i = max(0, i - 1)  # the limit may keep moving up
                continue
            i += 1
        return out, changed


class ProjectionMergeRule(Rule):
    """Consecutive projections keep only the final column set
    (reference: the projection handling in _internal/logical/rules/)."""

    name = "ProjectionMerge"

    def apply(self, ops: list[LogicalOp]) -> tuple[list[LogicalOp], bool]:
        out: list[LogicalOp] = []
        changed = False
        for op in ops:
            if (isinstance(op, MapBlocks) and op.kind == "project"
                    and out and isinstance(out[-1], MapBlocks)
                    and out[-1].kind == "project"
                    and op.cols is not None and out[-1].cols is not None
                    and set(op.cols) <= set(out[-1].cols)):
                # The later, narrower projection subsumes the earlier
                # one (only valid when its columns survive the first —
                # otherwise the first projection's error/absence
                # semantics must be preserved, so we leave both).
                out[-1] = op
                changed = True
                continue
            out.append(op)
        return out, changed


class OperatorFusionRule(Rule):
    """Reference: _internal/logical/rules/operator_fusion.py."""

    name = "OperatorFusion"

    def apply(self, ops: list[LogicalOp]) -> tuple[list[LogicalOp], bool]:
        fused = fuse_stages(ops)
        return fused, len(fused) != len(ops)


DEFAULT_RULES: tuple[Rule, ...] = (
    LimitPushdownRule(),
    ProjectionMergeRule(),
    OperatorFusionRule(),
)


def optimize(ops: list[LogicalOp],
             rules: tuple[Rule, ...] = DEFAULT_RULES,
             max_passes: int = 10) -> tuple[list[LogicalOp], list[str]]:
    """Apply rules to fixpoint (bounded); -> (ops, applied rule names).

    Fusion runs LAST within each pass so pushdown/merge see the
    un-fused structure they reason about.
    """
    applied: list[str] = []
    for _ in range(max_passes):
        changed_any = False
        for rule in rules:
            ops, changed = rule.apply(ops)
            if changed:
                applied.append(rule.name)
                changed_any = True
        if not changed_any:
            return ops, applied
    return ops, applied
