"""Backpressure policies + per-operator resource limits (the port of
``ray_tpu/data/backpressure.py``; it reads the port's runtime and
config).

Reference: python/ray/data/_internal/execution/backpressure_policy/
(ConcurrencyCapBackpressurePolicy, the resource-manager's memory-based
admission) — pluggable policies deciding whether an operator may grow
its in-flight window. The streaming executor is pull-based, so a slow
consumer already stalls upstream; these policies bound how far any
single operator can run AHEAD of its consumer.
"""

from __future__ import annotations


class BackpressurePolicy:
    """Decides if ``op_name`` may launch another block task while
    ``in_flight`` are outstanding."""

    def can_add_input(self, op_name: str, in_flight: int) -> bool:
        raise NotImplementedError


class ConcurrencyCapBackpressurePolicy(BackpressurePolicy):
    """Per-operator concurrency caps (reference:
    concurrency_cap_backpressure_policy.py). ``default_cap`` applies to
    operators not listed in ``caps``; 0 means uncapped here."""

    def __init__(self, caps: dict[str, int] | None = None,
                 default_cap: int = 0):
        self.caps = dict(caps or {})
        self.default_cap = default_cap

    def can_add_input(self, op_name: str, in_flight: int) -> bool:
        cap = self.caps.get(op_name, self.default_cap)
        return cap <= 0 or in_flight < cap


class StoreMemoryBackpressurePolicy(BackpressurePolicy):
    """Stop growing in-flight work while the object store is above its
    spill threshold (reference: the resource manager's memory-based
    admission)."""

    def can_add_input(self, op_name: str, in_flight: int) -> bool:
        if in_flight == 0:
            return True  # forward progress: never wedge an empty op
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.worker import global_runtime

        runtime = global_runtime()
        if runtime is None:
            return True
        stats = runtime.store.stats()
        limit = stats.get("memory_limit_bytes") or 0
        if limit <= 0:
            return True
        threshold = float(GLOBAL_CONFIG.object_spilling_threshold)
        return stats.get("memory_used_bytes", 0) <= threshold * limit


def default_policies() -> list[BackpressurePolicy]:
    return [StoreMemoryBackpressurePolicy()]
