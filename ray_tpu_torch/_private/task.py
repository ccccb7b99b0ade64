"""Task specification and resource demands.

The port of ``ray_tpu/_private/task.py``. ``GPU`` is a resource of its
own here: ``num_gpus`` demands ``GPU``, where the reference folds it into
``TPU``. ``num_tpus`` still demands ``TPU``, so code written for the
reference keeps its meaning (on a machine without TPUs that demand can
never be met, and the dispatcher warns).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch._private.ids import ObjectID, TaskID


def normalize_resources(
    num_cpus: float | None,
    num_gpus: float | None,
    resources: dict[str, float] | None,
    default_cpus: float = 1.0,
    num_tpus: float | None = None,
) -> dict[str, float]:
    """The resource demand map, zero demands dropped."""
    demand: dict[str, float] = {
        "CPU": float(num_cpus) if num_cpus is not None else default_cpus}
    if num_gpus:
        demand["GPU"] = float(num_gpus)
    if num_tpus:
        demand["TPU"] = float(num_tpus)
    for key, value in (resources or {}).items():
        demand[key] = float(value)
    return {k: v for k, v in demand.items() if v > 0}


@dataclass
class SchedulingStrategy:
    """DEFAULT (the least-utilized node), SPREAD (round-robin),
    PLACEMENT_GROUP (a bundle's reserved resources) or NODE_AFFINITY
    (one node; ``soft`` falls back to DEFAULT when it is full or gone)."""

    kind: str = "DEFAULT"
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    node_id: str | None = None
    soft: bool = False


@dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    func: Callable | None
    args: tuple
    kwargs: dict
    num_returns: int = 1
    resources: dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool | list[type] = False
    scheduling_strategy: SchedulingStrategy = field(
        default_factory=SchedulingStrategy)
    return_ids: list[ObjectID] = field(default_factory=list)
    # Absolute end-to-end deadline (time.time()); None = no budget. Each
    # stage checks it before doing work and seals TaskTimeoutError
    # instead of running dead work.
    deadline: float | None = None
    attempt: int = 0
    # Applied in a pool worker (env_vars, working_dir, py_modules).
    runtime_env: dict | None = None
    # The card shares of its GPU lease, set at admission.
    gpu_shares: dict[int, float] = field(default_factory=dict)
    # The performance plane's stamps (time.time()): first submitted, and
    # claimed by the scheduler; 0.0 while the plane is off.
    submit_ts: float = 0.0
    dispatch_ts: float = 0.0
    # The driver's trace context, (trace id, parent span id, anchor),
    # while tracing is on (util/tracing.py); None otherwise.
    trace_ctx: tuple | None = None
