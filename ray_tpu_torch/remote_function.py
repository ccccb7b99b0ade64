"""``@remote`` functions.

The port of ``ray_tpu/remote_function.py``: the same options, with
``num_gpus`` demanding the ``GPU`` resource (the reference folds it into
``TPU``).
"""

from __future__ import annotations

import functools
from typing import Callable

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.task import SchedulingStrategy, normalize_resources
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

_VALID_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "resources", "num_returns",
    "max_retries", "retry_exceptions", "name", "scheduling_strategy",
    "placement_group", "placement_group_bundle_index", "runtime_env",
    "memory", "max_calls", "_metadata", "_deadline_s",
}


def _build_strategy(options: dict) -> SchedulingStrategy:
    """The options' strategy: DEFAULT, SPREAD, ``placement_group=`` (with
    ``placement_group_bundle_index=``), or a strategy object of
    ``util.scheduling_strategies`` (placement group, node affinity)."""
    strategy = options.get("scheduling_strategy")
    if isinstance(strategy, SchedulingStrategy):
        return strategy
    if strategy == "SPREAD":
        return SchedulingStrategy(kind="SPREAD")
    if strategy in (None, "DEFAULT"):
        pg = options.get("placement_group")
        if pg is not None:
            return SchedulingStrategy(
                kind="PLACEMENT_GROUP", placement_group=pg,
                placement_group_bundle_index=options.get(
                    "placement_group_bundle_index", -1))
        return SchedulingStrategy()
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP", placement_group=strategy.placement_group,
            placement_group_bundle_index=strategy.placement_group_bundle_index)
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return SchedulingStrategy(kind="NODE_AFFINITY",
                                  node_id=strategy.node_id, soft=strategy.soft)
    raise ValueError(f"Unsupported scheduling_strategy: {strategy!r}")


def _resources(options: dict, default_cpus: float = 1.0) -> dict:
    return normalize_resources(
        options.get("num_cpus"), options.get("num_gpus"),
        options.get("resources"), default_cpus=default_cpus,
        num_tpus=options.get("num_tpus"))


class RemoteFunction:
    """A function turned into a task factory by ``@remote``."""

    def __init__(self, func: Callable, default_options: dict | None = None):
        self._function = func
        self._default_options = dict(default_options or {})
        bad = set(self._default_options) - _VALID_OPTIONS
        if bad:
            raise ValueError(f"Invalid @remote options: {sorted(bad)}")
        opts = self._default_options
        self._call_kwargs = dict(
            name=opts.get("name") or func.__qualname__,
            num_returns=opts.get("num_returns", 1),
            resources=_resources(opts),
            max_retries=opts.get("max_retries", 0),
            retry_exceptions=opts.get("retry_exceptions", False),
            scheduling_strategy=_build_strategy(opts),
            deadline_s=opts.get("_deadline_s"),
        )
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__name__}' cannot be called "
            "directly. Use '.remote()' to submit it as a task, or access the "
            "underlying function via '.func'.")

    @property
    def func(self) -> Callable:
        return self._function

    def options(self, **options) -> "RemoteFunction":
        bad = set(options) - _VALID_OPTIONS
        if bad:
            raise ValueError(f"Invalid options: {sorted(bad)}")
        return RemoteFunction(self._function,
                              {**self._default_options, **options})

    def remote(self, *args, _deadline_s: float | None = None, **kwargs):
        """``_deadline_s`` arms an end-to-end deadline for this call (it
        overrides the option): past it, the refs raise TaskTimeoutError
        and the task never runs."""
        call_kwargs = self._call_kwargs
        if _deadline_s is not None:
            call_kwargs = {**call_kwargs, "deadline_s": _deadline_s}
        refs = worker_mod.auto_init().submit_task(
            self._function, args, kwargs, **call_kwargs)
        return refs[0] if call_kwargs["num_returns"] == 1 else refs

    def __repr__(self):
        return f"RemoteFunction({self._function.__qualname__})"
