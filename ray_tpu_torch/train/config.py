"""Shared training config dataclasses.

The port of ``ray_tpu/train/config.py``. For the card, the reference's
``use_tpu``/``chips_per_worker`` are ``use_gpu``/``gpus_per_worker``,
asking for the ``GPU`` resource, as ``num_gpus`` does. Gangs of process
workers are not ported (ROADMAP queue 1, item 6): a worker is an actor
thread of the driver's process.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ScalingConfig:
    """How many workers and what each worker holds.

    num_workers: actor count in the worker group (threads of this
    process).
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"
    gpus_per_worker: float = 0
    # Process workers (one process per gang member) are ROADMAP item 6.
    use_process_workers: bool = False

    def __post_init__(self):
        if self.use_process_workers:
            raise ValueError(
                "ScalingConfig(use_process_workers=True): process worker "
                "gangs are not ported yet (ROADMAP queue 1, item 6); the "
                "workers are actor threads of this process")

    def worker_resources(self) -> dict[str, float]:
        res = dict(self.resources_per_worker)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = float(self.gpus_per_worker or 1)
        if "CPU" not in res:
            res["CPU"] = 1.0
        return res


@dataclass
class FailureConfig:
    """max_failures: group-level restarts; recovery re-forms the whole
    group from the latest checkpoint."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: int | None = None
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False


@dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    stop: dict[str, Any] | None = None
    verbose: int = 0
    # Max seconds between worker reports before the run is declared hung.
    report_timeout_s: float = 3600.0
