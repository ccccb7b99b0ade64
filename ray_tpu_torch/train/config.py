"""Shared training config dataclasses.

The port of ``ray_tpu/train/config.py``. For the card, the reference's
``use_tpu``/``chips_per_worker`` are ``use_gpu``/``gpus_per_worker``,
asking for the ``GPU`` resource, as ``num_gpus`` does. A worker is an
actor thread of the driver's process, or with ``use_process_workers``
a process actor of its own (``worker_env`` set in its environment).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ScalingConfig:
    """How many workers and what each worker holds.

    num_workers: actor count in the worker group.
    use_process_workers: one process per worker (a process actor) in
    place of a thread of this process; with ``use_gpu`` each process
    sees the card it leased.
    worker_env: environment variables of each worker process.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"
    gpus_per_worker: float = 0
    use_process_workers: bool = False
    worker_env: dict[str, str] | None = None

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
