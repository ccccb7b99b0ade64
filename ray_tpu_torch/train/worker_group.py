"""WorkerGroup: the gang of training actors.

The port of ``ray_tpu/train/worker_group.py`` for thread gangs: one
``TrainWorker`` actor per rank, each in its own bundle of one placement
group (``ScalingConfig.placement_strategy``), so the gang is placed all
or nothing and a ``use_gpu`` gang holds its ``GPU`` share until
``shutdown`` removes the group. The reference's process gangs (the
report channel actor, its pump and ``worker_env``) are ROADMAP item 6.
"""

from __future__ import annotations

from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import (
    TrainContext,
    _SessionState,
    run_with_session,
)
from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)


@ray_tpu_torch.remote
class TrainWorker:
    """One member of the gang; runs the user loop in its actor thread."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size

    def run(self, fn: Callable, config: dict, results_queue, stop_event,
            resume_checkpoint) -> Any:
        state = _SessionState(
            context=TrainContext(world_size=self.world_size,
                                 world_rank=self.rank,
                                 local_rank=self.rank),
            results_queue=results_queue,
            resume_checkpoint=resume_checkpoint,
            stop_event=stop_event,
        )

        def emit(msg: dict):
            results_queue.put({"rank": self.rank, **msg})

        return run_with_session(fn, config, state, emit)

    def ping(self) -> str:
        return "ok"


class WorkerGroup:
    """Creates, supervises and tears down the gang."""

    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling
        self.workers: list = []
        self.pg = None
        self._start()

    def _start(self):
        n = self.scaling.num_workers
        resources = self.scaling.worker_resources()
        self.pg = placement_group([dict(resources) for _ in range(n)],
                                  strategy=self.scaling.placement_strategy)
        if not self.pg.wait(timeout_seconds=60):
            remove_placement_group(self.pg)
            raise TimeoutError(
                f"Could not reserve {n} x {resources} for the worker group")
        worker_cls = TrainWorker.options(
            resources=dict(resources), num_cpus=0,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=self.pg))
        try:
            self.workers = [worker_cls.remote(rank, n) for rank in range(n)]
            ray_tpu_torch.get([w.ping.remote() for w in self.workers],
                              timeout=60)
        except BaseException:
            # Don't leak the committed bundles or a half-started gang.
            self.shutdown()
            raise

    def run(self, fn: Callable, config: dict, results_queue,
            stop_event, resume_checkpoint) -> list:
        """Kick off the loop on every worker; returns refs."""
        return [
            w.run.remote(fn, config, results_queue, stop_event,
                         resume_checkpoint)
            for w in self.workers
        ]

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — worker already dead
                pass
        if self.pg is not None:
            remove_placement_group(self.pg)
            self.pg = None
        self.workers = []
