"""Trainers: BaseTrainer, DataParallelTrainer and MeshTrainer.

The port of ``ray_tpu/train/trainer.py``. ``MeshTrainer`` is the
counterpart of the reference's ``JaxTrainer``: the worker group is the
SPMD unit, and the loop takes its ``DeviceMesh`` from
``session.get_mesh()`` and steps with ``parallel.train_step``. Its
backend hook brings up the default process group where the reference
calls ``jax.distributed.initialize``.

Failure semantics follow the gang model: on a worker failure with
``FailureConfig(max_failures=N)`` the whole group is torn down, formed
again and restarted from the latest reported checkpoint.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger("ray_tpu_torch.train")


@dataclass
class Result:
    metrics: dict = field(default_factory=dict)
    checkpoint: Checkpoint | None = None
    error: BaseException | None = None
    metrics_history: list = field(default_factory=list)

    @property
    def best_checkpoint(self) -> Checkpoint | None:
        return self.checkpoint


class BaseTrainer:
    """Subclasses implement fit()."""

    def __init__(self, *, scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 resume_from_checkpoint: Checkpoint | None = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError


class DataParallelTrainer(BaseTrainer):
    """Runs train_loop_per_worker on a gang of workers; streams reports."""

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None,
                 resume_from_checkpoint: Checkpoint | None = None):
        super().__init__(scaling_config=scaling_config, run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.datasets = datasets or {}

    # ------------------------------------------------------------------ fit

    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        max_failures = self.run_config.failure_config.max_failures
        storage = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_train")
        # Unique default name: two fits started within one second must
        # not share a checkpoint manager's directory.
        name = self.run_config.name or (
            f"train_{int(time.time())}_{os.getpid()}_"
            f"{os.urandom(3).hex()}")
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(storage, name), num_to_keep=ckpt_cfg.num_to_keep)

        attempt = 0
        resume = self.resume_from_checkpoint
        last_error: BaseException | None = None
        all_history: list = []
        while attempt <= max(0, max_failures):
            self._before_attempt()
            try:
                result = self._run_attempt(manager, resume)
            except BaseException as exc:  # noqa: BLE001 — group formation
                result = Result(error=exc)
            all_history.extend(result.metrics_history)
            result.metrics_history = all_history
            if result.error is None:
                return result
            last_error = result.error
            resume = manager.latest_checkpoint() or resume
            attempt += 1
            logger.warning(
                "Training attempt %d failed (%r); %s", attempt, result.error,
                "restarting from last checkpoint" if attempt <= max_failures
                else "giving up")
        final = Result(error=last_error)
        final.checkpoint = manager.latest_checkpoint()
        return final

    def _before_attempt(self) -> None:
        """Hook run before each (re)start of the worker group."""

    def _run_attempt(self, manager: CheckpointManager,
                     resume: Checkpoint | None) -> Result:
        results_queue: queue.Queue = queue.Queue()
        stop_event = threading.Event()
        group = WorkerGroup(self.scaling_config, stop=self.run_config.stop)
        config = dict(self.train_loop_config)
        loop = self.train_loop_per_worker
        if self.datasets:
            # Each worker iterates its shard.
            config["__datasets__"] = self.datasets
            loop = _wrap_with_datasets(loop, self.scaling_config.num_workers)
        try:
            refs = group.run(loop, config, results_queue, stop_event, resume)
            return self._collect(refs, results_queue, manager, stop_event,
                                 group.flush)
        finally:
            group.shutdown()

    def _collect(self, refs, results_queue, manager, stop_event,
                 flush) -> Result:
        n = self.scaling_config.num_workers
        done_ranks: set[int] = set()
        last_metrics: dict = {}
        history: list[dict] = []
        error: BaseException | None = None
        stop_criteria = self.run_config.stop or {}
        timeout_s = self.run_config.report_timeout_s
        pending_refs = list(refs)
        deadline = time.monotonic() + timeout_s
        while len(done_ranks) < n and error is None:
            try:
                msg = results_queue.get(timeout=1.0)
            except queue.Empty:
                # A worker that died without reporting surfaces on its run
                # ref: don't sit out the report timeout.
                if pending_refs:
                    finished, pending_refs = ray_tpu_torch.wait(
                        pending_refs, num_returns=len(pending_refs),
                        timeout=0)
                    for ref in finished:
                        try:
                            ray_tpu_torch.get(ref)
                        except BaseException as exc:  # noqa: BLE001
                            error = exc
                            break
                if error is not None:
                    # A process gang's reports may still be in its
                    # channel: take them (a checkpoint among them is the
                    # one to resume from) before failing the attempt.
                    flush(results_queue)
                    while not results_queue.empty():
                        msg = results_queue.get()
                        if msg["rank"] == 0 and not msg.get("done"):
                            last_metrics = msg["metrics"]
                            history.append(msg["metrics"])
                            if msg.get("checkpoint") is not None:
                                manager.register(msg["checkpoint"],
                                                 msg["metrics"])
                    break
                if time.monotonic() > deadline:
                    error = TimeoutError(
                        f"no training report within "
                        f"report_timeout_s={timeout_s}")
                    break
                continue
            deadline = time.monotonic() + timeout_s
            if msg.get("done"):
                done_ranks.add(msg["rank"])
                if msg.get("error") is not None:
                    error = msg["error"]
                continue
            if msg["rank"] == 0:
                last_metrics = msg["metrics"]
                history.append(msg["metrics"])
                if msg.get("checkpoint") is not None:
                    manager.register(msg["checkpoint"], msg["metrics"])
                for key, threshold in stop_criteria.items():
                    if key in last_metrics and last_metrics[key] >= threshold:
                        stop_event.set()
            # Other ranks' checkpoints are ignored: rank 0 saves the
            # (sharded) state.
        if error is not None:
            stop_event.set()
        return Result(metrics=last_metrics,
                      checkpoint=manager.latest_checkpoint(), error=error,
                      metrics_history=history)


def _wrap_with_datasets(loop: Callable, num_workers: int) -> Callable:
    def wrapped(config: dict):
        from ray_tpu_torch.train.session import get_context

        datasets = config.pop("__datasets__", {})
        rank = get_context().get_world_rank()
        config["datasets"] = {
            name: ds.shard(num_workers, rank) if hasattr(ds, "shard") else ds
            for name, ds in datasets.items()
        }
        return loop(config)

    return wrapped


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


class MeshTrainer(DataParallelTrainer):
    """The framework trainer of the port (the reference's JaxTrainer).

    ``dist_config`` forms the ``torch.distributed`` world on every
    worker before the loop runs:

    - ``None``: no world is formed here. A ``WORLD_SIZE`` in the
      environment (a launcher's) takes the ``env://`` path; otherwise
      ``session.get_mesh()`` brings up a world of one;
    - a dict of ``torch.distributed.init_process_group`` keywords, its
      ``rank`` taken from the gang rank unless given;
    - ``"auto"``: this driver picks a ``tcp://localhost`` rendezvous,
      fresh for each attempt, NCCL for a ``use_gpu`` gang and gloo
      otherwise. A thread gang of more than one worker cannot form such
      a world (one process), so that raises ``ValueError``; a process
      gang (``use_process_workers``) can.

    In a thread gang only a second initialisation of the default group
    is tolerated. A process gang's worker forms its world through
    ``_private/dist.py`` (the card it leased for NCCL) and destroys it
    when its loop ends.
    """

    def __init__(self, train_loop_per_worker: Callable,
                 dist_config: "dict | str | None" = None, **kwargs):
        scaling = kwargs.get("scaling_config") or ScalingConfig()
        self._auto = dist_config == "auto"
        if self._auto:
            if scaling.num_workers > 1 and not scaling.use_process_workers:
                raise ValueError(
                    "dist_config='auto' with num_workers>1 requires "
                    "ScalingConfig(use_process_workers=True): thread "
                    "workers share one process and can never form a "
                    "multi-process torch.distributed world")
            dist_config = {"backend": "nccl" if scaling.use_gpu else "gloo",
                           "world_size": scaling.num_workers}
            self._refresh_rendezvous(dist_config)
        self.dist_config = dist_config
        super().__init__(
            self._dist_backend_wrap(train_loop_per_worker, dist_config,
                                    scaling.use_gpu), **kwargs)

    @staticmethod
    def _refresh_rendezvous(config: dict) -> None:
        config["init_method"] = f"tcp://localhost:{_free_port()}"

    def _before_attempt(self) -> None:
        # A fresh port per (re)start: the previous gang's rendezvous may
        # still hold the old one. The loop wrapper closes over this dict,
        # so the change reaches the workers.
        if self._auto:
            self._refresh_rendezvous(self.dist_config)

    @staticmethod
    def _dist_backend_wrap(loop: Callable, dist_config: dict | None,
                           use_gpu: bool) -> Callable:
        def wrapped(config):
            import torch
            import torch.distributed as dist

            from ray_tpu_torch._private import dist as dist_mod
            from ray_tpu_torch._private.worker_pool import IN_WORKER_ENV
            from ray_tpu_torch.train.session import get_context

            formed = False
            if dist_config is not None:
                cfg = dict(dist_config)
                cfg.setdefault("rank", get_context().get_world_rank())
                if os.environ.get(IN_WORKER_ENV):
                    dist_mod.init_world(**cfg)
                    formed = True
                else:
                    try:
                        dist.init_process_group(**cfg)
                    except ValueError as e:
                        # Tolerate only a second initialisation (thread
                        # workers share the process, and a restart runs
                        # in it again); anything else must fail loudly,
                        # or the gang trains with the wrong world.
                        if "twice" not in str(e):
                            raise
            elif "WORLD_SIZE" in os.environ:
                dist_mod.ensure_process_group(
                    torch.device("cuda" if use_gpu else "cpu"))
            try:
                return loop(config)
            finally:
                if formed and dist.is_initialized():
                    dist.destroy_process_group()

        return wrapped
