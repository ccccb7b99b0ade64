"""WorkerGroup: the gang of training actors.

The port of ``ray_tpu/train/worker_group.py``: one ``TrainWorker`` actor
per rank, each in its own bundle of one placement group
(``ScalingConfig.placement_strategy``), so the gang is placed all or
nothing and a ``use_gpu`` gang holds its ``GPU`` share until
``shutdown`` removes the group. A worker is a thread of this process, or
with ``use_process_workers`` a process actor (``worker_env`` in its
environment); a queue cannot cross the process boundary, so a process
gang reports through a ``_TrainChannel`` actor, and a pump of this
process forwards the reports to the trainer's queue and the trainer's
stop back.

On a cluster the group places the gang onto worker daemons, as the
reference's does: a bundle the group reserved on a daemon makes its
worker an actor in that daemon's tree (forked from its fork server, or
for a ``GPU`` worker a fresh interpreter on the card its lease names),
so a ``STRICT_SPREAD`` gang has one member under each daemon, and
``MeshTrainer(dist_config="auto")`` forms one world across them
(``_private/dist.init_world``; gloo on the CPU). The channel stays in
this driver.
"""

from __future__ import annotations

import threading
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
class _TrainChannel:
    """The report and stop channel of a process gang: workers report
    through it (the nested API) and learn the stop flag from each
    report's reply. It holds the run's stop criteria too, so the report
    that meets them is answered with the stop at once (the driver's pump
    learns of it a poll later)."""

    def __init__(self, stop: dict | None = None):
        self._msgs: list = []
        self._stop = False
        self._criteria = dict(stop or {})

    def report(self, msg: dict) -> bool:
        self._msgs.append(msg)
        metrics = msg.get("metrics") or {}
        if msg.get("rank") == 0 and any(
                k in metrics and metrics[k] >= v
                for k, v in self._criteria.items()):
            self._stop = True
        return self._stop

    def drain(self) -> list:
        out, self._msgs = self._msgs, []
        return out

    def set_stop(self) -> None:
        self._stop = True


class _ChannelReporter:
    """The worker's side: a queue and a stop flag over the channel."""

    class _Flag:
        def __init__(self):
            self._set = False

        def is_set(self) -> bool:
            return self._set

    def __init__(self, channel_handle):
        self._channel = channel_handle
        self.stop_flag = self._Flag()

    def put(self, msg: dict) -> None:
        if ray_tpu_torch.get(self._channel.report.remote(msg)):
            self.stop_flag._set = True


@ray_tpu_torch.remote
class TrainWorker:
    """One member of the gang; runs the user loop in its actor thread
    (its own process in a process gang)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size

    def run(self, fn: Callable, config: dict, results_queue, stop_event,
            resume_checkpoint) -> Any:
        if stop_event is None:
            # A process gang: results_queue is the channel's handle, and
            # its replies carry the stop.
            reporter = _ChannelReporter(results_queue)
            results_queue, stop_event = reporter, reporter.stop_flag
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

    def __init__(self, scaling: ScalingConfig, stop: dict | None = None):
        self.scaling = scaling
        self.stop = stop
        self.workers: list = []
        self.pg = None
        self.channel = None
        self._pump_stop = threading.Event()
        # One flush at a time, so the reports keep their order.
        self._flush_lock = threading.Lock()
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
        if self.scaling.use_process_workers:
            options: dict = {"process": True}
            if self.scaling.worker_env:
                options["runtime_env"] = {
                    "env_vars": dict(self.scaling.worker_env)}
            worker_cls = worker_cls.options(**options)
            self.channel = _TrainChannel.remote(self.stop)
        try:
            self.workers = [worker_cls.remote(rank, n) for rank in range(n)]
            # A process worker boots an interpreter (a GPU one, a CUDA
            # context too) before it answers.
            ray_tpu_torch.get([w.ping.remote() for w in self.workers],
                              timeout=300)
        except BaseException:
            # Don't leak the committed bundles or a half-started gang.
            self.shutdown()
            raise

    def run(self, fn: Callable, config: dict, results_queue,
            stop_event, resume_checkpoint) -> list:
        """Kick off the loop on every worker; returns refs."""
        if self.channel is not None:
            self._start_pump(results_queue, stop_event)
            return [w.run.remote(fn, config, self.channel, None,
                                 resume_checkpoint)
                    for w in self.workers]
        return [
            w.run.remote(fn, config, results_queue, stop_event,
                         resume_checkpoint)
            for w in self.workers
        ]

    def flush(self, results_queue) -> None:
        """Move what the channel holds into ``results_queue`` now (a
        process gang's reports that came before its failure)."""
        with self._flush_lock:
            if self.channel is not None:
                for msg in ray_tpu_torch.get(self.channel.drain.remote()):
                    results_queue.put(msg)

    def _start_pump(self, results_queue, stop_event) -> None:
        def pump():
            stop_sent = False
            while not self._pump_stop.is_set():
                try:
                    self.flush(results_queue)
                except Exception:  # noqa: BLE001 — the channel is gone: done
                    return
                if stop_event.is_set() and not stop_sent:
                    stop_sent = True
                    self.channel.set_stop.remote()
                self._pump_stop.wait(0.05)

        threading.Thread(target=pump, daemon=True,
                         name="ray_tpu_torch-train-channel-pump").start()

    def shutdown(self):
        self._pump_stop.set()
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — worker already dead
                pass
        if self.channel is not None:
            ray_tpu_torch.kill(self.channel)
            self.channel = None
        if self.pg is not None:
            remove_placement_group(self.pg)
            self.pg = None
        self.workers = []
