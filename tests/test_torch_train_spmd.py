"""The port's process train gangs against the JAX package's.

The mirrored case of tests/test_train_spmd.py,
``test_process_worker_gang_reports_and_stops``, runs once through
``ray_tpu`` (``JaxTrainer``) and once through ``ray_tpu_torch``
(``MeshTrainer``), each gang two process workers under one runtime of
its package, and returns a plain record; the two must be equal, and
equal to what the mirrored test asserts.

``test_jax_trainer_two_process_spmd_mesh`` skips wherever jaxlib cannot
run a computation across two CPU processes, so its port runs against
that test's own expected value instead: a 2-process gloo gang
(``dist_config="auto"``) computes the global mean of 8 rows of
``arange(8)**2`` split by rank.

Where the port deliberately differs from the reference: ``"auto"``
forms a ``torch.distributed`` world (gloo here, NCCL for a ``use_gpu``
gang, each process on the card it leased) where the reference calls
``jax.distributed.initialize``; each gang process tears its world down
when its loop ends; and the report channel applies the run's stop
criteria itself, so the report that meets them is answered with the
stop.

The daemon-node case (tests/test_train_spmd.py:137) runs last, on a
cluster of each package of its own (a head in this process, two worker
daemons, a driver of no CPU): a ``STRICT_SPREAD`` gang of two process
workers forms one world (``jax.distributed`` there, a gloo world here)
and reports every member's pid and parent pid, so the record holds the
world's size and how many distinct daemons the members descend from.
"""

import time

import numpy as np
import pytest
from torch_time_limit import time_limit

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as jax_train
from ray_tpu_torch import train as port_train

PACKAGES = {"ray_tpu": (ray_tpu, jax_train, jax_train.JaxTrainer),
            "ray_tpu_torch": (ray_tpu_torch, port_train,
                              port_train.MeshTrainer)}
EXPECTED_MEAN = float(np.mean(np.arange(8, dtype=np.float32)[:, None] ** 2
                              * np.ones((1, 4))))


@pytest.fixture(scope="module")
def runtimes():
    for rt, _, _ in PACKAGES.values():
        rt.shutdown()
        rt.init(num_cpus=4)
    yield PACKAGES
    for rt, _, _ in PACKAGES.values():
        rt.shutdown()


def gang_reports_and_stops(train, trainer_cls):
    report = train.report

    def loop(config):
        for i in range(50):
            report({"score": i})

    result = trainer_cls(
        loop, scaling_config=train.ScalingConfig(num_workers=2,
                                                 use_process_workers=True),
        run_config=train.RunConfig(stop={"score": 5},
                                   report_timeout_s=60.0)).fit()
    return [repr(result.error) if result.error else None,
            5 <= result.metrics["score"] < 50]


def test_process_worker_gang_reports_and_stops_parity(runtimes):
    records = {name: gang_reports_and_stops(train, trainer_cls)
               for name, (_, train, trainer_cls) in runtimes.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [None, True]


def test_two_process_gloo_gang_global_mean(runtimes):
    def spmd_loop(config):
        import torch
        import torch.distributed as dist

        # The gang formed one gloo world of two processes; each holds
        # its rank's 4 rows of the global [8, 4] batch.
        rank = port_train.get_context().get_world_rank()
        rows = torch.arange(4 * rank, 4 * rank + 4, dtype=torch.float32)
        batch = rows[:, None] * torch.ones(1, 4)
        total = (batch * batch).sum()
        dist.all_reduce(total)
        port_train.report({"loss": float(total) / 32,
                           "world": dist.get_world_size(), "rank": rank,
                           "backend": dist.get_backend()})

    result = port_train.MeshTrainer(
        spmd_loop, dist_config="auto",
        scaling_config=port_train.ScalingConfig(num_workers=2,
                                                use_process_workers=True),
        run_config=port_train.RunConfig(report_timeout_s=120.0)).fit()
    assert result.error is None, result.error
    assert result.metrics["world"] == 2
    assert result.metrics["backend"] == "gloo"
    assert abs(result.metrics["loss"] - EXPECTED_MEAN) < 1e-5


# ------------------------------------- the gang across two daemons (last)


def _jax_daemon_loop(config):
    """tests/test_train_spmd.py's ``_multinode_loop``: every member's pid
    and parent pid, all-gathered across the ``jax.distributed`` world."""
    import os

    import jax
    import numpy as np
    from jax.experimental import multihost_utils

    from ray_tpu import train

    def parent_pid() -> int:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("PPid:"):
                    return int(line.split()[1])
        return -1

    mine = np.array([os.getpid(), parent_pid()], dtype=np.int64)
    gathered = multihost_utils.process_allgather(mine)
    train.report({"world": jax.process_count(),
                  "pids": [int(x) for x in gathered[:, 0]],
                  "ppids": [int(x) for x in gathered[:, 1]]})


def _torch_daemon_loop(config):
    """The same over the gang's gloo world."""
    import os

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train

    def parent_pid() -> int:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("PPid:"):
                    return int(line.split()[1])
        return -1

    mine = torch.tensor([os.getpid(), parent_pid()], dtype=torch.int64)
    gathered = [torch.zeros(2, dtype=torch.int64)
                for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    train.report({"world": dist.get_world_size(),
                  "pids": [int(t[0]) for t in gathered],
                  "ppids": [int(t[1]) for t in gathered]})


def _daemon_ancestor(pid: int, daemon_pids: set) -> "int | None":
    """Up from a gang process: daemon -> (fork server ->) gang worker."""
    for _ in range(3):
        if pid in daemon_pids:
            return pid
        try:
            with open(f"/proc/{pid}/status") as f:
                pid = int(next(line.split()[1] for line in f
                               if line.startswith("PPid:")))
        except (OSError, StopIteration):
            return None
    return pid if pid in daemon_pids else None


def gang_spans_two_daemons(name: str, log_dir) -> dict:
    import importlib

    rt, train, trainer_cls = PACKAGES[name]
    rt.shutdown()
    cluster = importlib.import_module(f"{name}.cluster_utils").Cluster(
        log_dir=str(log_dir / name))
    try:
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        assert cluster.wait_for_nodes(2, timeout=60)
        rt.init(num_cpus=0, address=cluster.address)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline \
                and rt.cluster_resources().get("CPU", 0) < 4:
            time.sleep(0.05)
        assert rt.cluster_resources().get("CPU", 0) >= 4
        if name == "ray_tpu":
            scaling = train.ScalingConfig(
                num_workers=2, use_process_workers=True,
                placement_strategy="STRICT_SPREAD",
                worker_env={"XLA_FLAGS":
                            "--xla_force_host_platform_device_count=2"})
            trainer = trainer_cls(
                _jax_daemon_loop, jax_distributed_config="auto",
                scaling_config=scaling,
                run_config=train.RunConfig(report_timeout_s=180.0))
        else:
            scaling = train.ScalingConfig(
                num_workers=2, use_process_workers=True,
                placement_strategy="STRICT_SPREAD")
            trainer = trainer_cls(
                _torch_daemon_loop, dist_config="auto",
                scaling_config=scaling,
                run_config=train.RunConfig(report_timeout_s=180.0))
        result = trainer.fit()
        if result.error is not None:
            return {"error": repr(result.error)}
        daemon_pids = {n.pid for n in cluster.worker_nodes}
        ancestors = {_daemon_ancestor(p, daemon_pids)
                     for p in result.metrics["ppids"]}
        return {"error": None, "world": result.metrics["world"],
                "members": len(set(result.metrics["pids"])),
                "all_under_daemons": None not in ancestors
                and ancestors <= daemon_pids,
                "distinct_daemons": len(ancestors - {None})}
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_gang_spans_two_daemon_nodes_parity(tmp_path):
    """tests/test_train_spmd.py:137: a STRICT_SPREAD gang of two process
    workers on two worker daemons forms one world of two, its members
    children of two different daemons."""
    with time_limit(360):
        records = {name: gang_spans_two_daemons(name, tmp_path)
                   for name in PACKAGES}
    assert records["ray_tpu_torch"] == records["ray_tpu"] == {
        "error": None, "world": 2, "members": 2, "all_under_daemons": True,
        "distinct_daemons": 2}
