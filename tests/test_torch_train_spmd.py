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
stop. The daemon-node case (two worker daemons) waits for remote nodes
(ROADMAP queue 1, item 10).
"""

import numpy as np
import pytest

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
