"""The port's pipelined execute path against the JAX package's: batched
dispatch, multi-task worker leases and grouped result seals on a real
daemon cluster (the cases of tests/test_task_pipeline.py and
tests/test_p2p_broadcast.py's batched submission under a daemon's
death).

Each case is a scenario run once against a ``ray_tpu`` cluster and once
against a ``ray_tpu_torch`` one (a head in this process, daemons as
processes, a driver with no CPU, so every task rides the remote path);
the two records must be equal, and equal to what the reference test
asserts. The five cases of tests/test_task_pipeline.py share one
module-scoped cluster per package: one 2-CPU daemon with fused
execution off (these cases hold the worker pipeline itself), whose
pool survives the worker crashes two of them cause.
"""

import os
import tempfile
import time

import pytest
from torch_cluster_sides import Side, both, start_clusters, stop_clusters
from torch_time_limit import time_limit

FUSED_OFF = {"RAY_TPU_FUSED_EXECUTION": "0",
             "RAY_TPU_TORCH_FUSED_EXECUTION": "0"}


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    sides = start_clusters(tmp_path_factory.mktemp("pipeline"),
                           [{"num_cpus": 2, "env": FUSED_OFF}])
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


def _batch_counters(side: Side) -> dict:
    agg = {"batch_rpcs": 0, "batch_tasks": 0, "frames": 0}
    for handle in side.handles():
        pipe = handle._control.call("executor_stats").get("pipeline", {})
        agg["batch_rpcs"] += int(pipe.get("batch_rpcs", 0))
        agg["batch_tasks"] += int(pipe.get("batch_tasks", 0))
        agg["frames"] += int(pipe.get("worker_pipelined_frames", 0))
    return agg


def result_mapping(side: Side) -> dict:
    @side.rt.remote
    def ident(i):
        import os

        return (i, os.getpid())

    out = side.rt.get([ident.remote(i) for i in range(120)], timeout=120.0)
    agg = _batch_counters(side)
    return {"mapping": [v[0] for v in out] == list(range(120)),
            "batched": agg["batch_tasks"] > 0, "frames": agg["frames"] > 0}


def test_batch_dispatch_preserves_result_mapping(pipeline):
    with time_limit(300):
        assert both(result_mapping, pipeline) == {
            "mapping": True, "batched": True, "frames": True}


def failure_isolation(side: Side) -> dict:
    @side.rt.remote
    def maybe_boom(i):
        if i % 10 == 3:
            raise ValueError(f"boom-{i}")
        return i

    refs = [maybe_boom.remote(i) for i in range(60)]
    failures, values = 0, 0
    for i, ref in enumerate(refs):
        if i % 10 == 3:
            with pytest.raises(Exception) as exc_info:
                side.rt.get(ref, timeout=120.0)
            assert f"boom-{i}" in str(exc_info.value)
            failures += 1
        else:
            assert side.rt.get(ref, timeout=120.0) == i
            values += 1
    return {"failures": failures, "values": values}


def test_failure_isolation_inside_batch(pipeline):
    with time_limit(300):
        assert both(failure_isolation, pipeline) == {"failures": 6,
                                                     "values": 54}


def cancellation(side: Side) -> dict:
    cancelled_error = side.exceptions().TaskCancelledError

    @side.rt.remote(num_cpus=1)
    def slowish(i):
        import time

        time.sleep(0.25)
        return i

    refs = [slowish.remote(i) for i in range(40)]
    first = side.rt.get(refs[0], timeout=60.0)
    for ref in refs[20:]:
        side.rt.cancel(ref)
    head = side.rt.get(refs[1:8], timeout=120.0)
    cancelled, wrong = 0, 0
    for i, ref in enumerate(refs[20:], start=20):
        try:
            wrong += side.rt.get(ref, timeout=120.0) != i
        except cancelled_error:
            cancelled += 1
    return {"first": first, "head": head, "some_cancelled": cancelled > 0,
            "wrong": wrong,
            "healthy": side.rt.get(slowish.remote(-1), timeout=60.0)}


def test_cancellation_mid_batch(pipeline):
    with time_limit(300):
        assert both(cancellation, pipeline) == {
            "first": 0, "head": list(range(1, 8)), "some_cancelled": True,
            "wrong": 0, "healthy": -1}


def crash_unstarted(side: Side) -> dict:
    crashed_error = side.exceptions().WorkerCrashedError

    @side.rt.remote(max_retries=0)
    def die_once(i, marker_dir):
        import os

        if i == 5:
            marker = os.path.join(marker_dir, f"died-{i}")
            if not os.path.exists(marker):
                with open(marker, "w"):
                    pass
                os._exit(1)
        return i

    marker_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_crash_test_")
    refs = [die_once.remote(i, marker_dir) for i in range(30)]
    crashed, completed = [], []
    for i, ref in enumerate(refs):
        try:
            assert side.rt.get(ref, timeout=120.0) == i
            completed.append(i)
        except crashed_error:
            crashed.append(i)
    return {"crashed": crashed, "completed": len(completed)}


def test_worker_crash_mid_pipeline_retries_unstarted(pipeline):
    with time_limit(300):
        assert both(crash_unstarted, pipeline) == {"crashed": [5],
                                                   "completed": 29}


def crash_retry(side: Side) -> dict:
    marker_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_retry_test_")

    @side.rt.remote(max_retries=2)
    def attempt(i, marker_dir):
        import os

        marker = os.path.join(marker_dir, f"attempts-{i}")
        with open(marker, "a") as f:
            f.write("x")
        if i == 7 and os.path.getsize(marker) == 1:
            os._exit(1)
        return i

    out = side.rt.get([attempt.remote(i, marker_dir) for i in range(20)],
                      timeout=120.0)
    attempts = [os.path.getsize(os.path.join(marker_dir, f"attempts-{i}"))
                for i in range(20)]
    return {"out": out, "attempts": attempts}


def test_worker_crash_retry_reruns_only_killed_task(pipeline):
    with time_limit(300):
        assert both(crash_retry, pipeline) == {
            "out": list(range(20)),
            "attempts": [2 if i == 7 else 1 for i in range(20)]}


# --------------------------- a cluster of its own (a daemon is killed)


def daemon_death(side: Side) -> dict:
    @side.rt.remote(num_cpus=1, max_retries=4)
    def work(i):
        import time

        time.sleep(0.05)
        return i * 3

    refs = [work.remote(i) for i in range(40)]
    time.sleep(0.3)  # let batched frames land on both daemons
    victim = side.cluster.worker_nodes[0]
    side.cluster.remove_node(victim, allow_graceful=False)  # SIGKILL
    return {"out": side.rt.get(refs, timeout=180)}


def test_batched_submission_correct_under_worker_death(tmp_path):
    with time_limit(400):
        sides = start_clusters(tmp_path, [{"num_cpus": 2},
                                          {"num_cpus": 2}])
        try:
            assert both(daemon_death, sides) == {
                "out": [i * 3 for i in range(40)]}
        finally:
            stop_clusters({n: s.cluster for n, s in sides.items()})
