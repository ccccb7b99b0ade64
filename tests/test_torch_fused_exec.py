"""The port's fused in-daemon execution, batch over-subscription and raw
small-value framing against the JAX package's (the cases of
tests/test_fused_exec.py).

Each cluster case is a scenario run once against a ``ray_tpu`` cluster
and once against a ``ray_tpu_torch`` one (one 4-CPU daemon, a driver
with no CPU, so every task rides the batch path); the records must be
equal, and equal to what the reference test asserts. The cases share
one module-scoped cluster per package, so each reads its counters as
the change over its own run. A counter the driver updates after the
results it reports were sealed is waited for, not read at once. The
disarmed case (``fused_execution`` off) starts its own cluster.
"""

import os
import tempfile
import time

import pytest
from torch_cluster_sides import (
    PACKAGES,
    Side,
    both,
    start_clusters,
    stop_clusters,
    wait_until,
)
from torch_time_limit import time_limit


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    sides = start_clusters(tmp_path_factory.mktemp("fused"),
                           [{"num_cpus": 4}])
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


def _daemon_pipeline(side: Side) -> dict:
    agg: dict = {}
    for handle in side.handles():
        pipe = handle._control.call("executor_stats").get("pipeline", {})
        for key, value in pipe.items():
            agg[key] = agg.get(key, 0) + int(value)
    return agg


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _driver_fused(side: Side) -> dict:
    return dict(side.runtime.execution_pipeline_stats()["fused"])


def fused_run(side: Side) -> dict:
    @side.rt.remote(num_cpus=1)
    def ident(i):
        import os

        return (i, os.getpid())

    # Warm the function's digest on the daemon first (a first-contact
    # batch would answer need_func and run classically).
    warm = side.rt.get(ident.remote(-1), timeout=60.0)[0]
    # The driver mirrors a batch RPC's fused count off its final reply,
    # which may land after the warm task's result: settle first.
    wait_until(lambda: _driver_fused(side)["fused_tasks"]
               == _daemon_pipeline(side)["fused_tasks"], 30)
    pipe0, drv0 = _daemon_pipeline(side), _driver_fused(side)
    out = side.rt.get([ident.remote(i) for i in range(300)], timeout=120.0)
    pipe = _delta(_daemon_pipeline(side), pipe0)
    daemon_pid = side.handles()[0]._control.call("exec_ping")
    pids = {v[1] for v in out}
    # The driver's mirror lands after the batch RPC's final reply.
    mirrored = wait_until(lambda: _delta(_driver_fused(side), drv0)
                          ["fused_tasks"] == pipe["fused_tasks"], 30)
    fully = pipe["fused_fallbacks"] == 0
    return {"warm": warm, "mapping": [v[0] for v in out] == list(range(300)),
            "fused_tasks": pipe["fused_tasks"] > 0,
            "fused_runs": pipe["fused_runs"] > 0,
            "in_daemon": daemon_pid in pids,
            "accounted": pipe["fused_tasks"] + pipe["fused_fallbacks"] >= 300,
            "no_pipe_when_fully_fused": (not fully) or (
                pipe["worker_pipelined_frames"] == 0
                and pids == {daemon_pid}),
            "driver_mirror": mirrored
            and _delta(_driver_fused(side), drv0)["fused_runs"] > 0}


def test_fused_run_executes_in_daemon_without_worker_pipe(fused):
    with time_limit(300):
        assert both(fused_run, fused) == {
            "warm": -1, "mapping": True, "fused_tasks": True,
            "fused_runs": True, "in_daemon": True, "accounted": True,
            "no_pipe_when_fully_fused": True, "driver_mirror": True}


def wall_budget(side: Side) -> dict:
    @side.rt.remote(num_cpus=1)
    def slow(i):
        import time

        time.sleep(0.15)
        return i

    pipe0, drv0 = _daemon_pipeline(side), _driver_fused(side)
    out = side.rt.get([slow.remote(i) for i in range(10)], timeout=120.0)
    pipe = _delta(_daemon_pipeline(side), pipe0)
    return {"out": out, "fused": pipe["fused_tasks"] >= 1,
            "fallbacks": pipe["fused_fallbacks"] >= 1,
            "frames": pipe["worker_pipelined_frames"] >= 1,
            "driver_fallbacks": wait_until(
                lambda: _delta(_driver_fused(side), drv0)
                ["fused_fallbacks"] >= 1, 30)}


def test_fused_wall_budget_spills_to_worker_path(fused):
    with time_limit(300):
        assert both(wall_budget, fused) == {
            "out": list(range(10)), "fused": True, "fallbacks": True,
            "frames": True, "driver_fallbacks": True}


def deadline(side: Side) -> dict:
    timeout_error = side.exceptions().TaskTimeoutError

    @side.rt.remote(num_cpus=1)
    def mark(path):
        with open(path, "w"):
            pass
        return "ran"

    mdir = tempfile.mkdtemp(prefix="ray_tpu_torch_fused_dl_")
    ref = mark.options(_deadline_s=0.0001).remote(os.path.join(mdir, "m0"))
    with pytest.raises(timeout_error):
        side.rt.get(ref, timeout=60.0)
    time.sleep(0.3)
    return {"ran": os.listdir(mdir)}


def test_fused_deadline_seals_typed_timeout(fused):
    with time_limit(120):
        assert both(deadline, fused) == {"ran": []}


def cancel_queued(side: Side) -> dict:
    cancelled_error = side.exceptions().TaskCancelledError

    @side.rt.remote(num_cpus=4)
    def hog():
        import time

        time.sleep(0.8)
        return "hog"

    @side.rt.remote(num_cpus=4)
    def queued():
        return "ran"

    @side.rt.remote(num_cpus=1)
    def probe():
        return 7

    blocker = hog.remote()
    tail = queued.remote()
    side.rt.cancel(tail)
    with pytest.raises(cancelled_error):
        side.rt.get(tail, timeout=60.0)
    return {"hog": side.rt.get(blocker, timeout=60.0),
            "probe": side.rt.get(probe.remote(), timeout=60.0)}


def test_fused_cancel_queued_task(fused):
    with time_limit(120):
        assert both(cancel_queued, fused) == {"hog": "hog", "probe": 7}


def overcommit(side: Side, n: int = 3000) -> dict:
    @side.rt.remote(num_cpus=1)
    def noop(i):
        return i

    disp0 = dict(side.runtime.execution_pipeline_stats()["dispatch"])
    pipe0 = _daemon_pipeline(side)
    out = side.rt.get([noop.remote(i) for i in range(n)], timeout=300.0)
    disp = _delta(side.runtime.execution_pipeline_stats()["dispatch"],
                  disp0)
    pipe = _delta(_daemon_pipeline(side), pipe0)
    return {"out": out == list(range(n)),
            "overcommit": disp["batch_overcommit"] > 0,
            "rpcs": pipe["batch_rpcs"] > 0,
            "deep": pipe["batch_tasks"] / max(1, pipe["batch_rpcs"]) > 4.0}


def test_batch_overcommit_beats_per_node_slot_cap(fused):
    with time_limit(400):
        assert both(overcommit, fused) == {"out": True, "overcommit": True,
                                           "rpcs": True, "deep": True}


def drain_100k(side: Side) -> dict:
    @side.rt.remote(num_cpus=1)
    def noop(i):
        return i

    refs = [noop.remote(i) for i in range(100_000)]
    drained = side.rt.get(refs[:10_000], timeout=1800.0)
    stats = side.runtime.execution_pipeline_stats()["dispatch"]
    pipe = _daemon_pipeline(side)
    for ref in refs[10_000:]:
        side.rt.cancel(ref)
    return {"drained": drained == list(range(10_000)),
            "overcommit": stats["batch_overcommit"] > 0,
            "deep": pipe["batch_tasks"] / max(1, pipe["batch_rpcs"]) > 4.0}


@pytest.mark.slow
def test_batch_overcommit_under_100k_drain(tmp_path):
    sides = start_clusters(tmp_path, [{"num_cpus": 4}])
    try:
        assert both(drain_100k, sides) == {"drained": True,
                                           "overcommit": True, "deep": True}
    finally:
        stop_clusters({n: s.cluster for n, s in sides.items()})


# ------------------------------------------------------------ raw framing


def _serialization(name: str):
    import importlib

    return importlib.import_module(f"{name}._private.serialization")


def raw_round_trip(serialization) -> dict:
    eligible = [None, True, False, 0, -1, 2**62, 3.5, float("inf"),
                "", "héllo", b"\x00bytes", (), (1, "x", (2.5, None)),
                {"k": 1, "nested": ("a", b"b")}, ((1, 2), {"kw": True})]
    kept = []
    for value in eligible:
        blob = serialization.try_serialize_raw(value)
        back = serialization.deserialize_from_buffer(memoryview(blob))
        kept.append(back == value and type(back) is type(value))
    ineligible = [2**70, [1, 2], {1: "non-str key"}, {"k": [1]},
                  object(), b"x" * 9000, "y" * 9000]
    refused = [serialization.try_serialize_raw(v) is None
               for v in ineligible]
    classic = serialization.serialize_framed({"a": [1, 2, 3]})
    a, b = serialization.deserialize_from_buffer(memoryview(
        serialization.try_serialize_raw((True, 1))))
    return {"kept": kept, "refused": refused,
            "classic": serialization.deserialize_from_buffer(
                memoryview(classic)),
            "bool_int": (a is True, type(b) is int)}


def test_raw_framing_round_trip_and_eligibility():
    records = {name: raw_round_trip(_serialization(name))
               for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "kept": [True] * 15, "refused": [True] * 7,
        "classic": {"a": [1, 2, 3]}, "bool_int": (True, True)}


def test_raw_framing_disarmed_produces_no_raw_frames(monkeypatch):
    for name in PACKAGES:
        serialization = _serialization(name)
        monkeypatch.setattr(serialization, "RAW_ON", False)
        assert serialization.try_serialize_raw(1) is None, name
        monkeypatch.setattr(serialization, "RAW_ON", True)
        assert serialization.try_serialize_raw(1) is not None, name


def mixed_types(side: Side) -> list:
    import numpy as np

    @side.rt.remote(num_cpus=1)
    def echo(x):
        return x

    values = [42, 3.5, "str", b"bytes", None, True, (1, "t"),
              {"k": (1, 2)}, [1, 2, 3], np.arange(16)]
    out = side.rt.get([echo.remote(v) for v in values], timeout=120.0)
    return [bool((got == sent).all()) if isinstance(sent, np.ndarray)
            else (got == sent and type(got) is type(sent))
            for sent, got in zip(values, out)]


def test_mixed_arg_result_types_through_fused_path(fused):
    with time_limit(120):
        assert both(mixed_types, fused) == [True] * 10


# -------------------------------------------------- disarmed equivalence


def nested_ref_child(side: Side) -> dict:
    @side.rt.remote(num_cpus=1)
    def child(x):
        return x * 2

    @side.rt.remote(num_cpus=1)
    def parent(x, rt_name):
        import importlib
        import os

        rt = importlib.import_module(rt_name)
        # The child takes a ref argument: it runs on the classic path,
        # which reserves this node's one CPU.
        return rt.get(child.remote(rt.put(x)), timeout=60) + 1, os.getpid()

    pipe0 = _daemon_pipeline(side)
    value, pid = side.rt.get(parent.remote(10, side.name), timeout=90)
    pipe = _delta(_daemon_pipeline(side), pipe0)
    daemon_pid = side.handles()[0]._control.call("exec_ping")
    return {"value": value, "available": wait_until(
                lambda: side.rt.available_resources().get("CPU") == 1.0),
            "parent_fused": pid == daemon_pid and pipe["fused_tasks"] == 1}


def test_fused_parent_gets_a_ref_bearing_child_on_one_cpu(tmp_path):
    """One daemon of one CPU: a fused parent blocked in get() on a child
    that takes a ref argument holds no reservation there, so the child
    is admitted on the classic path (no livelock of busy answers)."""
    with time_limit(300):
        sides = start_clusters(tmp_path, [{"num_cpus": 1, "pool_size": 1}])
        try:
            records = {name: nested_ref_child(side)
                       for name, side in sides.items()}
        finally:
            stop_clusters({n: s.cluster for n, s in sides.items()})
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "value": 21, "available": True, "parent_fused": True}, records


def test_fused_tasks_keep_their_token_and_driver_per_thread():
    """Port only: fused tasks of two drivers run at once on a daemon's
    threads. Each thread sees its own task token and its own driver's
    proxy; one task's end clears neither of the other's, and no proxy
    is replaced under a task that uses it."""
    import threading

    from ray_tpu_torch._private import worker_client

    entered, release = threading.Barrier(2), threading.Event()
    seen: dict = {}

    def task(address: str, token: str) -> None:
        worker_client.enter_daemon_task(address, token)
        try:
            first = worker_client.get_worker_runtime()
            entered.wait(10)
            if token == "t-b":
                release.wait(10)
            seen[token] = (worker_client.current_task_token(),
                           first._rpc.address,
                           worker_client.get_worker_runtime() is first,
                           first._rpc._closed)
        finally:
            worker_client.leave_daemon_task()
            if token == "t-a":
                release.set()

    env_before = os.environ.get(worker_client.ADDRESS_ENV)
    threads = [threading.Thread(target=task, args=args) for args in
               (("127.0.0.1:1", "t-a"), ("127.0.0.1:2", "t-b"))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(20)
    try:
        assert seen == {"t-a": ("t-a", "127.0.0.1:1", True, False),
                        "t-b": ("t-b", "127.0.0.1:2", True, False)}
        assert worker_client.current_task_token() is None
        assert not worker_client.in_daemon_task()
        assert os.environ.get(worker_client.ADDRESS_ENV) == env_before
    finally:
        for runtime in list(worker_client._daemon_runtimes.values()):
            runtime.shutdown()
    assert worker_client._daemon_runtimes == {}


def test_daemon_proxies_of_gone_drivers_are_closed_past_the_cap():
    """Port only: a long-lived daemon keeps at most a few proxies to
    drivers with no task running there (the oldest close first); one
    whose driver still has a task running stays open."""
    from ray_tpu_torch._private import worker_client

    kept = worker_client._DAEMON_RUNTIMES_KEPT
    made = []
    try:
        worker_client.enter_daemon_task("127.0.0.1:1", "t-busy")
        busy = worker_client.get_worker_runtime()
        for i in range(kept + 3):
            address = f"127.0.0.1:{i + 2}"
            thread_task(address, f"t{i}", made)
        assert not busy._rpc._closed
        # The busy driver's proxy counts toward the cap.
        assert [r._rpc._closed for r in made] \
            == [True] * 4 + [False] * (kept - 1)
        assert len(worker_client._daemon_runtimes) == kept
    finally:
        worker_client.leave_daemon_task()
        for runtime in list(worker_client._daemon_runtimes.values()):
            runtime.shutdown()
    assert worker_client._daemon_runtimes == {}


def thread_task(address: str, token: str, made: list) -> None:
    """A fused task of another driver on another thread of the daemon."""
    import threading

    from ray_tpu_torch._private import worker_client

    def run() -> None:
        worker_client.enter_daemon_task(address, token)
        try:
            made.append(worker_client.get_worker_runtime())
        finally:
            worker_client.leave_daemon_task()

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(10)


def disarmed(side: Side, tmp_path) -> dict:
    errors = side.exceptions()

    @side.rt.remote(num_cpus=1)
    def ident(i):
        import os

        return (i, os.getpid())

    out = side.rt.get([ident.remote(i) for i in range(200)], timeout=120.0)
    pipe = _daemon_pipeline(side)
    daemon_pid = side.handles()[0]._control.call("exec_ping")
    out2 = side.rt.get([ident.remote(i) for i in range(200)], timeout=120.0)
    pipe2 = _daemon_pipeline(side)

    @side.rt.remote(num_cpus=4)
    def hog():
        import time

        time.sleep(0.8)
        return "hog"

    @side.rt.remote(num_cpus=4)
    def queued():
        return "ran"

    blocker = hog.remote()
    tail = queued.remote()
    side.rt.cancel(tail)
    with pytest.raises(errors.TaskCancelledError):
        side.rt.get(tail, timeout=60.0)

    @side.rt.remote(num_cpus=1)
    def mark(path):
        with open(path, "w"):
            pass
        return "ran"

    mdir = tmp_path / f"markers-{side.name}"
    mdir.mkdir()
    with pytest.raises(errors.TaskTimeoutError):
        side.rt.get(mark.options(_deadline_s=0.0001).remote(
            str(mdir / "m0")), timeout=60.0)
    time.sleep(0.3)
    return {"out": [v[0] for v in out] == list(range(200)),
            "unfused": pipe["fused_runs"] == pipe["fused_tasks"] == 0,
            "frames": pipe["worker_pipelined_frames"] > 0,
            "in_workers": daemon_pid not in {v[1] for v in out},
            "out2": [v[0] for v in out2] == list(range(200)),
            "reuses": pipe2["runner_reuses"] > 0,
            "driver": side.runtime.execution_pipeline_stats()["fused"],
            "hog": side.rt.get(blocker, timeout=60.0),
            "ran": os.listdir(mdir)}


def test_fused_disarmed_fallback_equivalence(tmp_path, monkeypatch):
    import importlib

    configs = [importlib.import_module(f"{n}._private.config").GLOBAL_CONFIG
               for n in PACKAGES]
    executors = [importlib.import_module(f"{n}._private.node_executor")
                 for n in PACKAGES]
    monkeypatch.setenv("RAY_TPU_FUSED_EXECUTION", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_FUSED_EXECUTION", "0")
    for config, executor in zip(configs, executors):
        config.reset()
        executor.init_fused_from_config()
    env = {"RAY_TPU_FUSED_EXECUTION": "0",
           "RAY_TPU_TORCH_FUSED_EXECUTION": "0"}
    try:
        with time_limit(400):
            sides = start_clusters(tmp_path, [{"num_cpus": 4, "env": env}])
            try:
                assert both(lambda side: disarmed(side, tmp_path),
                            sides) == {
                    "out": True, "unfused": True, "frames": True,
                    "in_workers": True, "out2": True, "reuses": True,
                    "driver": {"fused_runs": 0, "fused_tasks": 0,
                               "fused_fallbacks": 0},
                    "hog": "hog", "ran": []}
            finally:
                stop_clusters({n: s.cluster for n, s in sides.items()})
    finally:
        monkeypatch.delenv("RAY_TPU_FUSED_EXECUTION", raising=False)
        monkeypatch.delenv("RAY_TPU_TORCH_FUSED_EXECUTION", raising=False)
        for config, executor in zip(configs, executors):
            config.reset()
            executor.init_fused_from_config()
