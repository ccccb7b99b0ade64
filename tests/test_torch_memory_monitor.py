"""The port's memory monitor, the OOM retry budget and the memory
watermark of admission against the JAX package's.

Each mirrored case (the three memory-monitor cases of
tests/test_dashboard_monitors.py and tests/test_overload.py's
``test_memory_watermark_shed``) runs once through ``ray_tpu`` and once
through ``ray_tpu_torch``, each under its own ``init`` and
``shutdown()``, and returns a plain record; the two records must be
equal, and equal to what the mirrored test asserts. The store axis of
the watermark (pressure the spill tier can relieve admits and kicks the
spiller) runs through both as well.

The port-only case at the end: no ``ray_tpu_torch`` thread (the spiller,
the heartbeat, the health checker, the memory monitor and the runtime's
own) outlives ``shutdown()``.
"""

import os
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import memory_monitor as jax_monitor
from ray_tpu._private.config import GLOBAL_CONFIG as JAX_CONFIG
from ray_tpu_torch._private import memory_monitor as torch_monitor
from ray_tpu_torch._private.config import GLOBAL_CONFIG as TORCH_CONFIG

RUNTIMES = {"ray_tpu": (ray_tpu, jax_monitor, JAX_CONFIG),
            "ray_tpu_torch": (ray_tpu_torch, torch_monitor, TORCH_CONFIG)}
WAIT_S = 30.0


def _run(scenario, name, **init):
    rt, monitor, config = RUNTIMES[name]
    rt.shutdown()
    runtime = rt.init(**init)
    try:
        return scenario(rt, runtime, monitor, config)
    finally:
        rt.shutdown()
        config.reset()
        monitor._set_usage_override(None)
        monitor._set_store_fraction_override(None)


def _both(scenario, **init) -> dict:
    return {name: _run(scenario, name, **init) for name in RUNTIMES}


def _error(fn) -> "str | None":
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        return type(exc).__name__
    return None


# ---------------------------- mirrored: test_dashboard_monitors.py


MANUAL_MONITOR = {"memory_monitor_refresh_ms": 0}  # no monitor thread


def test_memory_monitor_kills_fattest_worker():
    def scenario(rt, runtime, monitor, config):
        usage = monitor.host_memory_usage_fraction()
        workers = runtime.worker_pool.live_workers()
        rss = [monitor.process_rss_bytes(w.proc.pid) > 0 for w in workers]
        # Threshold 0: always over; one kill per check.
        killer = monitor.MemoryMonitor(runtime, threshold=0.0)
        # Wired in as init() does: a dispatch racing the kill retries on
        # the OOM budget.
        runtime.memory_monitor = killer
        killed = killer.check_once()

        @rt.remote
        def ok():
            return os.getpid()

        # The pool replaces the dead worker; tasks still run.
        pid = rt.get(ok.remote(), timeout=WAIT_S)
        return [0.0 < usage < 1.0, len(workers), all(rss),
                killed in {w.proc.pid for w in workers}, killer.num_kills,
                pid > 0]

    records = _both(scenario, num_cpus=4, process_workers=2,
                    system_config=dict(MANUAL_MONITOR))
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, 2, True, True, 1, True]


def test_memory_monitor_noop_below_threshold():
    def scenario(rt, runtime, monitor, config):
        never = monitor.MemoryMonitor(runtime, threshold=1.0)
        return [never.check_once(), never.num_kills]

    records = _both(scenario, num_cpus=2, process_workers=1,
                    system_config=dict(MANUAL_MONITOR))
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [None, 0]


def test_oom_killed_task_is_retried(tmp_path):
    """A task whose worker the memory monitor kills is retried on its
    OOM budget, though its max_retries is 0."""
    def scenario(rt, runtime, monitor, config):
        marker = tmp_path / f"attempted-{rt.__name__}"

        @rt.remote(max_retries=0)
        def first_slow_then_fast(path):
            import os as _os
            import time as _time

            if not _os.path.exists(path):
                with open(path, "w") as f:
                    f.write("1")
                _time.sleep(30)  # the first attempt: long enough to kill
                return "slow-path"
            return "retried-ok"

        killer = monitor.MemoryMonitor(runtime, threshold=0.0)
        runtime.memory_monitor = killer  # the retry decision reads it
        ref = first_slow_then_fast.remote(str(marker))

        def shoot():
            deadline = time.time() + 15
            while time.time() < deadline and not marker.exists():
                time.sleep(0.05)
            time.sleep(0.2)  # the task is in its sleep now
            killer.check_once()

        shooter = threading.Thread(target=shoot)
        shooter.start()
        got = rt.get(ref, timeout=60)
        shooter.join(timeout=10)
        return [got, killer.num_kills]

    records = _both(scenario, num_cpus=2, process_workers=1,
                    system_config=dict(MANUAL_MONITOR))
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["retried-ok", 1]


# --------------------------------------- mirrored: test_overload.py


def _shed_counter(rt, runtime) -> int:
    stats = runtime.fault_stats() if rt is ray_tpu else runtime.stats()
    return stats["admission_shed"]


def test_memory_watermark_shed():
    def scenario(rt, runtime, monitor, config):
        @rt.remote
        def quick(x):
            return x

        config.update({"admission_memory_watermark": 0.9})
        monitor._set_usage_override(0.95)
        try:
            shed = _error(lambda: rt.get(quick.remote(1, _deadline_s=30),
                                         timeout=30))
        finally:
            monitor._set_usage_override(None)
        # The pressure gone: admission opens again.
        return [shed, _shed_counter(rt, runtime),
                rt.get(quick.remote(2, _deadline_s=30), timeout=20)]

    records = _both(scenario, num_cpus=1)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["SystemOverloadedError", 1, 2]


def test_memory_watermark_store_pressure_admits_and_spills():
    """Over the watermark where the spill tier can relieve it (the store
    axis): the deadline-armed submit is admitted and the spiller kicked;
    the same pressure with the spill disk backing off sheds."""
    def scenario(rt, runtime, monitor, config):
        @rt.remote
        def quick(x):
            return x

        config.update({"admission_memory_watermark": 0.9})
        monitor._set_usage_override(0.95)
        monitor._set_store_fraction_override(0.5)
        admitted = rt.get(quick.remote(1, _deadline_s=30), timeout=30)
        mgr = runtime.store._spill
        with mgr._lock:
            mgr._backoff_until = time.monotonic() + 30
        backing_off = _error(lambda: rt.get(quick.remote(2, _deadline_s=30),
                                            timeout=30))
        with mgr._lock:
            mgr._backoff_until = 0.0
        return [admitted, backing_off, _shed_counter(rt, runtime)]

    records = _both(scenario, num_cpus=1)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [1, "SystemOverloadedError", 1]


# ------------------------------------------------------------- port only


def _port_threads() -> list[str]:
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("ray_tpu_torch"))


def test_no_runtime_thread_outlives_shutdown(tmp_path, monkeypatch):
    """The spiller, the heartbeat and health-check threads and the memory
    monitor run while the runtime does (after a spill, a node's death and
    a pool task), and none of them, nor any other ``ray_tpu_torch``
    thread, is left after ``shutdown()``; the per-pid spill directory
    goes with the last spill manager."""
    from ray_tpu_torch._private import spill_manager

    monkeypatch.setenv(spill_manager.SESSION_DIR_ENV, str(tmp_path))
    ray_tpu_torch.shutdown()
    runtime = ray_tpu_torch.init(
        num_cpus=2, process_workers=1, object_store_memory=64 * 1024,
        system_config={"memory_monitor_refresh_ms": 50,
                       "memory_usage_threshold": 1.0,
                       "health_check_period_ms": 50,
                       "health_check_failure_threshold": 3})
    try:
        refs = [ray_tpu_torch.put(bytes(40 * 1024)) for _ in range(2)]
        node = runtime.add_node({"CPU": 1.0})
        runtime.kill_node(node)

        @ray_tpu_torch.remote
        def pid():
            return os.getpid()

        assert ray_tpu_torch.get(pid.remote(), timeout=WAIT_S) != os.getpid()
        deadline = time.monotonic() + WAIT_S
        while (runtime.spill_stats()["spills"] == 0
               or [n.alive for n in runtime.gcs.list_nodes()
                   if n.node_id == node] != [False]) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert runtime.spill_stats()["spills"] >= 1
        assert ray_tpu_torch.get(refs) == [bytes(40 * 1024)] * 2
        running = _port_threads()
        spill_dir = spill_manager.process_spill_dir()
        assert os.path.isdir(spill_dir)
    finally:
        ray_tpu_torch.shutdown()
        TORCH_CONFIG.reset()
    for name in ("ray_tpu_torch-spiller-driver-store",
                 "ray_tpu_torch-heartbeat", "ray_tpu_torch-health-check",
                 "ray_tpu_torch-memory-monitor"):
        assert name in running
    deadline = time.monotonic() + 5.0
    while _port_threads() and time.monotonic() < deadline:
        time.sleep(0.05)  # a connection's thread sees its socket close
    assert _port_threads() == []
    assert not os.path.exists(spill_dir)


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_process_rss_bytes_of_this_process(package):
    monitor = RUNTIMES[package][1]
    assert monitor.process_rss_bytes(os.getpid()) > 0
    assert monitor.process_rss_bytes(2 ** 22 + 7) == 0
