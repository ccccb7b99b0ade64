"""The port's submit ring against the JAX package's: refs and results
across a deep burst, dependencies across buffered submits, a cancel
racing a buffered submit, a full ring's backpressure, placement-group
submits through the ring, a daemon's death with submits still buffered,
and the ``submit_pipeline=0`` fallback (the cases of
tests/test_submit_pipeline.py but its trace-context one, which waits
for tracing to be ported).

Each case is a scenario run once per package, on a fresh runtime (or a
cluster of its own); the two records must be equal, and equal to what
the reference test asserts.
"""

import importlib
import os
import signal
import threading
import time

import pytest
from torch_cluster_sides import PACKAGES, wait_until
from torch_time_limit import time_limit


def _mod(name: str, sub: str):
    return importlib.import_module(f"{name}.{sub}")


def each(scenario, **init_kwargs) -> dict:
    """The scenario's record on a fresh 8-CPU runtime of each package;
    the records must agree."""
    records = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        rt.shutdown()
        runtime = rt.init(num_cpus=8, **init_kwargs)
        try:
            records[name] = scenario(name, rt, runtime)
        finally:
            rt.shutdown()
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def identity(name, rt, runtime) -> dict:
    armed = runtime._submit_ring is not None

    @rt.remote
    def ident(i):
        return i * 3

    before = runtime.execution_pipeline_stats()["submit"]
    refs = [ident.remote(i) for i in range(10_000)]
    distinct = len({r.id() for r in refs}) == 10_000
    out = rt.get(refs, timeout=300.0)
    after = runtime.execution_pipeline_stats()["submit"]
    submits = after["ring_submits"] - before["ring_submits"]
    flushes = after["flushes"] - before["flushes"]
    return {"armed": armed, "distinct": distinct,
            "out": out == [i * 3 for i in range(10_000)],
            "submits": submits >= 10_000,
            "coalesced": 0 < flushes < submits}


def test_ring_submits_preserve_ref_identity_and_results():
    with time_limit(300):
        assert each(identity) == {"armed": True, "distinct": True,
                                  "out": True, "submits": True,
                                  "coalesced": True}


def chain(name, rt, runtime) -> int:
    @rt.remote
    def inc(x):
        return x + 1

    ref = rt.put(0)
    for _ in range(50):
        ref = inc.remote(ref)
    return rt.get(ref, timeout=120.0)


def test_dependencies_across_buffered_submits():
    with time_limit(120):
        assert each(chain) == 50


def buffered_cancel(name, rt, runtime) -> dict:
    ring = runtime._submit_ring
    cancelled_error = _mod(name, "exceptions").TaskCancelledError
    hits = []

    @rt.remote
    def tracked(i):
        hits.append(i)
        return i

    ring._gate.clear()
    try:
        victim = tracked.remote(99)
        survivor = tracked.remote(1)
        before = ring.buffered_cancels
        rt.cancel(victim)
        counted = ring.buffered_cancels == before + 1
        # Sealed at once: no flush needed.
        with pytest.raises(cancelled_error):
            rt.get(victim, timeout=5.0)
    finally:
        ring._gate.set()
    survived = rt.get(survivor, timeout=60.0)
    time.sleep(0.2)
    return {"counted": counted, "survivor": survived, "hits": list(hits)}


def test_cancel_races_buffered_submit():
    with time_limit(120):
        assert each(buffered_cancel) == {"counted": True, "survivor": 1,
                                         "hits": [1]}


def overflow(name, rt, runtime) -> dict:
    ring = runtime._submit_ring
    capacity = ring._capacity

    @rt.remote
    def ident(i):
        return i

    ring._gate.clear()
    refs = [ident.remote(i) for i in range(32)]  # fills the ring
    done = threading.Event()
    overflow_refs = []

    def push_one_more():
        overflow_refs.append(ident.remote(32))
        done.set()

    threading.Thread(target=push_one_more, daemon=True).start()
    blocked = not done.wait(1.0)
    ring._gate.set()
    finished = done.wait(30.0)
    return {"capacity": capacity, "blocked": blocked,
            "finished": finished, "waits": ring.ring_full_waits >= 1,
            "out": rt.get(refs + overflow_refs, timeout=120.0)}


def test_ring_overflow_backpressures_submitter(monkeypatch):
    for prefix in ("RAY_TPU_", "RAY_TPU_TORCH_"):
        monkeypatch.setenv(prefix + "SUBMIT_RING_SIZE", "32")
        monkeypatch.setenv(prefix + "SUBMIT_FLUSH_MAX", "8")
    configs = [_mod(n, "_private.config").GLOBAL_CONFIG for n in PACKAGES]
    for config in configs:
        config.reset()
    try:
        with time_limit(120):
            assert each(overflow) == {"capacity": 32, "blocked": True,
                                      "finished": True, "waits": True,
                                      "out": list(range(33))}
    finally:
        for prefix in ("RAY_TPU_", "RAY_TPU_TORCH_"):
            monkeypatch.delenv(prefix + "SUBMIT_RING_SIZE", raising=False)
            monkeypatch.delenv(prefix + "SUBMIT_FLUSH_MAX", raising=False)
        for config in configs:
            config.reset()


def pg_route(name, rt, runtime) -> dict:
    pg_mod = _mod(name, "util.placement_group")
    strategies = _mod(name, "util.scheduling_strategies")
    pg = pg_mod.placement_group([{"CPU": 2}], strategy="PACK")
    ready = pg.wait(60.0)

    @rt.remote(num_cpus=1)
    def where(i):
        return i

    before = runtime.execution_pipeline_stats()["submit"]["ring_submits"]
    strategy = strategies.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    refs = [where.options(scheduling_strategy=strategy).remote(i)
            for i in range(8)]
    out = rt.get(refs, timeout=120.0)
    after = runtime.execution_pipeline_stats()["submit"]["ring_submits"]
    pg_mod.remove_placement_group(pg)
    return {"ready": ready, "out": out, "through_ring": after - before >= 8}


def test_pg_submits_route_through_ring():
    with time_limit(120):
        assert each(pg_route) == {"ready": True, "out": list(range(8)),
                                  "through_ring": True}


def queued_death(name, tmp_path) -> dict:
    rt = importlib.import_module(name)
    rt.shutdown()
    cluster = _mod(name, "cluster_utils").Cluster(
        log_dir=str(tmp_path / name / "cluster"))
    cluster.add_node(num_cpus=4, resources={"vic": 100.0}, pool_size=1,
                     heartbeat_period_s=0.5)
    started = False
    try:
        assert cluster.wait_for_nodes(1, timeout=60)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        started = True
        assert wait_until(
            lambda: rt.cluster_resources().get("vic", 0) > 0, 30)
        victim = next(h for h in cluster._nodes if h.alive())
        marker_dir = tmp_path / name / "markers"
        marker_dir.mkdir(parents=True)

        @rt.remote(num_cpus=1, resources={"vic": 1.0}, max_retries=3)
        def run_once(i, mdir):
            import os as _os

            with open(f"{mdir}/ran-{i}-{_os.getpid()}", "w"):
                pass
            return i

        ring = runtime._submit_ring
        ring._gate.clear()  # the submits stay buffered
        refs = [run_once.remote(i, str(marker_dir)) for i in range(12)]
        depth = ring.depth()
        os.kill(victim.pid, signal.SIGKILL)
        cluster.add_node(num_cpus=4, resources={"vic": 100.0}, pool_size=1,
                         heartbeat_period_s=0.5)
        ring._gate.set()
        results = rt.get(refs, timeout=180)
        runs = [len([f for f in os.listdir(marker_dir)
                     if f.startswith(f"ran-{i}-")]) for i in range(12)]
        return {"depth": depth, "results": sorted(results), "runs": runs}
    finally:
        if started:
            rt.shutdown()
        cluster.shutdown()


def test_daemon_death_with_queued_submits_no_loss_no_double_run(tmp_path):
    with time_limit(400):
        records = {name: queued_death(name, tmp_path) for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "depth": 12, "results": list(range(12)), "runs": [1] * 12}


def disabled(name, rt, runtime) -> dict:
    cancelled_error = _mod(name, "exceptions").TaskCancelledError
    armed = runtime._submit_ring is not None

    @rt.remote
    def ident(i):
        return i * 3

    out = rt.get([ident.remote(i) for i in range(500)], timeout=120.0)
    stats = runtime.execution_pipeline_stats()["submit"]

    @rt.remote
    def add(a, b):
        return a + b

    added = rt.get(add.remote(rt.put(1), 2), timeout=60.0)

    @rt.remote(num_cpus=8)
    def hog():
        time.sleep(1.0)

    @rt.remote(num_cpus=8)
    def queued():
        return "ran"

    blocker = hog.remote()
    tail = queued.remote()
    rt.cancel(tail)
    with pytest.raises(cancelled_error):
        rt.get(tail, timeout=60.0)
    rt.get(blocker, timeout=60.0)
    return {"armed": armed, "out": out == [i * 3 for i in range(500)],
            "ring": (stats["ring_submits"], stats["flushes"]),
            "added": added}


def test_submit_pipeline_disabled_fallback_equivalence(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SUBMIT_PIPELINE", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_SUBMIT_PIPELINE", "0")
    configs = [_mod(n, "_private.config").GLOBAL_CONFIG for n in PACKAGES]
    for config in configs:
        config.reset()
    try:
        with time_limit(120):
            assert each(disabled) == {"armed": False, "out": True,
                                      "ring": (0, 0), "added": 3}
    finally:
        monkeypatch.delenv("RAY_TPU_SUBMIT_PIPELINE", raising=False)
        monkeypatch.delenv("RAY_TPU_TORCH_SUBMIT_PIPELINE", raising=False)
        for config in configs:
            config.reset()
