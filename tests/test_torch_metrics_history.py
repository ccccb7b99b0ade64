"""The port's metrics history (``ray_tpu_torch/_private/metrics_history.py``)
against the JAX package's.

Each case of tests/test_metrics_history.py runs once through ``ray_tpu``
and once through ``ray_tpu_torch`` and returns a plain record (queries
under a fixed fake clock, verdicts, flight records); the records must
be equal, and equal to what the reference case asserts. Two cases of
the reference are not mirrored: :466 and :529 drive the ``top`` and
``doctor`` CLI, which waits for ROADMAP item 12's ``scripts.py``; of the
disarmed-head case (:618) the RPC half is mirrored and its CLI half
waits with them.

Where the port differs: it has no ``overload.saturate`` chaos site yet
(ROADMAP 10c), so in the overload case (:580) both packages' daemons
shed through ``admission_memory_watermark`` set below any host's use,
which sheds every deadline-armed task as the chaos site does.
"""

from __future__ import annotations

import importlib
import random
import threading
import time

import pytest

from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")
ENV_PREFIX = {"ray_tpu": "RAY_TPU_", "ray_tpu_torch": "RAY_TPU_TORCH_"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}._private.{name}")


def _mh(pkg: str):
    return _mod(pkg, "metrics_history")


def _reset(pkg: str) -> None:
    _mod(pkg, "config").GLOBAL_CONFIG.reset()
    _mh(pkg).init_from_config()
    _mod(pkg, "gcs_shard").init_from_config()


@pytest.fixture(autouse=True)
def _history_clean():
    yield
    for pkg in PACKAGES:
        _reset(pkg)


def _both(scenario) -> dict:
    records = {}
    for pkg in PACKAGES:
        try:
            records[pkg] = scenario(pkg)
        finally:
            _reset(pkg)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


class _FakeClock:
    def __init__(self, start=0.0, wall0=1_000_000.0):
        self.now = start
        self.wall0 = wall0

    def clock(self):
        return self.now

    def wall(self):
        return self.wall0 + self.now

    def advance(self, dt):
        self.now += dt


def _store(pkg, interval=1.0, retention=10.0, domains=1, clk=None):
    clk = clk or _FakeClock()
    return clk, _mh(pkg).HistoryStore(interval, retention, domains=domains,
                                      clock=clk.clock, wall=clk.wall)


def _stats(tasks=0, shed=0, opens=0, timeouts=0, retries=0, spills=0,
           restores=0, restore_p50=0.0, fused=0, running=0, depth=0,
           age=0.1, hist=None):
    row = {"tasks_executed": tasks, "running": running, "depth": depth,
           "age_s": age,
           "faults": {"admission_shed": shed, "breaker_open": opens,
                      "task_timeouts": timeouts, "rpc_retries": retries},
           "pipeline": {"fused_fallbacks": fused},
           "spill": {"spills": spills, "restores": restores,
                     "restore_p50_ms": restore_p50}}
    if hist is not None:
        row["stage_hist"] = hist
    return row


def _wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.2)


# --------------------------------------------------------------- ring store


def ring_determinism(pkg):
    runs = []
    for _ in range(2):
        clk, store = _store(pkg, interval=1.0, retention=10.0, domains=4)
        for i in range(1, 8):
            clk.advance(1.0)
            store.sample({"aa01": _stats(tasks=10 * i, shed=i),
                          "bb02": _stats(tasks=7 * i)}, [])
        runs.append(store.query(window_s=5.0))
    row = runs[0]["nodes"]["aa01"]
    return {"same": runs[0] == runs[1], "query": runs[0],
            "deltas": {s["tasks_executed"] for s in row["samples"]},
            "rates": (row["rates"]["tasks_executed"],
                      row["rates"]["admission_shed"])}


def test_ring_determinism_under_fixed_clock():
    """tests/test_metrics_history.py:73. The whole query is in the
    record: the two packages' stores give equal queries."""
    record = _both(ring_determinism)
    assert record["same"] and record["deltas"] == {10.0}
    assert record["rates"] == (pytest.approx(10.0), pytest.approx(1.0))


def first_sample_zero(pkg):
    clk, store = _store(pkg)
    clk.advance(1.0)
    store.sample({"aa01": _stats(tasks=50_000, shed=400)}, [])
    sample = store.query()["nodes"]["aa01"]["samples"][0]
    return {"tasks": sample["tasks_executed"],
            "shed": sample["admission_shed"]}


def test_first_sample_is_zero_delta_not_cumulative_total():
    """tests/test_metrics_history.py:94."""
    assert _both(first_sample_zero) == {"tasks": 0.0, "shed": 0.0}


def counter_reset(pkg):
    mh = _mh(pkg)
    clk, store = _store(pkg)
    for tasks in (100, 200, 300, 5, 30):
        clk.advance(1.0)
        store.sample({"aa01": _stats(tasks=tasks)}, [])
    row = store.query()["nodes"]["aa01"]
    return {"deltas": [s["tasks_executed"] for s in row["samples"]],
            "rate_ok": row["rates"]["tasks_executed"] >= 0.0,
            "hist": mh.snapshot_delta(
                {"counts": [1, 0], "sum": 0.1, "count": 1},
                {"counts": [5, 2], "sum": 0.9, "count": 7})}


def test_counter_reset_across_daemon_restart_never_negative():
    """tests/test_metrics_history.py:105."""
    assert _both(counter_reset) == {
        "deltas": [0.0, 100.0, 100.0, 0.0, 25.0], "rate_ok": True,
        "hist": {"counts": [0, 0], "sum": 0.0, "count": 0}}


def retention(pkg):
    clk, store = _store(pkg, interval=1.0, retention=5.0)
    record = {"capacity": store.capacity}
    for i in range(1, 10):
        clk.advance(1.0)
        store.sample({"aa01": _stats(tasks=i)}, [])
    record["bounded"] = len(store.query()["nodes"]["aa01"]["samples"]) <= 5
    for _ in range(7):
        clk.advance(1.0)
        store.sample({"bb02": _stats(tasks=1)}, [])
    record["nodes"] = sorted(store.query()["nodes"])
    return record


def test_retention_bounds_ring_and_evicts_departed_nodes():
    """tests/test_metrics_history.py:130."""
    assert _both(retention) == {"capacity": 5, "bounded": True,
                                "nodes": ["bb02"]}


def shard_stall_stale(pkg):
    clk, store = _store(pkg, domains=4)
    node_by_domain = {}
    for i in range(64):
        hexid = f"{i:02x}ab"
        node_by_domain.setdefault(store.domain_of(hexid), hexid)
        if len(node_by_domain) == 4:
            break
    stats = {h: _stats(tasks=10) for h in node_by_domain.values()}
    clk.advance(1.0)
    store.sample(stats, [{"shard": 2, "age_s": 4.2}])
    out = store.query()
    record = {"degraded": out["degraded"],
              "stale": {d: out["nodes"][h]["stale"]
                        for d, h in sorted(node_by_domain.items())}}
    clk.advance(1.0)
    store.sample(stats, [{"shard": 2, "age_s": 0.0}])
    out = store.query(window_s=0.4)
    record.update(healed=out["degraded"],
                  healed_stale=out["nodes"][node_by_domain[2]]["stale"])
    return record


def test_shard_stall_marks_domain_samples_stale_and_degraded():
    """tests/test_metrics_history.py:148."""
    assert _both(shard_stall_stale) == {
        "degraded": [2], "stale": {0: False, 1: False, 2: True, 3: False},
        "healed": [], "healed_stale": False}


def stage_hist_window(pkg):
    mh = _mh(pkg)
    perf = _mod(pkg, "perf_plane")
    clk, store = _store(pkg)
    hist = perf.StageHistogram()
    cumulative: dict = {}
    for i in range(1, 6):
        for _ in range(10):
            hist.observe(0.001 * i)
        snap = hist.snapshot()
        clk.advance(1.0)
        store.sample({"aa01": _stats(tasks=i, hist={"exec": snap})}, [])
        cumulative = snap
    merged = mh.merge_window(store.query()["nodes"]["aa01"]["samples"],
                             "exec")
    return {"count": merged["count"] == cumulative["count"],
            "counts": merged["counts"] == list(cumulative["counts"]),
            "p50": mh.summarize(merged)["p50_s"]
            == pytest.approx(mh.summarize(cumulative)["p50_s"]),
            "summary": mh.summarize(merged)}


def test_stage_hist_window_merge_percentiles():
    """tests/test_metrics_history.py:175."""
    record = _both(stage_hist_window)
    assert record["count"] and record["counts"] and record["p50"]


# ----------------------------------------------- shared latency helpers


def router_semantics(pkg):
    mh = _mh(pkg)
    perf = _mod(pkg, "perf_plane")

    def oracle(snap, prev):
        if prev is None:
            delta = snap
        else:
            delta = {"counts": [int(a) - int(b) for a, b in
                                zip(snap["counts"], prev["counts"])],
                     "sum": float(snap["sum"]) - float(prev["sum"]),
                     "count": int(snap["count"]) - int(prev["count"])}
        count = int(delta.get("count", 0))
        return {"count": count,
                "mean_s": (delta["sum"] / count) if count else 0.0,
                "p50_s": perf.quantile(delta, 0.5),
                "p99_s": perf.quantile(delta, 0.99)}

    hist = perf.StageHistogram()
    prev = None
    rng = random.Random(7)
    got = []
    for _ in range(6):
        for _ in range(200):
            hist.observe(rng.uniform(1e-4, 0.5))
        snap = hist.snapshot()
        summary = mh.summarize(mh.snapshot_delta(snap, prev))
        assert summary == oracle(snap, prev)
        got.append(summary)
        prev = snap
    return {"summaries": got}


def test_snapshot_delta_summarize_match_pr14_router_semantics():
    """tests/test_metrics_history.py:200."""
    _both(router_semantics)


def router_shared(pkg):
    router = importlib.import_module(f"{pkg}.serve.router").Router
    return {"shared": router._summarize is _mh(pkg).summarize}


def test_router_summarize_is_the_shared_helper():
    """tests/test_metrics_history.py:238."""
    assert _both(router_shared) == {"shared": True}


def router_window(pkg):
    router_cls = importlib.import_module(f"{pkg}.serve.router").Router
    perf = _mod(pkg, "perf_plane")
    router = router_cls.__new__(router_cls)
    router._latency = perf.StageHistogram()
    router._last_window_snap = None
    router._lock = threading.Lock()
    for _ in range(100):
        router._latency.observe(0.010)
    first = router.latency_window_stats()
    for _ in range(50):
        router._latency.observe(0.100)
    window = router.latency_window_stats()
    return {"first": first["count"], "window": window["count"],
            "moved": window["p50_s"] > first["p50_s"]}


def test_router_window_stats_ride_shared_helper():
    """tests/test_metrics_history.py:244."""
    assert _both(router_window) == {"first": 100, "window": 50,
                                    "moved": True}


def router_monotonic(pkg, monkeypatch):
    router_mod = importlib.import_module(f"{pkg}.serve.router")

    class FakeRouter:
        def __init__(self):
            self.observed = []

        def _release(self, idx):
            pass

        def observe_latency(self, dt_s):
            self.observed.append(dt_s)

    fake = FakeRouter()
    resp = router_mod.DeploymentResponse(None, router=fake, replica_idx=0,
                                         started=time.monotonic())
    real_time = time.time
    with monkeypatch.context() as m:
        m.setattr(router_mod.time, "time", lambda: real_time() + 3600.0)
        resp._release()
        fake2 = FakeRouter()
        stream = router_mod.DeploymentStreamingResponse(
            None, None, router=fake2, replica_idx=0,
            started=time.monotonic())
        stream._release()
    return {"unary": (len(fake.observed), fake.observed[0] < 60.0),
            "stream": (len(fake2.observed), fake2.observed[0] < 60.0)}


def test_router_latency_stamps_survive_wall_clock_jump(monkeypatch):
    """tests/test_metrics_history.py:268."""
    assert _both(lambda pkg: router_monotonic(pkg, monkeypatch)) == {
        "unary": (1, True), "stream": (1, True)}


# ------------------------------------------------------------- watchdog


_THRESHOLDS = {
    "window_s": 10.0, "overload_shed_per_s": 0.5,
    "breaker_storm_opens": 3.0, "spill_churn_per_s": 2.0,
    "spill_restore_p50_ms": 50.0, "wedged_age_s": 5.0,
    "stale_shard_age_s": 3.0, "fused_fallback_per_s": 1.0,
}


def _watchdog(pkg, domains=1):
    clk, store = _store(pkg, domains=domains)
    return clk, store, _mh(pkg).HealthWatchdog(store,
                                               thresholds=_THRESHOLDS)


def _feed(clk, store, rows, shard_rows=None, n=1):
    for _ in range(n):
        clk.advance(1.0)
        store.sample(rows, shard_rows or [])


def _strip(verdicts: list) -> list:
    return [{k: v for k, v in verdict.items()} for verdict in verdicts]


def clean_run(pkg):
    clk, store, wd = _watchdog(pkg)
    cumulative = 0
    swept = []
    for _ in range(8):
        cumulative += 50
        _feed(clk, store, {"aa01": _stats(tasks=cumulative)})
        swept.append(wd.sweep({"aa01": _stats(tasks=cumulative)}, []))
    report = wd.report()
    return {"swept": swept, "verdicts": report["verdicts"],
            "fired": report["fired"], "fired_total": report["fired_total"],
            "rules": report["rules"]}


def test_watchdog_zero_verdicts_on_clean_run():
    """tests/test_metrics_history.py:331."""
    assert _both(clean_run) == {
        "swept": [[]] * 8, "verdicts": [], "fired": [], "fired_total": {},
        "rules": ["overload", "breaker_storm", "spill_thrash",
                  "stale_shard", "wedged_node", "fused_fallback_spike"]}


def overload_sustained(pkg):
    clk, store, wd = _watchdog(pkg)
    _feed(clk, store, {"aa01": _stats(shed=0)})
    _feed(clk, store, {"aa01": _stats(shed=40)})
    burst = wd.sweep({}, [])
    _feed(clk, store, {"aa01": _stats(shed=80)})
    return {"burst": burst, "new": _strip(wd.sweep({}, []))}


def test_overload_requires_sustained_sheds():
    """tests/test_metrics_history.py:346. The verdicts, evidence and
    all, are equal in both packages."""
    record = _both(overload_sustained)
    assert record["burst"] == []
    (verdict,) = record["new"]
    assert verdict["rule"] == "overload" and verdict["node"] == "aa01"
    assert verdict["value"] >= 0.5 and verdict["window_s"] == 10.0
    assert verdict["evidence"]["intervals_shedding"] >= 2


def breaker_storm(pkg):
    clk, store, wd = _watchdog(pkg)
    _feed(clk, store, {"aa01": _stats(opens=0)})
    _feed(clk, store, {"aa01": _stats(opens=4)})
    return {"new": _strip(wd.sweep({}, []))}


def test_breaker_storm_fires_on_open_burst():
    """tests/test_metrics_history.py:365."""
    (verdict,) = _both(breaker_storm)["new"]
    assert verdict["rule"] == "breaker_storm" and verdict["value"] == 4.0
    assert sum(verdict["evidence"]["breaker_open"]) == 4.0


def spill_thrash(pkg):
    clk, store, wd = _watchdog(pkg)
    _feed(clk, store, {"aa01": _stats()})
    _feed(clk, store, {"aa01": _stats(spills=30, restores=30,
                                      restore_p50=1.0)})
    fast = wd.sweep({}, [])
    _feed(clk, store, {"aa01": _stats(spills=60, restores=60,
                                      restore_p50=120.0)})
    return {"fast": fast, "new": _strip(wd.sweep({}, []))}


def test_spill_thrash_needs_churn_and_slow_restores():
    """tests/test_metrics_history.py:375."""
    record = _both(spill_thrash)
    assert record["fast"] == []
    (verdict,) = record["new"]
    assert verdict["rule"] == "spill_thrash"
    assert verdict["evidence"]["restore_p50_ms"] == 120.0


def stale_shard(pkg):
    clk, store, wd = _watchdog(pkg, domains=4)
    rows = [{"shard": 3, "age_s": 7.5, "queued_writes": 9,
             "shed_writes": 0}]
    _feed(clk, store, {"aa01": _stats()}, shard_rows=rows)
    return {"new": _strip(wd.sweep({}, rows))}


def test_stale_shard_verdict_names_the_shard():
    """tests/test_metrics_history.py:391."""
    (verdict,) = _both(stale_shard)["new"]
    assert verdict["rule"] == "stale_shard" and verdict["node"] == "shard:3"
    assert verdict["evidence"]["queued_writes"] == 9


def wedged_node(pkg):
    clk, store, wd = _watchdog(pkg)
    _feed(clk, store, {"aa01": _stats()})
    new = wd.sweep({"aa01": _stats(age=9.0), "bb02": _stats(age=0.2)}, [])
    return {"new": [(v["rule"], v["node"]) for v in new]}


def test_wedged_node_verdict_on_stats_age():
    """tests/test_metrics_history.py:404."""
    assert _both(wedged_node) == {"new": [("wedged_node", "aa01")]}


def fused_spike(pkg):
    clk, store, wd = _watchdog(pkg)
    _feed(clk, store, {"aa01": _stats(fused=0)})
    _feed(clk, store, {"aa01": _stats(fused=30)})
    return {"new": [v["rule"] for v in wd.sweep({}, [])]}


def test_fused_fallback_spike_verdict():
    """tests/test_metrics_history.py:413."""
    assert _both(fused_spike) == {"new": ["fused_fallback_spike"]}


def verdict_lifecycle(pkg, monkeypatch):
    flight_recorder = _mod(pkg, "flight_recorder")
    recorded = []
    with monkeypatch.context() as m:
        m.setattr(flight_recorder, "record",
                  lambda kind, *args: recorded.append((kind, args)))
        clk, store, wd = _watchdog(pkg)
        rows = [{"shard": 0, "age_s": 9.0, "queued_writes": 0,
                 "shed_writes": 0}]
        _feed(clk, store, {"aa01": _stats()})
        steps = [len(wd.sweep({}, rows)), list(recorded)]
        steps += [wd.sweep({}, rows), len(recorded),
                  len(wd.report()["verdicts"])]
        steps += [wd.sweep({}, []), wd.report()["verdicts"]]
        steps += [len(wd.sweep({}, rows)), len(recorded),
                  wd.report()["fired_total"]]
    return {"steps": steps}


def test_verdict_lifecycle_flight_records_activations_only(monkeypatch):
    """tests/test_metrics_history.py:420."""
    assert _both(lambda pkg: verdict_lifecycle(pkg, monkeypatch)) == {
        "steps": [1, [("health.stale_shard", ("shard:0", 9.0))], [], 1, 1,
                  [], [], 1, 2, {"stale_shard": 2}]}


def rule_registry(pkg):
    mh = _mh(pkg)
    return {"rules": list(mh._RULES), "same": tuple(mh._RULES)
            == mh.HEALTH_RULES,
            "callable": all(callable(mh._RULES[r]) for r in mh.HEALTH_RULES)}


def test_rule_registry_matches_dispatch_table():
    """tests/test_metrics_history.py:454."""
    record = _both(rule_registry)
    assert record["same"] and record["callable"]


def test_history_keys_match_the_reference():
    """The sample row and the rules are the reference's."""
    for name in ("HISTORY_STAT_KEYS", "GAUGE_KEYS", "HEALTH_RULES",
                 "_STAT_SOURCES"):
        assert getattr(_mh("ray_tpu_torch"), name) == \
            getattr(_mh("ray_tpu"), name), name


# ------------------------------------------------------- live cluster


def overload_chaos(pkg, tmp_path):
    rt = importlib.import_module(pkg)
    cluster_cls = importlib.import_module(f"{pkg}.cluster_utils").Cluster
    overloaded = importlib.import_module(f"{pkg}.exceptions") \
        .SystemOverloadedError
    _mod(pkg, "config").GLOBAL_CONFIG.update({
        "metrics_history_interval_s": 0.3, "health_window_s": 8.0,
        "health_overload_shed_per_s": 0.2})
    rt.shutdown()
    cluster = cluster_cls(log_dir=str(tmp_path / pkg / "cluster"))
    cluster.add_node(num_cpus=2, pool_size=1, heartbeat_period_s=0.3,
                     env={ENV_PREFIX[pkg] + "ADMISSION_MEMORY_WATERMARK":
                          "0.0001"})
    runtime = None
    try:
        assert cluster.wait_for_nodes(1, timeout=60)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        _wait_for(lambda: rt.cluster_resources().get("CPU", 0) >= 2, 60,
                  "the worker node to join")

        @rt.remote(num_cpus=1)
        def quick(x):
            return x

        shed = 0
        for _wave in range(4):
            for i in range(3):
                with pytest.raises(overloaded):
                    rt.get(quick.remote(i, _deadline_s=5), timeout=30)
                shed += 1
            time.sleep(1.0)
        _wait_for(lambda: any(
            v["rule"] == "overload"
            for v in (runtime.cluster_health() or {}).get("verdicts", [])),
            30, "the overload verdict")
        verdict = next(v for v in runtime.cluster_health()["verdicts"]
                       if v["rule"] == "overload")
        return {"shed": shed, "value": verdict["value"] >= 0.2,
                "intervals": verdict["evidence"]["intervals_shedding"] >= 2,
                "window": verdict["window_s"]}
    finally:
        if runtime is not None:
            rt.shutdown()
        cluster.shutdown()


def test_overload_chaos_fires_overload_verdict(tmp_path):
    """tests/test_metrics_history.py:580, the daemons shedding through
    the memory watermark (see the top of the file)."""
    with time_limit(150):
        assert _both(lambda pkg: overload_chaos(pkg, tmp_path)) == {
            "shed": 12, "value": True, "intervals": True, "window": 8.0}


def fused_spike_live(pkg, tmp_path):
    rt = importlib.import_module(pkg)
    cluster_cls = importlib.import_module(f"{pkg}.cluster_utils").Cluster
    _mod(pkg, "config").GLOBAL_CONFIG.update({
        "metrics_history_interval_s": 0.3, "health_window_s": 8.0,
        "health_fused_fallback_per_s": 0.2})
    rt.shutdown()
    cluster = cluster_cls(log_dir=str(tmp_path / pkg / "cluster"))
    # A budget no fused run can keep: every run past its first task
    # spills the rest to the worker path.
    cluster.add_node(num_cpus=2, pool_size=1, heartbeat_period_s=0.3,
                     env={ENV_PREFIX[pkg] + "FUSED_RUN_WALL_BUDGET_S":
                          "0.001"})
    runtime = None
    try:
        assert cluster.wait_for_nodes(1, timeout=60)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        _wait_for(lambda: rt.cluster_resources().get("CPU", 0) >= 2, 60,
                  "the worker node to join")

        @rt.remote(num_cpus=1)
        def nap(x):
            time.sleep(0.01)
            return x

        out = []
        for wave in range(4):
            out += rt.get([nap.remote(wave * 10 + i) for i in range(10)],
                          timeout=60)
            time.sleep(1.0)
        _wait_for(lambda: any(
            v["rule"] == "fused_fallback_spike"
            for v in (runtime.cluster_health() or {}).get("verdicts", [])),
            30, "the fused_fallback_spike verdict")
        verdict = next(v for v in runtime.cluster_health()["verdicts"]
                       if v["rule"] == "fused_fallback_spike")
        return {"out": out == list(range(40)),
                "fallbacks": runtime.execution_pipeline_stats()["fused"]
                ["fused_fallbacks"] > 0,
                "value": verdict["value"] >= 0.2,
                "window": verdict["window_s"]}
    finally:
        if runtime is not None:
            rt.shutdown()
        cluster.shutdown()


def test_real_fused_fallbacks_fire_fused_fallback_spike(tmp_path):
    """A daemon whose fused runs overrun a tiny fused_run_wall_budget_s
    ships real fallbacks in its pipeline group, and the head's watchdog
    raises fused_fallback_spike over them, in both packages."""
    with time_limit(150):
        assert _both(lambda pkg: fused_spike_live(pkg, tmp_path)) == {
            "out": True, "fallbacks": True, "value": True, "window": 8.0}


def disarmed_head(pkg, tmp_path):
    rt = importlib.import_module(pkg)
    cluster_cls = importlib.import_module(f"{pkg}.cluster_utils").Cluster
    mh = _mh(pkg)
    _mod(pkg, "config").GLOBAL_CONFIG.update({"metrics_history": False})
    mh.init_from_config()
    record = {"on": mh.HISTORY_ON}
    rt.shutdown()
    cluster = cluster_cls(log_dir=str(tmp_path / pkg / "cluster"))
    runtime = None
    try:
        runtime = rt.init(num_cpus=0, address=cluster.address)
        hist = runtime.metrics_history()
        health = runtime.cluster_health()
        record.update(hist=hist["armed"], health=health["armed"],
                      rules=health["rules"] == list(mh.HEALTH_RULES))
        return record
    finally:
        if runtime is not None:
            rt.shutdown()
        cluster.shutdown()


def test_disarmed_head_answers_typed_unarmed(tmp_path):
    """tests/test_metrics_history.py:618, its RPC half."""
    with time_limit(60):
        assert _both(lambda pkg: disarmed_head(pkg, tmp_path)) == {
            "on": False, "hist": False, "health": False, "rules": True}


SLICE_KEYS = ("gcs_shards", "gcs_shard_max_queued_writes", "perf_plane",
              "flight_recorder_events", "flight_recorder_flush_s",
              "metrics_history", "metrics_history_interval_s",
              "metrics_history_retention_s", "health_window_s",
              "health_overload_shed_per_s", "health_breaker_storm_opens",
              "health_spill_churn_per_s", "health_spill_restore_p50_ms",
              "health_wedged_age_s", "health_stale_shard_age_s",
              "health_fused_fallback_per_s")


def test_config_keys_have_the_reference_defaults_and_env_overrides(
        monkeypatch):
    """Every key the sharded head and the observability plane read has
    the reference's default, and the port's environment prefix
    overrides it."""
    port = _mod("ray_tpu_torch", "config")
    ref = _mod("ray_tpu", "config")
    for key in SLICE_KEYS:
        assert port._DEFAULTS[key] == ref._DEFAULTS[key], key
    monkeypatch.setenv("RAY_TPU_TORCH_GCS_SHARDS", "4")
    monkeypatch.setenv("RAY_TPU_TORCH_METRICS_HISTORY", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_HEALTH_WEDGED_AGE_S", "2.5")
    config = port.Config()
    assert (config.gcs_shards, config.metrics_history,
            config.health_wedged_age_s) == (4, False, 2.5)
