"""The port's scheduling plane (locality- and load-scored placement) and
straggler speculation's trigger against the JAX package's.

The fifteen cases of tests/test_sched_plane.py. Each case runs once
through ``ray_tpu`` and once through ``ray_tpu_torch`` and returns a
plain record (the node a pick chose, named by its place in the case's
own node list, and the decision counters); the two records must be
equal, and equal to what the reference case asserts. The two cluster
cases share one module-scoped cluster per package: two 2-CPU daemons
with one pool worker each, beating every 0.5 s, one with resource
``aa`` and one with ``bb``, and a driver of no CPU. The reference's
locality case also reads ``util.state.summarize_placement``, which the
port does not have yet: the mirror reads the same rows (the head's
node-stats table) and decisions (``execution_pipeline_stats()``)
directly.
"""

from __future__ import annotations

import importlib
import time
import urllib.request

import pytest
from torch_cluster_sides import Side, both, start_clusters, stop_clusters
from torch_time_limit import time_limit

import ray_tpu
import ray_tpu_torch

PACKAGES = ("ray_tpu", "ray_tpu_torch")
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _reset(pkg: str) -> None:
    _mod(pkg, "_private.config").GLOBAL_CONFIG.reset()
    _mod(pkg, "_private.scheduler").init_sched_from_config()
    _mod(pkg, "_private.speculation").init_from_config()


def _each(scenario, limit: int = 120):
    """The scenario's record through both packages, each starting
    armed-by-default with a clean config; the records must agree."""
    records = {}
    for pkg in PACKAGES:
        _reset(pkg)
        try:
            with time_limit(limit):
                records[pkg] = scenario(pkg)
        finally:
            _reset(pkg)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _mk_cluster(pkg: str, n_nodes: int = 2, cpus: float = 4.0):
    sched = _mod(pkg, "_private.scheduler")
    ids = _mod(pkg, "_private.ids")
    cluster = sched.ClusterState(spread_threshold=0.5)
    nodes = []
    for _ in range(n_nodes):
        node = sched.NodeState(node_id=ids.NodeID(), total={"CPU": cpus},
                               available={"CPU": cpus})
        cluster.add_node(node)
        nodes.append(node)
    return cluster, nodes


def _classic_pick(nodes, demand=None, threshold=0.5):
    """The disarmed ordering, written out for the equivalence checks."""
    demand = demand or {"CPU": 1.0}
    fitting = [n for n in nodes if n.fits(demand)]
    under = [n for n in fitting if n.utilization() < threshold]
    pool = under if under else fitting
    return min(pool, key=lambda n: (n.utilization(), n.node_id.hex()))


# ---------------------------------------------------------------- locality


def holder_pick(pkg) -> dict:
    cluster, nodes = _mk_cluster(pkg, 3)
    holder = nodes[-1]
    locality = {holder.node_id.hex(): 8 * 1024 * 1024}
    picks = [cluster.pick_node({"CPU": 1.0}, None, locality=locality)
             is holder for _ in range(3)]
    return {"picks": picks, "counters": cluster.sched_counters()}


def test_locality_pick_prefers_holder_node():
    assert _each(holder_pick) == {
        "picks": [True] * 3,
        "counters": {"locality_hits": 3,
                     "locality_bytes_saved": 3 * 8 * 1024 * 1024,
                     "load_spillbacks": 0, "stale_stats_skips": 0}}


def locality_tie(pkg) -> dict:
    cluster, nodes = _mk_cluster(pkg, 2)
    a, b = nodes
    locality = {a.node_id.hex(): 1024 * 1024, b.node_id.hex(): 1024 * 1024}
    expected = min(nodes, key=lambda n: (n.utilization(), n.node_id.hex()))
    first = cluster.pick_node({"CPU": 1.0}, None,
                              locality=locality) is expected
    # A fresh load report skews the tie toward the idle holder.
    cluster.update_node_stats(expected.node_id, running=9.0, depth=9.0,
                              wait_s=0.0)
    other = b if expected is a else a
    cluster.update_node_stats(other.node_id, running=0.0, depth=0.0,
                              wait_s=0.0)
    second = cluster.pick_node({"CPU": 1.0}, None,
                               locality=locality) is other
    return {"classic_tiebreak": first, "load_tiebreak": second}


def test_locality_tie_broken_by_load_then_classic_order():
    assert _each(locality_tie) == {"classic_tiebreak": True,
                                   "load_tiebreak": True}


def locality_beats_idle(pkg) -> dict:
    cluster, nodes = _mk_cluster(pkg, 2)
    a, b = sorted(nodes, key=lambda n: n.node_id.hex())
    b.acquire({"CPU": 1.0})  # b busier than the idle a
    chosen = cluster.pick_node({"CPU": 1.0}, None,
                               locality={b.node_id.hex(): 4 << 20})
    return {"busier_holder": chosen is b}


def test_locality_beats_otherwise_idle_node():
    assert _each(locality_beats_idle) == {"busier_holder": True}


# ------------------------------------------------------ load-aware spillback


def skewed_backlog(pkg) -> dict:
    cluster, nodes = _mk_cluster(pkg, 2)
    default = _classic_pick(nodes)
    other = next(n for n in nodes if n is not default)
    cluster.update_node_stats(default.node_id, running=12.0, depth=12.0,
                              wait_s=0.5)
    cluster.update_node_stats(other.node_id, running=0.0, depth=0.0,
                              wait_s=0.0)
    chosen = cluster.pick_node({"CPU": 1.0}, None)
    return {"spilled": chosen is other,
            "load_spillbacks": cluster.sched_counters()["load_spillbacks"]}


def test_load_spillback_on_injected_skewed_backlog():
    assert _each(skewed_backlog) == {"spilled": True, "load_spillbacks": 1}


def small_delta(pkg) -> dict:
    cluster, nodes = _mk_cluster(pkg, 2)
    default = _classic_pick(nodes)
    other = next(n for n in nodes if n is not default)
    cluster.update_node_stats(default.node_id, running=1.0, depth=1.0,
                              wait_s=0.0)
    cluster.update_node_stats(other.node_id, running=1.0, depth=0.0,
                              wait_s=0.0)
    return {"kept": cluster.pick_node({"CPU": 1.0}, None) is default,
            "load_spillbacks": cluster.sched_counters()["load_spillbacks"]}


def test_small_load_delta_keeps_classic_choice():
    assert _each(small_delta) == {"kept": True, "load_spillbacks": 0}


# ------------------------------------------------------------- stale decay


def stale_decay(pkg) -> dict:
    _mod(pkg, "_private.config").GLOBAL_CONFIG.update(
        {"sched_stats_stale_s": 0.2})
    cluster, nodes = _mk_cluster(pkg, 2)
    default = _classic_pick(nodes)
    other = next(n for n in nodes if n is not default)
    cluster.update_node_stats(default.node_id, running=0.0, depth=0.0,
                              wait_s=0.0, age_s=10.0)
    cluster.update_node_stats(other.node_id, running=0.0, depth=0.0,
                              wait_s=0.0)
    out = {"skipped_stale": cluster.pick_node({"CPU": 1.0}, None) is other,
           "skips": cluster.sched_counters()["stale_stats_skips"]}
    # Every feed stale: the classic ordering, no further skip counted.
    cluster.update_node_stats(other.node_id, running=0.0, depth=0.0,
                              wait_s=0.0, age_s=10.0)
    out["all_stale_classic"] = \
        cluster.pick_node({"CPU": 1.0}, None) is default
    out["skips_after"] = cluster.sched_counters()["stale_stats_skips"]
    return out


def test_stale_stats_decay_skips_wedged_node():
    assert _each(stale_decay) == {"skipped_stale": True, "skips": 1,
                                  "all_stale_classic": True,
                                  "skips_after": 1}


def _backdate(pkg: str, gcs, node_hex: str, seconds: float) -> None:
    """Move a node-stats row's receipt back by ``seconds``."""
    if pkg == "ray_tpu" and gcs._stats_shards is None:
        with gcs._node_stats_lock:
            stats, at = gcs._node_stats[node_hex]
            gcs._node_stats[node_hex] = (stats, at - seconds)
        return
    dom = gcs._stats_domain(node_hex)
    with dom.lock:
        stats, at = dom.rows[node_hex]
        dom.rows[node_hex] = (stats, at - seconds)


def receipt_age(pkg) -> dict:
    gcs = _mod(pkg, "_private.gcs").GlobalControlService()
    gcs.record_node_stats("aa" * 8, {"running": 2})
    out = gcs.node_stats()["aa" * 8]
    record = {"running": out["running"],
              "fresh": 0.0 <= out["age_s"] < 1.0}
    _backdate(pkg, gcs, "aa" * 8, 10.0)
    record["aged"] = gcs.node_stats()["aa" * 8]["age_s"] >= 10.0
    return record


def test_gcs_node_stats_expose_receipt_age():
    assert _each(receipt_age) == {"running": 2, "fresh": True,
                                  "aged": True}


# ---------------------------------------------------- disarmed equivalence


def disarmed_pick(pkg) -> dict:
    _mod(pkg, "_private.config").GLOBAL_CONFIG.update(
        {"locality_aware_scheduling": False})
    _mod(pkg, "_private.scheduler").init_sched_from_config()
    cluster, nodes = _mk_cluster(pkg, 3)
    default = _classic_pick(nodes)
    other = next(n for n in nodes if n is not default)
    cluster.update_node_stats(default.node_id, running=50.0, depth=50.0,
                              wait_s=5.0)
    locality = {other.node_id.hex(): 64 << 20}
    picks = [cluster.pick_node({"CPU": 1.0}, None, locality=locality)
             is default for _ in range(4)]
    return {"picks": picks, "counters": cluster.sched_counters()}


def test_disarmed_pick_node_ignores_hints_and_stats():
    assert _each(disarmed_pick) == {
        "picks": [True] * 4,
        "counters": {"locality_hits": 0, "locality_bytes_saved": 0,
                     "load_spillbacks": 0, "stale_stats_skips": 0}}


def armed_without_feed(pkg) -> dict:
    cluster, nodes = _mk_cluster(pkg, 4)
    order = {n.node_id.hex(): i for i, n in enumerate(nodes)}

    def sequence():
        seq = []
        for _ in range(6):
            node = cluster.pick_node({"CPU": 1.0}, None)
            seq.append(node.node_id.hex())
            node.acquire({"CPU": 1.0})
        return seq

    seq_armed = sequence()
    for node in nodes:
        node.available = dict(node.total)
        node.inflight.clear()
    _mod(pkg, "_private.config").GLOBAL_CONFIG.update(
        {"locality_aware_scheduling": False})
    _mod(pkg, "_private.scheduler").init_sched_from_config()
    seq_classic = sequence()
    return {"same": seq_armed == seq_classic,
            # The classic order itself, by each node's rank in hex order.
            "ranks": [sorted(order).index(h) for h in seq_classic]}


def test_armed_without_feed_matches_classic_ordering():
    record = _each(armed_without_feed)
    assert record["same"] is True, record


# ------------------------------------------------------ speculation trigger


def trigger_math(pkg) -> dict:
    perf_plane = _mod(pkg, "_private.perf_plane")
    spec_mod = _mod(pkg, "_private.speculation")
    perf_plane.reset()
    try:
        for _ in range(20):
            perf_plane.record_task_wall("fn", 0.010)
        count, p99 = perf_plane.wall_quantile("fn", 0.99)
        factor, min_samples = 3.0, 8
        return {
            "count": count, "p99": p99 == pytest.approx(0.010),
            "under": spec_mod.should_speculate(0.02, count, p99, factor,
                                               min_samples),
            "past": spec_mod.should_speculate(0.05, count, p99, factor,
                                              min_samples),
            "sample_floor": spec_mod.should_speculate(
                60.0, min_samples - 1, p99, factor, min_samples),
            "sub_ms_floor": spec_mod.should_speculate(
                0.002, count, 1e-6, factor, min_samples),
        }
    finally:
        perf_plane.reset()


def test_speculation_trigger_math():
    assert _each(trigger_math) == {
        "count": 20, "p99": True, "under": False, "past": True,
        "sample_floor": False, "sub_ms_floor": False}


def wall_ring(pkg) -> dict:
    perf_plane = _mod(pkg, "_private.perf_plane")
    perf_plane.reset()
    try:
        for i in range(perf_plane.WALL_SAMPLE_CAP + 100):
            perf_plane.record_task_wall("g", float(i))
        count, _p99 = perf_plane.wall_quantile("g", 0.99)
        return {"count": count, "cap": perf_plane.WALL_SAMPLE_CAP}
    finally:
        perf_plane.reset()


def test_wall_sample_ring_is_bounded():
    record = _each(wall_ring)
    assert record["count"] == record["cap"], record


def disarmed_watcher(pkg) -> dict:
    rt = RUNTIMES[pkg]
    for other in RUNTIMES.values():
        other.shutdown()
    runtime = rt.init(num_cpus=2)
    try:
        return {"watcher": runtime._spec_watcher,
                "launched": runtime.execution_pipeline_stats()["sched"][
                    "speculations_launched"]}
    finally:
        rt.shutdown()


def test_speculation_disarmed_by_default_no_watcher():
    assert _each(disarmed_watcher) == {"watcher": None, "launched": 0}


def metrics_families(pkg) -> dict:
    rt = RUNTIMES[pkg]
    for other in RUNTIMES.values():
        other.shutdown()
    runtime = rt.init(num_cpus=2, metrics_port=0)
    try:
        @rt.remote
        def f(x):
            return x

        value = rt.get(f.remote(1), timeout=10)
        port = runtime.metrics_agent.port
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        return {"value": value,
                "family": f"{pkg}_sched_decisions_total" in body,
                "kinds": [kind for kind in (
                    "locality_hits", "load_spillbacks", "stale_stats_skips",
                    "speculations_launched") if f'kind="{kind}"' in body]}
    finally:
        rt.shutdown()


def test_sched_metrics_families_exported():
    assert _each(metrics_families) == {
        "value": 1, "family": True,
        "kinds": ["locality_hits", "load_spillbacks", "stale_stats_skips",
                  "speculations_launched"]}


# --------------------------------------------------------- cluster cases


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    for pkg in PACKAGES:
        _reset(pkg)
    with time_limit(300):
        sides = start_clusters(
            tmp_path_factory.mktemp("sched_plane"),
            [{"num_cpus": 2, "pool_size": 1, "heartbeat_period_s": 0.5,
              "resources": {"aa": 1.0}},
             {"num_cpus": 2, "pool_size": 1, "heartbeat_period_s": 0.5,
              "resources": {"bb": 1.0}}])
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


def _wait_for(predicate, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {what}")


def large_arg_locality(side: Side) -> dict:
    rt, runtime = side.rt, side.runtime
    b_hex = next(n["NodeID"] for n in rt.nodes()
                 if "bb" in n["Resources"])
    tag_env = side.tag_env

    @rt.remote(num_cpus=1)
    def produce(nbytes):
        return b"x" * nbytes

    @rt.remote(num_cpus=1)
    def consume(blob, env_name):
        import os as _os

        return len(blob), _os.environ.get(env_name, "?")[:8]

    base = runtime.execution_pipeline_stats()["sched"]
    # 512 KiB: over the inline reply size, so it stays on B.
    ref = produce.options(scheduling_strategy=side.affinity(
        node_id=b_hex, soft=False)).remote(512 * 1024)
    _wait_for(lambda: runtime.store.contains(ref.id()), 30,
              "the producer's result to seal")
    outs = [rt.get(consume.remote(ref, tag_env), timeout=30)
            for _ in range(4)]
    sched = runtime.execution_pipeline_stats()["sched"]
    rows = runtime.gcs_client.call("node_stats", timeout_s=5.0)
    b_tag = rt.get(consume.options(scheduling_strategy=side.affinity(
        node_id=b_hex, soft=False)).remote(ref, tag_env), timeout=30)[1]
    return {
        "sizes": [size for size, _ in outs],
        "one_node": len({tag for _, tag in outs}) == 1,
        "on_holder": {tag for _, tag in outs} == {b_tag},
        "hits": sched["locality_hits"] - base["locality_hits"] >= 4,
        "bytes": sched["locality_bytes_saved"]
        - base["locality_bytes_saved"] >= 4 * 512 * 1024,
        "rows": bool(rows) and all(
            {"running", "depth", "age_s", "tasks_executed"} <= set(row)
            for row in rows.values()),
    }


def test_large_arg_locality_places_on_holder(two_nodes):
    with time_limit(180):
        assert both(large_arg_locality, two_nodes) == {
            "sizes": [512 * 1024] * 4, "one_node": True, "on_holder": True,
            "hits": True, "bytes": True, "rows": True}


def stats_loaded_spillback(side: Side) -> dict:
    rt, runtime = side.rt, side.runtime
    # The node watcher's feed would overwrite the injection on its 2 s
    # beat: hold it off for the case.
    runtime._sched_feed_at = time.monotonic() + 60.0
    try:
        remote = [runtime.cluster.get_node(nid)
                  for nid in side.remote_node_ids()]
        default = min(remote, key=lambda n: (n.utilization(),
                                             n.node_id.hex()))
        other = next(n for n in remote if n is not default)
        base = runtime.execution_pipeline_stats()["sched"]
        runtime.cluster.update_node_stats(default.node_id, running=16.0,
                                          depth=16.0, wait_s=1.0)
        runtime.cluster.update_node_stats(other.node_id, running=0.0,
                                          depth=0.0, wait_s=0.0)
        tag_env = side.tag_env

        @rt.remote(num_cpus=1)
        def where(env_name):
            import os as _os

            return _os.environ.get(env_name, "?")[:8]

        tags = {rt.get(where.remote(tag_env), timeout=30)
                for _ in range(3)}
        sched = runtime.execution_pipeline_stats()["sched"]
        return {"one_node": len(tags) == 1,
                "spilled": sched["load_spillbacks"]
                - base["load_spillbacks"] >= 1}
    finally:
        runtime._sched_feed_at = 0.0


def test_spillback_avoids_stats_loaded_node(two_nodes):
    with time_limit(120):
        assert both(stats_loaded_spillback, two_nodes) == {
            "one_node": True, "spilled": True}
