"""The port's metrics agent, user metrics and performance plane
(``ray_tpu_torch/_private/metrics_agent.py``, ``util/metrics.py``,
``_private/perf_plane.py``) against the JAX package's.

Each metrics case of tests/test_state_metrics.py (:89, :110, :120, :139,
:162, :201, :265, :321, :386 and :452) runs once through ``ray_tpu`` and
once through ``ray_tpu_torch`` and returns a plain record (the lines and
families a scrape serves, parsed); the records must be equal, and equal
to what the reference case asserts. A scrape's family names carry each
package's prefix (``ray_tpu_`` and ``ray_tpu_torch_``): the record
normalises the port's to the reference's.

Where the port differs, each with its ROADMAP item:

- it has no tracing plane yet (item 12): the reference's "tracing
  disabled" precondition (:265, :386) and its dropped-spans family
  (:120) are checked on the reference's side only;
- its head keeps task events one call at a time (no batch call, no
  task-event groups: no submit path of the port needs them), so :139's
  batched overflow is a second single record on the port's side;
- its daemons have no pipelined execute path, so the per-node
  ``node_pipeline`` family (:321) is checked on the reference's side
  only; the ``node_data_plane`` and ``node_faults`` families are held
  equal.

The state-API cases (:23, :51, :68, :78, :229, :300) wait for item 12's
``util/state``.
"""

from __future__ import annotations

import importlib
import re
import time
import urllib.request

from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _pkg(pkg: str):
    return importlib.import_module(pkg)


def _metrics(pkg: str):
    return importlib.import_module(f"{pkg}.util.metrics")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}._private.{name}")


def _both(scenario) -> dict:
    records = {}
    for pkg in PACKAGES:
        _pkg(pkg).shutdown()
        _metrics(pkg).REGISTRY.clear()
        try:
            records[pkg] = scenario(pkg)
        finally:
            _pkg(pkg).shutdown()
            _metrics(pkg).REGISTRY.clear()
            _mod(pkg, "config").GLOBAL_CONFIG.reset()
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _scrape(port: int) -> str:
    """One scrape, the port's family prefix normalised."""
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=10).read().decode()
    return body.replace("ray_tpu_torch_", "ray_tpu_")


def _tracing_off(pkg: str) -> bool:
    if pkg != "ray_tpu":
        return True  # the port has no tracing plane (item 12)
    return not importlib.import_module("ray_tpu.util.tracing").is_enabled()


# ------------------------------------------------------------ user metrics


def user_exposition(pkg):
    m = _metrics(pkg)
    c = m.Counter("test_requests_total", "requests", tag_keys=("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2, tags={"route": "/a"})
    g = m.Gauge("test_queue_depth", "depth")
    g.set(7)
    h = m.Histogram("test_latency_s", "latency", boundaries=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return {"text": m.REGISTRY.scrape()}


def test_user_metrics_exposition():
    """tests/test_state_metrics.py:89: the whole exposition text is
    equal in both packages."""
    text = _both(user_exposition)["text"]
    for line in ('test_requests_total{route="/a"} 3.0',
                 "test_queue_depth 7.0", 'test_latency_s_bucket{le="0.1"} 1',
                 'test_latency_s_bucket{le="1.0"} 2',
                 'test_latency_s_bucket{le="+Inf"} 3',
                 "test_latency_s_count 3"):
        assert line in text


def tag_validation(pkg):
    m = _metrics(pkg)
    c = m.Counter("test_tagged", tag_keys=("a",))
    errors = []
    for call in (lambda: c.inc(tags={"b": "x"}), lambda: c.inc(-1)):
        try:
            call()
            errors.append(None)
        except ValueError:
            errors.append("ValueError")
    try:
        m.Counter("test_tagged")
        errors.append(None)
    except ValueError:
        errors.append("ValueError")
    return {"errors": errors,
            "escaped": m._escape_label('a"b\\c\nd')}


def test_metric_tag_validation():
    """tests/test_state_metrics.py:110, and a second registration of a
    name and the label escaping beside it."""
    assert _both(tag_validation) == {
        "errors": ["ValueError"] * 3, "escaped": 'a\\"b\\\\c\\nd'}


# ------------------------------------------------------------ the endpoint


def http_endpoint(pkg):
    rt = _pkg(pkg)
    runtime = rt.init(num_cpus=4, metrics_port=0)

    @rt.remote
    def work():
        return 1

    rt.get([work.remote() for _ in range(3)])
    body = _scrape(runtime.metrics_agent.port)
    record = {line: line in body for line in (
        'ray_tpu_tasks{state="FINISHED"} 3', "ray_tpu_nodes_alive 1",
        "ray_tpu_object_store_num_objects",
        "ray_tpu_task_events_dropped_total",
        'ray_tpu_faults_total{node="driver",kind="rpc_retries"}')}
    if pkg == "ray_tpu":  # the tracing plane (item 12)
        assert "ray_tpu_trace_spans_dropped_total" in body
    return record


def test_metrics_http_endpoint():
    """tests/test_state_metrics.py:120."""
    with time_limit(60):
        assert all(_both(http_endpoint).values())


def event_drops(pkg):
    rt = _pkg(pkg)
    runtime = rt.init(num_cpus=4, metrics_port=0)
    gcs_mod = _mod(pkg, "gcs")
    task_id = _mod(pkg, "ids").TaskID
    gcs = runtime.gcs
    # The cap = now: the reference's single-lock table's, the port's one
    # task-event domain's (gcs_shards=1).
    capped = gcs if pkg == "ray_tpu" else gcs._task_shards[0]
    attr = "_task_event_limit" if pkg == "ray_tpu" else "limit"
    old_limit = getattr(capped, attr)
    setattr(capped, attr, len(gcs.list_task_events()))
    try:
        gcs.record_task_event(gcs_mod.TaskEvent(task_id(), "overflow",
                                                "PENDING"))
        late = gcs_mod.TaskEvent(task_id(), "overflow2", "PENDING")
        if pkg == "ray_tpu":
            gcs.record_task_events([late])
        else:  # the port has no batch call (no submit path needs one)
            gcs.record_task_event(late)
    finally:
        setattr(capped, attr, old_limit)
    body = _scrape(runtime.metrics_agent.port)
    return {"dropped": gcs.task_events_dropped,
            "line": "ray_tpu_task_events_dropped_total 2" in body}


def test_task_event_drops_are_counted():
    """tests/test_state_metrics.py:139."""
    with time_limit(60):
        assert _both(event_drops) == {"dropped": 2, "line": True}


# ------------------------------------------- always-on performance plane


def histogram_buckets(pkg):
    perf = _mod(pkg, "perf_plane")

    def fill(values):
        h = perf.StageHistogram()
        for v in values:
            h.observe(v)
        return h.snapshot()

    vals = [0.0, 1e-7, 1e-6, 1.5e-6, 2e-6, 3e-6, 1e-3, 0.5, 100.0, 1e9]
    a, b = fill(vals), fill(vals)
    other = fill([1e-6, 0.5])
    merged: dict = {}
    perf.merge_snapshots(merged, a)
    perf.merge_snapshots(merged, other)
    q = perf.quantile(fill([0.5] * 10), 0.5)
    many = perf.StageHistogram()
    many.observe_many([1e-6, 2e-6, 0.5])
    many.observe_n(0.25, 4)
    return {"same": a == b, "a": a,
            "index": [perf._bucket_index(x)
                      for x in (1e-6, 2e-6, 3e-6, 4e-6, 1e9)],
            "merged_counts": merged["counts"] == [
                x + y for x, y in zip(a["counts"], other["counts"])],
            "merged_count": merged["count"],
            "q": 0.25 <= q <= 1.1, "many": many.snapshot()}


def test_stage_histogram_buckets_and_merge_determinism():
    """tests/test_state_metrics.py:162, with the batched observers
    beside it."""
    record = _both(histogram_buckets)
    assert record["same"] and record["a"]["count"] == 10
    assert record["index"] == [0, 1, 2, 2, 26]
    assert record["merged_counts"] and record["merged_count"] == 12
    assert record["q"] and record["many"]["count"] == 7


def gcs_aggregation(pkg):
    perf = _mod(pkg, "perf_plane")

    def hist_with(n, dt):
        h = perf.StageHistogram()
        for _ in range(n):
            h.observe(dt)
        return h.snapshot()

    gcs = _mod(pkg, "gcs").GlobalControlService()
    gcs.record_node_stats("aa" * 8,
                          {"stage_hist": {"exec": hist_with(3, 0.01)}})
    gcs.record_node_stats("bb" * 8, {
        "stage_hist": {"exec": hist_with(5, 0.01),
                       "admit_worker": hist_with(2, 0.001)}})
    merged = gcs.cluster_stage_latency()
    record = {"exec": merged["exec"]["count"],
              "admit": merged["admit_worker"]["count"]}
    gcs.drop_node_stats("aa" * 8)
    record["after_drop"] = gcs.cluster_stage_latency()["exec"]["count"]
    return record


def test_gcs_stage_aggregation_prunes_dead_nodes():
    """tests/test_state_metrics.py:201."""
    assert _both(gcs_aggregation) == {"exec": 8, "admit": 2,
                                      "after_drop": 5}


def resource_tables(pkg):
    perf = _mod(pkg, "perf_plane")
    perf.reset()
    sample = perf.sample_end("f", perf.sample_start())
    perf.record_task_resources("g", 1.0, 0.5, 10.0, count=3)
    perf.record_task_resources("g", 2.0, 0.5, 4.0)
    table = perf.resource_snapshot()
    merged = perf.merge_resource_tables({}, table)
    perf.merge_resource_tables(merged, table)
    for wall in (0.3, 0.1, 0.2):
        perf.record_task_wall("h", wall)
    walls = perf.wall_quantile("h", 0.5)
    perf.reset()
    return {"sample": (sample[0], len(sample)), "g": table["g"],
            "merged": merged["g"], "walls": walls,
            "none": perf.wall_quantile("h", 0.5)}


def test_task_resource_tables_and_walls():
    """The per-function attribution and the wall samples of
    ray_tpu/_private/perf_plane.py, through both packages."""
    assert _both(resource_tables) == {
        "sample": ("f", 4),
        "g": {"count": 4, "wall_s": 3.0, "cpu_s": 1.0, "peak_rss_kb": 10.0},
        "merged": {"count": 8, "wall_s": 6.0, "cpu_s": 2.0,
                   "peak_rss_kb": 10.0},
        "walls": (3, 0.2), "none": (0, 0.0)}


def local_scrape(pkg):
    rt = _pkg(pkg)
    runtime = rt.init(num_cpus=4, metrics_port=0)
    tracing_off = _tracing_off(pkg)

    @rt.remote
    def work(x):
        return x * 2

    values = rt.get([work.remote(i) for i in range(4)])
    body = _scrape(runtime.metrics_agent.port)
    return {"tracing_off": tracing_off, "values": values,
            "submit_dispatch": bool(re.search(
                r'ray_tpu_stage_latency_bucket\{stage="submit_dispatch",'
                r'node="driver",le="\+Inf"\} [1-9]', body)),
            "exec_local_count": bool(re.search(
                r'ray_tpu_stage_latency_count\{stage="exec_local",'
                r'node="driver"\} [1-9]', body)),
            "exec_local_sum": bool(re.search(
                r'ray_tpu_stage_latency_sum\{stage="exec_local",'
                r'node="driver"\} ', body)),
            "resources": bool(re.search(
                r'ray_tpu_task_resources\{node="driver",'
                r'func="[^"]*work[^"]*",key="cpu_s"\} ', body))}


def test_local_scrape_serves_stage_latency_and_resources():
    """tests/test_state_metrics.py:265."""
    with time_limit(60):
        assert _both(local_scrape) == {
            "tracing_off": True, "values": [0, 2, 4, 6],
            "submit_dispatch": True, "exec_local_count": True,
            "exec_local_sum": True, "resources": True}


# ------------------------------------------------------------ the cluster


def _cluster_driver(pkg, log_dir, n_nodes, cpus, **cluster_kwargs):
    rt = _pkg(pkg)
    cluster = importlib.import_module(f"{pkg}.cluster_utils").Cluster(
        log_dir=str(log_dir), **cluster_kwargs)
    for _ in range(n_nodes):
        cluster.add_node(num_cpus=2)
    assert cluster.wait_for_nodes(n_nodes, timeout=90)
    runtime = rt.init(num_cpus=0, address=cluster.address, metrics_port=0)
    deadline = time.time() + 30
    while time.time() < deadline \
            and rt.cluster_resources().get("CPU", 0) < cpus:
        time.sleep(0.2)
    return rt, cluster, runtime


def per_node_series(pkg, tmp_path):
    rt, cluster, runtime = _cluster_driver(pkg, tmp_path / pkg, 1, 2)
    try:
        @rt.remote
        def work(x):
            return x

        values = rt.get([work.remote(i) for i in range(8)])
        port = runtime.metrics_agent.port
        pattern = re.compile(r'ray_tpu_node_tasks_executed\{node="[0-9a-f]+"\}'
                             r' ([1-9][0-9]*)')
        deadline = time.time() + 15
        body = _scrape(port)
        while time.time() < deadline and not pattern.search(body):
            time.sleep(0.5)
            body = _scrape(port)
        if pkg == "ray_tpu":  # the pipelined execute path
            assert re.search(r'ray_tpu_node_pipeline\{node="[0-9a-f]+",'
                             r'key="batch_tasks"\} \d+', body)
        return {"values": values, "executed": bool(pattern.search(body)),
                **{family: bool(re.search(
                    family + r'\{node="[0-9a-f]+",key="[a-z_.]+"\} ', body))
                   for family in ("ray_tpu_node_data_plane",
                                  "ray_tpu_node_faults")}}
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_cluster_scrape_serves_per_node_series(tmp_path):
    """tests/test_state_metrics.py:321."""
    with time_limit(120):
        assert _both(lambda pkg: per_node_series(pkg, tmp_path)) == {
            "values": list(range(8)), "executed": True,
            "ray_tpu_node_data_plane": True, "ray_tpu_node_faults": True}


def stage_histograms(pkg, tmp_path):
    tracing_off = _tracing_off(pkg)
    rt, cluster, runtime = _cluster_driver(pkg, tmp_path / pkg, 2, 4)
    try:
        @rt.remote
        def work(x):
            return x

        spread = work.options(scheduling_strategy="SPREAD")
        values = sorted(rt.get([spread.remote(i) for i in range(16)]))
        port = runtime.metrics_agent.port

        def series():
            pairs = re.findall(
                r'ray_tpu_stage_latency_count\{stage="([a-z_]+)",'
                r'node="([0-9a-f]+|driver)"\} ([1-9][0-9]*)', _scrape(port))
            return {n for _s, n, _c in pairs}, {s for s, _n, _c in pairs}

        deadline = time.time() + 20
        nodes, stages = series()
        while time.time() < deadline and (len(nodes) < 3 or len(stages) < 3):
            time.sleep(0.5)
            nodes, stages = series()
        return {"tracing_off": tracing_off, "values": values,
                "daemons": len(nodes - {"driver"}) >= 2,
                "driver": "driver" in nodes, "stages": len(stages) >= 3,
                "exec": "exec" in stages, "rpc_seal": "rpc_seal" in stages}
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_cluster_scrape_serves_stage_latency_histograms(tmp_path):
    """tests/test_state_metrics.py:386."""
    with time_limit(150):
        assert _both(lambda pkg: stage_histograms(pkg, tmp_path)) == {
            "tracing_off": True, "values": list(range(16)), "daemons": True,
            "driver": True, "stages": True, "exec": True, "rpc_seal": True}


def persist_families(pkg, tmp_path):
    rt = _pkg(pkg)
    cluster = importlib.import_module(f"{pkg}.cluster_utils").Cluster(
        log_dir=str(tmp_path / pkg / "cluster"),
        persist_path=str(tmp_path / pkg / "gcs_snapshot.pkl"))
    cluster.add_node(num_cpus=2)
    try:
        assert cluster.wait_for_nodes(1, timeout=60)
        runtime = rt.init(num_cpus=0, address=cluster.address,
                          metrics_port=0)
        body = _scrape(runtime.metrics_agent.port)
        epoch = re.search(r"ray_tpu_gcs_epoch (\d+)", body)
        return {"epoch": epoch is not None
                and int(epoch.group(1)) == cluster.gcs.epoch,
                "kinds": [bool(re.search(
                    r'ray_tpu_gcs_persist_total\{kind="%s"\} \d+' % kind,
                    body)) for kind in (
                    "wal_records_written", "wal_records_replayed",
                    "snapshots_written", "torn_wal_tails", "torn_snapshots",
                    "persist_errors", "fenced_writes")],
                "restore_ms": bool(re.search(
                    r"ray_tpu_gcs_snapshot_restore_ms \d", body)),
                "no_shard_rows": "ray_tpu_gcs_shard{" not in body}
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_cluster_scrape_serves_gcs_persist_families(tmp_path):
    """tests/test_state_metrics.py:452; an unsharded head serves no shard
    rows."""
    with time_limit(90):
        assert _both(lambda pkg: persist_families(pkg, tmp_path)) == {
            "epoch": True, "kinds": [True] * 7, "restore_ms": True,
            "no_shard_rows": True}
