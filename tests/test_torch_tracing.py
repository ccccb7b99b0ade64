"""The port's tracing plane (``ray_tpu_torch.util.tracing`` and the trace
context through the driver, the daemons and the pool workers) against
the JAX package's.

The ten cases of tests/test_tracing.py and the placement-group case of
tests/test_submit_pipeline.py:186 that waited for tracing. Each case
runs once through ``ray_tpu`` and once through ``ray_tpu_torch`` and
returns a plain record. Span and trace ids are random per run, so the
records hold structure: span names, parent links, process lanes, the
order of a task's stages, counters. The two records must be equal, and
equal to what the reference case asserts. The cluster cases share one
module-scoped cluster per package: one 2-CPU daemon with tracing armed
in its environment and fused execution off (the cases hold the worker
hop), and a tracing driver of no CPU.
"""

from __future__ import annotations

import importlib
import json
import time

import pytest
from torch_cluster_sides import Side, both, start_clusters, stop_clusters
from torch_time_limit import time_limit

import ray_tpu
import ray_tpu_torch

PACKAGES = ("ray_tpu", "ray_tpu_torch")
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def _tracing(pkg: str):
    return importlib.import_module(f"{pkg}.util.tracing")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _each(scenario, limit: int = 120) -> dict:
    """The scenario's record through both packages, with tracing armed
    for it and fully disarmed after; the records must agree."""
    records = {}
    for pkg in PACKAGES:
        tracing = _tracing(pkg)
        tracing.clear()
        tracing.enable()
        try:
            with time_limit(limit):
                records[pkg] = scenario(pkg, tracing)
        finally:
            tracing.disable()
            tracing.clear()
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _with_runtime(body):
    """``body(pkg, tracing, rt, runtime)`` on a fresh 8-CPU runtime of
    the package (the reference's ray_start_regular)."""

    def scenario(pkg, tracing):
        rt = RUNTIMES[pkg]
        for other in RUNTIMES.values():
            other.shutdown()
        runtime = rt.init(num_cpus=8, ignore_reinit_error=True)
        try:
            return body(pkg, tracing, rt, runtime)
        finally:
            rt.shutdown()
    return scenario


# ------------------------------------------------------------- unit level


def context_links(pkg, tracing) -> dict:
    unlinked = tracing.make_trace_context()
    with tracing.trace_span("outer") as outer:
        ctx = tracing.make_trace_context()
        linked = (ctx[0] == outer.trace_id, ctx[1] == outer.span_id)
    tracing.disable()
    return {"armed_ctx": unlinked is not None and unlinked[1] is None,
            "linked": linked,
            "disarmed_ctx": tracing.make_trace_context()}


def test_trace_context_links_to_current_span():
    assert _each(context_links) == {
        "armed_ctx": True, "linked": (True, True), "disarmed_ctx": None}


def nested_spans(pkg, tracing) -> dict:
    with tracing.trace_span("a") as a:
        with tracing.trace_span("b") as b:
            inner = (b.trace_id == a.trace_id, b.parent_id == a.span_id)
    spans = {s.name: s for s in tracing.get_spans()}
    return {"inner": inner, "names": sorted(spans),
            "recorded_same_trace":
                spans["b"].trace_id == spans["a"].trace_id,
            "root_parent": spans["a"].parent_id}


def test_nested_spans_share_trace_id():
    assert _each(nested_spans) == {
        "inner": (True, True), "names": ["a", "b"],
        "recorded_same_trace": True, "root_parent": None}


def remote_span_ingest(pkg, tracing) -> dict:
    ctx = ("tid1234", "span5678", 100.0)
    with tracing.remote_span("daemon:execute", ctx, "node:abc"):
        pass
    shipped = tracing.drain_buffered()
    out = {"n_shipped": len(shipped),
           "ids": (shipped[0]["trace_id"], shipped[0]["parent_id"]),
           "second_drain": tracing.drain_buffered()}
    before = shipped[0]["start_time"]
    out["ingested"] = tracing.ingest_spans(shipped, offset_s=5.0)
    merged = [s for s in tracing.get_spans() if s.name == "daemon:execute"]
    out["merged"] = len(merged)
    out["shifted"] = merged[0].start_time == pytest.approx(before + 5.0)
    out["proc"] = merged[0].proc
    return out


def test_remote_span_buffers_and_ingests_with_offset():
    assert _each(remote_span_ingest) == {
        "n_shipped": 1, "ids": ("tid1234", "span5678"), "second_drain": [],
        "ingested": 1, "merged": 1, "shifted": True, "proc": "node:abc"}


def clock_sync(pkg, tracing) -> dict:
    sync = tracing.ClockSync()
    # The peer's clock runs 10 s behind.
    first = sync.observe(100.0, 100.4, 90.2)     # rtt 0.4
    second = sync.observe(200.0, 200.1, 190.08)  # rtt 0.1: tighter
    third = sync.observe(300.0, 302.0, 280.0)    # rtt 2.0: looser
    return {"first": first == pytest.approx(10.0),
            "second": second == pytest.approx(9.97),
            "third": third == pytest.approx(9.97),
            "samples": sync.samples}


def test_clock_sync_keeps_min_rtt_sample():
    assert _each(clock_sync) == {"first": True, "second": True,
                                 "third": True, "samples": 3}


def offset_merge(pkg, tracing) -> dict:
    observations = [(10.0, 10.5, 3.1), (20.0, 20.2, 13.05),
                    (30.0, 31.0, 22.0)]
    offsets = []
    for _ in range(3):
        sync = tracing.ClockSync()
        for obs in observations:
            sync.observe(*obs)
        offsets.append(sync.offset)
    tracing.ingest_spans([{"name": "x", "start_time": 1.0,
                           "end_time": 2.0}], offsets[0])
    got = [s for s in tracing.get_spans() if s.name == "x"][0]
    return {"offset": round(offsets[0], 12),
            "same": offsets[0] == offsets[1] == offsets[2],
            "start": got.start_time == pytest.approx(1.0 + offsets[0]),
            "end": got.end_time == pytest.approx(2.0 + offsets[0])}


def test_clock_offset_merge_is_deterministic():
    record = _each(offset_merge)
    assert record["same"] and record["start"] and record["end"], record


def buffer_cap(pkg, tracing) -> dict:
    config = _mod(pkg, "_private.config").GLOBAL_CONFIG
    config.update({"tracing_buffer_max_spans": 4})
    try:
        for i in range(10):
            tracing.buffer_span({"name": f"s{i}", "start_time": 1.0,
                                 "end_time": 2.0})
        return {"kept": len(tracing.drain_buffered()),
                "dropped": tracing.dropped_spans()}
    finally:
        config.update({"tracing_buffer_max_spans": 4096})


def test_span_buffer_cap_counts_drops():
    assert _each(buffer_cap) == {"kept": 4, "dropped": 6}


def export_conformance(pkg, tracing, rt, runtime) -> dict:
    import tempfile

    @rt.remote
    def f():
        from importlib import import_module

        with import_module(f"{pkg}.util.tracing").trace_span("inside"):
            return 1

    values = rt.get([f.remote() for _ in range(3)])
    with tracing.trace_span("driver-side"):
        pass
    tracing.instant("fault:test_pin")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        n = tracing.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    meta = {e["name"] for e in events if e["ph"] == "M"}
    return {
        "values": values, "written": n == len(events) > 0,
        "int_lanes": all(isinstance(e["pid"], int)
                         and isinstance(e.get("tid", 0), int)
                         for e in events),
        "meta": sorted(meta & {"process_name", "thread_name"}),
        "pin": any(e["ph"] == "i" and e["name"] == "fault:test_pin"
                   for e in events),
        "spans": sorted({e["name"] for e in events
                         if e.get("cat") == "span"}),
    }


def test_export_chrome_trace_conformance():
    assert _each(_with_runtime(export_conformance)) == {
        "values": [1, 1, 1], "written": True, "int_lanes": True,
        "meta": ["process_name", "thread_name"], "pin": True,
        "spans": ["driver-side", "inside"]}


def disarmed_stage_ts(pkg, tracing, rt, runtime) -> dict:
    tracing.disable()

    @rt.remote
    def f():
        return 1

    value = rt.get(f.remote())
    return {"value": value, "armed": tracing.is_enabled(),
            "stage_maps": sorted({len(ev.stage_ts) for ev in
                                  runtime.gcs.list_task_events()})}


def test_tracing_disabled_adds_no_stage_ts():
    assert _each(_with_runtime(disarmed_stage_ts)) == {
        "value": 1, "armed": False, "stage_maps": [0]}


def pg_task_stamps(pkg, tracing, rt, runtime) -> dict:
    pg_mod = _mod(pkg, "util.placement_group")
    strategies = _mod(pkg, "util.scheduling_strategies")
    pg = pg_mod.placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(60.0)

    @rt.remote(num_cpus=1)
    def traced_task():
        return "ok"

    strategy = strategies.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    value = rt.get(traced_task.options(
        scheduling_strategy=strategy).remote(), timeout=60.0)

    def stages():
        events = [e for e in runtime.gcs.list_task_events()
                  if e.name.endswith("traced_task")]
        return events[-1].stage_ts if events else {}

    deadline = time.monotonic() + 10
    while "dispatch" not in stages() and time.monotonic() < deadline:
        time.sleep(0.05)
    got = stages()
    return {"value": value, "submit": "submit" in got,
            "dispatch": "dispatch" in got,
            "ordered": got.get("submit", 0) <= got.get("dispatch", -1)}


def test_pg_task_keeps_trace_context_and_stage_stamps():
    assert _each(_with_runtime(pg_task_stamps)) == {
        "value": "ok", "submit": True, "dispatch": True, "ordered": True}


# ---------------------------------------------------------- cluster level

TRACED_DAEMON = {"RAY_TPU_TRACING_ENABLED": "1",
                 "RAY_TPU_TORCH_TRACING_ENABLED": "1",
                 "RAY_TPU_FUSED_EXECUTION": "0",
                 "RAY_TPU_TORCH_FUSED_EXECUTION": "0"}


@pytest.fixture(scope="module")
def traced_cluster(tmp_path_factory):
    with time_limit(300):
        sides = start_clusters(tmp_path_factory.mktemp("tracing"),
                               [{"num_cpus": 2, "env": TRACED_DAEMON}])
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


def _traced(scenario):
    """Run a cluster scenario with the side's driver tracing."""

    def run(side: Side):
        tracing = _tracing(side.name)
        tracing.clear()
        tracing.enable()
        try:
            with time_limit(120):
                return scenario(side, tracing)
        finally:
            tracing.disable()
            tracing.clear()
    return run


def stage_propagation(side: Side, tracing) -> dict:
    @side.rt.remote
    def f(x):
        return x * 3

    values = side.rt.get([f.remote(i) for i in range(24)], timeout=60)
    events = [ev for ev in side.runtime.gcs.list_task_events()
              if ev.name.endswith(".f") or ev.name == "f"]
    full = [ev for ev in events
            if all(k in ev.stage_ts for k in tracing.STAGES)]
    spans = tracing.get_spans()
    lanes = {s.proc.split(":")[0] for s in spans if s.proc}
    remote = [s for s in spans if s.proc.startswith(("node:", "worker:"))]
    return {
        "values": values == [i * 3 for i in range(24)],
        "full_chain": len(full) > 0,
        "ordered": all([ev.stage_ts[k] for k in tracing.STAGES]
                       == sorted(ev.stage_ts[k] for k in tracing.STAGES)
                       for ev in full),
        "lanes": sorted(lanes),
        # A batch of one may ride the single path (its daemon:execute
        # span) or the batch RPC (daemon:task), as the flushes cut.
        "worker_spans": "worker:execute" in {s.name for s in remote},
        "known_names": {s.name for s in remote} <= {
            "daemon:execute", "daemon:task", "worker:execute"},
        "remote_trace_ids": any(s.trace_id for s in remote),
    }


def test_cluster_stage_propagation(traced_cluster):
    assert both(_traced(stage_propagation), traced_cluster) == {
        "values": True, "full_chain": True, "ordered": True,
        "lanes": ["node", "worker"], "worker_spans": True,
        "known_names": True, "remote_trace_ids": True}


def merged_chrome_trace(side: Side, tracing) -> dict:
    import tempfile

    @side.rt.remote
    def g(x):
        return x + 7

    values = side.rt.get([g.remote(i) for i in range(12)], timeout=60)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/cluster_trace.json"
        n = tracing.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    stage_events = [e for e in events if e.get("cat") == "task_stage"]
    by_task: dict = {}
    for ev in stage_events:
        by_task.setdefault(ev["args"]["task_id"], set()).add(ev["pid"])
    named = {e["pid"] for e in events if e["ph"] == "M"
             and e["name"] == "process_name"}
    return {
        "values": values == [i + 7 for i in range(12)],
        "written": n > 0, "stage_slices": bool(stage_events),
        "crossed_lanes": any(len(p) >= 2 for p in by_task.values()),
        "flows": sorted({e["ph"] for e in events if e["ph"] in ("s", "f")}),
        "lanes_named": {e["pid"] for e in stage_events} <= named,
        "slice_names": sorted({e["name"].split(" ", 1)[1]
                               for e in stage_events}),
    }


def test_cluster_merged_chrome_trace(traced_cluster):
    assert both(_traced(merged_chrome_trace), traced_cluster) == {
        "values": True, "written": True, "stage_slices": True,
        "crossed_lanes": True, "flows": ["f", "s"], "lanes_named": True,
        "slice_names": sorted([
            "stage:submit→dispatch", "stage:dispatch→rpc",
            "stage:rpc→admit", "stage:admit→worker", "stage:worker→exec",
            "stage:execute", "stage:exec→seal"])}
