"""The Prometheus metrics agent.

The port of ``ray_tpu/_private/metrics_agent.py``: the process's metric
registry (``ray_tpu_torch.util.metrics.REGISTRY``) and the runtime's own
collectors, served in the Prometheus text format over HTTP at
``/metrics`` (``init(metrics_port=0)`` picks a free port; the agent's
``port`` says which). Families are the reference's under the
``ray_tpu_torch_`` prefix:

- the driver's tables: tasks and actors by state, the object store, the
  spill tier, nodes alive, the export leases, available resources, task
  events dropped, trace spans dropped at the tracing buffer's cap, its
  failure counters and the scheduler's decisions
  (``sched_decisions_total{kind=}``: locality hits and bytes saved, load
  spillbacks, stale-stats skips, speculations launched, won and lost);
- the head's (a connected driver): the persistence counters and epoch,
  one ``gcs_shard{shard=,key=}`` row per shard of a sharded head, the
  watchdog's ``health`` verdicts and each node's latest ``node_history``
  sample;
- per node, out of the head's node-stats table (each daemon's
  heartbeat): tasks executed and running, the data-plane, failure and
  spill groups, the LLM engine's counters (``node_engine``), the
  scheduler's load view, and the performance plane's
  ``stage_latency`` histograms and ``task_resources`` rows beside the
  driver's own.

Not ported: the reference's dispatch-lane families, whose plane the
port does not have yet (ROADMAP item 10c).
"""

from __future__ import annotations

import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ray_tpu_torch.util.metrics import REGISTRY, _escape_label

P = "ray_tpu_torch"


def install_runtime_collectors(runtime):
    """Register the scrape-time collector over ``runtime``'s tables; the
    callable it returns removes it (a later init must not scrape a dead
    runtime)."""

    def collect() -> list[str]:
        lines: list[str] = []
        by_state: dict[str, int] = {}
        for ev in runtime.gcs.list_task_events():
            by_state[ev.state] = by_state.get(ev.state, 0) + 1
        lines.append(f"# TYPE {P}_tasks gauge")
        for state, n in sorted(by_state.items()):
            lines.append(f'{P}_tasks{{state="{state}"}} {n}')

        actor_states: dict[str, int] = {}
        for rec in runtime.gcs.list_actors():
            actor_states[rec.state] = actor_states.get(rec.state, 0) + 1
        lines.append(f"# TYPE {P}_actors gauge")
        for state, n in sorted(actor_states.items()):
            lines.append(f'{P}_actors{{state="{state}"}} {n}')

        stats = runtime.store.stats()
        lines.append(f"# TYPE {P}_object_store_memory_bytes gauge")
        lines.append(f"{P}_object_store_memory_bytes "
                     f"{stats['memory_used_bytes']}")
        lines.append(f"# TYPE {P}_object_store_num_objects gauge")
        lines.append(f"{P}_object_store_num_objects {stats['num_objects']}")
        lines.append(f"# TYPE {P}_spilled_bytes_total counter")
        lines.append(f"{P}_spilled_bytes_total "
                     f"{stats['spilled_bytes_total']}")

        try:
            spill = runtime.spill_stats()
        except Exception:  # noqa: BLE001 — a runtime shutting down
            spill = {}
        lines.append(f"# TYPE {P}_spill_total counter")
        for key, value in sorted(spill.items()):
            if isinstance(value, (int, float)) and key != "restore_p50_ms":
                lines.append(f'{P}_spill_total{{node="driver",'
                             f'kind="{_escape_label(key)}"}} {int(value)}')
        lines.append(f"# TYPE {P}_spill_restore_p50_ms gauge")
        lines.append(f"{P}_spill_restore_p50_ms "
                     f"{spill.get('restore_p50_ms', 0.0)}")

        alive = sum(1 for n in runtime.gcs.list_nodes() if n.alive)
        lines.append(f"# TYPE {P}_nodes_alive gauge")
        lines.append(f"{P}_nodes_alive {alive}")

        lines.append(f"# TYPE {P}_same_host_copy_hits counter")
        lines.append(f"{P}_same_host_copy_hits "
                     f"{getattr(runtime, 'same_host_copy_hits', 0)}")
        leases = getattr(runtime, "_export_leases", None)
        if leases is not None:
            ls = leases.stats()
            lines.append(f"# TYPE {P}_export_map_leases gauge")
            for field in ("active", "granted", "released", "expired"):
                lines.append(f'{P}_export_map_leases{{state="{field}"}} '
                             f'{ls[field]}')

        lines.append(f"# TYPE {P}_resource_available gauge")
        for key, value in runtime.cluster.available_resources().items():
            lines.append(f'{P}_resource_available'
                         f'{{resource="{_escape_label(key)}"}} {value}')

        lines.append(f"# TYPE {P}_task_events_dropped_total counter")
        lines.append(f"{P}_task_events_dropped_total "
                     f"{runtime.gcs.task_events_dropped}")
        from ray_tpu_torch.util import tracing

        lines.append(f"# TYPE {P}_trace_spans_dropped_total counter")
        lines.append(f"{P}_trace_spans_dropped_total "
                     f"{tracing.dropped_spans()}")

        try:
            faults = runtime.fault_stats()
        except Exception:  # noqa: BLE001 — a runtime shutting down
            faults = {}
        lines.append(f"# TYPE {P}_faults_total counter")
        for key, value in sorted(faults.items()):
            lines.append(f'{P}_faults_total{{node="driver",'
                         f'kind="{_escape_label(key)}"}} {value}')

        # The driver's submit ring and batched dispatch, as the
        # node_submit and node_dispatch families under node="driver".
        try:
            pipeline_stats = runtime.execution_pipeline_stats()
        except Exception:  # noqa: BLE001 — a runtime shutting down
            pipeline_stats = {}
        lines.append(f"# TYPE {P}_sched_decisions_total counter")
        for key, value in sorted(pipeline_stats.get("sched", {}).items()):
            lines.append(f'{P}_sched_decisions_total'
                         f'{{kind="{_escape_label(key)}"}} {value}')
        for family, group in (("node_submit", "submit"),
                              ("node_dispatch", "dispatch")):
            lines.append(f"# TYPE {P}_{family} counter")
            for key, value in sorted(pipeline_stats.get(group, {}).items()):
                lines.append(f'{P}_{family}{{node="driver",'
                             f'key="{_escape_label(key)}"}} {int(value)}')

        lines.extend(_head_lines(runtime))
        by_node = _node_stats_table(runtime)
        lines.extend(_node_stat_lines(by_node))
        lines.extend(_engine_lines(by_node))
        lines.extend(_sched_node_lines(by_node))
        lines.extend(_perf_plane_lines(by_node))
        return lines

    return REGISTRY.add_collector(collect)


def _head_lines(runtime) -> list[str]:
    """The head's families, for a driver connected to one: persistence,
    shard rows, health verdicts and the latest history samples."""
    lines: list[str] = []
    persist = _ask(runtime.gcs_persist_stats)
    if persist:
        lines.append(f"# TYPE {P}_gcs_epoch gauge")
        lines.append(f"{P}_gcs_epoch {persist.get('epoch', 0)}")
        lines.append(f"# TYPE {P}_gcs_snapshot_restore_ms gauge")
        lines.append(f"{P}_gcs_snapshot_restore_ms "
                     f"{persist.get('snapshot_restore_ms', 0)}")
        lines.append(f"# TYPE {P}_gcs_persist_total counter")
        for key in ("wal_records_written", "wal_records_replayed",
                    "wal_replay_skipped", "snapshots_written",
                    "torn_wal_tails", "torn_snapshots", "persist_errors",
                    "fenced_writes"):
            lines.append(f'{P}_gcs_persist_total{{kind="{key}"}} '
                         f'{persist.get(key, 0)}')
    shards = _ask(runtime.gcs_shard_stats)
    if shards:
        from ray_tpu_torch._private.gcs_shard import GCS_SHARD_STAT_KEYS

        lines.append(f"# TYPE {P}_gcs_shard gauge")
        for row in shards:
            for key in GCS_SHARD_STAT_KEYS:
                lines.append(f'{P}_gcs_shard{{shard="{row.get("shard", 0)}",'
                             f'key="{key}"}} {row.get(key, 0)}')
    health = _ask(runtime.cluster_health)
    if health and health.get("armed"):
        lines.extend(_health_lines(health))
    history = _ask(lambda: runtime.metrics_history(window_s=60.0))
    if history and history.get("armed"):
        lines.extend(_history_lines(history))
    return lines


def _ask(fn):
    try:
        return fn()
    except Exception:  # noqa: BLE001 — no head, or it is unreachable
        return None


def _health_lines(health: dict) -> list[str]:
    """``health{rule=,node=}`` 1 per active verdict, and each rule's
    fired total."""
    lines = [f"# TYPE {P}_health gauge"]
    for verdict in health.get("verdicts") or []:
        rule = _escape_label(str(verdict.get("rule", "")))
        node = _escape_label(str(verdict.get("node", ""))[:16])
        lines.append(f'{P}_health{{rule="{rule}",node="{node}"}} 1')
    lines.append(f"# TYPE {P}_health_fired_total counter")
    for rule, total in sorted((health.get("fired_total") or {}).items()):
        lines.append(f'{P}_health_fired_total'
                     f'{{rule="{_escape_label(str(rule))}"}} {int(total)}')
    return lines


def _history_lines(history: dict) -> list[str]:
    """``node_history{node=,key=}``: each node's newest per-interval
    sample of the head's ring store."""
    from ray_tpu_torch._private.metrics_history import HISTORY_STAT_KEYS

    lines = [f"# TYPE {P}_node_history gauge"]
    for node_hex, row in sorted((history.get("nodes") or {}).items()):
        samples = row.get("samples") or []
        if not samples:
            continue
        latest = samples[-1]
        node = _escape_label(node_hex[:16])
        for key in HISTORY_STAT_KEYS:
            lines.append(f'{P}_node_history{{node="{node}",key="{key}"}} '
                         f'{float(latest.get(key, 0.0) or 0.0)}')
    return lines


def _node_stats_table(runtime) -> dict:
    """{node hex -> its last heartbeat stats}: the head's table for a
    connected driver, else this runtime's own."""
    client = getattr(runtime, "gcs_client", None)
    if client is not None:
        try:
            return client.call("node_stats", timeout_s=2.0) or {}
        except Exception:  # noqa: BLE001 — the head is unreachable
            return {}
    return runtime.gcs.node_stats()


def _node_stat_lines(by_node: dict) -> list[str]:
    lines: list[str] = []
    if not by_node:
        return lines
    for family, kind in (("node_tasks_executed", "counter"),
                         ("node_running_tasks", "gauge"),
                         ("node_pipeline", "counter"),
                         ("node_data_plane", "counter"),
                         ("node_faults", "counter"),
                         ("node_spill", "counter")):
        lines.append(f"# TYPE {P}_{family} {kind}")
    for node_hex, stats in sorted(by_node.items()):
        if not isinstance(stats, dict):
            continue
        node = _escape_label(node_hex[:16])
        if "tasks_executed" in stats:
            lines.append(f'{P}_node_tasks_executed{{node="{node}"}} '
                         f'{stats["tasks_executed"]}')
        if "running" in stats:
            lines.append(f'{P}_node_running_tasks{{node="{node}"}} '
                         f'{stats["running"]}')
        for group_name in ("pipeline", "data_plane", "faults", "spill"):
            group = stats.get(group_name)
            if not isinstance(group, dict):
                continue
            metric = f"{P}_node_{group_name}"
            for key, value in sorted(group.items()):
                if isinstance(value, dict):
                    # A nested table (lease stats) flattens one level.
                    for sub, subv in sorted(value.items()):
                        if isinstance(subv, (int, float)):
                            lines.append(
                                f'{metric}{{node="{node}",key='
                                f'"{_escape_label(f"{key}.{sub}")}"}} {subv}')
                elif isinstance(value, (int, float)):
                    lines.append(f'{metric}{{node="{node}",'
                                 f'key="{_escape_label(key)}"}} {value}')
    return lines


def _engine_lines(by_node: dict) -> list[str]:
    """``node_engine{node=,key=}``: the LLM engines of this process under
    node="driver", a daemon's from its heartbeat's ``engine`` group. A
    process that never served an LLM does not import the serve tier for
    a scrape."""
    rows: list[tuple[str, dict]] = []
    mod = sys.modules.get("ray_tpu_torch.serve.llm_engine.engine")
    if mod is not None:
        merged = mod.merged_engine_stats()
        if merged:
            rows.append(("driver", merged))
    for node_hex, stats in sorted(by_node.items()):
        group = stats.get("engine") if isinstance(stats, dict) else None
        if isinstance(group, dict):
            rows.append((node_hex[:16], group))
    if not rows:
        return []
    lines = [f"# TYPE {P}_node_engine counter"]
    for node, group in rows:
        for key, value in sorted(group.items()):
            if isinstance(value, (int, float)):
                lines.append(f'{P}_node_engine{{node="{_escape_label(node)}",'
                             f'key="{_escape_label(key)}"}} {int(value)}')
    return lines


def _sched_node_lines(by_node: dict) -> list[str]:
    """The load view of each node the scheduler reads: running, depth,
    the report's age and the admit and exec p50s of its histograms."""
    from ray_tpu_torch._private import perf_plane

    lines: list[str] = []
    if not by_node:
        return lines
    lines.append(f"# TYPE {P}_sched_node_load gauge")
    for node_hex, stats in sorted(by_node.items()):
        if not isinstance(stats, dict):
            continue
        node = _escape_label(node_hex[:16])
        hist = stats.get("stage_hist") \
            if isinstance(stats.get("stage_hist"), dict) else {}
        rows = {
            "running": float(stats.get("running", 0.0) or 0.0),
            "depth": float(stats.get("depth", stats.get("running", 0.0))
                           or 0.0),
            "age_s": float(stats.get("age_s", 0.0) or 0.0),
            "admit_p50_s": perf_plane.quantile(
                hist.get("admit_worker") or {}, 0.5),
            "exec_p50_s": perf_plane.quantile(hist.get("exec") or {}, 0.5),
        }
        for key, value in rows.items():
            lines.append(f'{P}_sched_node_load{{node="{node}",'
                         f'key="{key}"}} {value:g}')
    return lines


def _hist_lines(lines: list, stage: str, node: str, snap: dict) -> None:
    """One (stage, node) histogram: cumulative ``_bucket`` lines per
    bound and +Inf, ``_sum`` and ``_count``."""
    from ray_tpu_torch._private.perf_plane import BUCKET_BOUNDS

    counts = snap.get("counts") or []
    label = (f'stage="{_escape_label(stage)}",'
             f'node="{_escape_label(node)}"')
    cum = 0
    for i, bound in enumerate(BUCKET_BOUNDS):
        cum += int(counts[i]) if i < len(counts) else 0
        lines.append(f'{P}_stage_latency_bucket{{{label},'
                     f'le="{bound:g}"}} {cum}')
    total = int(snap.get("count", 0))
    lines.append(f'{P}_stage_latency_bucket{{{label},le="+Inf"}} {total}')
    lines.append(f'{P}_stage_latency_sum{{{label}}} '
                 f'{float(snap.get("sum", 0.0)):.6f}')
    lines.append(f'{P}_stage_latency_count{{{label}}} {total}')


def _perf_plane_lines(by_node: dict) -> list[str]:
    """``stage_latency`` histograms labelled (stage, node), the driver's
    hops under node="driver" and each daemon's under its id, and the
    ``task_resources`` rows per function."""
    from ray_tpu_torch._private import perf_plane

    if not perf_plane.PERF_ON:
        return []
    lines = [f"# TYPE {P}_stage_latency histogram"]
    for stage, snap in sorted(perf_plane.stage_snapshot().items()):
        _hist_lines(lines, stage, "driver", snap)
    for node_hex, stats in sorted(by_node.items()):
        hists = stats.get("stage_hist") if isinstance(stats, dict) else None
        if not isinstance(hists, dict):
            continue
        for stage, snap in sorted(hists.items()):
            if isinstance(snap, dict):
                _hist_lines(lines, stage, node_hex[:16], snap)

    lines.append(f"# TYPE {P}_task_resources gauge")

    def emit_resources(node: str, table: dict) -> None:
        for func, row in sorted(table.items()):
            if not isinstance(row, dict):
                continue
            for key in ("count", "wall_s", "cpu_s", "peak_rss_kb"):
                lines.append(
                    f'{P}_task_resources{{node="{_escape_label(node)}",'
                    f'func="{_escape_label(func)}",key="{key}"}} '
                    f'{float(row.get(key, 0.0)):g}')

    emit_resources("driver", perf_plane.resource_snapshot())
    for node_hex, stats in sorted(by_node.items()):
        table = stats.get("task_resources") \
            if isinstance(stats, dict) else None
        if isinstance(table, dict):
            emit_resources(node_hex[:16], table)
    return lines


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server's name
        path = self.path.split("?", 1)[0].rstrip("/")
        if path not in ("", "/metrics"):
            self.send_error(404)
            return
        body = REGISTRY.scrape().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # no stderr line per request
        pass


class MetricsAgent:
    """The ``/metrics`` endpoint on a thread of its own."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 remove_collector=None):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._remove_collector = remove_collector
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ray_tpu_torch-metrics")
        self._thread.start()

    def shutdown(self) -> None:
        if self._remove_collector is not None:
            self._remove_collector()
        self._server.shutdown()
        self._server.server_close()


def start_metrics_agent(runtime, port: int = 0) -> MetricsAgent:
    remove = install_runtime_collectors(runtime)
    return MetricsAgent(port=port, remove_collector=remove)
