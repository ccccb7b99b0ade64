"""Runtime configuration flags.

The port of ``ray_tpu/_private/config.py``, with the knobs the runtime
and its worker pool read. Each flag is declared once in ``_DEFAULTS`` and can be
overridden by a ``RAY_TPU_TORCH_<NAME>`` environment variable and by
``init(system_config={...})``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any

_DEFAULTS: dict[str, Any] = {
    # Scheduling.
    "num_cpus": os.cpu_count() or 1,
    # Object store: its budget (a put past it spills the oldest sealed
    # objects, pickled, to the spill directory).
    "object_store_memory_mb": 2048,
    "object_spilling_dir": os.path.join(tempfile.gettempdir(),
                                        "ray_tpu_torch_spill"),
    # The data layer stops growing in-flight block tasks while the store
    # holds more than this share of its budget.
    "object_spilling_threshold": 0.8,
    # End-to-end deadline every task and actor call inherits when it
    # sets none; 0 disables.
    "task_default_deadline_s": 0.0,
    # Admission control: with more tasks than this queued or running in
    # the dispatcher, a deadline-armed submit raises the retryable
    # SystemOverloadedError instead of queueing; deadline-free submits
    # queue. 0 = unlimited.
    "admission_max_queue_depth": 0,
    # Host-memory fraction above which a deadline-armed submit is shed
    # (read from /proc/meminfo, memoized for 0.2 s); with the spill tier
    # armed, pressure the spill can relieve is spilled instead. 0
    # disables.
    "admission_memory_watermark": 0.0,
    # Node health: each virtual node heartbeats every half period; one
    # silent for this many periods is declared dead.
    "health_check_period_ms": 1000,
    "health_check_failure_threshold": 5,
    # Lineage: the producing task of at most this many objects is kept
    # (the oldest lose their rebuild).
    "lineage_table_max_entries": 10_000,
    # The managed spill tier (spill_manager.py): past spill_high_watermark
    # x the store's budget, a spiller thread moves unpinned host objects,
    # largest first, to checksummed files under
    # <session dir>/spill/<pid>/ until usage is under the low watermark,
    # and a read restores them after checking length and CRC. Off, the
    # store spills inline past its budget, as before.
    "spill_enabled": True,
    "spill_high_watermark": 0.85,
    "spill_low_watermark": 0.60,
    "spill_fsync": False,           # fsync each file before its rename
    "spill_min_object_kb": 16,      # smallest object spilled
    # After a failed spill write, admission treats store pressure as
    # pressure it cannot relieve (a typed shed) for this long.
    "spill_disk_full_backoff_s": 5.0,
    # The memory monitor: above this host-memory fraction it kills the
    # pool worker with the largest RSS, every refresh period (0: off).
    "memory_usage_threshold": 0.95,
    "memory_monitor_refresh_ms": 1000,
    # Retries of a task whose worker the memory monitor killed, beyond
    # its own max_retries.
    "task_oom_retries": 3,
    # Worker processes (``init(process_workers=N)`` overrides the pool
    # size; 0: tasks run on threads of this process).
    "worker_pool_size": 0,
    # Growth cap of the pool for nested submission (0: 4 x size + 8).
    "worker_pool_max_size": 0,
    "worker_startup_timeout_s": 30.0,
    # The native shared-memory arena (plasma-lite,
    # _native/plasma_store.cpp) the driver creates at init and its worker
    # processes attach: a pool result, a promoted argument or an export
    # of at most object_arena_max_object_bytes lives there instead of in
    # a segment of its own. 0: segments only.
    "object_arena_bytes": 64 * 1024 * 1024,
    "object_arena_max_object_bytes": 1024 * 1024,
    # Pool results up to this size come back through the pipe; larger
    # ones in a shared-memory segment of their own.
    "worker_inline_result_kb": 64,
    # Small immutable values cross the pipe in the raw tag encoding
    # instead of a pickle.
    "raw_framing": True,
    # Worker processes' output goes to per-session files, tailed back to
    # this process's stdout.
    "log_to_driver": True,
    # The node layer (node.py, node_executor.py, gcs_server.py), with the
    # reference's defaults. DEFAULT placement packs onto the nodes under
    # this utilization before it spreads.
    "scheduler_spread_threshold": 0.5,
    # A node daemon's results up to this size ship in the execute reply;
    # larger ones stay in its store and are pulled in fetch_chunk_kb
    # chunks, up to rpc_pipeline_depth in flight per pull.
    "executor_inline_reply_kb": 256,
    "fetch_chunk_kb": 4096,
    "rpc_pipeline_depth": 8,
    # Coalesced RPC frames: how long a burst lingers before its
    # __batch__ frame goes (0: natural batching, no added latency) and
    # the most calls one frame carries.
    "rpc_batch_flush_ms": 0.0,
    "rpc_batch_max_entries": 128,
    # The pipelined task path: tasks per execute_task_batch RPC (the
    # dispatcher fills an open batch past a node's free slots up to
    # this, scaled by the backlog over the nodes) and the frames in
    # flight on one multi-task worker lease.
    "dispatch_batch_max": 128,
    "worker_pipeline_depth": 4,
    # Fused in-daemon execution: a run of plain CPU entries of a batch
    # RPC (no refs, no runtime_env, no GPU) runs on the daemon's
    # dispatch thread with no worker-pipe hop, at most
    # fused_max_run_tasks per RPC; past fused_run_wall_budget_s the rest
    # of the run takes the worker pipeline (counted in fused_fallbacks).
    "fused_execution": True,
    "fused_max_run_tasks": 256,
    "fused_run_wall_budget_s": 0.25,
    # The driver's submit ring: .remote() returns its refs at once and a
    # submitter thread does the record-keeping for up to
    # submit_flush_max records a pass; a full ring (submit_ring_size)
    # blocks .remote(). Off, every submit takes the inline path.
    "submit_pipeline": True,
    "submit_ring_size": 65536,
    "submit_flush_max": 1024,
    # A daemon's store of primary copies: past this cap the managed tier
    # spills them to checksummed files (spill_enabled), else the oldest
    # go inline to node_store_spill_dir.
    "node_store_primary_limit_mb": 4096,
    "node_store_spill_dir": os.path.join(tempfile.gettempdir(),
                                         "ray_tpu_torch_node_spill"),
    # A daemon drops the results and actors of a driver whose endpoint
    # stayed unreachable for owner_dead_grace_s, probing every
    # owner_sweep_period_ms; 0 disables the sweep.
    "owner_sweep_period_ms": 5000,
    "owner_dead_grace_s": 15.0,
    # The same-host plane (same_host.py): a daemon or driver on the same
    # host as an object's holder maps the holder's named shared-memory
    # segment (or copies out of it once) instead of pulling the bytes in
    # chunks over RPC. Objects of at least same_host_map_min_kb get such
    # a segment; a puller's pin lease outlives same_host_pin_ttl_s only
    # while the puller still answers pings.
    "same_host_plane": True,
    "same_host_map_min_kb": 1024,
    "same_host_pin_ttl_s": 30.0,
    # The retry policy of idempotent control calls (rpc.call_with_retry:
    # heartbeats, fetch plans, head reads) and its per-destination
    # circuit breaker: a destination that fails rpc_breaker_failures
    # logical calls in a row fails fast until one half-open probe, let
    # through after rpc_breaker_reset_s, succeeds. 0 disables the
    # breaker.
    "rpc_retry_attempts": 3,
    "rpc_retry_base_ms": 50,
    "rpc_retry_deadline_s": 15.0,
    "rpc_breaker_failures": 5,
    "rpc_breaker_reset_s": 5.0,
    # The head declares a node dead after this long without a heartbeat.
    "gcs_heartbeat_timeout_s": 10.0,
    # The durable head (gcs_persistence.py): its whole hot set as a
    # checksummed snapshot every gcs_snapshot_interval_s (or when the WAL
    # passes gcs_wal_max_mb) and a framed WAL record per mutation
    # between them. Off, the head writes the legacy {kv, jobs} pickle.
    "gcs_persistence": True,
    "gcs_snapshot_interval_s": 30.0,
    "gcs_wal_max_mb": 64,
    # fsync each WAL append and snapshot (a SIGKILL loses nothing
    # without it; a power cut may lose the tail).
    "gcs_wal_fsync": False,
    # Each head start mints a persisted epoch; writes stamped with an
    # older one are refused (StaleEpochError) until the writer re-syncs.
    "gcs_epoch_fencing": True,
    # A daemon that answers pings but stays absent from the head's node
    # table for more than this many watcher passes is dropped.
    "node_amnesia_max_passes": 5,
    # Serve routers push their latency window (p50/p99) to the
    # controller at most this often: the latency autoscaler's feed.
    # 0 disables the push.
    "serve_latency_report_s": 1.0,
    # The native (C++) daemon blob store (node_store.cpp), used when the
    # managed spill tier is off; a failed build raises.
    "node_store_native": True,
    # The native (C++) KV engine (gcs_kv.cpp) of head processes; a failed
    # build raises.
    "gcs_kv_native": True,
    # The sharded head (gcs_shard.py): the object directory, node stats
    # and task events split into this many in-head domains, each with
    # its own lock, WAL and snapshot segment and epoch. 1 keeps the
    # single snapshot and WAL; a changed count over a persisted layout
    # is refused (ReshardError).
    "gcs_shards": 1,
    # A stalled shard queues writes (WAL-durable at once) up to this
    # many, then sheds SystemOverloadedError.
    "gcs_shard_max_queued_writes": 512,
    # The performance plane (perf_plane.py): stage-latency histograms
    # and per-function resource attribution, shipped on heartbeats.
    "perf_plane": True,
    # The flight recorder (flight_recorder.py): a bounded per-process
    # event ring; daemons rewrite it under <session>/flight/ every
    # flight_recorder_flush_s when it moved (0: on demand only).
    "flight_recorder_events": 512,
    "flight_recorder_flush_s": 2.0,
    # The head's metrics history (metrics_history.py): one
    # delta-encoded sample per node per interval, kept for the
    # retention window, and the health watchdog over it.
    "metrics_history": True,
    "metrics_history_interval_s": 2.0,
    "metrics_history_retention_s": 600.0,
    # The watchdog's thresholds (metrics_history.HEALTH_RULES); rates
    # are taken over health_window_s.
    "health_window_s": 30.0,
    "health_overload_shed_per_s": 0.5,
    "health_breaker_storm_opens": 3.0,
    "health_spill_churn_per_s": 2.0,
    "health_spill_restore_p50_ms": 50.0,
    "health_wedged_age_s": 10.0,
    "health_stale_shard_age_s": 3.0,
    "health_fused_fallback_per_s": 1.0,
}

# The environment that hands a worker process its driver's arena.
ARENA_NAME_ENV = "RAY_TPU_TORCH_ARENA_NAME"
ARENA_MAX_ENV = "RAY_TPU_TORCH_ARENA_MAX"


class Config:
    """Process-wide flag table with env-var and runtime overrides."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values = dict(_DEFAULTS)
        self._apply_env_overrides()

    def _apply_env_overrides(self):
        for key, default in _DEFAULTS.items():
            raw = os.environ.get("RAY_TPU_TORCH_" + key.upper())
            if raw is not None:
                self._values[key] = _coerce(raw, type(default))

    def update(self, overrides: dict[str, Any] | str | None):
        if not overrides:
            return
        if isinstance(overrides, str):
            overrides = json.loads(overrides)
        with self._lock:
            for key, value in overrides.items():
                if key not in _DEFAULTS:
                    raise KeyError(f"Unknown system config key: {key!r}")
                self._values[key] = value

    def get(self, key: str) -> Any:
        with self._lock:
            return self._values[key]

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self.get(key)
        except KeyError:
            raise AttributeError(key) from None

    def reset(self):
        with self._lock:
            self._values = dict(_DEFAULTS)
            self._apply_env_overrides()


def _coerce(raw: str, typ: type) -> Any:
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


GLOBAL_CONFIG = Config()
