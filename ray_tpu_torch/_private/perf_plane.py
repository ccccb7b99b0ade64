"""The always-on performance plane: stage-latency histograms and
per-task resource attribution.

The port of ``ray_tpu/_private/perf_plane.py``, whole.

- **Fixed log-bucketed histograms** (``StageHistogram``): 26 power-of-2
  buckets from 1 us to ~33 s. Observing is one ``bit_length`` and
  three adds under a short lock. Snapshots are plain count lists that
  merge by bucket addition, so daemons ship them on their heartbeat
  (``stats_for_sync``) and the head and the driver fold them exactly.
- **Durations, not timestamps**: every hop is measured on one process's
  clock, so no clock sync is needed.
- **One module-attribute branch when disarmed** (``PERF_ON``), armed by
  the ``perf_plane`` config key (default on;
  ``RAY_TPU_TORCH_PERF_PLANE=0`` disarms a cluster through the daemons'
  environment).

Stage names (each names the hop that ends there):

- driver: ``submit_dispatch`` (``.remote()`` to the scheduler's claim),
  ``dispatch_rpc`` (claim to the execute RPC sent), ``rpc_seal`` (RPC
  sent to the results sealed: the remote round trip), ``exec_local``
  (a task run by the driver's threads or its pool: the function's wall)
- daemon: ``admit_worker`` (admission to the function's start),
  ``exec`` (the function's wall, measured where it ran)

Per-task resource attribution: a worker samples ``time.thread_time``,
the wall clock and the peak-RSS delta around the task body and sends
the 4-tuple back with its reply; the process that owns the run rolls it
up per function (count, cpu seconds, wall, peak RSS), served as the
``task_resources`` heartbeat group and the ``ray_tpu_torch_task_resources``
family of ``/metrics``.
"""

from __future__ import annotations

import resource
import threading
import time

_thread_time = time.thread_time
_wall_time = time.time
_getrusage = resource.getrusage
_RUSAGE_SELF = resource.RUSAGE_SELF

# Bucket i covers (2^(i-1) µs, 2^i µs]; the last bucket is +Inf.
N_BUCKETS = 26
BUCKET_BOUNDS = tuple(1e-6 * (1 << i) for i in range(N_BUCKETS))

# The ONE production branch: instrumentation sites across the runtime
# check this module attribute and pay nothing else while the plane is
# disarmed. Armed from config at first Runtime/daemon init.
PERF_ON: bool = True


def _bucket_index(dt_s: float) -> int:
    """Deterministic log2 bucket for a duration: bucket i holds
    durations in (2^(i-1), 2^i] microseconds (sub-µs lands in bucket
    0; overflow saturates into the +Inf bucket)."""
    if dt_s <= 0.0:
        return 0
    n = int(dt_s * 1e6)
    if n <= 1:
        return 0
    idx = (n - 1).bit_length()
    return idx if idx < N_BUCKETS else N_BUCKETS


class StageHistogram:
    """Lock-cheap fixed-bucket latency histogram.

    ``observe`` is the hot path: one bucket-index computation and three
    updates under a short lock. ``snapshot()`` returns the mergeable
    plain-data form ({"counts": [...N_BUCKETS+1 ints], "sum": s,
    "count": n}) that rides heartbeats and /metrics."""

    __slots__ = ("_counts", "_sum", "_count", "_lock")

    def __init__(self):
        self._counts = [0] * (N_BUCKETS + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, dt_s: float) -> None:
        idx = _bucket_index(dt_s)
        with self._lock:
            self._counts[idx] += 1
            self._sum += dt_s
            self._count += 1

    def observe_many(self, samples) -> None:
        """One lock pass for a whole batch of durations (the columnar
        completion path records a reply group's worth of stage hops at
        once instead of a lock acquire per task)."""
        indexed = [(_bucket_index(dt), dt) for dt in samples]
        with self._lock:
            for idx, dt in indexed:
                self._counts[idx] += 1
                self._sum += dt
            self._count += len(indexed)

    def observe_n(self, dt_s: float, n: int) -> None:
        """``n`` identical samples in one pass (a streamed reply group
        lands at one instant — every member shares the rpc_seal
        duration)."""
        idx = _bucket_index(dt_s)
        with self._lock:
            self._counts[idx] += n
            self._sum += dt_s * n
            self._count += n

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self._counts), "sum": self._sum,
                    "count": self._count}


def merge_snapshots(into: dict, snap: dict) -> dict:
    """Fold one snapshot into an accumulator IN PLACE (bucket-wise
    addition — the property that makes per-node histograms cluster-
    aggregatable without approximation). Returns ``into``."""
    counts = into.setdefault("counts", [0] * (N_BUCKETS + 1))
    other = snap.get("counts") or []
    for i in range(min(len(counts), len(other))):
        counts[i] += int(other[i])
    into["sum"] = float(into.get("sum", 0.0)) + float(snap.get("sum", 0.0))
    into["count"] = int(into.get("count", 0)) + int(snap.get("count", 0))
    return into


def quantile(snap: dict, q: float) -> float:
    """Estimate a quantile from a snapshot by linear interpolation
    inside the target bucket (upper-bounded by the bucket edge). The
    +Inf bucket reports the largest finite bound."""
    counts = snap.get("counts") or []
    total = int(snap.get("count", 0))
    if total <= 0 or not counts:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= target:
            hi = BUCKET_BOUNDS[i] if i < N_BUCKETS \
                else BUCKET_BOUNDS[-1]
            lo = BUCKET_BOUNDS[i - 1] if 0 < i <= N_BUCKETS else 0.0
            frac = (target - seen) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += c
    return BUCKET_BOUNDS[-1]


# --------------------------------------------------------------------------
# Process-wide stage registry
# --------------------------------------------------------------------------

_hist_lock = threading.Lock()
_hists: dict[str, StageHistogram] = {}


def record_stage(stage: str, dt_s: float) -> None:
    """Record one hop duration into this process's histogram for
    ``stage``. Callers gate on ``PERF_ON`` so the disarmed cost is one
    module-attribute branch."""
    hist = _hists.get(stage)
    if hist is None:
        with _hist_lock:
            hist = _hists.setdefault(stage, StageHistogram())
    hist.observe(dt_s)


def record_stage_many(stage: str, samples) -> None:
    """Batched record_stage: one histogram-lock pass for a whole
    group of durations."""
    if not samples:
        return
    hist = _hists.get(stage)
    if hist is None:
        with _hist_lock:
            hist = _hists.setdefault(stage, StageHistogram())
    hist.observe_many(samples)


def record_stage_n(stage: str, dt_s: float, n: int) -> None:
    """``n`` identical observations in one pass."""
    if n <= 0:
        return
    hist = _hists.get(stage)
    if hist is None:
        with _hist_lock:
            hist = _hists.setdefault(stage, StageHistogram())
    hist.observe_n(dt_s, n)


def stage_snapshot() -> dict:
    """{stage: histogram snapshot} for every stage this process has
    recorded (the heartbeat/scrape payload)."""
    with _hist_lock:
        hists = dict(_hists)
    return {stage: h.snapshot() for stage, h in hists.items()}


# --------------------------------------------------------------------------
# Per-task resource attribution
# --------------------------------------------------------------------------

_res_lock = threading.Lock()
# func signature -> [count, wall_s sum, cpu_s sum, peak rss delta kb]
_resources: dict[str, list] = {}


def sample_start() -> tuple:
    """(thread_time, wall, ru_maxrss_kb) before a task body."""
    return (_thread_time(), _wall_time(),
            _getrusage(_RUSAGE_SELF).ru_maxrss)


def sample_end(name: str, start: tuple) -> tuple:
    """Finish a sample: (name, wall_s, cpu_s, rss_delta_kb) — the
    4-tuple that rides worker replies and feeds
    ``record_task_resources``. RSS is a high-water mark, so the delta
    is how much this task RAISED the process peak (0 for tasks that
    fit under it)."""
    cpu0, wall0, rss0 = start
    return (name,
            _wall_time() - wall0,
            _thread_time() - cpu0,
            max(0, _getrusage(_RUSAGE_SELF).ru_maxrss - rss0))


def record_task_resources(name: str, wall_s: float, cpu_s: float,
                          rss_delta_kb: float, count: int = 1) -> None:
    """Fold one sample into the per-function table. ``count`` lets a
    run-level sample (fused in-daemon runs measure once around N
    tasks) keep the task count honest while the sums stay exact."""
    with _res_lock:
        row = _resources.get(name)
        if row is None:
            _resources[name] = [int(count), float(wall_s), float(cpu_s),
                                float(rss_delta_kb)]
        else:
            row[0] += int(count)
            row[1] += float(wall_s)
            row[2] += float(cpu_s)
            row[3] = max(row[3], float(rss_delta_kb))


def resource_snapshot() -> dict:
    """{func: {count, wall_s, cpu_s, peak_rss_kb}} for this process."""
    with _res_lock:
        return {name: {"count": row[0], "wall_s": row[1],
                       "cpu_s": row[2], "peak_rss_kb": row[3]}
                for name, row in _resources.items()}


def merge_resource_tables(into: dict, table: dict) -> dict:
    """Fold one per-function table into an accumulator IN PLACE
    (counts/sums add, peak RSS takes the max)."""
    for name, row in (table or {}).items():
        if not isinstance(row, dict):
            continue
        acc = into.setdefault(name, {"count": 0, "wall_s": 0.0,
                                     "cpu_s": 0.0, "peak_rss_kb": 0.0})
        acc["count"] += int(row.get("count", 0))
        acc["wall_s"] += float(row.get("wall_s", 0.0))
        acc["cpu_s"] += float(row.get("cpu_s", 0.0))
        acc["peak_rss_kb"] = max(acc["peak_rss_kb"],
                                 float(row.get("peak_rss_kb", 0.0)))
    return into


# --------------------------------------------------------------------------
# Per-function wall samples (straggler-speculation feed)
# --------------------------------------------------------------------------

# Exact recent wall-clock samples per function signature, recorded by
# the OWNER at task completion (submit -> seal on the driver's own
# clock, so every node's execution of the function lands in one merged
# sample set — the cluster view of the function's distribution). The
# speculation watcher compares in-flight elapsed walls against the p99
# of this ring; exact samples, not histogram buckets, because the
# trigger multiplies the p99 and a bucket-edge estimate would swing
# the threshold by up to 2x.
WALL_SAMPLE_CAP = 512

_wall_lock = threading.Lock()
_walls: dict[str, list] = {}  # name -> [next_idx, [samples...]]


def record_task_wall(name: str, wall_s: float) -> None:
    """One completed task's end-to-end wall (owner clock)."""
    with _wall_lock:
        entry = _walls.get(name)
        if entry is None:
            _walls[name] = [0, [float(wall_s)]]
            return
        idx, samples = entry
        if len(samples) < WALL_SAMPLE_CAP:
            samples.append(float(wall_s))
        else:
            samples[idx] = float(wall_s)
            entry[0] = (idx + 1) % WALL_SAMPLE_CAP


def wall_quantile(name: str, q: float) -> "tuple[int, float]":
    """(sample count, exact q-quantile wall) for ``name``; (0, 0.0)
    when the function has no completed samples yet."""
    with _wall_lock:
        entry = _walls.get(name)
        samples = list(entry[1]) if entry is not None else []
    if not samples:
        return 0, 0.0
    samples.sort()
    idx = min(len(samples) - 1,
              max(0, int(round(q * (len(samples) - 1)))))
    return len(samples), samples[idx]


# --------------------------------------------------------------------------
# Arm/disarm
# --------------------------------------------------------------------------


def enable() -> None:
    global PERF_ON
    PERF_ON = True


def disable() -> None:
    global PERF_ON
    PERF_ON = False


def reset() -> None:
    """Clear every histogram and the attribution table (tests; a
    shutdown/init cycle must not replay the previous session's
    latencies)."""
    with _hist_lock:
        _hists.clear()
    with _res_lock:
        _resources.clear()
    with _wall_lock:
        _walls.clear()


def init_from_config() -> None:
    """Arm/disarm from the ``perf_plane`` knob (driver init and daemon
    boot both call this; workers inherit RAY_TPU_TORCH_PERF_PLANE
    through the child env at import of their config)."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    global PERF_ON
    PERF_ON = bool(GLOBAL_CONFIG.perf_plane)


# Env-driven default: forked/spawned processes (pool workers, daemons)
# arm the plane at import to match their parent without any handshake.
try:
    init_from_config()
except Exception:  # noqa: BLE001 — config unavailable mid-bootstrap
    pass
