"""The head's metrics history: a time-series ring store over the
node-stats table and the health watchdog that sweeps it.

The port of ``ray_tpu/_private/metrics_history.py``, whole. The
per-node cumulative stats daemons ship on their heartbeats
(``node_executor.stats_for_sync`` into the head's node-stats table)
become bounded per-interval history:

- ``HistoryStore``: a fixed-interval ring per node, sharded along the
  head's node-stats domains (``gcs_shard.shard_of(node_hex)``) and
  merged across them when queried. Each interval the head's monitor
  tick delta-encodes the cumulative counters into one sample
  (``HISTORY_STAT_KEYS`` and the stage histograms' bucket deltas); a
  counter that went backward (its daemon restarted) clamps to zero and
  rebaselines. Retention is ``metrics_history_retention_s``; the nodes
  of a stalled head shard get stale-marked samples, and queries name
  the domain under ``degraded`` instead of blocking.
- ``snapshot_delta``/``summarize``: the windowed-latency helpers, the
  one copy the serve router uses too.
- ``HealthWatchdog``: a rule sweep each interval emitting typed
  verdicts (``HEALTH_RULES``): overload (sustained admission sheds),
  breaker_storm, spill_thrash, stale_shard, wedged_node (an ``age_s``
  past bound) and fused_fallback_spike. A verdict becoming active is
  flight-recorded (``health.<rule>``), exported as
  ``ray_tpu_torch_health{rule=,node=}`` and served by the
  ``cluster_health`` RPC with its evidence.

``fused_fallback_spike`` (with its ``fused_fallbacks`` history key and
its ``health_fused_fallback_per_s`` threshold) reads a daemon's
``pipeline`` group, which no daemon of the port ships: the port has no
pipelined execute path, and its kernels never fall back. The rule is
kept so the port's watchdog answers the reference's rule set, and is
inert until a fused pipeline is ported.

Disarmed (``metrics_history`` off), the head's monitor tick pays one
module-attribute branch (``HISTORY_ON``) and both RPCs answer
``armed=False``. The reference's per-lock witness classes are plain
``threading.Lock``s here (the lock witness is not ported yet).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ray_tpu_torch._private import gcs_shard, perf_plane

# The ONE disarm branch (same discipline as perf_plane.PERF_ON).
HISTORY_ON = True


def init_from_config() -> None:
    """Arm/disarm the history plane from config (head boot reaches
    this through import; RAY_TPU_TORCH_METRICS_HISTORY=0 disarms)."""
    global HISTORY_ON
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    HISTORY_ON = bool(GLOBAL_CONFIG.metrics_history)


try:
    init_from_config()
except Exception:  # noqa: BLE001 — config unavailable mid-bootstrap
    pass


# The per-interval sample row. Counters are per-interval deltas of the
# heartbeat-shipped cumulative stats; gauge keys are point samples.
HISTORY_STAT_KEYS = (
    "tasks_executed", "admission_shed", "breaker_open", "task_timeouts",
    "rpc_retries", "spills", "restores", "restore_p50_ms",
    "fused_fallbacks", "chunked_pulls", "same_host_map_hits",
    "prefill_tokens", "decode_tokens", "running", "depth",
)
# Point-sample keys (everything else in the registry delta-encodes).
GAUGE_KEYS = frozenset({"restore_p50_ms", "running", "depth"})
# The delta-encoded (rate-derivable) subset, precomputed for query().
_COUNTER_KEYS = tuple(k for k in HISTORY_STAT_KEYS
                      if k not in GAUGE_KEYS)
# Where each registry key lives in a stats_for_sync() row:
# (group or None for top-level, field).
_STAT_SOURCES = {
    "tasks_executed": (None, "tasks_executed"),
    "admission_shed": ("faults", "admission_shed"),
    "breaker_open": ("faults", "breaker_open"),
    "task_timeouts": ("faults", "task_timeouts"),
    "rpc_retries": ("faults", "rpc_retries"),
    "spills": ("spill", "spills"),
    "restores": ("spill", "restores"),
    "restore_p50_ms": ("spill", "restore_p50_ms"),
    "fused_fallbacks": ("pipeline", "fused_fallbacks"),
    "chunked_pulls": ("data_plane", "chunked_pulls"),
    "same_host_map_hits": ("data_plane", "same_host_map_hits"),
    "prefill_tokens": ("engine", "prefill_tokens"),
    "decode_tokens": ("engine", "decode_tokens"),
    "running": (None, "running"),
    "depth": (None, "depth"),
}

# The watchdog's typed verdicts (the flight-recorder kind of a verdict
# is ``health.<rule>``).
HEALTH_RULES = (
    "overload", "breaker_storm", "spill_thrash",
    "stale_shard", "wedged_node", "fused_fallback_spike",
)


# -- shared windowed-latency helpers ----------------------------------
def counter_delta(cur: float, prev: float) -> float:
    """``max(0, cur - prev)``: a restarted daemon resets its cumulative
    counters mid-series; the clamp rebaselines instead of emitting a
    negative rate."""
    delta = float(cur) - float(prev)
    return delta if delta > 0.0 else 0.0


def snapshot_delta(cur: dict, prev: dict | None) -> dict:
    """Bucket-subtraction window over two cumulative histogram
    snapshots (perf_plane shape: counts/sum/count): the per-window
    histogram is the elementwise difference, clamped at zero so a
    counter reset cannot produce a negative bucket. ``prev=None``
    returns ``cur`` itself (the first window since boot)."""
    counts = [int(c) for c in (cur.get("counts") or [])]
    if not prev:
        return {"counts": counts, "sum": float(cur.get("sum", 0.0)),
                "count": int(cur.get("count", 0))}
    prev_counts = list(prev.get("counts") or [])
    n = max(len(counts), len(prev_counts))
    delta_counts = [
        max(0, (int(counts[i]) if i < len(counts) else 0)
            - (int(prev_counts[i]) if i < len(prev_counts) else 0))
        for i in range(n)]
    count = max(0, int(cur.get("count", 0)) - int(prev.get("count", 0)))
    delta_sum = float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0))
    if count == 0 or delta_sum < 0.0:
        delta_sum = 0.0
    return {"counts": delta_counts, "sum": delta_sum, "count": count}


def summarize(snap: dict) -> dict:
    """count / mean / p50 / p99 of one histogram snapshot — the shape
    the serve autoscaler feed and the history queries both serve."""
    count = int(snap.get("count", 0))
    return {
        "count": count,
        "mean_s": (float(snap.get("sum", 0.0)) / count) if count
        else 0.0,
        "p50_s": perf_plane.quantile(snap, 0.5),
        "p99_s": perf_plane.quantile(snap, 0.99),
    }


def merge_window(samples: list, stage: str) -> dict:
    """Merge one stage's per-interval histogram deltas back into one
    window snapshot (exact bucket addition — deltas are mergeable the
    same way cumulative snapshots are)."""
    # Seeded empty: merge_snapshots initializes the bucket vector on
    # first fold (a pre-seeded [] would pin the length at zero).
    merged: dict = {}
    for sample in samples:
        snap = (sample.get("stage_hist") or {}).get(stage)
        if isinstance(snap, dict):
            perf_plane.merge_snapshots(merged, snap)
    return merged


def _encode_sample(stats: dict, prev: dict) -> dict:
    """Delta-encode one node's cumulative heartbeat stats row into one
    per-interval sample (exactly the HISTORY_STAT_KEYS row). ``prev``
    is the node's last-seen cumulative value per counter key, updated
    in place; a key's first sighting contributes a zero delta (the
    cumulative-since-boot total is not an interval rate)."""
    sample = {key: 0.0 for key in HISTORY_STAT_KEYS}
    for key in HISTORY_STAT_KEYS:
        group, field = _STAT_SOURCES[key]
        row = stats if group is None else (stats.get(group) or {})
        if not isinstance(row, dict):
            row = {}
        try:
            value = float(row.get(field, 0.0) or 0.0)
        except (TypeError, ValueError):
            value = 0.0
        if key in GAUGE_KEYS:
            sample[key] = value
        else:
            sample[key] = counter_delta(value, prev.get(key, value))
            prev[key] = value
    return sample


def rate_over_window(samples: list, key: str,
                     interval_s: float) -> float:
    """Per-second rate of one delta-encoded counter over a sample
    window (covered time = samples x interval, so a short history
    right after boot is not diluted by the empty remainder)."""
    if not samples:
        return 0.0
    total = sum(float(s.get(key, 0.0) or 0.0) for s in samples)
    return total / max(len(samples) * max(interval_s, 1e-9), 1e-9)


class _NodeSeries:
    """One node's bounded sample ring + its delta-encoder state."""

    __slots__ = ("samples", "prev", "prev_hist", "last_seen")

    def __init__(self, capacity: int):
        self.samples: deque = deque(maxlen=capacity)
        self.prev: dict = {}
        self.prev_hist: dict = {}
        self.last_seen = 0.0


class _Domain:
    """One shard domain of the store: its own lock and node series table
    (the head's NodeStatsShard split, so a wedged domain marks exactly
    the nodes whose control-plane shard wedged)."""

    __slots__ = ("index", "lock", "series")

    def __init__(self, index: int):
        self.index = index
        self.lock = threading.Lock()
        self.series: dict[str, _NodeSeries] = {}


class HistoryStore:
    """Fixed-interval ring-buffer time-series store over the GCS
    node-stats table. The head's monitor tick drives ``sample()``;
    ``query()`` merges across shard domains and stale-marks the ones
    whose control-plane shard is stalled."""

    def __init__(self, interval_s: float, retention_s: float,
                 domains: int = 1, clock=time.monotonic,
                 wall=time.time):
        self.interval_s = max(0.1, float(interval_s))
        self.retention_s = max(self.interval_s, float(retention_s))
        self.capacity = max(2, int(self.retention_s / self.interval_s))
        self._clock = clock
        self._wall = wall
        self._domains = [_Domain(i) for i in range(max(1, int(domains)))]
        self._last_sample = 0.0
        self._stalled: tuple = ()
        self.samples_taken = 0

    @classmethod
    def from_config(cls, domains: int = 1) -> "HistoryStore":
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return cls(
            float(GLOBAL_CONFIG.metrics_history_interval_s),
            float(GLOBAL_CONFIG.metrics_history_retention_s),
            domains=domains)

    def domain_of(self, node_hex: str) -> int:
        return gcs_shard.shard_of(node_hex, len(self._domains))

    def due(self, now: float | None = None) -> bool:
        now = self._clock() if now is None else now
        return now - self._last_sample >= self.interval_s

    def sample(self, node_stats: dict,
               shard_rows: list | None = None) -> int:
        """Record one interval: delta-encode every node's cumulative
        row into its domain's ring. Domains whose GCS shard is
        currently stalled (a nonzero age_s on its shard_stats row)
        record stale-marked samples. Returns nodes sampled."""
        now = self._clock()
        ts = self._wall()
        stalled = tuple(sorted(
            int(row.get("shard", 0)) for row in (shard_rows or [])
            if float(row.get("age_s", 0.0) or 0.0) > 0.0))
        self._stalled = stalled
        self._last_sample = now
        self.samples_taken += 1
        recorded = 0
        n_domains = len(self._domains)
        for node_hex, stats in (node_stats or {}).items():
            if not isinstance(stats, dict):
                continue
            domain = self._domains[
                gcs_shard.shard_of(node_hex, n_domains)]
            stale = domain.index in stalled
            with domain.lock:
                series = domain.series.get(node_hex)
                if series is None:
                    series = _NodeSeries(self.capacity)
                    domain.series[node_hex] = series
                sample = _encode_sample(stats, series.prev)
                sample["ts"] = ts
                sample["age_s"] = float(stats.get("age_s", 0.0) or 0.0)
                sample["stale"] = stale
                hists = stats.get("stage_hist")
                if isinstance(hists, dict):
                    deltas = {}
                    for stage, snap in hists.items():
                        if not isinstance(snap, dict):
                            continue
                        delta = snapshot_delta(
                            snap, series.prev_hist.get(stage))
                        series.prev_hist[stage] = {
                            "counts": list(snap.get("counts") or []),
                            "sum": float(snap.get("sum", 0.0)),
                            "count": int(snap.get("count", 0))}
                        if delta["count"]:
                            deltas[stage] = delta
                    if deltas:
                        sample["stage_hist"] = deltas
                series.samples.append(sample)
                series.last_seen = now
                recorded += 1
        self._prune(now)
        return recorded

    def _prune(self, now: float) -> None:
        """Drop series for nodes gone longer than the retention window
        (dead/churned nodes must not pin their rings forever)."""
        for domain in self._domains:
            with domain.lock:
                for node_hex in list(domain.series):
                    series = domain.series[node_hex]
                    if now - series.last_seen > self.retention_s:
                        del domain.series[node_hex]

    def degraded(self) -> list:
        """Shard domains currently serving stale-marked samples."""
        return list(self._stalled)

    def query(self, window_s: float | None = None,
              node: str | None = None) -> dict:
        """Windowed cross-domain merge: per node, the samples inside
        the window plus per-key rate-over-window for every counter in
        the registry. ``node`` filters by hex prefix. Samples out of a
        stalled domain carry ``stale``; the stalled domains themselves
        ride ``degraded``."""
        ts = self._wall()
        window = float(window_s) if window_s else self.retention_s
        nodes: dict = {}
        for domain in self._domains:
            with domain.lock:
                for node_hex, series in domain.series.items():
                    if node and not node_hex.startswith(node):
                        continue
                    samples = [dict(s) for s in series.samples
                               if ts - float(s.get("ts", 0.0))
                               <= window + self.interval_s / 2.0]
                    if not samples:
                        continue
                    rates = {
                        key: round(rate_over_window(
                            samples, key, self.interval_s), 6)
                        for key in _COUNTER_KEYS}
                    nodes[node_hex] = {
                        "samples": samples,
                        "rates": rates,
                        "stale": any(s.get("stale") for s in samples),
                        "domain": domain.index,
                    }
        return {"armed": True, "interval_s": self.interval_s,
                "retention_s": self.retention_s, "window_s": window,
                "ts": ts, "degraded": self.degraded(), "nodes": nodes}


# -- health watchdog --------------------------------------------------
def _thresholds_from_config() -> dict:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return {
        "window_s": float(GLOBAL_CONFIG.health_window_s),
        "overload_shed_per_s": float(
            GLOBAL_CONFIG.health_overload_shed_per_s),
        "breaker_storm_opens": float(
            GLOBAL_CONFIG.health_breaker_storm_opens),
        "spill_churn_per_s": float(
            GLOBAL_CONFIG.health_spill_churn_per_s),
        "spill_restore_p50_ms": float(
            GLOBAL_CONFIG.health_spill_restore_p50_ms),
        "wedged_age_s": float(GLOBAL_CONFIG.health_wedged_age_s),
        "stale_shard_age_s": float(
            GLOBAL_CONFIG.health_stale_shard_age_s),
        "fused_fallback_per_s": float(
            GLOBAL_CONFIG.health_fused_fallback_per_s),
    }


def _verdict(rule: str, node: str, value: float, threshold: float,
             window_s: float, ts: float, detail: str,
             evidence: dict) -> dict:
    return {"rule": rule, "node": node, "value": round(value, 4),
            "threshold": threshold, "window_s": window_s, "ts": ts,
            "detail": detail, "evidence": evidence}


def _node_windows(hist: dict):
    for node_hex, row in sorted((hist.get("nodes") or {}).items()):
        yield node_hex, row, row.get("samples") or []


def _rule_overload(thresholds: dict, hist: dict, node_stats: dict,
                   shard_rows: list, ts: float) -> list:
    """Sustained admission sheds: the shed rate over the window is
    past bound AND at least two intervals shed (one burst is
    backpressure; sustained shedding is an overloaded node)."""
    thr = thresholds["overload_shed_per_s"]
    window = thresholds["window_s"]
    out = []
    for node_hex, row, samples in _node_windows(hist):
        sheds = [float(s.get("admission_shed", 0.0)) for s in samples]
        rate = row["rates"].get("admission_shed", 0.0)
        nonzero = sum(1 for shed in sheds if shed > 0.0)
        if nonzero >= 2 and rate >= thr:
            out.append(_verdict(
                "overload", node_hex, rate, thr, window, ts,
                f"admission shedding {rate:.2f}/s sustained over "
                f"{nonzero} intervals",
                {"admission_shed": sheds[-10:],
                 "intervals_shedding": nonzero}))
    return out


def _rule_breaker_storm(thresholds: dict, hist: dict, node_stats: dict,
                        shard_rows: list, ts: float) -> list:
    """Circuit-breaker opens piling up inside one window: a sick
    destination is eating whole retry budgets cluster-wide."""
    thr = thresholds["breaker_storm_opens"]
    window = thresholds["window_s"]
    out = []
    for node_hex, row, samples in _node_windows(hist):
        opens = [float(s.get("breaker_open", 0.0)) for s in samples]
        total = sum(opens)
        if total >= thr:
            out.append(_verdict(
                "breaker_storm", node_hex, total, thr, window, ts,
                f"{total:.0f} breaker opens in {window:.0f}s",
                {"breaker_open": opens[-10:]}))
    return out


def _rule_spill_thrash(thresholds: dict, hist: dict, node_stats: dict,
                       shard_rows: list, ts: float) -> list:
    """Spill/restore churn past bound while restores are slow: the
    working set is cycling through disk instead of fitting memory."""
    thr = thresholds["spill_churn_per_s"]
    p50_thr = thresholds["spill_restore_p50_ms"]
    window = thresholds["window_s"]
    out = []
    for node_hex, row, samples in _node_windows(hist):
        churn = row["rates"].get("spills", 0.0) \
            + row["rates"].get("restores", 0.0)
        p50_ms = float(samples[-1].get("restore_p50_ms", 0.0)) \
            if samples else 0.0
        if churn >= thr and p50_ms >= p50_thr:
            out.append(_verdict(
                "spill_thrash", node_hex, churn, thr, window, ts,
                f"spill/restore churn {churn:.2f}/s with restore "
                f"p50 {p50_ms:.1f}ms",
                {"spills_per_s": row["rates"].get("spills", 0.0),
                 "restores_per_s": row["rates"].get("restores", 0.0),
                 "restore_p50_ms": p50_ms}))
    return out


def _rule_stale_shard(thresholds: dict, hist: dict, node_stats: dict,
                      shard_rows: list, ts: float) -> list:
    """A GCS shard domain stalled past bound: its reads serve a stale
    view, its writes queue — history for its nodes is degraded."""
    thr = thresholds["stale_shard_age_s"]
    window = thresholds["window_s"]
    out = []
    for row in shard_rows or []:
        age = float(row.get("age_s", 0.0) or 0.0)
        if age >= thr:
            index = int(row.get("shard", 0))
            out.append(_verdict(
                "stale_shard", f"shard:{index}", age, thr, window, ts,
                f"gcs shard {index} stalled {age:.1f}s "
                f"(queued_writes={row.get('queued_writes', 0)})",
                {"shard": index, "age_s": age,
                 "queued_writes": row.get("queued_writes", 0),
                 "shed_writes": row.get("shed_writes", 0)}))
    return out


def _rule_wedged_node(thresholds: dict, hist: dict, node_stats: dict,
                      shard_rows: list, ts: float) -> list:
    """A node's stats receipt age past bound: the daemon stopped
    heartbeating (wedged or partitioned) but is not yet declared
    dead — its load view and history are both suspect."""
    thr = thresholds["wedged_age_s"]
    window = thresholds["window_s"]
    out = []
    for node_hex, stats in sorted((node_stats or {}).items()):
        if not isinstance(stats, dict):
            continue
        age = float(stats.get("age_s", 0.0) or 0.0)
        if age >= thr:
            out.append(_verdict(
                "wedged_node", node_hex, age, thr, window, ts,
                f"no stats heartbeat for {age:.1f}s",
                {"age_s": age,
                 "running": stats.get("running", 0)}))
    return out


def _rule_fused_fallback_spike(thresholds: dict, hist: dict,
                               node_stats: dict, shard_rows: list,
                               ts: float) -> list:
    """Fused-eligible entries spilling to the worker pipeline at rate:
    the per-run wall budget is blowing — fused runs carry tasks too
    long for the dispatch thread."""
    thr = thresholds["fused_fallback_per_s"]
    window = thresholds["window_s"]
    out = []
    for node_hex, row, samples in _node_windows(hist):
        rate = row["rates"].get("fused_fallbacks", 0.0)
        if rate >= thr:
            out.append(_verdict(
                "fused_fallback_spike", node_hex, rate, thr, window,
                ts, f"fused fallbacks {rate:.2f}/s",
                {"fused_fallbacks": [
                    float(s.get("fused_fallbacks", 0.0))
                    for s in samples[-10:]]}))
    return out


_RULES = {
    "overload": _rule_overload,
    "breaker_storm": _rule_breaker_storm,
    "spill_thrash": _rule_spill_thrash,
    "stale_shard": _rule_stale_shard,
    "wedged_node": _rule_wedged_node,
    "fused_fallback_spike": _rule_fused_fallback_spike,
}
assert tuple(_RULES) == HEALTH_RULES


class HealthWatchdog:
    """Rule-driven SLO sweep over the history store. ``sweep()`` runs
    on the head's monitor tick right after ``HistoryStore.sample()``;
    a (rule, node) pair BECOMING active is flight-recorded
    (``health.<rule>``) and counted, active verdicts clear themselves
    when their condition stops holding."""

    def __init__(self, store: HistoryStore,
                 thresholds: dict | None = None):
        self.store = store
        self.thresholds = dict(thresholds or _thresholds_from_config())
        self._lock = threading.Lock()
        self._active: dict[tuple, dict] = {}
        self._fired: deque = deque(maxlen=256)
        self._fired_total: dict[str, int] = {}

    def sweep(self, node_stats: dict,
              shard_rows: list | None = None) -> list:
        """One rule pass; returns the verdicts that became active."""
        from ray_tpu_torch._private import flight_recorder

        ts = self.store._wall()
        hist = self.store.query(window_s=self.thresholds["window_s"])
        found: dict[tuple, dict] = {}
        for rule in HEALTH_RULES:
            for verdict in _RULES[rule](self.thresholds, hist,
                                        node_stats or {},
                                        shard_rows or [], ts):
                found[(verdict["rule"], verdict["node"])] = verdict
        with self._lock:
            new = [verdict for key, verdict in found.items()
                   if key not in self._active]
            self._active = found
            for verdict in new:
                self._fired.append(dict(verdict))
                self._fired_total[verdict["rule"]] = \
                    self._fired_total.get(verdict["rule"], 0) + 1
        for verdict in new:
            flight_recorder.record("health." + verdict["rule"],
                                   verdict["node"], verdict["value"])
        return new

    def report(self) -> dict:
        """The ``cluster_health`` RPC body: active verdicts, the
        recent fired ring, per-rule totals, the rule registry."""
        with self._lock:
            return {
                "armed": True,
                "verdicts": [dict(v) for v in self._active.values()],
                "fired": [dict(v) for v in self._fired],
                "fired_total": dict(self._fired_total),
                "rules": list(HEALTH_RULES),
                "window_s": self.thresholds["window_s"],
                "degraded": self.store.degraded(),
                "ts": self.store._wall(),
            }


def disarmed_history() -> dict:
    """The ``metrics_history`` RPC body on a disarmed head."""
    return {"armed": False, "interval_s": 0.0, "retention_s": 0.0,
            "window_s": 0.0, "ts": time.time(), "degraded": [],
            "nodes": {}}


def disarmed_health() -> dict:
    """The ``cluster_health`` RPC body on a disarmed head."""
    return {"armed": False, "verdicts": [], "fired": [],
            "fired_total": {}, "rules": list(HEALTH_RULES),
            "window_s": 0.0, "degraded": [], "ts": time.time()}
