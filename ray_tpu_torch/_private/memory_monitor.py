"""The memory monitor: host memory pressure, and the kill of the largest
pool worker before the OS's OOM killer takes the whole process tree.

The port of ``ray_tpu/_private/memory_monitor.py``. Above the threshold
the monitor kills the pool worker with the largest RSS; its task fails
with ``WorkerCrashedError`` and is retried on the ``task_oom_retries``
budget. Admission reads the same pressure on two axes
(``memory_pressure_kind``): host memory the spill tier can relieve
("store") and memory it cannot ("host").
"""

from __future__ import annotations

import logging
import resource
import threading
import time

logger = logging.getLogger("ray_tpu_torch")


def host_memory_usage_fraction() -> float:
    """used / total from /proc/meminfo (MemAvailable-based); 0.0 when it
    cannot be read."""
    try:
        info: dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = int(rest.strip().split()[0])  # kB
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", 0)
        if total <= 0:
            return 0.0
        return 1.0 - avail / total
    except OSError:
        return 0.0


# Admission asks "is host memory over the watermark?" for every
# deadline-armed submit: the fraction is read at most once per
# _WATERMARK_TTL_S. Tests pin it with _set_usage_override.
_WATERMARK_TTL_S = 0.2
_watermark_lock = threading.Lock()
_watermark_sample = (0.0, -1e9)  # (fraction, time.monotonic() read)
_usage_override: float | None = None
# The store axis: a provider gives the resident spillable store bytes
# (pressure the spill tier can relieve). Tests pin the resulting
# fraction with _set_store_fraction_override.
_store_bytes_provider = None
_store_fraction_override: float | None = None
_host_total_kb = 0


def _set_usage_override(fraction: "float | None") -> None:
    """Test seam: pin the host-memory fraction (None: read /proc again)
    and drop the memo."""
    global _usage_override, _watermark_sample
    with _watermark_lock:
        _usage_override = fraction
        _watermark_sample = (0.0, -1e9)


def set_store_bytes_provider(fn) -> None:
    """Register ``fn() -> resident spillable store bytes`` (the runtime
    installs its store's host bytes; None removes it)."""
    global _store_bytes_provider
    _store_bytes_provider = fn


def _set_store_fraction_override(fraction: "float | None") -> None:
    """Test seam for the store axis: pin the store's share of host
    memory (None: ask the provider again)."""
    global _store_fraction_override
    _store_fraction_override = fraction


def _store_fraction() -> float:
    """Resident spillable store bytes as a fraction of host memory."""
    if _store_fraction_override is not None:
        return _store_fraction_override
    provider = _store_bytes_provider
    if provider is None:
        return 0.0
    global _host_total_kb
    if _host_total_kb <= 0:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal"):
                        _host_total_kb = int(line.split()[1])
                        break
        except OSError:
            return 0.0
    if _host_total_kb <= 0:
        return 0.0
    try:
        return float(provider()) / (_host_total_kb * 1024.0)
    except Exception:  # noqa: BLE001 — classification never raises
        return 0.0


def memory_watermark_exceeded(watermark: float) -> bool:
    """Whether host memory use is at or above ``watermark`` (a fraction;
    <= 0 disables), memoized for _WATERMARK_TTL_S."""
    if watermark <= 0.0:
        return False
    global _watermark_sample
    now = time.monotonic()
    with _watermark_lock:
        frac, at = _watermark_sample
        if now - at <= _WATERMARK_TTL_S:
            return frac >= watermark
        frac = (_usage_override if _usage_override is not None
                else host_memory_usage_fraction())
        _watermark_sample = (frac, now)
        return frac >= watermark


def memory_pressure_kind(watermark: float) -> "str | None":
    """Admission's memory pressure on two axes: None under the watermark;
    "store" over it where spilling the store's resident bytes would bring
    the host back under (spill, admit); "host" where it would not
    (shed)."""
    if watermark <= 0.0 or not memory_watermark_exceeded(watermark):
        return None
    with _watermark_lock:
        host_frac = _watermark_sample[0]
    if host_frac - _store_fraction() < watermark:
        return "store"
    return "host"


def process_rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * resource.getpagesize()
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    """Polls host memory; above the threshold, kills the pool worker with
    the largest RSS (its task fails as a system failure and is retried,
    the reference's OOM policy)."""

    def __init__(self, runtime, threshold: float = 0.95,
                 period_s: float = 1.0):
        self.runtime = runtime
        self.threshold = threshold
        self.period_s = period_s
        self.num_kills = 0
        # Pids this monitor killed: their WorkerCrashedErrors are OOM
        # kills, retried on their own budget. Bounded, and consumed at
        # the last retry, so a recycled pid cannot be taken for one.
        self.killed_pids: set[int] = set()
        self._kill_order: list[int] = []
        self._shutdown = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="ray_tpu_torch-memory-monitor")

    def start(self) -> "MemoryMonitor":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._shutdown.wait(self.period_s):
            self.check_once()

    def consume_attribution(self, pid: int) -> None:
        """Forget a kill after its task's last retry."""
        self.killed_pids.discard(pid)
        try:
            self._kill_order.remove(pid)
        except ValueError:
            pass

    def check_once(self) -> int | None:
        """One pressure check; the killed pid, or None."""
        usage = host_memory_usage_fraction()
        if usage <= self.threshold:
            return None
        pool = getattr(self.runtime, "worker_pool", None)
        if pool is None:
            logger.warning(
                "memory pressure: host at %.0f%% (threshold %.0f%%) — "
                "no worker pool to reclaim from", usage * 100,
                self.threshold * 100)
            return None
        victim = self._largest_worker(pool)
        if victim is None:
            return None
        pid = victim.proc.pid
        logger.warning(
            "memory pressure: host at %.0f%% — killing pool worker "
            "pid=%s rss=%.0fMB (its task fails with a retryable system "
            "error)", usage * 100, pid, process_rss_bytes(pid) / 1e6)
        self.killed_pids.add(pid)
        self._kill_order.append(pid)
        while len(self._kill_order) > 64:
            self.killed_pids.discard(self._kill_order.pop(0))
        try:
            victim.proc.kill()
        except OSError:
            return None
        self.num_kills += 1
        return pid

    @staticmethod
    def _largest_worker(pool):
        # Idle and busy workers alike: a busy one's task fails with a
        # retryable error, which beats the OS killing the process tree.
        alive = pool.live_workers()
        if not alive:
            return None
        return max(alive, key=lambda w: process_rss_bytes(w.proc.pid))

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread.is_alive() \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
