"""The flight recorder: a bounded per-process ring of lifecycle, fault
and chaos events, written to the session directory so a post-mortem
survives a SIGKILL.

The port of ``ray_tpu/_private/flight_recorder.py``.

- ``record(kind, *args)`` appends a raw ``(ts, kind, args)`` tuple to a
  bounded ``deque``: no formatting, no I/O and no lock (a deque append
  is atomic under the GIL). Events are formatted only when dumped.
- Daemons install with a flusher thread that rewrites this process's
  ring file every ``flight_recorder_flush_s`` when new events arrived,
  and once at install, so a SIGKILLed daemon's ring is on disk within
  one flush period of its last event. New events are told by the ring's
  newest entry, not its length: the reference's length check misses an
  event recorded during a dump, and every event once the ring is full.
  Drivers and pool workers install without one (their rings are read
  live and dumped on demand).

Ring files are ``$RAY_TPU_TORCH_SESSION_DIR/flight/<role>-<pid>.json``
(the session directory defaults to ``ray_tpu_torch`` under the
temporary directory) and hold the ring plus what the install site's
``extra_fn`` adds; ``collect_session_dumps`` reads every one of them,
dead processes' included. Files older than three days are pruned when a
flusher installs.

Record sites in the port: chaos fires (chaos.py); the RPC breaker
opening (rpc.py); the spill tier's ``spill.*`` (spill_manager.py); the
durable head's ``gcs.restore`` / ``gcs.torn_snapshot`` /
``gcs.persist_error`` / ``gcs.fenced_write`` and, on a sharded head,
``gcs.shard_restore`` / ``gcs.shard_fenced_write`` /
``gcs.shard_backoff`` (gcs_server.py, gcs_shard.py); the re-sync of
daemons and drivers across a head or shard restart, ``epoch.bump`` /
``heartbeat.stale_epoch`` / ``gcs.stale_epoch`` / ``heartbeat.shed``
(node.py, worker.py); node death, object loss, worker crashes and a
daemon's stop; and the health watchdog's ``health.<rule>`` verdicts
(metrics_history.py).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque

SESSION_DIR_ENV = "RAY_TPU_TORCH_SESSION_DIR"


def _session_dir() -> str:
    return os.environ.get(SESSION_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch")


def flight_dir() -> str:
    return os.path.join(_session_dir(), "flight")


class FlightRecorder:
    def __init__(self, role: str, capacity: int = 512,
                 flush_period_s: float = 0.0, extra_fn=None):
        self.role = role
        self.pid = os.getpid()
        self.started_at = time.time()
        self._ring: deque = deque(maxlen=max(8, int(capacity)))
        # () -> dict of process state a dump carries beside the ring.
        self._extra_fn = extra_fn
        # The newest event the last dump held: the flusher writes again
        # when the ring's newest event is another one (its length stops
        # moving once the ring is full).
        self._flushed_tail: object = ()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if flush_period_s and flush_period_s > 0:
            self.arm_flush(float(flush_period_s))

    def arm_flush(self, period_s: float) -> None:
        """Start the flusher thread (once): a process may install early,
        so its boot events land in the ring, and arm the flusher when
        the rest of it is up."""
        if self._thread is not None or period_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._flush_loop, args=(float(period_s),),
            daemon=True, name="ray_tpu_torch-flight-recorder")
        self._thread.start()

    def record(self, kind: str, *args) -> None:
        self._ring.append((time.time(), kind, args))

    def snapshot(self) -> dict:
        """The ring and the process state as plain data (events are
        formatted here, never where they are recorded)."""
        events = [{"ts": ts, "kind": kind, "args": [str(a) for a in args]}
                  for ts, kind, args in list(self._ring)]
        extra = {}
        if self._extra_fn is not None:
            try:
                extra = self._extra_fn() or {}
            except Exception:  # noqa: BLE001 — a dump never raises
                extra = {}
        return {"role": self.role, "pid": self.pid,
                "started_at": self.started_at, "events": events, **extra}

    def path(self) -> str:
        return os.path.join(flight_dir(), f"{self.role}-{self.pid}.json")

    def _tail(self) -> object:
        try:
            return self._ring[-1]
        except IndexError:
            return None

    def dump(self, reason: str) -> str | None:
        """Write the ring file (tmp, then rename); its path, or None
        when the session directory cannot be written."""
        # Taken before the snapshot: an event recorded during the write
        # makes the next flush write again.
        tail = self._tail()
        snap = self.snapshot()
        snap["reason"] = reason
        snap["dumped_at"] = time.time()
        path = self.path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
        except OSError:
            return None
        self._flushed_tail = tail
        return path

    def _flush_loop(self, period_s: float) -> None:
        # A first dump at once: a daemon killed before the first period
        # still leaves its boot events.
        self.dump("periodic")
        while not self._stop.wait(period_s):
            if self._tail() is not self._flushed_tail:
                self.dump("periodic")

    def stop(self) -> None:
        self._stop.set()


_REC: FlightRecorder | None = None


def install(role: str, flush: bool = False,
            extra_fn=None) -> FlightRecorder:
    """Install the process's recorder. Installing again keeps the ring
    (events survive a shutdown and init in one process) and upgrades
    it in place: an ``extra_fn`` where there was none, a flusher where
    there was none."""
    global _REC
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if _REC is not None:
        if extra_fn is not None and _REC._extra_fn is None:
            _REC._extra_fn = extra_fn
        if flush and _REC._thread is None:
            _prune_stale_dumps()
            _REC.arm_flush(float(GLOBAL_CONFIG.flight_recorder_flush_s
                                 or 0.0))
        return _REC
    capacity = int(GLOBAL_CONFIG.flight_recorder_events or 512)
    period = float(GLOBAL_CONFIG.flight_recorder_flush_s or 0.0) \
        if flush else 0.0
    if flush:
        _prune_stale_dumps()
    _REC = FlightRecorder(role, capacity=capacity, flush_period_s=period,
                          extra_fn=extra_fn)
    _REC.record("start", role)
    return _REC


def _prune_stale_dumps(max_age_s: float = 3 * 86400) -> None:
    """Remove ring files older than ``max_age_s``: the session directory
    outlives sessions, and a host cycling daemons must not gather dumps
    for ever. Recent files stay: they are the post-mortems."""
    try:
        names = os.listdir(flight_dir())
    except OSError:
        return
    cutoff = time.time() - max_age_s
    for name in names:
        path = os.path.join(flight_dir(), name)
        try:
            if os.path.getmtime(path) < cutoff:
                os.unlink(path)
        except OSError:
            continue  # another pruner got there first


def get() -> FlightRecorder | None:
    return _REC


def record(kind: str, *args) -> None:
    """One attribute load and a deque append with a recorder installed,
    one branch without."""
    rec = _REC
    if rec is not None:
        rec._ring.append((time.time(), kind, args))


def dump(reason: str) -> str | None:
    rec = _REC
    return rec.dump(reason) if rec is not None else None


def collect_session_dumps() -> list[dict]:
    """Every ring file of the session directory, parsed, with its file
    name under ``file``; a malformed or half-written file is skipped."""
    out: list[dict] = []
    try:
        names = sorted(os.listdir(flight_dir()))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(flight_dir(), name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict):
            doc["file"] = name
            out.append(doc)
    return out
