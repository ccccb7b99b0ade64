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
    # End-to-end deadline every task and actor call inherits when it
    # sets none; 0 disables.
    "task_default_deadline_s": 0.0,
    # Admission control: with more tasks than this queued or running in
    # the dispatcher, a deadline-armed submit raises the retryable
    # SystemOverloadedError instead of queueing; deadline-free submits
    # queue. 0 = unlimited.
    "admission_max_queue_depth": 0,
    # Worker processes (``init(process_workers=N)`` overrides the pool
    # size; 0: tasks run on threads of this process).
    "worker_pool_size": 0,
    # Growth cap of the pool for nested submission (0: 4 x size + 8).
    "worker_pool_max_size": 0,
    "worker_startup_timeout_s": 30.0,
    # Pool results up to this size come back through the pipe; larger
    # ones in a shared-memory segment of their own.
    "worker_inline_result_kb": 64,
    # Small immutable values cross the pipe in the raw tag encoding
    # instead of a pickle.
    "raw_framing": True,
    # Worker processes' output goes to per-session files, tailed back to
    # this process's stdout.
    "log_to_driver": True,
    # Serve routers push their latency window (p50/p99) to the
    # controller at most this often: the latency autoscaler's feed.
    # 0 disables the push.
    "serve_latency_report_s": 1.0,
}


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
