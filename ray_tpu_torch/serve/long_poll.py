"""Versioned long-poll pub/sub from the controller to the routers.

The port of ``ray_tpu/serve/long_poll.py``: the ``LongPollHost`` inside
the controller holds ``key -> (version, value)``; a ``LongPollClient``
blocks on ``listen_for_change({key: last_seen_version})`` and gets back
only the keys whose version advanced, so a router learns of a scale-up
or a dead replica in one round trip. ``close()`` releases every listener
at once (the controller's shutdown must not wait out their timeouts).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable

import ray_tpu_torch

logger = logging.getLogger("ray_tpu_torch")

LISTEN_TIMEOUT_S = 5.0


class LongPollHost:
    """Hosted inside the controller actor."""

    def __init__(self):
        self._lock = threading.Condition()
        self._store: dict[str, tuple[int, Any]] = {}
        self._closed = False

    def notify_changed(self, key: str, value: Any) -> None:
        with self._lock:
            version = self._store.get(key, (0, None))[0] + 1
            self._store[key] = (version, value)
            self._lock.notify_all()

    def listen_for_change(
            self, keys_to_versions: dict[str, int],
            timeout_s: float = LISTEN_TIMEOUT_S) -> dict[str, tuple[int, Any]]:
        """Block until any key advances past the caller's version; the
        advanced ``{key: (version, value)}`` subset ({} on timeout or
        once closed)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while not self._closed:
                updates = {
                    key: self._store[key]
                    for key, seen in keys_to_versions.items()
                    if key in self._store and self._store[key][0] > seen
                }
                if updates:
                    return updates
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._lock.wait(remaining)
            return {}

    def snapshot(self, key: str) -> tuple[int, Any]:
        with self._lock:
            return self._store.get(key, (0, None))

    def close(self) -> None:
        """Release every listener and drop the values."""
        with self._lock:
            self._closed = True
            self._store.clear()
            self._lock.notify_all()


class LongPollClient:
    """A thread that long-polls the controller actor and calls
    ``callbacks[key](value)`` on each update."""

    def __init__(self, controller_handle, callbacks: dict[str, Callable]):
        self._controller = controller_handle
        self._callbacks = callbacks
        self._versions = {key: 0 for key in callbacks}
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="serve-long-poll", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                ref = self._controller.listen_for_change.remote(
                    dict(self._versions))
                updates = ray_tpu_torch.get(ref, timeout=LISTEN_TIMEOUT_S * 4)
            except Exception:  # noqa: BLE001 — controller busy or gone; retry
                if self._stopped.is_set():
                    return
                time.sleep(0.1)
                continue
            if self._stopped.is_set():
                return
            for key, (version, value) in (updates or {}).items():
                self._versions[key] = version
                try:
                    self._callbacks[key](value)
                except Exception:  # noqa: BLE001 — the poll must go on
                    logger.exception("long-poll callback for %r failed", key)
