"""Loading the JAX package's native library for the port's mirrors.

``ray_tpu._native.load()`` builds ``libray_tpu_native.so`` in place with
``g++ -o`` the first time any process needs it, and a process that
opens the file while another is still writing it caches the failure
(``_lib = False``) for its whole life, so its reference side loses the
native engines. ``load_reference_native`` takes a lock across processes,
and when a load fails it waits for the file to stop changing (the
writer to finish), clears the cached failure and loads again, up to a
deadline. The mirrors assert the result, as before.
"""

from __future__ import annotations

import fcntl
import importlib
import os
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK_PATH = os.path.join(_REPO, "build", "ray_tpu_native.lock")
DEADLINE_S = 180.0
_SETTLE_S = 0.5


def _file_state(path: str):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_size, st.st_mtime_ns


def _wait_for_writer(path: str, deadline: float) -> None:
    """Until the file has stayed the same for ``_SETTLE_S`` (or is gone
    for good, which the next load rebuilds)."""
    last = _file_state(path)
    stable_since = time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.1)
        state = _file_state(path)
        if state != last:
            last, stable_since = state, time.monotonic()
        elif time.monotonic() - stable_since >= _SETTLE_S:
            return


def load_reference_native(native=None, deadline_s: float = DEADLINE_S):
    """The JAX package's native library (``None`` past the deadline);
    ``native`` is its loader module (``ray_tpu._native`` by default)."""
    native = native or importlib.import_module("ray_tpu._native")
    os.makedirs(os.path.dirname(LOCK_PATH), exist_ok=True)
    deadline = time.monotonic() + deadline_s
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                lib = native.load()
                if lib is not None or time.monotonic() >= deadline:
                    return lib
                _wait_for_writer(native._LIB, deadline)
                with native._lock:
                    native._lib = None  # the cached failure
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
