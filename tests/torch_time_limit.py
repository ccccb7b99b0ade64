"""A time limit of its own for a test that spawns processes, so a hung
head or daemon fails that test instead of holding the suite."""

from __future__ import annotations

import contextlib
import signal


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise TimeoutError in the main thread after ``seconds``."""

    def expire(signum, frame):
        raise TimeoutError(f"test passed its own {seconds} s limit")

    prior = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prior)
