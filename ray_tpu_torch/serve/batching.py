"""Dynamic request batching: ``@serve.batch``.

A copy of ``ray_tpu/serve/batching.py``. Calls to the wrapped method are
queued; a batcher drains up to ``max_batch_size`` items (waiting at most
``batch_wait_timeout_s`` for the batch to fill), calls the function once
with the list of inputs, and hands each caller its output. The wrapped
function sees a batch, so it can run one forward pass on the card for
many small requests.
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading
import time
import weakref
from typing import Any, Callable


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._max_batch_size = max_batch_size
        self._wait_s = batch_wait_timeout_s
        self._lock = threading.Condition()
        self._queue: list[tuple[Any, concurrent.futures.Future]] = []
        self._thread: threading.Thread | None = None
        self._stopped = False

    def submit(self, instance, item: Any) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._stopped:
                raise RuntimeError(
                    "@serve.batch batcher is shut down (deployment "
                    "stopping)")
            self._queue.append((item, fut))
            # The loop only exits under this lock with an empty queue
            # (clearing self._thread), so a live self._thread is
            # guaranteed to see this item — no lost-wakeup race.
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, args=(instance,),
                    name="serve-batcher", daemon=True)
                self._thread.start()
            self._lock.notify_all()
        return fut

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Deployment shutdown: stop the batcher thread and FAIL every
        still-queued caller (a future that would otherwise wait on a
        thread that will never drain it). Idempotent."""
        with self._lock:
            self._stopped = True
            pending, self._queue = self._queue, []
            thread = self._thread
            self._lock.notify_all()
        for _, fut in pending:
            if not fut.done():
                fut.set_exception(RuntimeError(
                    "@serve.batch batcher shut down before this "
                    "request was batched"))
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=timeout_s)

    def _take_batch(self) -> list[tuple[Any, concurrent.futures.Future]]:
        deadline = time.monotonic() + self._wait_s
        with self._lock:
            while True:
                if self._stopped:
                    return []
                if len(self._queue) >= self._max_batch_size:
                    batch = self._queue[:self._max_batch_size]
                    del self._queue[:self._max_batch_size]
                    return batch
                remaining = deadline - time.monotonic()
                if remaining <= 0 or (self._queue and not self._wait_s):
                    batch, self._queue = self._queue, []
                    return batch
                self._lock.wait(min(remaining, 0.05))

    def _loop(self, instance) -> None:
        try:
            self._loop_impl(instance)
        finally:
            # The loop NEVER exits with waiting callers attached —
            # whatever killed it (shutdown, or an exotic BaseException
            # escaping the per-batch handler), queued futures fail
            # loudly instead of hanging their callers forever.
            with self._lock:
                pending, self._queue = self._queue, []
                if self._thread is threading.current_thread():
                    self._thread = None
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(RuntimeError(
                        "@serve.batch batcher thread exited with this "
                        "request still queued"))

    def _loop_impl(self, instance) -> None:
        idle_since = time.monotonic()
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stopped:
                    return
                if time.monotonic() - idle_since > 5.0:
                    with self._lock:
                        if self._queue:
                            continue  # raced with a submit: keep going
                        self._thread = None  # next submit starts a new loop
                        return
                continue
            idle_since = time.monotonic()
            items = [item for item, _ in batch]
            try:
                if instance is not None:
                    results = self._fn(instance, items)
                else:
                    results = self._fn(items)
                if not isinstance(results, (list, tuple)) or \
                        len(results) != len(items):
                    raise TypeError(
                        f"@serve.batch function must return a list of "
                        f"{len(items)} results, got {type(results)}")
                for (_, fut), result in zip(batch, results):
                    fut.set_result(result)
            except BaseException as exc:  # noqa: BLE001 — fan the error out
                # EVERY waiting caller of this batch gets the error —
                # a KeyboardInterrupt/SystemExit-shaped failure must
                # not strand half the batch on futures nobody will
                # ever complete.
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            exc if isinstance(exc, Exception)
                            else RuntimeError(
                                f"@serve.batch function died with "
                                f"{type(exc).__name__}: {exc}"))
                if not isinstance(exc, Exception):
                    raise  # fatal: let _loop's finally fail the queue


def batch(_fn: Callable | None = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped fn receives a LIST of requests and must
    return a list of responses of the same length. Callers still call it
    with a single request and get a single response.
    """

    def decorator(fn: Callable):
        # One batcher per bound instance (replicas must not share queues
        # or execute against each other's self); plain functions share
        # the module-level batcher. Weak keys: a dead replica's batcher
        # is collected with it — no leak, and no id()-reuse handing a
        # new instance a stale batcher bound to the old self.
        free_batcher = _Batcher(fn, max_batch_size, batch_wait_timeout_s)
        per_instance: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())
        id_fallback: dict[int, _Batcher] = {}  # non-weakrefable classes
        creation_lock = threading.Lock()

        def batcher_for(instance):
            if instance is None:
                return free_batcher
            with creation_lock:
                try:
                    b = per_instance.get(instance)
                    if b is None:
                        b = _Batcher(fn, max_batch_size,
                                     batch_wait_timeout_s)
                        per_instance[instance] = b
                    return b
                except TypeError:  # no __weakref__ slot
                    b = id_fallback.get(id(instance))
                    if b is None:
                        b = _Batcher(fn, max_batch_size,
                                     batch_wait_timeout_s)
                        id_fallback[id(instance)] = b
                    return b

        def existing_batcher(instance) -> "_Batcher | None":
            """The batcher already bound to ``instance`` (None when it
            never submitted) — deployment shutdown looks its batchers
            up WITHOUT creating new ones."""
            if instance is None:
                return free_batcher
            with creation_lock:
                try:
                    return per_instance.get(instance)
                except TypeError:  # no __weakref__ slot
                    return id_fallback.get(id(instance))

        @functools.wraps(fn)
        def wrapper(*args):
            if len(args) == 2:  # bound method: (self, item)
                instance, item = args
            elif len(args) == 1:
                instance, item = None, args[0]
            else:
                raise TypeError("@serve.batch functions take one request arg")
            return batcher_for(instance).submit(instance, item).result()

        wrapper._serve_batcher = free_batcher
        wrapper._serve_batcher_for = existing_batcher
        return wrapper

    if _fn is not None:
        return decorator(_fn)
    return decorator


def shutdown_batchers(instance) -> int:
    """Stop every batcher thread bound to ``instance``'s @serve.batch
    methods (the replica calls this from prepare_for_shutdown): each
    thread exits and still-queued callers fail typed instead of
    hanging on a future nobody will drain. Returns the number of
    batchers stopped."""
    if instance is None:
        return 0
    stopped = 0
    for name in dir(type(instance)):
        try:
            attr = getattr(type(instance), name)
        except AttributeError:
            continue
        lookup = getattr(attr, "_serve_batcher_for", None)
        if lookup is None:
            continue
        batcher = lookup(instance)
        if batcher is not None:
            batcher.shutdown()
            stopped += 1
    return stopped
