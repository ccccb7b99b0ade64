"""Actor execution.

The port of ``ray_tpu/_private/actor_runtime.py``. Each actor runs on a
thread of the process that runs the runtime, in one of three modes:

- sequential (``max_concurrency=1``): calls run one at a time, in order;
- a thread pool of ``max_concurrency`` threads, and one pool of its own
  for each concurrency group (``concurrency_groups={"control": 2}``):
  a method marked ``@method(concurrency_group="control")`` runs there,
  so calls of other methods that fill the main pool cannot hold it back;
- an asyncio loop, for a class with ``async def`` methods, running up to
  ``max_concurrency`` calls at once.

The actor holds its resources (its ``GPU``, say) for its lifetime: they
are given back when its last executor thread has ended, so a killed
actor's calls that were already running finish on the card before another
task is admitted there. A call
whose deadline died in the queue seals ``TaskTimeoutError`` (stage
``actor_queue``) instead of running; a running call sees its deadline
through ``get_runtime_context().get_task_deadline()``.
"""

from __future__ import annotations

import asyncio
import inspect
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

from ray_tpu_torch._private import request_context
from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.scheduler import format_traceback
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorError,
    PendingCallsLimitExceeded,
    TaskCancelledError,
    TaskTimeoutError,
)


class _ExitActor(BaseException):
    """Raised by exit_actor() to unwind out of the running method."""


@dataclass
class _ActorCall:
    method_name: str
    args: tuple
    kwargs: dict
    return_ids: list[ObjectID]
    cancelled: bool = False
    # Absolute end-to-end deadline (time.time()), checked before the
    # method runs.
    deadline: "float | None" = None


class LocalActor:
    """A live actor instance bound to its executor thread or loop.

    ``set_context()`` runs on every thread that executes the actor's code
    (the runtime context: actor id, node, assigned resources)."""

    def __init__(
        self,
        actor_id: ActorID,
        cls: type,
        init_args: tuple,
        init_kwargs: dict,
        store,
        *,
        max_concurrency: int = 1,
        max_restarts: int = 0,
        max_pending_calls: int = -1,
        concurrency_groups: dict[str, int] | None = None,
        creation_return_id: ObjectID | None = None,
        on_death: Callable[[ActorID, str], None] | None = None,
        on_release: Callable[[ActorID], None] | None = None,
        set_context: Callable[[], None] | None = None,
    ):
        self.actor_id = actor_id
        self._cls = cls
        self._init_args = init_args
        self._init_kwargs = init_kwargs
        self._store = store
        self._max_concurrency = max(1, max_concurrency)
        self._max_restarts = max_restarts
        self._max_pending_calls = max_pending_calls
        self._concurrency_groups = dict(concurrency_groups or {})
        self._method_groups = method_groups(cls)
        self._on_death = on_death
        self._on_release = on_release
        self._set_context = set_context or (lambda: None)
        self.num_restarts = 0
        self._queue: queue.Queue[_ActorCall | None] = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        # Signalled when an executor thread ends.
        self._thread_ended = threading.Condition(self._lock)
        self._live_threads = 0
        self._dead = False
        # Dead with no restart to follow.
        self._final = False
        self._death_reason: str | None = None
        self._instance = None
        self._is_async = any(
            inspect.iscoroutinefunction(m) for _, m in
            inspect.getmembers(cls, predicate=inspect.isfunction))
        self._creation_return_id = creation_return_id
        self._start_thread()

    def _start_thread(self) -> None:
        with self._lock:
            self._live_threads += 1
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"ray_tpu_torch-actor-{self._cls.__name__}"
                 f"-r{self.num_restarts}")
        self._thread.start()

    # ----------------------------------------------------------------- calls

    def submit(self, call: _ActorCall) -> None:
        with self._lock:
            if self._dead:
                self._fail_call(call, ActorDiedError(
                    self.actor_id, self._death_reason or "actor has died"))
                return
            if 0 <= self._max_pending_calls <= self._pending:
                self._fail_call(call, PendingCallsLimitExceeded(
                    f"actor {self._cls.__name__} has {self._pending} "
                    f"pending calls"))
                return
            self._pending += 1
            # Queued under the lock, so _mark_dead's drain (same lock)
            # cannot miss a call in flight.
            self._queue.put(call)

    def _fail_call(self, call: _ActorCall, error: BaseException) -> None:
        for rid in call.return_ids:
            self._store.put_error(rid, error)

    # ------------------------------------------------------------- execution

    def _run(self) -> None:
        # This thread serves the queue it started with: a restart gives
        # the new thread a new queue, and this one ends at its sentinel.
        calls = self._queue
        self._set_context()
        try:
            self._instance = self._cls(*self._init_args, **self._init_kwargs)
        except Exception as exc:  # noqa: BLE001 — a failed constructor kills the actor
            self._mark_dead(f"constructor failed: {exc!r}")
            if self._creation_return_id is not None:
                self._store.put_error(
                    self._creation_return_id,
                    ActorError(exc, format_traceback(exc),
                               f"{self._cls.__name__}.__init__"))
        else:
            if self._creation_return_id is not None:
                self._store.put(self._creation_return_id, None)
            if self._is_async:
                self._run_async_loop(calls)
            elif self._max_concurrency > 1 or self._concurrency_groups:
                self._run_threadpool(calls)
            else:
                self._run_sequential(calls)
        with self._lock:
            self._live_threads -= 1
            release = self._final and self._live_threads == 0
            self._thread_ended.notify_all()
        if release:
            # Let go of the instance and its arguments now (an engine
            # actor holds weights and a KV pool on the card), not when
            # the collector reaches the runtime's reference cycles.
            self._instance = None
            self._init_args, self._init_kwargs = (), {}
            if self._on_release is not None:
                self._on_release(self.actor_id)

    def _run_sequential(self, calls: queue.Queue) -> None:
        while (call := calls.get()) is not None:
            self._execute(call)
            # Unbind before blocking again: a stale local would keep the
            # last call's arguments (and ObjectRefs in them) alive.
            call = None

    def _run_threadpool(self, calls: queue.Queue) -> None:
        pools = {group: ThreadPoolExecutor(max_workers=size,
                                           initializer=self._set_context)
                 for group, size in [(None, self._max_concurrency),
                                     *self._concurrency_groups.items()]}
        try:
            while (call := calls.get()) is not None:
                pools[self._method_groups.get(call.method_name)].submit(
                    self._execute, call)
                call = None
        finally:
            for pool in pools.values():
                pool.shutdown(wait=True)

    def _run_async_loop(self, calls: queue.Queue) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        sem = asyncio.Semaphore(self._max_concurrency)
        running: set = set()

        async def run_one(call):
            try:
                await self._execute_async(call)
            finally:
                sem.release()

        async def drive():
            while True:
                call = await loop.run_in_executor(None, calls.get)
                if call is None:
                    return
                await sem.acquire()
                task = loop.create_task(run_one(call))
                running.add(task)
                task.add_done_callback(running.discard)

        try:
            loop.run_until_complete(drive())
        finally:
            for task in list(running):
                task.cancel()
            loop.run_until_complete(
                asyncio.gather(*running, return_exceptions=True))
            loop.close()

    def _call_error(self, call: _ActorCall) -> "BaseException | None":
        """The error a call seals instead of running, or None."""
        with self._lock:
            self._pending -= 1
        if call.cancelled:
            return TaskCancelledError()
        if call.deadline is not None and time.time() > call.deadline:
            return TaskTimeoutError(
                f"{self._cls.__name__}.{call.method_name}", "actor_queue",
                call.deadline)
        return None

    def _execute(self, call: _ActorCall) -> None:
        error = self._call_error(call)
        if error is not None:
            self._fail_call(call, error)
            return
        token = request_context.set_deadline(call.deadline)
        try:
            method = getattr(self._instance, call.method_name)
            self._store_result(call, method(*call.args, **call.kwargs))
        except _ExitActor:
            self._store_result(call, None)
            self.kill("exit_actor() was called", no_restart=True)
        except BaseException as exc:  # noqa: BLE001 — sealed onto the call's refs, where it is reported
            self._fail_call(call, ActorError(
                exc, format_traceback(exc),
                f"{self._cls.__name__}.{call.method_name}"))
        finally:
            request_context.reset_deadline(token)

    async def _execute_async(self, call: _ActorCall) -> None:
        error = self._call_error(call)
        if error is not None:
            self._fail_call(call, error)
            return
        token = request_context.set_deadline(call.deadline)
        try:
            method = getattr(self._instance, call.method_name)
            result = method(*call.args, **call.kwargs)
            if inspect.isawaitable(result):
                result = await result
            self._store_result(call, result)
        except _ExitActor:
            self._store_result(call, None)
            self.kill("exit_actor() was called", no_restart=True)
        except BaseException as exc:  # noqa: BLE001 — sealed onto the call's refs, where it is reported
            self._fail_call(call, ActorError(
                exc, format_traceback(exc),
                f"{self._cls.__name__}.{call.method_name}"))
        finally:
            request_context.reset_deadline(token)

    def _store_result(self, call: _ActorCall, result: Any) -> None:
        if len(call.return_ids) == 1:
            self._store.put(call.return_ids[0], result)
        elif len(call.return_ids) > 1:
            values = list(result) if result is not None \
                else [None] * len(call.return_ids)
            for rid, value in zip(call.return_ids, values):
                self._store.put(rid, value)

    # ----------------------------------------------------------------- death

    def kill(self, reason: str = "killed via kill()",
             no_restart: bool = True) -> None:
        restartable = (not no_restart) \
            and self.num_restarts < self._max_restarts
        # A restarting actor keeps its resources and its name, so on_death
        # fires, and the resources go back, only on permanent death.
        self._mark_dead(reason, notify=not restartable)
        self._queue.put(None)  # unblock the executor loop
        if restartable:
            self._restart()

    def _mark_dead(self, reason: str, notify: bool = True) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._final = notify
            self._death_reason = reason
            drained: list[_ActorCall] = []
            try:
                while True:
                    item = self._queue.get_nowait()
                    if item is not None:
                        drained.append(item)
            except queue.Empty:
                pass
            self._pending = 0
        for call in drained:
            self._fail_call(call, ActorDiedError(self.actor_id, reason))
        if notify and self._on_death is not None:
            self._on_death(self.actor_id, reason)

    def _restart(self) -> None:
        """Build a new instance on a new thread."""
        with self._lock:
            self.num_restarts += 1
            self._dead = False
            self._death_reason = None
        self._instance = None
        self._creation_return_id = None
        self._queue = queue.Queue()
        self._start_thread()

    def wait_stopped(self, timeout: float) -> bool:
        """Wait up to ``timeout`` for every executor thread to end (the
        calls that were running when the actor died included); whether
        they have."""
        with self._lock:
            return self._thread_ended.wait_for(
                lambda: self._live_threads == 0, timeout)

    def is_dead(self) -> bool:
        with self._lock:
            return self._dead


def method_groups(cls: type) -> dict[str, str]:
    """Method name -> the concurrency group it is marked with."""
    groups = {}
    for name in dir(cls):
        group = getattr(getattr(cls, name, None),
                        "__ray_tpu_concurrency_group__", None)
        if group is not None:
            groups[name] = group
    return groups


def exit_actor():
    """End the current actor from inside one of its methods."""
    raise _ExitActor()
