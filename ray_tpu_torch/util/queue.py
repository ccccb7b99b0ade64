"""A FIFO queue backed by an actor, shareable across tasks and actors.

The port of ``ray_tpu/util/queue.py``: blocking ``put``/``get`` with
timeouts, ``Empty`` and ``Full`` as in the ``queue`` module. Serve's
streaming responses carry their chunks through one.
"""

from __future__ import annotations

import collections
import time
from typing import Any

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._items: collections.deque = collections.deque()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return 0 < self.maxsize <= len(self._items)

    def put_nowait(self, item: Any) -> bool:
        if self.full():
            return False
        self._items.append(item)
        return True

    def put_nowait_batch(self, items: list) -> bool:
        if self.maxsize and len(self._items) + len(items) > self.maxsize:
            return False
        self._items.extend(items)
        return True

    def get_nowait(self):
        if not self._items:
            return False, None
        return True, self._items.popleft()

    def get_nowait_batch(self, num_items: int):
        if len(self._items) < num_items:
            return False, None
        return True, [self._items.popleft() for _ in range(num_items)]


class Queue:
    """A FIFO queue whose handle pickles to its actor's handle."""

    def __init__(self, maxsize: int = 0, actor_options: dict | None = None):
        self.maxsize = maxsize
        self.actor = ray_tpu_torch.remote(_QueueActor).options(
            **(actor_options or {})).remote(maxsize)

    def __getstate__(self):
        return {"maxsize": self.maxsize, "actor": self.actor}

    def __setstate__(self, state):
        self.maxsize = state["maxsize"]
        self.actor = state["actor"]

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True,
            timeout: float | None = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(0.01)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: list) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(
                list(items))):
            raise Full

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(0.01)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> list:
        ok, items = ray_tpu_torch.get(
            self.actor.get_nowait_batch.remote(num_items))
        if not ok:
            raise Empty
        return items

    def shutdown(self) -> None:
        """Kill the queue's actor (a no-op once the runtime is shut down:
        it must not start a new one)."""
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.kill(self.actor)
