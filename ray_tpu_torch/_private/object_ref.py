"""ObjectRef: a handle to a (possibly pending) object.

The port of ``ray_tpu/_private/object_ref.py``. A live ObjectRef holds one
reference on its object; unpickling a ref registers a new one, so a
handle passed into a task keeps the object alive.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, _register: bool = True):
        self._id = object_id
        self._registered = False
        if _register:
            runtime = _try_runtime()
            if runtime is not None:
                runtime.reference_counter.add_ref(object_id)
                self._registered = True

    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def __del__(self):
        # Runs at any point the collector runs, possibly while this thread
        # holds a runtime lock: the counter only appends to a deque here
        # and a reaper thread does the rest, so this can never deadlock.
        if getattr(self, "_registered", False):
            try:
                runtime = _try_runtime()
                if runtime is not None:
                    runtime.reference_counter.defer_remove(self._id)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass

    def __reduce__(self):
        return (ObjectRef, (self._id,))

    def future(self) -> concurrent.futures.Future:
        """A concurrent.futures.Future resolving to the value."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        runtime = _try_runtime()
        if runtime is None:
            fut.set_exception(RuntimeError("ray_tpu_torch is not initialized"))
            return fut
        runtime.attach_future(self, fut)
        return fut

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"


def _try_runtime():
    from ray_tpu_torch._private import worker

    return worker.global_runtime()


def resolve_args(args: tuple, kwargs: dict,
                 get_fn) -> tuple[tuple, dict, list[Any]]:
    """Replace top-level ObjectRef args with their values. Refs nested in
    containers are passed through (the callee calls get() itself), as in
    the reference."""
    resolved_args = tuple(get_fn(a) if isinstance(a, ObjectRef) else a
                          for a in args)
    resolved_kwargs = {k: get_fn(v) if isinstance(v, ObjectRef) else v
                       for k, v in kwargs.items()}
    return resolved_args, resolved_kwargs, ref_args(args, kwargs)


def ref_args(args: tuple, kwargs: dict) -> list:
    """The top-level ObjectRef arguments: a task's dependencies."""
    return [a for a in args if isinstance(a, ObjectRef)] + [
        v for v in kwargs.values() if isinstance(v, ObjectRef)]
