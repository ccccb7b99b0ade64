"""Shared-memory object transport between the driver and its worker
processes.

The port of ``ray_tpu/_private/shm_store.py`` without the native arena
(``arena_store.py`` and ``ray_tpu/_native/``): every object that crosses
in shared memory has a POSIX segment of its own
(``multiprocessing.shared_memory``), as the reference's objects above
``object_arena_max_object_bytes`` do. An object is serialized once into
a segment and mapped by every process that reads it, so an argument
passed from worker to worker never copies through the driver.

The driver owns the directory (object id -> segment), the owner half of
the reference's ownership-based object directory; readers keep their
mappings open in a per-process cache.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from multiprocessing import resource_tracker, shared_memory
from typing import Any

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID


@dataclass(frozen=True)
class ShmDescriptor:
    """Where an object lives: segment name and payload size."""

    name: str
    size: int


def untrack(seg: shared_memory.SharedMemory) -> None:
    """Drop a segment from this process's resource tracker, which would
    unlink it when the process exits: a worker exiting must not delete
    objects the driver still serves. Workers untrack what they create
    (the driver adopts it) and what they attach."""
    try:
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:  # noqa: BLE001 — private tracker API may change shape
        pass


def track(seg: shared_memory.SharedMemory) -> None:
    """Register an adopted segment with this process's tracker, so the
    later ``unlink()`` (which unregisters) is symmetric."""
    try:
        resource_tracker.register(seg._name, "shared_memory")
    except Exception:  # noqa: BLE001 — private tracker API may change shape
        pass


def _defuse(seg: shared_memory.SharedMemory) -> None:
    """Make a segment's close() a no-op after a BufferError: live views
    still use the mapping, which stays until the process exits."""
    try:
        seg._buf = None
        seg._mmap = None
    except Exception:  # noqa: BLE001 — private segment fields may change shape
        pass


class ShmObjectWriter:
    """Create-then-seal (plasma's Create/Seal)."""

    @staticmethod
    def put_serialized(header, buffers, size: int
                       ) -> tuple[ShmDescriptor, shared_memory.SharedMemory]:
        seg = shared_memory.SharedMemory(create=True, size=max(size, 1))
        serialization.write_framed(seg.buf, header, buffers)
        return ShmDescriptor(seg.name, size), seg

    @staticmethod
    def put(value: Any) -> tuple[ShmDescriptor, shared_memory.SharedMemory]:
        header, buffers = serialization.serialize(value)
        size = serialization.framed_size(header, buffers)
        return ShmObjectWriter.put_serialized(header, buffers, size)


class ShmClient:
    """Per-process reader with an open-segment cache. Values view the
    mapping zero-copy, so a segment stays open once read, until
    ``close_segment`` (the driver freed the object) or ``close_all``."""

    def __init__(self, untrack_on_attach: bool = False):
        self._lock = threading.Lock()
        self._segments: dict[str, shared_memory.SharedMemory] = {}
        # Python 3.12 registers a segment with the tracker on attach too.
        # Workers never unlink, so they untrack attaches; the driver's
        # client shares its process with ShmDirectory, whose unlink()
        # unregisters, so it keeps them.
        self._untrack_on_attach = untrack_on_attach
        self._leaked: list[shared_memory.SharedMemory] = []

    def get(self, desc: ShmDescriptor) -> Any:
        with self._lock:
            seg = self._segments.get(desc.name)
            if seg is None:
                seg = shared_memory.SharedMemory(name=desc.name)
                if self._untrack_on_attach:
                    untrack(seg)
                self._segments[desc.name] = seg
        return serialization.deserialize_from_buffer(seg.buf[:desc.size])

    def close_segment(self, name: str) -> None:
        with self._lock:
            seg = self._segments.pop(name, None)
        if seg is not None:
            try:
                seg.close()
            except BufferError:
                # A live view still uses the mapping: keep it open.
                with self._lock:
                    self._segments[name] = seg

    def close_all(self) -> None:
        with self._lock:
            segments = list(self._segments.values())
            self._segments.clear()
        for seg in segments:
            try:
                seg.close()
            except BufferError:
                _defuse(seg)
                with self._lock:
                    self._leaked.append(seg)


class ShmDirectory:
    """The driver's registry of segment-resident objects: each segment
    is unlinked exactly once, at free or at shutdown (POSIX shared
    memory outlives its processes until it is unlinked)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_object: dict[ObjectID, ShmDescriptor] = {}
        self._owned: dict[str, shared_memory.SharedMemory] = {}
        self._leaked: list[shared_memory.SharedMemory] = []

    def register(self, object_id: ObjectID, desc: ShmDescriptor,
                 segment: "shared_memory.SharedMemory | None") -> None:
        """``segment`` None: another process owns it (a peer's segment
        mapped on the same host), so this directory never unlinks it."""
        with self._lock:
            self._by_object[object_id] = desc
            if segment is not None:
                self._owned[desc.name] = segment

    def adopt(self, object_id: ObjectID, desc: ShmDescriptor) -> None:
        """Record a segment a worker created; the driver takes over its
        unlink (the worker may exit first)."""
        try:
            seg = shared_memory.SharedMemory(name=desc.name)
        except FileNotFoundError:
            return
        track(seg)  # the creating worker untracked it
        self.register(object_id, desc, seg)

    def lookup(self, object_id: ObjectID) -> ShmDescriptor | None:
        with self._lock:
            return self._by_object.get(object_id)

    def free(self, object_id: ObjectID) -> "str | None":
        """Unlink the object's segment; its name, or None."""
        with self._lock:
            desc = self._by_object.pop(object_id, None)
            seg = self._owned.pop(desc.name, None) if desc else None
        if seg is not None:
            self._close_and_unlink(seg)
        return desc.name if desc else None

    def shutdown(self) -> None:
        with self._lock:
            owned = list(self._owned.values())
            self._owned.clear()
            self._by_object.clear()
        for seg in owned:
            self._close_and_unlink(seg)

    def _close_and_unlink(self, seg: shared_memory.SharedMemory) -> None:
        try:
            seg.unlink()
        except FileNotFoundError:
            pass
        try:
            seg.close()
        except BufferError:
            _defuse(seg)
            with self._lock:
                self._leaked.append(seg)
