"""Shared-memory object transport between the driver and its worker
processes.

The port of ``ray_tpu/_private/shm_store.py``. An object that crosses in
shared memory is serialized once and read by every process that needs
it, so an argument passed from worker to worker never copies through the
driver. One of at most ``object_arena_max_object_bytes`` lives in the
driver's native arena (``arena_store.py``: an ``ArenaDescriptor``, read
by one copy out); a larger one has a POSIX segment of its own
(``multiprocessing.shared_memory``: a ``ShmDescriptor``, mapped with no
copy). A ``PeerArenaDescriptor`` names an object in another process's
arena on this host (the same-host plane), read by one copy under the
holder's lease.

The driver owns the directory (object id -> descriptor), the owner half
of the reference's ownership-based object directory; readers keep their
segment mappings open in a per-process cache.
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


@dataclass(frozen=True)
class ArenaDescriptor:
    """An object in the arena this process attached: its 16-byte key and
    payload size. ``name`` is a sentinel: segment call sites pass over
    it."""

    key: bytes
    size: int
    name: str = "<arena>"


@dataclass(frozen=True)
class PeerArenaDescriptor:
    """An object in another process's arena on this host: the arena's
    name and the object's key. Read by attaching the arena and copying
    the payload out once; the holder's lease keeps the bytes in place
    for the copy, and the copy keeps deserialized views valid after the
    lease ends."""

    arena: str
    key: bytes
    size: int
    name: str = "<peer-arena>"


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

    @staticmethod
    def put_arena_serialized(arena, key: bytes, header, buffers,
                             size: int) -> "ArenaDescriptor | None":
        """Write serialized framed data into the arena under ``key``,
        sealed pinned (the one reference belongs to the directory that
        registers it; ``ShmDirectory.free`` drops it). None when there is
        no arena or it is full: the caller takes a segment."""
        if arena is None:
            return None
        if not arena.write_object(
                key, size, lambda view: serialization.write_framed(
                    view, header, buffers)):
            return None
        return ArenaDescriptor(key, size)


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
        self._arena = None
        # Attachments of peers' arenas (the same-host plane), made at the
        # first PeerArenaDescriptor.
        self._peer_arenas = None

    def set_arena(self, arena) -> None:
        self._arena = arena

    @property
    def arena(self):
        """The arena this process attached (or owns), or None."""
        return self._arena

    def get(self, desc) -> Any:
        if isinstance(desc, PeerArenaDescriptor):
            with self._lock:
                if self._peer_arenas is None:
                    from ray_tpu_torch._private.same_host import (
                        PeerArenaRegistry,
                    )

                    self._peer_arenas = PeerArenaRegistry()
                registry = self._peer_arenas
            blob = registry.read(desc.arena, desc.key)
            if blob is None:
                raise KeyError(f"peer-arena object {desc.key.hex()} "
                               f"unavailable in {desc.arena}")
            return serialization.deserialize_from_buffer(
                memoryview(blob)[:desc.size])
        if isinstance(desc, ArenaDescriptor):
            if self._arena is None:
                raise RuntimeError("arena object but no arena attached")
            blob = self._arena.get_bytes(desc.key)
            if blob is None:
                raise KeyError(
                    f"arena object {desc.key.hex()} evicted or deleted")
            # The copy owns its memory: views deserialized from it stay
            # valid whatever the arena does next.
            return serialization.deserialize_from_buffer(memoryview(blob))
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
            peer_arenas, self._peer_arenas = self._peer_arenas, None
        if peer_arenas is not None:
            peer_arenas.close_all()
        for seg in segments:
            try:
                seg.close()
            except BufferError:
                _defuse(seg)
                with self._lock:
                    self._leaked.append(seg)


class ShmDirectory:
    """The driver's registry of objects in shared memory: each segment
    is unlinked exactly once, at free or at shutdown (POSIX shared
    memory outlives its processes until it is unlinked), and each arena
    object is unpinned and deleted at its free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_object: dict[ObjectID, Any] = {}
        self._owned: dict[str, shared_memory.SharedMemory] = {}
        self._leaked: list[shared_memory.SharedMemory] = []
        self._arena = None

    def set_arena(self, arena) -> None:
        self._arena = arena

    def register_arena(self, object_id: ObjectID,
                       desc: ArenaDescriptor) -> None:
        """Record an object in the arena. It arrives sealed pinned, so it
        was never evictable on its way here; the directory takes over
        that reference and drops it in ``free``."""
        with self._lock:
            self._by_object[object_id] = desc

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
        """Unlink the object's segment (its name returned), or unpin and
        delete its arena entry (None returned: no segment to close)."""
        with self._lock:
            desc = self._by_object.pop(object_id, None)
            arena = self._arena
            seg = self._owned.pop(desc.name, None) \
                if isinstance(desc, ShmDescriptor) else None
        if isinstance(desc, ArenaDescriptor):
            if arena is not None:
                arena.unpin(desc.key)  # the seal_pinned reference
                arena.delete(desc.key)
            return None
        if seg is not None:
            self._close_and_unlink(seg)
        return desc.name if isinstance(desc, ShmDescriptor) else None

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
