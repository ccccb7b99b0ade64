"""ArenaStore: the Python side of the native shared-memory arena.

The port of ``ray_tpu/_private/arena_store.py`` (reference: plasma's
client, src/ray/object_manager/plasma/client.h: Create, Seal, Get,
Release, Delete against one shared arena). The native side
(``ray_tpu_torch/_native/plasma_store.cpp``) keeps the allocator, the
object table and a robust lock in the shared memory; this wrapper adds
buffers.

The driver creates the arena at ``init`` (``/ray_tpu_torch_arena_<pid>``,
never a name of the JAX package's); its worker processes attach it by the
name they are handed (``RAY_TPU_TORCH_ARENA_NAME``). Objects are keyed by
16-byte ids (``ObjectID.binary()``, or random for a worker's result).

Where the port differs: every key, size and offset is checked here
before it crosses into C (a key is at least 16 bytes, of which the arena
uses the first 16; a view lies inside the mapping), and ``close`` waits
for the calls in flight on other threads before it unmaps, so no thread
can write or read through a mapping that is gone. A closed store refuses
writes (``False``/``None``, as a full arena does) and finds nothing. A
failed native build raises (``_native.load``): there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

from ray_tpu_torch._native import load as _load_native

KEY_BYTES = 16
# A store whose calls in flight do not finish in this long is unmapped
# only at process exit (its name is unlinked all the same).
_CLOSE_WAIT_S = 10.0


def _check_key(key) -> bytes:
    if not isinstance(key, (bytes, bytearray)) or len(key) < KEY_BYTES:
        raise ValueError(f"an arena key is at least {KEY_BYTES} bytes, got "
                         f"{type(key).__name__} of "
                         f"{len(key) if hasattr(key, '__len__') else '?'}")
    return bytes(key)


def _check_size(size) -> int:
    size = int(size)
    if size < 0:
        raise ValueError(f"negative object size {size}")
    return size


class ArenaStore:
    """One mapped shared-memory arena, created or attached."""

    def __init__(self, handle, name: str, owner: bool):
        self._lib = _load_native()
        self._handle = handle
        self.name = name
        self.owner = owner
        self._base = ctypes.cast(self._lib.rt_store_base(handle),
                                 ctypes.c_void_p).value
        self._mapped = int(self._lib.rt_store_mapped_size(handle))
        self._state = threading.Condition(threading.Lock())
        self._calls = 0

    # -- lifecycle ----------------------------------------------------
    @classmethod
    def create(cls, name: str, capacity_bytes: int,
               table_capacity: int = 4096) -> "ArenaStore | None":
        """A new arena (one of the same name is unlinked first); None
        when the system refuses the segment."""
        lib = _load_native()
        handle = lib.rt_store_create(name.encode(), _check_size(capacity_bytes),
                                     int(table_capacity))
        if not handle:
            return None
        return cls(handle, name, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ArenaStore | None":
        """Map an existing arena; None when there is none by that name."""
        lib = _load_native()
        handle = lib.rt_store_attach(name.encode())
        if not handle:
            return None
        return cls(handle, name, owner=False)

    def close(self) -> None:
        """Detach, or destroy (unmap and unlink) when this process owns
        the arena; once the calls in flight have returned."""
        with self._state:
            handle, self._handle = self._handle, None
            if handle is None:
                return
            drained = self._state.wait_for(lambda: self._calls == 0,
                                           timeout=_CLOSE_WAIT_S)
        if drained:
            if self.owner:
                self._lib.rt_store_destroy(handle, self.name.encode())
            else:
                self._lib.rt_store_detach(handle)
        elif self.owner:
            import _posixshmem

            try:
                _posixshmem.shm_unlink(self.name)
            except OSError:
                pass  # unlinked already

    @contextlib.contextmanager
    def _call(self):
        """The handle, held open for the block (None when closed)."""
        with self._state:
            handle = self._handle
            if handle is not None:
                self._calls += 1
        try:
            yield handle
        finally:
            if handle is not None:
                with self._state:
                    self._calls -= 1
                    if self._calls == 0:
                        self._state.notify_all()

    # -- objects ------------------------------------------------------
    def _view(self, offset: int, size: int) -> memoryview:
        if offset < 0 or size < 0 or offset + size > self._mapped:
            raise ValueError(f"range [{offset}, {offset + size}) lies outside "
                             f"the {self._mapped}-byte arena {self.name}")
        return memoryview((ctypes.c_uint8 * size).from_address(
            self._base + offset)).cast("B")

    def put_bytes(self, object_id: bytes, payloads) -> bool:
        """Write ``payloads`` (buffers) as one sealed object. False when
        the arena cannot hold it (the caller takes a segment of its
        own)."""
        key = _check_key(object_id)
        payloads = [p if isinstance(p, (bytes, bytearray, memoryview))
                    else bytes(p) for p in payloads]
        total = sum(memoryview(p).nbytes for p in payloads)
        with self._call() as handle:
            if handle is None:
                return False
            offset = self._lib.rt_store_create_object(handle, key, total)
            if not offset:
                return False
            view = self._view(offset, total)
            pos = 0
            for p in payloads:
                n = memoryview(p).nbytes
                view[pos:pos + n] = memoryview(p).cast("B")
                pos += n
            self._lib.rt_store_seal(handle, key)
            return True

    def write_object(self, object_id: bytes, size: int, write) -> bool:
        """Allocate ``size`` bytes, let ``write(view)`` fill them and seal
        them pinned (``seal_pinned``: the one reference is the caller's to
        hand over), all with the arena held open. False when the arena
        cannot hold it; a ``write`` that raises deletes the object."""
        key = _check_key(object_id)
        size = _check_size(size)
        with self._call() as handle:
            if handle is None:
                return False
            offset = self._lib.rt_store_create_object(handle, key, size)
            if not offset:
                return False
            try:
                write(self._view(offset, size))
            except BaseException:
                self._lib.rt_store_delete(handle, key)
                raise
            self._lib.rt_store_seal_pinned(handle, key)
            return True

    def create_for_write(self, object_id: bytes,
                         size: int) -> memoryview | None:
        """Allocate an unsealed object and return a writable view of it
        (plasma's Create); the caller writes, then ``seal``s. None when
        the arena cannot hold it. The view is valid while the store is
        open: the port's own paths use ``write_object``."""
        key = _check_key(object_id)
        size = _check_size(size)
        with self._call() as handle:
            if handle is None:
                return None
            offset = self._lib.rt_store_create_object(handle, key, size)
            if not offset:
                return None
            return self._view(offset, size)

    def seal(self, object_id: bytes) -> None:
        key = _check_key(object_id)
        with self._call() as handle:
            if handle is not None:
                self._lib.rt_store_seal(handle, key)

    def seal_pinned(self, object_id: bytes) -> None:
        """Seal and take a reference at once: the object is never
        evictable before ``unpin`` (the hand-off of a worker's result to
        the driver's directory)."""
        key = _check_key(object_id)
        with self._call() as handle:
            if handle is not None:
                self._lib.rt_store_seal_pinned(handle, key)

    def unpin(self, object_id: bytes) -> None:
        """Drop a reference taken by ``seal_pinned`` or ``pin``."""
        key = _check_key(object_id)
        with self._call() as handle:
            if handle is not None:
                self._lib.rt_store_release(handle, key)

    def pin(self, object_id: bytes) -> int | None:
        """Take a reference on a sealed object without reading it: its
        size, or None when it is absent or unsealed. Until ``unpin`` it is
        not evicted and a delete waits (the owner pins for a same-host
        peer that reads this arena)."""
        key = _check_key(object_id)
        size = ctypes.c_uint64()
        with self._call() as handle:
            if handle is None:
                return None
            offset = self._lib.rt_store_get(handle, key, ctypes.byref(size))
        return size.value if offset else None

    def peek(self, object_id: bytes) -> tuple[int, int] | None:
        """(offset, size) of a sealed object, no reference taken: the
        read-only path of a peer attached to another process's arena
        (the owner's lease pin keeps the range valid)."""
        key = _check_key(object_id)
        size = ctypes.c_uint64()
        with self._call() as handle:
            if handle is None:
                return None
            offset = self._lib.rt_store_peek(handle, key, ctypes.byref(size))
        return (int(offset), size.value) if offset else None

    def view_at(self, offset: int, size: int) -> memoryview:
        """A view of an arena range (paired with ``peek`` under a pin or
        lease); valid while the store is open."""
        return self._view(int(offset), int(size))

    def read_sealed(self, object_id: bytes) -> bytes | None:
        """A copy of a sealed object's bytes, no reference taken, with
        the arena held open for the copy; None when it is absent."""
        key = _check_key(object_id)
        size = ctypes.c_uint64()
        with self._call() as handle:
            if handle is None:
                return None
            offset = self._lib.rt_store_peek(handle, key, ctypes.byref(size))
            if not offset:
                return None
            return bytes(self._view(offset, size.value))

    def get_bytes(self, object_id: bytes) -> bytes | None:
        """A copy of an object's payload (a reference is held for the
        copy): a zero-copy view could see its range reused after an
        eviction. Large objects, where zero-copy matters, take segments
        of their own instead."""
        key = _check_key(object_id)
        size = ctypes.c_uint64()
        with self._call() as handle:
            if handle is None:
                return None
            offset = self._lib.rt_store_get(handle, key, ctypes.byref(size))
            if not offset:
                return None
            try:
                return bytes(self._view(offset, size.value))
            finally:
                self._lib.rt_store_release(handle, key)

    def delete(self, object_id: bytes) -> None:
        key = _check_key(object_id)
        with self._call() as handle:
            if handle is not None:
                self._lib.rt_store_delete(handle, key)

    def contains(self, object_id: bytes) -> bool:
        key = _check_key(object_id)
        with self._call() as handle:
            if handle is None:
                return False
            return bool(self._lib.rt_store_contains(handle, key))

    def stats(self) -> dict:
        u = [ctypes.c_uint64() for _ in range(5)]
        with self._call() as handle:
            if handle is not None:
                self._lib.rt_store_stats(handle, *[ctypes.byref(x) for x in u])
        return {"used_bytes": u[0].value, "capacity_bytes": u[1].value,
                "num_objects": u[2].value, "num_evictions": u[3].value,
                "alloc_failures": u[4].value}


# The driver's arena under /dev/shm is ARENA_PREFIX<pid>.
ARENA_PREFIX = "ray_tpu_torch_arena_"


def default_arena_name() -> str:
    """The driver's arena: ``/ray_tpu_torch_arena_<pid>``."""
    return f"/{ARENA_PREFIX}{os.getpid()}"
