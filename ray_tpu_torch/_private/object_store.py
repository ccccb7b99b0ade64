"""In-memory object store with spilling and reference counting.

The port of ``ray_tpu/_private/object_store.py``, its in-process tier.
Objects are held as live Python objects, by reference: a ``put`` of
tensors, on the CPU or on a card, copies nothing, and every reader in the
process gets the same tensors (the same ``data_ptr()``). Each object is
charged its size. With the managed spill tier armed
(``enable_managed_spill``, spill_manager.py), a spiller thread moves the
largest sealed host objects that no reader holds pinned to checksummed
files once their bytes cross the high watermark, and a read restores
them after checking the file; a torn file marks the object lost and
hands it to the runtime's lineage rebuild. Without it, past the budget
the oldest such objects are pickled inline to the spill directory. An
object that holds a tensor on a card is charged but never spilled: the
putter still holds the tensor, so a pickle would free no memory, and a
restore would make a second copy on the card. Such objects do not count
against the budget, so they push no host object out either.

Reference counting follows the ownership model: live ObjectRef handles
count, and an object whose count reaches zero is evicted.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import os
import pickle
import threading
import time
import types
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import (
    GetTimeoutError,
    ObjectFreedError,
    ObjectLostError,
)


# Leaves whatever they hold: their attributes are code or raw data.
_OPAQUE = (type, types.ModuleType, types.FunctionType, types.MethodType,
           types.BuiltinFunctionType, torch.Tensor, np.ndarray,
           str, bytes, bytearray, memoryview)


def _children(value: Any):
    """What a container or a plain object holds: a dict's values, the
    items of a list, tuple or set, a dataclass's fields, an instance's
    ``__dict__`` values; None for a leaf."""
    if isinstance(value, dict):
        return value.values()
    if isinstance(value, (list, tuple, set, frozenset)):
        return value
    if isinstance(value, _OPAQUE):
        return None
    if dataclasses.is_dataclass(value):
        return [getattr(value, f.name) for f in dataclasses.fields(value)]
    attrs = getattr(value, "__dict__", None)
    return attrs.values() if isinstance(attrs, dict) else None


def _leaves(value: Any):
    """Every leaf ``value`` holds, each container visited once (a
    self-referencing object ends), without recursion."""
    seen: set[int] = set()
    stack = [value]
    while stack:
        item = stack.pop()
        children = _children(item)
        if children is None:
            yield item
        elif id(item) not in seen:
            seen.add(id(item))
            stack.extend(children)


def _leaf_size(value: Any) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (bytes, bytearray, memoryview, str)):
        return len(value)
    return 64


def _sizeof(value: Any) -> int:
    """Best-effort deep size estimate without serializing.

    A tensor counts ``numel() * element_size()`` on any device, an array
    its ``nbytes``; a container or an object counts what it holds (a
    dict's values, not its keys; a dataclass's fields; an instance's
    ``__dict__``), however many entries, so a parameter tree or a train
    state is charged the bytes of its leaves. The reference counts a
    ``torch.Tensor`` as 64 bytes, adds 64 bytes and the keys for every
    container, and sees only lists, tuples, sets and dicts of under
    1,024 entries."""
    return sum(_leaf_size(leaf) for leaf in _leaves(value))


def _on_device(value: Any) -> bool:
    """Whether ``value`` holds a tensor outside host memory, found where
    ``_sizeof`` looks."""
    return any(isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"
               for leaf in _leaves(value))


class _DeviceTensorFound(Exception):
    """A spill met a tensor outside host memory."""


class _HostPickler(pickle.Pickler):
    """Pickles host objects only: a tensor on a card (one ``_sizeof``
    could not see, behind ``__slots__`` or a custom ``__reduce__``)
    raises instead of being copied to the host."""

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise _DeviceTensorFound
        return None


@dataclass
class ObjectEntry:
    object_id: ObjectID
    value: Any = None
    error: BaseException | None = None
    sealed: bool = False
    size_bytes: int = 0
    # Holds a tensor on a card: never spilled, outside the budget.
    on_device: bool = False
    spilled_path: str | None = None
    freed: bool = False
    # Lost: was sealed, then its node died or its spill file tore.
    # Getters wait until the lineage rebuild reseals it (or an
    # ObjectLostError is sealed in).
    lost: bool = False
    created_at: float = field(default_factory=time.monotonic)
    # Pinned while a get() is materializing it; pinned entries never spill.
    pin_count: int = 0
    # Spilled by the managed tier: its file has the length and CRC header.
    managed_spill: bool = False
    # The managed tier's least-recently-used tiebreak (stamped on get).
    last_used: float = field(default_factory=time.monotonic)


class _TornRestore(Exception):
    """A managed spill file failed its check: the entry is marked lost and
    the getter waits for the rebuild."""


class ObjectStore:
    """The node's object store: seal/get/wait/free with spill to disk."""

    def __init__(self, memory_limit_bytes: int, spill_dir: str):
        # Reentrant: an allocation inside a locked section can run the
        # collector, which can run ObjectRef.__del__ and from it evict()
        # on this store from the same thread.
        self._lock = threading.Condition(threading.RLock())
        self._entries: dict[ObjectID, ObjectEntry] = {}
        self._memory_limit = memory_limit_bytes
        self._memory_used = 0
        # The part of _memory_used held on cards.
        self._device_used = 0
        self._spill_dir = spill_dir
        self._spilled_bytes_total = 0
        self._restored_bytes_total = 0
        # Called outside the lock with each sealed id.
        self._seal_listeners: list[Callable[[ObjectID], None]] = []
        # Called once an object's value is dropped (freed or evicted).
        self._free_listeners: list[Callable[[ObjectID], None]] = []
        # The managed spill tier, armed by enable_managed_spill; None
        # keeps the inline spill.
        self._spill = None
        self._spill_min_bytes = 4096
        self._leased_fn = None
        self._on_backing_free = None
        self._on_torn = None
        # Objects that failed to pickle once: never chosen again.
        self._unspillable: set[ObjectID] = set()

    # ------------------------------------------------------- managed spill

    def enable_managed_spill(self, spill_dir: str | None = None,
                             leased_fn=None, on_backing_free=None,
                             on_torn=None):
        """Arm the managed spill tier and return its SpillManager.
        ``leased_fn()`` gives the id bytes never to spill now;
        ``on_backing_free(object_id)`` drops an object's shared-memory
        twin once its copy is on disk; ``on_torn(object_id)`` rebuilds an
        object whose file failed its check (without it, the getter gets
        ObjectLostError)."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.spill_manager import SpillManager

        self._leased_fn = leased_fn
        self._on_backing_free = on_backing_free
        self._on_torn = on_torn
        self._spill_min_bytes = max(
            4096, int(GLOBAL_CONFIG.spill_min_object_kb) * 1024)
        self._spill = SpillManager(
            "driver-store", self._memory_limit,
            usage_fn=self._host_used,
            victims_fn=self._spill_victims,
            extract_fn=self._spill_extract,
            commit_fn=self._spill_commit,
            spill_dir=spill_dir)
        return self._spill

    def _host_used(self) -> int:
        """The bytes the budget counts: those in host memory."""
        return self._memory_used - self._device_used

    def _spill_victims(self, need_bytes: int) -> list:
        leased: set = set()
        if self._leased_fn is not None:
            try:
                leased = {bytes(b) for b in self._leased_fn()}
            except Exception:  # noqa: BLE001 — nothing protected then
                leased = set()
        with self._lock:
            cands = [
                (e.object_id, e.size_bytes, e.last_used)
                for e in self._entries.values()
                if self._spillable(e)
                and e.size_bytes >= self._spill_min_bytes
                and e.object_id not in self._unspillable
                and e.object_id.binary() not in leased]
        # Largest first (the fewest files free the most bytes), least
        # recently used as the tiebreak.
        cands.sort(key=lambda c: (-c[1], c[2]))
        out, covered = [], 0
        for oid, size, _used in cands:
            out.append(oid)
            covered += size
            if covered >= need_bytes:
                break
        return out

    @staticmethod
    def _spillable(entry: "ObjectEntry | None") -> bool:
        """Sealed, live, in host memory, not on disk, no reader pinning
        it."""
        return entry is not None and entry.sealed and not entry.freed \
            and entry.error is None and not entry.on_device \
            and entry.pin_count == 0 and entry.spilled_path is None

    def _spill_extract(self, object_id: ObjectID):
        with self._lock:
            entry = self._entries.get(object_id)
            if not self._spillable(entry):
                return None
            value = entry.value
        # Pickled outside the lock: it walks user containers.
        buf = io.BytesIO()
        try:
            _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(value)
        except _DeviceTensorFound:
            self._keep_on_device(entry)
            return None
        except Exception:  # noqa: BLE001 — unpicklable stays in memory
            with self._lock:
                self._unspillable.add(object_id)
            return None
        return buf.getbuffer()

    def _spill_commit(self, object_id: ObjectID, path: str,
                      size: int) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            if not self._spillable(entry):
                return False
            entry.spilled_path = path
            entry.managed_spill = True
            entry.value = None
            self._memory_used -= entry.size_bytes
            self._spilled_bytes_total += entry.size_bytes
        if self._on_backing_free is not None:
            self._on_backing_free(object_id)
        return True

    # ------------------------------------------------------------------ put

    def create_pending(self, object_id: ObjectID) -> None:
        """Register an object whose value arrives later."""
        with self._lock:
            if object_id not in self._entries:
                self._entries[object_id] = ObjectEntry(object_id)

    def put(self, object_id: ObjectID, value: Any) -> None:
        self._seal(object_id, value=value, error=None)

    def put_error(self, object_id: ObjectID, error: BaseException) -> None:
        self._seal(object_id, value=None, error=error)

    def _seal(self, object_id: ObjectID, value: Any,
              error: BaseException | None):
        # Sized outside the lock: _sizeof walks user containers.
        size_bytes = _sizeof(value) if error is None else 256
        on_device = error is None and _on_device(value)
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = self._entries[object_id] = ObjectEntry(object_id)
            if entry.sealed and not entry.freed:
                # Idempotent reseal (a retried task recomputed it).
                if entry.spilled_path is not None:
                    self._unlink_spill(entry)
                else:
                    self._uncharge(entry)
            entry.value = value
            entry.error = error
            entry.sealed = True
            entry.freed = False
            entry.lost = False
            entry.size_bytes = size_bytes
            entry.on_device = on_device
            self._memory_used += size_bytes
            if on_device:
                self._device_used += size_bytes
            self._unspillable.discard(object_id)
            self._lock.notify_all()
            listeners = list(self._seal_listeners)
        for cb in listeners:
            cb(object_id)
        self._maybe_spill()

    def add_free_listener(self, cb: Callable[[ObjectID], None]) -> None:
        with self._lock:
            self._free_listeners.append(cb)

    def _notify_freed(self, object_ids) -> None:
        with self._lock:
            listeners = list(self._free_listeners)
        for cb in listeners:
            for oid in object_ids:
                cb(oid)

    def add_seal_listener(self, cb: Callable[[ObjectID], None]) -> None:
        with self._lock:
            self._seal_listeners.append(cb)

    # ------------------------------------------------------------------ get

    def get(self, object_id: ObjectID, timeout: float | None = None) -> Any:
        """Block until the object is sealed; raise a sealed error.

        A managed restore that finds its file torn marks the object lost,
        hands it to ``on_torn`` (the lineage rebuild) and waits again: the
        getter gets the rebuilt value or a sealed ObjectLostError, never
        the torn bytes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                while True:
                    entry = self._entries.get(object_id)
                    if entry is not None and entry.freed:
                        raise ObjectFreedError(
                            object_id, f"object {object_id.hex()} was freed")
                    if entry is not None and entry.sealed:
                        break
                    # Unknown, pending or lost: wait (an unknown id may be
                    # in flight, a lost one is being rebuilt).
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise GetTimeoutError(
                            f"get() timed out waiting for object "
                            f"{object_id.hex()}")
                    self._lock.wait(timeout=1.0 if remaining is None
                                    else min(remaining, 1.0))
                entry.pin_count += 1
                entry.last_used = time.monotonic()
            torn = False
            try:
                value, error = self._materialize(entry)
            except _TornRestore:
                torn = True
            finally:
                with self._lock:
                    entry.pin_count -= 1
            if not torn:
                if error is not None:
                    raise error
                return value
            if self._on_torn is not None:
                try:
                    self._on_torn(object_id)
                except Exception:  # noqa: BLE001 — the getter waits on
                    pass
            else:
                # No rebuild wired: fail the waiters instead of waiting
                # for a reseal that never comes.
                from ray_tpu_torch._private.object_ref import ObjectRef

                self.put_error(object_id, ObjectLostError(
                    ObjectRef(object_id, _register=False),
                    f"object {object_id.hex()} spill file was torn and no "
                    f"lineage rebuild is wired"))

    def _materialize(self, entry: ObjectEntry):
        """The value of a sealed entry, restored from disk if spilled.
        Concurrent restores race benignly: only the reader whose snapshot
        of the path still matches unlinks the file. A managed file that
        fails its check (or whose pickle fails to load) marks the entry
        lost and raises _TornRestore."""
        from ray_tpu_torch._private.spill_manager import TornSpillError

        while True:
            with self._lock:
                path = entry.spilled_path
                managed = entry.managed_spill
            if path is None:
                return entry.value, entry.error
            if managed:
                try:
                    payload = self._spill.restore(entry.object_id, path)
                    value = pickle.loads(payload)
                except TornSpillError:
                    if not self._mark_torn(entry, path):
                        continue  # raced a reseal; look again
                    raise _TornRestore() from None
                except OSError:
                    continue  # another reader restored it; look again
                except Exception as exc:  # noqa: BLE001 — a poisoned pickle
                    if not self._mark_torn(entry, path):
                        continue
                    _unlink(path)
                    raise _TornRestore() from exc
            else:
                try:
                    with open(path, "rb") as f:
                        value = pickle.load(f)
                except FileNotFoundError:
                    continue  # another reader restored it; look again
            with self._lock:
                if entry.spilled_path == path:
                    self._unlink_spill(entry, count=False)
                    entry.value = value
                    self._memory_used += entry.size_bytes
                    self._restored_bytes_total += entry.size_bytes
            self._maybe_spill()
            # Our loaded copy, not entry.value: another reader may have
            # restored it and the spiller spilled it again meanwhile.
            return value, entry.error

    def _mark_torn(self, entry: ObjectEntry, path: str) -> bool:
        """The entry's file ``path`` failed its check: the entry is lost
        (False if a reseal replaced the file meanwhile)."""
        with self._lock:
            if entry.spilled_path != path:
                return False
            entry.spilled_path = None
            entry.managed_spill = False
            entry.value = None
            entry.sealed = False
            entry.lost = True
            return True

    def mark_lost(self, object_id: ObjectID) -> bool:
        """A sealed object goes back to pending because its node died;
        True if it was sealed. An object a get() is reading now survives
        (the driver holds that copy)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.freed \
                    or entry.pin_count > 0:
                return False
            if entry.spilled_path is not None:
                self._unlink_spill(entry)
            else:
                self._uncharge(entry)
            entry.value = None
            entry.error = None
            entry.on_device = False
            entry.sealed = False
            entry.lost = True
            return True

    def is_lost(self, object_id: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.lost and not entry.sealed

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.sealed and not entry.freed

    def is_pending(self, object_id: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and not entry.sealed

    def wait(self, object_ids: list[ObjectID], num_returns: int,
             timeout: float | None) -> tuple[list[ObjectID], list[ObjectID]]:
        """The first ``num_returns`` sealed ids (in input order) and the
        rest, or what is sealed when ``timeout`` runs out."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                ready = [oid for oid in object_ids
                         if (e := self._entries.get(oid)) is not None
                         and e.sealed and not e.freed]
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if len(ready) >= num_returns or (
                        remaining is not None and remaining <= 0):
                    ready_set = set(ready[:num_returns])
                    return ([o for o in object_ids if o in ready_set],
                            [o for o in object_ids if o not in ready_set])
                self._lock.wait(timeout=1.0 if remaining is None
                                else min(remaining, 1.0))

    # ----------------------------------------------------------------- free

    def free(self, object_ids: list[ObjectID]) -> None:
        with self._lock:
            for oid in object_ids:
                entry = self._entries.get(oid)
                if entry is None:
                    continue
                if entry.sealed and entry.spilled_path is None:
                    self._uncharge(entry)
                self._unlink_spill(entry)
                entry.value = None
                entry.error = None
                entry.freed = True
                entry.sealed = True
                self._unspillable.discard(oid)
            self._lock.notify_all()
        self._notify_freed(object_ids)

    def evict(self, object_id: ObjectID) -> None:
        """Drop an object entirely (its reference count reached zero)."""
        with self._lock:
            entry = self._entries.pop(object_id, None)
            self._unspillable.discard(object_id)
            if entry is None:
                return
            if entry.sealed and not entry.freed \
                    and entry.spilled_path is None:
                self._uncharge(entry)
            self._unlink_spill(entry)
        self._notify_freed([object_id])

    def _uncharge(self, entry: ObjectEntry) -> None:
        # Caller holds the lock; the entry is in memory.
        self._memory_used -= entry.size_bytes
        if entry.on_device:
            self._device_used -= entry.size_bytes

    # ----------------------------------------------------------------- spill

    def _unlink_spill(self, entry: ObjectEntry, count: bool = True) -> None:
        """Drop the entry's spill file; a managed one's removal is counted
        by the manager (``count``: a free, an eviction or a loss, not a
        restore). Caller holds the lock."""
        path, entry.spilled_path = entry.spilled_path, None
        managed, entry.managed_spill = entry.managed_spill, False
        if path is None:
            return
        if managed and count and self._spill is not None:
            self._spill.delete_file(path)
        else:
            _unlink(path)

    def _maybe_spill(self) -> None:
        """With the managed tier, wake its spiller past the high
        watermark. Without it, past the budget, pickle the oldest sealed
        unpinned objects in host memory (over 4 KiB) to disk until their
        usage is back under 70% of it."""
        if self._spill is not None:
            self._spill.notify()
            return
        to_spill: list[ObjectEntry] = []
        with self._lock:
            host_used = self._memory_used - self._device_used
            if host_used <= self._memory_limit:
                return
            candidates = sorted(
                (e for e in self._entries.values()
                 if e.sealed and not e.freed and e.error is None
                 and not e.on_device
                 and e.spilled_path is None and e.pin_count == 0
                 and e.size_bytes > 4096),
                key=lambda e: e.created_at)
            need = host_used - int(self._memory_limit * 0.7)
            for entry in candidates:
                if need <= 0:
                    break
                to_spill.append(entry)
                need -= entry.size_bytes
        if not to_spill:
            return
        os.makedirs(self._spill_dir, exist_ok=True)
        kept = False
        for entry in to_spill:
            path = os.path.join(self._spill_dir, entry.object_id.hex())
            try:
                with open(path, "wb") as f:
                    _HostPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(
                        entry.value)
            except _DeviceTensorFound:
                _unlink(path)
                self._keep_on_device(entry)
                kept = True
                continue
            except Exception:  # noqa: BLE001 — unpicklable stays in memory
                _unlink(path)
                continue
            with self._lock:
                if entry.pin_count == 0 and entry.spilled_path is None \
                        and entry.sealed and not entry.freed \
                        and entry.object_id in self._entries:
                    entry.spilled_path = path
                    entry.value = None
                    self._memory_used -= entry.size_bytes
                    self._spilled_bytes_total += entry.size_bytes
                else:
                    _unlink(path)
        if kept:
            # What it was to free is still charged, now outside the
            # budget: choose again among the host objects.
            self._maybe_spill()

    def _keep_on_device(self, entry: ObjectEntry) -> None:
        """The spill found a tensor on a card in ``entry``: it stays in
        memory, charged as device bytes, outside the budget."""
        with self._lock:
            if not entry.on_device and entry.spilled_path is None \
                    and entry.sealed and not entry.freed \
                    and entry.object_id in self._entries:
                entry.on_device = True
                self._device_used += entry.size_bytes

    def close(self) -> None:
        """Drop every object and delete the spill files."""
        with self._lock:
            for entry in self._entries.values():
                self._unlink_spill(entry)
            self._entries.clear()
            self._memory_used = 0
            self._device_used = 0
            self._seal_listeners.clear()
            self._free_listeners.clear()
            self._lock.notify_all()

    # ----------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._entries),
                "num_sealed": sum(1 for e in self._entries.values()
                                  if e.sealed),
                "memory_used_bytes": self._memory_used,
                "device_bytes": self._device_used,
                "memory_limit_bytes": self._memory_limit,
                "spilled_bytes_total": self._spilled_bytes_total,
                "restored_bytes_total": self._restored_bytes_total,
            }


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass  # already gone


class ReferenceCounter:
    """Counts the live ObjectRef handles of each object and evicts the
    object when its count reaches zero.

    ``ObjectRef.__del__`` runs wherever the collector runs, possibly while
    the thread holds one of the runtime's locks, so ``defer_remove`` only
    appends to a deque (atomic under the GIL) and a reaper thread does the
    removal and the eviction."""

    def __init__(self, store: ObjectStore):
        self._lock = threading.Lock()
        self._counts: dict[ObjectID, int] = {}
        self._store = store
        # Called after an eviction (the runtime drops the object's
        # location and lineage there).
        self.on_evict: Callable[[ObjectID], None] | None = None
        self._deferred: "collections.deque[ObjectID]" = collections.deque()
        self._stop = threading.Event()
        self._reaper = threading.Thread(
            target=self._reap_loop, daemon=True,
            name="ray_tpu_torch-ref-reaper")
        self._reaper.start()

    def defer_remove(self, object_id: ObjectID) -> None:
        """The destructor's entry point: a deque append and nothing else
        (even Event.set() takes a lock); the reaper polls."""
        self._deferred.append(object_id)

    def _reap_loop(self) -> None:
        while not self._stop.is_set():
            try:
                object_id = self._deferred.popleft()
            except IndexError:
                self._stop.wait(0.02)
                continue
            try:
                self.remove_ref(object_id)
            except Exception:  # noqa: BLE001 — the reaper must survive
                pass

    def stop(self) -> None:
        self._stop.set()
        self._reaper.join(timeout=5.0)

    def add_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._counts[object_id] = self._counts.get(object_id, 0) + 1

    def remove_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            count = self._counts.get(object_id)
            if count is None:
                return
            if count > 1:
                self._counts[object_id] = count - 1
                return
            del self._counts[object_id]
        self._store.evict(object_id)
        if self.on_evict is not None:
            self.on_evict(object_id)
