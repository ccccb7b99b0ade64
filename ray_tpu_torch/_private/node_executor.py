"""The node executor: the cluster's distributed execution plane.

The port of ``ray_tpu/_private/node_executor.py``:

- ``NodeExecutorService`` runs in every worker-node daemon and serves
  ``execute_task`` over RPC: admission reserves the task's resources on
  the node's own ledger (a node several drivers share refuses work past
  its capacity, and the driver spills it to another node), then a CPU
  task runs in the node's worker pool and a ``GPU`` task runs in the
  daemon's own process, on its dispatch thread, on the card the node's
  ``CardLedger`` leased it (the reference runs TPU tasks there too: the
  daemon owns the accelerator). Actors live in worker processes of their
  own; a ``GPU`` actor boots a fresh interpreter that sees only its
  leased cards.
- ``NodeObjectStore`` holds the results too large to ship in the reply
  and the copies pulled from peers. Peers and drivers read them with
  chunked ``fetch_object`` calls; a large object is pulled from its
  owner and from the peers that hold it, several chunks in flight
  (``fetch_plan``, ``ChunkDirectory``, ``_PartialBlob``), with a peer
  that dies mid-pull blacklisted and a dead owner replaced by a holder
  of the whole object.
- ``RemoteNodeHandle`` is the driver's side: it ships a function once
  per node by digest and passes an argument that lives on a node as a
  ``FetchRef``, so the consuming node pulls it from the holder and the
  driver never relays the bytes.

A CUDA tensor crosses a node boundary as it crosses a process boundary:
one host copy, and back on ``cuda`` where the receiver sees a card.
There is no CUDA IPC.

The node store spills: past ``node_store_primary_limit_mb`` its primary
copies go to checksummed files (the managed tier of
``spill_manager.py``, armed under ``spill_enabled``), restored by the
next read, a fetch or a task taking one as an argument; a fetch plan says
when the copy is on disk, and the heartbeat carries the spilled and
restored events to the head's directory. A CUDA tensor result is in the
store as its serialized host copy already, so it spills as that and
comes back on ``cuda`` where it is read.

The same-host plane (``same_host.py``): a stored result of at least
``same_host_map_min_kb`` gets a named-segment twin, and a puller on the
same host (``fetch_plan``'s ``puller_host`` equal to this daemon's
``host_id``) is granted a lease on it in the plan's reply. A pool task's
argument then maps the owner's segment with no copy; a read in the
daemon's own process (every ``GPU`` task) copies out of it once. The
puller releases the lease (``unpin_object``); the sweep ends the leases
of pullers that died. Anything that fails falls through to the chunked
pull. A spilled primary has no twin and is pulled in chunks. A driver's
export of at most ``object_arena_max_object_bytes`` is an ``"arena"``
source, an object in the driver's native arena: a pool task's argument
then reads it out of the attached arena (a ``PeerArenaDescriptor``, one
copy in the worker) and a read here copies it once. Only a driver owns
an arena; the sweep unlinks the arenas of owners that died
(``arena_orphans_swept``).

The store is the native one (``node_store_native.py``) when
``node_store_native`` is on and the managed spill tier is off, else
``NodeObjectStore`` (``make_node_store``).

The pipelined task path: ``execute_task_batch`` takes a run of tasks
in one RPC and streams their completions back in groups as they finish
(``results`` parts; ``started``/``started_many`` before an entry can
have effects, ``parked``/``resumed`` when a frame waits behind a blocked
lease head or in admission; then ``("done", n, fused stats)``). A
ref-bearing entry, a ``GPU`` entry (which runs on this process's
dispatch thread, on its card) and one whose runtime_env needs a fresh
interpreter take the classic ``execute_task``; the rest ride pipelined
multi-task worker leases (``WorkerPool.run_task_batch``), or, while
``fused_execution`` is on and this node declares no ``GPU``, run right
on the RPC's dispatch thread with no worker-pipe hop (``_run_fused``,
its wall budget spilling the rest to the worker path). A node with a
card runs its card tasks in this process, which sees the card, so its
plain tasks stay in pool workers, which do not. ``executor_stats()``
and ``stats_for_sync()`` carry the ``pipeline`` group of counters.

Not ported (ROADMAP 10c): the columnar batch descriptor (``"col1"``)
and the dispatch lanes that send it, speculation, the chaos sites of
the batch RPC (``sched.straggle``, ``overload.saturate``) and the trace
context of a batch entry (element 10 rides as ``None``).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from ray_tpu_torch._private import flight_recorder, serialization
from ray_tpu_torch._private import perf_plane as perf
from ray_tpu_torch._private.accelerators import CardLedger
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.rpc import (
    MuxRpcClient,
    RpcClient,
    RpcError,
    RpcMethodError,
    RpcServer,
    TailPayload,
    breaker_stats,
    rpc_retry_count,
)

logger = logging.getLogger("ray_tpu_torch")

# The environment variable a daemon sets to its node's tag; its workers
# and actors inherit it, so a task can tell where it ran.
NODE_TAG_ENV = "RAY_TPU_TORCH_NODE_TAG"


def _inline_reply_bytes() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return int(GLOBAL_CONFIG.executor_inline_reply_kb) * 1024


def _fetch_chunk_bytes() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return int(GLOBAL_CONFIG.fetch_chunk_kb) * 1024


def _pipeline_depth() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return max(1, int(GLOBAL_CONFIG.rpc_pipeline_depth))


# Fused in-daemon execution (fused_execution): a run of plain CPU entries
# of a batch RPC runs on its dispatch thread, with no worker-pipe hop.
# Daemons read RAY_TPU_TORCH_FUSED_EXECUTION at import.
FUSED_ON: bool = True


def init_fused_from_config() -> None:
    """Arm or disarm fused in-daemon execution from the config."""
    global FUSED_ON
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    FUSED_ON = bool(GLOBAL_CONFIG.fused_execution)


init_fused_from_config()

# An object of fewer chunks is pulled from its owner alone; a larger one
# also from up to _CHUNK_FANOUT peers that pulled it.
_MIN_P2P_CHUNKS = 4
_CHUNK_FANOUT = 4
# Pulled copies a node keeps.
_PULL_CACHE_BYTES = 512 << 20
# executor_stats()["data_plane"]: how a node's pulls went (a mapped peer
# segment, one copy out of one, the chunked pull), the map sources it
# serves, the peers' segments it holds and its leases' counters.
DATA_PLANE_STAT_KEYS = ("same_host_map_hits", "same_host_copy_hits",
                        "chunked_pulls", "map_sources",
                        "attached_mappings", "leases")


@dataclass
class FetchRef:
    """An argument that lives in a node's store (or a driver's export
    store): looked up locally or pulled in chunks from ``addr``."""

    id_bytes: bytes
    addr: str


@dataclass
class RemoteBlob:
    """A driver store's placeholder for a result held on a node."""

    node_hex: str
    addr: str
    size: int


class NodeBusyError(Exception):
    """The node refused the lease at admission (it is full); the driver
    spills the task to another node."""


class NodeOverloadedError(Exception):
    """The node shed the lease (its admission cap or memory watermark):
    a deadline-armed task fails fast instead of spilling."""


class TaskDeadlineExpired(Exception):
    """The node found the task's deadline already past and ran
    nothing."""


def _exc_blob(exc: BaseException) -> bytes:
    import traceback

    tb = "".join(traceback.format_exception(type(exc), exc,
                                            exc.__traceback__))
    try:
        return serialization.serialize_framed((exc, tb))
    except Exception:  # noqa: BLE001 — an exception that cannot be pickled
        return serialization.serialize_framed(
            (RuntimeError(f"{type(exc).__name__}: {exc}"), tb))


# --------------------------------------------------------------------------
# The node's objects
# --------------------------------------------------------------------------


def _purge_stale_spills(spill_dir: str) -> None:
    """Delete the inline-spill files of daemons that died (the pid leads
    each file's name; a live pid's files stay)."""
    from ray_tpu_torch._private.same_host import pid_is_dead

    try:
        names = os.listdir(spill_dir)
    except OSError:
        return
    for name in names:
        pid_part = name.split("-", 1)[0]
        if not name.endswith(".blob") or not pid_part.isdigit() \
                or int(pid_part) == os.getpid():
            continue
        if pid_is_dead(int(pid_part)):
            try:
                os.unlink(os.path.join(spill_dir, name))
            except OSError:
                pass  # another sweeper won the unlink


class NodeObjectStore:
    """A daemon's store of framed blobs: task and actor results (primary
    copies, tagged with their owner, kept until the owner frees them or
    dies) and copies pulled from peers (a cache, evicted oldest first).

    Primary copies past ``node_store_primary_limit_mb`` go to disk. With
    the managed tier armed (``enable_managed_spill``, as the executor
    does under ``spill_enabled``) a spiller thread moves them, largest
    first, to checksummed ``RTS1`` files once usage passes the high
    watermark, and a read restores the file after checking it (a torn
    file drops the object: a reader sees it gone, never garbage). Off,
    a put past the cap writes the oldest primaries inline to
    ``node_store_spill_dir``. Pulled copies and protected ids
    (``leased_fn``) are never spilled.
    """

    def __init__(self, cache_limit_bytes: int = _PULL_CACHE_BYTES,
                 primary_limit_bytes: int | None = None,
                 spill_dir: str | None = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._lock = threading.Lock()
        self._blobs: dict[bytes, bytes] = {}  # insertion-ordered
        self._cached: dict[bytes, None] = {}  # pulled copies, FIFO
        self._cache_limit = cache_limit_bytes
        self._cache_bytes = 0
        self._primary_bytes = 0
        self._primary_limit = (
            primary_limit_bytes if primary_limit_bytes is not None
            else int(GLOBAL_CONFIG.node_store_primary_limit_mb) << 20)
        self._spill_dir = spill_dir or GLOBAL_CONFIG.node_store_spill_dir
        # id -> (path, size): primaries on disk, restored on a read.
        self._spilled: dict[bytes, tuple[str, int]] = {}
        # Which of them are managed-tier (RTS1) files.
        self._managed_spills: set[bytes] = set()
        self._spill_mgr = None
        self._spill_min_bytes = 0
        self._leased_fn = None
        self._on_spilled = None
        self._on_restored = None
        self._owner_of: dict[bytes, str] = {}
        self._owned_ids: dict[str, set[bytes]] = {}
        self.fetches_served = 0
        self.spills = 0
        self.restores = 0
        _purge_stale_spills(self._spill_dir)

    # ------------------------------------------------------ managed tier

    def enable_managed_spill(self, spill_dir: str | None = None,
                             leased_fn=None, on_spilled=None,
                             on_restored=None):
        """Arm the watermark spiller on this store (the inline path is
        then bypassed). ``leased_fn() -> ids`` never spilled;
        ``on_spilled(key, owner)`` and ``on_restored(key, owner)`` follow
        each move. Returns the SpillManager."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.spill_manager import SpillManager

        self._leased_fn = leased_fn
        self._on_spilled = on_spilled
        self._on_restored = on_restored
        self._spill_min_bytes = int(GLOBAL_CONFIG.spill_min_object_kb) * 1024
        self._spill_mgr = SpillManager(
            "node-store", self._primary_limit,
            usage_fn=lambda: self._primary_bytes,
            victims_fn=self._spill_victims,
            extract_fn=self._spill_extract,
            commit_fn=self._spill_commit, spill_dir=spill_dir)
        return self._spill_mgr

    def _spill_victims(self, need_bytes: int) -> list:
        """Primary copies covering ``need_bytes``, largest first (the
        fewest files free the most), oldest as the tiebreak; never a
        pulled copy, a protected id or one under ``spill_min_object_kb``."""
        leased: set = set()
        if self._leased_fn is not None:
            try:
                leased = set(self._leased_fn())
            except Exception:  # noqa: BLE001 — no filter beats no spill
                leased = set()
        with self._lock:
            cands = [(key, len(blob), age)
                     for age, (key, blob) in enumerate(self._blobs.items())
                     if key not in self._cached and key not in leased
                     and len(blob) >= self._spill_min_bytes]
        cands.sort(key=lambda c: (-c[1], c[2]))
        out, covered = [], 0
        for key, size, _age in cands:
            out.append(key)
            covered += size
            if covered >= need_bytes:
                break
        return out

    def _spill_extract(self, key: bytes):
        with self._lock:
            if key in self._cached:
                return None
            return self._blobs.get(key)

    def _spill_commit(self, key: bytes, path: str, size: int) -> bool:
        with self._lock:
            blob = self._blobs.get(key)
            if blob is None or key in self._cached or len(blob) != size:
                return False  # freed or sealed again since the extract
            del self._blobs[key]
            self._primary_bytes -= size
            self._spilled[key] = (path, size)
            self._managed_spills.add(key)
            self.spills += 1
            owner = self._owner_of.get(key)
        if self._on_spilled is not None:
            self._on_spilled(key, owner)
        return True

    def _restore_managed(self, key: bytes) -> bytes | None:
        """Restore a managed spill: check the file, make the blob the
        in-memory primary again and remove the file. A torn file drops
        the object (None: the reader sees it gone)."""
        from ray_tpu_torch._private.spill_manager import TornSpillError

        mgr = self._spill_mgr
        while True:
            with self._lock:
                blob = self._blobs.get(key)
                if blob is not None:
                    return blob
                entry = self._spilled.get(key)
                if entry is None:
                    return None  # freed, or dropped as torn, meanwhile
                path, size = entry
            try:
                payload = bytes(mgr.restore(key, path))
            except TornSpillError:
                with self._lock:
                    if self._spilled.get(key) == (path, size):
                        self._forget_locked(key)
                return None
            except OSError:
                continue  # another reader restored it and removed the file
            with self._lock:
                if self._spilled.get(key) != (path, size):
                    if key in self._blobs:
                        return self._blobs[key]  # another reader won
                    continue  # raced a free
                del self._spilled[key]
                self._managed_spills.discard(key)
                self._blobs[key] = payload
                self._primary_bytes += size
                self.restores += 1
                owner = self._owner_of.get(key)
            try:
                os.unlink(path)
            except OSError:
                pass  # the restored copy is safe; the file is tidy-up
            if self._on_restored is not None:
                self._on_restored(key, owner)
            # Back over the high watermark: another victim goes.
            mgr.notify()
            return payload

    # ------------------------------------------------------- inline path

    def _spill_one(self, id_bytes: bytes, blob: bytes) -> None:
        """Write one victim of the inline path; the blob stays readable
        in memory until its file has landed."""
        os.makedirs(self._spill_dir, exist_ok=True)
        # A file per attempt: two puts may pick the same victim.
        path = os.path.join(
            self._spill_dir,
            f"{os.getpid()}-{id_bytes.hex()}-{os.urandom(4).hex()}.blob")
        try:
            with open(path, "wb") as f:
                f.write(blob)
        except OSError:
            return  # disk full or unwritable: the blob stays in memory
        with self._lock:
            stale = self._blobs.get(id_bytes) is not blob
            if not stale:
                del self._blobs[id_bytes]
                self._primary_bytes -= len(blob)
                self._spilled[id_bytes] = (path, len(blob))
                self.spills += 1
        if stale:  # freed or sealed again during the write
            try:
                os.unlink(path)
            except OSError:
                pass  # already swept

    def _drop_spilled(self, id_bytes: bytes) -> None:
        # Caller holds self._lock.
        entry = self._spilled.pop(id_bytes, None)
        managed = id_bytes in self._managed_spills
        self._managed_spills.discard(id_bytes)
        if entry is None:
            return
        if managed and self._spill_mgr is not None:
            self._spill_mgr.delete_file(entry[0])
            return
        try:
            os.unlink(entry[0])
        except OSError:
            pass  # already gone

    # ------------------------------------------------------------- store

    def put(self, id_bytes: bytes, blob: bytes, cached: bool = False,
            owner: str | None = None, notify: bool = True) -> None:
        """Keep ``blob``. ``notify=False`` leaves the spiller asleep: the
        caller puts several (a task's returns) and then calls
        ``notify_spill()``, so one pass sees them all."""
        victims: list[tuple[bytes, bytes]] = []
        with self._lock:
            self._forget_locked(id_bytes)
            self._blobs[id_bytes] = blob
            if cached:
                self._cached[id_bytes] = None
                self._cache_bytes += len(blob)
                while self._cache_bytes > self._cache_limit \
                        and len(self._cached) > 1:
                    self._forget_locked(next(iter(self._cached)))
                return
            self._primary_bytes += len(blob)
            if owner is not None:
                self._owner_of[id_bytes] = owner
                self._owned_ids.setdefault(owner, set()).add(id_bytes)
            if self._spill_mgr is None:
                # Inline path: past the cap, the oldest primaries (never
                # the one just put) are picked here and written below.
                projected = self._primary_bytes
                for victim, vblob in self._blobs.items():
                    if projected <= self._primary_limit:
                        break
                    if victim in self._cached or victim == id_bytes:
                        continue
                    projected -= len(vblob)
                    victims.append((victim, vblob))
        for victim, vblob in victims:
            self._spill_one(victim, vblob)
        if notify:
            self.notify_spill()

    def notify_spill(self) -> None:
        """Wake the managed spiller if usage is over its high mark."""
        if self._spill_mgr is not None:
            self._spill_mgr.notify()

    def get(self, id_bytes: bytes) -> bytes | None:
        """The blob, restored from disk when it was spilled."""
        with self._lock:
            blob = self._blobs.get(id_bytes)
            spilled = self._spilled.get(id_bytes)
            managed = id_bytes in self._managed_spills
        if blob is not None or spilled is None:
            return blob
        if managed:
            return self._restore_managed(id_bytes)
        try:
            with open(spilled[0], "rb") as f:
                data = f.read()
        except OSError:
            return None
        with self._lock:
            self.restores += 1
        return data

    def _forget_locked(self, id_bytes: bytes) -> bool:
        existed = False
        blob = self._blobs.pop(id_bytes, None)
        if blob is not None:
            existed = True
            if id_bytes in self._cached:
                del self._cached[id_bytes]
                self._cache_bytes -= len(blob)
            else:
                self._primary_bytes -= len(blob)
        if id_bytes in self._spilled:
            existed = True
            self._drop_spilled(id_bytes)
        owner = self._owner_of.pop(id_bytes, None)
        if owner is not None:
            ids = self._owned_ids.get(owner)
            if ids is not None:
                ids.discard(id_bytes)
                if not ids:
                    del self._owned_ids[owner]
        return existed

    def free(self, ids: list[bytes]) -> int:
        with self._lock:
            return sum(1 for i in ids if self._forget_locked(i))

    def free_owner(self, owner: str) -> int:
        """Drop every primary copy a dead owner left here."""
        with self._lock:
            ids = list(self._owned_ids.get(owner, ()))
            return sum(1 for i in ids if self._forget_locked(i))

    def owners(self) -> list[str]:
        with self._lock:
            return list(self._owned_ids)

    def size(self, id_bytes: bytes) -> int | None:
        with self._lock:
            blob = self._blobs.get(id_bytes)
            if blob is not None:
                return len(blob)
            spilled = self._spilled.get(id_bytes)
            return None if spilled is None else spilled[1]

    def is_spilled(self, id_bytes: bytes) -> bool:
        """Whether the only copy here is on disk."""
        with self._lock:
            return id_bytes in self._spilled and id_bytes not in self._blobs

    def read_chunk(self, id_bytes: bytes, offset: int,
                   length: int) -> tuple[int, bytes] | None:
        with self._lock:
            blob = self._blobs.get(id_bytes)
            spilled = self._spilled.get(id_bytes)
            managed = id_bytes in self._managed_spills
            if blob is not None:
                self.fetches_served += 1
                # A view of a segment (a driver's export) ships as bytes.
                return len(blob), bytes(blob[offset:offset + length])
        if spilled is None:
            return None
        if managed:
            # The whole object is restored once (its CRC needs all of
            # it) and every chunk served from memory.
            blob = self._restore_managed(id_bytes)
            if blob is None:
                return None
            with self._lock:
                self.fetches_served += 1
            return len(blob), blob[offset:offset + length]
        path, size = spilled
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                chunk = f.read(length)
        except OSError:
            return None
        with self._lock:
            self.fetches_served += 1
            self.restores += 1
        return size, chunk

    def stats(self) -> dict:
        with self._lock:
            return {"num_blobs": len(self._blobs),
                    # Every blob held in memory, pulled copies included.
                    "bytes": sum(len(b) for b in self._blobs.values()),
                    "primary_bytes": self._primary_bytes,
                    "cached_bytes": self._cache_bytes,
                    "fetches_served": self.fetches_served,
                    "spilled_blobs": len(self._spilled),
                    "spilled_bytes": sum(size for _, size
                                         in self._spilled.values()),
                    "spills": self.spills, "restores": self.restores,
                    "owners": len(self._owned_ids)}


def _probe_peer(addr: str) -> bool:
    """Whether the RPC server at ``addr`` answers a ping."""
    client = RpcClient(addr, timeout_s=2.0, connect_timeout_s=1.0)
    try:
        return client.call("ping") == "pong"
    except Exception:  # noqa: BLE001 — unreachable
        return False
    finally:
        client.close()


def _close_borrowed(seg) -> None:
    """Close this process's mapping of a peer's segment (never unlink:
    the owner does)."""
    if seg is None:
        return
    try:
        seg.close()
    except (BufferError, OSError):
        pass  # a view still uses it: it goes with the process


class _PeerClients:
    """One multiplexed client per peer: a node's concurrent chunk
    fetches share one socket per pair."""

    def __init__(self):
        self._lock = threading.Lock()
        self._clients: dict[str, MuxRpcClient] = {}

    def get(self, addr: str) -> MuxRpcClient:
        with self._lock:
            client = self._clients.get(addr)
            if client is None:
                client = self._clients[addr] = MuxRpcClient(
                    addr, timeout_s=600.0)
            return client

    def close(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for client in clients:
            client.close()


def wrap_chunk_reply(reply: tuple):
    """A large chunk ships as a tail payload: its bytes cross without a
    pickle copy. A small one keeps the plain (total, bytes) shape."""
    total, chunk = reply
    if len(chunk) >= (1 << 16):
        return TailPayload(total, chunk)
    return total, bytes(chunk) if isinstance(chunk, memoryview) else chunk


def fetch_blob(client, id_bytes: bytes) -> bytes:
    """Pull one object in ``fetch_chunk_kb`` chunks; on a multiplexed
    client up to ``rpc_pipeline_depth`` chunk requests are in flight, so
    the rate is not one round trip per chunk."""
    chunk_bytes = _fetch_chunk_bytes()
    first = client.call("fetch_object", id_bytes, 0, chunk_bytes)
    if first is None:
        raise KeyError(f"object {id_bytes.hex()} not present on "
                       f"{client.address}")
    total, chunk = first
    if len(chunk) >= total:
        return bytes(chunk)
    buf = bytearray(total)
    buf[:len(chunk)] = chunk
    call_async = getattr(client, "call_async", None)
    pending: collections.deque = collections.deque()
    depth = _pipeline_depth() if call_async is not None else 1
    next_off = len(chunk)
    while next_off < total or pending:
        while next_off < total and len(pending) < depth:
            if call_async is not None:
                pending.append((next_off, call_async(
                    "fetch_object", id_bytes, next_off, chunk_bytes)))
            else:
                pending.append((next_off, client.call(
                    "fetch_object", id_bytes, next_off, chunk_bytes)))
            next_off += chunk_bytes
        off, slot = pending.popleft()
        reply = slot.result() if call_async is not None else slot
        if reply is None:
            raise KeyError(f"object {id_bytes.hex()} vanished from "
                           f"{client.address}")
        buf[off:off + len(reply[1])] = reply[1]
    return bytes(buf)


class ChunkDirectory:
    """The holders of the objects a node (or a driver's export store)
    owns: a puller registers when it starts and is handed the holders
    before it, so later pullers spread their chunk requests over peers
    instead of queueing on the owner."""

    TTL_S = 180.0

    def __init__(self):
        self._lock = threading.Lock()
        # id -> {holder address -> when it registered}
        self._holders: dict[bytes, dict[str, float]] = {}

    def register(self, id_bytes: bytes, addr: str | None) -> list[str]:
        """Record ``addr`` as a (partial) holder; the other holders,
        oldest first."""
        now = time.monotonic()
        with self._lock:
            table = self._holders.setdefault(id_bytes, {})
            for holder, seen in list(table.items()):
                if now - seen > self.TTL_S:
                    del table[holder]
            others = [a for a in table if a != addr]
            if addr:
                table.setdefault(addr, now)
            return others

    def drop(self, ids: list[bytes]) -> None:
        with self._lock:
            for id_bytes in ids:
                self._holders.pop(id_bytes, None)

    def prune(self) -> None:
        now = time.monotonic()
        with self._lock:
            for id_bytes in list(self._holders):
                table = self._holders[id_bytes]
                for holder, seen in list(table.items()):
                    if now - seen > self.TTL_S:
                        del table[holder]
                if not table:
                    del self._holders[id_bytes]


def plan_holders(directory: ChunkDirectory, id_bytes: bytes,
                 puller_addr: str | None, total: int) -> list[str]:
    """The holder half of a fetch plan: only objects large enough for
    pullers to take the peer path register them."""
    chunk = _fetch_chunk_bytes()
    n_chunks = -(-total // chunk) if total else 0
    if n_chunks < _MIN_P2P_CHUNKS:
        return []
    return directory.register(id_bytes, puller_addr)


class _PartialBlob:
    """A pull in progress (or just finished) whose chunks are already
    served to peers: a receiver relays what it has, so a broadcast scales
    with its receivers and not with the owner's socket."""

    __slots__ = ("total", "chunk", "buf", "have", "lock", "done", "error",
                 "completed_at")

    def __init__(self, total: int, chunk: int):
        self.total = total
        self.chunk = chunk
        self.buf = bytearray(total)
        self.have: set[int] = set()
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.completed_at: float | None = None

    def n_chunks(self) -> int:
        return -(-self.total // self.chunk) if self.total else 0

    def write(self, index: int, data) -> None:
        off = index * self.chunk
        with self.lock:
            self.buf[off:off + len(data)] = data
            self.have.add(index)

    def read_chunk(self, offset: int, length: int):
        """A range iff every chunk it covers is here, else None."""
        if offset >= self.total:
            return (self.total, b"")
        end = min(offset + length, self.total)
        first, last = offset // self.chunk, (end - 1) // self.chunk
        with self.lock:
            if any(i not in self.have for i in range(first, last + 1)):
                return None
            return (self.total, bytes(self.buf[offset:end]))

    def finish(self) -> bytes:
        with self.lock:
            blob = bytes(self.buf)
        self.completed_at = time.monotonic()
        self.done.set()
        return blob

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.done.set()


# --------------------------------------------------------------------------
# Actors on the node
# --------------------------------------------------------------------------


class _PipelineInflight:
    """The order of each pipelined lease's frames, for parking: when the
    task at a lease's head blocks in a nested get(), the frames queued
    behind it are sent but not running, so their CPU goes back (here
    through task_block, at the driver through a streamed "parked" part),
    or a nested child that needs that CPU would wait on tasks that
    cannot start until the head resumes."""

    def __init__(self, service: "NodeExecutorService"):
        self._service = service
        self._lock = threading.Lock()
        self._leases: dict = {}        # lease key -> [token, ...]
        self._token_lease: dict = {}   # token -> lease key
        self._parked: set = set()
        # token -> notify(kind, token): streams a control part to the
        # driver that owns the token (installed per batch RPC).
        self._notify: dict = {}

    def register_notify(self, tokens, notify) -> None:
        with self._lock:
            for token in tokens:
                self._notify[token] = notify

    def forget_notify(self, tokens) -> None:
        with self._lock:
            for token in tokens:
                self._notify.pop(token, None)

    def sent(self, key, token) -> None:
        with self._lock:
            self._leases.setdefault(key, []).append(token)
            self._token_lease[token] = key
        # The frame is in a worker's pipe: from here on the task may have
        # started, and a death of this daemon retries it under the
        # system-failure budget instead of requeueing it unseen.
        self._fire(token, "started")

    def done(self, key, token) -> None:
        resumed = None
        with self._lock:
            order = self._leases.get(key)
            if order is None:
                return
            try:
                order.remove(token)
            except ValueError:
                pass
            self._token_lease.pop(token, None)
            self._parked.discard(token)
            if not order:
                self._leases.pop(key, None)
            elif order[0] in self._parked:
                # The next frame starts the moment this reply is written.
                resumed = order[0]
                self._parked.discard(resumed)
        if resumed is not None:
            self._service.task_unblock(resumed)
            self._fire(resumed, "resumed")

    def drop_lease(self, key) -> None:
        """The lease died: unpark what it held (the unstarted frames are
        requeued and tracked again on a new lease)."""
        with self._lock:
            order = self._leases.pop(key, [])
            parked = [t for t in order if t in self._parked]
            for token in order:
                self._token_lease.pop(token, None)
                self._parked.discard(token)
        for token in parked:
            self._service.task_unblock(token)
            self._fire(token, "resumed")

    def on_block(self, token) -> None:
        """A running task blocked in a nested get(): park every frame
        queued behind it on its lease."""
        with self._lock:
            key = self._token_lease.get(token)
            order = self._leases.get(key) if key is not None else None
            if not order or order[0] != token:
                return
            parked = [t for t in order[1:] if t not in self._parked]
            self._parked.update(parked)
        for queued in parked:
            self._service.task_block(queued)
            self._fire(queued, "parked")

    def _fire(self, token, kind: str) -> None:
        with self._lock:
            notify = self._notify.get(token)
        if notify is not None:
            try:
                notify(kind, token)
            except Exception:  # noqa: BLE001 — the stream is gone
                pass


class _ActorNewError(Exception):
    """The actor's constructor raised; carries the (exception,
    traceback) blob from its process."""

    def __init__(self, blob: bytes):
        super().__init__("actor constructor failed")
        self.blob = blob


class _MuxPipe:
    """Calls multiplexed over an actor process's pipe (``max_concurrency
    > 1``): each carries an id, a reader thread matches the replies, and
    up to ``max_concurrency`` run in the actor at once. ``engine_stats``:
    the actor process's LLM-engine counters as its last reply carried
    them (None while it hosts no engine)."""

    def __init__(self, conn):
        import queue

        self._queue_mod = queue
        self._conn = conn
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: dict[int, Any] = {}
        self._next_id = 0
        self._closed = False
        self.engine_stats: dict | None = None
        threading.Thread(target=self._reader, daemon=True,
                         name="ray_tpu_torch-daemon-actor-mux").start()

    def call(self, method: str, args_blob: bytes, n_returns: int) -> tuple:
        from ray_tpu_torch.exceptions import WorkerCrashedError

        slot = self._queue_mod.SimpleQueue()
        with self._lock:
            if self._closed:
                raise WorkerCrashedError("actor process died")
            self._next_id += 1
            call_id = self._next_id
            self._pending[call_id] = slot
        try:
            with self._send_lock:
                self._conn.send(("actor_call", call_id, method, args_blob,
                                 n_returns))
        except (OSError, ValueError) as exc:
            with self._lock:
                self._pending.pop(call_id, None)
            raise WorkerCrashedError(
                f"actor pipe broken: {exc!r}") from exc
        result = slot.get()
        if result is None:
            raise WorkerCrashedError(
                "actor process died with the call in flight")
        return result

    def _reader(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                break
            if msg[0] != "reply":
                continue
            _, call_id, status, payload, self.engine_stats = msg
            with self._lock:
                slot = self._pending.pop(call_id, None)
            if slot is not None:
                slot.put((status, payload))
        with self._lock:
            self._closed = True
            stranded = list(self._pending.values())
            self._pending.clear()
        for slot in stranded:
            slot.put(None)


class _DaemonActor:
    """An actor on this node: a worker process of its own, driven over
    its pipe. ``gpu_ids``: the cards of its lease; such an actor boots a
    fresh interpreter that sees only them (never a fork)."""

    def __init__(self, cls_blob: bytes, args_blob: bytes,
                 runtime_env: dict | None, max_concurrency: int,
                 extra_env: dict | None, gpu_ids: list[int] | None,
                 worker=None):
        from ray_tpu_torch._private.worker_pool import PoolWorker

        self.max_concurrency = max(1, int(max_concurrency or 1))
        self.owner: str | None = None  # the creating driver's endpoint
        self._worker = worker if worker is not None else PoolWorker(
            -1, extra_env=extra_env, gpu_ids=gpu_ids)
        self._mux = None
        reply = self._worker.request(
            ("actor_new", cls_blob, args_blob, runtime_env,
             self.max_concurrency, {}))
        if reply[0] == "err":
            self._worker.stop()
            raise _ActorNewError(reply[1])
        if self.max_concurrency > 1:
            self._mux = _MuxPipe(self._worker.conn)

    @property
    def pid(self) -> int:
        return self._worker.proc.pid

    def alive(self) -> bool:
        return self._worker.alive()

    def call(self, method: str, args_blob: bytes, n_returns: int) -> tuple:
        """("ok", packed results) | ("err", blob); raises
        WorkerCrashedError when the process dies."""
        if self._mux is not None:
            return self._mux.call(method, args_blob, n_returns)
        return self._worker.request(
            ("actor_call", method, args_blob, n_returns))

    def kill(self) -> None:
        self._worker.stop()


# --------------------------------------------------------------------------
# The service
# --------------------------------------------------------------------------


class NodeExecutorService:
    """A daemon's execution plane: admission, the worker pool, the
    actors, the object store and the RPC surface."""

    # Pulled arguments kept in shared memory for pool tasks (FIFO).
    _SHM_ARGS_MAX_BYTES = 2 << 30

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 pool_size: int | None = None,
                 resources: dict[str, float] | None = None):
        from ray_tpu_torch._private.shm_store import ShmClient, ShmDirectory
        from ray_tpu_torch._private.worker_pool import WorkerPool

        from ray_tpu_torch._private.node_store_native import make_node_store

        self._server = RpcServer(host, port)
        self.store = make_node_store()
        # The store's spill tier: armed under spill_enabled. Its spilled
        # and restored events, (owner, object hex, kind), wait here for
        # the next heartbeat, which carries them to the head's directory.
        from ray_tpu_torch._private import spill_manager

        self._spill_mgr = None
        self._spill_events: list = []
        self._spill_events_lock = threading.Lock()
        # Pulls whose plan said the holder's copy was on disk.
        self.spilled_plan_hits = 0
        # key -> when its segment last went to a pool task: the blob is
        # not spilled while the task may still be attaching.
        self._shm_out_stamp: dict[bytes, float] = {}
        if spill_manager.SPILL_ON:
            self._spill_mgr = self.store.enable_managed_spill(
                leased_fn=self._spill_protected,
                on_spilled=self._on_blob_spilled,
                on_restored=self._on_blob_restored)
            # Admission's pressure classifier counts this store's
            # resident bytes as relievable.
            from ray_tpu_torch._private.memory_monitor import (
                set_store_bytes_provider,
            )

            set_store_bytes_provider(lambda: self.store._primary_bytes)
        self._peers = _PeerClients()
        self._partials: dict[bytes, _PartialBlob] = {}
        self._partials_lock = threading.Lock()
        self.chunk_directory = ChunkDirectory()
        self.advertised_address = self._server.address
        # The same-host plane: pullers on this host map this daemon's
        # segments under a lease instead of pulling chunks.
        from ray_tpu_torch._private.same_host import LeaseTable, host_identity

        self.host_id = host_identity()
        self.leases = LeaseTable()  # the owner's side: peers' pins
        # key -> ("seg", segment name, size): the objects this daemon
        # serves to pullers on its host by name (its own segments only).
        self._map_sources: dict[bytes, tuple] = {}
        # The puller's side: key -> (owner address, lease token, segment)
        # of a peer's segment handed to pool tasks.
        self._attached: dict[bytes, tuple] = {}
        self._attached_owner_strikes: dict[str, int] = {}
        self.lease_orphans_swept = 0
        # The drivers' arenas this daemon reads (attached at first use),
        # and the dead owners' arenas its sweep unlinked.
        from ray_tpu_torch._private.same_host import PeerArenaRegistry

        self._peer_arenas = PeerArenaRegistry()
        self.arena_orphans_swept = 0
        self.peer_arenas_detached = 0
        # How pulls went: a peer's segment mapped for a pool task, one
        # copy out of a peer's segment, the chunked pull.
        self.same_host_map_hits = 0
        self.same_host_copy_hits = 0
        self.chunked_pulls = 0
        # Bytes pulled in chunks and the seconds those pulls took; bytes
        # copied out of peers' segments and the seconds those reads took
        # (the plan, the lease, the attach and the copy).
        self.pulled_bytes = 0
        self.pull_seconds = 0.0
        self.same_host_bytes = 0
        self.same_host_seconds = 0.0
        self.peer_blacklists = 0
        self.relay_chunks_served = 0
        self.task_timeouts = 0
        self.admission_shed = 0
        self._resources = {k: float(v) for k, v in
                           (resources or {}).items()}
        self.cards = CardLedger.for_count(self._resources.get("GPU", 0.0))
        self._running_lock = threading.Lock()
        # token -> (demand, card shares)
        self._running: dict[str, tuple[dict, dict]] = {}
        # token -> the CPU a task blocked in a nested get() gave back.
        self._blocked_cpu: dict[str, float] = {}
        self._func_cache: dict[str, Callable] = {}
        self._func_lock = threading.Lock()
        # need_func retries find their arguments here, by nonce.
        self._stashed_args: dict[str, bytes] = {}
        self._driver_sys_path: list[str] = []
        self.tasks_executed = 0
        # The batch RPCs' function blobs by digest: forwarded to pool
        # workers as they came (this process never loads them unless an
        # entry fuses).
        self._func_blob_cache: dict[str, bytes] = {}
        # The pipelined path: each lease's frame order (parking) and its
        # counters: batch RPCs served, entries they carried, completion
        # groups streamed, fused runs, fused tasks and fused entries
        # that went to the worker path when a run's budget ran out.
        self._pipeline_inflight = _PipelineInflight(self)
        self.batch_rpcs = 0
        self.batch_tasks_received = 0
        self.reply_groups = 0
        self.fused_runs = 0
        self.fused_tasks = 0
        self.fused_fallbacks = 0
        self._fused_lock = threading.Lock()
        # Long-lived runner threads drive the batches' worker leases.
        from ray_tpu_torch._private.rpc import _ThreadRecycler

        self._batch_runners = _ThreadRecycler(
            "ray_tpu_torch-batch-runner", idle_s=30.0)
        self._factory_warmed = False
        self._cancel_lock = threading.Lock()
        self._cancelled_tokens: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._load_listener: Callable[[], None] | None = None
        self._actors: dict[bytes, _DaemonActor] = {}
        self._actors_lock = threading.Lock()
        # Keys whose constructor is running: a call declaring
        # awaiting_create waits here instead of bouncing "gone".
        self._actors_creating: set[bytes] = set()
        self._actors_creating_cond = threading.Condition(self._actors_lock)
        # Prestarted CPU actor processes, keyed by their spawn env.
        self._standby: dict[tuple, list] = {}
        self._standby_lock = threading.Lock()
        self._standby_refilling: set[tuple] = set()
        self._standby_target = 2
        self._stop_event = threading.Event()
        self._sweep_thread: threading.Thread | None = None
        self._shm_args_lock = threading.Lock()
        self._shm_args_order: collections.OrderedDict = \
            collections.OrderedDict()
        if pool_size is None:
            pool_size = max(1, min(int(self._resources.get(
                "CPU", os.cpu_count() or 1)), 16))
        self._shm_directory = ShmDirectory()
        self._shm_client = ShmClient()
        self.pool = WorkerPool(pool_size, self._shm_directory,
                               self._shm_client)

        s = self._server
        s.register("ping", lambda: "pong")
        s.register("exec_ping", os.getpid)
        # One multiplexed connection carries all of a driver's work in
        # flight: the long-running methods run off its thread.
        s.register("execute_task", self.execute_task, concurrent=True)
        s.register("execute_task_batch", self.execute_task_batch,
                   concurrent=True, streaming=True)
        s.register("fetch_object", self.fetch_object, concurrent=True)
        s.register("fetch_plan", self.fetch_plan, concurrent=True)
        s.register("unpin_object", self.unpin_object)
        s.register("free_objects", self.free_objects)
        s.register("executor_stats", self.executor_stats)
        s.register("cancel_task", self.cancel_task)
        s.register("task_block", self.task_block)
        s.register("task_unblock", self.task_unblock)
        s.register("adopt_sys_path", self.adopt_sys_path)
        s.register("create_actor", self.create_actor, concurrent=True)
        s.register("actor_call", self.actor_call, concurrent=True)
        s.register("actor_kill", self.actor_kill)

    @property
    def port(self) -> int:
        return self._server.port

    def address_for(self, host: str) -> str:
        return f"{host}:{self._server.port}"

    def start(self) -> "NodeExecutorService":
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._server.start()
        # A node sweeps the results and actors of a driver whose endpoint
        # stayed unreachable for owner_dead_grace_s.
        period_ms = int(GLOBAL_CONFIG.owner_sweep_period_ms or 0)
        if period_ms > 0:
            self._sweep_thread = threading.Thread(
                target=self._owner_sweep_loop,
                args=(period_ms / 1000.0,
                      float(GLOBAL_CONFIG.owner_dead_grace_s)),
                daemon=True, name="ray_tpu_torch-owner-sweep")
            self._sweep_thread.start()
        return self

    def _owner_sweep_loop(self, period_s: float, grace_s: float) -> None:
        """Owner-death collection: a driver whose endpoint stays
        unreachable past the grace period has crashed, so its results
        and its actors here go (they would pin the node forever).
        Unreachable means every probe failed for the whole grace."""
        from concurrent.futures import ThreadPoolExecutor

        fail_since: dict[str, float] = {}
        while not self._stop_event.wait(period_s):
            self._sweep_transfer_plane()
            with self._actors_lock:
                actor_owners = {a.owner for a in self._actors.values()
                                if a.owner}
            owners = set(self.store.owners()) | actor_owners
            if not owners:
                fail_since.clear()
                continue

            def probe(owner: str) -> bool:
                client = RpcClient(owner, timeout_s=3.0,
                                   connect_timeout_s=2.0)
                try:
                    return client.call("ping") == "pong"
                except Exception:  # noqa: BLE001 — unreachable
                    return False
                finally:
                    client.close()

            with ThreadPoolExecutor(max_workers=min(8, len(owners))) as tpe:
                results = dict(zip(owners, tpe.map(probe, owners)))
            now = time.monotonic()
            for owner, alive in results.items():
                if alive:
                    fail_since.pop(owner, None)
                    continue
                if now - fail_since.setdefault(owner, now) <= grace_s:
                    continue
                freed = self.store.free_owner(owner)
                with self._actors_lock:
                    dead_keys = [k for k, a in self._actors.items()
                                 if a.owner == owner]
                for key in dead_keys:
                    self._reap_actor(key)
                fail_since.pop(owner, None)
                logger.warning("owner %s unreachable for %.0fs: swept %d "
                               "objects and %d actors", owner, grace_s,
                               freed, len(dead_keys))
            for owner in [o for o in fail_since if o not in owners]:
                del fail_since[owner]

    def _sweep_transfer_plane(self) -> None:
        """Drop finished relay copies past their TTL and stale holder
        registrations; end the map leases that outlived the TTL and whose
        puller stopped answering (a killed puller must not pin this
        daemon's segments forever); drop the peers' segments this daemon
        holds for pool tasks once their owner failed two probes in a row
        (its lease went with it)."""
        from ray_tpu_torch._private.same_host import pin_ttl_s

        now = time.monotonic()
        with self._partials_lock:
            for key in [k for k, p in self._partials.items()
                        if p.done.is_set() and (
                            p.error is not None or p.completed_at is None
                            or now - p.completed_at > ChunkDirectory.TTL_S)]:
                del self._partials[key]
        self.chunk_directory.prune()
        self.leases.sweep(pin_ttl_s(), _probe_peer)
        with self._shm_args_lock:
            owners = {addr for addr, _, _ in self._attached.values()}
        for addr in owners:
            if _probe_peer(addr):
                self._attached_owner_strikes.pop(addr, None)
                continue
            strikes = self._attached_owner_strikes.get(addr, 0) + 1
            self._attached_owner_strikes[addr] = strikes
            if strikes < 2:
                continue
            self._attached_owner_strikes.pop(addr, None)
            with self._shm_args_lock:
                victims = [k for k, (a, _, _) in self._attached.items()
                           if a == addr]
            for key in victims:
                self._drop_shm_arg(key)
                self.lease_orphans_swept += 1
        # The arenas of co-hosted owners killed without a destroy have no
        # other unlinker, and this daemon's mappings of dead owners'
        # arenas would keep their pages.
        from ray_tpu_torch._private.same_host import sweep_orphan_shm

        self.arena_orphans_swept += sweep_orphan_shm()
        self.peer_arenas_detached += self._peer_arenas.close_dead_owners()

    def stop(self) -> None:
        self._stop_event.set()
        self._server.stop()
        # The same-host plane: the peers' leases on this daemon's
        # segments end, and the peers' segments it holds are let go,
        # before the directories unwind.
        self.leases.clear()
        with self._shm_args_lock:
            attached = list(self._attached.values())
            self._attached.clear()
            self._map_sources.clear()
        for owner_addr, token, seg in attached:
            _close_borrowed(seg)
            self._unpin_at(owner_addr, token)
        if self._spill_mgr is not None:
            import shutil

            from ray_tpu_torch._private import spill_manager

            self._spill_mgr.stop()
            if spill_manager.live_manager_count() == 0:
                shutil.rmtree(self._spill_mgr.spill_dir,
                              ignore_errors=True)
        with self._actors_lock:
            actors = list(self._actors.values())
            self._actors.clear()
        for actor in actors:
            actor.kill()
        with self._standby_lock:
            standby = [w for pool in self._standby.values() for w in pool]
            self._standby.clear()
        for worker in standby:
            worker.stop()
        self.pool.shutdown()
        self._peers.close()
        self._shm_client.close_all()
        self._shm_directory.shutdown()
        self._peer_arenas.close_all()

    # ------------------------------------------------------------ admission

    def set_load_listener(self, listener: Callable[[], None]) -> None:
        """``listener()`` runs whenever admission changes what is free
        (the node agent pushes a heartbeat then)."""
        self._load_listener = listener

    def _notify_load(self) -> None:
        listener = self._load_listener
        if listener is not None:
            try:
                listener()
            except Exception:  # noqa: BLE001 — the push is best-effort
                pass

    # How long a pool task's argument segment is protected from the
    # spiller after it went out.
    _SHM_ARG_GRACE_S = 10.0

    def _spill_protected(self) -> set:
        """Ids the spiller skips: those a same-host peer holds a lease on,
        and those whose segment went to a pool task within the grace
        window."""
        out = self.leases.pinned_ids()
        now = time.monotonic()
        with self._shm_args_lock:
            for key in [k for k, at in self._shm_out_stamp.items()
                        if now - at > self._SHM_ARG_GRACE_S]:
                del self._shm_out_stamp[key]
            out.update(self._shm_out_stamp)
        return out

    def _on_blob_spilled(self, key: bytes, owner: str | None) -> None:
        """A primary went to disk: it is no longer a map source, and its
        segment twin goes too, unless a pool task took it within the
        grace window (the victims were chosen before; the task may still
        be attaching). The event waits for the next heartbeat."""
        with self._shm_args_lock:
            self._map_sources.pop(key, None)
        if key not in self._spill_protected():
            self._drop_shm_arg(key)
        self._queue_spill_event(owner, key, "spilled")

    def _on_blob_restored(self, key: bytes, owner: str | None) -> None:
        self._queue_spill_event(owner, key, "restored")

    def _queue_spill_event(self, owner: str | None, key: bytes,
                           kind: str) -> None:
        if owner:
            with self._spill_events_lock:
                self._spill_events.append((owner, key.hex(), kind))
                del self._spill_events[:-4096]  # bounded

    def _drain_spill_events(self) -> list:
        with self._spill_events_lock:
            out, self._spill_events = self._spill_events, []
        return out

    def _spill_stats(self) -> dict:
        from ray_tpu_torch._private.spill_manager import merged_stats

        stats = merged_stats(self._spill_mgr)
        stats["spilled_plan_hits"] = self.spilled_plan_hits
        # The seconds of the spills and restores behind those bytes (the
        # first 512 of each), for their rates.
        timings = self._spill_mgr.timings() if self._spill_mgr else {}
        for kind in ("spill", "restore"):
            rows = timings.get(kind, ())
            stats[f"{kind}_timed_bytes"] = sum(b for b, _ in rows)
            stats[f"{kind}_seconds"] = sum(t for _, t in rows)
        return stats

    def _overload_reason(self) -> "str | None":
        """Why admission sheds now: the reservation depth over
        ``admission_max_queue_depth`` or memory over
        ``admission_memory_watermark`` (both 0: off). With the spill tier
        armed, pressure from this store's bytes kicks the spiller and
        admits, unless the disk is full (the tier backs off): then it
        sheds like host pressure."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        cap = int(GLOBAL_CONFIG.admission_max_queue_depth or 0)
        if cap > 0:
            with self._running_lock:
                depth = len(self._running)
            if depth >= cap:
                return f"admitted reservations at admission_max_queue_" \
                       f"depth={cap}"
        watermark = float(GLOBAL_CONFIG.admission_memory_watermark or 0)
        if watermark > 0:
            from ray_tpu_torch._private.memory_monitor import (
                memory_pressure_kind,
                memory_watermark_exceeded,
            )

            if self._spill_mgr is not None:
                kind = memory_pressure_kind(watermark)
                if kind == "store":
                    if self._spill_mgr.backing_off():
                        return (f"store memory over admission_memory_"
                                f"watermark={watermark} and the spill "
                                f"disk is full (backing off)")
                    self._spill_mgr.request_spill()
                elif kind == "host":
                    return f"host memory over admission_memory_" \
                           f"watermark={watermark}"
            elif memory_watermark_exceeded(watermark):
                return f"host memory over admission_memory_watermark=" \
                       f"{watermark}"
        return None

    def _try_reserve(self, token: str, demand: dict) -> "dict | None":
        """Reserve ``demand`` under ``token`` in the same lock pass as the
        capacity check: the card shares of its ``GPU``, or None when it
        does not fit."""
        with self._running_lock:
            for key, cap in self._resources.items():
                used = sum(float(d.get(key, 0.0))
                           for d, _ in self._running.values())
                if used + float(demand.get(key, 0.0)) > cap + 1e-9:
                    return None
            if any(float(v) > 0 and k not in self._resources
                   for k, v in demand.items()):
                return None
            shares = self.cards.pick(float(demand.get("GPU", 0.0)))
            if shares is None:
                return None
            self.cards.take(shares)
            self._running[token] = (dict(demand), shares)
        self._notify_load()
        return shares

    def _release(self, token: str) -> None:
        with self._running_lock:
            entry = self._running.pop(token, None)
            self._blocked_cpu.pop(token, None)
            if entry is not None:
                self.cards.give(entry[1])
        self._notify_load()

    def available_resources(self) -> dict[str, float]:
        """Total minus what is reserved: the heartbeat's availability."""
        avail = dict(self._resources)
        with self._running_lock:
            for demand, _ in self._running.values():
                for key, value in demand.items():
                    avail[key] = avail.get(key, 0.0) - value
        return avail

    def cancel_task(self, token: str) -> bool:
        """Flag ``token``: an execution that has not reached its function
        yet refuses with ("cancelled",)."""
        with self._cancel_lock:
            self._cancelled_tokens[token] = True
            while len(self._cancelled_tokens) > 4096:
                self._cancelled_tokens.popitem(last=False)
        return True

    def _token_cancelled(self, token: str | None) -> bool:
        if token is None:
            return False
        with self._cancel_lock:
            return self._cancelled_tokens.pop(token, None) is not None

    def task_block(self, token: str) -> bool:
        """A task here blocked in a nested get(): give its CPU back to
        admission, so the work it waits for can land on this node."""
        with self._running_lock:
            entry = self._running.get(token)
            if entry is None or token in self._blocked_cpu:
                return False
            demand, shares = entry
            cpu = float(demand.get("CPU", 0.0))
            if cpu <= 0:
                return False
            self._blocked_cpu[token] = cpu
            self._running[token] = ({**demand, "CPU": 0.0}, shares)
        self._notify_load()
        # A pipelined lease's head blocked: the frames behind it hold CPU
        # without running, so they are parked too.
        self._pipeline_inflight.on_block(token)
        return True

    def task_unblock(self, token: str) -> bool:
        """The blocked task resumed: take its CPU again (this may
        overcommit for a moment; new work is still checked)."""
        with self._running_lock:
            cpu = self._blocked_cpu.pop(token, None)
            entry = self._running.get(token)
            if cpu is None or entry is None:
                return False
            demand, shares = entry
            self._running[token] = (
                {**demand, "CPU": demand.get("CPU", 0.0) + cpu}, shares)
        self._notify_load()
        return True

    # ---------------------------------------------------------------- tasks

    def execute_task(self, digest: str, func_blob: bytes | None,
                     args_blob: bytes | None, n_returns: int,
                     return_keys: list[bytes],
                     runtime_env: dict | None = None,
                     resources: dict | None = None,
                     task_token: str | None = None,
                     client_addr: str | None = None,
                     args_ref: str | None = None,
                     deadline: float | None = None) -> tuple:
        """Run one task. Replies ("ok", [("inline", blob) | ("stored",
        size) | ("err", blob) per return]), ("err", blob), ("busy",)
        when it does not fit, ("overloaded", why) when admission sheds,
        ("timeout", stage) when its deadline is past, ("cancelled",), or
        ("need_func", nonce) when this node does not know the digest yet
        (the arguments wait under the nonce, so the retry ships the
        function alone)."""
        demand = {k: float(v) for k, v in (resources or {}).items()}
        demand.setdefault("CPU", 1.0)
        token = task_token or f"exec-{digest[:8]}-{os.urandom(4).hex()}"
        if args_blob is None and args_ref is not None:
            with self._func_lock:
                args_blob = self._stashed_args.pop(args_ref, None)
            if args_blob is None:
                return ("stale_args",)
        if deadline is not None and time.time() > deadline:
            self.task_timeouts += 1
            return ("timeout", "admitted")
        shed = self._overload_reason()
        if shed is not None:
            self.admission_shed += 1
            return ("overloaded", shed)
        shares = self._try_reserve(token, demand)
        if shares is None:
            return ("busy",)
        t_admit = time.time()
        try:
            if self._token_cancelled(task_token):
                return ("cancelled",)
            with self._func_lock:
                func = self._func_cache.get(digest)
            if func is None:
                if func_blob is None:
                    return self._stash_args(args_blob)
                try:
                    func = serialization.loads_function(func_blob)
                except BaseException as exc:  # noqa: BLE001 — to the driver
                    return ("err", _exc_blob(exc))
                with self._func_lock:
                    self._func_cache[digest] = func
                    # A batch entry of this digest comes without it.
                    self._func_blob_cache[digest] = func_blob
            args, kwargs = serialization.deserialize_from_buffer(
                memoryview(args_blob))
            on_card = demand.get("GPU", 0.0) > 0
            args, kwargs = self._resolve_fetch_args(args, kwargs,
                                                    to_shm=not on_card)
            from ray_tpu_torch._private.runtime_env_packaging import (
                resolve_runtime_env,
            )

            values = self._run(func, digest, func_blob, args, kwargs,
                               n_returns, resolve_runtime_env(runtime_env),
                               on_card, shares, token, client_addr, t_admit)
        except BaseException as exc:  # noqa: BLE001 — shipped to the driver
            return ("err", _exc_blob(exc))
        finally:
            self._release(token)
        self.tasks_executed += 1
        entries = [self._reply_entry(key, value, client_addr)
                   for key, value in zip(return_keys, values)]
        self.store.notify_spill()
        return ("ok", entries)

    def _stash_args(self, args_blob: bytes) -> tuple:
        """Keep the arguments of a task whose function must be resent;
        bounded by entries and bytes."""
        nonce = os.urandom(8).hex()
        with self._func_lock:
            self._stashed_args[nonce] = args_blob
            total = sum(len(b) for b in self._stashed_args.values())
            while self._stashed_args and (len(self._stashed_args) > 256
                                          or total > 256 * 1024 * 1024):
                victim = next(iter(self._stashed_args))
                total -= len(self._stashed_args.pop(victim))
        return ("need_func", nonce)

    def _reply_entry(self, id_bytes: bytes, value: Any,
                     owner: str | None) -> tuple:
        """One result in the reply: inline when small, else kept here and
        pulled by whoever reads it."""
        try:
            blob = serialization.serialize_framed(value)
        except BaseException as exc:  # noqa: BLE001 — this return failed
            return ("err", _exc_blob(exc))
        return self._blob_entry(id_bytes, blob, owner)

    def _blob_entry(self, id_bytes: bytes, blob: bytes,
                    owner: str | None) -> tuple:
        """The caller wakes the spiller once all of a call's returns are
        in (largest first is then taken over all of them)."""
        if len(blob) <= _inline_reply_bytes():
            return ("inline", blob)
        self.store.put(id_bytes, blob, owner=owner, notify=False)
        self._maybe_export_stored(id_bytes, blob)
        return ("stored", len(blob))

    def _maybe_export_stored(self, id_bytes: bytes, blob) -> None:
        """Give a large stored primary a named-segment twin, so pullers
        on this host (peer daemons, the driver) map it instead of pulling
        chunks: one copy here saves one per puller. The twin is a pool
        task's argument segment too, and the shm-args FIFO bounds it."""
        from multiprocessing import shared_memory

        from ray_tpu_torch._private.same_host import map_enabled, map_min_bytes

        if not map_enabled() or len(blob) < map_min_bytes():
            return
        with self._shm_args_lock:
            if self._shm_directory.lookup(ObjectID(id_bytes)) is not None:
                return
        try:
            seg = shared_memory.SharedMemory(create=True,
                                             size=max(len(blob), 1))
        except OSError:
            return  # /dev/shm is full: the chunked pull still serves it
        seg.buf[:len(blob)] = blob
        self._register_shm_arg(id_bytes, seg, len(blob))
        if self.store.is_spilled(id_bytes):
            # The spiller took the primary while the twin was written
            # (a spilled primary has no twin).
            self._drop_shm_arg(id_bytes)

    def _run(self, func, digest: str, func_blob: bytes | None, args: tuple,
             kwargs: dict, n_returns: int, runtime_env: dict | None,
             on_card: bool, shares: dict, token: str,
             client_addr: str | None, t_admit: float) -> list:
        """Run the function where it belongs. With the performance plane
        armed: ``admit_worker`` is admission to the hand-off (the call
        on this thread, or the pool's dispatch), ``exec`` the function's
        wall where it ran, and its resources are rolled up here."""
        perf_on = perf.PERF_ON
        if perf_on:
            perf.record_stage("admit_worker", max(0.0, time.time() - t_admit))
        if on_card:
            # A GPU task runs in this process, on its dispatch thread, on
            # the card its lease names; admission bounds how many.
            import torch

            if shares and torch.cuda.is_available() \
                    and min(shares) < torch.cuda.device_count():
                torch.cuda.set_device(min(shares))
            if runtime_env:
                logger.warning("a GPU task runs in the daemon's process: "
                               "its runtime_env is ignored")
            sample = perf.sample_start() if perf_on else None
            result = func(*args, **kwargs)
            if sample is not None:
                self._record_sample(perf.sample_end(
                    getattr(func, "__qualname__", digest[:8]), sample))
            if n_returns == 0:
                return []
            if n_returns == 1:
                return [result]
            if not isinstance(result, (tuple, list)) \
                    or len(result) != n_returns:
                raise ValueError(f"task declared num_returns={n_returns} "
                                 f"but returned {type(result).__name__}")
            return list(result)
        from ray_tpu_torch._private.worker_pool import _RemoteTaskError

        args_blob = serialization.serialize_framed((args, kwargs))
        if func_blob is None:
            func_blob = serialization.dumps_function(func)
        return_ids = [ObjectID() for _ in range(max(1, n_returns))]
        with self._func_lock:
            sys_path = list(self._driver_sys_path) or None
        sample: list | None = [] if perf_on else None
        try:
            pairs = self.pool.run_task_blobs(
                digest, func_blob, args_blob, n_returns, return_ids,
                runtime_env=runtime_env, task_token=token,
                client_addr=client_addr, sys_path=sys_path,
                perf_sample=sample)
        except _RemoteTaskError as rte:
            rte.cause.__ray_tpu_remote_tb__ = rte.remote_tb
            raise rte.cause from None
        finally:
            # Results in segments were adopted into this node's directory
            # and are copied out below: unlink them.
            for rid in return_ids:
                name = self._shm_directory.free(rid)
                if name is not None:
                    self._shm_client.close_segment(name)
        if sample:
            self._record_sample(sample[0])
        return [value for _, value in pairs]

    @staticmethod
    def _record_sample(sample: tuple) -> None:
        """A (name, wall, cpu, rss) sample: the function's resources and
        its ``exec`` hop."""
        perf.record_task_resources(*sample)
        perf.record_stage("exec", float(sample[1]))

    # ------------------------------------------------------ pipelined path

    def _try_reserve_many(self, wants: list) -> list[bool]:
        """Admission for a batch in one lock pass: each (token, demand)
        that fits is reserved, in order (a saturating batch admits its
        prefix, and the rest is parked or spilled back). Only entries
        without ``GPU`` come here."""
        out = []
        with self._running_lock:
            used: dict[str, float] = {}
            for demand, _ in self._running.values():
                for key, value in demand.items():
                    used[key] = used.get(key, 0.0) + float(value)
            for token, demand in wants:
                ok = all(k in self._resources or float(v) <= 0
                         for k, v in demand.items()) and all(
                    used.get(k, 0.0) + float(demand.get(k, 0.0))
                    <= cap + 1e-9 for k, cap in self._resources.items())
                if ok:
                    self._running[token] = (dict(demand), {})
                    for key, value in demand.items():
                        used[key] = used.get(key, 0.0) + float(value)
                out.append(ok)
        if any(out):
            self._notify_load()
        return out

    @staticmethod
    def _needs_dedicated_worker(runtime_env: dict | None) -> bool:
        """An entry whose runtime_env needs a fresh interpreter (variables
        torch reads at import) cannot ride a shared lease."""
        if not runtime_env:
            return False
        from ray_tpu_torch._private.worker_factory import (
            import_sensitive_subset,
        )

        return bool(import_sensitive_subset(
            {str(k): str(v) for k, v in
             (runtime_env.get("env_vars") or {}).items()}))

    def _warm_factory_once(self) -> None:
        """At the first batch, start the fork server in the background,
        so the first spawn pays only what is left of its boot (not at
        the daemon's start: a node that never runs work never forks)."""
        if self._factory_warmed:
            return
        self._factory_warmed = True

        def warm():
            try:
                from ray_tpu_torch._private.worker_pool import _get_factory

                _get_factory()
            except Exception:  # noqa: BLE001 — spawns start it themselves
                pass

        threading.Thread(target=warm, daemon=True,
                         name="ray_tpu_torch-factory-warm").start()

    def _pipe_reply_to_task_reply(self, return_keys: list, status: str,
                                  payload, owner: str | None) -> tuple:
        """A worker lease's completion in the execute_task reply shape.
        An inline result is a framed blob already, so it crosses with no
        decode and encode here."""
        from ray_tpu_torch._private.worker_pool import unpack_result
        from ray_tpu_torch.exceptions import WorkerCrashedError

        if status == "timeout":
            # The worker found the frame's deadline past: nothing ran.
            self.task_timeouts += 1
            return ("timeout", "worker")
        if status == "crash":
            flight_recorder.record("worker.crash", str(payload)[:120])
            if isinstance(payload, WorkerCrashedError):
                exc = payload
            else:
                exc = WorkerCrashedError(str(payload))
            return ("err", _exc_blob(exc))
        if status == "err":
            return ("err", payload)
        out = []
        for id_bytes, packed in zip(return_keys, payload):
            if packed[0] == "inline":
                out.append(self._blob_entry(id_bytes, packed[1], owner))
            elif packed[0] == "shm":
                rid = ObjectID(id_bytes)
                try:
                    value = unpack_result(packed, rid, self._shm_directory,
                                          self._shm_client)
                    out.append(self._reply_entry(id_bytes, value, owner))
                finally:
                    name = self._shm_directory.free(rid)
                    if name is not None:
                        self._shm_client.close_segment(name)
            else:
                out.append(packed)  # ("err", blob): this return failed
        self.tasks_executed += 1
        return ("ok", out)

    def execute_task_batch(self, entries: list,
                           client_addr: str | None = None,
                           _emit_part=None) -> tuple:
        """Run a batch of tasks leased to this node in one RPC, streaming
        their completions back in groups as they finish (no wait for the
        slowest).

        Each entry: (digest, func_blob, args_blob, n_returns,
        return_keys, runtime_env, resources, task_token, flags[, trace
        context (None here), deadline]); flags bit 0: the arguments hold
        FetchRefs, bit 2: the driver over-subscribed the entry past this
        node's free slots. A ref-bearing entry, a ``GPU`` entry and one
        whose runtime_env needs a fresh interpreter take the classic
        ``execute_task`` on a dispatch thread of its own; the rest ride
        pipelined worker leases, or fuse (below).

        Parts: ("results", [(idx, reply), ...]) with the execute_task
        reply shape, ("started", idx) or ("started_many", [idx, ...])
        before an entry can have effects, ("parked", idx) and
        ("resumed", idx) while a frame waits behind a blocked lease head
        or in admission. Final reply: ("done", n, fused stats).

        While ``FUSED_ON`` and on a node without a card, a run of plain
        entries (no refs, no runtime_env) runs on this dispatch thread,
        each reserved under its own token while it runs, at most
        ``fused_max_run_tasks`` of them, and past
        ``fused_run_wall_budget_s`` the rest takes the worker path. An
        over-subscribed entry whose reservation fails parks in admission
        (completions let it in) instead of answering busy."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.rpc import DISPATCH_POOL
        from ray_tpu_torch._private.worker_pool import _BatchTask

        self._warm_factory_once()
        n = len(entries)
        with self._fused_lock:
            self.batch_rpcs += 1
            self.batch_tasks_received += n
        cond = threading.Condition()
        completions: list = []
        control: list = []

        def complete(idx: int, reply: tuple) -> None:
            with cond:
                completions.append((idx, reply))
                cond.notify()

        with self._func_lock:
            sys_path = list(self._driver_sys_path) or None
        fused: list = []
        # Over-subscribed entries whose reservation failed: [(task,
        # demand)], admitted by the reply loop as capacity frees.
        parked: list = []
        reserve_wants: list = []
        demand_by_idx: dict[int, dict] = {}
        token_idx: dict[str, int] = {}
        admit_ts: dict[int, float] = {}
        # One shed decision per batch RPC.
        shed_why = self._overload_reason()
        now = time.time()
        # A node with a card runs its card tasks in this process, which
        # sees the card: its plain entries stay in pool workers, which
        # do not.
        fused_cap = max(1, int(GLOBAL_CONFIG.fused_max_run_tasks)) \
            if FUSED_ON and not self.cards.capacity else 0
        for idx, entry in enumerate(entries):
            (digest, func_blob, args_blob, n_returns, return_keys,
             runtime_env, resources, token, flags) = entry[:9]
            deadline = entry[10] if len(entry) > 10 else None
            if func_blob is not None:
                with self._func_lock:
                    self._func_blob_cache[digest] = func_blob
            if deadline is not None and now > deadline:
                self.task_timeouts += 1
                complete(idx, ("timeout", "admitted"))
                continue
            if shed_why is not None:
                self.admission_shed += 1
                complete(idx, ("overloaded", shed_why))
                continue
            demand = {k: float(v) for k, v in (resources or {}).items()}
            demand.setdefault("CPU", 1.0)
            token = token or f"exec-{digest[:8]}-{os.urandom(4).hex()}"
            if (flags & 1) or demand.get("GPU", 0.0) > 0 \
                    or self._needs_dedicated_worker(runtime_env):
                def classic(idx=idx, digest=digest, func_blob=func_blob,
                            args_blob=args_blob, n_returns=n_returns,
                            return_keys=return_keys,
                            runtime_env=runtime_env, resources=resources,
                            token=token, deadline=deadline):
                    try:
                        reply = self.execute_task(
                            digest, func_blob, args_blob, n_returns,
                            return_keys, runtime_env, resources, token,
                            client_addr, deadline=deadline)
                    except BaseException as exc:  # noqa: BLE001 — to the driver
                        reply = ("err", _exc_blob(exc))
                    complete(idx, reply)

                # It may start the moment it is handed off.
                with cond:
                    control.append(("started", idx))
                    cond.notify()
                DISPATCH_POOL.submit(classic)
                continue
            blob = func_blob
            if blob is None:
                with self._func_lock:
                    blob = self._func_blob_cache.get(digest)
            if blob is None:
                # This daemon restarted since the driver learned the
                # digest: that task goes the single path.
                complete(idx, ("need_func", None))
                continue
            if runtime_env:
                # Its packages (working_dir, py_modules) are pulled into
                # this node's cache, as the classic path does.
                from ray_tpu_torch._private.runtime_env_packaging import (
                    resolve_runtime_env,
                )

                try:
                    runtime_env = resolve_runtime_env(runtime_env)
                except BaseException as exc:  # noqa: BLE001 — this task's
                    complete(idx, ("err", _exc_blob(exc)))
                    continue
            token_idx[token] = idx
            demand_by_idx[idx] = demand
            task = _BatchTask(
                idx=idx, digest=digest, func_blob=blob, args_blob=args_blob,
                n_returns=max(1, n_returns), runtime_env=runtime_env,
                token=token, client_addr=client_addr, sys_path=sys_path,
                deadline=deadline, overcommit=bool(flags & 2),
                return_keys=return_keys)
            if len(fused) < fused_cap and not runtime_env:
                # Runs on this thread, which reserves each entry's demand
                # only while it runs (_run_fused).
                fused.append(task)
                continue
            reserve_wants.append((task, demand))

        def notify(kind: str, token: str) -> None:
            with cond:
                control.append((kind, token_idx.get(token)))
                cond.notify()

        def on_result(task, status, payload, sample=None) -> None:
            with self._running_lock:
                self._running.pop(task.token, None)
                self._blocked_cpu.pop(task.token, None)
            if sample and perf.PERF_ON:
                self._record_sample(sample)
            try:
                reply = self._pipe_reply_to_task_reply(
                    task.return_keys, status, payload, client_addr)
            except BaseException as exc:  # noqa: BLE001 — to the driver
                reply = ("err", _exc_blob(exc))
            complete(task.idx, reply)

        notified: list = []

        def launch(run: list) -> None:
            tokens = [t.token for t in run]
            self._pipeline_inflight.register_notify(tokens, notify)
            notified.extend(tokens)
            if perf.PERF_ON:
                t_hand = time.time()
                for t in run:
                    perf.record_stage("admit_worker", max(
                        0.0, t_hand - admit_ts.get(t.idx, t_hand)))
            depth = max(1, int(GLOBAL_CONFIG.worker_pipeline_depth))
            self._batch_runners.submit(
                self.pool.run_task_batch, run, on_result, depth,
                self._pipeline_inflight)

        def reserve_or_park(wants: list) -> list:
            """Admission for [(task, demand)]: the admitted are returned;
            an over-subscribed entry that does not fit parks, any other
            answers busy (the driver spills it back)."""
            accepted = self._try_reserve_many(
                [(t.token, d) for t, d in wants])
            t_admit = time.time()
            admitted = []
            for (task, demand), ok in zip(wants, accepted):
                if ok:
                    admitted.append(task)
                    admit_ts[task.idx] = t_admit
                elif task.overcommit:
                    parked.append((task, demand))
                    _emit_part(("parked", task.idx))
                else:
                    complete(task.idx, ("busy",))
            return admitted

        if reserve_wants:
            admitted = reserve_or_park(reserve_wants)
            if admitted:
                launch(admitted)
        fused_stats = {"fused": 0, "fused_fallbacks": 0}

        def spill_fused(rest: list) -> None:
            # The run's budget ran out: the rest takes the worker path,
            # through admission like any worker-path entry.
            with self._fused_lock:
                self.fused_fallbacks += len(rest)
            fused_stats["fused_fallbacks"] += len(rest)
            admitted = reserve_or_park(
                [(t, demand_by_idx[t.idx]) for t in rest])
            if admitted:
                launch(admitted)

        try:
            done_n = 0
            if fused:
                done_n += self._run_fused(fused, demand_by_idx, client_addr,
                                          _emit_part, spill_fused,
                                          fused_stats)
            while done_n < n:
                with cond:
                    while not completions and not control:
                        if parked:
                            # Capacity freed by other RPCs never signals
                            # this condition: poll on a short beat.
                            if not cond.wait(timeout=0.05):
                                break
                        else:
                            cond.wait()
                    group, completions = completions, []
                    ctrl, control = control, []
                for kind, idx in ctrl:
                    if idx is not None:
                        _emit_part((kind, idx))
                if group:
                    _emit_part(("results", group))
                    self.reply_groups += 1
                    done_n += len(group)
                    self.store.notify_spill()
                    self._notify_load()
                if parked:
                    self._admit_parked(parked, launch, _emit_part, complete,
                                       admit_ts)
        finally:
            if notified:
                self._pipeline_inflight.forget_notify(notified)
        return ("done", n, fused_stats)

    # Fused entries are announced in ("started_many", [idx, ...]) windows
    # of this many before any of them can have effects: on this daemon's
    # death, an announced entry retries under the system-failure budget,
    # so the window bounds the budget a death can cost the unstarted.
    # Results go back in groups of _FUSED_GROUP.
    _FUSED_STARTED_WINDOW = 8
    _FUSED_GROUP = 64

    def _run_fused(self, tasks: list, demands: dict,
                   client_addr: "str | None", emit, spill,
                   fused_stats: dict) -> int:
        """Run fused entries one after another on this thread, announcing
        each window before it runs and streaming grouped results; returns
        how many completed here. Past the wall budget the rest goes to
        ``spill`` (the worker path) and completes through the reply loop.
        A window's socket write completes before any of its functions
        runs, and a killed daemon's kernel still sends what was written,
        so the driver never requeues unseen an entry that may have
        run."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        budget_s = float(GLOBAL_CONFIG.fused_run_wall_budget_s)
        t0 = time.monotonic()
        with self._fused_lock:
            self.fused_runs += 1
        group: list = []
        done = 0
        announced = 0
        window = self._FUSED_STARTED_WINDOW
        run_sample = perf.sample_start() if perf.PERF_ON else None
        for pos, task in enumerate(tasks):
            if budget_s > 0 and time.monotonic() - t0 > budget_s:
                if group:
                    emit(("results", group))
                    self.reply_groups += 1
                    done += len(group)
                    group = []
                spill(tasks[pos:])
                break
            if task.deadline is not None and time.time() > task.deadline:
                self.task_timeouts += 1
                group.append((task.idx, ("timeout", "admitted")))
            elif self._cancelled_tokens \
                    and self._token_cancelled(task.token):
                group.append((task.idx, ("cancelled",)))
            else:
                if pos >= announced:
                    emit(("started_many",
                          [t.idx for t in
                           tasks[announced:announced + window]]))
                    announced += window
                # The running entry alone holds its demand, under its
                # own token: the node's availability and load pushes
                # count it, and a nested get() there gives its CPU back
                # (task_block). The entries queued behind it hold none.
                with self._running_lock:
                    self._running[task.token] = (demands[task.idx], {})
                self._notify_load()
                try:
                    reply = self._exec_fused(task, client_addr)
                finally:
                    with self._running_lock:
                        self._running.pop(task.token, None)
                        self._blocked_cpu.pop(task.token, None)
                group.append((task.idx, reply))
                with self._fused_lock:
                    self.fused_tasks += 1
                fused_stats["fused"] += 1
            if len(group) >= self._FUSED_GROUP:
                emit(("results", group))
                self.reply_groups += 1
                done += len(group)
                group = []
        else:
            if group:
                emit(("results", group))
                self.reply_groups += 1
                done += len(group)
        ran = fused_stats["fused"]
        if run_sample is not None and ran:
            # One resource sample brackets the run, attributed to its
            # first function with the task count.
            func = self._func_cache.get(tasks[0].digest)
            name = getattr(func, "__qualname__", tasks[0].digest[:8])
            _, wall, cpu, rss = perf.sample_end(name, run_sample)
            perf.record_task_resources(name, wall, cpu, rss, count=ran)
        self.store.notify_spill()
        self._notify_load()
        return done

    def _exec_fused(self, task, client_addr: "str | None") -> tuple:
        """Run one fused entry in this process: the execute_task reply
        shape, for one args decode, the function and one encode per
        result (both raw-framed when small and immutable)."""
        from ray_tpu_torch._private import worker_client

        # The function's public API calls (a nested task, a get) go to
        # the task's driver, as from a pool worker, under its token: both
        # are this thread's, as other batch RPCs run fused tasks of other
        # drivers at the same time. Refs in its arguments and results
        # belong to that driver too.
        worker_client.enter_daemon_task(client_addr, task.token)
        try:
            return self._exec_fused_here(task, client_addr)
        finally:
            worker_client.leave_daemon_task()

    def _exec_fused_here(self, task, client_addr: "str | None") -> tuple:
        try:
            func = self._func_cache.get(task.digest)
            if func is None:
                func = serialization.loads_function(task.func_blob)
                with self._func_lock:
                    self._func_cache[task.digest] = func
            args, kwargs = serialization.deserialize_from_buffer(
                memoryview(task.args_blob))
            t_exec = time.time() if perf.PERF_ON else 0.0
            result = func(*args, **kwargs)
            if t_exec:
                perf.record_stage("exec", max(0.0, time.time() - t_exec))
            n_returns = task.n_returns
            if n_returns == 1:
                values = [result]
            else:
                if not isinstance(result, (tuple, list)) \
                        or len(result) != n_returns:
                    raise ValueError(
                        f"task declared num_returns={n_returns} but "
                        f"returned {type(result).__name__}")
                values = list(result)
        except BaseException as exc:  # noqa: BLE001 — to the driver
            return ("err", _exc_blob(exc))
        out = []
        for id_bytes, value in zip(task.return_keys or (), values):
            try:
                blob = serialization.try_serialize_raw(value)
                if blob is None:
                    blob = serialization.serialize_framed(value)
            except BaseException as exc:  # noqa: BLE001 — this return failed
                out.append(("err", _exc_blob(exc)))
                continue
            out.append(self._blob_entry(id_bytes, blob, client_addr))
        self.tasks_executed += 1
        return ("ok", out)

    def _admit_parked(self, parked: list, launch, emit, complete,
                      admit_ts: dict) -> None:
        """Try the over-subscribed entries this batch RPC parked again: a
        past deadline seals a timeout, an admitted entry streams
        ("resumed", idx) (the driver takes its CPU again) and joins the
        worker path as a new run."""
        now = time.time()
        still: list = []
        for task, demand in parked:
            if task.deadline is not None and now > task.deadline:
                self.task_timeouts += 1
                complete(task.idx, ("timeout", "admitted"))
            else:
                still.append((task, demand))
        parked[:] = []
        if not still:
            return
        accepted = self._try_reserve_many([(t.token, d) for t, d in still])
        t_admit = time.time()
        go: list = []
        for (task, demand), ok in zip(still, accepted):
            if ok:
                emit(("resumed", task.idx))
                admit_ts[task.idx] = t_admit
                go.append(task)
            else:
                parked.append((task, demand))
        if go:
            launch(go)

    # -------------------------------------------------------------- objects

    def fetch_object(self, id_bytes: bytes, offset: int, length: int):
        reply = self.store.read_chunk(id_bytes, offset, length)
        if reply is None:
            # A pull in progress here may hold the chunks: relay them.
            with self._partials_lock:
                part = self._partials.get(id_bytes)
            if part is None:
                return None
            reply = part.read_chunk(offset, length)
            if reply is None:
                return None
            self.relay_chunks_served += 1
        return wrap_chunk_reply(reply)

    def fetch_plan(self, id_bytes: bytes, puller_addr: str | None = None,
                   puller_host: str | None = None):
        """(total size, the other holders, the map source, {"spilled":
        bool}) for an object here; None when it is unknown here. The
        puller is registered as a holder, so later pullers take chunks
        from it too. ``map_source``: for a puller whose host is this
        daemon's, how to map the object's segment (kind, name, size) and
        the token of the lease granted on it before this reply leaves,
        which pins it until ``unpin_object`` or the TTL sweep; None
        otherwise (the chunked pull). ``spilled``: the copy here is on
        disk (it has no segment), so the first chunk pays its restore."""
        total = self.store.size(id_bytes)
        if total is None:
            with self._partials_lock:
                part = self._partials.get(id_bytes)
            if part is None:
                with self._shm_args_lock:
                    source = self._map_sources.get(id_bytes)
                if source is None:
                    return None
                total = source[2]
            else:
                total = part.total
        map_info = None
        if puller_addr and puller_host and puller_host == self.host_id:
            map_info = self._grant_map_lease(id_bytes, puller_addr)
        # A puller that maps holds no chunks to relay.
        reg_addr = None if map_info is not None else puller_addr
        return (total, plan_holders(self.chunk_directory, id_bytes,
                                    reg_addr, total), map_info,
                {"spilled": self.store.is_spilled(id_bytes)})

    def _grant_map_lease(self, id_bytes: bytes,
                         holder: str) -> dict | None:
        """The owner's half: the object's segment and a lease for
        ``holder`` on it. A segment needs no pin in memory (POSIX keeps a
        mapped segment past its unlink): the lease keeps the object off
        the spiller's victims and records the grant."""
        from ray_tpu_torch._private.same_host import map_enabled

        if not map_enabled():
            return None
        with self._shm_args_lock:
            source = self._map_sources.get(id_bytes)
        if source is None:
            return None
        kind, name, size = source
        token = self.leases.grant(id_bytes, holder)
        return {"kind": kind, "name": name, "key": b"", "size": size,
                "host": self.host_id, "token": token}

    def unpin_object(self, token: str) -> bool:
        """End one map lease (the puller let its mapping go)."""
        return self.leases.release(token)

    def free_objects(self, ids: list[bytes]) -> int:
        self.chunk_directory.drop(ids)
        with self._partials_lock:
            for key in ids:
                self._partials.pop(key, None)
        for key in ids:
            self._drop_shm_arg(key)
        return self.store.free(ids)

    def _resolve_fetch_args(self, args: tuple, kwargs: dict,
                            to_shm: bool = False):
        """Replace FetchRef arguments with their values, or (``to_shm``,
        for a pool task) with shared-memory descriptors the worker maps:
        the daemon does not deserialize and pickle again what it
        pulled."""
        from ray_tpu_torch._private.worker_pool import _ShmRef

        def convert(a):
            if not isinstance(a, FetchRef):
                return a
            if to_shm:
                return _ShmRef(self._shm_fetch_blob(a))
            return self._load_object(a)

        return (tuple(convert(a) for a in args),
                {k: convert(v) for k, v in kwargs.items()})

    def _load_object(self, ref: FetchRef) -> Any:
        """The value of ``ref`` in this process: from this node, or pulled
        (one copy out of the holder's segment on the same host)."""
        blob = self._local_blob(ref)
        if blob is None:
            blob = self._fetch_remote(ref)
        return serialization.deserialize_from_buffer(memoryview(blob))

    def _local_blob(self, ref: FetchRef) -> bytes | None:
        """The object from this node's store or a finished pull here."""
        blob = self.store.get(ref.id_bytes)
        if blob is None:
            with self._partials_lock:
                part = self._partials.get(ref.id_bytes)
            if part is not None and part.done.is_set() \
                    and part.error is None:
                with part.lock:
                    blob = bytes(part.buf)
        return blob

    def _shm_fetch_blob(self, ref: FetchRef):
        """The object in shared memory a pool task reads: this node's own
        segment (the stored primary's twin, or written once here and
        shared by every task that takes it) or, on the same host, the
        owner's segment or arena object, under a lease. FIFO-bounded."""
        from ray_tpu_torch._private.shm_store import (
            PeerArenaDescriptor,
            ShmDescriptor,
        )

        oid = ObjectID(ref.id_bytes)
        with self._shm_args_lock:
            desc = self._shm_directory.lookup(oid)
            # The descriptor is about to ride a worker frame: the spiller
            # must not unlink its segment before the worker attaches.
            self._shm_out_stamp[ref.id_bytes] = time.monotonic()
            if desc is not None:
                self._shm_args_order.move_to_end(ref.id_bytes)
                return desc
        blob = self._local_blob(ref)
        if blob is None:
            got = self._fetch_remote(ref, to_shm=True)
            if isinstance(got, (ShmDescriptor, PeerArenaDescriptor)):
                return got
            blob = got
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(create=True,
                                         size=max(len(blob), 1))
        seg.buf[:len(blob)] = blob
        return self._register_shm_arg(ref.id_bytes, seg, len(blob))

    def _register_shm_arg(self, key: bytes, seg, size: int,
                          desc=None, attached: tuple | None = None):
        """Record a descriptor pool workers map in the node's directory
        (FIFO-bounded; the loser of a concurrent race discards its
        segment) and return the one that stands. This daemon's own
        segment (``attached`` None) is a map source too;
        ``attached=(owner address, token)`` records a peer's segment
        instead: never a source, never unlinked here, and its lease is
        released at the owner when the entry goes."""
        from ray_tpu_torch._private.shm_store import ShmDescriptor

        if desc is None:
            desc = ShmDescriptor(seg.name, size)
        oid = ObjectID(key)
        evicted = []
        with self._shm_args_lock:
            existing = self._shm_directory.lookup(oid)
            if existing is None:
                self._shm_directory.register(
                    oid, desc, seg if attached is None else None)
                if attached is not None:
                    self._attached[key] = (attached[0], attached[1], seg)
                else:
                    self._map_sources[key] = ("seg", seg.name, size)
                self._shm_args_order[key] = size
                total = sum(self._shm_args_order.values())
                while total > self._SHM_ARGS_MAX_BYTES \
                        and len(self._shm_args_order) > 1:
                    old_key, old_size = self._shm_args_order.popitem(
                        last=False)
                    total -= old_size
                    evicted.append(old_key)
        if existing is not None:
            # A concurrent task got there first.
            if attached is not None:
                _close_borrowed(seg)
                self._unpin_at(*attached)
            else:
                seg.unlink()
                seg.close()
            return existing
        for old_key in evicted:
            self._drop_shm_arg(old_key, locked_order=True)
        return desc

    def _drop_shm_arg(self, key: bytes, locked_order: bool = False) -> None:
        with self._shm_args_lock:
            if not locked_order:
                self._shm_args_order.pop(key, None)
        self._release_plane_state(key)
        name = self._shm_directory.free(ObjectID(key))
        if name is not None:
            self._shm_client.close_segment(name)

    def _release_plane_state(self, key: bytes) -> None:
        """The same-host plane's state of one object: it stops being a
        map source, the peers' leases on it end, and a peer's segment this
        daemon holds for it is closed and its lease released at the
        owner."""
        with self._shm_args_lock:
            self._map_sources.pop(key, None)
            attached = self._attached.pop(key, None)
        self.leases.release_object(key)
        if attached is not None:
            owner_addr, token, seg = attached
            _close_borrowed(seg)
            self._unpin_at(owner_addr, token)

    def _unpin_at(self, owner_addr: str, token: str) -> None:
        """Release a lease at its owner, without waiting (the owner's TTL
        sweep is the backstop when this is lost)."""
        try:
            self._peers.get(owner_addr).call_async("unpin_object", token)
        except Exception:  # noqa: BLE001 — the owner is gone: nothing pinned
            pass

    def _fetch_remote(self, ref: FetchRef, to_shm: bool = False):
        """Pull ``ref`` from the cluster. The owner's plan comes first: on
        the same host it grants a lease on its segment, which a pool
        task's argument (``to_shm``) maps, a descriptor returned, and a
        read in this process copies once; otherwise (or when that fails)
        a small object comes from its owner alone, a large one in chunks
        from the owner and every peer that holds it, this node relaying
        its chunks meanwhile. One pull per object: concurrent tasks that
        need it wait for the first."""
        from ray_tpu_torch._private.rpc import call_with_retry
        from ray_tpu_torch._private.same_host import map_enabled

        start = time.perf_counter()
        owner = self._peers.get(ref.addr)
        plan = call_with_retry(owner.call, "fetch_plan", ref.id_bytes,
                               self.advertised_address,
                               self.host_id if map_enabled() else None,
                               attempts=2, timeout_s=30.0)
        if plan is not None and len(plan) > 3 and plan[3] \
                and plan[3].get("spilled"):
            # The holder's copy is on its disk: it has no segment, and
            # the first chunk pays the restore.
            self.spilled_plan_hits += 1
        map_info = plan[2] if plan is not None and len(plan) > 2 else None
        if map_info is not None:
            got = self._try_same_host(ref, map_info, to_shm)
            if got is not None:
                if not to_shm:
                    with self._running_lock:
                        self.same_host_bytes += len(got)
                        self.same_host_seconds += \
                            time.perf_counter() - start
                return got
        start = time.perf_counter()
        blob = self._pull(ref, plan)
        with self._running_lock:
            self.pulled_bytes += len(blob)
            self.pull_seconds += time.perf_counter() - start
        return blob

    def _try_same_host(self, ref: FetchRef, info: dict, to_shm: bool):
        """Take a granted map lease: for a pool task, map the holder's
        segment or hand over the holder's arena object (its descriptor,
        the lease kept until the entry goes); for a read here, copy out
        of either once (the bytes, the lease released). None on any
        failure, the lease released first: the chunked pull decides."""
        from ray_tpu_torch._private.same_host import (
            attach_segment,
            read_segment,
        )
        from ray_tpu_torch._private.shm_store import (
            PeerArenaDescriptor,
            ShmDescriptor,
        )

        key = ref.id_bytes
        token = info.get("token")
        owner_addr = ref.addr
        kind = info.get("kind")
        try:
            if info.get("host") != self.host_id or not token \
                    or kind not in ("seg", "arena"):
                if token:
                    self._unpin_at(owner_addr, token)
                return None
            size = int(info.get("size", 0))
            seg = blob = None
            try:
                if kind == "arena":
                    # A pool task reads it in its own process; a read
                    # here copies it now. Either way the owner's pin
                    # holds it in place.
                    if to_shm:
                        if self._peer_arenas.get(info["name"]) is None:
                            raise OSError(f"arena {info['name']} is gone")
                    else:
                        blob = self._peer_arenas.read(info["name"],
                                                      info["key"])
                        if blob is None:
                            raise OSError("arena object is gone")
                elif to_shm:
                    seg = attach_segment(info["name"])
                else:
                    blob = read_segment(info["name"], size)
            except (OSError, ValueError):
                self._unpin_at(owner_addr, token)
                return None  # the holder let it go: the chunked pull
            if to_shm:
                desc = (PeerArenaDescriptor(info["name"], info["key"], size)
                        if kind == "arena"
                        else ShmDescriptor(info["name"], size))
                desc = self._register_shm_arg(
                    key, seg, size, desc=desc, attached=(owner_addr, token))
                self.same_host_map_hits += 1
                return desc
            self._unpin_at(owner_addr, token)
            self.same_host_copy_hits += 1
            self.store.put(key, blob, cached=True)
            return blob
        except Exception:  # noqa: BLE001 — any failure: the chunked pull
            if token:
                self._unpin_at(owner_addr, token)
            return None

    def _pull(self, ref: FetchRef, plan) -> bytes:
        owner = self._peers.get(ref.addr)
        chunk = _fetch_chunk_bytes()
        n_chunks = -(-plan[0] // chunk) if plan is not None and plan[0] \
            else 0
        if plan is None or n_chunks < _MIN_P2P_CHUNKS:
            self.chunked_pulls += 1
            blob = fetch_blob(owner, ref.id_bytes)
            self.store.put(ref.id_bytes, blob, cached=True)
            return blob
        total, holders = plan[0], plan[1]
        with self._partials_lock:
            part = self._partials.get(ref.id_bytes)
            leader = part is None or (part.done.is_set()
                                      and part.error is not None)
            if leader:
                part = self._partials[ref.id_bytes] = _PartialBlob(total,
                                                                   chunk)
        if not leader:
            part.done.wait()
            if part.error is None:
                with part.lock:
                    return bytes(part.buf)
            self.chunked_pulls += 1
            blob = fetch_blob(owner, ref.id_bytes)
            self.store.put(ref.id_bytes, blob, cached=True)
            return blob
        self.chunked_pulls += 1
        try:
            self._pull_chunks(ref, part, holders)
        except BaseException as exc:  # noqa: BLE001 — release the waiters
            with self._partials_lock:
                if self._partials.get(ref.id_bytes) is part:
                    del self._partials[ref.id_bytes]
            part.fail(exc)
            raise
        blob = part.finish()
        self.store.put(ref.id_bytes, blob, cached=True)
        if self.store.size(ref.id_bytes) is not None:
            # The cache serves it from here on.
            with self._partials_lock:
                if self._partials.get(ref.id_bytes) is part:
                    del self._partials[ref.id_bytes]
        return blob

    def _pull_chunks(self, ref: FetchRef, part: _PartialBlob,
                     holders: list[str]) -> None:
        """A sliding window of chunk requests over the owner and its
        peers. Chunk order starts at a point that hashes this node's
        address, so concurrent receivers begin in different regions and
        exchange the rest; a chunk goes to the peer that began its region
        first, and a miss goes back to the owner without stalling the
        window. A peer whose transport fails is blacklisted for the rest
        of the pull; a dead owner is replaced by any holder that answers
        with the whole object."""
        import zlib

        owner_addr = ref.addr
        fanout = _CHUNK_FANOUT
        n_chunks = part.n_chunks()
        my_addr = self.advertised_address
        dead: set[str] = set()
        known_holders = [a for a in holders if a and a != my_addr]

        def peer_starts(addrs: list[str]) -> dict[str, int]:
            return {a: zlib.crc32(a.encode()) % n_chunks
                    for a in dict.fromkeys(addrs)
                    if a and a != my_addr and a not in dead}

        starts = peer_starts(holders[:fanout])
        start = zlib.crc32(my_addr.encode()) % n_chunks
        order = list(range(start, n_chunks)) + list(range(start))
        depth = _pipeline_depth()
        pending: collections.deque = collections.deque()

        def pick_source(idx: int) -> str:
            best, bestd = owner_addr, n_chunks // 2
            for src, s in starts.items():
                d = (idx - s) % n_chunks
                if d < bestd:
                    best, bestd = src, d
            return best

        def blacklist(src: str) -> None:
            if src not in dead:
                dead.add(src)
                starts.pop(src, None)
                self.peer_blacklists += 1

        def replan_owner() -> str | None:
            for addr in dict.fromkeys(list(starts) + known_holders):
                if addr in dead or addr == my_addr:
                    continue
                try:
                    client = self._peers.get(addr)
                    plan = client.call("fetch_plan", ref.id_bytes, my_addr,
                                       timeout_s=5.0)
                    if plan is not None and plan[0] == part.total \
                            and client.call("fetch_object", ref.id_bytes,
                                            0, 1, timeout_s=5.0) is not None:
                        return addr
                except (RpcError, RpcMethodError, OSError):
                    blacklist(addr)
            return None

        def fail_over(src: str) -> None:
            nonlocal owner_addr
            blacklist(src)
            if src == owner_addr:
                survivor = replan_owner()
                if survivor is None:
                    raise KeyError(
                        f"object {ref.id_bytes.hex()}: owner {owner_addr} "
                        f"died and no surviving holder has a whole copy")
                owner_addr = survivor

        def issue(idx: int, src: str, attempts: int) -> None:
            length = min(part.chunk, part.total - idx * part.chunk)
            while True:
                try:
                    slot = self._peers.get(src).call_async(
                        "fetch_object", ref.id_bytes, idx * part.chunk,
                        length)
                except (RpcError, OSError):
                    fail_over(src)
                    attempts += 1
                    if attempts > 3:
                        raise KeyError(f"object {ref.id_bytes.hex()} is "
                                       f"unreachable on every source")
                    src = owner_addr
                    continue
                pending.append((idx, src, slot, attempts))
                return

        it = iter(order)
        exhausted = False
        completed = 0
        while pending or not exhausted:
            while not exhausted and len(pending) < depth:
                idx = next(it, None)
                if idx is None:
                    exhausted = True
                    break
                issue(idx, pick_source(idx), 0)
            if not pending:
                continue
            idx, src, slot, attempts = pending.popleft()
            transport_dead = False
            try:
                reply = slot.result()
            except (RpcError, RpcMethodError):
                reply, transport_dead = None, True
            if reply is None:
                if transport_dead:
                    fail_over(src)
                if attempts >= 3:
                    raise KeyError(f"object {ref.id_bytes.hex()} not "
                                   f"present on {owner_addr}")
                issue(idx, owner_addr, attempts + 1)
                continue
            part.write(idx, reply[1])
            completed += 1
            if completed % 64 == 0:
                # Pullers that registered after the plan are fresh relay
                # sources.
                try:
                    plan = self._peers.get(owner_addr).call(
                        "fetch_plan", ref.id_bytes, my_addr)
                    if plan is not None:
                        starts = peer_starts(plan[1][:fanout])
                except (RpcError, RpcMethodError, OSError):
                    pass

    # ---------------------------------------------------------- bookkeeping

    def adopt_sys_path(self, paths: list) -> int:
        """Take a driver's import paths (the directories that exist
        here), so what it pickled by reference imports here and in this
        node's workers."""
        import sys

        added = 0
        for path in paths:
            if path and path not in sys.path and os.path.isdir(path):
                sys.path.append(path)
                added += 1
        with self._func_lock:
            merged = list(self._driver_sys_path)
            merged += [p for p in paths
                       if p and p not in merged and os.path.isdir(p)]
            self._driver_sys_path = merged
        return added

    def executor_stats(self) -> dict:
        import threading as _threading

        with self._running_lock:
            running = len(self._running)
        with self._actors_lock:
            num_actors = len(self._actors)
        return {"tasks_executed": self.tasks_executed, "running": running,
                "store": self.store.stats(), "num_actors": num_actors,
                "spill": self._spill_stats(),
                "pid": os.getpid(), "chunked_pulls": self.chunked_pulls,
                "pulled_bytes": self.pulled_bytes,
                "pull_seconds": self.pull_seconds,
                "same_host_bytes": self.same_host_bytes,
                "same_host_seconds": self.same_host_seconds,
                "data_plane": self._data_plane_stats(),
                "available": self.available_resources(),
                "relay_chunks_served": self.relay_chunks_served,
                "pipeline": self._pipeline_stats(),
                "faults": self._fault_stats(),
                "threads": _threading.active_count()}

    def _pipeline_stats(self) -> dict:
        """The pipelined path's counters, stage by stage: batch RPCs and
        their entries, worker lease runs, tasks and frames, completion
        groups, fused runs, tasks and fallbacks, and the batch runner
        threads spawned and reused."""
        return {"batch_rpcs": self.batch_rpcs,
                "batch_tasks": self.batch_tasks_received,
                "reply_groups": self.reply_groups,
                "worker_lease_runs": self.pool.batch_runs,
                "worker_lease_tasks": self.pool.batch_tasks,
                "worker_pipelined_frames": self.pool.batch_frames,
                "fused_runs": self.fused_runs,
                "fused_tasks": self.fused_tasks,
                "fused_fallbacks": self.fused_fallbacks,
                "runner_spawns": self._batch_runners.spawns,
                "runner_reuses": self._batch_runners.reuses}

    def _data_plane_stats(self) -> dict:
        with self._shm_args_lock:
            data_plane = {
                "same_host_map_hits": self.same_host_map_hits,
                "same_host_copy_hits": self.same_host_copy_hits,
                "chunked_pulls": self.chunked_pulls,
                "map_sources": len(self._map_sources),
                "attached_mappings": len(self._attached)}
        data_plane["leases"] = self.leases.stats()
        return data_plane

    def _fault_stats(self) -> dict:
        """The failure counters: how often each recovery path fired."""
        return {"rpc_retries": rpc_retry_count(),
                "batch_requeues": self.pool.batch_requeues,
                "peer_blacklists": self.peer_blacklists,
                "task_timeouts": self.task_timeouts,
                "admission_shed": self.admission_shed,
                "lease_orphans_swept": self.lease_orphans_swept,
                "arena_orphans_swept": self.arena_orphans_swept,
                "breaker_open": breaker_stats()["opens"]}

    def _engine_stats(self) -> "dict | None":
        """The counters of the LLM engines this daemon hosts, summed: in
        its own process and in its multiplexed actors' processes (a GPU
        actor runs in a process of its own), as each actor's last reply
        carried them. None when no process of the node has an
        engine."""
        from ray_tpu_torch._private.worker_pool import _hosted_engine_stats

        with self._actors_lock:
            rows = [actor._mux.engine_stats for actor in self._actors.values()
                    if actor._mux is not None]
        merged = None
        for row in [_hosted_engine_stats(), *rows]:
            if not row:
                continue
            merged = merged or {}
            for key, value in row.items():
                merged[key] = merged.get(key, 0) + int(value)
        return merged

    def stats_for_sync(self) -> dict:
        """The heartbeat's stats: cheap counters only (the groups the
        head's node-stats table, the metrics history and /metrics read),
        with the spill tier's counters and its events since the last
        beat, the hosted LLM engines' counters, and the performance
        plane's stage histograms and resource table."""
        with self._running_lock:
            running = len(self._running)
            depth = max(0, running - len(self._blocked_cpu))
        stats = {"tasks_executed": self.tasks_executed, "running": running,
                 "depth": depth, "stats_ts": time.time(),
                 "chunked_pulls": self.chunked_pulls,
                 "pipeline": self._pipeline_stats(),
                 "data_plane": self._data_plane_stats(),
                 "faults": self._fault_stats()}
        if self._spill_mgr is not None:
            stats["spill"] = self._spill_stats()
            events = self._drain_spill_events()
            if events:
                stats["spill_events"] = events
        engine = self._engine_stats()
        if engine is not None:
            stats["engine"] = engine
        if perf.PERF_ON:
            stats["stage_hist"] = perf.stage_snapshot()
            stats["task_resources"] = perf.resource_snapshot()
        return stats

    # --------------------------------------------------------------- actors

    def create_actor(self, actor_key: bytes, cls_blob: bytes,
                     args_blob: bytes, runtime_env: dict | None = None,
                     max_concurrency: int = 1,
                     resources: dict | None = None,
                     client_addr: str | None = None,
                     sys_path: list | None = None) -> tuple:
        """Host an actor: reserve its resources for its life, start its
        process and run its constructor there. Replies ("ok", pid),
        ("busy",) or ("err", blob)."""
        if sys_path:
            self.adopt_sys_path(sys_path)
        with self._actors_creating_cond:
            self._actors_creating.add(actor_key)
        try:
            return self._create_actor_gated(
                actor_key, cls_blob, args_blob, runtime_env,
                max_concurrency, resources, client_addr)
        finally:
            with self._actors_creating_cond:
                self._actors_creating.discard(actor_key)
                self._actors_creating_cond.notify_all()

    def _create_actor_gated(self, actor_key: bytes, cls_blob: bytes,
                            args_blob: bytes, runtime_env: dict | None,
                            max_concurrency: int, resources: dict | None,
                            client_addr: str | None) -> tuple:
        from ray_tpu_torch._private import worker_client
        from ray_tpu_torch._private.runtime_env_packaging import (
            resolve_runtime_env,
        )

        with self._actors_lock:
            existing = self._actors.get(actor_key)
        if existing is not None:
            if existing.alive():
                return ("ok", existing.pid)  # a retried request
            self._reap_actor(actor_key)
        demand = {k: float(v) for k, v in (resources or {}).items()}
        token = "actor-" + actor_key.hex()
        shares = self._try_reserve(token, demand)
        if shares is None:
            return ("busy",)
        try:
            args, kwargs = serialization.deserialize_from_buffer(
                memoryview(args_blob))
            args, kwargs = self._resolve_fetch_args(args, kwargs,
                                                    to_shm=True)
            init_blob = serialization.serialize_framed((args, kwargs))
            extra_env = {}
            if client_addr:
                extra_env[worker_client.ADDRESS_ENV] = client_addr
            gpu_ids = sorted(shares)
            worker = None if gpu_ids else self._take_standby(extra_env)
            actor = _DaemonActor(cls_blob, init_blob,
                                 resolve_runtime_env(runtime_env),
                                 max_concurrency, extra_env, gpu_ids,
                                 worker=worker)
        except _ActorNewError as exc:
            self._release(token)
            return ("err", exc.blob)
        except BaseException as exc:  # noqa: BLE001 — shipped to the driver
            self._release(token)
            return ("err", _exc_blob(exc))
        actor.owner = client_addr
        with self._actors_lock:
            self._actors[actor_key] = actor
        return ("ok", actor.pid)

    def actor_call(self, actor_key: bytes, method: str, args_blob: bytes,
                   n_returns: int, return_keys: list[bytes],
                   awaiting_create: bool = False) -> tuple:
        """Call a method of an actor here. Replies ("ok", results) in the
        execute_task shape, ("err", blob) when the method raised,
        ("dead", blob) when the actor's process died, or ("gone",) when
        this node does not host it. ``awaiting_create``: the call was
        sent right behind its create_actor, so it waits for the
        constructor instead of bouncing."""
        from ray_tpu_torch._private.worker_pool import (
            _WorkerUnavailable,
            unpack_result,
        )
        from ray_tpu_torch.exceptions import WorkerCrashedError

        with self._actors_lock:
            actor = self._actors.get(actor_key)
        if actor is None and awaiting_create:
            actor = self._await_actor(actor_key)
        if actor is None:
            return ("gone",)
        try:
            args, kwargs = serialization.deserialize_from_buffer(
                memoryview(args_blob))
            args, kwargs = self._resolve_fetch_args(args, kwargs,
                                                    to_shm=True)
            status, payload = actor.call(
                method, serialization.serialize_framed((args, kwargs)),
                max(1, n_returns))
        except (WorkerCrashedError, _WorkerUnavailable) as exc:
            flight_recorder.record("worker.crash", str(exc)[:120])
            self._reap_actor(actor_key)
            return ("dead", _exc_blob(exc))
        except BaseException as exc:  # noqa: BLE001 — shipped to the driver
            return ("err", _exc_blob(exc))
        if status == "err":
            return ("err", payload)
        out = []
        for id_bytes, packed in zip(return_keys, payload):
            if packed[0] == "inline":
                out.append(self._blob_entry(id_bytes, packed[1],
                                            actor.owner))
            elif packed[0] == "shm":
                rid = ObjectID(id_bytes)
                try:
                    value = unpack_result(packed, rid, self._shm_directory,
                                          self._shm_client)
                    out.append(self._reply_entry(id_bytes, value,
                                                 actor.owner))
                finally:
                    name = self._shm_directory.free(rid)
                    if name is not None:
                        self._shm_client.close_segment(name)
            else:
                out.append(packed)  # ("err", blob): this return failed
        self.store.notify_spill()
        return ("ok", out)

    def _await_actor(self, actor_key: bytes, grace_s: float = 10.0,
                     create_timeout_s: float = 600.0):
        """Wait for the key's creation in flight (a short grace covers a
        call that overtook its create frame)."""
        grace_deadline = time.monotonic() + grace_s
        deadline = time.monotonic() + create_timeout_s
        seen_creating = False
        with self._actors_creating_cond:
            while True:
                actor = self._actors.get(actor_key)
                if actor is not None:
                    return actor
                now = time.monotonic()
                if actor_key in self._actors_creating:
                    seen_creating = True
                    if now > deadline:
                        return None
                    self._actors_creating_cond.wait(min(1.0,
                                                        deadline - now))
                elif seen_creating or now > grace_deadline:
                    return None
                else:
                    self._actors_creating_cond.wait(0.05)

    def _take_standby(self, extra_env: dict):
        """A prestarted live CPU actor process for this env (None on a
        miss); a refill starts either way."""
        key = tuple(sorted(extra_env.items()))
        worker = None
        with self._standby_lock:
            pool = self._standby.get(key, [])
            while pool:
                candidate = pool.pop()
                if candidate.alive():
                    worker = candidate
                    break
                candidate.stop()
        self._refill_standby(key)
        return worker

    def _refill_standby(self, key: tuple) -> None:
        with self._standby_lock:
            if key in self._standby_refilling:
                return
            self._standby_refilling.add(key)

        def refill():
            from ray_tpu_torch._private.worker_pool import PoolWorker

            try:
                while not self._stop_event.is_set():
                    with self._standby_lock:
                        if len(self._standby.get(key, [])) \
                                >= self._standby_target:
                            return
                    try:
                        worker = PoolWorker(-1, extra_env=dict(key))
                    except Exception:  # noqa: BLE001 — the next take spawns
                        return
                    with self._standby_lock:
                        if self._stop_event.is_set():
                            stale = worker
                        else:
                            self._standby.setdefault(key, []).append(worker)
                            stale = None
                    if stale is not None:
                        stale.stop()
                        return
            finally:
                with self._standby_lock:
                    self._standby_refilling.discard(key)

        threading.Thread(target=refill, daemon=True,
                         name="ray_tpu_torch-actor-standby").start()

    def actor_kill(self, actor_key: bytes) -> bool:
        return self._reap_actor(actor_key)

    def _reap_actor(self, actor_key: bytes) -> bool:
        with self._actors_lock:
            actor = self._actors.pop(actor_key, None)
        if actor is not None:
            actor.kill()
        self._release("actor-" + actor_key.hex())
        return actor is not None


# --------------------------------------------------------------------------
# The driver's side
# --------------------------------------------------------------------------


class RemoteNodeHandle:
    """A driver's handle to one node's executor. All task and actor
    traffic shares one multiplexed connection (``pool``); control calls
    go on a short-timeout client, so a ping to a dead node fails
    fast."""

    def __init__(self, node_id, address: str):
        self.node_id = node_id
        self.address = address
        self.pool = MuxRpcClient(address, timeout_s=24 * 3600.0)
        self._control = RpcClient(address, timeout_s=5.0,
                                  connect_timeout_s=2.0)
        self._digest_lock = threading.Lock()
        self.known_digests: set[str] = set()
        self._sys_path_sent = False

    def ping(self) -> bool:
        try:
            return self._control.call("ping") == "pong"
        except (RpcError, RpcMethodError, OSError):
            return False

    def ensure_sys_path(self) -> None:
        """Hand the node this driver's import paths once."""
        if self._sys_path_sent:
            return
        import sys

        try:
            self._control.call("adopt_sys_path", [p for p in sys.path if p])
            self._sys_path_sent = True
        except (RpcError, RpcMethodError, OSError):
            pass  # retried at the next execute

    def execute(self, digest: str, func_blob: bytes, args_blob: bytes,
                n_returns: int, return_keys: list[bytes],
                runtime_env: dict | None, resources: dict[str, float],
                task_token: str | None = None,
                client_addr: str | None = None,
                deadline: float | None = None) -> list:
        """Lease, push and wait for the reply; the function crosses only
        the first time this node meets its digest. Returns the result
        entries. Raises NodeBusyError, NodeOverloadedError or
        TaskDeadlineExpired when the node refused the lease, and the
        task's own exception when it raised."""
        self.ensure_sys_path()
        with self._digest_lock:
            known = digest in self.known_digests
        extra = {} if deadline is None else {"deadline": deadline}
        # Coalesced: a burst of single-path tasks to this node shares
        # __batch__ frames; each reply is still its own.
        reply = self.pool.call(
            "execute_task", digest, None if known else func_blob,
            args_blob, n_returns, return_keys, runtime_env, resources,
            task_token, client_addr, coalesce=True, **extra)
        if reply[0] == "need_func":
            # The node lost the function (it restarted): send it alone,
            # the node kept the arguments under the nonce.
            reply = self.pool.call(
                "execute_task", digest, func_blob, None, n_returns,
                return_keys, runtime_env, resources, task_token,
                client_addr, reply[1], **extra)
            if reply[0] == "stale_args":
                reply = self.pool.call(
                    "execute_task", digest, func_blob, args_blob,
                    n_returns, return_keys, runtime_env, resources,
                    task_token, client_addr, **extra)
        if reply[0] == "busy":
            raise NodeBusyError(self.address)
        if reply[0] == "overloaded":
            raise NodeOverloadedError(reply[1])
        if reply[0] == "timeout":
            raise TaskDeadlineExpired(reply[1])
        if reply[0] == "cancelled":
            from ray_tpu_torch.exceptions import TaskCancelledError

            raise TaskCancelledError()
        with self._digest_lock:
            self.known_digests.add(digest)
        if reply[0] == "err":
            exc, tb = serialization.deserialize_from_buffer(
                memoryview(reply[1]))
            exc.__ray_tpu_remote_tb__ = tb
            raise exc
        return reply[1]

    def execute_batch(self, entries: list, on_results, on_parked=None,
                      on_resumed=None, client_addr: str | None = None,
                      on_started=None) -> tuple:
        """One execute_task_batch RPC for a run of tasks leased to this
        node. ``on_results(group)`` takes each streamed completion group,
        [(idx, reply), ...] in the execute_task reply shape;
        ``on_parked(idx)``/``on_resumed(idx)`` the frames waiting behind
        a blocked lease head or in admission; ``on_started(idx)`` marks
        an entry maybe started. Returns (replies delivered, the fused
        stats of the final reply); the caller fails the indexes that
        never came (a stream cut mid-batch). Raises RpcError or
        RpcMethodError as ``execute`` does."""
        self.ensure_sys_path()
        slot = self.pool.call_streaming("execute_task_batch", entries,
                                        client_addr)
        delivered = 0
        while True:
            part = slot.next_part()
            if part is None:
                break
            kind, payload = part
            if kind == "results":
                delivered += len(payload)
                on_results(payload)
            elif kind == "started" and on_started is not None:
                on_started(payload)
            elif kind == "started_many" and on_started is not None:
                for idx in payload:
                    on_started(idx)
            elif kind == "parked" and on_parked is not None:
                on_parked(payload)
            elif kind == "resumed" and on_resumed is not None:
                on_resumed(payload)
        done = slot.result()  # raises what cut the stream
        stats = done[2] if isinstance(done, tuple) and len(done) > 2 \
            else {}
        return delivered, stats

    def fetch(self, id_bytes: bytes) -> bytes:
        return fetch_blob(self.pool, id_bytes)

    def free(self, ids: list[bytes]) -> None:
        self._control.call("free_objects", ids)

    def close(self) -> None:
        self._control.close()
        self.pool.close()
