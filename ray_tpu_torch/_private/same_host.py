"""The same-host plane: the pieces the node executor and the driver's
export server share.

The port of ``ray_tpu/_private/same_host.py``. When two daemons (or a
daemon and the driver) share a host, a fetch need not move the bytes
through the RPC transport: the holder's copy is in a named POSIX
shared-memory segment, and the puller maps it (a pool task's argument,
zero copies) or copies out of it once (a read in the daemon's own
process, or the driver's).

- ``host_identity()``: a durable host id (the boot id and the uid, not
  an IP address: many daemons share one address on a test box). It is
  published with the node's registration and echoed in ``fetch_plan``
  replies, so a puller recognises a holder on its own host.
- ``LeaseTable``: the owner's pin registry. A puller takes a lease
  before it maps or copies, and the owner keeps the object for the
  lease's life. A lease ends by ``unpin_object`` or, once it outlives
  the TTL and its holder stops answering pings, by the sweep: a dead
  puller cannot pin an object forever.
- ``attach_segment``, ``read_segment``, ``PeerArenaRegistry`` and
  ``fetch_mapped_blob``: the puller's side.
- ``sweep_orphan_shm``: unlinks the arenas of owners that died.

A map source crosses the RPC boundary as a plain dict: ``{"kind": "seg"
or "arena", "name": ..., "key": ..., "size": ..., "host": ...,
"token": ...}``. A ``"seg"`` source is a named segment of its own; an
``"arena"`` source is an object (``key``) in the owner's native arena
(``name``), which only a driver owns (an export of at most
``object_arena_max_object_bytes``): the owner pins it for the lease's
life, and the puller attaches the arena and reads it without touching
its references.

Not ported: the ``lease.expire`` chaos site (ROADMAP item 10c).
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Callable

_HOST_ID: str | None = None
_HOST_ID_LOCK = threading.Lock()

# Tests set it to stand in for a second host on one machine.
HOST_ID_ENV = "RAY_TPU_TORCH_HOST_ID"


def host_identity() -> str:
    """This host's identity: the same in every process, new after a
    reboot. ``RAY_TPU_TORCH_HOST_ID`` overrides it."""
    global _HOST_ID
    override = os.environ.get(HOST_ID_ENV)
    if override:
        return override
    with _HOST_ID_LOCK:
        if _HOST_ID is None:
            boot_id = ""
            try:
                with open("/proc/sys/kernel/random/boot_id") as f:
                    boot_id = f.read().strip()
            except OSError:
                pass  # no boot id here: the fallback below
            if not boot_id:
                import socket
                import uuid

                boot_id = f"{socket.gethostname()}-{uuid.getnode():x}"
            # Shared memory is per user on some systems, and the uid is
            # shm_open's permission boundary.
            _HOST_ID = f"{boot_id}:{os.getuid()}"
        return _HOST_ID


def map_enabled() -> bool:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return bool(GLOBAL_CONFIG.same_host_plane)


def map_min_bytes() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return int(GLOBAL_CONFIG.same_host_map_min_kb) * 1024


def pin_ttl_s() -> float:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return float(GLOBAL_CONFIG.same_host_pin_ttl_s)


class LeaseTable:
    """The owner's registry of the objects it mapped out.

    ``grant`` records a lease (the caller pinned the object first and
    hands the unpin here as ``on_release``); ``release`` ends it.
    ``sweep`` ends the leases that are older than the TTL and whose
    holder does not answer: a healthy puller that holds a mapping for a
    long time keeps its lease, a killed one cannot pin the owner's
    memory past one TTL and a sweep period."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        # token -> (id_bytes, holder_addr, granted_monotonic, on_release)
        self._leases: dict[str, tuple] = {}
        self.granted = 0
        self.released = 0
        self.expired = 0

    def grant(self, id_bytes: bytes, holder: str,
              on_release: Callable[[], None] | None = None) -> str:
        with self._lock:
            self._next += 1
            token = f"{self._next}-{os.urandom(4).hex()}"
            self._leases[token] = (id_bytes, holder, time.monotonic(),
                                   on_release)
            self.granted += 1
        return token

    def release(self, token: str) -> bool:
        with self._lock:
            lease = self._leases.pop(token, None)
            if lease is not None:
                self.released += 1
        if lease is None:
            return False
        self._run_release(lease)
        return True

    def release_object(self, id_bytes: bytes) -> int:
        """The owner freed the object: every lease on it ends."""
        with self._lock:
            victims = [t for t, l in self._leases.items()
                       if l[0] == id_bytes]
            leases = [self._leases.pop(t) for t in victims]
            self.released += len(leases)
        for lease in leases:
            self._run_release(lease)
        return len(leases)

    def pinned_ids(self) -> set[bytes]:
        with self._lock:
            return {l[0] for l in self._leases.values()}

    def sweep(self, ttl_s: float,
              probe: Callable[[str], bool] | None = None) -> int:
        """End the leases older than ``ttl_s`` whose holder is
        unreachable (``probe`` returns False or raises). With no probe,
        age alone expires a lease."""
        now = time.monotonic()
        with self._lock:
            stale = [(t, l) for t, l in self._leases.items()
                     if now - l[2] > ttl_s]
        expired = []
        alive_holders: dict[str, bool] = {}
        for token, lease in stale:
            holder = lease[1]
            if probe is not None:
                if holder not in alive_holders:
                    try:
                        alive_holders[holder] = bool(probe(holder))
                    except Exception:  # noqa: BLE001 — unreachable
                        alive_holders[holder] = False
                if alive_holders[holder]:
                    # The holder lives: its lease starts a new TTL rather
                    # than being probed at every pass.
                    with self._lock:
                        if token in self._leases:
                            i, h, _, cb = self._leases[token]
                            self._leases[token] = (i, h, now, cb)
                    continue
            with self._lock:
                lease = self._leases.pop(token, None)
                if lease is not None:
                    self.expired += 1
            if lease is not None:
                expired.append(lease)
        for lease in expired:
            self._run_release(lease)
        return len(expired)

    def clear(self) -> None:
        with self._lock:
            leases = list(self._leases.values())
            self._leases.clear()
        for lease in leases:
            self._run_release(lease)

    @staticmethod
    def _run_release(lease: tuple) -> None:
        cb = lease[3]
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — a release is best-effort
                pass

    def stats(self) -> dict:
        with self._lock:
            return {"active": len(self._leases), "granted": self.granted,
                    "released": self.released, "expired": self.expired}


def pid_is_dead(pid: int) -> bool:
    """True only for a pid that provably does not exist (a 0-signal
    probe): a process of another user (EPERM) counts as alive, so what
    another user holds is never touched. The sweeps of dead owners'
    arenas (``sweep_orphan_shm``) and of dead daemons' spill directories
    use it."""
    try:
        os.kill(pid, 0)
        return False
    except ProcessLookupError:
        return True
    except PermissionError:
        return False




def arena_owner_pid(name: str) -> int | None:
    """The owner's pid in a driver arena's name
    (``[/]ray_tpu_torch_arena_<pid>``), else None. The JAX package's
    arenas (``ray_tpu_arena_<pid>``) never match."""
    from ray_tpu_torch._private.arena_store import ARENA_PREFIX

    match = re.fullmatch(re.escape(ARENA_PREFIX) + r"(\d+)",
                         name.lstrip("/"))
    return None if match is None else int(match.group(1))


def sweep_orphan_shm() -> int:
    """Unlink the arenas (``/dev/shm/ray_tpu_torch_arena_<pid>``) whose
    owner died without destroying them; the number unlinked. An arena is
    made by ``shm_open`` in C, so no resource tracker unlinks it after a
    SIGKILL: any process of the host that lives on (a daemon's sweep, the
    driver's pin sweeper) does. Only this user's segments of provably
    dead pids are touched; a mapping of an unlinked arena stays valid."""
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return 0
    swept = 0
    for name in names:
        pid = arena_owner_pid(name)
        if pid is None or pid == os.getpid() or not pid_is_dead(pid):
            continue
        path = os.path.join("/dev/shm", name)
        try:
            if os.stat(path).st_uid != os.getuid():
                continue
            os.unlink(path)
            swept += 1
        except OSError:
            continue  # another sweeper won, or not ours to remove
    return swept


class PeerArenaRegistry:
    """This process's attachments of other processes' arenas, by name.
    They are kept while their owner lives (a mapping is cheap to hold and
    dear to churn), detached once it has died (``close_dead_owners``: an
    unlinked arena's pages stay committed while any mapping holds them,
    and the port reserves every page at create) and at ``close_all``.
    The mapping is read only: the puller takes no reference in the
    owner's arena (the owner pins for it under the lease), so a puller
    that crashes cannot wedge or corrupt the owner's arena."""

    def __init__(self):
        self._lock = threading.Lock()
        self._arenas: dict[str, object] = {}

    def get(self, name: str):
        from ray_tpu_torch._private.arena_store import ArenaStore

        with self._lock:
            arena = self._arenas.get(name)
        if arena is not None:
            return arena
        # A new attachment: a process that serves driver after driver
        # lets the dead ones' arenas go first.
        self.close_dead_owners()
        with self._lock:
            arena = self._arenas.get(name)
            if arena is None:
                arena = ArenaStore.attach(name)
                if arena is not None:
                    self._arenas[name] = arena
            return arena

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._arenas)

    def close_dead_owners(self) -> int:
        """Detach the arenas whose owner provably died; the number
        detached."""
        with self._lock:
            dead = [name for name in self._arenas
                    if (pid := arena_owner_pid(name)) is not None
                    and pid_is_dead(pid)]
            arenas = [self._arenas.pop(name) for name in dead]
        for arena in arenas:
            try:
                arena.close()
            except Exception:  # noqa: BLE001 — a detach is best-effort
                pass
        return len(arenas)

    def read(self, name: str, key: bytes) -> bytes | None:
        """A copy of a sealed object in a peer's arena, made with the
        attachment held open; None when the arena or the object is
        gone."""
        arena = self.get(name)
        return None if arena is None else arena.read_sealed(key)

    def close_all(self) -> None:
        with self._lock:
            arenas = list(self._arenas.values())
            self._arenas.clear()
        for arena in arenas:
            try:
                arena.close()
            except Exception:  # noqa: BLE001 — a detach is best-effort
                pass


def attach_segment(name: str):
    """Open a peer's segment by name. On Python 3.12+, which registers an
    attach with the resource tracker, the attach is untracked, so this
    process's exit never unlinks the owner's segment; earlier Pythons do
    not register attaches. Raises OSError when the name is gone."""
    import sys
    from multiprocessing import shared_memory

    from ray_tpu_torch._private.shm_store import untrack

    seg = shared_memory.SharedMemory(name=name)
    if sys.version_info >= (3, 12):
        untrack(seg)
    return seg


def read_segment(name: str, size: int) -> bytes:
    """The first ``size`` bytes of a peer's segment, in one copy: read
    from its file, not through a mapping, whose page faults on a freshly
    mapped source cost more than the copy itself on an H100 machine's
    host. The bytes are immutable, as a chunked pull's are: a value
    deserialized from them copies before it can be written, so a task
    that changes its argument never changes the cached copy. Raises
    OSError when the name is gone."""
    import _posixshmem

    fd = _posixshmem.shm_open("/" + name.lstrip("/"), os.O_RDONLY,
                              mode=0o600)
    try:
        parts, done = [], 0
        while done < size:
            got = os.read(fd, size - done)
            if not got:
                raise OSError(f"segment {name} is shorter than {size}")
            parts.append(got)
            done += len(got)
        return parts[0] if len(parts) == 1 else b"".join(parts)
    finally:
        os.close(fd)


def fetch_mapped_blob(call, id_bytes: bytes, my_addr: str, my_host: str,
                      plan_out: dict | None = None):
    """One read for a consumer that keeps no mappings (the driver reading
    a node's result): ask the holder for a plan and, when it grants a map
    lease, copy the framed bytes straight out of its segment, one copy
    (``read_segment``) and no chunked RPC. Returns the bytes, or None
    (the caller pulls in chunks). The lease is released either way.
    ``plan_out``, when given, receives the plan's fourth element
    (``{"spilled": ...}``)."""
    try:
        plan = call("fetch_plan", id_bytes, my_addr, my_host)
    except Exception:  # noqa: BLE001 — the holder is gone
        return None
    if plan_out is not None and plan is not None and len(plan) > 3 \
            and plan[3]:
        plan_out.update(plan[3])
    info = plan[2] if plan is not None and len(plan) > 2 else None
    if not info or info.get("host") != my_host or not info.get("token"):
        return None
    token = info["token"]
    try:
        if info.get("kind") == "seg":
            return read_segment(info["name"], int(info.get("size", 0)))
        if info.get("kind") == "arena":
            from ray_tpu_torch._private.arena_store import ArenaStore

            arena = ArenaStore.attach(info["name"])
            if arena is None:
                return None
            try:
                return arena.read_sealed(info["key"])
            finally:
                arena.close()
        return None
    except Exception:  # noqa: BLE001 — any failure: the chunked pull
        return None
    finally:
        try:
            call("unpin_object", token)
        except Exception:  # noqa: BLE001 — the TTL sweep is the backstop
            pass
