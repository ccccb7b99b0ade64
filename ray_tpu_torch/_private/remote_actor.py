"""The driver's side of an actor that lives on a worker-node daemon.

The port of ``ray_tpu/_private/remote_actor.py``. The runtime leases the
actor's resources on a node and the node starts its process
(``NodeExecutorService.create_actor``), in the daemon's process tree;
this class sends the calls there, in order (or up to
``max_concurrency`` at once), seals their results, and owns placement
and restarts. When the hosting node dies (a call finds it unreachable,
or the node watcher reports its death through ``notify_node_death``)
the actor is built again on a surviving node while ``max_restarts``
allows, from the same constructor arguments.

``RemoteActor`` has ``LocalActor``'s interface (``submit``, ``kill``,
``is_dead``, ``wait_stopped``), so the runtime treats both alike.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorError,
    PendingCallsLimitExceeded,
    TaskCancelledError,
    TaskTimeoutError,
)


class RemoteActor:
    """An actor in a process of its own on a worker-node daemon."""

    # The runtime leaves ObjectRef arguments in place (once sealed); they
    # travel as FetchRef location hints, so the bytes go node to node.
    resolves_refs = True

    def __init__(self, actor_id: ActorID, cls: type, init_args: tuple,
                 init_kwargs: dict, runtime, *, node_id, handle,
                 resources: dict[str, float], max_concurrency: int = 1,
                 max_restarts: int = 0, max_pending_calls: int = -1,
                 creation_return_id: ObjectID | None = None,
                 on_death: Callable[[ActorID, str], None] | None = None,
                 on_release: Callable[[ActorID], None] | None = None,
                 on_restart: Callable[[ActorID], None] | None = None,
                 runtime_env: dict | None = None):
        self.actor_id = actor_id
        self.node_id = node_id
        self._key = actor_id.binary()
        self._cls = cls
        self._init_args = init_args
        self._init_kwargs = init_kwargs
        self._runtime = runtime
        self._handle = handle
        self._resources = dict(resources)
        self._max_concurrency = max(1, int(max_concurrency))
        self._max_restarts = max_restarts
        self._max_pending_calls = max_pending_calls
        self._runtime_env = runtime_env
        self._on_death = on_death
        self._on_release = on_release
        self._on_restart = on_restart
        self._creation_return_id = creation_return_id
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._pending = 0
        self._dead = False
        self._death_reason: str | None = None
        self.num_restarts = 0
        self._gen = 0  # bumps at every failure handled (single flight)
        self.pid: int | None = None
        self._stopped = threading.Event()
        # The calls open as soon as the create request is sent: a call
        # sent before its reply is tagged, and the node holds it for the
        # constructor. _create_settled is set once creation ended.
        self._create_acked = False
        self._create_settled = threading.Event()
        # Clear while a restart moves the actor: a call waits for the new
        # node instead of failing on the dead one (and being counted as
        # one more crash).
        self._relocated = threading.Event()
        self._relocated.set()
        threading.Thread(target=self._run, daemon=True,
                         name=f"ray_tpu_torch-ractor-{cls.__name__}").start()

    # --------------------------------------------- LocalActor's interface

    def submit(self, call) -> None:
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
            self._queue.put(call)

    def kill(self, reason: str = "killed via kill()",
             no_restart: bool = True) -> None:
        with self._lock:
            if self._dead:
                return
            gen = self._gen
            handle = self._handle
        self._kill_remote_copy(handle)
        if no_restart:
            self._mark_dead(reason)
        else:
            # Uses a restart (or dies), off this thread: relocation may
            # block, and kill() returns at once.
            threading.Thread(target=self._handle_crash, args=(gen, reason),
                             daemon=True).start()

    def is_dead(self) -> bool:
        with self._lock:
            return self._dead

    def wait_stopped(self, timeout: float) -> bool:
        """Whether the actor is dead for good, its node copy reaped and
        its lease returned, within ``timeout``."""
        return self._stopped.wait(timeout)

    def notify_node_death(self, node_id) -> None:
        """The hosting node died: restart on a survivor (or die) even
        with no call in flight. The caller is the node watcher, and
        relocation can block, so it runs on a thread of its own."""
        with self._lock:
            # A restart already under way (a call found the node dead
            # first, and dropped it) handles this death.
            if self._dead or node_id != self.node_id \
                    or not self._relocated.is_set():
                return
            gen = self._gen
        threading.Thread(
            target=self._handle_crash,
            args=(gen, f"node {node_id.hex()[:8]} died"), daemon=True,
            name=f"ray_tpu_torch-ractor-restart-{self._cls.__name__}"
        ).start()

    # ---------------------------------------------------------- internals

    def _fail_call(self, call, error: BaseException) -> None:
        for rid in call.return_ids:
            self._runtime.store.put_error(rid, error)

    def _kill_remote_copy(self, handle) -> None:
        """Reap this actor's process on ``handle``'s node (idempotent;
        the node may not host it)."""
        try:
            handle._control.call("actor_kill", self._key)
        except Exception:  # noqa: BLE001 — the node is gone
            pass

    def _run(self) -> None:
        try:
            self._cls_blob = self._runtime._function_blob(self._cls)[1]
            init_blob = self._runtime._convert_remote_args(
                self._init_args, self._init_kwargs)
        except BaseException as exc:  # noqa: BLE001 — cannot leave the driver
            from ray_tpu_torch._private.scheduler import format_traceback

            self._mark_dead(f"constructor args not serializable: {exc!r}")
            if self._creation_return_id is not None:
                self._runtime.store.put_error(
                    self._creation_return_id,
                    ActorError(exc, format_traceback(exc),
                               f"{self._cls.__name__}.__init__"))
            return
        threading.Thread(target=self._create_async, args=(init_blob,),
                         daemon=True,
                         name=f"ray_tpu_torch-ractor-create-"
                              f"{self._cls.__name__}").start()
        if self._max_concurrency > 1:
            self._run_concurrent()
        else:
            self._run_sequential()

    def _create_async(self, init_blob: bytes) -> None:
        try:
            err = self._create_on_cluster(init_blob)
            if err == "dead":
                if self._creation_return_id is not None:
                    self._runtime.store.put_error(
                        self._creation_return_id, ActorDiedError(
                            self.actor_id,
                            self._death_reason or "killed during creation"))
                return
            if err is not None:
                self._mark_dead(f"constructor failed: {err!r}")
                if self._creation_return_id is not None:
                    self._runtime.store.put_error(
                        self._creation_return_id, err)
                return
            if self._creation_return_id is not None:
                self._runtime.store.put(self._creation_return_id, None)
            self._create_acked = True
        finally:
            self._create_settled.set()

    def _create_on_cluster(self, init_blob: bytes, timeout: float = 300.0):
        """Build the instance on the node leased now, moving the lease
        when the node is full or unreachable. None on success, "dead"
        when a kill raced it, else the creation's error."""
        import os
        import sys

        from ray_tpu_torch._private.rpc import RpcError, RpcMethodError

        deadline = time.monotonic() + timeout
        client_addr = self._runtime._client_server_addr() or None
        while True:
            with self._lock:
                if self._dead:
                    return "dead"
                handle, node_id = self._handle, self.node_id
            node_dead = False
            handle.ensure_sys_path()
            try:
                # Coalesced: a wave of actor creations to one node shares
                # __batch__ frames.
                reply = handle.pool.call(
                    "create_actor", self._key, self._cls_blob, init_blob,
                    self._runtime_env, self._max_concurrency,
                    self._resources, client_addr,
                    [p for p in sys.path if p and os.path.isdir(p)],
                    coalesce=True)
            except RpcMethodError as exc:
                return ActorError(exc.cause, exc.remote_tb,
                                  f"{self._cls.__name__}.__init__")
            except (RpcError, OSError):
                if not handle.ping():
                    self._runtime._drop_remote_node(node_id)
                    node_dead = True
                else:
                    # The reply was lost after the send: the node may
                    # have built a copy, which must not be orphaned.
                    self._kill_remote_copy(handle)
                reply = ("busy",)
            if reply[0] == "ok":
                self.pid = reply[1]
                self._runtime._record_actor_placement(self)
                with self._lock:
                    raced_kill = self._dead
                if raced_kill:
                    self._kill_remote_copy(handle)
                    self._runtime._release_actor_lease(self.actor_id)
                    return "dead"
                return None
            if reply[0] == "err":
                exc, tb = serialization.deserialize_from_buffer(
                    memoryview(reply[1]))
                return ActorError(exc, tb, f"{self._cls.__name__}.__init__")
            # Busy or unreachable: move the lease (perhaps back to the
            # same node once it has room); never create without one.
            placed = None
            while placed is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return TimeoutError(
                        f"could not place actor {self._cls.__name__} "
                        f"({self._resources}) on any worker node within "
                        f"{timeout:.0f}s")
                placed = self._runtime._relocate_actor_lease(
                    self.actor_id, self._resources,
                    exclude={node_id} if node_dead else None,
                    timeout=min(remaining, 30.0))
            if placed == "pg_dead":
                return ActorDiedError(self.actor_id,
                                      "its placement-group bundle is gone")
            with self._lock:
                self.node_id, self._handle = placed
            time.sleep(0.05)  # a full cluster is polled, not hammered

    def _run_sequential(self) -> None:
        while (call := self._queue.get()) is not None:
            self._dispatch_call(call)
            # Unbind before blocking: a stale local keeps the last call's
            # arguments alive.
            call = None

    def _run_concurrent(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=self._max_concurrency,
                thread_name_prefix=f"ractor-{self._cls.__name__}") as pool:
            while (call := self._queue.get()) is not None:
                pool.submit(self._dispatch_call, call)
                call = None

    def _dispatch_call(self, call) -> None:
        from ray_tpu_torch._private.rpc import RpcError, RpcMethodError

        self._relocated.wait()
        with self._lock:
            self._pending = max(0, self._pending - 1)
            if self._dead:
                self._fail_call(call, ActorDiedError(
                    self.actor_id, self._death_reason or "actor died"))
                return
            gen, handle, node_id = self._gen, self._handle, self.node_id
        site = f"{self._cls.__name__}.{call.method_name}"
        if call.cancelled:
            self._fail_call(call, TaskCancelledError())
            return
        if call.deadline is not None and time.time() > call.deadline:
            self._fail_call(call, TaskTimeoutError(site, "actor_queue",
                                                   call.deadline))
            return
        try:
            args_blob = self._runtime._convert_remote_args(call.args,
                                                           call.kwargs)
        except BaseException as exc:  # noqa: BLE001 — unpicklable arguments
            self._fail_call(call, ActorError(
                exc, "", f"{site} (argument serialization)"))
            return
        # A call sent before the create reply landed is tagged: the node
        # holds it for the constructor in flight.
        pre_ack = not self._create_acked
        try:
            reply = handle.pool.call(
                "actor_call", self._key, call.method_name, args_blob,
                len(call.return_ids), [r.binary() for r in call.return_ids],
                pre_ack, coalesce=True)
        except RpcMethodError as exc:
            self._fail_call(call, ActorError(exc.cause, exc.remote_tb, site))
            return
        except (RpcError, OSError) as exc:
            if handle.ping():
                # One reset socket on a live node does not kill the actor:
                # only this call fails (it may or may not have run).
                self._fail_call(call, ActorError(
                    exc, "", f"{site} (transport failure; actor alive)"))
                return
            self._fail_call(call, ActorDiedError(
                self.actor_id, f"node {node_id.hex()[:8]} unreachable: "
                               f"{exc}"))
            self._handle_crash(gen, f"node unreachable: {exc}")
            return
        if reply[0] == "ok":
            if pre_ack:
                # The node answered once the constructor ran, which can be
                # before this driver took in the creation's reply: seal
                # after it, so the actor table has the actor's node and
                # pid before any of its results is seen.
                self._create_settled.wait(timeout=600.0)
            try:
                self._runtime._seal_remote_results(
                    call.return_ids, reply[1], node_id, handle.address)
            except BaseException as exc:  # noqa: BLE001 — a result failed to pickle
                self._fail_call(call, ActorError(
                    exc, getattr(exc, "__ray_tpu_remote_tb__", "") or "",
                    site))
        elif reply[0] == "err":
            exc, tb = serialization.deserialize_from_buffer(
                memoryview(reply[1]))
            self._fail_call(call, ActorError(exc, tb, site))
        else:  # ("dead", blob) | ("gone",)
            if reply[0] == "gone" and pre_ack \
                    and not getattr(call, "_gone_retry", False):
                # The call raced a creation that moved to another node:
                # the actor was never lost. Resend once it settled.
                call._gone_retry = True
                self._create_settled.wait(timeout=600.0)
                with self._lock:
                    self._pending += 1
                self._dispatch_call(call)
                return
            reason = "actor process died" if reply[0] == "dead" \
                else "the hosting node lost the actor (restarted?)"
            self._fail_call(call, ActorDiedError(self.actor_id, reason))
            self._handle_crash(gen, reason)

    def _handle_crash(self, gen: int, reason: str) -> None:
        """Restart or die, once per failure: while restarts remain, the
        lease moves to a surviving node and the constructor runs there."""
        with self._lock:
            if self._dead or gen != self._gen:
                return  # another thread handled this failure
            self._gen += 1
            restartable = self.num_restarts < self._max_restarts
            if restartable:
                self.num_restarts += 1
                self._relocated.clear()
            handle, node_id = self._handle, self.node_id
        if not restartable:
            self._mark_dead(reason)
            return
        exclude = None
        if not handle.ping():
            self._runtime._drop_remote_node(node_id)
            exclude = {node_id}
        else:
            # The node lives: its copy goes before the new one is built,
            # or it is orphaned holding its reservation.
            self._kill_remote_copy(handle)
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        # How long a restarting actor waits for a node to host it.
        timeout = float(GLOBAL_CONFIG.actor_restart_relocate_timeout_s)
        placed = self._runtime._relocate_actor_lease(
            self.actor_id, self._resources, exclude=exclude,
            timeout=timeout)
        if placed is None or placed == "pg_dead":
            self._mark_dead(f"no surviving worker node to restart on "
                            f"({reason})")
            return
        with self._lock:
            self.node_id, self._handle = placed
            self._create_acked = False
            self._create_settled.clear()
        self._relocated.set()
        try:
            init_blob = self._runtime._convert_remote_args(
                self._init_args, self._init_kwargs)
            err = self._create_on_cluster(init_blob, timeout=timeout)
        except BaseException as exc:  # noqa: BLE001 — the restart failed
            err = exc
        finally:
            self._create_settled.set()
        if err == "dead":
            return  # a kill raced the restart and cleaned up
        if err is not None:
            self._mark_dead(f"restart failed: {err!r}")
            return
        self._create_acked = True
        if self._on_restart is not None:
            self._on_restart(self.actor_id)

    def _mark_dead(self, reason: str) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._death_reason = reason
            drained = []
            try:
                while True:
                    item = self._queue.get_nowait()
                    if item is not None:
                        drained.append(item)
            except queue.Empty:
                pass
            self._pending = 0
        self._queue.put(None)  # ends the dispatch loop
        for call in drained:
            self._fail_call(call, ActorDiedError(self.actor_id, reason))
        self._create_settled.set()
        self._relocated.set()
        if self._on_death is not None:
            self._on_death(self.actor_id, reason)
        if self._on_release is not None:
            self._on_release(self.actor_id)
        self._stopped.set()
