"""The worker-side runtime: the public API inside a worker process.

The port of ``ray_tpu/_private/worker_client.py``. Code running in a
pool worker or a process actor may call ``remote``, ``get``, ``put``,
``wait`` and actors, as every Ray worker may; here a worker holds no
runtime of its own but ``WorkerModeRuntime``, which sends each call to
the driver's client server (``util/client/server.py``). ObjectRefs made
in a worker are ids of objects the driver holds, so they flow freely
between nested calls, task returns and the driver.

A worker blocked in ``get()`` sends its task's token with the call; the
driver gives that task's CPU back while the wait lasts (the process
counterpart of ``BlockedResourceContext``), so an outer task waiting on
an inner one never starves it.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Sequence

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.rpc import MuxRpcClient

ADDRESS_ENV = "RAY_TPU_TORCH_DRIVER_CLIENT_ADDR"

# Set by the worker's serve loop around each task; sent with blocking
# get/wait calls so the driver gives the task's CPU back.
_current_task_token: str | None = None

_active_lock = threading.Lock()
_active: "WorkerModeRuntime | None" = None


def current_task_token() -> str | None:
    return _current_task_token


def set_task_token(token: str | None) -> None:
    global _current_task_token
    _current_task_token = token


def active_worker_runtime() -> "WorkerModeRuntime | None":
    return _active


def use_address(address: str) -> None:
    """Point this process's public API at ``address``: a node daemon's
    pool worker serves tasks of whichever driver submitted them."""
    global _active
    with _active_lock:
        if os.environ.get(ADDRESS_ENV) == address:
            return
        os.environ[ADDRESS_ENV] = address
        stale, _active = _active, None
    if stale is not None:
        stale.shutdown()


def get_worker_runtime() -> "WorkerModeRuntime":
    """The process's proxy runtime, made at its first use."""
    global _active
    with _active_lock:
        if _active is None:
            address = os.environ.get(ADDRESS_ENV)
            if not address:
                raise RuntimeError(
                    "the public API inside a worker process needs the "
                    f"driver's client server ({ADDRESS_ENV} is not set)")
            _active = WorkerModeRuntime(address)
        return _active


class _ProxyReferenceCounter:
    """The borrower half of the ownership protocol: the first handle of
    an object in this process registers a borrow with the driver, the
    last one gone releases it.

    ``defer_remove`` (the ObjectRef destructor's entry) only appends to a
    deque, and ``add_ref`` (which runs while a reply is unpickled) only
    queues the borrow: a reaper thread makes the calls."""

    def __init__(self, runtime: "WorkerModeRuntime"):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._counts: dict[ObjectID, int] = {}
        self._deferred: "collections.deque[ObjectID]" = collections.deque()
        self._pending_borrows: "collections.deque[ObjectID]" = \
            collections.deque()
        # Borrows are leases on the driver: keep them alive well inside
        # its TTL (the driver's reply gives the TTL).
        self._keepalive_s = 15.0
        threading.Thread(target=self._reap_loop, daemon=True,
                         name="ray_tpu_torch-proxy-ref-reaper").start()

    def add_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            count = self._counts.get(object_id, 0)
            self._counts[object_id] = count + 1
            if count == 0:
                self._pending_borrows.append(object_id)

    def defer_remove(self, object_id: ObjectID) -> None:
        self._deferred.append(object_id)

    def _flush_borrows(self, extra: list) -> None:
        batch = list(extra)
        with self._lock:
            while self._pending_borrows:
                batch.append(self._pending_borrows.popleft().hex())
        if batch:
            try:
                _, ttl = self._runtime._rpc.call(
                    "client_borrow", self._runtime.borrower_id, batch)
                if ttl > 0:
                    self._keepalive_s = ttl / 4
            except Exception:  # noqa: BLE001 — the driver is going away
                pass

    def _reap_loop(self) -> None:
        last_keepalive = time.monotonic()
        while True:
            keepalive = []
            if time.monotonic() - last_keepalive >= self._keepalive_s:
                last_keepalive = time.monotonic()
                with self._lock:
                    keepalive = [oid.hex() for oid in self._counts]
            self._flush_borrows(keepalive)
            try:
                object_id = self._deferred.popleft()
            except IndexError:
                time.sleep(0.02)
                continue
            try:
                self.remove_ref(object_id)
            except Exception:  # noqa: BLE001 — the reaper must survive
                pass

    def remove_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            count = self._counts.get(object_id)
            if count is None:
                return
            if count > 1:
                self._counts[object_id] = count - 1
                return
            del self._counts[object_id]
            # A borrow still queued must never follow the release: it
            # would pin a freed key for good.
            try:
                self._pending_borrows.remove(object_id)
            except ValueError:
                pass
        try:
            self._runtime._rpc.call("client_release", [object_id.hex()],
                                    borrower_id=self._runtime.borrower_id)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class _NullGcs:
    """``ActorHandle.__getattr__`` reads an actor's method metadata from
    the GCS table, which lives in the driver: default it."""

    def get_actor(self, actor_id):
        return None


def _resource_options(resources: dict[str, float]) -> dict:
    opts: dict[str, Any] = {"num_cpus": resources.get("CPU", 0.0)}
    if "GPU" in resources:
        opts["num_gpus"] = resources["GPU"]
    if "TPU" in resources:
        opts["num_tpus"] = resources["TPU"]
    rest = {k: v for k, v in resources.items()
            if k not in ("CPU", "GPU", "TPU")}
    if rest:
        opts["resources"] = rest
    return opts


def _strategy_options(strategy) -> dict:
    """Driver-side options of a strategy; a hard constraint is carried
    over or refused, never dropped."""
    kind = getattr(strategy, "kind", "DEFAULT") if strategy else "DEFAULT"
    if kind == "DEFAULT":
        return {}
    if kind == "SPREAD":
        return {"scheduling_strategy": "SPREAD"}
    if kind == "NODE_AFFINITY":
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        return {"scheduling_strategy": NodeAffinitySchedulingStrategy(
            node_id=strategy.node_id, soft=strategy.soft)}
    raise ValueError(f"{kind} scheduling is not supported for work "
                     f"submitted from inside worker processes")


class WorkerModeRuntime:
    """The part of ``Runtime`` the public API uses, over RPC."""

    _POLL_S = 10.0

    def __init__(self, address: str):
        # One connection carries the reaper's borrows and releases beside
        # a long-poll get in flight.
        self._rpc = MuxRpcClient(address, timeout_s=60.0)
        # Per-process identity: the driver keys its pins by it, so two
        # workers borrowing one ref release it independently.
        self.borrower_id = f"worker-{os.getpid()}-{os.urandom(3).hex()}"
        self.reference_counter = _ProxyReferenceCounter(self)
        self.gcs = _NullGcs()
        self.namespace = "default"

    @staticmethod
    def _marshal(args: tuple, kwargs: dict) -> bytes:
        """ObjectRefs and ActorHandles become keys the client server
        resolves."""
        from ray_tpu_torch.actor import ActorHandle

        def convert(v):
            if isinstance(v, ObjectRef):
                return ("__ref__", v.hex())
            if isinstance(v, ActorHandle):
                return ("__actor__", v._actor_id.hex())
            if type(v) is list:
                return [convert(x) for x in v]
            if type(v) is tuple:
                return tuple(convert(x) for x in v)
            if type(v) is dict:
                return {k: convert(x) for k, x in v.items()}
            return v

        return serialization.serialize_framed(
            (tuple(convert(a) for a in args),
             {k: convert(v) for k, v in kwargs.items()}))

    @staticmethod
    def _new_refs(keys: list[str]) -> list[ObjectRef]:
        return [ObjectRef(ObjectID(bytes.fromhex(k))) for k in keys]

    # -- tasks ----------------------------------------------------------
    def submit_task(self, func, args: tuple, kwargs: dict, *, name: str,
                    num_returns: int = 1, resources: dict[str, float],
                    max_retries: int = 0, retry_exceptions=False,
                    scheduling_strategy=None,
                    runtime_env: dict | None = None,
                    deadline_s: float | None = None) -> list[ObjectRef]:
        options = _resource_options(resources)
        options.update(name=name, num_returns=num_returns,
                       max_retries=max_retries,
                       retry_exceptions=retry_exceptions)
        if runtime_env:
            options["runtime_env"] = runtime_env
        if deadline_s is not None:
            # A relative budget: the driver stamps the absolute deadline.
            options["_deadline_s"] = deadline_s
        options.update(_strategy_options(scheduling_strategy))
        keys = self._rpc.call(
            "client_task", serialization.dumps_function(func),
            self._marshal(args, kwargs), options,
            claimant=self.borrower_id)
        return self._new_refs(keys)

    # -- objects --------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed")
        key = self._rpc.call("client_put",
                             serialization.serialize_framed(value),
                             claimant=self.borrower_id)
        return self._new_refs([key])[0]

    def _abandon_block(self, token: str | None, blocked: bool) -> None:
        if token is not None and blocked:
            try:
                self._rpc.call("client_unblock", token)
            except Exception:  # noqa: BLE001 — best-effort restore
                pass

    def get(self, refs: Sequence[ObjectRef],
            timeout: float | None = None) -> list[Any]:
        keys = [r.hex() for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        token = current_task_token()
        blocked = False  # a "pending" round left the task's CPU released
        try:
            while True:
                poll = self._POLL_S
                if deadline is not None:
                    poll = min(poll, max(0.0, deadline - time.monotonic()))
                status, blob = self._rpc.call("client_get", keys, poll,
                                              token, blocked)
                if status == "ok":
                    blocked = False
                    return list(serialization.deserialize_from_buffer(
                        memoryview(blob)))
                blocked = token is not None
                if deadline is not None and time.monotonic() >= deadline:
                    from ray_tpu_torch.exceptions import GetTimeoutError

                    raise GetTimeoutError(
                        f"get() timed out after {timeout}s (nested)")
        finally:
            self._abandon_block(token, blocked)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: float | None = None):
        by_key = {r.hex(): r for r in refs}
        deadline = None if timeout is None else time.monotonic() + timeout
        token = current_task_token()
        blocked = False
        try:
            while True:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                ready, pending = self._rpc.call(
                    "client_wait", list(by_key), num_returns, remaining,
                    self._POLL_S, token, blocked)
                if len(ready) >= num_returns or (
                        remaining is not None and remaining <= 0):
                    blocked = False
                    return ([by_key[k] for k in ready],
                            [by_key[k] for k in pending])
                blocked = token is not None
        finally:
            self._abandon_block(token, blocked)

    def cancel(self, ref: ObjectRef) -> None:
        self._rpc.call("client_cancel", ref.hex())

    # -- actors ---------------------------------------------------------
    def create_actor(self, cls: type, args: tuple, kwargs: dict, *,
                     name: str | None = None, namespace: str | None = None,
                     resources: dict[str, float], max_concurrency: int = 1,
                     max_restarts: int = 0, max_pending_calls: int = -1,
                     concurrency_groups: dict | None = None,
                     scheduling_strategy=None, get_if_exists: bool = False,
                     process: bool = False, runtime_env: dict | None = None,
                     deadline_s: float | None = None):
        options = _resource_options(resources)
        options.update(max_concurrency=max_concurrency,
                       max_restarts=max_restarts,
                       max_pending_calls=max_pending_calls)
        if concurrency_groups:
            options["concurrency_groups"] = concurrency_groups
        if deadline_s is not None:
            options["_deadline_s"] = deadline_s
        options.update(_strategy_options(scheduling_strategy))
        if name is not None:
            options["name"] = name
        if namespace is not None:
            options["namespace"] = namespace
        if get_if_exists:
            options["get_if_exists"] = True
        if process:
            options["process"] = True
        if runtime_env:
            options["runtime_env"] = runtime_env
        key = self._rpc.call("client_create_actor",
                             serialization.dumps_function(cls),
                             self._marshal(args, kwargs), options)
        return ActorID(bytes.fromhex(key)), None

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict, num_returns: int = 1,
                          deadline_s: float | None = None
                          ) -> list[ObjectRef]:
        keys = self._rpc.call(
            "client_actor_call", actor_id.hex(), method_name,
            self._marshal(args, kwargs), num_returns,
            claimant=self.borrower_id, deadline_s=deadline_s)
        return self._new_refs(keys)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._rpc.call("client_kill_actor", actor_id.hex())

    def get_actor_handle(self, name: str, namespace: str | None = None):
        from ray_tpu_torch.actor import ActorHandle

        key, class_name = self._rpc.call("client_get_actor", name, namespace)
        return ActorHandle(ActorID(bytes.fromhex(key)), class_name)

    # -- the rest of the surface ----------------------------------------
    def cluster_resources(self) -> dict[str, float]:
        return self._rpc.call("client_cluster_resources", False)

    def available_resources(self) -> dict[str, float]:
        return self._rpc.call("client_cluster_resources", True)

    def attach_future(self, ref, fut) -> None:
        def resolve():
            try:
                fut.set_result(self.get([ref])[0])
            except BaseException as exc:  # noqa: BLE001 — the future carries it
                if not fut.cancelled():
                    fut.set_exception(exc)

        threading.Thread(target=resolve, daemon=True).start()

    def shutdown(self) -> None:
        global _active
        self._rpc.close()
        with _active_lock:
            if _active is self:
                _active = None
