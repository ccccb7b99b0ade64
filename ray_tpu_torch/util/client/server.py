"""The client server: the public API of this process's runtime, served
over RPC to its worker processes.

The port of ``ray_tpu/util/client/server.py``. Code in a pool worker or
a process actor calls ``remote``, ``get``, ``put``, ``wait`` and actors
through ``worker_client.WorkerModeRuntime``, which sends each call here;
the endpoints run it against this process's runtime.

Another driver calls a named actor of this process through the same
endpoints (``client_actor_call``, ``client_get``, ``client_release``,
``client_kill_actor``), with the actor's key from the head's directory.

Object lifetime: every ref handed to a worker is pinned in
``self._refs`` until the worker releases it. A worker that unpickles a
ref this process owns registers as its borrower; borrows are leases the
worker keeps alive, so a crashed worker's pins age out.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.rpc import RpcServer


def _runtime():
    from ray_tpu_torch._private.worker import global_runtime

    return global_runtime()


class ClientServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = RpcServer(host, port)
        self._refs: dict[str, Any] = {}       # ref hex -> ObjectRef
        # ref hex -> the ids of the workers borrowing it (and of the
        # claimants it was handed to): the pin stays while any holds it.
        self._borrowers: dict[str, set] = {}
        # (key, borrower id) -> last keepalive.
        self._borrow_seen: dict[tuple, float] = {}
        self._borrow_ttl_s = float(os.environ.get(
            "RAY_TPU_TORCH_BORROW_TTL_S", "60"))
        self._stop = threading.Event()
        # Released keys: a get of one fails even before the reaper has
        # evicted the object.
        self._released: set[str] = set()
        self._actors: dict[str, Any] = {}     # actor hex -> ActorHandle
        self._lock = threading.Lock()
        s = self._server
        s.register("ping", lambda: "pong")
        s.register("client_put", self.put)
        # Long polls run off the connection's thread: the worker's one
        # connection interleaves borrows and releases with a blocked get.
        s.register("client_get", self.get, concurrent=True)
        s.register("client_wait", self.wait, concurrent=True)
        s.register("client_task", self.task)
        s.register("client_create_actor", self.create_actor)
        s.register("client_actor_call", self.actor_call)
        s.register("client_kill_actor", self.kill_actor)
        s.register("client_release", self.release)
        s.register("client_borrow", self.borrow)
        s.register("client_cancel", self.cancel)
        s.register("client_unblock", self.unblock)
        s.register("client_get_actor", self.get_actor)
        s.register("client_cluster_resources", self.cluster_resources)

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def address(self) -> str:
        return self._server.address

    def start(self) -> "ClientServer":
        self._server.start()
        threading.Thread(target=self._janitor_loop, daemon=True,
                         name="ray_tpu_torch-client-borrow-janitor").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.stop()
        with self._lock:
            self._refs.clear()
            self._actors.clear()

    # -- helpers ------------------------------------------------------
    def _track(self, ref, claimant: str | None = None) -> str:
        """Pin a ref handed out, claimed by the receiving worker."""
        key = ref.id().hex()
        with self._lock:
            self._refs[key] = ref
            self._released.discard(key)
            self._borrowers.setdefault(key, set()).add(
                claimant or "__direct__")
        return key

    def _resolve(self, key: str):
        with self._lock:
            if key in self._released:
                raise KeyError(f"released client ref {key}")
            ref = self._refs.get(key)
        if ref is not None:
            return ref
        # Not handed out by this server: a ref this process created that
        # reached a worker inside a task's arguments. This process owns
        # it, so an id the store knows resolves.
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef

        runtime = _runtime()
        oid = ObjectID(bytes.fromhex(key))
        if runtime is not None and (runtime.store.contains(oid)
                                    or runtime.store.is_pending(oid)):
            return ObjectRef(oid)
        raise KeyError(f"unknown/released client ref {key}")

    def _resolve_actor(self, key: str):
        with self._lock:
            handle = self._actors.get(key)
        if handle is not None:
            return handle
        # A handle this process created, passed into a worker's task.
        from ray_tpu_torch._private.ids import ActorID
        from ray_tpu_torch.actor import ActorHandle

        actor_id = ActorID(bytes.fromhex(key))
        runtime = _runtime()
        record = runtime.gcs.get_actor(actor_id) if runtime else None
        if record is None:
            raise KeyError(f"unknown client actor {key}")
        return ActorHandle(actor_id, record.class_name)

    def _deserialize_args(self, args_blob: bytes):
        args, kwargs = serialization.deserialize_from_buffer(
            memoryview(args_blob))

        def convert(v):
            if isinstance(v, tuple) and len(v) == 2 and v[0] == "__ref__":
                return self._resolve(v[1])
            if isinstance(v, tuple) and len(v) == 2 \
                    and v[0] == "__actor__":
                return self._resolve_actor(v[1])
            # Exact container types only: subclasses pass untouched.
            if type(v) is list:
                return [convert(x) for x in v]
            if type(v) is tuple:
                return tuple(convert(x) for x in v)
            if type(v) is dict:
                return {k: convert(x) for k, x in v.items()}
            return v

        return (tuple(convert(a) for a in args),
                {k: convert(v) for k, v in kwargs.items()})

    @staticmethod
    def _block_ctx(block_token: str | None):
        """The calling worker is blocked inside one of this process's
        pool tasks: the context that gives that task's CPU back while it
        waits."""
        runtime = _runtime()
        if block_token is None or runtime is None:
            return None
        return runtime.lookup_block_context(block_token)

    # -- endpoints ----------------------------------------------------
    def put(self, value_blob: bytes, claimant: str | None = None) -> str:
        import ray_tpu_torch

        value = serialization.deserialize_from_buffer(memoryview(value_blob))
        return self._track(ray_tpu_torch.put(value), claimant)

    def get(self, keys: list[str], poll_s: float = 10.0,
            block_token: str | None = None,
            blocked_already: bool = False) -> tuple[str, bytes | None]:
        """("ok", values blob) when every ref is ready within ``poll_s``,
        else ("pending", None); the worker polls again. The calling
        task's CPU is given back at the first poll and taken again only
        at a terminal outcome."""
        import ray_tpu_torch

        refs = [self._resolve(k) for k in keys]
        ctx = self._block_ctx(block_token)
        if ctx is not None and not blocked_already:
            ctx.block()
        terminal = True
        try:
            _, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=poll_s)
            if pending:
                terminal = False
                return ("pending", None)
            return ("ok", serialization.serialize_framed(
                ray_tpu_torch.get(refs)))
        finally:
            if ctx is not None and terminal:
                ctx.unblock(force=True)

    def wait(self, keys: list[str], num_returns: int,
             timeout: float | None, poll_s: float = 10.0,
             block_token: str | None = None,
             blocked_already: bool = False) -> tuple[list[str], list[str]]:
        import ray_tpu_torch

        capped = poll_s if timeout is None else min(timeout, poll_s)
        refs = [self._resolve(k) for k in keys]
        ctx = self._block_ctx(block_token)
        if ctx is not None and not blocked_already:
            ctx.block()
        terminal = True
        try:
            ready, pending = ray_tpu_torch.wait(
                refs, num_returns=num_returns, timeout=capped)
            terminal = (len(ready) >= num_returns
                        or (timeout is not None and timeout <= capped))
            by_ref = {id(r): k for r, k in zip(refs, keys)}
            return ([by_ref[id(r)] for r in ready],
                    [by_ref[id(r)] for r in pending])
        finally:
            if ctx is not None and terminal:
                ctx.unblock(force=True)

    def unblock(self, block_token: str) -> bool:
        """The worker gave up a blocked wait (its timeout): the task's
        CPU is taken again."""
        ctx = self._block_ctx(block_token)
        if ctx is None:
            return False
        ctx.drain()
        return True

    def task(self, func_blob: bytes, args_blob: bytes, options: dict,
             claimant: str | None = None) -> list[str]:
        import ray_tpu_torch

        func = serialization.loads_function(func_blob)
        args, kwargs = self._deserialize_args(args_blob)
        remote_fn = ray_tpu_torch.remote(func)
        if options:
            remote_fn = remote_fn.options(**options)
        out = remote_fn.remote(*args, **kwargs)
        refs = out if isinstance(out, (list, tuple)) else [out]
        return [self._track(r, claimant) for r in refs]

    def create_actor(self, cls_blob: bytes, args_blob: bytes,
                     options: dict) -> str:
        import ray_tpu_torch

        cls = serialization.loads_function(cls_blob)
        args, kwargs = self._deserialize_args(args_blob)
        actor_cls = ray_tpu_torch.remote(cls)
        if options:
            actor_cls = actor_cls.options(**options)
        handle = actor_cls.remote(*args, **kwargs)
        key = handle._actor_id.hex()
        with self._lock:
            self._actors[key] = handle
        return key

    def actor_call(self, actor_key: str, method: str, args_blob: bytes,
                   num_returns: int = 1, claimant: str | None = None,
                   deadline_s: float | None = None) -> list[str]:
        handle = self._resolve_actor(actor_key)
        args, kwargs = self._deserialize_args(args_blob)
        bound = getattr(handle, method).options(num_returns=num_returns)
        if deadline_s is not None:
            bound = bound.options(_deadline_s=deadline_s)
        out = bound.remote(*args, **kwargs)
        refs = out if isinstance(out, (list, tuple)) else [out]
        return [self._track(r, claimant) for r in refs]

    def kill_actor(self, actor_key: str) -> bool:
        import ray_tpu_torch

        with self._lock:
            handle = self._actors.pop(actor_key, None)
        if handle is None:
            try:
                handle = self._resolve_actor(actor_key)
            except KeyError:
                return False
        ray_tpu_torch.kill(handle)
        return True

    def borrow(self, borrower_id: str, keys: list[str]) -> tuple:
        """A worker unpickled these refs and may hold them past its
        call: pin them until it releases them or its lease runs out.
        Objects already gone do not pin. Returns (pinned, TTL in s), so
        the borrower paces its keepalives by this server's clock."""
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef

        runtime = _runtime()
        pinned = 0
        now = time.monotonic()
        for k in keys:
            oid = ObjectID(bytes.fromhex(k))
            exists = runtime is not None and (
                runtime.store.contains(oid) or runtime.store.is_pending(oid))
            # One lock hold per key: a concurrent release must not fall
            # between the pin and the borrower's registration.
            with self._lock:
                if k not in self._refs:
                    if not exists:
                        continue
                    self._refs[k] = ObjectRef(oid)
                    self._released.discard(k)
                self._borrowers.setdefault(k, set()).add(borrower_id)
                self._borrow_seen[(k, borrower_id)] = now
            pinned += 1
        return pinned, self._borrow_ttl_s

    def release(self, keys: list[str],
                borrower_id: str | None = None) -> int:
        with self._lock:
            n = 0
            for k in keys:
                holders = self._borrowers.get(k)
                if holders is not None:
                    holders.discard(borrower_id or "__direct__")
                    self._borrow_seen.pop((k, borrower_id), None)
                    if holders:
                        continue  # other holders keep the pin
                    self._borrowers.pop(k, None)
                if self._refs.pop(k, None) is not None:
                    n += 1
                    self._released.add(k)
            if len(self._released) > 100_000:
                self._released = set(list(self._released)[-50_000:])
        return n

    def _sweep_expired_borrows(self) -> None:
        """Drop the borrows whose keepalives stopped (the worker died
        without releasing)."""
        now = time.monotonic()
        with self._lock:
            expired = [(k, bid) for (k, bid), seen in self._borrow_seen.items()
                       if now - seen > self._borrow_ttl_s]
            for k, bid in expired:
                self._borrow_seen.pop((k, bid), None)
                holders = self._borrowers.get(k)
                if holders is None:
                    continue
                holders.discard(bid)
                if holders:
                    continue
                self._borrowers.pop(k, None)
                if self._refs.pop(k, None) is not None:
                    self._released.add(k)

    def _janitor_loop(self) -> None:
        while not self._stop.wait(min(5.0, self._borrow_ttl_s / 4)):
            try:
                self._sweep_expired_borrows()
            except Exception:  # noqa: BLE001 — the janitor must survive
                pass

    def cancel(self, key: str) -> bool:
        import ray_tpu_torch

        try:
            ray_tpu_torch.cancel(self._resolve(key))
            return True
        except KeyError:
            return False

    def get_actor(self, name: str,
                  namespace: str | None = None) -> tuple[str, str]:
        import ray_tpu_torch

        handle = ray_tpu_torch.get_actor(name, namespace)
        key = handle._actor_id.hex()
        with self._lock:
            self._actors[key] = handle
        return key, handle._class_name

    def cluster_resources(self, available: bool = False) -> dict:
        import ray_tpu_torch

        return (ray_tpu_torch.available_resources() if available
                else ray_tpu_torch.cluster_resources())
