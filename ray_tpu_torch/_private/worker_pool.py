"""Worker processes: the pool that runs tasks, and process actors.

The port of ``ray_tpu/_private/worker_pool.py``. With
``init(process_workers=N)`` the driver keeps N worker processes, sends
each task over a duplex pipe behind the serialization boundary
(``serialization.py``) and moves data through shared memory
(``shm_store.py``): a result, a promoted argument or an export of at
most ``object_arena_max_object_bytes`` through the driver's native
arena, which each of its worker processes attaches by the name it is
handed (``RAY_TPU_TORCH_ARENA_NAME``; a node daemon's workers get none),
and a larger one through a segment of its own. An argument passed from
worker to worker never copies through the driver. Threads of one process share one GIL; a
worker process does not, so CPU-bound fan-out runs on as many cores as
there are workers. A crashed worker is seen as the pipe's EOF: its task
fails with ``WorkerCrashedError`` (retried as a system failure while
retries remain) and the pool starts another.

A process actor (``ProcessActor``) has a worker process to itself: its
constructor and its calls run there in submission order, or, with
``max_concurrency > 1``, multiplexed over the pipe onto a thread pool in
the worker. ``max_restarts`` starts a new process and runs the
constructor again.

Where the port departs from the reference: the reference's workers are
CPU processes (``JAX_PLATFORMS=cpu``), a task asking for ``TPU`` never
goes to the pool, and a TPU host's chips belong to one process. A CUDA
card has no such lock, so a process actor whose lease holds ``GPU`` is
started as a fresh interpreter (as the reference starts an
``allow_tpu`` worker, never a fork of the factory) with
``CUDA_VISIBLE_DEVICES`` listing exactly the cards it leased; every
other worker process gets ``CUDA_VISIBLE_DEVICES=""``, and a task that
asks for ``GPU`` stays on a thread of the driver.

Code in a worker may call the whole public API (``worker_client.py``);
a nested ``get()`` of a task gives the task's CPU back while it blocks,
and the pool grows on demand (up to its cap), so an outer task waiting
on an inner one never starves it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

from ray_tpu_torch._private import perf_plane as perf
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.shm_store import (
    ArenaDescriptor,
    ShmClient,
    ShmDescriptor,
    ShmDirectory,
    untrack,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorError,
    PendingCallsLimitExceeded,
    TaskTimeoutError,
    WorkerCrashedError,
)

IN_WORKER_ENV = "RAY_TPU_TORCH_IN_POOL_WORKER"
LOG_DIR_ENV = "RAY_TPU_TORCH_WORKER_LOG_DIR"
THREADS_ENV = "RAY_TPU_TORCH_WORKER_THREADS"
# Set for a GPU process actor when the driver sees a card: the actor
# then refuses to start without one instead of running on the CPU.
REQUIRE_CARD_ENV = "RAY_TPU_TORCH_REQUIRE_CARD"
_AUTHKEY_ENV = "RAY_TPU_TORCH_WORKER_AUTHKEY"

# The runtime_env fields that need a package manager or a container:
# ROADMAP queue 1, item 12.
_REFUSED_RUNTIME_ENV = ("pip", "conda", "container")


def validate_runtime_env(runtime_env: dict | None) -> None:
    """Refuse the fields the port does not bring yet."""
    refused = sorted(k for k in (runtime_env or {})
                     if k in _REFUSED_RUNTIME_ENV)
    if refused:
        raise ValueError(
            f"runtime_env {refused} is not supported by ray_tpu_torch yet "
            f"(ROADMAP queue 1, item 12); env_vars, working_dir and "
            f"py_modules are")


def _inline_result_bytes() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return int(GLOBAL_CONFIG.worker_inline_result_kb) * 1024


@dataclass
class _ShmRef:
    """An ObjectRef argument: the worker maps the segment (zero-copy)."""

    desc: ShmDescriptor


@dataclass
class _BatchTask:
    """One task of a pipelined batch run (``WorkerPool.run_task_batch``)."""

    idx: int                    # its position in the caller's batch
    digest: str
    func_blob: bytes | None
    args_blob: bytes
    n_returns: int
    runtime_env: dict | None = None
    token: str | None = None
    client_addr: str | None = None
    sys_path: list | None = None
    # The absolute end-to-end deadline: a frame whose budget died queued
    # behind the lease's head is refused by the worker, never run.
    deadline: float | None = None
    # The driver over-subscribed this entry past the node's free slots
    # (entry flags bit 2): a failed reservation parks it in the daemon's
    # admission instead of answering busy.
    overcommit: bool = False
    # The return keys, which the fused in-daemon path needs.
    return_keys: list | None = None
    # The driver's trace context (util/tracing.py): its frame carries it
    # and the worker stamps pickup and exec times into the reply.
    trace: tuple | None = None


# --------------------------------------------------------------------------
# The worker process
# --------------------------------------------------------------------------


def _exception_blob(exc: BaseException) -> bytes:
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        return serialization.serialize_framed((exc, tb))
    except Exception:  # noqa: BLE001 — an exception that cannot be pickled
        return serialization.serialize_framed(
            (RuntimeError(f"{type(exc).__name__}: {exc}"), tb))


class _runtime_env_ctx:
    """A runtime_env applied around one task in the worker (``env_vars``,
    ``working_dir``, ``py_modules``) and undone after it: pool workers
    are shared. A process actor's applies for its life."""

    def __init__(self, runtime_env: dict | None):
        validate_runtime_env(runtime_env)
        self.env = runtime_env or {}
        self._saved_vars: dict[str, str | None] = {}
        self._saved_cwd: str | None = None
        self._added_sys_paths: list[str] = []
        self._unload_prefixes: list[str] = []

    def __enter__(self):
        try:
            for k, v in (self.env.get("env_vars") or {}).items():
                self._saved_vars[k] = os.environ.get(k)
                os.environ[k] = str(v)
            working_dir = self.env.get("working_dir")
            if working_dir:
                self._saved_cwd = os.getcwd()
                os.chdir(working_dir)
                self._add_path(working_dir)
                self._unload_prefixes.append(os.path.abspath(working_dir))
            for path in self.env.get("py_modules") or []:
                abspath = os.path.abspath(path)
                self._add_path(os.path.dirname(abspath))
                # Unload the module itself on exit, never its parent
                # directory's other modules.
                self._unload_prefixes.append(abspath)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def _add_path(self, path: str) -> None:
        if path not in sys.path:
            sys.path.insert(0, path)
            self._added_sys_paths.append(path)

    def __exit__(self, *exc):
        if self._saved_cwd is not None:
            try:
                os.chdir(self._saved_cwd)
            except OSError:
                pass  # the saved cwd was deleted
        if self._unload_prefixes:
            # Modules imported from the env's paths leave with it: the
            # next task on this worker must not see them.
            dirs = tuple(p + os.sep for p in self._unload_prefixes)
            exact = set(self._unload_prefixes)
            for name, mod in list(sys.modules.items()):
                mod_file = getattr(mod, "__file__", None)
                if mod_file and (mod_file.startswith(dirs)
                                 or mod_file in exact):
                    sys.modules.pop(name, None)
        for added in self._added_sys_paths:
            try:
                sys.path.remove(added)
            except ValueError:
                pass
        for k, old in self._saved_vars.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        return None


def _resolve_shm_args(args, kwargs, client: ShmClient):
    args = tuple(client.get(a.desc) if isinstance(a, _ShmRef) else a
                 for a in args)
    kwargs = {k: client.get(v.desc) if isinstance(v, _ShmRef) else v
              for k, v in kwargs.items()}
    return args, kwargs


def _arena_max_bytes() -> int:
    from ray_tpu_torch._private.config import ARENA_MAX_ENV

    return int(os.environ.get(ARENA_MAX_ENV) or 1024 * 1024)


def _pack_results(values: list, arena=None) -> list:
    """Each value -> ("inline", bytes) | ("arena", key, size) | ("shm",
    name, size) | ("err", blob): inline up to
    ``worker_inline_result_kb``; else in the driver's ``arena`` up to its
    object cap (sealed pinned: the driver's directory takes over the
    reference, so the result cannot be evicted on its way); else, or
    when the arena is full, a segment of its own that the driver
    adopts."""
    from multiprocessing import shared_memory

    out = []
    for value in values:
        raw = serialization.try_serialize_raw(value)
        if raw is not None:
            out.append(("inline", raw))
            continue
        try:
            header, buffers = serialization.serialize(value)
        except Exception as exc:  # noqa: BLE001 — a result that cannot be pickled
            out.append(("err", _exception_blob(exc)))
            continue
        size = serialization.framed_size(header, buffers)
        if size <= _inline_result_bytes():
            blob = bytearray(size)
            serialization.write_framed(memoryview(blob), header, buffers)
            out.append(("inline", bytes(blob)))
            continue
        if arena is not None and size <= _arena_max_bytes():
            key = os.urandom(16)
            # A worker killed between here and the driver's reply leaks
            # this one pin, bounded by the crashes; the arena dies with
            # the driver.
            if arena.write_object(key, size, lambda view: (
                    serialization.write_framed(view, header, buffers))):
                out.append(("arena", key, size))
                continue
        seg = shared_memory.SharedMemory(create=True, size=size)
        untrack(seg)  # its unlink is the driver's
        serialization.write_framed(seg.buf, header, buffers)
        name = seg.name
        seg.close()
        out.append(("shm", name, size))
    return out


def worker_main(conn) -> None:
    """A worker process's entry: serve until told to exit. The first
    message is ("hello", the driver's sys.path): the worker adopts it,
    so what was pickled by reference (test modules included) imports."""
    kind, parent_sys_path = conn.recv()
    assert kind == "hello", kind
    sys.path[:0] = [p for p in parent_sys_path if p not in sys.path]
    os.environ[IN_WORKER_ENV] = "1"
    threads = os.environ.get(THREADS_ENV)
    if threads:
        import torch

        torch.set_num_threads(int(threads))
    client = ShmClient(untrack_on_attach=True)
    arena = _attach_driver_arena(client)
    try:
        _serve(conn, client)
    finally:
        client.close_all()
        if arena is not None:
            arena.close()


def _attach_driver_arena(client: ShmClient):
    """Attach the arena this worker was handed (none when the name is
    empty: a node daemon's worker, or a driver without one)."""
    from ray_tpu_torch._private.config import ARENA_NAME_ENV

    name = os.environ.get(ARENA_NAME_ENV)
    if not name:
        return None
    from ray_tpu_torch._private.arena_store import ArenaStore

    arena = ArenaStore.attach(name)
    if arena is None:
        raise RuntimeError(f"worker cannot attach its driver's arena {name}")
    client.set_arena(arena)
    return arena


def _exec_task_body(fields: tuple, func_cache: dict,
                    client: ShmClient, stages: dict | None = None) -> list:
    """Run one task message (the fields after its kind) and return the
    packed results. ``stages`` (a traced task's) receives the function's
    ``exec_start`` and ``exec_end``."""
    from ray_tpu_torch._private import worker_client

    digest, func_blob, args_blob, n_returns, renv, token = fields[:6]
    # A node daemon's task also names its driver (whose client server
    # the nested API calls) and the driver's import paths; a sender
    # with the performance plane armed asks for the attribution sample.
    client_addr = fields[6] if len(fields) > 6 else None
    sys_path = fields[7] if len(fields) > 7 else None
    want_sample = bool(fields[8]) if len(fields) > 8 else False
    if client_addr:
        worker_client.use_address(client_addr)
    if sys_path:
        sys.path.extend(p for p in sys_path if p not in sys.path)
    if func_blob is not None:
        func_cache[digest] = serialization.loads_function(func_blob)
    func = func_cache[digest]
    args, kwargs = serialization.deserialize_from_buffer(memoryview(args_blob))
    args, kwargs = _resolve_shm_args(args, kwargs, client)
    # The token rides nested get()/wait() calls, so the driver gives this
    # task's CPU back while it blocks.
    worker_client.set_task_token(token)
    sample = perf.sample_start() if want_sample else None
    try:
        with _runtime_env_ctx(renv):
            if stages is not None:
                stages["exec_start"] = time.time()
            result = func(*args, **kwargs)
            if stages is not None:
                stages["exec_end"] = time.time()
    finally:
        worker_client.set_task_token(None)
    if sample is not None:
        # (name, wall, cpu seconds, peak-RSS delta) around the function,
        # rolled up by the process that owns the run.
        sample = perf.sample_end(
            getattr(func, "__qualname__", digest[:8]), sample)
    _settle_borrows()
    if n_returns == 0:
        values = []
    elif n_returns == 1:
        values = [result]
    else:
        if not isinstance(result, (tuple, list)) or len(result) != n_returns:
            raise ValueError(f"task declared num_returns={n_returns} but "
                             f"returned {type(result).__name__}")
        values = list(result)
    packed = _pack_results(values, client.arena)
    return packed if sample is None else (packed, sample)


def _settle_borrows() -> None:
    """The borrows of the refs this call unpickled reach their owner
    before its reply does (``_ProxyReferenceCounter.settle``)."""
    from ray_tpu_torch._private import worker_client

    runtime = worker_client.active_worker_runtime()
    if runtime is not None:
        runtime.reference_counter.settle()


def _new_actor(msg: tuple, client: ShmClient):
    _, cls_blob, args_blob, renv = msg[:4]
    if os.environ.get(REQUIRE_CARD_ENV):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "this GPU process actor sees no CUDA card (CUDA_VISIBLE_"
                f"DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}); it "
                "does not run on the CPU instead")
    cls = serialization.loads_function(cls_blob)
    args, kwargs = serialization.deserialize_from_buffer(memoryview(args_blob))
    args, kwargs = _resolve_shm_args(args, kwargs, client)
    # The actor's process is its own: the env stays for its life.
    _runtime_env_ctx(renv).__enter__()
    instance = cls(*args, **kwargs)
    _settle_borrows()
    return instance


def _serve(conn, client: ShmClient) -> None:
    instance = None
    func_cache: dict[str, Any] = {}
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        kind = msg[0]
        try:
            if kind == "exit":
                return
            elif kind == "ping":
                conn.send(("pong", os.getpid()))
            elif kind == "task":
                # An optional 11th element is the driver's trace context:
                # the reply then carries the frame's pickup and exec
                # stamps, ("ok", packed, sample or None, stages).
                traced = len(msg) > 10 and msg[10] is not None
                stages = {"worker_start": time.time(),
                          "pid": os.getpid()} if traced else None
                out = _exec_task_body(msg[1:], func_cache, client, stages)
                # A sampled task replies ("ok", packed, sample).
                packed, sample = out if isinstance(out, tuple) \
                    else (out, None)
                if traced:
                    conn.send(("ok", packed, sample, stages))
                else:
                    conn.send(("ok", packed) if sample is None
                              else ("ok", packed, sample))
            elif kind == "task_seq":
                # A frame of a pipelined lease: the sender does not wait
                # for replies, frames run in the order received, and each
                # reply carries its call id, ("task_done", id, status,
                # payload[, sample[, stages]]). An optional 12th element
                # is the absolute deadline: a frame whose budget died
                # queued behind the lease's head is refused ("timeout").
                # An optional 13th is the driver's trace context: the
                # reply then carries the frame's pickup and exec stamps.
                call_id = msg[1]
                deadline = msg[11] if len(msg) > 11 else None
                if deadline is not None and time.time() > deadline:
                    conn.send(("task_done", call_id, "timeout", None))
                    continue
                traced = len(msg) > 12 and msg[12] is not None
                stages = {"worker_start": time.time(),
                          "pid": os.getpid()} if traced else None
                try:
                    out = _exec_task_body(msg[2:], func_cache, client,
                                          stages)
                except BaseException as exc:  # noqa: BLE001 — this task's
                    conn.send(("task_done", call_id, "err",
                               _exception_blob(exc)))
                    continue
                packed, sample = out if isinstance(out, tuple) \
                    else (out, None)
                if traced:
                    conn.send(("task_done", call_id, "ok", packed, sample,
                               stages))
                elif sample is not None:
                    conn.send(("task_done", call_id, "ok", packed, sample))
                else:
                    conn.send(("task_done", call_id, "ok", packed))
            elif kind == "actor_new":
                instance = _new_actor(msg, client)
                conn.send(("ok", None))
                max_concurrency, groups = msg[4], msg[5]
                if max_concurrency > 1 or groups:
                    # From here on calls carry ids, run on thread pools
                    # and their replies interleave.
                    _serve_actor_concurrent(conn, instance, client,
                                            max_concurrency, groups)
                    return
            elif kind == "actor_call":
                _, method_name, args_blob, n_returns = msg
                if instance is None:
                    raise RuntimeError("actor_call before actor_new")
                conn.send(_invoke_actor_method(instance, client, method_name,
                                               args_blob, n_returns))
            else:
                raise RuntimeError(f"unknown message kind {kind!r}")
        except BaseException as exc:  # noqa: BLE001 — sent to the driver
            try:
                conn.send(("err", _exception_blob(exc)))
            except OSError:
                return


def _hosted_engine_stats() -> "dict | None":
    """The summed counters of this process's LLM engines (None when it
    never imported the engine: a scrape does not import the serve
    tier)."""
    mod = sys.modules.get("ray_tpu_torch.serve.llm_engine.engine")
    return None if mod is None else mod.merged_engine_stats()


def _invoke_actor_method(instance, client: ShmClient, method_name: str,
                         args_blob: bytes, n_returns: int) -> tuple:
    """-> ("ok", packed results) | ("err", exception blob)."""
    try:
        args, kwargs = serialization.deserialize_from_buffer(
            memoryview(args_blob))
        args, kwargs = _resolve_shm_args(args, kwargs, client)
        result = getattr(instance, method_name)(*args, **kwargs)
        _settle_borrows()
        values = [result] if n_returns == 1 else (
            list(result) if isinstance(result, (tuple, list))
            else [None] * n_returns)
        return ("ok", _pack_results(values, client.arena))
    except BaseException as exc:  # noqa: BLE001 — sent to the driver
        return ("err", _exception_blob(exc))


def _serve_actor_concurrent(conn, instance, client: ShmClient,
                            max_concurrency: int, groups: dict) -> None:
    """Multiplexed serving: up to ``max_concurrency`` calls at once on
    one thread pool, and a pool of its own for each concurrency group;
    replies carry their call's id and share the pipe under a lock. Each
    reply also carries the counters of the LLM engines this process
    hosts (None without one), which the daemon ships on its
    heartbeat."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch._private.actor_runtime import method_groups

    send_lock = threading.Lock()
    pools = {group: ThreadPoolExecutor(max_workers=size,
                                       thread_name_prefix="actor-call")
             for group, size in [(None, max(1, max_concurrency)),
                                 *groups.items()]}
    marked = method_groups(type(instance))

    def run_one(call_id, method_name, args_blob, n_returns):
        status, payload = _invoke_actor_method(instance, client, method_name,
                                               args_blob, n_returns)
        try:
            with send_lock:
                # Read under the send lock: the daemon keeps the last
                # counters it received, which are then the newest.
                conn.send(("reply", call_id, status, payload,
                           _hosted_engine_stats()))
        except OSError:
            pass  # the driver is gone; this process is about to exit

    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            if msg[0] == "exit":
                return
            _, call_id, method_name, args_blob, n_returns = msg
            pools[marked.get(method_name)].submit(
                run_one, call_id, method_name, args_blob, n_returns)
    finally:
        for pool in pools.values():
            pool.shutdown(wait=False, cancel_futures=True)


# --------------------------------------------------------------------------
# The driver's side
# --------------------------------------------------------------------------


_factory_lock = threading.Lock()
_factory = None


def _get_factory():
    """The process's fork server, started at first use (and again if it
    died)."""
    global _factory
    from ray_tpu_torch._private.worker_factory import start_factory

    with _factory_lock:
        if _factory is not None and not _factory.alive():
            _factory = None
        if _factory is None:
            _factory = start_factory()
        return _factory


def stop_factory() -> None:
    global _factory
    with _factory_lock:
        factory, _factory = _factory, None
    if factory is not None:
        factory.stop()


def _visible_cards(gpu_ids: list[int]) -> str:
    """``CUDA_VISIBLE_DEVICES`` for the leased card indices, which count
    the cards this process sees."""
    own = os.environ.get("CUDA_VISIBLE_DEVICES")
    if own:
        mine = own.split(",")
        return ",".join(mine[i] for i in gpu_ids)
    return ",".join(str(i) for i in gpu_ids)


def _spawn_worker(name: str, extra_env: dict | None = None,
                  gpu_ids: list[int] | None = None, arena=None):
    """Start a worker: a fork of the factory for a CPU worker whose
    environment the factory can honour; otherwise (a GPU actor, or
    import-time settings of its own) a fresh interpreter that connects
    back over a Unix socket. ``gpu_ids`` (a ``GPU`` lease's cards) is
    what the worker sees in ``CUDA_VISIBLE_DEVICES``; without it the
    worker sees no card. ``arena``: the driver's, which the worker
    attaches; without it the worker attaches none, whatever this
    process's environment says."""
    import secrets
    import socket
    import tempfile
    from multiprocessing.connection import Connection, Listener

    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.worker_factory import cpu_worker_env

    from ray_tpu_torch._private.config import ARENA_MAX_ENV, ARENA_NAME_ENV

    env = dict(os.environ)
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    env[ARENA_NAME_ENV] = arena.name if arena is not None else ""
    env[ARENA_MAX_ENV] = str(int(GLOBAL_CONFIG.object_arena_max_object_bytes))
    if gpu_ids:
        env["CUDA_VISIBLE_DEVICES"] = _visible_cards(gpu_ids)
        if serialization.sees_card():
            env[REQUIRE_CARD_ENV] = "1"
    else:
        env = cpu_worker_env(env)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    log_dir = env.get(LOG_DIR_ENV)
    log_path = None
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{name}.log")
    if not gpu_ids:
        factory = _get_factory()
        if factory.compatible(env):
            parent_sock, child_sock = socket.socketpair(socket.AF_UNIX,
                                                        socket.SOCK_STREAM)
            try:
                proc = factory.spawn(env=env, cwd=os.getcwd(),
                                     log_path=log_path,
                                     pipe_fd=child_sock.fileno())
            finally:
                child_sock.close()
            conn = Connection(parent_sock.detach())
            conn.send(("hello", list(sys.path)))
            return proc, conn
    # A fresh interpreter (never a fork of a process that may hold a
    # CUDA context) connecting back to a one-shot listener.
    addr = os.path.join(tempfile.gettempdir(),
                        f"ray_tpu_torch_{os.getpid()}_{name}_"
                        f"{secrets.token_hex(4)}.sock")
    authkey = secrets.token_bytes(16)
    listener = Listener(addr, family="AF_UNIX", authkey=authkey)
    env[_AUTHKEY_ENV] = authkey.hex()
    log_file = open(log_path, "ab") if log_path else None
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_pool",
             addr], env=env, cwd=os.getcwd(), stdout=log_file,
            stderr=log_file)
    finally:
        if log_file is not None:
            log_file.close()
    try:
        box: list = []

        def accept():
            try:
                box.append(listener.accept())
            except Exception as exc:  # noqa: BLE001 — reported below
                box.append(exc)

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        t.join(timeout=float(GLOBAL_CONFIG.worker_startup_timeout_s))
        if not box or isinstance(box[0], Exception):
            proc.kill()
            proc.wait()
            raise WorkerCrashedError(
                f"worker {name} failed to connect: "
                f"{box[0] if box else 'timeout'}")
        conn = box[0]
    finally:
        listener.close()
        try:
            os.unlink(addr)
        except FileNotFoundError:
            pass
    conn.send(("hello", list(sys.path)))
    return proc, conn


class _WorkerUnavailable(Exception):
    """The request never reached the worker (it was dead already)."""


class _RemoteTaskError(Exception):
    """A worker-side exception and its remote traceback."""

    def __init__(self, cause: BaseException, remote_tb: str):
        super().__init__(str(cause))
        self.cause = cause
        self.remote_tb = remote_tb


def _remote_error(blob) -> tuple[BaseException, str]:
    return serialization.deserialize_from_buffer(memoryview(blob))


class PoolWorker:
    """One worker process and its pipe; one request in flight."""

    def __init__(self, index: int, extra_env: dict | None = None,
                 gpu_ids: list[int] | None = None, arena=None):
        self.index = index
        self._lock = threading.Lock()
        # Digests of the functions this worker has been sent: each
        # crosses once per worker.
        self.known_digests: set[str] = set()
        self.proc, self.conn = _spawn_worker(f"w{index}", extra_env,
                                             gpu_ids, arena)

    def _crashed(self, exc: BaseException) -> WorkerCrashedError:
        err = WorkerCrashedError(f"worker {self.index} (pid "
                                 f"{self.proc.pid}) died: {exc!r}")
        err.worker_pid = self.proc.pid
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.record("worker.crash", str(err)[:120])
        return err

    def request(self, msg: tuple) -> tuple:
        """Send one request and wait for its reply. Raises
        _WorkerUnavailable when the send fails (nothing started: safe to
        retry elsewhere), WorkerCrashedError when the process dies after
        taking it."""
        with self._lock:
            try:
                self.conn.send(msg)
            except (OSError, ValueError) as exc:
                raise _WorkerUnavailable(
                    f"worker {self.index} (pid {self.proc.pid}) "
                    f"unreachable: {exc!r}") from exc
            try:
                return self.conn.recv()
            except (EOFError, OSError) as exc:
                raise self._crashed(exc) from exc

    def send(self, msg: tuple) -> None:
        """Send without waiting for a reply (the multiplexed protocol, and
        a pipelined lease's frames, whose one reader matches the tagged
        replies)."""
        with self._lock:
            try:
                self.conn.send(msg)
            except (OSError, ValueError) as exc:
                raise _WorkerUnavailable(
                    f"worker {self.index} (pid {self.proc.pid}) "
                    f"unreachable: {exc!r}") from exc

    def recv_reply(self) -> tuple:
        """The next reply of a pipelined lease. Raises WorkerCrashedError
        when the process died."""
        try:
            return self.conn.recv()
        except (EOFError, OSError) as exc:
            raise self._crashed(exc) from exc

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> None:
        """Ask the process to exit, then terminate, then kill it; it has
        ended when this returns."""
        try:
            self.conn.send(("exit",))
        except (OSError, ValueError):
            pass  # the worker dropped the pipe already
        for end in (lambda: None, self.proc.terminate, self.proc.kill):
            end()
            try:
                self.proc.wait(timeout=2.0)
                break
            except subprocess.TimeoutExpired:
                continue
        self.conn.close()


class WorkerPool:
    """The task workers (the reference's worker_pool.h pops a worker per
    lease and takes it back after)."""

    def __init__(self, size: int, directory: ShmDirectory,
                 driver_client: ShmClient, max_size: int | None = None,
                 arena=None):
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self.size = size
        # Room to grow for nested submission: an outer task blocked in
        # get() holds its worker while the inner task needs another.
        self.max_size = max_size if max_size is not None else (
            int(GLOBAL_CONFIG.worker_pool_max_size) or size * 4 + 8)
        # Workers kept between tasks.
        self.idle_cap = size if size > 0 else min(4, self.max_size)
        self.directory = directory
        self.driver_client = driver_client
        # The driver's arena, handed to every worker (None on a daemon).
        self.arena = arena
        self._lock = threading.Condition(threading.Lock())
        self._index_lock = threading.Lock()
        self._idle: list[PoolWorker] = []
        # Every worker started, idle or leased (the memory monitor's
        # view); dead ones are dropped as new ones start.
        self._all_workers: set[PoolWorker] = set()
        self._next_index = 0
        self._num_leased = 0
        self._shutdown = False
        # The pipelined batches: lease runs, tasks that entered them,
        # frames sent, and unstarted frames requeued after a crash.
        self._batch_lock = threading.Lock()
        self.batch_runs = 0
        self.batch_tasks = 0
        self.batch_frames = 0
        self.batch_requeues = 0
        if size > 0:
            # In parallel: each spawn waits on its worker's start-up.
            with ThreadPoolExecutor(max_workers=min(size, 8)) as tpe:
                self._idle.extend(tpe.map(lambda _: self._new_worker(),
                                          range(size)))

    def _new_worker(self, extra_env: dict | None = None) -> PoolWorker:
        with self._index_lock:
            index = self._next_index
            self._next_index += 1
        worker = PoolWorker(index, extra_env=extra_env, arena=self.arena)
        with self._index_lock:
            self._all_workers = {w for w in self._all_workers if w.alive()}
            self._all_workers.add(worker)
        return worker

    def live_workers(self) -> list[PoolWorker]:
        """Every live worker, idle or busy."""
        with self._index_lock:
            return [w for w in self._all_workers if w.alive()]

    def _acquire(self) -> PoolWorker:
        grow = False
        with self._lock:
            while not self._idle and not self._shutdown:
                # Grow instead of waiting: every leased worker may be an
                # outer task blocked on an inner one.
                if self._num_leased < self.max_size:
                    grow = True
                    break
                self._lock.wait(timeout=0.5)
            if self._shutdown:
                raise RuntimeError("worker pool is shut down")
            self._num_leased += 1
            worker = None if grow else self._idle.pop()
        if worker is not None and worker.alive():
            return worker
        if worker is not None:
            worker.stop()  # died while idle: replace it
        try:
            return self._new_worker()
        except BaseException:
            with self._lock:
                self._num_leased -= 1
                self._lock.notify()
            raise

    def _release(self, worker: PoolWorker) -> None:
        replacement = None
        if not worker.alive():
            worker.stop()
            worker = None
            if self._num_leased <= self.size and not self._shutdown:
                replacement = self._new_worker()
        keep = worker or replacement
        retire = None
        with self._lock:
            self._num_leased -= 1
            if keep is not None:
                if not self._shutdown and len(self._idle) < self.idle_cap:
                    self._idle.append(keep)
                else:
                    retire = keep
            self._lock.notify()
        if retire is not None:
            # A surplus worker of a burst: retire it off the lock.
            threading.Thread(target=retire.stop, daemon=True).start()

    # ----------------------------------------------------- pipelined batches

    def try_acquire_idle(self) -> "PoolWorker | None":
        """Lease an idle worker if there is one: never grows the pool,
        never waits (the extra lease runners of a batch)."""
        with self._lock:
            if self._shutdown:
                return None
            while self._idle:
                worker = self._idle.pop()
                if worker.alive():
                    self._num_leased += 1
                    return worker
                worker.stop()
        return None

    def run_task_batch(self, tasks: "list[_BatchTask]", on_result,
                       depth: int, tracker=None) -> None:
        """Run a batch over pipelined multi-task worker leases, and return
        when every task has completed.

        One lease is taken up front; while tasks are queued and a
        runner's pipe is full, idle workers are leased too, so short
        tasks drain through one lease and long ones fan out. A lease
        keeps up to ``depth`` call-id-tagged frames in flight.

        ``on_result(task, status, payload, sample, stages)`` fires once
        per task (``stages``: a traced frame's worker stamps, else None)
        from a runner thread: "ok" (packed results), "err" (an exception
        blob), "timeout" (its deadline died before the worker took it)
        or "crash" (a WorkerCrashedError: it may have started). A worker
        that dies mid-pipeline fails only its oldest frame in flight; the
        ones behind it never started and go to a fresh lease.
        ``tracker`` sees each lease's frames: ``sent(key, token)``,
        ``done(key, token)``, ``drop_lease(key)``."""
        from collections import deque

        if not tasks:
            return
        state = _BatchState(deque(tasks), on_result, max(1, depth),
                            tracker, len(tasks))
        with self._batch_lock:
            self.batch_runs += 1
            self.batch_tasks += len(tasks)
        try:
            worker = self._acquire()
        except BaseException as exc:  # noqa: BLE001 — the pool is shut down
            for task in tasks:
                self._complete_one(state, task, "crash", exc)
            return
        self._batch_runner(worker, state)
        # This runner is done; its siblings may still hold frames.
        state.done.wait()

    def _maybe_extra_runner(self, state: "_BatchState") -> None:
        with state.lock:
            if not state.queue:
                return
        worker = self.try_acquire_idle()
        if worker is None:
            return
        threading.Thread(target=self._batch_runner, args=(worker, state),
                         daemon=True,
                         name="ray_tpu_torch-batch-lease").start()

    def _batch_runner(self, worker: PoolWorker,
                      state: "_BatchState") -> None:
        from collections import deque

        tracker = state.tracker
        while True:  # one pass per lease (a crash takes a new worker)
            lease_key = object()
            inflight: deque = deque()  # (call id, task)
            next_id = 0
            crashed: BaseException | None = None
            while True:
                while len(inflight) < state.depth:
                    with state.lock:
                        task = state.queue.popleft() if state.queue \
                            else None
                    if task is None:
                        break
                    blob = None if task.digest in worker.known_digests \
                        else task.func_blob
                    next_id += 1
                    frame = ("task_seq", next_id, task.digest, blob,
                             task.args_blob, task.n_returns,
                             task.runtime_env, task.token,
                             task.client_addr,
                             task.sys_path if blob is not None else None,
                             perf.PERF_ON)
                    if task.deadline is not None or task.trace is not None:
                        frame = frame + (task.deadline,)
                    if task.trace is not None:
                        frame = frame + (task.trace,)
                    try:
                        worker.send(frame)
                    except _WorkerUnavailable as exc:
                        # Never delivered: it goes back with the unstarted.
                        with state.lock:
                            state.queue.appendleft(task)
                        with self._batch_lock:
                            self.batch_requeues += 1
                        crashed = exc
                        break
                    worker.known_digests.add(task.digest)
                    inflight.append((next_id, task))
                    with self._batch_lock:
                        self.batch_frames += 1
                    if tracker is not None and task.token:
                        tracker.sent(lease_key, task.token)
                if crashed is not None:
                    break
                if not inflight:
                    self._release(worker)
                    return
                with state.lock:
                    more = bool(state.queue)
                if more:
                    self._maybe_extra_runner(state)
                try:
                    msg = worker.recv_reply()
                except WorkerCrashedError as exc:
                    crashed = exc
                    break
                if msg[0] != "task_done":
                    continue
                call_id, status, payload = msg[1], msg[2], msg[3]
                sample = msg[4] if len(msg) > 4 else None
                stages = msg[5] if len(msg) > 5 else None
                task = None
                for i, (cid, queued) in enumerate(inflight):
                    if cid == call_id:
                        task = queued
                        del inflight[i]
                        break
                if task is None:
                    continue
                if tracker is not None and task.token:
                    tracker.done(lease_key, task.token)
                self._complete_one(state, task, status, payload, sample,
                                   stages)
            # The worker died (or refused a frame). Its oldest frame was
            # running and may have had effects: it fails. The ones behind
            # it never started and go to a fresh lease.
            if tracker is not None:
                tracker.drop_lease(lease_key)
            started = inflight.popleft() if inflight else None
            if started is not None:
                self._complete_one(state, started[1], "crash", crashed)
            if inflight:
                with self._batch_lock:
                    self.batch_requeues += len(inflight)
            with state.lock:
                state.queue.extendleft(t for _, t in reversed(inflight))
                remaining = bool(state.queue)
            self._release(worker)
            if not remaining:
                return
            try:
                worker = self._acquire()
            except BaseException:  # noqa: BLE001 — the pool is shut down
                with state.lock:
                    stranded = list(state.queue)
                    state.queue.clear()
                for task in stranded:
                    self._complete_one(state, task, "crash", crashed)
                return

    @staticmethod
    def _complete_one(state: "_BatchState", task: _BatchTask, status: str,
                      payload, sample=None, stages=None) -> None:
        try:
            state.on_result(task, status, payload, sample, stages)
        finally:
            with state.lock:
                state.remaining -= 1
                if state.remaining <= 0:
                    state.done.set()

    def marshal_args(self, args: tuple, kwargs: dict,
                     promote: Callable[[Any], Any]) -> bytes:
        """Top-level ObjectRef arguments become _ShmRef descriptors (the
        driver's values promoted into its arena or a segment); the rest
        is framed."""
        from ray_tpu_torch._private.object_ref import ObjectRef

        if not any(isinstance(a, ObjectRef) for a in args) \
                and not any(isinstance(v, ObjectRef)
                            for v in kwargs.values()):
            raw = serialization.try_serialize_raw((args, kwargs))
            if raw is not None:
                return raw

        def convert(a):
            return _ShmRef(promote(a)) if isinstance(a, ObjectRef) else a

        return serialization.serialize_framed(
            (tuple(convert(a) for a in args),
             {k: convert(v) for k, v in kwargs.items()}))

    def run_task_blobs(self, digest: str, func_blob: bytes, args_blob: bytes,
                       n_returns: int, return_ids: list[ObjectID],
                       runtime_env: dict | None = None,
                       task_token: str | None = None,
                       client_addr: str | None = None,
                       sys_path: list[str] | None = None,
                       perf_sample: list | None = None,
                       trace: tuple | None = None,
                       stages_out: dict | None = None
                       ) -> list[tuple[ObjectID, Any]]:
        """Run a task on a worker; [(return id, value)]. The function
        crosses the pipe the first time a worker meets its digest. On a
        node daemon, ``client_addr`` is the submitting driver's client
        server and ``sys_path`` its import paths. With ``perf_sample``
        (a list) the worker samples the function's resources and the
        (name, wall, cpu, rss) tuple is appended to it. With ``trace``
        (the driver's trace context) the worker's pickup and exec stamps
        and its pid land in ``stages_out``. Raises
        WorkerCrashedError (a system failure) or _RemoteTaskError (the
        task's own)."""
        from ray_tpu_torch._private.worker_factory import (
            import_sensitive_subset,
        )

        if trace is not None:
            extra = (client_addr, sys_path, perf_sample is not None, trace)
        elif perf_sample is not None:
            extra = (client_addr, sys_path, True)
        elif client_addr or sys_path:
            extra = (client_addr, sys_path)
        else:
            extra = ()

        env_vars = {str(k): str(v) for k, v in
                    ((runtime_env or {}).get("env_vars") or {}).items()}
        if import_sensitive_subset(env_vars):
            # torch reads these at import: a shared worker (a fork of the
            # factory) would ignore them, so the task gets a fresh
            # worker of its own, counted against the pool's cap.
            with self._lock:
                while self._num_leased >= self.max_size \
                        and not self._shutdown:
                    self._lock.wait(timeout=0.5)
                if self._shutdown:
                    raise RuntimeError("worker pool is shut down")
                self._num_leased += 1
            worker = None
            try:
                worker = self._new_worker(extra_env=env_vars)
                return self._unpack_reply(worker.request(
                    ("task", digest, func_blob, args_blob, n_returns,
                     runtime_env, task_token, *extra)), return_ids,
                    perf_sample, stages_out)
            finally:
                if worker is not None:
                    worker.stop()
                with self._lock:
                    self._num_leased -= 1
                    self._lock.notify()
        while True:
            worker = self._acquire()
            send_blob = None if digest in worker.known_digests else func_blob
            try:
                reply = worker.request(("task", digest, send_blob, args_blob,
                                        n_returns, runtime_env, task_token,
                                        *extra))
            except _WorkerUnavailable:
                continue  # nothing started; _release replaces the worker
            finally:
                self._release(worker)
            worker.known_digests.add(digest)
            return self._unpack_reply(reply, return_ids, perf_sample,
                                      stages_out)

    def _unpack_reply(self, reply: tuple, return_ids: list[ObjectID],
                      perf_sample: list | None = None,
                      stages_out: dict | None = None
                      ) -> list[tuple[ObjectID, Any]]:
        if reply[0] == "err":
            raise _RemoteTaskError(*_remote_error(reply[1]))
        if len(reply) > 2 and reply[2] is not None \
                and perf_sample is not None:
            perf_sample.append(reply[2])
        if len(reply) > 3 and stages_out is not None and reply[3]:
            stages_out.update(reply[3])
        return [(rid, unpack_result(packed, rid, self.directory,
                                    self.driver_client))
                for rid, packed in zip(return_ids, reply[1])]

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            workers, self._idle = self._idle, []
            self._lock.notify_all()
        for w in workers:
            w.stop()


class _BatchState:
    """One ``run_task_batch`` call's state: the queue its lease runners
    take from, the completions still to come and the parking tracker."""

    __slots__ = ("queue", "on_result", "depth", "tracker", "remaining",
                 "lock", "done")

    def __init__(self, queue, on_result, depth, tracker, n):
        self.queue = queue
        self.on_result = on_result
        self.depth = depth
        self.tracker = tracker
        self.remaining = n
        self.lock = threading.Lock()
        self.done = threading.Event()


def unpack_result(packed: tuple, rid: ObjectID, directory: ShmDirectory,
                  client: ShmClient) -> Any:
    """One packed result as a value; a segment is adopted by the
    directory under ``rid``, and an arena entry registered there (its
    pin with it). A result that failed to pickle raises."""
    if packed[0] == "inline":
        return serialization.deserialize_from_buffer(memoryview(packed[1]))
    if packed[0] == "arena":
        desc = ArenaDescriptor(packed[1], packed[2])
        directory.register_arena(rid, desc)
        return client.get(desc)
    if packed[0] == "shm":
        desc = ShmDescriptor(packed[1], packed[2])
        directory.adopt(rid, desc)
        return client.get(desc)
    raise _RemoteTaskError(*_remote_error(packed[1]))


# --------------------------------------------------------------------------
# Process actors
# --------------------------------------------------------------------------


class ProcessActor:
    """An actor in a worker process of its own.

    It has ``LocalActor``'s interface (``submit``, ``kill``,
    ``wait_stopped``, ``is_dead``), so the runtime treats both alike.
    ``gpu_ids`` are the cards of its ``GPU`` lease: the process sees
    exactly those. A top-level ObjectRef argument crosses as the
    descriptor of its value in the driver's arena or a segment
    (``takes_shm_args``), and a result the way a task's does, as for a
    pool task; the reference pickles every argument's value into the
    pipe."""

    takes_shm_args = True

    def __init__(self, actor_id: ActorID, cls: type, init_args: tuple,
                 init_kwargs: dict, runtime, *, max_restarts: int = 0,
                 max_pending_calls: int = -1, max_concurrency: int = 1,
                 concurrency_groups: dict | None = None,
                 creation_return_id: ObjectID | None = None,
                 on_death: Callable[[ActorID, str], None] | None = None,
                 on_release: Callable[[ActorID], None] | None = None,
                 runtime_env: dict | None = None,
                 gpu_ids: list[int] | None = None):
        import queue

        self.actor_id = actor_id
        self._cls = cls
        self._max_concurrency = max(1, int(max_concurrency))
        self._groups = dict(concurrency_groups or {})
        self._runtime_env = runtime_env
        self._gpu_ids = list(gpu_ids or [])
        self._init_args = init_args
        self._init_kwargs = init_kwargs
        self._runtime = runtime
        self._max_restarts = max_restarts
        self._max_pending_calls = max_pending_calls
        self._on_death = on_death
        self._on_release = on_release
        self.num_restarts = 0
        self._queue: queue.Queue = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self._dead = False
        self._death_reason: str | None = None
        self._stopped = threading.Event()
        self._creation_return_id = creation_return_id
        self._worker: PoolWorker | None = None
        self._start_thread()

    def _start_thread(self) -> None:
        threading.Thread(target=self._run, daemon=True,
                         name=f"ray_tpu_torch-pactor-{self._cls.__name__}"
                              f"-r{self.num_restarts}").start()

    # ----------------------------------------------- LocalActor's interface

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
        restartable = (not no_restart) \
            and self.num_restarts < self._max_restarts
        drained = self._set_dead(reason)
        if drained is None:
            return
        # Terminate first: a call in flight keeps the process busy, and
        # the stop that follows waits for it to end.
        worker = self._worker
        if worker is not None and worker.alive():
            worker.proc.terminate()
        self._finish_death(reason, drained, notify=not restartable)
        if restartable:
            self._restart()

    def is_dead(self) -> bool:
        with self._lock:
            return self._dead

    def wait_stopped(self, timeout: float) -> bool:
        return self._stopped.wait(timeout)

    # ------------------------------------------------------------ internals

    def _fail_call(self, call, error: BaseException) -> None:
        for rid in call.return_ids:
            self._runtime.store.put_error(rid, error)

    def _label(self, call) -> str:
        return f"{self._cls.__name__}.{call.method_name}"

    def _call_error(self, call) -> BaseException | None:
        """The error a call seals instead of running, or None."""
        if call.deadline is not None and time.time() > call.deadline:
            return TaskTimeoutError(self._label(call), "actor_queue",
                                    call.deadline)
        return None

    def _marshal(self, call) -> bytes:
        try:
            return serialization.serialize_framed((call.args, call.kwargs))
        except Exception as exc:  # noqa: BLE001 — arguments that cannot be pickled
            raise ActorError(exc, "", f"{self._label(call)} (argument "
                                      f"serialization)") from exc

    def _run(self) -> None:
        calls, generation = self._queue, self.num_restarts
        try:
            # Its env_vars are in the process's environment from the
            # start: one that torch reads at import boots a fresh
            # interpreter instead of a fork.
            self._worker = PoolWorker(
                -1, extra_env=(self._runtime_env or {}).get("env_vars"),
                gpu_ids=self._gpu_ids,
                arena=getattr(self._runtime, "arena", None))
            reply = self._worker.request(
                ("actor_new", serialization.dumps_function(self._cls),
                 serialization.serialize_framed((self._init_args,
                                                 self._init_kwargs)),
                 self._runtime_env, self._max_concurrency, self._groups))
            if reply[0] == "err":
                exc, tb = _remote_error(reply[1])
                raise ActorError(exc, tb, f"{self._cls.__name__}.__init__")
        except BaseException as exc:  # noqa: BLE001 — sealed on the creation ref
            self._mark_dead(f"constructor failed: {exc!r}")
            if self._creation_return_id is not None:
                self._runtime.store.put_error(self._creation_return_id, exc)
            return
        if self._creation_return_id is not None:
            self._runtime.store.put(self._creation_return_id, None)
        if self._max_concurrency > 1 or self._groups:
            self._run_concurrent(calls, generation)
            return
        while (call := calls.get()) is not None:
            with self._lock:
                self._pending -= 1
                dead = self._dead
            if dead:
                self._fail_call(call, ActorDiedError(
                    self.actor_id, self._death_reason or "actor died"))
                continue
            try:
                error = self._call_error(call)
                if error is not None:
                    self._fail_call(call, error)
                    continue
                reply = self._worker.request(
                    ("actor_call", call.method_name, self._marshal(call),
                     len(call.return_ids)))
                self._store_call_results(call, reply)
            except (WorkerCrashedError, _WorkerUnavailable):
                self._handle_crash(call, generation)
                return
            except BaseException as exc:  # noqa: BLE001 — fail the call, keep serving
                self._fail_call(call, exc)
            # Unbind before blocking again: a stale local would keep the
            # last call's arguments alive.
            call = None

    def _store_call_results(self, call, reply: tuple) -> None:
        if reply[0] == "err":
            exc, tb = _remote_error(reply[1])
            self._fail_call(call, ActorError(exc, tb, self._label(call)))
            return
        runtime = self._runtime
        try:
            values = [unpack_result(packed, rid, runtime.shm_directory,
                                    runtime.shm_client)
                      for rid, packed in zip(call.return_ids, reply[1])]
        except _RemoteTaskError as err:
            self._fail_call(call, ActorError(err.cause, err.remote_tb,
                                             self._label(call)))
            return
        for rid, value in zip(call.return_ids, values):
            runtime.store.put(rid, value)

    def _run_concurrent(self, calls, generation: int) -> None:
        """Multiplexed (``max_concurrency > 1``): calls stream to the
        worker tagged with ids and a reader thread matches the replies.
        Per-caller order is not kept, as in the reference."""
        worker = self._worker
        pending: dict[int, Any] = {}
        pending_lock = threading.Lock()
        next_id = 0

        def reader():
            while True:
                try:
                    msg = worker.conn.recv()
                except (EOFError, OSError):
                    break
                # The reply's engine counters are a daemon's to ship.
                _, call_id, status, payload, _engine = msg
                with pending_lock:
                    call = pending.pop(call_id, None)
                if call is None:
                    continue
                with self._lock:
                    self._pending = max(0, self._pending - 1)
                # One bad reply fails its call; the reader keeps serving.
                try:
                    self._store_call_results(call, (status, payload))
                except BaseException as exc:  # noqa: BLE001
                    self._fail_call(call, exc)
            # The pipe closed: fail what is in flight. The reader alone
            # handles the death (the sender defers to it), unless this
            # generation was replaced or killed already.
            with pending_lock:
                stranded = list(pending.values())
                pending.clear()
            for call in stranded:
                self._fail_call(call, ActorDiedError(
                    self.actor_id, "actor process died with calls in "
                                   "flight"))
            if self.num_restarts == generation and not self.is_dead():
                self._crashed("actor process died")

        threading.Thread(target=reader, daemon=True,
                         name=f"ray_tpu_torch-pactor-read-"
                              f"{self._cls.__name__}").start()
        while (call := calls.get()) is not None:
            with self._lock:
                dead = self._dead
            error = ActorDiedError(self.actor_id, self._death_reason
                                   or "actor died") if dead \
                else self._call_error(call)
            if error is None:
                try:
                    args_blob = self._marshal(call)
                except ActorError as exc:
                    error = exc
            if error is not None:
                with self._lock:
                    self._pending = max(0, self._pending - 1)
                self._fail_call(call, error)
                continue
            call_id, next_id = next_id, next_id + 1
            with pending_lock:
                pending[call_id] = call
            try:
                worker.send(("actor_call_async", call_id, call.method_name,
                             args_blob, len(call.return_ids)))
            except _WorkerUnavailable:
                with pending_lock:
                    pending.pop(call_id, None)
                with self._lock:
                    self._pending = max(0, self._pending - 1)
                self._fail_call(call, ActorDiedError(
                    self.actor_id, f"actor process died sending "
                                   f"{call.method_name}()"))
                return
            call = args_blob = None

    def _handle_crash(self, call, generation: int) -> None:
        reason = f"actor process died executing {call.method_name}()"
        self._fail_call(call, ActorDiedError(self.actor_id, reason))
        if self.num_restarts == generation:
            self._crashed(reason)

    def _crashed(self, reason: str) -> None:
        restartable = self.num_restarts < self._max_restarts
        if self._mark_dead(reason, notify=not restartable) and restartable:
            self._restart()

    def _set_dead(self, reason: str) -> "list | None":
        """Mark the actor dead and take its queued calls; None if it was
        dead already."""
        import queue

        with self._lock:
            if self._dead:
                return None
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
            self._queue.put(None)  # this generation's loop ends
            self._pending = 0
        return drained

    def _finish_death(self, reason: str, drained: list,
                      notify: bool) -> None:
        for call in drained:
            self._fail_call(call, ActorDiedError(self.actor_id, reason))
        worker = self._worker
        if worker is not None:
            worker.stop()  # the process has ended when this returns
        if notify:
            if self._on_death is not None:
                self._on_death(self.actor_id, reason)
            # Dead for good: the process is gone, and so is what it held.
            self._init_args, self._init_kwargs = (), {}
            if self._on_release is not None:
                self._on_release(self.actor_id)
            self._stopped.set()

    def _mark_dead(self, reason: str, notify: bool = True) -> bool:
        drained = self._set_dead(reason)
        if drained is None:
            return False
        self._finish_death(reason, drained, notify)
        return True

    def _restart(self) -> None:
        import queue

        with self._lock:
            self.num_restarts += 1
            self._dead = False
            self._death_reason = None
            self._queue = queue.Queue()
        self._creation_return_id = None
        self._start_thread()


# --------------------------------------------------------------------------
# A fresh interpreter's entry: python -m ray_tpu_torch._private.worker_pool
# --------------------------------------------------------------------------

if __name__ == "__main__":
    from multiprocessing.connection import Client

    # Serve from the module imported by name, not this __main__ copy:
    # unpickled _ShmRef instances are of the imported module's class.
    from ray_tpu_torch._private.worker_pool import worker_main as _main

    _conn = Client(sys.argv[1], family="AF_UNIX",
                   authkey=bytes.fromhex(os.environ.pop(_AUTHKEY_ENV)))
    _main(_conn)
