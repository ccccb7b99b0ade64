"""The process's runtime and the core public API.

The port of ``ray_tpu/_private/worker.py``, its single-host path: what
``ray_tpu.init()`` builds with no ``address``. ``Runtime`` composes the
object store, the control-plane tables, the cluster's resources (one
head node: ``CPU``, the detected ``GPU``s and any custom resources) and
the dispatcher; the module functions (``init``/``get``/``put``/...)
drive the process's one runtime.

Tasks and actors run on threads of the process that called ``init()``,
which owns the card, unless ``init(process_workers=N)`` starts a pool of
worker processes (``worker_pool.py``): a task then runs in a pool worker
when it can be pickled and asks for no ``GPU`` (an unpicklable one falls
back to a thread, as in the reference), and ``@remote(process=True)``
gives an actor a process of its own. Code in those processes calls this
runtime back through the client server (``util/client/server.py``).

A ``GPU`` lease names its cards: an in-thread task or actor runs on its
lease's first card (``torch.cuda.set_device`` on its thread, when the
card exists) and on the default stream (PyTorch's current stream is per
thread too), so work that a task enqueues on the card is ordered before
work any other thread enqueues there after it: a CUDA tensor a task
returns is sealed without a synchronize, and a consumer on the default
stream reads it safely. A process actor sees its cards, and only them,
in ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import logging
import os
import queue
import threading
import time
import weakref
from typing import Any, Sequence

import torch

from ray_tpu_torch._private import accelerators, worker_client
from ray_tpu_torch._private.actor_runtime import LocalActor, _ActorCall
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.gcs import (
    ActorRecord,
    GlobalControlService,
    JobRecord,
    NodeRecord,
    TaskEvent,
)
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef, ref_args, resolve_args
from ray_tpu_torch._private.object_store import ObjectStore, ReferenceCounter
from ray_tpu_torch._private.placement_groups import PlacementGroupManager
from ray_tpu_torch._private.scheduler import (
    BlockedResourceContext,
    ClusterState,
    Dispatcher,
    NodeState,
    format_traceback,
)
from ray_tpu_torch._private.task import SchedulingStrategy, TaskSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    PlacementGroupError,
    SystemOverloadedError,
    TaskCancelledError,
    TaskError,
    TaskTimeoutError,
    WorkerCrashedError,
)

logger = logging.getLogger("ray_tpu_torch")

# How long an actor creation waits for its resources to free up before the
# actor dies.
_ACTOR_LEASE_TIMEOUT_S = 300.0
# How long kill() waits for the killed actor's running calls to return;
# past it, the actor's resources come back when they do.
_KILL_WAIT_S = 10.0


def _in_worker_process() -> bool:
    from ray_tpu_torch._private.worker_pool import IN_WORKER_ENV

    return bool(os.environ.get(IN_WORKER_ENV))


def _use_cards(shares: dict[int, float]) -> None:
    """Run this thread on its lease's first card, when that card
    exists."""
    if shares and torch.cuda.is_available() \
            and min(shares) < torch.cuda.device_count():
        torch.cuda.set_device(min(shares))


class RuntimeContext:
    """The running task's or actor's context, per thread: job, task,
    actor and node ids and the resources it holds."""

    _tls = threading.local()

    @classmethod
    def current(cls) -> dict:
        return getattr(cls._tls, "ctx", None) or {}

    @classmethod
    def set(cls, **kwargs):
        cls._tls.ctx = kwargs

    @classmethod
    def clear(cls):
        cls._tls.ctx = None


class Runtime:
    """The store, the control plane and the scheduler of one process."""

    def __init__(self, num_cpus: float | None = None,
                 num_gpus: float | None = None,
                 resources: dict[str, float] | None = None,
                 object_store_memory: int | None = None,
                 namespace: str = "default",
                 process_workers: int | None = None):
        cfg = GLOBAL_CONFIG
        self.namespace = namespace
        self.job_id = JobID()
        self.gcs = GlobalControlService()
        self.store = ObjectStore(
            memory_limit_bytes=(object_store_memory
                                or cfg.object_store_memory_mb * 1024 * 1024),
            spill_dir=cfg.object_spilling_dir)
        self.reference_counter = ReferenceCounter(self.store)
        self.cluster = ClusterState()
        self.placement_groups = PlacementGroupManager(
            self.cluster, self.store, self.gcs)
        self.dispatcher = Dispatcher(self.cluster, self.store,
                                     self.placement_groups)
        self.dispatcher.set_deadline_hook(self._seal_deadline)
        self.dispatcher.set_unplaceable_hook(self._seal_unplaceable)
        # Failure counters (stats()): deadline-sealed tasks and
        # admission sheds.
        self._counter_lock = threading.Lock()
        self._task_timeouts = 0
        self._admission_shed = 0
        self._actors: dict[ActorID, LocalActor] = {}
        # Signalled whenever an actor lands in _actors or dies: submit
        # queues wait on it.
        self._actors_changed = threading.Condition()
        self._actor_queues: dict[ActorID, queue.Queue] = {}
        # Actor id -> (node, resources, (group id, bundle index) or None,
        # card shares).
        self._actor_leases: dict[ActorID, tuple] = {}
        self._futures_lock = threading.Lock()
        self._futures: dict[ObjectID,
                            list[concurrent.futures.Future]] = {}
        self.store.add_seal_listener(self._resolve_futures)
        # The head node: CPU as asked, GPU as asked or detected.
        head = {"CPU": float(num_cpus if num_cpus is not None
                             else cfg.num_cpus)}
        head.update(accelerators.detect_resources())
        if num_gpus is not None:
            head["GPU"] = float(num_gpus)
        head.update({k: float(v) for k, v in (resources or {}).items()})
        self.head_node_id = self.add_node(
            {k: v for k, v in head.items() if v > 0},
            labels={"node_type": "head"})
        self.gcs.register_job(JobRecord(self.job_id))
        self._start_process_plane(
            cfg.worker_pool_size if process_workers is None
            else process_workers)

    # ------------------------------------------------- worker processes

    def _start_process_plane(self, pool_size: int) -> None:
        """The pieces worker processes use: the segment directory, the
        client server (started at the first process spawn, so a runtime
        of threads pays nothing), the log monitor and the pool."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.shm_store import ShmClient, ShmDirectory

        serialization.init_raw_from_config()
        self.shm_directory = ShmDirectory()
        self.shm_client = ShmClient()
        self.store.add_free_listener(self._on_object_freed)
        self.worker_pool = None
        self.worker_client_server = None
        self.log_monitor = None
        # Task token -> the BlockedResourceContext of a pool task, for a
        # nested get() that arrives with the token.
        self._inflight_blocks: dict[str, BlockedResourceContext] = {}
        self._inflight_blocks_lock = threading.Lock()
        self._func_blobs: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._promote_lock = threading.Lock()
        if not pool_size or pool_size <= 0:
            return
        from ray_tpu_torch._private import worker_pool as pool_mod

        self.ensure_client_server()
        if GLOBAL_CONFIG.log_to_driver:
            import tempfile
            import uuid

            from ray_tpu_torch._private.log_monitor import LogMonitor

            # One directory per session: a second init() in this process
            # must not replay the first one's logs.
            log_dir = os.path.join(
                tempfile.gettempdir(),
                f"ray_tpu_torch_session_{os.getpid()}_"
                f"{uuid.uuid4().hex[:6]}", "logs")
            os.environ[pool_mod.LOG_DIR_ENV] = log_dir
            self.log_monitor = LogMonitor(log_dir).start()
        # N workers with torch's default thread count each would
        # oversubscribe the host.
        os.environ[pool_mod.THREADS_ENV] = str(
            max(1, (os.cpu_count() or 1) // int(pool_size)))
        self.worker_pool = pool_mod.WorkerPool(
            int(pool_size), self.shm_directory, self.shm_client)

    def ensure_client_server(self) -> None:
        """Start the client server on first need; processes spawned after
        it find it in their environment."""
        if self.worker_client_server is not None:
            return
        from ray_tpu_torch.util.client import ClientServer

        self.worker_client_server = ClientServer().start()
        os.environ[worker_client.ADDRESS_ENV] = \
            self.worker_client_server.address

    def lookup_block_context(self, token: str):
        """The block context of a pool task in flight."""
        with self._inflight_blocks_lock:
            return self._inflight_blocks.get(token)

    def _on_object_freed(self, object_id: ObjectID) -> None:
        name = self.shm_directory.free(object_id)
        if name is not None:
            self.shm_client.close_segment(name)

    def _function_blob(self, func) -> tuple[str, bytes]:
        """A task function pickled once per identity (the reference's
        function manager exports each function once); closures are
        captured at the first export, as there."""
        import hashlib

        from ray_tpu_torch._private import serialization

        try:
            cached = self._func_blobs.get(func)
        except TypeError:  # a callable that cannot be weakly keyed
            cached = None
        if cached is not None:
            return cached
        blob = serialization.dumps_function(func)
        entry = (hashlib.sha1(blob).hexdigest(), blob)
        try:
            self._func_blobs[func] = entry
        except TypeError:
            pass
        return entry

    def _promote_to_shm(self, ref: ObjectRef):
        """Make an object of this process readable by worker processes:
        its segment, written at the first use."""
        from ray_tpu_torch._private.shm_store import ShmObjectWriter

        with self._promote_lock:
            desc = self.shm_directory.lookup(ref.id())
            if desc is None:
                desc, seg = ShmObjectWriter.put(self.store.get(ref.id()))
                self.shm_directory.register(ref.id(), desc, seg)
            return desc

    def _try_execute_on_pool(self, spec: TaskSpec, node: NodeState,
                             bundled: bool) -> bool:
        """Run the task in a pool worker behind the serialization
        boundary; False (the caller runs it on a thread) when its
        function or arguments cannot be pickled."""
        from ray_tpu_torch._private.worker_pool import _RemoteTaskError

        try:
            args_blob = self.worker_pool.marshal_args(
                spec.args, spec.kwargs, self._promote_to_shm)
            digest, func_blob = self._function_blob(spec.func)
        except Exception:  # noqa: BLE001 — not picklable: run in-thread
            return False
        # A nested get() from the worker carries this token and gives the
        # task's CPU back here while it blocks.
        token = spec.task_id.hex()
        with self._inflight_blocks_lock:
            self._inflight_blocks[token] = BlockedResourceContext(
                self.cluster, node.node_id, {} if bundled else spec.resources)
        try:
            results = self.worker_pool.run_task_blobs(
                digest, func_blob, args_blob, spec.num_returns,
                spec.return_ids, runtime_env=spec.runtime_env,
                task_token=token)
        except _RemoteTaskError as rte:
            rte.cause.__ray_tpu_remote_tb__ = rte.remote_tb
            raise rte.cause from None
        finally:
            with self._inflight_blocks_lock:
                ctx = self._inflight_blocks.pop(token)
            # A worker that died in a blocked get() left the CPU given
            # away: take it back before the dispatcher releases it.
            ctx.drain()
        for rid, value in results:
            self.store.put(rid, value)
        return True

    def add_node(self, resources: dict[str, float],
                 labels: dict[str, str] | None = None) -> NodeID:
        node_id = NodeID()
        self.cluster.add_node(NodeState(
            node_id=node_id, total=dict(resources),
            available=dict(resources), labels=dict(labels or {})))
        self.gcs.register_node(NodeRecord(
            node_id=node_id, address=f"local://{node_id.hex()[:8]}",
            resources=dict(resources), labels=dict(labels or {})))
        return node_id

    # ------------------------------------------------------------ deadlines

    @staticmethod
    def _absolute_deadline(deadline_s: float | None) -> float | None:
        """now + budget, falling back to task_default_deadline_s."""
        if deadline_s is None:
            deadline_s = float(GLOBAL_CONFIG.task_default_deadline_s or 0)
            if deadline_s <= 0:
                return None
        return time.time() + float(deadline_s)

    def _seal_deadline(self, spec: TaskSpec, stage: str) -> None:
        """Seal TaskTimeoutError onto a task whose budget died at
        ``stage``; the FAILED event records the stage."""
        err = TaskTimeoutError(spec.name, stage, spec.deadline or 0.0)
        for rid in spec.return_ids:
            self.store.put_error(rid, err)
        with self._counter_lock:
            self._task_timeouts += 1
        self.gcs.record_task_event(TaskEvent(
            spec.task_id, spec.name, "FAILED", end_time=time.time(),
            error=f"deadline expired at stage {stage!r}"))

    def _seal_unplaceable(self, spec: TaskSpec,
                          error: PlacementGroupError) -> None:
        for rid in spec.return_ids:
            self.store.put_error(rid, error)
        self.gcs.record_task_event(TaskEvent(
            spec.task_id, spec.name, "FAILED", end_time=time.time(),
            error=str(error)))

    # ------------------------------------------------------------ admission

    def _admission_overload_reason(self) -> str | None:
        """Why admission sheds right now, or None: the dispatcher's
        backlog over ``admission_max_queue_depth`` (0: no cap)."""
        cap = int(GLOBAL_CONFIG.admission_max_queue_depth or 0)
        if cap > 0 and self.dispatcher.pending_count() > cap:
            return f"dispatcher backlog over admission_max_queue_depth={cap}"
        return None

    def stats(self) -> dict:
        """Driver-side counters: tasks sealed at their deadline, submits
        shed at admission, and the dispatcher's depth."""
        with self._counter_lock:
            return {"task_timeouts": self._task_timeouts,
                    "admission_shed": self._admission_shed,
                    "queue_depth": self.dispatcher.pending_count()}

    # ---------------------------------------------------------------- tasks

    def submit_task(self, func, args: tuple, kwargs: dict, *, name: str,
                    num_returns: int = 1, resources: dict[str, float],
                    max_retries: int = 0,
                    retry_exceptions: bool | list = False,
                    scheduling_strategy: SchedulingStrategy | None = None,
                    runtime_env: dict | None = None,
                    deadline_s: float | None = None) -> list[ObjectRef]:
        """Queue one task; its refs come back at once. ``runtime_env``
        applies in a pool worker (a task on a thread ignores it).
        ``deadline_s``
        arms an end-to-end budget checked at every stage; a
        deadline-armed submit over the admission cap raises
        ``SystemOverloadedError`` instead of queueing (its budget would
        die in the backlog)."""
        from ray_tpu_torch._private.worker_pool import validate_runtime_env

        validate_runtime_env(runtime_env)
        deadline = self._absolute_deadline(deadline_s)
        if deadline is not None:
            reason = self._admission_overload_reason()
            if reason is not None:
                with self._counter_lock:
                    self._admission_shed += 1
                raise SystemOverloadedError(reason)
        return_ids = [ObjectID() for _ in range(num_returns)]
        spec = TaskSpec(
            task_id=TaskID(), name=name, func=func, args=args,
            kwargs=kwargs, num_returns=num_returns, resources=resources,
            max_retries=max_retries, retry_exceptions=retry_exceptions,
            scheduling_strategy=scheduling_strategy or SchedulingStrategy(),
            return_ids=return_ids, deadline=deadline,
            runtime_env=runtime_env)
        for rid in return_ids:
            self.store.create_pending(rid)
        refs = [ObjectRef(rid) for rid in return_ids]
        self.gcs.record_task_event(TaskEvent(spec.task_id, name, "PENDING"))
        self.dispatcher.submit(spec, self._execute_task,
                               ref_args(args, kwargs))
        return refs

    def _execute_task(self, spec: TaskSpec, node: NodeState) -> None:
        start = time.time()
        if spec.deadline is not None and start > spec.deadline:
            self._seal_deadline(spec, "execute")
            return
        self.gcs.record_task_event(TaskEvent(
            spec.task_id, spec.name, "RUNNING", start_time=start,
            node_id=node.node_id.hex()))
        RuntimeContext.set(
            task_id=spec.task_id, task_name=spec.name, job_id=self.job_id,
            node_id=node.node_id, actor_id=None,
            resources=dict(spec.resources),
            gpu_ids=sorted(spec.gpu_shares))
        # A bundled task's CPU is its bundle's: it is not lent to the node
        # while the task blocks.
        bundled = spec.scheduling_strategy.kind == "PLACEMENT_GROUP"
        try:
            # A task that asks for GPU stays on a thread of this process,
            # as the reference's TPU tasks do.
            if self.worker_pool is None or "GPU" in spec.resources \
                    or not self._try_execute_on_pool(spec, node, bundled):
                _use_cards(spec.gpu_shares)
                args, kwargs, _ = resolve_args(
                    spec.args, spec.kwargs, lambda ref: self.get([ref])[0])
                with BlockedResourceContext(
                        self.cluster, node.node_id,
                        {} if bundled else spec.resources):
                    result = spec.func(*args, **kwargs)
                self._store_task_result(spec, result)
            self.gcs.record_task_event(TaskEvent(
                spec.task_id, spec.name, "FINISHED", start_time=start,
                end_time=time.time(), node_id=node.node_id.hex()))
        except BaseException as exc:  # noqa: BLE001 — sealed onto the task's refs, where it is reported
            self._finish_task_failure(spec, exc, start)
        finally:
            RuntimeContext.clear()

    def _finish_task_failure(self, spec: TaskSpec, exc: BaseException,
                             start: float) -> None:
        """Retry when the policy allows, else seal the error."""
        if self._maybe_retry(spec, exc):
            return
        # A task error that is already typed (a failed dependency, a
        # cancellation, its worker's death) passes through unwrapped.
        error = exc if isinstance(
            exc, (TaskError, TaskCancelledError, WorkerCrashedError)) \
            else TaskError(exc, getattr(exc, "__ray_tpu_remote_tb__", None)
                           or format_traceback(exc), spec.name)
        for rid in spec.return_ids:
            self.store.put_error(rid, error)
        self.gcs.record_task_event(TaskEvent(
            spec.task_id, spec.name, "FAILED", start_time=start,
            end_time=time.time(), error=repr(exc)))

    def _maybe_retry(self, spec: TaskSpec, exc: BaseException) -> bool:
        """Resubmit while retries remain: a system failure (an actor's or
        a worker's death) always, an application error as
        ``retry_exceptions`` allows."""
        if spec.attempt >= spec.max_retries:
            return False
        if isinstance(exc, (ActorDiedError, WorkerCrashedError)) \
                or spec.retry_exceptions is True:
            retry = True
        elif isinstance(spec.retry_exceptions, (list, tuple)):
            retry = any(isinstance(exc, t) for t in spec.retry_exceptions)
        else:
            retry = False
        if not retry:
            return False
        spec.attempt += 1
        logger.info("Retrying task %s (attempt %d/%d) after %r", spec.name,
                    spec.attempt, spec.max_retries, exc)
        self.dispatcher.submit(spec, self._execute_task,
                               ref_args(spec.args, spec.kwargs))
        return True

    def _store_task_result(self, spec: TaskSpec, result: Any) -> None:
        if spec.num_returns == 1:
            self.store.put(spec.return_ids[0], result)
            return
        if spec.num_returns == 0:
            return
        if not isinstance(result, (tuple, list)) \
                or len(result) != spec.num_returns:
            raise ValueError(
                f"Task {spec.name} declared num_returns={spec.num_returns} "
                f"but returned {type(result).__name__} of length "
                f"{len(result) if isinstance(result, (tuple, list)) else 'n/a'}")
        for rid, value in zip(spec.return_ids, result):
            self.store.put(rid, value)

    # --------------------------------------------------------------- actors

    def create_actor(self, cls: type, args: tuple, kwargs: dict, *,
                     name: str | None = None, namespace: str | None = None,
                     resources: dict[str, float], max_concurrency: int = 1,
                     max_restarts: int = 0, max_pending_calls: int = -1,
                     concurrency_groups: dict[str, int] | None = None,
                     scheduling_strategy: SchedulingStrategy | None = None,
                     get_if_exists: bool = False, process: bool = False,
                     runtime_env: dict | None = None,
                     deadline_s: float | None = None
                     ) -> tuple[ActorID, ObjectRef]:
        """Register the actor, then lease its resources and build it on a
        thread of its own, or (``process=True``) in a worker process of
        its own, which ``runtime_env`` applies to. ``deadline_s`` is the
        default budget of each of its calls."""
        from ray_tpu_torch._private.worker_pool import (
            ProcessActor,
            validate_runtime_env,
        )

        validate_runtime_env(runtime_env)
        ns = namespace or self.namespace
        if name is not None and get_if_exists:
            existing = self.gcs.get_named_actor(name, ns)
            if existing is not None:
                return existing.actor_id, self.put(None)
        actor_id = ActorID()
        creation_rid = ObjectID()
        self.store.create_pending(creation_rid)
        creation_ref = ObjectRef(creation_rid)
        method_meta = {
            attr: {"num_returns": getattr(cls, attr).__ray_tpu_num_returns__}
            for attr in dir(cls)
            if hasattr(getattr(cls, attr, None), "__ray_tpu_num_returns__")}
        record = ActorRecord(
            actor_id=actor_id, name=name, namespace=ns,
            class_name=cls.__name__, method_meta=method_meta,
            default_deadline_s=float(deadline_s or 0.0))
        try:
            self.gcs.register_actor(record)
        except ValueError:
            # Two get_if_exists creators raced past the existence check:
            # the loser joins the winner's actor.
            if name is not None and get_if_exists:
                existing = self.gcs.get_named_actor(name, ns)
                if existing is not None:
                    self.store.put(creation_rid, None)
                    return existing.actor_id, creation_ref
            raise
        strategy = scheduling_strategy or SchedulingStrategy()

        def start_actor():
            try:
                lease = self._lease_actor_resources(
                    cls.__name__, resources, strategy, record)
            except (TimeoutError, PlacementGroupError) as exc:
                self.store.put_error(creation_rid, exc)
                self._mark_actor_dead(actor_id, repr(exc))
                return
            node_id, shares = (lease[0], lease[3]) if lease is not None \
                else (None, {})
            context = dict(job_id=self.job_id, task_id=None,
                           actor_id=actor_id, node_id=node_id,
                           resources=dict(resources),
                           gpu_ids=sorted(shares))

            def set_context():
                RuntimeContext.set(**context)
                _use_cards(shares)

            if process:
                # The process finds the client server in its environment.
                self.ensure_client_server()
            with self._actors_changed:
                if record.state == "DEAD":
                    # Killed before it was built.
                    if lease is not None:
                        self._release_lease(*lease)
                    self.store.put_error(creation_rid, ActorDiedError(
                        actor_id, record.death_cause or "actor has died"))
                    return
                self._actor_leases[actor_id] = lease
                # ALIVE before the actor thread starts: a constructor
                # that fails marks it DEAD, and that must be the last
                # word.
                self.gcs.update_actor_state(actor_id, "ALIVE")
                if process:
                    actor = ProcessActor(
                        actor_id, cls, args, kwargs, self,
                        max_restarts=max_restarts,
                        max_pending_calls=max_pending_calls,
                        max_concurrency=max_concurrency,
                        concurrency_groups=concurrency_groups,
                        creation_return_id=creation_rid,
                        on_death=self._mark_actor_dead,
                        on_release=self._release_actor_lease,
                        runtime_env=runtime_env, gpu_ids=sorted(shares))
                else:
                    if runtime_env:
                        logger.warning("actor %s runs on a thread: its "
                                       "runtime_env is ignored (pass "
                                       "process=True)", cls.__name__)
                    actor = LocalActor(
                        actor_id, cls, args, kwargs, self.store,
                        max_concurrency=max_concurrency,
                        max_restarts=max_restarts,
                        max_pending_calls=max_pending_calls,
                        concurrency_groups=concurrency_groups,
                        creation_return_id=creation_rid,
                        on_death=self._mark_actor_dead,
                        on_release=self._release_actor_lease,
                        set_context=set_context)
                self._actors[actor_id] = actor
                self._actors_changed.notify_all()

        threading.Thread(target=start_actor, daemon=True,
                         name=f"ray_tpu_torch-actor-create-"
                              f"{cls.__name__}").start()
        return actor_id, creation_ref

    def _lease_actor_resources(self, name: str, resources: dict, strategy,
                               record: ActorRecord) -> tuple | None:
        """Take the actor's resources for its lifetime, from the node or
        from its placement group's bundle, waiting up to
        _ACTOR_LEASE_TIMEOUT_S for them to free up: the lease (node,
        resources, (group id, bundle index) or None, card shares), or
        None if the actor is killed while it waits. A bundle that can
        never hold them raises PlacementGroupError."""
        timeout = _ACTOR_LEASE_TIMEOUT_S
        deadline = time.monotonic() + timeout
        bundle = None
        if strategy.kind == "PLACEMENT_GROUP":
            bundle = (strategy.placement_group.id,
                      strategy.placement_group_bundle_index)
        while record.state != "DEAD":
            if bundle is not None:
                reason = self.placement_groups.unplaceable(*bundle, resources)
                if reason is not None:
                    raise PlacementGroupError(reason)
                try:
                    node_id, shares = self.placement_groups \
                        .acquire_from_bundle(*bundle, resources)
                    return node_id, resources, bundle, shares
                except PlacementGroupError:
                    pass  # pending, or the bundle is full for now
            else:
                node = self.cluster.pick_node(resources, strategy)
                shares = None if node is None else self.cluster.try_acquire(
                    node.node_id, resources)
                if shares is not None:
                    return node.node_id, resources, None, shares
                if node is None:
                    self.cluster.warn_if_infeasible(f"Actor {name}",
                                                    resources)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"Could not lease resources {resources} for actor "
                    f"{name} within {timeout}s")
            self.cluster.wait_for_change(0.05)
        return None

    def _release_actor_lease(self, actor_id: ActorID) -> None:
        """Give back a dead actor's resources, once its executor threads
        have ended."""
        lease = self._actor_leases.pop(actor_id, None)
        if lease is not None:
            self._release_lease(*lease)

    def _release_lease(self, node_id: NodeID, resources: dict,
                       bundle: tuple | None, shares: dict) -> None:
        if bundle is not None:
            self.placement_groups.release_to_bundle(*bundle, resources,
                                                    shares)
        else:
            self.cluster.release(node_id, resources, shares)

    def _mark_actor_dead(self, actor_id: ActorID, reason: str) -> None:
        self.gcs.update_actor_state(actor_id, "DEAD", reason)
        with self._actors_changed:
            # Its drain thread delivers what is queued (the dead actor
            # fails it) and ends; a later call is failed at submit.
            submit_queue = self._actor_queues.pop(actor_id, None)
            if submit_queue is not None:
                submit_queue.put(None)
            self._actors_changed.notify_all()

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict, num_returns: int = 1,
                          deadline_s: float | None = None
                          ) -> list[ObjectRef]:
        """Queue one method call. Calls of one actor go through its
        ordered submit queue, so each caller's calls keep their order
        across the actor's start-up and the resolution of their
        ObjectRef arguments."""
        return_ids = [ObjectID() for _ in range(max(1, num_returns))]
        for rid in return_ids:
            self.store.create_pending(rid)
        refs = [ObjectRef(rid) for rid in return_ids]
        call = _ActorCall(method_name, args, kwargs, return_ids,
                          deadline=self._absolute_deadline(deadline_s))
        record = self.gcs.get_actor(actor_id)
        if record is None or record.state == "DEAD":
            # Dead for good (a restarting actor stays ALIVE).
            err = ActorDiedError(actor_id, (record.death_cause if record
                                            else None) or "actor not found")
            for rid in return_ids:
                self.store.put_error(rid, err)
            return refs
        self._enqueue_actor_call(actor_id, call)
        return refs

    def _enqueue_actor_call(self, actor_id: ActorID, call: _ActorCall) -> None:
        """Put ``call`` on the actor's submit queue, starting its drain
        thread on first use. The drain thread ends once the actor is dead
        for good and its queue is empty (checked under the same lock), so
        a dead actor keeps no thread."""
        with self._actors_changed:
            submit_queue = self._actor_queues.get(actor_id)
            if submit_queue is not None:
                submit_queue.put(call)
                return
            submit_queue = self._actor_queues[actor_id] = queue.Queue()
            submit_queue.put(call)

        def drained() -> bool:
            with self._actors_changed:
                record = self.gcs.get_actor(actor_id)
                if record is not None and record.state != "DEAD" \
                        or not submit_queue.empty():
                    return False
                if self._actor_queues.get(actor_id) is submit_queue:
                    del self._actor_queues[actor_id]
                return True

        def drain():
            while (call := submit_queue.get()) is not None:
                self._deliver_actor_call(actor_id, call)
                # Unbind before blocking: a stale local would keep the
                # last call's arguments alive.
                call = None
                if drained():
                    return

        threading.Thread(target=drain, daemon=True,
                         name=f"ray_tpu_torch-actor-submit-"
                              f"{actor_id.hex()[:8]}").start()

    def _deliver_actor_call(self, actor_id: ActorID,
                            call: _ActorCall) -> None:
        """Resolve the call's ObjectRef arguments and hand it to the
        actor once it is built, in queue order (blocking here keeps the
        order); a failed argument or an actor that never started fails
        the call."""
        actor = self._wait_actor(actor_id)
        if actor is None:
            err = ActorDiedError(actor_id, "actor failed to start")
            for rid in call.return_ids:
                self.store.put_error(rid, err)
            return
        try:
            call.args, call.kwargs, _ = resolve_args(
                call.args, call.kwargs, lambda ref: self.get([ref])[0])
        except Exception as exc:  # noqa: BLE001 — a failed argument fails the call
            for rid in call.return_ids:
                self.store.put_error(rid, exc)
            return
        actor.submit(call)

    def _wait_actor(self, actor_id: ActorID):
        """The live actor once it is built; None if it died first."""
        with self._actors_changed:
            while actor_id not in self._actors:
                record = self.gcs.get_actor(actor_id)
                if record is None or record.state == "DEAD":
                    return None
                self._actors_changed.wait(0.25)
            return self._actors[actor_id]

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        with self._actors_changed:
            actor = self._actors.get(actor_id)
            if actor is None:
                # Not built yet: start_actor sees DEAD and stops.
                self._mark_actor_dead(actor_id, "killed via kill()")
                return
        actor.kill("killed via kill()", no_restart=no_restart)
        if no_restart and RuntimeContext.current().get("actor_id") \
                != actor_id:
            # Its calls that are running cannot be stopped: wait a while
            # for them, so an idle actor's resources are back on return.
            actor.wait_stopped(_KILL_WAIT_S)

    def get_actor_handle(self, name: str, namespace: str | None = None):
        from ray_tpu_torch.actor import ActorHandle

        record = self.gcs.get_named_actor(name, namespace or self.namespace)
        if record is None:
            raise ValueError(f"Failed to look up actor with name {name!r}")
        return ActorHandle(record.actor_id, record.class_name)

    # ------------------------------------------------------------ get/put/…

    def put(self, value: Any) -> ObjectRef:
        """Seal ``value`` by reference (no copy, tensors included)."""
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed")
        object_id = ObjectID()
        self.store.put(object_id, value)
        return ObjectRef(object_id)

    def get(self, refs: Sequence[ObjectRef],
            timeout: float | None = None) -> list[Any]:
        block_ctx = BlockedResourceContext.current()
        deadline = None if timeout is None else time.monotonic() + timeout
        results = []
        for ref in refs:
            if not isinstance(ref, ObjectRef):
                raise TypeError(f"get() expects ObjectRef (or list of "
                                f"them), got {type(ref)}")
            if self.store.contains(ref.id()):
                results.append(self.store.get(ref.id()))
                continue
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if block_ctx is not None:
                block_ctx.block()
            try:
                results.append(self.store.get(ref.id(), timeout=remaining))
            finally:
                if block_ctx is not None:
                    block_ctx.unblock()
        return results

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: float | None = None
             ) -> tuple[list[ObjectRef], list[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError(f"num_returns={num_returns} exceeds the number "
                             f"of refs ({len(refs)})")
        by_id = {ref.id(): ref for ref in refs}
        block_ctx = BlockedResourceContext.current()
        if block_ctx is not None:
            block_ctx.block()
        try:
            ready, not_ready = self.store.wait(
                [r.id() for r in refs], num_returns, timeout)
        finally:
            if block_ctx is not None:
                block_ctx.unblock()
        return [by_id[i] for i in ready], [by_id[i] for i in not_ready]

    def cancel(self, ref: ObjectRef) -> None:
        """Best effort: a task that has not started is cancelled; a
        running thread cannot be stopped and completes normally."""
        spec = self.dispatcher.cancel_by_return_id(ref.id())
        if spec is None:
            return
        err = TaskCancelledError(spec.task_id)
        for rid in spec.return_ids:
            self.store.put_error(rid, err)
        self.gcs.record_task_event(TaskEvent(
            spec.task_id, spec.name, "FAILED", error="cancelled"))

    def free(self, refs: Sequence[ObjectRef]) -> None:
        self.store.free([r.id() for r in refs])

    def attach_future(self, ref: ObjectRef,
                      fut: concurrent.futures.Future) -> None:
        with self._futures_lock:
            if self.store.is_pending(ref.id()):
                self._futures.setdefault(ref.id(), []).append(fut)
                return
        self._resolve_one_future(ref.id(), fut)

    def _resolve_futures(self, object_id: ObjectID) -> None:
        with self._futures_lock:
            futs = self._futures.pop(object_id, [])
        for fut in futs:
            self._resolve_one_future(object_id, fut)

    def _resolve_one_future(self, object_id: ObjectID, fut) -> None:
        try:
            fut.set_result(self.store.get(object_id, timeout=0))
        except Exception as exc:  # noqa: BLE001 — the future carries it
            fut.set_exception(exc)

    def cluster_resources(self) -> dict[str, float]:
        return self.cluster.total_resources()

    def available_resources(self) -> dict[str, float]:
        return self.cluster.available_resources()

    def shutdown(self) -> None:
        for actor in list(self._actors.values()):
            actor.kill("runtime shutdown", no_restart=True)
        for submit_queue in list(self._actor_queues.values()):
            submit_queue.put(None)
        self.placement_groups.shutdown()
        self.dispatcher.shutdown()
        self._stop_process_plane()
        self.reference_counter.stop()
        # The runtime's parts refer to each other; dropping the objects
        # here frees what they hold (tensors on the card) at once.
        self.store.close()
        self.gcs.finish_job(self.job_id)

    def _stop_process_plane(self) -> None:
        from ray_tpu_torch._private import worker_pool as pool_mod

        if self.worker_pool is not None:
            self.worker_pool.shutdown()
        pool_mod.stop_factory()
        if self.worker_client_server is not None:
            self.worker_client_server.stop()
            os.environ.pop(worker_client.ADDRESS_ENV, None)
        os.environ.pop(pool_mod.THREADS_ENV, None)
        if self.log_monitor is not None:
            import shutil

            self.log_monitor.stop()
            os.environ.pop(pool_mod.LOG_DIR_ENV, None)
            shutil.rmtree(os.path.dirname(self.log_monitor.log_dir),
                          ignore_errors=True)
        self.shm_client.close_all()
        self.shm_directory.shutdown()


# --------------------------------------------------------------------------
# The process's runtime
# --------------------------------------------------------------------------

_runtime: Runtime | None = None
_runtime_lock = threading.Lock()
_atexit_registered = False


def global_runtime():
    """This process's runtime; in a worker process, the proxy to its
    driver's (made at first use, as refs may unpickle before any call)."""
    if _runtime is not None or not _in_worker_process():
        return _runtime
    active = worker_client.active_worker_runtime()
    if active is not None or not os.environ.get(worker_client.ADDRESS_ENV):
        return active
    return worker_client.get_worker_runtime()


def init(*, num_cpus: float | None = None, num_gpus: float | None = None,
         resources: dict[str, float] | None = None,
         object_store_memory: int | None = None,
         namespace: str = "default", ignore_reinit_error: bool = False,
         system_config: dict | None = None,
         process_workers: int | None = None) -> Runtime:
    """Start the process's runtime. ``num_gpus`` sets the head node's
    ``GPU`` count (by default ``torch.cuda.device_count()``);
    ``process_workers`` starts that many worker processes (by default
    ``worker_pool_size``, 0). In a worker process the public API goes to
    the driver's runtime, and this returns its proxy."""
    global _runtime, _atexit_registered
    if _in_worker_process():
        return worker_client.get_worker_runtime()
    with _runtime_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RuntimeError(
                "ray_tpu_torch.init() has already been called; pass "
                "ignore_reinit_error=True to ignore")
        GLOBAL_CONFIG.update(system_config)
        _runtime = Runtime(num_cpus=num_cpus, num_gpus=num_gpus,
                           resources=resources,
                           object_store_memory=object_store_memory,
                           namespace=namespace,
                           process_workers=process_workers)
        if not _atexit_registered:
            atexit.register(shutdown)
            _atexit_registered = True
        return _runtime


def shutdown() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def auto_init() -> Runtime:
    """The process's runtime, started with the defaults if need be (in a
    worker process, the proxy to the driver's)."""
    runtime = _runtime
    return runtime if runtime is not None else init(ignore_reinit_error=True)


def put(value: Any) -> ObjectRef:
    return auto_init().put(value)


def get(refs, timeout: float | None = None):
    runtime = auto_init()
    if isinstance(refs, ObjectRef):
        return runtime.get([refs], timeout=timeout)[0]
    if isinstance(refs, (list, tuple)):
        return runtime.get(list(refs), timeout=timeout)
    raise TypeError(f"get() expects an ObjectRef or list of ObjectRefs, "
                    f"got {type(refs)}")


def wait(refs, *, num_returns: int = 1, timeout: float | None = None):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return auto_init().wait(list(refs), num_returns=num_returns,
                            timeout=timeout)


def kill(actor_handle, *, no_restart: bool = True) -> None:
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    auto_init().kill_actor(actor_handle._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    auto_init().cancel(ref)


def get_actor(name: str, namespace: str | None = None):
    return auto_init().get_actor_handle(name, namespace)


def cluster_resources() -> dict[str, float]:
    return auto_init().cluster_resources()


def available_resources() -> dict[str, float]:
    return auto_init().available_resources()


def nodes() -> list[dict]:
    return [{"NodeID": r.node_id.hex(), "Alive": r.alive,
             "Resources": dict(r.resources), "Labels": dict(r.labels),
             "NodeManagerAddress": r.address}
            for r in auto_init().gcs.list_nodes()]


def timeline() -> list[dict]:
    """Chrome-trace events, one complete ("X") slice per task that has
    started and ended, on its node's lane."""
    runtime = auto_init()
    lanes: dict[str, int] = {}
    events = []
    for ev in runtime.gcs.list_task_events():
        if not ev.start_time or not ev.end_time:
            continue
        events.append({
            "name": ev.name, "cat": "task", "ph": "X",
            "ts": ev.start_time * 1e6,
            "dur": max(ev.end_time - ev.start_time, 1e-6) * 1e6,
            "pid": lanes.setdefault(ev.node_id, len(lanes)), "tid": 0,
            "args": {"task_id": ev.task_id.hex(), "state": ev.state,
                     "node_id": ev.node_id},
        })
    return events

