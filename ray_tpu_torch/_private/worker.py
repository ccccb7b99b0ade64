"""The process's runtime and the core public API.

The port of ``ray_tpu/_private/worker.py``. ``Runtime`` composes the
object store, the control-plane tables, the cluster's resources (one
head node: ``CPU``, the detected ``GPU``s and any custom resources) and
the dispatcher; the module functions (``init``/``get``/``put``/...)
drive the process's one runtime.

Connected mode (``init(address=...)``): the driver registers with a head
(``gcs_server.py``) as a node of role ``driver`` and mirrors the head's
worker-node daemons into its scheduler. A task the scheduler places on
such a node runs there (``node_executor.py``), spilling to another node
when that one refuses it; a large result stays on the node that made it
(the driver's store holds a ``RemoteBlob`` that is pulled when read), an
argument that lives on a node is pulled by the consumer from its holder,
and a large argument of the driver's is exported once from its export
store. An actor leased on a node lives there (``remote_actor.py``) and
restarts on a surviving node when its node dies. The driver's actor
records and object locations are mirrored to the head.

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

The store spills through the managed tier (spill_manager.py) unless
``spill_enabled`` is off. Every task's spec is kept as the lineage of its
returns (recovery.py), and the node that ran it as their location: when a
virtual node dies (``kill_node`` stops its heartbeat; the health monitor
notices), its objects are marked lost and rebuilt by re-running their
tasks, arguments first, as is an object whose spill file tore. With
worker processes, a memory monitor kills the largest worker under host
memory pressure, and its task is retried on its own budget.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import logging
import os
import queue
import threading
import time
import weakref
from typing import Any, Sequence

import torch

from ray_tpu_torch._private import accelerators, flight_recorder, worker_client
from ray_tpu_torch._private import perf_plane as perf
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
from ray_tpu_torch._private.recovery import (
    LineageTable,
    NodeHealthMonitor,
    ObjectRecoveryManager,
)
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
    ActorError,
    ObjectLostError,
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
    """A worker process, or a node daemon's thread running a fused task:
    the public API there is the proxy to the task's driver."""
    from ray_tpu_torch._private.worker_pool import IN_WORKER_ENV

    return bool(os.environ.get(IN_WORKER_ENV)) \
        or worker_client.in_daemon_task()


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


class _SubmitRecord:
    """One buffered ``.remote()``: its ids and refs were handed out at
    once, the rest waits for the submitter's flush."""

    __slots__ = ("func", "args", "kwargs", "name", "num_returns",
                 "resources", "max_retries", "retry_exceptions",
                 "strategy", "runtime_env", "task_id", "return_ids",
                 "cancelled", "state", "deadline", "submit_ts")

    # Its state, changed under the ring's lock:
    BUFFERED = 0   # in the ring: a cancel is sealed by the ring
    DRAINING = 1   # claimed by a flush: the flush replays a cancel
    SUBMITTED = 2  # handed to the dispatcher


class _SubmitRing:
    """The driver's bounded submit ring: ``.remote()`` pushes a record
    and returns its refs; a submitter thread drains it in flushes, each
    paying the TaskSpecs, the store, lineage and event record-keeping and
    the dispatcher's wakeup once for the whole flush
    (``Runtime._flush_submits``). A full ring blocks ``.remote()``:
    backpressure, never loss."""

    def __init__(self, runtime, capacity: int, flush_max: int):
        self._runtime = runtime
        self._capacity = max(2, int(capacity))
        self._flush_max = max(1, int(flush_max))
        self._cond = threading.Condition()
        self._ring: collections.deque = collections.deque()
        self._by_rid: dict = {}  # return id -> record, until submitted
        self._stop = False
        self._parked = False
        # A test seam: cleared, it holds the drain, so a race against a
        # BUFFERED record (a cancel, an overflow) is deterministic.
        self._gate = threading.Event()
        self._gate.set()
        self.submits = 0
        self.flushes = 0
        self.flush_tasks = 0
        self.ring_full_waits = 0
        self.buffered_cancels = 0
        self._thread = threading.Thread(target=self._drain_loop,
                                        daemon=True,
                                        name="ray_tpu_torch-submitter")
        self._thread.start()

    def holds(self, object_id) -> bool:
        """Whether ``object_id`` is a return of a record not yet handed to
        the dispatcher (attach_future treats it as pending)."""
        with self._cond:
            return object_id in self._by_rid

    def push(self, rec: _SubmitRecord) -> None:
        with self._cond:
            if len(self._ring) >= self._capacity:
                self.ring_full_waits += 1
                while len(self._ring) >= self._capacity and not self._stop:
                    self._cond.wait(0.1)
            self._ring.append(rec)
            for rid in rec.return_ids:
                self._by_rid[rid] = rec
            self.submits += 1
            if self._parked:
                self._cond.notify_all()

    def cancel(self, object_id) -> "_SubmitRecord | None":
        """Cancel a buffered or draining record: the record when the ring
        owns the cancel (a BUFFERED one is sealed here, a DRAINING one by
        its flush), None when the ring does not know ``object_id``."""
        with self._cond:
            rec = self._by_rid.get(object_id)
            if rec is None:
                return None
            if rec.cancelled:
                return rec  # cancelled already
            rec.cancelled = True
            buffered = rec.state == _SubmitRecord.BUFFERED
            if buffered:
                self.buffered_cancels += 1
        if buffered:
            # The flush skips it: this is the one place its error seals.
            self._runtime._seal_cancelled_submit(rec)
        return rec

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._ring and not self._stop:
                    self._parked = True
                    try:
                        self._cond.wait(timeout=0.2)
                    finally:
                        self._parked = False
                if not self._ring and self._stop:
                    return
            # Between wake and claim, so a cleared gate holds records
            # BUFFERED.
            self._gate.wait()
            # In a burst (dozens buffered and more arriving) linger a
            # little, so the producer fills a whole flush instead of
            # trading the GIL record for record; a sustained stall ends
            # the linger.
            if len(self._ring) >= 64:
                deadline = time.monotonic() + 0.05
                last_depth, stalls = -1, 0
                while not self._stop:
                    depth = len(self._ring)
                    if depth >= self._flush_max \
                            or time.monotonic() >= deadline:
                        break
                    stalls = stalls + 1 if depth == last_depth else 0
                    if stalls >= 2:
                        break
                    last_depth = depth
                    time.sleep(0.002)
            with self._cond:
                n = min(len(self._ring), self._flush_max)
                batch = [self._ring.popleft() for _ in range(n)]
                self._cond.notify_all()  # wake blocked pushers
            if not batch:
                continue
            try:
                self._runtime._flush_submits(self, batch)
            except BaseException as exc:  # noqa: BLE001 — the drain never dies
                logger.exception("submit flush failed")
                for rec in batch:
                    with self._cond:
                        for rid in rec.return_ids:
                            self._by_rid.pop(rid, None)
                        sealed = rec.cancelled \
                            and rec.state == _SubmitRecord.BUFFERED
                        rec.state = _SubmitRecord.SUBMITTED
                    if not sealed:
                        for rid in rec.return_ids:
                            self._runtime.store.put_error(rid, exc)
            with self._cond:
                self.flushes += 1
                self.flush_tasks += n

    def depth(self) -> int:
        with self._cond:
            return len(self._ring)

    def stop(self) -> None:
        """Flush what is buffered, then join the submitter."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._gate.set()
        self._thread.join(timeout=10.0)


class Runtime:
    """The store, the control plane and the scheduler of one process."""

    def __init__(self, num_cpus: float | None = None,
                 num_gpus: float | None = None,
                 resources: dict[str, float] | None = None,
                 object_store_memory: int | None = None,
                 namespace: str = "default",
                 process_workers: int | None = None,
                 address: str | None = None,
                 metrics_port: int | None = None):
        cfg = GLOBAL_CONFIG
        self.namespace = namespace
        # The performance plane, armed from config, its histograms
        # cleared (a new session does not replay the last one's), and
        # the flight ring: no flusher in a driver (no per-driver files);
        # it is read live or dumped on demand.
        perf.init_from_config()
        perf.reset()
        flight_recorder.install("driver")
        # The head's stats for /metrics: (method, arguments) -> (fetched
        # at, value), kept briefly so scrapes do not become head calls.
        self._head_stats: dict[tuple, tuple] = {}
        self.job_id = JobID()
        self.gcs_client = None
        self._node_agent = None
        # The head's epoch, learned from reply meta and stamped on this
        # driver's writes to the head; a new one (the head restarted) or
        # a refused write makes the next flush publish everything again.
        self._gcs_epoch: int | None = None
        self._epoch_republish = False
        if address:
            from ray_tpu_torch._private.rpc import MuxRpcClient, RpcError

            # Reconnects to the same address on the next call after the
            # head went away, so a restarted head is found again.
            self.gcs_client = MuxRpcClient(address, timeout_s=60.0)
            self.gcs_client.on_reply_meta = self._on_gcs_reply_meta
            try:
                self.gcs_client.call("ping", timeout_s=10.0)
            except (RpcError, OSError) as exc:
                self.gcs_client.close()
                raise ConnectionError(f"cannot connect to the head at "
                                      f"{address}: {exc}") from exc
        self.gcs = GlobalControlService()
        self.store = ObjectStore(
            memory_limit_bytes=(object_store_memory
                                or cfg.object_store_memory_mb * 1024 * 1024),
            spill_dir=cfg.object_spilling_dir)
        self.reference_counter = ReferenceCounter(self.store)
        self.cluster = ClusterState(
            spread_threshold=float(cfg.scheduler_spread_threshold))
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
        # The pipelined path's counters: fused runs, tasks and fallbacks
        # the batch RPCs reported, batch entries requeued unseen after a
        # node died, and the submit flushes' wall.
        self._fused_runs = 0
        self._fused_tasks = 0
        self._fused_fallbacks = 0
        self._batch_requeues = 0
        self._flush_wall_us = 0
        self._submit_ring = None
        self._actors: dict[ActorID, LocalActor] = {}
        # Signalled whenever an actor lands in _actors or dies: submit
        # queues wait on it.
        self._actors_changed = threading.Condition()
        self._shut_down = False
        self._actor_queues: dict[ActorID, queue.Queue] = {}
        # Actor id -> (node, resources, (group id, bundle index) or None,
        # card shares).
        self._actor_leases: dict[ActorID, tuple] = {}
        self._futures_lock = threading.Lock()
        self._futures: dict[ObjectID,
                            list[concurrent.futures.Future]] = {}
        # (owner address, actor key) -> the ordered call pipe to a named
        # actor of another driver.
        self._foreign_proxies: dict[tuple[str, str],
                                    _ForeignActorProxy] = {}
        # The (namespace, name) entries this driver published in the
        # head's actor directory and has not withdrawn yet.
        self._published_names: set[tuple[str, str]] = set()
        # (deadline, refs): refs nested in the arguments of calls sent
        # lately, held until their receivers' borrows have landed.
        self._arg_pin_pen: collections.deque = collections.deque()
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
        # Lineage and the object directory: the task that made each
        # object and the node that holds it (the objects that die with
        # it). Reentrant: an eviction can run from ObjectRef.__del__.
        self.lineage = LineageTable(cfg.lineage_table_max_entries)
        self.recovery = ObjectRecoveryManager(self)
        self._object_locations: dict[ObjectID, NodeID] = {}
        self._locations_lock = threading.RLock()
        self.reference_counter.on_evict = self._forget_object
        self._start_process_plane(
            cfg.worker_pool_size if process_workers is None
            else process_workers)
        self._arm_spill_tier()
        self.health_monitor = NodeHealthMonitor(
            self.gcs, period_s=cfg.health_check_period_ms / 1000.0,
            failure_threshold=cfg.health_check_failure_threshold,
            on_node_dead=self._on_node_dead)
        self._init_connected_mode(
            address, float(num_cpus if num_cpus is not None
                           else cfg.num_cpus))
        # The submit ring: .remote() returns its refs at once and the
        # ring's thread does the record-keeping, a flush at a time.
        if bool(cfg.submit_pipeline):
            self._submit_ring = _SubmitRing(
                self, int(cfg.submit_ring_size), int(cfg.submit_flush_max))
        # The pins lapse on time, not at the next submit: an idle driver
        # must still let its last ones go.
        self._arg_pin_thread = threading.Thread(
            target=self._arg_pin_sweeper, daemon=True,
            name="ray_tpu_torch-arg-pin-sweeper")
        self._arg_pin_thread.start()
        # The Prometheus endpoint, with metrics_port (0: a free port).
        self.metrics_agent = None
        if metrics_port is not None:
            from ray_tpu_torch._private.metrics_agent import (
                start_metrics_agent,
            )

            self.metrics_agent = start_metrics_agent(self, port=metrics_port)

    # ------------------------------------------------- worker processes

    def _start_process_plane(self, pool_size: int) -> None:
        """The pieces worker processes use: the shared-memory directory
        and the driver's arena, the client server (started at the first
        process spawn, so a runtime of threads pays nothing), the log
        monitor and the pool."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.shm_store import ShmClient, ShmDirectory

        serialization.init_raw_from_config()
        self.shm_directory = ShmDirectory()
        self.shm_client = ShmClient()
        # The native shared arena (plasma-lite, _native/plasma_store.cpp):
        # this driver owns it, and its worker processes attach it by the
        # name they are handed. A failed build raises; object_arena_bytes
        # 0 keeps every object in a segment of its own.
        self.arena = None
        arena_bytes = int(GLOBAL_CONFIG.object_arena_bytes or 0)
        if arena_bytes > 0:
            from ray_tpu_torch._private.arena_store import (
                ArenaStore,
                default_arena_name,
            )

            self.arena = ArenaStore.create(default_arena_name(), arena_bytes)
            if self.arena is None:
                raise RuntimeError(
                    f"cannot create the {arena_bytes}-byte arena "
                    f"{default_arena_name()} in /dev/shm (object_arena_bytes"
                    f"=0 runs without it)")
            self.shm_client.set_arena(self.arena)
            self.shm_directory.set_arena(self.arena)
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
        # Object id -> when it was last promoted to a segment for a pool
        # task: the spiller leaves it alone for a grace window, as the
        # task's frame may not have attached the segment yet.
        self._recent_promotes: dict[ObjectID, float] = {}
        self.memory_monitor = None
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
            int(pool_size), self.shm_directory, self.shm_client,
            arena=self.arena)
        refresh_ms = int(GLOBAL_CONFIG.memory_monitor_refresh_ms or 0)
        if refresh_ms > 0:
            from ray_tpu_torch._private.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                self, threshold=float(GLOBAL_CONFIG.memory_usage_threshold),
                period_s=refresh_ms / 1000.0).start()

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
        """A value freed or spilled: its segment for workers goes, and so
        does its export twin (a daemon that mapped it keeps its
        mapping)."""
        name = self.shm_directory.free(object_id)
        if name is not None:
            self.shm_client.close_segment(name)
        self._drop_export_source(object_id.binary())

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
        """Make an object of this process readable by worker processes,
        at its first use: in the arena (keyed by its id) when it is at
        most ``object_arena_max_object_bytes`` and fits, else in a
        segment of its own. Serialized under a lock: two threads
        promoting one object would race the arena's duplicate-key
        check."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.shm_store import ShmObjectWriter

        with self._promote_lock:
            self._recent_promotes[ref.id()] = time.monotonic()
            desc = self.shm_directory.lookup(ref.id())
            if desc is not None:
                return desc
            header, buffers = serialization.serialize(
                self._materialize_value(ref.id(), self.store.get(ref.id())))
            size = serialization.framed_size(header, buffers)
            if size <= int(GLOBAL_CONFIG.object_arena_max_object_bytes):
                desc = ShmObjectWriter.put_arena_serialized(
                    self.arena, ref.id().binary(), header, buffers, size)
                if desc is not None:
                    self.shm_directory.register_arena(ref.id(), desc)
                    return desc
            desc, seg = ShmObjectWriter.put_serialized(header, buffers, size)
            self.shm_directory.register(ref.id(), desc, seg)
            return desc

    def _shm_actor_args(self, call: _ActorCall) -> None:
        """A process actor's call: each top-level ObjectRef argument
        crosses as the descriptor of its value in the arena or a segment,
        as a pool task's does. The call keeps the refs (``call.refs``)
        until its results are stored: the entry is freed with the last
        ref, and the caller may hold none."""
        from ray_tpu_torch._private.worker_pool import _ShmRef

        refs = ref_args(call.args, call.kwargs)
        if not refs:
            return
        self.get(refs)  # ready (or the first error fails the call)

        def convert(a):
            if not isinstance(a, ObjectRef):
                return a
            try:
                return _ShmRef(self._promote_to_shm(a))
            except Exception as exc:  # noqa: BLE001 — a value that cannot be pickled
                raise ActorError(exc, "", f"{call.method_name} (argument "
                                          f"serialization)") from exc

        call.refs = tuple(refs)
        call.args = tuple(convert(a) for a in call.args)
        call.kwargs = {k: convert(v) for k, v in call.kwargs.items()}

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
        sample: list | None = [] if perf.PERF_ON else None
        try:
            results = self.worker_pool.run_task_blobs(
                digest, func_blob, args_blob, spec.num_returns,
                spec.return_ids, runtime_env=spec.runtime_env,
                task_token=token, perf_sample=sample)
        except _RemoteTaskError as rte:
            rte.cause.__ray_tpu_remote_tb__ = rte.remote_tb
            raise rte.cause from None
        finally:
            with self._inflight_blocks_lock:
                ctx = self._inflight_blocks.pop(token)
            # A worker that died in a blocked get() left the CPU given
            # away: take it back before the dispatcher releases it.
            ctx.drain()
        if sample:
            # The worker's (name, wall, cpu, rss) around the function.
            perf.record_task_resources(*sample[0])
            perf.record_stage("exec_local", float(sample[0][1]))
        for rid, value in results:
            self.store.put(rid, value)
        return True

    # ------------------------------------------------------------ spill tier

    _SHM_PROMOTE_GRACE_S = 30.0

    def _arm_spill_tier(self) -> None:
        """The managed spill tier on the store, unless ``spill_enabled``
        is off (the store then spills inline past its budget)."""
        from ray_tpu_torch._private import spill_manager
        from ray_tpu_torch._private.memory_monitor import (
            set_store_bytes_provider,
        )

        spill_manager.init_from_config()
        if not spill_manager.SPILL_ON:
            return
        # A value moved to disk frees its shared-memory twin as a freed
        # object does (a worker that mapped it keeps its mapping).
        self.store.enable_managed_spill(
            leased_fn=self._spill_protected_ids,
            on_backing_free=self._on_object_freed,
            on_torn=self._recover_torn_object)
        # Admission's store axis counts host bytes only: an object on a
        # card is not host memory and is never spilled.
        set_store_bytes_provider(self.store._host_used)

    def _spill_protected_ids(self) -> set:
        """Id bytes the spiller must skip: the exports a daemon on this
        host holds a map lease on, and values promoted to a segment for a
        pool task within the grace window."""
        out = self._export_leases.pinned_ids()
        now = time.monotonic()
        with self._promote_lock:
            for oid in [o for o, at in self._recent_promotes.items()
                        if now - at > self._SHM_PROMOTE_GRACE_S]:
                del self._recent_promotes[oid]
            out.update(oid.binary() for oid in self._recent_promotes)
        return out

    def _recover_torn_object(self, object_id: ObjectID) -> None:
        """A spill file failed its check on restore and the store marked
        the object lost: rebuild it from lineage (the getter waits for
        the reseal), or seal ObjectLostError."""
        recovered = False
        try:
            recovered = self.recovery.recover(object_id,
                                              reason="spill_torn")
        except Exception:  # noqa: BLE001 — the error below is sealed
            logger.exception("rebuilding torn object %s failed",
                             object_id.hex())
        if not recovered:
            self.store.put_error(object_id, ObjectLostError(
                ObjectRef(object_id, _register=False),
                f"object {object_id.hex()} spill file was torn and no "
                f"lineage can rebuild it"))

    def spill_stats(self) -> dict:
        """The spill tier's counters (zeros when it is off)."""
        from ray_tpu_torch._private.spill_manager import merged_stats

        return merged_stats(self.store._spill)

    # ---------------------------------------------------------------- nodes

    def add_node(self, resources: dict[str, float],
                 labels: dict[str, str] | None = None) -> NodeID:
        """Add a virtual node. Its ``GPU`` count names cards of this
        process from 0 (the nodes share them)."""
        node_id = NodeID()
        self.cluster.add_node(NodeState(
            node_id=node_id, total=dict(resources),
            available=dict(resources), labels=dict(labels or {})))
        self.gcs.register_node(NodeRecord(
            node_id=node_id, address=f"local://{node_id.hex()[:8]}",
            resources=dict(resources), labels=dict(labels or {})))
        return node_id

    def remove_node(self, node_id: NodeID) -> None:
        self.cluster.remove_node(node_id)
        self.gcs.mark_node_dead(node_id)

    def kill_node(self, node_id: NodeID) -> None:
        """Crash a virtual node: its heartbeat stops, and the health
        monitor's detection drives the death (detection, not fiat)."""
        self.health_monitor.suppress(node_id)

    def _on_node_dead(self, node_id: NodeID) -> None:
        """A node died: it leaves scheduling, tasks hard-pinned to it
        fail, and its objects are lost and rebuilt where lineage
        allows."""
        logger.warning("Node %s died; rebuilding its objects",
                       node_id.hex()[:8])
        flight_recorder.record("node.dead", node_id.hex()[:16])
        self.remove_node(node_id)
        for spec in self.dispatcher.fail_hard_affinity(node_id.hex()):
            err = TaskError(
                RuntimeError(f"node {node_id.hex()[:8]} died and task "
                             f"{spec.name} is hard-pinned to it"),
                "", spec.name)
            for rid in spec.return_ids:
                self.store.put_error(rid, err)
        # The node's actors restart on a survivor (or die), even those
        # with no call in flight.
        for actor in list(self._actors.values()):
            if getattr(actor, "node_id", None) == node_id:
                actor.notify_node_death(node_id)
        with self._locations_lock:
            lost = [oid for oid, nid in self._object_locations.items()
                    if nid == node_id]
            for oid in lost:
                del self._object_locations[oid]
        # Everything is marked lost before anything is rebuilt: a rebuild
        # checks is_lost() on its arguments.
        marked = [oid for oid in lost if self.store.mark_lost(oid)]
        for oid in marked:
            try:
                if not self.recovery.recover(oid):
                    # Unregistered: the error lives in the entry it
                    # describes, and a registered ref would pin it.
                    self.store.put_error(oid, ObjectLostError(
                        ObjectRef(oid, _register=False),
                        f"object {oid.hex()} was on dead node "
                        f"{node_id.hex()[:8]} and has no lineage"))
            except Exception:  # noqa: BLE001 — one object must not strand
                logger.exception("failed to handle the loss of object %s",
                                 oid.hex())

    def _record_location(self, object_id: ObjectID,
                         node_id: NodeID) -> None:
        """The node that holds the object: it dies with that node."""
        node = self.cluster.get_node(node_id)
        if node is None or not node.alive:
            # A task that finished after its node died: its result is
            # the driver's, and a dead node's entry would never go.
            return
        with self._locations_lock:
            self._object_locations[object_id] = node_id
            if self.gcs_client is not None:
                self._loc_dirty_adds[object_id.hex()] = node_id.hex()
                self._loc_dirty_removes.discard(object_id.hex())

    def _forget_object(self, object_id: ObjectID) -> None:
        """An evicted object's location and lineage go with it; a copy on
        a node or in the export store is freed there."""
        with self._locations_lock:
            node_id = self._object_locations.pop(object_id, None)
            if node_id is not None and self.gcs_client is not None:
                self._loc_dirty_removes.add(object_id.hex())
                self._loc_dirty_adds.pop(object_id.hex(), None)
        if self._export_store is not None:
            self._export_store.free([object_id.binary()])
            self._export_directory.drop([object_id.binary()])
        self._drop_export_source(object_id.binary())
        if node_id is not None and node_id in self._remote_ever:
            # The holder drops it at the watcher's next flush (kept
            # queued while the node is away).
            with self._remote_free_lock:
                self._remote_free_queue.append((node_id,
                                                object_id.binary()))
        self.lineage.forget([object_id])

    # ------------------------------------------------------- connected mode

    def _init_connected_mode(self, address: str | None,
                             num_cpus: float) -> None:
        """With a head: the export store and its server, the node
        watcher, the actor mirror and this driver's node agent."""
        self._remote_nodes: dict[NodeID, Any] = {}
        self._remote_nodes_lock = threading.Lock()
        self._remote_ever: set[NodeID] = set()
        self._amnesia_misses: dict[NodeID, int] = {}
        self._remote_free_queue: list[tuple[NodeID, bytes]] = []
        self._remote_free_lock = threading.Lock()
        self._loc_dirty_adds: dict[str, str] = {}
        self._loc_dirty_removes: set[str] = set()
        self._loc_keepalive = 0.0
        self._actor_dirty: set[ActorID] = set()
        self._mirror_lock = threading.Lock()
        # None: the first pass publishes (an empty table included).
        self._pg_published: list | None = None
        self._pkg_hashes: dict[str, str] = {}
        self._watcher_stop = threading.Event()
        self._node_watcher = None
        self._export_store = None
        self._export_directory = None
        self._export_spill_mgr = None
        self._obj_server = None
        self._export_addr = ""
        # The same-host plane, the driver's side: an export of at least
        # same_host_map_min_kb is written into a named segment, which
        # daemons on this host map under a lease instead of pulling it
        # in chunks (same_host.py); a node's result is read by one copy
        # out of its holder's segment.
        from ray_tpu_torch._private.same_host import LeaseTable, host_identity

        self.host_id = host_identity()
        self._export_sources: dict[bytes, tuple] = {}
        self._export_segments: dict[bytes, Any] = {}
        self._export_leases = LeaseTable()
        self._export_lock = threading.Lock()
        # The exports being written, each with the event its other
        # converters wait on (_export_once).
        self._export_put_lock = threading.Lock()
        self._export_puts: dict[bytes, threading.Event] = {}
        self._lease_sweep_at = 0.0
        # How this driver read nodes' results: per path, reads, bytes and
        # seconds; and the plans that said the holder's copy was on disk.
        self._remote_gets = {"mapped": [0, 0, 0.0], "chunked": [0, 0, 0.0]}
        self._remote_get_spilled_plans = 0
        if not address:
            return
        from ray_tpu_torch._private import spill_manager
        from ray_tpu_torch._private.node import NodeAgent
        from ray_tpu_torch._private.node_executor import (
            ChunkDirectory,
            NodeObjectStore,
        )
        from ray_tpu_torch._private.rpc import RpcServer

        # Daemon tasks and actors call the driver back through it.
        self.ensure_client_server()
        self._export_store = NodeObjectStore()
        if spill_manager.SPILL_ON:
            # The exports ride the spill tier too; spilling one frees its
            # segment twin. A leased export (a daemon on this host is
            # mapping it) is never a victim.
            self._export_spill_mgr = self._export_store.enable_managed_spill(
                leased_fn=self._export_leases.pinned_ids,
                on_spilled=lambda key, _owner: self._drop_export_source(key))
        self._export_directory = ChunkDirectory()
        self._obj_server = RpcServer()
        self._obj_server.register("ping", lambda: "pong")
        self._obj_server.register("fetch_object", self._export_fetch_object,
                                  concurrent=True)
        self._obj_server.register("fetch_plan", self._export_fetch_plan,
                                  concurrent=True)
        self._obj_server.register("unpin_object",
                                  self._export_leases.release)
        self._obj_server.start()
        self._export_addr = self._obj_server.address
        self.gcs.pubsub.subscribe("actors", self._queue_actor_mirror)
        self._node_agent = NodeAgent(
            address, {"CPU": num_cpus}, labels={"node_role": "driver"},
            usage_fn=self.available_resources)
        # The nodes registered by now are schedulable when init returns.
        self._sync_remote_nodes(self.gcs_client.call("list_nodes"))
        self._node_watcher = threading.Thread(
            target=self._watch_remote_nodes, daemon=True,
            name="ray_tpu_torch-node-watcher")
        self._node_watcher.start()
        # The tasks a dispatch pass claims for one node ride one
        # execute_task_batch RPC.
        self.dispatcher.set_batch_hooks(self._task_batch_key,
                                        self._run_task_batch)

    def _export_fetch_object(self, id_bytes: bytes, offset: int,
                             length: int):
        return self._export_store.read_chunk(id_bytes, offset, length)

    def _export_fetch_plan(self, id_bytes: bytes,
                           puller_addr: str | None = None,
                           puller_host: str | None = None):
        """(size, the other holders, the map source) of an exported
        object. A puller on another host is registered, so the next one
        takes chunks from it too; one on this host is granted a lease on
        the export's segment instead and moves no bytes through the
        transport."""
        from ray_tpu_torch._private.node_executor import plan_holders
        from ray_tpu_torch._private.same_host import map_enabled

        total = self._export_store.size(id_bytes)
        if total is None:
            return None
        map_info = None
        if puller_addr and puller_host and map_enabled() \
                and puller_host == self.host_id:
            map_info = self._grant_export_lease(id_bytes, puller_addr)
        reg_addr = None if map_info is not None else puller_addr
        return (total, plan_holders(self._export_directory, id_bytes,
                                    reg_addr, total), map_info)

    def _grant_export_lease(self, id_bytes: bytes,
                            holder: str) -> dict | None:
        """A lease for ``holder`` on the export's segment, or on its arena
        twin, which stays pinned in the arena until the lease ends."""
        with self._export_lock:
            source = self._export_sources.get(id_bytes)
        if source is None:
            return None
        kind, name, size = source
        key = b""
        if kind == "arena":
            arena, key = self.arena, id_bytes
            if arena is None or arena.pin(key) is None:
                return None
            token = self._export_leases.grant(
                id_bytes, holder, on_release=lambda: arena.unpin(key))
        else:
            token = self._export_leases.grant(id_bytes, holder)
        return {"kind": kind, "name": name, "key": key, "size": size,
                "host": self.host_id, "token": token}

    def _register_export_source(self, id_bytes: bytes, header, buffers,
                                size: int):
        """Back an export with shared memory that daemons on this host
        read: one of at least ``same_host_map_min_kb`` is written straight
        into a named segment (returned as a view of the framed bytes,
        which the export store keeps); one of at most
        ``object_arena_max_object_bytes`` gets a twin in the arena under
        its id (the export store keeps a heap copy of its own: the twin
        is what same-host peers read, the copy what the chunked pull
        serves). None when the caller keeps a heap copy alone (the plane
        off, no room)."""
        from multiprocessing import shared_memory

        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.same_host import map_enabled, map_min_bytes
        from ray_tpu_torch._private.shm_store import ShmObjectWriter

        if not map_enabled():
            return None
        if size < map_min_bytes():
            if self.arena is None or size > int(
                    GLOBAL_CONFIG.object_arena_max_object_bytes):
                return None
            if ShmObjectWriter.put_arena_serialized(
                    self.arena, id_bytes, header, buffers, size) is None:
                return None
            with self._export_lock:
                self._export_sources[id_bytes] = ("arena", self.arena.name,
                                                  size)
            buf = bytearray(size)
            serialization.write_framed(memoryview(buf), header, buffers)
            return bytes(buf)
        try:
            seg = shared_memory.SharedMemory(create=True, size=max(size, 1))
        except OSError:
            return None  # /dev/shm is full: a heap copy, pulled in chunks
        serialization.write_framed(seg.buf, header, buffers)
        with self._export_lock:
            self._export_sources[id_bytes] = ("seg", seg.name, size)
            self._export_segments[id_bytes] = seg
        return memoryview(seg.buf)[:size]

    def _drop_export_source(self, id_bytes: bytes) -> None:
        """The export is freed or spilled: the leases on it end (their
        arena pins with them), then its segment is unlinked (a daemon
        that mapped it keeps its mapping) or its arena twin unpinned and
        deleted."""
        with self._export_lock:
            source = self._export_sources.pop(id_bytes, None)
            seg = self._export_segments.pop(id_bytes, None)
        if source is None:
            return
        self._export_leases.release_object(id_bytes)
        if source[0] == "arena" and self.arena is not None:
            self.arena.unpin(id_bytes)  # the seal_pinned reference
            self.arena.delete(id_bytes)
        if seg is not None:
            _unlink_export_segment(seg)

    def remote_get_stats(self) -> dict:
        """How this driver read nodes' results, per path (``mapped``: one
        copy out of the holder's segment on this host; ``chunked``: the
        chunked pull): reads, bytes, seconds; ``spilled_plans``: plans
        that said the holder's copy was on its disk."""
        with self._counter_lock:
            out = {path: {"gets": n, "bytes": b, "seconds": t}
                   for path, (n, b, t) in self._remote_gets.items()}
            out["spilled_plans"] = self._remote_get_spilled_plans
        out["export_leases"] = self._export_leases.stats()
        return out

    def _client_server_addr(self) -> str:
        server = self.worker_client_server
        return "" if server is None else server.address

    def _watch_remote_nodes(self) -> None:
        """Mirror the head's node table into the scheduler. Membership
        and availability arrive by push on the head's channels (a long
        poll). The whole table is read again on a membership event, on
        every new subscription (what was published before it is
        missed) and every 10 s; availability comes from the pushes only,
        and a report older than its TTL gives way to this driver's
        ledger. Each wake also flushes queued frees, location deltas and
        actor records."""
        from ray_tpu_torch._private.gcs_pubsub import GcsSubscriber
        from ray_tpu_torch._private.rpc import (
            RpcError,
            RpcMethodError,
            call_with_retry,
        )

        subscriber = None
        last_sync = 0.0
        try:
            while not self._watcher_stop.is_set():
                with self._remote_free_lock:
                    busy = bool(self._remote_free_queue)
                with self._locations_lock:
                    busy = busy or bool(self._loc_dirty_adds
                                        or self._loc_dirty_removes)
                membership = False
                events = []
                if subscriber is None:
                    try:
                        subscriber = GcsSubscriber(
                            self.gcs_client.address,
                            ["nodes", "node_resources", "object_loss"])
                        membership = True
                    except Exception:  # noqa: BLE001 — the head is gone: the next pass subscribes again
                        self._watcher_stop.wait(0.5)
                if subscriber is not None:
                    try:
                        events = subscriber.poll(
                            timeout_s=0.5 if busy else 5.0)
                    except Exception:  # noqa: BLE001 — the head is gone: the next pass subscribes again
                        subscriber.close()
                        subscriber = None
                        self._watcher_stop.wait(0.5)
                if self._watcher_stop.is_set():
                    return
                for channel, message in events:
                    if channel == "node_resources":
                        hex_id, available = message
                        self.cluster.update_reported(
                            NodeID(bytes.fromhex(hex_id)), available)
                    elif channel == "object_loss":
                        self._handle_object_loss(message)
                    else:  # "nodes", or "resubscribed"
                        membership = True
                try:
                    self._flush_remote_frees()
                    self._flush_object_locations()
                    self._flush_control_mirror()
                    now = time.monotonic()
                    if membership or now - last_sync >= 10.0:
                        self._sync_remote_nodes(call_with_retry(
                            self.gcs_client.call, "list_nodes",
                            attempts=2, timeout_s=10.0))
                        last_sync = now
                except (RpcError, RpcMethodError, OSError):
                    continue  # the head is down: the next pass retries
                except Exception:  # noqa: BLE001 — the watcher must live
                    logger.exception("remote node sync failed")
        finally:
            if subscriber is not None:
                subscriber.close()

    def _sync_remote_nodes(self, nodes: list[dict]) -> None:
        """Reconcile with the head's table: a node the head declared dead
        (or whose executor moved, or that registered again under a new
        id) is dropped; a node merely absent is pinged first and dropped
        after ``node_amnesia_max_passes`` absent passes; a new live node
        joins (one seen before keeps its ledger)."""
        from ray_tpu_torch._private.node_executor import RemoteNodeHandle

        listed = {NodeID(bytes.fromhex(info["node_id"])): info
                  for info in nodes if info.get("executor_address")}
        with self._remote_nodes_lock:
            known = dict(self._remote_nodes)
        alive_addrs = {info["executor_address"]
                       for info in listed.values() if info["alive"]}
        absent = []
        for node_id, handle in known.items():
            info = listed.get(node_id)
            if info is None and handle.address in alive_addrs \
                    or info is not None and (
                        not info["alive"]
                        or info["executor_address"] != handle.address):
                self._drop_remote_node(node_id)
            elif info is None:
                absent.append((node_id, handle))
            else:
                self._amnesia_misses.pop(node_id, None)
        max_passes = max(1, int(GLOBAL_CONFIG.node_amnesia_max_passes))
        for node_id, handle in absent:
            misses = self._amnesia_misses.get(node_id, 0) + 1
            if not handle.ping() or misses > max_passes:
                self._amnesia_misses.pop(node_id, None)
                self._drop_remote_node(node_id)
            else:
                self._amnesia_misses[node_id] = misses
        for node_id, info in listed.items():
            if not info["alive"]:
                continue
            with self._remote_nodes_lock:
                already = node_id in self._remote_nodes
            if already:
                continue
            handle = RemoteNodeHandle(node_id, info["executor_address"])
            if not handle.ping():
                handle.close()
                continue
            with self._remote_nodes_lock:
                self._remote_nodes[node_id] = handle
                self._remote_ever.add(node_id)
            if not self.cluster.revive_node(node_id):
                self.cluster.add_node(NodeState(
                    node_id=node_id, total=dict(info["resources"]),
                    available=dict(info["resources"]),
                    labels={**info.get("labels", {}), "remote": "1"}))
            logger.info("remote node %s (%s) joined with %s",
                        info["node_id"][:8], info["executor_address"],
                        info["resources"])

    def _drop_remote_node(self, node_id: NodeID) -> None:
        """A node is gone: its handle closes and it dies here (its tasks
        retry elsewhere, its objects are rebuilt, its actors restart)."""
        with self._remote_nodes_lock:
            handle = self._remote_nodes.pop(node_id, None)
            alive = set(self._remote_nodes)
        if handle is None:
            return
        handle.close()
        # Spillback avoid sets made against the old membership may now
        # exclude every surviving node.
        self.dispatcher.reset_unsatisfiable_avoids(alive)
        self._on_node_dead(node_id)

    def _handle_object_loss(self, obj_hexes) -> None:
        """The head reports objects whose last holder died: rebuild ours
        now, not at the next get()."""
        flight_recorder.record("object.loss", len(obj_hexes))
        for obj_hex in obj_hexes:
            oid = ObjectID(bytes.fromhex(obj_hex))
            with self._locations_lock:
                if oid not in self._object_locations:
                    continue
                del self._object_locations[oid]
            if self.store.mark_lost(oid) and not self.recovery.recover(oid):
                self.store.put_error(oid, ObjectLostError(
                    ObjectRef(oid, _register=False),
                    f"object {obj_hex} lost its last holder and has no "
                    f"lineage"))

    def _flush_remote_frees(self) -> None:
        """Tell the holders of freed results to drop them (batched); a
        node away for a while keeps its frees queued."""
        with self._remote_free_lock:
            queued, self._remote_free_queue = self._remote_free_queue, []
        if not queued:
            return
        by_node: dict[NodeID, list[bytes]] = {}
        for node_id, id_bytes in queued:
            by_node.setdefault(node_id, []).append(id_bytes)
        retained = []
        for node_id, ids in by_node.items():
            with self._remote_nodes_lock:
                handle = self._remote_nodes.get(node_id)
            try:
                if handle is None:
                    raise LookupError(node_id)
                handle.free(ids)
            except Exception:  # noqa: BLE001 — retried at the next flush
                retained.extend((node_id, i) for i in ids)
        if retained:
            with self._remote_free_lock:
                self._remote_free_queue.extend(retained)
                if len(self._remote_free_queue) > 100_000:
                    del self._remote_free_queue[:-50_000]

    def _on_gcs_reply_meta(self, meta: dict) -> None:
        """On the head client's reader thread: a new epoch (the head
        restarted) schedules a full republish of this driver's
        locations, actor records and placement groups."""
        epoch = meta.get("epoch") if isinstance(meta, dict) else None
        if not isinstance(epoch, int):
            return
        prior, self._gcs_epoch = self._gcs_epoch, epoch
        if prior is not None and epoch != prior:
            flight_recorder.record("epoch.bump", prior, epoch)
            self._epoch_republish = True
            self._loc_keepalive = 0.0

    def _handle_stale_epoch(self, exc: BaseException) -> bool:
        """Whether ``exc`` is the head's typed fence: take the epoch it
        carries and schedule the full republish."""
        from ray_tpu_torch._private.gcs import StaleEpochError
        from ray_tpu_torch._private.rpc import RpcMethodError

        cause = exc.cause if isinstance(exc, RpcMethodError) else exc
        if not isinstance(cause, StaleEpochError):
            return False
        flight_recorder.record("gcs.stale_epoch", cause.current_epoch)
        self._gcs_epoch = cause.current_epoch
        self._epoch_republish = True
        self._loc_keepalive = 0.0
        return True

    def _flush_object_locations(self) -> None:
        """Location deltas to the head's directory, stamped with the
        head's epoch. Every 10 s, and at once after the head restarted,
        the update carries every entry (a keepalive of this owner's
        lease and a full republish)."""
        if self.gcs_client is None:
            return
        with self._locations_lock:
            adds = list(self._loc_dirty_adds.items())
            removes = list(self._loc_dirty_removes)
            self._loc_dirty_adds.clear()
            self._loc_dirty_removes.clear()
            have_entries = bool(self._object_locations)
        now = time.monotonic()
        full = have_entries and now - self._loc_keepalive >= 10.0
        if not adds and not removes and not full:
            return
        if full:
            with self._locations_lock:
                adds = [(oid.hex(), nid.hex()) for oid, nid
                        in self._object_locations.items()]
        try:
            self.gcs_client.call("object_locations_update",
                                 self._export_addr, adds, removes,
                                 epoch=self._gcs_epoch, timeout_s=10.0)
            if full:
                self._loc_keepalive = now
        except Exception as exc:  # noqa: BLE001 — requeued for the next flush
            self._handle_stale_epoch(exc)
            with self._locations_lock:
                for obj_hex, node_hex in adds:
                    self._loc_dirty_adds.setdefault(obj_hex, node_hex)
                self._loc_dirty_removes.update(removes)

    def _queue_actor_mirror(self, event) -> None:
        """An actor transition: its record goes to the head at the
        watcher's next pass."""
        with self._mirror_lock:
            self._actor_dirty.add(event[1])

    def _flush_control_mirror(self) -> None:
        """The actor records that changed, and the placement groups when
        they did, to the head's mirrors, stamped with its epoch; after a
        head restart, all of them."""
        if self._epoch_republish:
            self._epoch_republish = False
            with self._mirror_lock:
                self._actor_dirty.update(
                    r.actor_id for r in self.gcs.list_actors())
                self._pg_published = None
        with self._mirror_lock:
            dirty, self._actor_dirty = self._actor_dirty, set()
        records = [self.gcs.actor_plain(r) for r in
                   (self.gcs.get_actor(a) for a in dirty) if r is not None]
        try:
            if records:
                self.gcs_client.call("actor_update", records,
                                     epoch=self._gcs_epoch, timeout_s=10.0)
        except Exception as exc:  # noqa: BLE001 — retried at the next pass
            self._handle_stale_epoch(exc)
            with self._mirror_lock:
                self._actor_dirty.update(dirty)
        groups = self.placement_groups.snapshot()
        if groups != self._pg_published:
            try:
                self.gcs_client.call("pg_update", self.job_id.hex(), groups,
                                     epoch=self._gcs_epoch, timeout_s=10.0)
                self._pg_published = groups
            except Exception as exc:  # noqa: BLE001 — retried at the next pass
                self._handle_stale_epoch(exc)

    def _convert_remote_args(self, args: tuple, kwargs: dict) -> bytes:
        """The framed arguments of work sent to a node. An ObjectRef
        argument becomes a FetchRef to its holder (a node's result) or
        to this driver's export store (a large value of the driver's,
        exported once); a small value goes inline."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.node_executor import (
            FetchRef,
            RemoteBlob,
            _inline_reply_bytes,
        )
        from ray_tpu_torch._private.object_ref import collect_reduced_refs
        from ray_tpu_torch._private.object_store import _sizeof

        def convert(a):
            if not isinstance(a, ObjectRef):
                return a
            id_bytes = a.binary()
            # size(), not get(): a spilled export stays on disk.
            if self._export_store.size(id_bytes) is not None:
                return FetchRef(id_bytes, self._export_addr)
            value = self.store.get(a.id())  # sealed before dispatch
            if isinstance(value, RemoteBlob):
                return FetchRef(id_bytes, value.addr)
            if _sizeof(value) > _inline_reply_bytes():
                self._export_once(id_bytes, value)
                return FetchRef(id_bytes, self._export_addr)
            return value

        # Every ref the payload carries (those in custom objects and in
        # values exported by convert() too) is pinned for the grace
        # period, as _pin_nested_arg_refs pins the plain containers'.
        nested: list = []
        with collect_reduced_refs(nested):
            blob = serialization.serialize_framed(
                (tuple(convert(a) for a in args),
                 {k: convert(v) for k, v in kwargs.items()}))
        if nested:
            self._arg_pin_pen.append(
                (time.monotonic() + self._ARG_PIN_GRACE_S, nested))
        return blob

    def _export_once(self, id_bytes: bytes, value: Any) -> None:
        """Export a large value once, even when tasks convert it at once:
        the first serializes it straight into a named segment (which
        daemons on this host map and the chunked pull serves from) and
        the others wait for it; exports of other objects go on."""
        from ray_tpu_torch._private import serialization

        while True:
            with self._export_put_lock:
                if self._export_store.size(id_bytes) is not None:
                    return
                done = self._export_puts.get(id_bytes)
                leader = done is None
                if leader:
                    done = self._export_puts[id_bytes] = threading.Event()
            if not leader:
                # Then look again: the first may have failed.
                done.wait()
                continue
            try:
                header, buffers = serialization.serialize(value)
                size = serialization.framed_size(header, buffers)
                shm_blob = self._register_export_source(
                    id_bytes, header, buffers, size)
                self._export_store.put(
                    id_bytes, shm_blob if shm_blob is not None
                    else serialization.serialize_framed(value))
            finally:
                with self._export_put_lock:
                    del self._export_puts[id_bytes]
                done.set()
            return

    def _package_runtime_env(self, renv: dict | None) -> dict | None:
        """A runtime env's local directories become content-hashed
        packages in the export store, which nodes pull and cache
        (runtime_env_packaging.py)."""
        if not renv or self._export_store is None:
            return renv
        from ray_tpu_torch._private.runtime_env_packaging import (
            hash_directory,
            package_directory,
        )

        def pack(path, keep_name: bool):
            if not (isinstance(path, str) and os.path.isdir(path)):
                return path
            key = os.path.abspath(path)
            # Hashed at every submit: an edited directory ships anew.
            hash_hex = hash_directory(key)
            if self._pkg_hashes.get(key) != hash_hex \
                    or self._export_store.size(
                        bytes.fromhex(hash_hex)) is None:
                hash_hex, blob = package_directory(key)
                self._export_store.put(bytes.fromhex(hash_hex), blob)
                self._pkg_hashes[key] = hash_hex
            member = os.path.basename(key.rstrip("/")) if keep_name \
                else None
            return {"__pkg__": [hash_hex, self._export_addr, member]}

        out = dict(renv)
        if "working_dir" in out:
            out["working_dir"] = pack(out["working_dir"], keep_name=False)
        if out.get("py_modules"):
            out["py_modules"] = [pack(m, keep_name=True)
                                 for m in out["py_modules"]]
        return out

    def _seal_remote_results(self, return_ids, results, node_id,
                             address) -> None:
        """Seal a node's reply: small values here, a large one as a
        RemoteBlob whose location is recorded."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.node_executor import RemoteBlob

        for rid, packed in zip(return_ids, results):
            if packed[0] == "inline":
                self.store.put(rid, serialization.deserialize_from_buffer(
                    memoryview(packed[1])))
            elif packed[0] == "stored":
                self.store.put(rid, RemoteBlob(node_id.hex(), address,
                                               packed[1]))
                self._record_location(rid, node_id)
            else:  # ("err", blob): this return failed to pickle
                exc, tb = serialization.deserialize_from_buffer(
                    memoryview(packed[1]))
                exc.__ray_tpu_remote_tb__ = tb
                raise exc

    def _materialize_value(self, object_id: ObjectID, value: Any) -> Any:
        """A RemoteBlob's value, pulled from its holder and sealed here;
        a holder that is gone means a rebuild from lineage, or
        ObjectLostError."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.node_executor import RemoteBlob, fetch_blob
        from ray_tpu_torch._private.rpc import RpcClient

        if not isinstance(value, RemoteBlob):
            return value
        node_id = NodeID(bytes.fromhex(value.node_hex))
        with self._remote_nodes_lock:
            handle = self._remote_nodes.get(node_id)
        try:
            start = time.perf_counter()
            client = None if handle is not None else RpcClient(value.addr)
            try:
                call = handle.pool.call if handle is not None \
                    else client.call
                # A holder on this host: one copy out of its segment;
                # otherwise (or when no lease is granted) the chunked
                # pull.
                blob = self._fetch_mapped(call, object_id.binary())
                path = "mapped"
                if blob is None:
                    path = "chunked"
                    blob = handle.fetch(object_id.binary()) \
                        if handle is not None \
                        else fetch_blob(client, object_id.binary())
            finally:
                if client is not None:
                    client.close()
            with self._counter_lock:
                entry = self._remote_gets[path]
                entry[0] += 1
                entry[1] += len(blob)
                entry[2] += time.perf_counter() - start
            real = serialization.deserialize_from_buffer(memoryview(blob))
        except Exception as exc:  # noqa: BLE001 — the holder is gone
            if not self.store.mark_lost(object_id):
                raise
            if self.recovery.recover(object_id):
                return self._materialize_value(
                    object_id, self.store.get(object_id))
            err = ObjectLostError(
                ObjectRef(object_id, _register=False),
                f"object {object_id.hex()} was on unreachable node "
                f"{value.node_hex[:8]} and has no lineage: {exc}")
            self.store.put_error(object_id, err)
            raise err from exc
        self.store.put(object_id, real)
        return real

    def _fetch_mapped(self, call, id_bytes: bytes) -> bytes | None:
        """A node's result copied out of its holder's segment, when the
        holder is on this host and grants a lease; else None."""
        from ray_tpu_torch._private.same_host import (
            fetch_mapped_blob,
            map_enabled,
        )

        if not (map_enabled() and self._export_addr):
            return None
        plan: dict = {}
        blob = fetch_mapped_blob(call, id_bytes, self._export_addr,
                                 self.host_id, plan_out=plan)
        if plan.get("spilled"):
            with self._counter_lock:
                self._remote_get_spilled_plans += 1
        return blob

    def _execute_remote(self, spec: TaskSpec, node: NodeState,
                        handle) -> None:
        """Run the task on the node daemon that holds its lease. A
        function or argument that cannot be serialized fails the task:
        the lease (and a card share) is that node's, never this
        process's."""
        from ray_tpu_torch._private.rpc import RpcError

        try:
            digest, func_blob = self._function_blob(spec.func)
            args_blob = self._convert_remote_args(spec.args, spec.kwargs)
        except Exception as exc:  # noqa: BLE001 — sealed onto the task's refs by the caller
            raise TypeError(
                f"task {spec.name} is leased to node "
                f"{node.node_id.hex()[:8]}, but its function or arguments "
                f"cannot be serialized: {type(exc).__name__}: {exc}") \
                from exc
        # The task's token keys the node's reservation and this driver's
        # block context: a nested get() from the task gives its CPU back
        # on both ledgers while it waits.
        token = spec.task_id.hex()
        bundled = spec.scheduling_strategy.kind == "PLACEMENT_GROUP"

        def control(method):
            def call():
                try:
                    handle._control.call(method, token)
                except Exception:  # noqa: BLE001 — the node is gone
                    pass
            return call

        with self._inflight_blocks_lock:
            self._inflight_blocks[token] = BlockedResourceContext(
                self.cluster, node.node_id,
                {} if bundled else spec.resources,
                on_release=control("task_block"),
                on_reacquire=control("task_unblock"))
        t_send = time.time()
        if perf.PERF_ON and spec.dispatch_ts:
            perf.record_stage("dispatch_rpc",
                              max(0.0, t_send - spec.dispatch_ts))
        try:
            results = handle.execute(
                digest, func_blob, args_blob, spec.num_returns,
                [rid.binary() for rid in spec.return_ids],
                self._package_runtime_env(spec.runtime_env),
                spec.resources, task_token=token,
                client_addr=self._client_server_addr() or None,
                deadline=spec.deadline)
        except (RpcError, OSError) as exc:
            # A dead node, not one reset socket, loses its objects.
            if not handle.ping():
                self._drop_remote_node(node.node_id)
            raise WorkerCrashedError(
                f"node {node.node_id.hex()[:8]} unreachable during task "
                f"{spec.name}: {exc}") from exc
        finally:
            with self._inflight_blocks_lock:
                ctx = self._inflight_blocks.pop(token)
            ctx.drain()
        self._seal_remote_results(spec.return_ids, results, node.node_id,
                                  handle.address)
        if perf.PERF_ON:
            perf.record_stage("rpc_seal", max(0.0, time.time() - t_send))

    # ----------------------------------------------------- batched dispatch

    def _task_batch_key(self, spec: TaskSpec, node: NodeState, run):
        """The dispatcher's batch key: the tasks a pass claims for one
        remote node ride one execute_task_batch RPC. A task on this
        process, a ``GPU`` task (it runs on its daemon's dispatch thread,
        on its card), a placement-group task and a custom run callable
        take a thread of their own."""
        if node is None or run != self._execute_task:
            return None
        if spec.resources.get("GPU", 0.0) > 0 \
                or spec.scheduling_strategy.kind == "PLACEMENT_GROUP":
            return None
        with self._remote_nodes_lock:
            if node.node_id not in self._remote_nodes:
                return None
        return node.node_id

    def _collect_remote_results(self, return_ids, results, node_id,
                                address, out_pairs: list) -> None:
        """A task's reply entries as (return id, value) pairs appended to
        ``out_pairs`` (the caller seals a whole completion group with one
        ``put_batch``). Raises on an error entry, failing that task
        alone."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.node_executor import RemoteBlob

        for rid, packed in zip(return_ids, results):
            if packed[0] == "inline":
                out_pairs.append((rid, serialization.deserialize_from_buffer(
                    memoryview(packed[1]))))
            elif packed[0] == "stored":
                out_pairs.append((rid, RemoteBlob(node_id.hex(), address,
                                                  packed[1])))
                self._record_location(rid, node_id)
            else:  # ("err", blob): this return failed to pickle
                exc, tb = serialization.deserialize_from_buffer(
                    memoryview(packed[1]))
                exc.__ray_tpu_remote_tb__ = tb
                raise exc

    def _shed_remote(self, spec: TaskSpec, node: NodeState, why: str,
                     start: float) -> None:
        """A node shed the task at admission: a deadline-armed task fails
        at once with the retryable SystemOverloadedError (its budget
        would die waiting), any other spills back."""
        with self._counter_lock:
            self._admission_shed += 1
        if spec.deadline is None:
            self._spillback_requeue(spec, node)
            return
        err = SystemOverloadedError(
            f"node {node.node_id.hex()[:8]} shed the task: {why}")
        for rid in spec.return_ids:
            self.store.put_error(rid, err)
        self.gcs.record_task_event(TaskEvent(
            spec.task_id, spec.name, "FAILED", start_time=start,
            end_time=time.time(), error=f"shed: {why}"))

    def _run_task_batch(self, specs: list, node: NodeState,
                        complete) -> None:
        """The dispatcher's batch runner: one execute_task_batch RPC
        carries the run to ``node``; each streamed completion group is
        sealed with one ``put_batch`` and its claims released together
        (``complete.many``), with no wait for the slowest task.

        If the stream is cut (the daemon died), an entry the daemon never
        marked started is requeued unseen (at most three times); one that
        may have started fails with WorkerCrashedError, which retries
        under its ``max_retries``."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.rpc import RpcError, RpcMethodError

        with self._remote_nodes_lock:
            handle = self._remote_nodes.get(node.node_id)
        if handle is None:
            # The node went between claim and launch: the single path
            # does the unreachable-node bookkeeping.
            for spec in specs:
                try:
                    self._execute_task(spec, node)
                finally:
                    complete(spec)
            return
        start = time.time()
        client_addr = self._client_server_addr() or None
        entries: list = []
        ctx_by_idx: dict[int, BlockedResourceContext] = {}
        spec_by_idx: dict[int, TaskSpec] = {}
        fallback: list = []

        def control(method, token):
            def call():
                try:
                    handle._control.call(method, token)
                except Exception:  # noqa: BLE001 — the node is gone
                    pass
            return call

        for spec in specs:
            if spec.deadline is not None and start > spec.deadline:
                self._seal_deadline(spec, "execute")
                complete(spec)
                continue
            try:
                digest, func_blob = self._function_blob(spec.func)
                args_blob = self._convert_remote_args(spec.args,
                                                      spec.kwargs)
                runtime_env = self._package_runtime_env(spec.runtime_env)
            except Exception:  # noqa: BLE001 — the single path reports it
                fallback.append(spec)
                continue
            has_refs = any(isinstance(a, ObjectRef) for a in spec.args) \
                or any(isinstance(v, ObjectRef)
                       for v in spec.kwargs.values())
            token = spec.task_id.hex()
            with handle._digest_lock:
                known = digest in handle.known_digests
                # Optimistic: a daemon that restarted answers need_func
                # for that task, which then goes the single path.
                handle.known_digests.add(digest)
            idx = len(entries)
            # Flags bit 0: the arguments hold FetchRefs; bit 2: the
            # dispatcher filled this claim past the node's free slots.
            entry = (digest, None if known else func_blob, args_blob,
                     spec.num_returns,
                     [rid.binary() for rid in spec.return_ids],
                     runtime_env, spec.resources, token,
                     (1 if has_refs else 0)
                     | (2 if getattr(spec, "_overcommit", False) else 0))
            if spec.deadline is not None:
                # The 10th element is the trace context (not ported).
                entry = entry + (None, spec.deadline)
            entries.append(entry)
            spec_by_idx[idx] = spec
            ctx = BlockedResourceContext(
                self.cluster, node.node_id, spec.resources,
                on_release=control("task_block", token),
                on_reacquire=control("task_unblock", token))
            ctx_by_idx[idx] = ctx
            with self._inflight_blocks_lock:
                self._inflight_blocks[token] = ctx
            self.gcs.record_task_event(TaskEvent(
                spec.task_id, spec.name, "RUNNING", start_time=start,
                node_id=node.node_id.hex()))
        complete_many = getattr(complete, "many", None)

        def finish_idx(idx: int, defer: "list | None" = None) -> None:
            spec = spec_by_idx.pop(idx, None)
            if spec is None:
                return
            ctx = ctx_by_idx.pop(idx, None)
            if ctx is not None:
                with self._inflight_blocks_lock:
                    self._inflight_blocks.pop(spec.task_id.hex(), None)
                ctx.drain()
            if defer is not None:
                defer.append(spec)
            else:
                complete(spec)

        t_send = time.time()

        def on_results(group) -> None:
            pairs: list = []
            deferred: "list | None" = [] if complete_many is not None \
                else None
            end = time.time()
            for idx, reply in group:
                spec = spec_by_idx.get(idx)
                if spec is None:
                    continue  # a duplicate
                kind = reply[0]
                if perf.PERF_ON and kind in ("ok", "err"):
                    perf.record_stage("rpc_seal", max(0.0, end - t_send))
                if kind == "ok":
                    try:
                        self._collect_remote_results(
                            spec.return_ids, reply[1], node.node_id,
                            handle.address, pairs)
                        self.gcs.record_task_event(TaskEvent(
                            spec.task_id, spec.name, "FINISHED",
                            start_time=start, end_time=end,
                            node_id=node.node_id.hex()))
                    except BaseException as exc:  # noqa: BLE001 — this task's
                        self._finish_task_failure(spec, exc, start)
                    finish_idx(idx, deferred)
                elif kind == "err":
                    exc, tb = serialization.deserialize_from_buffer(
                        memoryview(reply[1]))
                    exc.__ray_tpu_remote_tb__ = tb
                    self._finish_task_failure(spec, exc, start)
                    finish_idx(idx, deferred)
                elif kind == "busy":
                    finish_idx(idx, deferred)
                    self._spillback_requeue(spec, node)
                elif kind == "timeout":
                    self._seal_deadline(spec, reply[1] if len(reply) > 1
                                        and reply[1] else "admitted")
                    finish_idx(idx, deferred)
                elif kind == "overloaded":
                    finish_idx(idx, deferred)
                    self._shed_remote(spec, node, str(reply[1]), start)
                elif kind == "cancelled":
                    self._finish_task_failure(
                        spec, TaskCancelledError(spec.task_id), start)
                    finish_idx(idx, deferred)
                else:  # ("need_func", _): the single path resends it
                    spec_by_idx.pop(idx, None)
                    ctx = ctx_by_idx.pop(idx, None)
                    if ctx is not None:
                        with self._inflight_blocks_lock:
                            self._inflight_blocks.pop(spec.task_id.hex(),
                                                      None)
                        ctx.drain()

                    def redo(spec=spec):
                        try:
                            self._execute_task(spec, node)
                        finally:
                            complete(spec)

                    threading.Thread(target=redo, daemon=True,
                                     name="ray_tpu_torch-task-refunc").start()
            if pairs:
                self.store.put_batch(pairs)
            if deferred:
                # After the seal, so the backlog never undercounts.
                complete_many(deferred)

        def on_parked(idx: int) -> None:
            # Its frame waits behind a blocked lease head or in the
            # node's admission: its CPU goes back until it runs.
            ctx = ctx_by_idx.get(idx)
            if ctx is not None:
                ctx.block()

        def on_resumed(idx: int) -> None:
            ctx = ctx_by_idx.get(idx)
            if ctx is not None:
                ctx.unblock(force=True)

        started_idx: set[int] = set()
        transport_exc: BaseException | None = None
        if perf.PERF_ON:
            for spec in spec_by_idx.values():
                if spec.dispatch_ts:
                    perf.record_stage("dispatch_rpc",
                                      max(0.0, t_send - spec.dispatch_ts))
        if entries:
            try:
                _, fused_stats = handle.execute_batch(
                    entries, on_results, on_parked, on_resumed,
                    client_addr, on_started=started_idx.add)
                if fused_stats.get("fused") \
                        or fused_stats.get("fused_fallbacks"):
                    with self._counter_lock:
                        if fused_stats.get("fused"):
                            self._fused_runs += 1
                            self._fused_tasks += int(fused_stats["fused"])
                        self._fused_fallbacks += int(
                            fused_stats.get("fused_fallbacks", 0))
            except (RpcError, RpcMethodError, OSError) as exc:
                transport_exc = exc
        if spec_by_idx:
            # The stream was cut (or came back short).
            if transport_exc is not None and not handle.ping():
                self._drop_remote_node(node.node_id)
            for idx in list(spec_by_idx):
                spec = spec_by_idx[idx]
                invisible = getattr(spec, "_invisible_requeues", 0)
                if idx not in started_idx and invisible < 3:
                    spec._invisible_requeues = invisible + 1
                    with self._counter_lock:
                        self._batch_requeues += 1
                    finish_idx(idx)
                    self.dispatcher.submit(spec, self._execute_task,
                                           ref_args(spec.args, spec.kwargs))
                    continue
                err = WorkerCrashedError(
                    f"node {node.node_id.hex()[:8]} lost task {spec.name} "
                    f"mid-batch: {transport_exc}")
                self._finish_task_failure(spec, err, start)
                finish_idx(idx)
        for spec in fallback:
            try:
                self._execute_task(spec, node)
            finally:
                complete(spec)

    def execution_pipeline_stats(self) -> dict:
        """The driver's counters of the pipelined path, stage by stage
        (each daemon's are in its ``executor_stats()["pipeline"]``):
        ``submit`` the ring, ``dispatch`` the batching, ``seal`` the
        grouped seals, ``fused`` the fused runs the batch RPCs reported.
        The scheduling plane's ``sched`` group is not ported."""
        ring = self._submit_ring
        with self._counter_lock:
            fused = {"fused_runs": self._fused_runs,
                     "fused_tasks": self._fused_tasks,
                     "fused_fallbacks": self._fused_fallbacks}
        dispatch = self.dispatcher.pipeline_stats()
        return {
            "submit": {
                "ring_submits": ring.submits if ring else 0,
                "flushes": ring.flushes if ring else 0,
                "flush_tasks": ring.flush_tasks if ring else 0,
                "ring_full_waits": ring.ring_full_waits if ring else 0,
                "buffered_cancels": ring.buffered_cancels if ring else 0,
                "flush_wall_us": self._flush_wall_us},
            "dispatch": {
                "batches": dispatch["batches_launched"],
                "batch_tasks": dispatch["batch_tasks_launched"],
                "singles": dispatch["singles_launched"],
                "batch_overcommit": dispatch["batch_overcommit"]},
            "seal": {"batch_seals": self.store.batch_seals,
                     "batch_sealed_objects":
                         self.store.batch_sealed_objects},
            "fused": fused,
        }

    def _spillback_requeue(self, spec: TaskSpec, node: NodeState) -> None:
        """The node refused the lease: queue the task again, avoiding it.
        Once every node refused, or no node outside the avoid set can
        ever hold the task (a demand or a hard affinity only the refusing
        node meets: avoiding it would park the task for good), the avoid
        set starts over after a growing delay, so a full cluster is
        polled, not hammered."""
        avoid = getattr(spec, "_avoid_nodes", None) or set()
        avoid.add(node.node_id)
        delay = 0.0
        strategy = spec.scheduling_strategy
        pinned = strategy.node_id \
            if strategy.kind == "NODE_AFFINITY" and not strategy.soft \
            else None
        elsewhere = any(
            n.alive and n.node_id not in avoid
            and n.feasible(spec.resources)
            and (pinned is None or n.node_id.hex() == pinned)
            for n in self.cluster.nodes())
        with self._remote_nodes_lock:
            if avoid >= set(self._remote_nodes) or not elsewhere:
                avoid = set()
                spec._spill_rounds = getattr(spec, "_spill_rounds", 0) + 1
                delay = min(0.05 * (2 ** min(spec._spill_rounds, 6)), 2.0)
        spec._avoid_nodes = avoid

        def requeue():
            self.dispatcher.submit(spec, self._execute_task,
                                   ref_args(spec.args, spec.kwargs))

        if delay > 0:
            timer = threading.Timer(delay, requeue)
            timer.daemon = True
            timer.start()
        else:
            requeue()

    def _relocate_actor_lease(self, actor_id: ActorID,
                              resources: dict[str, float],
                              exclude: set | None = None,
                              timeout: float = 300.0):
        """Move a remote actor's lease to a worker node: give back the
        one it has, take one elsewhere. (node id, handle), "pg_dead"
        when its placement-group bundle's node is gone, or None when no
        node can host it within ``timeout``."""
        lease = self._actor_leases.pop(actor_id, None)
        if lease is not None:
            self._release_lease(*lease)
            bundle = lease[2]
            if bundle is not None:
                # A group's actor is recreated in its bundle or nowhere.
                try:
                    node_id, shares = \
                        self.placement_groups.acquire_from_bundle(
                            *bundle, resources)
                except PlacementGroupError:
                    return "pg_dead"
                with self._remote_nodes_lock:
                    handle = self._remote_nodes.get(node_id)
                if handle is None or (exclude and node_id in exclude):
                    self.placement_groups.release_to_bundle(
                        *bundle, resources, shares)
                    return "pg_dead"
                self._actor_leases[actor_id] = (node_id, resources, bundle,
                                                shares)
                return node_id, handle
        deadline = time.monotonic() + timeout
        exclude = set(exclude or ())
        while True:
            with self._remote_nodes_lock:
                remote_ids = set(self._remote_nodes)
            local_ids = {n.node_id for n in self.cluster.nodes()
                         if n.node_id not in remote_ids}
            node = self.cluster.pick_node(resources, SchedulingStrategy(),
                                          exclude=local_ids | exclude)
            shares = None if node is None else self.cluster.try_acquire(
                node.node_id, resources)
            if shares is not None:
                with self._remote_nodes_lock:
                    handle = self._remote_nodes.get(node.node_id)
                if handle is None:  # dropped between pick and acquire
                    self.cluster.release(node.node_id, resources, shares)
                else:
                    self._actor_leases[actor_id] = (node.node_id, resources,
                                                    None, shares)
                    return node.node_id, handle
            if time.monotonic() > deadline:
                return None
            self.cluster.wait_for_change(0.1)

    def _record_actor_placement(self, actor) -> None:
        """The actor table's placement columns: its node and process."""
        record = self.gcs.get_actor(actor.actor_id)
        if record is None:
            return
        node_id = getattr(actor, "node_id", None)
        if node_id is None:
            lease = self._actor_leases.get(actor.actor_id)
            node_id = lease[0] if lease is not None else self.head_node_id
        record.node_id_hex = node_id.hex() if node_id is not None else ""
        if isinstance(actor, LocalActor):
            record.pid = os.getpid()
        else:
            worker = getattr(actor, "_worker", None)
            record.pid = getattr(actor, "pid", None) or (
                worker.proc.pid if worker is not None else None)
        record.num_restarts = getattr(actor, "num_restarts", 0)
        with self._mirror_lock:
            self._actor_dirty.add(actor.actor_id)

    def _stop_connected_mode(self) -> None:
        if self.gcs_client is None:
            return
        self._watcher_stop.set()
        if self._node_watcher is not None:
            self._node_watcher.join(timeout=10.0)
        try:
            self._flush_remote_frees()
        except Exception:  # noqa: BLE001 — best-effort at shutdown
            pass
        with self._remote_nodes_lock:
            handles = list(self._remote_nodes.values())
            self._remote_nodes.clear()
        for handle in handles:
            handle.close()
        if self._node_agent is not None:
            self._node_agent.stop(drain=True)
        if self._obj_server is not None:
            self._obj_server.stop()
        # The export twins: the leases die with the runtime, and the
        # segments are unlinked here or they outlive it in /dev/shm.
        self._export_leases.clear()
        with self._export_lock:
            export_ids = list(self._export_segments)
            export_segs = list(self._export_segments.values())
            self._export_segments.clear()
            self._export_sources.clear()
        if export_ids:
            self._export_store.free(export_ids)
        for seg in export_segs:
            _unlink_export_segment(seg)
        if self._export_spill_mgr is not None:
            self._export_spill_mgr.stop()
        self.gcs_client.close()

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
        backlog over ``admission_max_queue_depth`` (0: no cap), or host
        memory over ``admission_memory_watermark`` (0: off). With the
        spill tier armed, memory the store's spill can relieve kicks the
        spiller and admits, unless its disk is full."""
        cap = int(GLOBAL_CONFIG.admission_max_queue_depth or 0)
        if cap > 0 and self.dispatcher.pending_count() > cap:
            return f"dispatcher backlog over admission_max_queue_depth={cap}"
        watermark = float(GLOBAL_CONFIG.admission_memory_watermark or 0)
        if watermark <= 0:
            return None
        from ray_tpu_torch._private.memory_monitor import (
            memory_pressure_kind,
            memory_watermark_exceeded,
        )

        mgr = self.store._spill
        if mgr is None:
            if memory_watermark_exceeded(watermark):
                return (f"host memory over admission_memory_watermark"
                        f"={watermark}")
            return None
        kind = memory_pressure_kind(watermark)
        if kind == "store":
            if mgr.backing_off():
                return (f"store memory over admission_memory_watermark"
                        f"={watermark} and the spill disk is full "
                        f"(backing off)")
            mgr.request_spill()
            return None
        if kind == "host":
            return f"host memory over admission_memory_watermark={watermark}"
        return None

    def stats(self) -> dict:
        """Driver-side counters: tasks sealed at their deadline, submits
        shed at admission, the dispatcher's depth and the objects rebuilt
        from lineage."""
        with self._counter_lock:
            return {"task_timeouts": self._task_timeouts,
                    "admission_shed": self._admission_shed,
                    "queue_depth": self.dispatcher.pending_count(),
                    "lineage_rebuilds": self.recovery.num_recoveries}

    def _head_call(self, max_age_s: float, method: str, kind: type,
                   **kwargs):
        """A head stat for /metrics: the cached value while younger than
        ``max_age_s``, else a fresh call (the last value when the head
        does not answer or answers with another type). None without a
        head."""
        if self.gcs_client is None:
            return None
        key = (method, tuple(sorted(kwargs.items())))
        fetched_at, cached = self._head_stats.get(key, (0.0, None))
        now = time.monotonic()
        if cached is not None and now - fetched_at < max_age_s:
            return cached
        try:
            value = self.gcs_client.call(method, timeout_s=2.0, **kwargs)
        except Exception:  # noqa: BLE001 — unreachable: the last value
            return cached
        if not isinstance(value, kind):
            return cached
        self._head_stats[key] = (now, value)
        return value

    def gcs_persist_stats(self) -> dict | None:
        """The head's persistence counters and epoch (5 s cache)."""
        return self._head_call(5.0, "gcs_persist_stats", dict)

    def gcs_shard_stats(self) -> list | None:
        """One row per shard of a sharded head, [] for an unsharded one
        (5 s cache)."""
        return self._head_call(5.0, "gcs_shard_stats", list)

    def metrics_history(self, window_s: float | None = None,
                        node: str | None = None) -> dict | None:
        """The head's per-node history over the window (1 s cache)."""
        return self._head_call(1.0, "metrics_history", dict,
                               window_s=window_s, node=node)

    def cluster_health(self) -> dict | None:
        """The head watchdog's verdicts (1 s cache)."""
        return self._head_call(1.0, "cluster_health", dict)

    def fault_stats(self) -> dict:
        """This driver's failure counters, in the shape of a daemon's
        ``executor_stats()["faults"]``: how often each recovery path
        fired in this process."""
        from ray_tpu_torch._private.rpc import breaker_stats, rpc_retry_count

        with self._counter_lock:
            task_timeouts = self._task_timeouts
            admission_shed = self._admission_shed
        return {"rpc_retries": rpc_retry_count(),
                "peer_blacklists": 0,  # a driver pulls whole blobs
                "lease_orphans_swept": self._export_leases.expired,
                "lineage_rebuilds": self.recovery.num_recoveries,
                "task_timeouts": task_timeouts,
                "admission_shed": admission_shed,
                "breaker_open": breaker_stats()["opens"]}

    # ---------------------------------------------------------------- tasks

    _ARG_PIN_GRACE_S = 10.0

    def _pin_nested_arg_refs(self, args, kwargs) -> None:
        """Hold the refs nested in a call's arguments (in lists, tuples
        and dicts) for a grace period. The callee is not handed their
        values: it registers as their borrower when it unpickles them,
        and that registration is asynchronous, so a caller that drops
        its own handle right after the submit would free the object
        before the borrow lands. Refs inside custom objects are caught
        where the arguments are pickled for a node
        (``_convert_remote_args``); until then the queued arguments keep
        them alive."""
        refs: list = []

        def walk(v, depth: int) -> None:
            if isinstance(v, ObjectRef):
                refs.append(v)
            elif depth < 8 and type(v) in (list, tuple):
                for x in v:
                    walk(x, depth + 1)
            elif depth < 8 and type(v) is dict:
                for x in v.values():
                    walk(x, depth + 1)

        # A top-level ref is resolved before the call runs: only what is
        # inside an argument is borrowed.
        for v in (*args, *kwargs.values()):
            if type(v) in (list, tuple, dict):
                walk(v, 1)
        if refs:
            self._arg_pin_pen.append(
                (time.monotonic() + self._ARG_PIN_GRACE_S, refs))

    def _sweep_arg_pins(self) -> None:
        now = time.monotonic()
        while self._arg_pin_pen and self._arg_pin_pen[0][0] <= now:
            try:
                self._arg_pin_pen.popleft()
            except IndexError:
                break

    def _arg_pin_sweeper(self) -> None:
        from ray_tpu_torch._private.node_executor import _probe_peer
        from ray_tpu_torch._private.same_host import (
            pin_ttl_s,
            sweep_orphan_shm,
        )

        while not self._watcher_stop.wait(1.0):
            self._sweep_arg_pins()
            # The export map leases: a lease past the TTL whose daemon
            # stopped answering ends, so a killed daemon cannot pin this
            # driver's segments forever.
            now = time.monotonic()
            if now - self._lease_sweep_at >= 5.0:
                self._lease_sweep_at = now
                try:
                    self._export_leases.sweep(pin_ttl_s(), _probe_peer)
                except Exception:  # noqa: BLE001 — the sweep is best-effort
                    pass
                # The arenas of co-hosted owners killed without a
                # destroy have no other unlinker.
                try:
                    sweep_orphan_shm()
                except Exception:  # noqa: BLE001 — the sweep is best-effort
                    pass

    def submit_task(self, func, args: tuple, kwargs: dict, *, name: str,
                    num_returns: int = 1, resources: dict[str, float],
                    max_retries: int = 0,
                    retry_exceptions: bool | list = False,
                    scheduling_strategy: SchedulingStrategy | None = None,
                    runtime_env: dict | None = None,
                    deadline_s: float | None = None) -> list[ObjectRef]:
        """Queue one task; its refs come back at once. ``runtime_env``
        applies in a pool worker (a task on a thread ignores it).
        ``deadline_s`` arms an end-to-end budget checked at every stage.

        With the submit ring (``submit_pipeline``, the default) this only
        makes the ids and pushes a record: the ring's flush does the
        record-keeping, and a deadline-armed submit over the admission
        cap is sealed with ``SystemOverloadedError`` there. Without it
        (``_submit_task_inline``) such a submit raises at once."""
        from ray_tpu_torch._private.worker_pool import validate_runtime_env

        validate_runtime_env(runtime_env)
        deadline = self._absolute_deadline(deadline_s)
        ring = self._submit_ring
        if ring is None:
            return self._submit_task_inline(
                func, args, kwargs, name=name, num_returns=num_returns,
                resources=resources, max_retries=max_retries,
                retry_exceptions=retry_exceptions,
                scheduling_strategy=scheduling_strategy,
                runtime_env=runtime_env, deadline=deadline)
        rec = _SubmitRecord()
        rec.func = func
        rec.args = args
        rec.kwargs = kwargs
        rec.name = name
        rec.num_returns = num_returns
        rec.resources = resources
        rec.max_retries = max_retries
        rec.retry_exceptions = retry_exceptions
        rec.strategy = scheduling_strategy or SchedulingStrategy()
        rec.runtime_env = runtime_env
        rec.task_id = TaskID()
        rec.return_ids = [ObjectID() for _ in range(num_returns)]
        rec.cancelled = False
        rec.deadline = deadline
        rec.state = _SubmitRecord.BUFFERED
        # The performance plane's submit stamp is the .remote() call's,
        # so submit_dispatch counts the ring's wait too.
        rec.submit_ts = time.time() if perf.PERF_ON else 0.0
        add_ref = self.reference_counter.add_ref
        refs = []
        for rid in rec.return_ids:
            ref = ObjectRef(rid, _register=False)
            add_ref(rid)
            ref._registered = True
            refs.append(ref)
        ring.push(rec)
        return refs

    def _submit_task_inline(self, func, args: tuple, kwargs: dict, *,
                            name: str, num_returns: int,
                            resources: dict[str, float], max_retries: int,
                            retry_exceptions: bool | list,
                            scheduling_strategy: SchedulingStrategy | None,
                            runtime_env: dict | None,
                            deadline: float | None) -> list[ObjectRef]:
        """The per-task submit (``submit_pipeline`` off): a
        deadline-armed submit over the admission cap raises
        ``SystemOverloadedError`` instead of queueing (its budget would
        die in the backlog)."""
        if deadline is not None:
            reason = self._admission_overload_reason()
            if reason is not None:
                with self._counter_lock:
                    self._admission_shed += 1
                raise SystemOverloadedError(reason)
        self._pin_nested_arg_refs(args, kwargs)
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
        self.lineage.record(spec)
        self.gcs.record_task_event(TaskEvent(spec.task_id, name, "PENDING"))
        self.dispatcher.submit(spec, self._execute_task,
                               ref_args(args, kwargs))
        return refs

    def _seal_cancelled_submit(self, rec: _SubmitRecord) -> None:
        """A buffered submit was cancelled before any dispatch: seal the
        cancellation onto its refs (``put_error`` makes their entries)."""
        err = TaskCancelledError(rec.task_id)
        for rid in rec.return_ids:
            self.store.put_error(rid, err)
        self.gcs.record_task_event(TaskEvent(
            rec.task_id, rec.name, "FAILED", error="cancelled"))

    def _cancel_registered(self, object_id: ObjectID) -> None:
        """Cancel a task the dispatcher holds and not yet started."""
        spec = self.dispatcher.cancel_by_return_id(object_id)
        if spec is None:
            return
        err = TaskCancelledError(spec.task_id)
        for rid in spec.return_ids:
            self.store.put_error(rid, err)
        self.gcs.record_task_event(TaskEvent(
            spec.task_id, spec.name, "FAILED", error="cancelled"))

    def _seal_overloaded(self, rec: _SubmitRecord, reason: str) -> None:
        """Shed a deadline-armed submit at the flush: its refs get the
        retryable SystemOverloadedError."""
        err = SystemOverloadedError(reason)
        for rid in rec.return_ids:
            self.store.put_error(rid, err)
        with self._counter_lock:
            self._admission_shed += 1
        self.gcs.record_task_event(TaskEvent(
            rec.task_id, rec.name, "FAILED", end_time=time.time(),
            error=f"shed: {reason}"))

    def _flush_submits(self, ring: _SubmitRing, records: list) -> None:
        """One flush of the submit ring: the TaskSpecs, then one
        ``create_pending_batch``, one ``lineage.record_many`` and one
        ``dispatcher.submit_many`` for the whole flush. ``ring`` comes
        in as an argument: shutdown detaches the runtime's ring before
        its last flush."""
        t0 = time.perf_counter()
        live: list = []
        with ring._cond:
            for rec in records:
                if rec.cancelled:
                    # Sealed by ring.cancel() while BUFFERED.
                    for rid in rec.return_ids:
                        ring._by_rid.pop(rid, None)
                    continue
                rec.state = _SubmitRecord.DRAINING
                live.append(rec)
        if not live:
            return
        # Admission at the flush: over the cap, a deadline-armed record is
        # shed (its budget would die in the backlog) and the others wait
        # here, which backs the ring up into .remote() (bounded
        # blocking, never loss).
        overload = self._admission_overload_reason()
        if overload is not None:
            armed = [rec for rec in live if rec.deadline is not None]
            for rec in armed:
                self._seal_overloaded(rec, overload)
            if armed:
                live = [rec for rec in live if rec.deadline is None]
                with ring._cond:
                    for rec in armed:
                        rec.state = _SubmitRecord.SUBMITTED
                        for rid in rec.return_ids:
                            ring._by_rid.pop(rid, None)
            while live and self._admission_overload_reason() is not None:
                if ring._stop:
                    break  # the last flush must not wedge
                time.sleep(0.02)
        now = time.time()
        specs: list = []
        failed: list = []
        expired: list = []
        for rec in live:
            if rec.deadline is not None and now > rec.deadline:
                expired.append(rec)  # its budget died in the ring
                continue
            try:
                self._pin_nested_arg_refs(rec.args, rec.kwargs)
                spec = TaskSpec(
                    task_id=rec.task_id, name=rec.name, func=rec.func,
                    args=rec.args, kwargs=rec.kwargs,
                    num_returns=rec.num_returns, resources=rec.resources,
                    max_retries=rec.max_retries,
                    retry_exceptions=rec.retry_exceptions,
                    scheduling_strategy=rec.strategy,
                    return_ids=rec.return_ids, deadline=rec.deadline,
                    runtime_env=rec.runtime_env, submit_ts=rec.submit_ts)
            except BaseException as exc:  # noqa: BLE001 — sealed on its refs
                failed.append((rec, exc))
                continue
            specs.append(spec)
        # Every pending entry exists before any task of the flush reaches
        # the dispatcher, so dependencies within a flush gate right.
        self.store.create_pending_batch(
            [rid for spec in specs for rid in spec.return_ids])
        self.lineage.record_many(specs)
        for spec in specs:
            self.gcs.record_task_event(TaskEvent(spec.task_id, spec.name,
                                                 "PENDING"))
        # A placement-group task goes through the same queue: the
        # dispatcher admits it to its bundle.
        if specs:
            self.dispatcher.submit_many(
                [(spec, self._execute_task, ref_args(spec.args, spec.kwargs))
                 for spec in specs])
        for rec, exc in failed:
            for rid in rec.return_ids:
                self.store.put_error(rid, exc)
            self.gcs.record_task_event(TaskEvent(
                rec.task_id, rec.name, "FAILED", error=str(exc)))
        for rec in expired:
            self._seal_deadline(rec, "submit")
        # Handed over: a cancel from here on goes to the dispatcher, and
        # one that came while the record was DRAINING is replayed now.
        post_cancel: list = []
        with ring._cond:
            for rec in live:
                rec.state = _SubmitRecord.SUBMITTED
                for rid in rec.return_ids:
                    ring._by_rid.pop(rid, None)
                if rec.cancelled:
                    post_cancel.append(rec)
        for rec in post_cancel:
            if rec.return_ids:
                self._cancel_registered(rec.return_ids[0])
        self._flush_wall_us += int((time.perf_counter() - t0) * 1e6)

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
        with self._remote_nodes_lock:
            remote_handle = self._remote_nodes.get(node.node_id)
        try:
            if remote_handle is not None:
                from ray_tpu_torch._private.node_executor import (
                    NodeBusyError,
                    NodeOverloadedError,
                    TaskDeadlineExpired,
                )

                try:
                    self._execute_remote(spec, node, remote_handle)
                except NodeBusyError:
                    self._spillback_requeue(spec, node)
                    return
                except TaskDeadlineExpired:
                    self._seal_deadline(spec, "admitted")
                    return
                except NodeOverloadedError as exc:
                    self._shed_remote(spec, node, str(exc), start)
                    return
                self.gcs.record_task_event(TaskEvent(
                    spec.task_id, spec.name, "FINISHED",
                    start_time=start, end_time=time.time(),
                    node_id=node.node_id.hex()))
                return
            # A task that asks for GPU stays on a thread of this process,
            # as the reference's TPU tasks do.
            if self.worker_pool is None or "GPU" in spec.resources \
                    or not self._try_execute_on_pool(spec, node, bundled):
                _use_cards(spec.gpu_shares)
                args, kwargs, _ = resolve_args(
                    spec.args, spec.kwargs, lambda ref: self.get([ref])[0])
                sample = perf.sample_start() if perf.PERF_ON else None
                with BlockedResourceContext(
                        self.cluster, node.node_id,
                        {} if bundled else spec.resources):
                    result = spec.func(*args, **kwargs)
                if sample is not None:
                    s = perf.sample_end(spec.name, sample)
                    perf.record_task_resources(*s)
                    perf.record_stage("exec_local", s[1])
                self._store_task_result(spec, result)
            for rid in spec.return_ids:
                self._record_location(rid, node.node_id)
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
        # cancellation, an argument lost for good, its worker's death)
        # passes through unwrapped.
        error = exc if isinstance(
            exc, (TaskError, TaskCancelledError, ObjectLostError,
                  WorkerCrashedError)) \
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
        ``retry_exceptions`` allows. A worker the memory monitor killed
        retries on the ``task_oom_retries`` budget (the task did nothing
        wrong)."""
        monitor = self.memory_monitor
        oom_kill = (isinstance(exc, WorkerCrashedError)
                    and monitor is not None
                    and exc.worker_pid in monitor.killed_pids)
        oom_budget = int(GLOBAL_CONFIG.task_oom_retries)
        if oom_kill and spec.attempt + 1 >= oom_budget:
            # The last OOM attempt: a recycled pid must not pass for one.
            monitor.consume_attribution(exc.worker_pid)
        budget = max(spec.max_retries, oom_budget) if oom_kill \
            else spec.max_retries
        if spec.attempt >= budget:
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
            default_deadline_s=float(deadline_s or 0.0),
            max_restarts=max_restarts)
        try:
            self.gcs.register_actor(record)
            # Published before .remote() returns, so another driver
            # resolves the name at once (its calls queue until the actor
            # is up); every death path withdraws it.
            if name is not None:
                self._publish_named_actor(record)
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
        # An actor can live on a node daemon only if its class and its
        # arguments cross a process boundary; a zero-resource DEFAULT
        # actor stays here (it may close over this process's state).
        with self._remote_nodes_lock:
            remote_ids = set(self._remote_nodes)
        keep_local = bool(remote_ids) and (
            (strategy.kind == "DEFAULT" and not any(resources.values()))
            or not self._remotable(cls, args, kwargs))

        def start_actor():
            try:
                lease = self._lease_actor_resources(
                    cls.__name__, resources, strategy, record,
                    exclude=remote_ids if keep_local else None)
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
                if record.state == "DEAD" or self._shut_down:
                    # Killed (or the runtime shut down) before it was
                    # built.
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
                with self._remote_nodes_lock:
                    remote_handle = None if node_id is None \
                        else self._remote_nodes.get(node_id)
                if remote_handle is not None:
                    from ray_tpu_torch._private.remote_actor import (
                        RemoteActor,
                    )

                    def on_restart(aid):
                        self._record_actor_placement(self._actors[aid])
                        self.gcs.update_actor_state(aid, "ALIVE")

                    actor = RemoteActor(
                        actor_id, cls, args, kwargs, self,
                        node_id=node_id, handle=remote_handle,
                        resources=resources, max_restarts=max_restarts,
                        max_pending_calls=max_pending_calls,
                        max_concurrency=max_concurrency,
                        creation_return_id=creation_rid,
                        on_death=self._mark_actor_dead,
                        on_release=self._release_actor_lease,
                        on_restart=on_restart,
                        runtime_env=self._package_runtime_env(runtime_env))
                elif process:
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
                # Recorded before the actor is published: no call's result
                # is seen before the table has its placement.
                self._record_actor_placement(actor)
                self._actors[actor_id] = actor
                self._actors_changed.notify_all()

        threading.Thread(target=start_actor, daemon=True,
                         name=f"ray_tpu_torch-actor-create-"
                              f"{cls.__name__}").start()
        return actor_id, creation_ref

    def _lease_actor_resources(self, name: str, resources: dict, strategy,
                               record: ActorRecord,
                               exclude: set | None = None) -> tuple | None:
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
                node = self.cluster.pick_node(resources, strategy,
                                              exclude=exclude)
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

    def _remotable(self, cls: type, args: tuple, kwargs: dict) -> bool:
        """Whether the class and its arguments can leave this process."""
        from ray_tpu_torch._private import serialization

        try:
            self._function_blob(cls)
            if args or kwargs:
                serialization.serialize_framed((
                    tuple(None if isinstance(a, ObjectRef) else a
                          for a in args),
                    {k: None if isinstance(v, ObjectRef) else v
                     for k, v in kwargs.items()}))
            return True
        except Exception:  # noqa: BLE001 — not picklable
            return False

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
        """Dead for good: a creation that failed, a constructor that
        raised, a death with no restart left, a kill or the shutdown."""
        self.gcs.update_actor_state(actor_id, "DEAD", reason)
        record = self.gcs.get_actor(actor_id)
        if record is not None and record.name is not None:
            self._unpublish_named_actor(record.namespace, record.name)
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
        self._pin_nested_arg_refs(args, kwargs)
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
            if getattr(actor, "resolves_refs", False):
                # The refs stay (they travel as location hints); a failed
                # argument still fails the call.
                for ref in ref_args(call.args, call.kwargs):
                    self.store.get(ref.id())
            elif getattr(actor, "takes_shm_args", False):
                self._shm_actor_args(call)
            else:
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
        """This driver's named actor, else the head's actor directory's:
        a ``ForeignActorHandle`` to the driver that owns it (a local
        handle when that driver is this one)."""
        import pickle

        from ray_tpu_torch.actor import ActorHandle, ForeignActorHandle

        ns = namespace or self.namespace
        record = self.gcs.get_named_actor(name, ns)
        if record is not None:
            return ActorHandle(record.actor_id, record.class_name)
        if self.gcs_client is not None:
            try:
                blob = self.gcs_client.call(
                    "kv_get", f"{ns}/{name}".encode(), "named_actors",
                    timeout_s=10.0)
            except Exception:  # noqa: BLE001 — the head is unreachable
                blob = None
            if blob is not None:
                info = pickle.loads(blob)
                if info["owner_addr"] == self._client_server_addr():
                    return ActorHandle(
                        ActorID(bytes.fromhex(info["actor_key"])),
                        info["class_name"])
                return ForeignActorHandle(
                    info["owner_addr"], info["actor_key"],
                    info["class_name"],
                    method_meta=info.get("method_meta", {}))
        raise ValueError(f"Failed to look up actor with name {name!r}")

    def _publish_named_actor(self, record: ActorRecord) -> None:
        """Enter a named actor in the head's directory (its KV namespace
        ``named_actors``, written to the WAL): the address of this
        driver's client server, which other drivers' calls go to."""
        if self.gcs_client is None:
            return
        import pickle

        self.ensure_client_server()
        entry = pickle.dumps({
            "actor_key": record.actor_id.hex(),
            "class_name": record.class_name,
            "owner_addr": self._client_server_addr(),
            # Per-method defaults (num_returns), so a foreign handle's
            # calls return what a local handle's would.
            "method_meta": dict(record.method_meta),
        })
        try:
            self.gcs_client.call(
                "kv_put", f"{record.namespace}/{record.name}".encode(),
                entry, "named_actors", timeout_s=10.0)
            self._published_names.add((record.namespace, record.name))
        except Exception:  # noqa: BLE001 — the directory is best effort
            logger.warning("failed to publish named actor %s", record.name)

    def _unpublish_named_actor(self, namespace: str, name: str) -> None:
        if self.gcs_client is None:
            return
        self._published_names.discard((namespace, name))
        try:
            self.gcs_client.call("kv_del", f"{namespace}/{name}".encode(),
                                 "named_actors", timeout_s=10.0)
        except Exception:  # noqa: BLE001 — the directory is best effort
            pass

    def submit_foreign_actor_task(self, owner_addr: str, actor_key: str,
                                  method_name: str, args: tuple,
                                  kwargs: dict, num_returns: int = 1
                                  ) -> list[ObjectRef]:
        """Call an actor another driver owns: the handle's ordered proxy
        drives that driver's client server and seals the results into
        this store as they arrive."""
        return_ids = [ObjectID() for _ in range(max(1, num_returns))]
        for rid in return_ids:
            self.store.create_pending(rid)
        refs = [ObjectRef(rid) for rid in return_ids]
        key = (owner_addr, actor_key)
        with self._futures_lock:
            proxy = self._foreign_proxies.get(key)
            if proxy is None:
                proxy = _ForeignActorProxy(self, owner_addr, actor_key)
                self._foreign_proxies[key] = proxy
        proxy.submit(method_name, args, kwargs, return_ids)
        return refs

    def kill_foreign_actor(self, owner_addr: str, actor_key: str) -> None:
        """Kill an actor another driver owns, in that driver."""
        from ray_tpu_torch._private.rpc import RpcClient

        client = RpcClient(owner_addr, timeout_s=30.0)
        try:
            client.call("client_kill_actor", actor_key)
        finally:
            client.close()

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
                results.append(self._materialize_value(
                    ref.id(), self.store.get(ref.id())))
                continue
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if block_ctx is not None:
                block_ctx.block()
            try:
                value = self.store.get(ref.id(), timeout=remaining)
            finally:
                if block_ctx is not None:
                    block_ctx.unblock()
            results.append(self._materialize_value(ref.id(), value))
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
        running thread cannot be stopped and completes normally. A
        submit still in the ring is the ring's to cancel (a buffered one
        seals at once, a draining one when its flush ends)."""
        ring = self._submit_ring
        if ring is not None and ring.cancel(ref.id()) is not None:
            return
        self._cancel_registered(ref.id())

    def free(self, refs: Sequence[ObjectRef]) -> None:
        self.store.free([r.id() for r in refs])
        for r in refs:
            self._forget_object(r.id())

    def attach_future(self, ref: ObjectRef,
                      fut: concurrent.futures.Future) -> None:
        ring = self._submit_ring
        with self._futures_lock:
            # A submit still in the ring has no store entry yet, but is
            # pending: its flush makes the entry, and the seal resolves
            # the future.
            if self.store.is_pending(ref.id()) or (
                    ring is not None and not self.store.contains(ref.id())
                    and ring.holds(ref.id())):
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
            fut.set_result(self._materialize_value(
                object_id, self.store.get(object_id, timeout=0)))
        except Exception as exc:  # noqa: BLE001 — the future carries it
            fut.set_exception(exc)

    def cluster_resources(self) -> dict[str, float]:
        return self.cluster.total_resources()

    def available_resources(self) -> dict[str, float]:
        return self.cluster.available_resources()

    def shutdown(self) -> None:
        if self._submit_ring is not None:
            # Flush what is buffered (its owners may hold refs) and stop
            # the submitter before the dispatcher stops.
            ring, self._submit_ring = self._submit_ring, None
            ring.stop()
        if self.metrics_agent is not None:
            self.metrics_agent.shutdown()
            self.metrics_agent = None
        with self._actors_changed:
            # An actor still being built sees this and is not started.
            self._shut_down = True
            actors = list(self._actors.values())
        for actor in actors:
            actor.kill("runtime shutdown", no_restart=True)
        for submit_queue in list(self._actor_queues.values()):
            submit_queue.put(None)
        with self._futures_lock:
            proxies = list(self._foreign_proxies.values())
            self._foreign_proxies.clear()
        for proxy in proxies:
            proxy.close()
        # Withdrawn while the head connection is still open: an entry
        # left behind would name a driver that is gone.
        for namespace, name in list(self._published_names):
            self._unpublish_named_actor(namespace, name)
        self.placement_groups.shutdown()
        self.health_monitor.shutdown()
        self.dispatcher.shutdown()
        self._watcher_stop.set()
        self._arg_pin_thread.join(timeout=5.0)
        self._arg_pin_pen.clear()
        self._stop_connected_mode()
        self._stop_process_plane()
        self.reference_counter.stop()
        self._stop_spill_tier()
        # The runtime's parts refer to each other; dropping the objects
        # (and the lineage's task specs) here frees what they hold
        # (tensors on the card) at once.
        self.store.close()
        self.lineage.clear()
        self.gcs.finish_job(self.job_id)

    def _stop_spill_tier(self) -> None:
        """Stop the spiller; the last manager of the process removes the
        per-pid spill directory."""
        import shutil

        from ray_tpu_torch._private import memory_monitor, spill_manager

        if self.store._spill is None:
            return
        self.store._spill.stop()
        memory_monitor.set_store_bytes_provider(None)
        if spill_manager.live_manager_count() == 0:
            shutil.rmtree(spill_manager.process_spill_dir(),
                          ignore_errors=True)

    def _stop_process_plane(self) -> None:
        from ray_tpu_torch._private import worker_pool as pool_mod

        if self.memory_monitor is not None:
            self.memory_monitor.stop()
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
        if self.arena is not None:
            self.arena.close()  # the owner's: unmapped and unlinked
            self.arena = None


def _unlink_export_segment(seg) -> None:
    """Unlink and close an export's segment. A chunk read in flight (or
    the export store's view) may still use the mapping: then it stays
    mapped until the process exits."""
    from ray_tpu_torch._private.shm_store import _defuse

    try:
        seg.unlink()
    except OSError:
        pass  # already unlinked
    try:
        seg.close()
    except (BufferError, OSError):
        _defuse(seg)


class _ForeignActorProxy:
    """The ordered call pipe to one actor of another driver: a drain
    thread makes each call (``client_actor_call``), long-polls its
    results (``client_get``) into this store and releases them on the
    owner before it sends the next call."""

    def __init__(self, runtime: Runtime, owner_addr: str, actor_key: str):
        from ray_tpu_torch._private.rpc import RpcClient

        self._runtime = runtime
        self._actor_key = actor_key
        self._owner_addr = owner_addr
        self._rpc = RpcClient(owner_addr, timeout_s=60.0)
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._drain, daemon=True,
            name=f"ray_tpu_torch-foreign-actor-{actor_key[:8]}")
        self._thread.start()

    def submit(self, method_name: str, args: tuple, kwargs: dict,
               return_ids: list[ObjectID]) -> None:
        self._queue.put((method_name, args, kwargs, return_ids))

    def close(self) -> None:
        self._queue.put(None)
        self._rpc.close()

    def _fail(self, return_ids, exc: BaseException) -> None:
        for rid in return_ids:
            self._runtime.store.put_error(rid, exc)

    def _drain(self) -> None:
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.rpc import RpcError, RpcMethodError

        while True:
            item = self._queue.get()
            if item is None:
                return
            method_name, args, kwargs, return_ids = item
            sealed: set = set()
            try:
                # The owner cannot read this store: refs go as values.
                args, kwargs, _ = resolve_args(
                    args, kwargs, lambda r: self._runtime.get([r])[0])
                blob = serialization.serialize_framed((args, kwargs))
                keys = self._rpc.call(
                    "client_actor_call", self._actor_key, method_name,
                    blob, len(return_ids))
                if len(keys) != len(return_ids):
                    raise ValueError(
                        f"{method_name} returned {len(keys)} values but "
                        f"the handle expected {len(return_ids)} (declare "
                        f"num_returns via .options or @method)")
                for key, rid in zip(keys, return_ids):
                    while True:
                        status, vblob = self._rpc.call(
                            "client_get", [key], 10.0)
                        if status == "ok":
                            value = serialization.deserialize_from_buffer(
                                memoryview(vblob))[0]
                            self._runtime.store.put(rid, value)
                            sealed.add(rid)
                            break
                try:
                    self._rpc.call("client_release", keys)
                except (RpcError, RpcMethodError):
                    pass
            except RpcMethodError as exc:
                # The owner's own error (the method's, or a dead actor's).
                self._fail([r for r in return_ids if r not in sealed],
                           exc.cause)
            except (RpcError, OSError) as exc:
                # Results already delivered stay: only the returns still
                # pending become errors.
                self._fail([r for r in return_ids if r not in sealed],
                           ActorDiedError(
                               None, f"owner driver at {self._owner_addr} "
                               f"unreachable: {exc}"))
            except Exception as exc:  # noqa: BLE001 — sealed for the caller
                self._fail([r for r in return_ids if r not in sealed], exc)
            # Unbind before blocking on the queue: a stale local would
            # keep the last call's arguments alive.
            item = args = kwargs = None


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
         process_workers: int | None = None,
         address: str | None = None,
         metrics_port: int | None = None) -> Runtime:
    """Start the process's runtime. ``num_gpus`` sets the head node's
    ``GPU`` count (by default ``torch.cuda.device_count()``);
    ``process_workers`` starts that many worker processes (by default
    ``worker_pool_size``, 0); ``address`` connects to a cluster's head
    (``cluster_utils.Cluster.address``), whose worker-node daemons then
    run tasks and actors; ``metrics_port`` serves ``/metrics`` there (0:
    a free port, ``runtime.metrics_agent.port``). In a worker process the
    public API goes to the driver's runtime, and this returns its
    proxy."""
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
                           process_workers=process_workers,
                           address=address, metrics_port=metrics_port)
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
    from ray_tpu_torch.actor import ActorHandle, ForeignActorHandle

    if isinstance(actor_handle, ForeignActorHandle):
        auto_init().kill_foreign_actor(actor_handle._owner_addr,
                                       actor_handle._actor_key)
        return
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
    """This runtime's nodes and, when connected, the head's."""
    runtime = auto_init()
    out = [{"NodeID": r.node_id.hex(), "Alive": r.alive,
            "Resources": dict(r.resources), "Labels": dict(r.labels),
            "NodeManagerAddress": r.address}
           for r in runtime.gcs.list_nodes()]
    if getattr(runtime, "gcs_client", None) is not None:
        from ray_tpu_torch._private.rpc import RpcError

        try:
            for n in runtime.gcs_client.call("list_nodes"):
                out.append({"NodeID": n["node_id"], "Alive": n["alive"],
                            "Resources": n["resources"],
                            "Labels": n["labels"],
                            "NodeManagerAddress": n["address"]})
        except (RpcError, OSError):
            pass  # the head is unreachable: this runtime's view only
    return out


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

