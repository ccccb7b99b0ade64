"""Lineage-based object recovery and node health checks.

The port of ``ray_tpu/_private/recovery.py``:

- ``LineageTable`` keeps the task that produced each object, bounded
  (the oldest entries lose their rebuild);
- ``ObjectRecoveryManager`` re-runs that task when the object is lost,
  rebuilding a lost argument first;
- ``NodeHealthMonitor`` declares a node dead once its heartbeat is
  stale: a beater thread heartbeats every live virtual node (they share
  the process), ``suppress`` stops one's beat, and the checker notices
  after ``failure_threshold`` periods.

A rebuild re-runs the producing task, so a task with side effects or
unseeded randomness may rebuild a different value, as in the reference.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable

from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task import TaskSpec

logger = logging.getLogger("ray_tpu_torch")


class LineageTable:
    """object id -> the TaskSpec that produced it, bounded."""

    def __init__(self, max_entries: int = 10_000):
        # Reentrant: forget() can run from ObjectRef.__del__ while
        # record() holds the lock.
        self._lock = threading.RLock()
        self._by_object: "OrderedDict[ObjectID, TaskSpec]" = OrderedDict()
        self._max_entries = max_entries

    def record(self, spec: TaskSpec) -> None:
        self.record_many((spec,))

    def record_many(self, specs) -> None:
        """Record a batch of specs under one lock pass."""
        with self._lock:
            by_object = self._by_object
            for spec in specs:
                for rid in spec.return_ids:
                    by_object[rid] = spec
                    # A re-record (a retry, a rebuild) refreshes recency.
                    by_object.move_to_end(rid)
            while len(by_object) > self._max_entries:
                by_object.popitem(last=False)

    def lookup(self, object_id: ObjectID) -> TaskSpec | None:
        with self._lock:
            return self._by_object.get(object_id)

    def forget(self, object_ids) -> None:
        with self._lock:
            for oid in object_ids:
                self._by_object.pop(oid, None)

    def clear(self) -> None:
        with self._lock:
            self._by_object.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_object)


class ObjectRecoveryManager:
    """Rebuilds lost objects by re-running their lineage."""

    def __init__(self, runtime):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._in_flight: set[ObjectID] = set()
        self.num_recoveries = 0
        # Rebuilds of objects whose spill file tore (not a node's death).
        self.num_torn_recoveries = 0

    def recover(self, object_id: ObjectID, reason: str = "lost") -> bool:
        """Resubmit the producing task, rebuilding its lost arguments
        first. False when there is no lineage (a ``put`` object, evicted
        lineage) or the task is hard-pinned to a dead node: the caller
        fails the waiters with ObjectLostError. Idempotent while the
        rebuild is in flight. ``reason`` is "lost" (a node's death) or
        "spill_torn" (a torn spill file)."""
        runtime = self._runtime
        spec = runtime.lineage.lookup(object_id)
        if spec is None:
            return False
        strategy = spec.scheduling_strategy
        if strategy is not None and strategy.kind == "NODE_AFFINITY" \
                and not strategy.soft:
            # A hard affinity to a dead node can never be placed again.
            node = runtime.cluster.get_node(
                NodeID(bytes.fromhex(strategy.node_id)))
            if node is None or not node.alive:
                return False
        with self._lock:
            if all(rid in self._in_flight for rid in spec.return_ids):
                return True
            self._in_flight.update(spec.return_ids)
            self.num_recoveries += 1
            if reason == "spill_torn":
                self.num_torn_recoveries += 1

        from ray_tpu_torch.exceptions import ObjectLostError

        store = runtime.store
        deps = []
        unrecoverable = None
        for arg in list(spec.args) + list(spec.kwargs.values()):
            if not isinstance(arg, ObjectRef):
                continue
            deps.append(arg)
            if store.is_lost(arg.id()) and not self.recover(arg.id()):
                unrecoverable = ObjectLostError(
                    ObjectRef(arg.id(), _register=False),
                    f"object {arg.id().hex()} lost with no lineage to "
                    f"rebuild it")
                store.put_error(arg.id(), unrecoverable)
        if unrecoverable is not None:
            # The task can never produce a right value: its returns get
            # the argument's ObjectLostError instead of a doomed rerun.
            for rid in spec.return_ids:
                store.put_error(rid, unrecoverable)
            with self._lock:
                self._in_flight.difference_update(spec.return_ids)
            return True
        for rid in spec.return_ids:
            store.create_pending(rid)

        def run_and_clear(s, node, _orig=spec):
            try:
                runtime._execute_task(_orig, node)
            finally:
                with self._lock:
                    self._in_flight.difference_update(_orig.return_ids)

        runtime.dispatcher.submit(spec, run_and_clear, deps)
        return True


class NodeHealthMonitor:
    """Declares nodes dead when their heartbeat goes stale.

    The beater heartbeats every live node every half period, except the
    suppressed ones (``kill_node``); the checker calls ``on_node_dead``
    once for a node whose heartbeat did not move in ``failure_threshold``
    checks in a row, the detect-then-broadcast flow of the reference's
    health checks. Misses are counted in checks, not in seconds: a stall
    of this process (a long hold of the GIL, a loaded host) delays the
    checks as much as the beats, and is not taken for a death."""

    def __init__(self, gcs, period_s: float, failure_threshold: int,
                 on_node_dead: Callable[[NodeID], None]):
        self._gcs = gcs
        self._period = period_s
        self._threshold = failure_threshold
        self._on_node_dead = on_node_dead
        self._lock = threading.Lock()
        self._suppressed: set[NodeID] = set()
        self._reported: set[NodeID] = set()
        self._stop = threading.Event()
        self._beater = threading.Thread(
            target=self._beat_loop, name="ray_tpu_torch-heartbeat",
            daemon=True)
        self._checker = threading.Thread(
            target=self._check_loop, name="ray_tpu_torch-health-check",
            daemon=True)
        self._beater.start()
        self._checker.start()

    def suppress(self, node_id: NodeID) -> None:
        """Stop heartbeating ``node_id``: the checker declares it dead."""
        with self._lock:
            self._suppressed.add(node_id)

    def _beat_loop(self) -> None:
        while not self._stop.wait(self._period / 2):
            with self._lock:
                suppressed = set(self._suppressed)
            for record in self._gcs.list_nodes():
                if record.alive and record.node_id not in suppressed:
                    self._gcs.heartbeat(record.node_id)

    def _check_loop(self) -> None:
        # node -> (its heartbeat at the last check, checks it has not
        # moved in)
        seen: dict[NodeID, tuple[float, int]] = {}
        while not self._stop.wait(self._period):
            for record in self._gcs.list_nodes():
                if not record.alive:
                    seen.pop(record.node_id, None)
                    continue
                beat, misses = seen.get(record.node_id, (None, 0))
                misses = misses + 1 if record.last_heartbeat == beat else 0
                seen[record.node_id] = (record.last_heartbeat, misses)
                if misses < self._threshold:
                    continue
                with self._lock:
                    if record.node_id in self._reported:
                        continue
                    self._reported.add(record.node_id)
                try:
                    self._on_node_dead(record.node_id)
                except Exception:  # noqa: BLE001 — retried next period
                    logger.exception("handling the death of node %s "
                                     "failed; retrying",
                                     record.node_id.hex()[:8])
                    with self._lock:
                        self._reported.discard(record.node_id)

    def shutdown(self) -> None:
        self._stop.set()
        for thread in (self._beater, self._checker):
            if thread is not threading.current_thread():
                thread.join(timeout=10.0)
