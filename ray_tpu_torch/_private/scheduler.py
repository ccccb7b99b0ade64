"""Cluster resources and task dispatch.

The port of ``ray_tpu/_private/scheduler.py``:

- ``ClusterState``: every node's total and available resources, and the
  node a demand goes to. DEFAULT packs onto the nodes under
  ``scheduler_spread_threshold`` utilization, then takes the least
  utilized; SPREAD round-robins over the nodes it fits; NODE_AFFINITY
  takes its node (a remote node's too). A remote node's own report of
  what is free (pushed when its load changes) caps this driver's ledger
  while it is fresh, so another driver's load on a shared node counts;
- ``Dispatcher``: tasks wait for their argument objects to seal, are
  admitted when their resources fit (a placement-group task: when they
  fit in its bundle's reservation), and each admitted task runs on a
  thread of its own. Ready tasks queue by resource signature, so a task
  that cannot be admitted (a second ``num_gpus=1`` task) holds back only
  tasks of its own demand;
- ``BlockedResourceContext``: a task blocked in ``get()`` gives its CPU
  back until it wakes and keeps its GPU, so nested task graphs deeper
  than the CPU count cannot deadlock.

With batch hooks set (``set_batch_hooks``), the tasks a dispatch pass
claims for one remote node go out as one batch (one runner thread, one
``execute_task_batch`` RPC) of up to ``dispatch_batch_max``; once a batch
to a node is open, the pass keeps filling it past the node's free slots
(``force_acquire``, counted in ``batch_overcommit``), so a deep backlog
rides deep batches, and the node parks the excess in its admission.
``submit_many`` queues a whole submit-ring flush under one lock.

Locality- and load-aware placement (``LOCALITY_ON``, armed from
``locality_aware_scheduling``): the dispatcher asks its locality hook for
the bytes of a task's large arguments on each node, and ``pick_node``
gives a DEFAULT task to the node holding the most of them; otherwise the
node-stats feed (``update_node_stats``: running, queue depth and wait,
shipped on heartbeats) moves a task off the classic choice when that
choice's backlog is measurably deeper or its report went stale.
Disarmed, ``pick_node`` is the classic policy. ``sched_counters()``
counts the decisions.

Not ported: the batched acquisitions of the dispatch lanes (ROADMAP item
10c).
"""

from __future__ import annotations

import collections
import heapq
import itertools
import logging
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable

from ray_tpu_torch._private import perf_plane as perf
from ray_tpu_torch._private.accelerators import CardLedger
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.task import TaskSpec
from ray_tpu_torch.exceptions import PlacementGroupError
from ray_tpu_torch.util import tracing

logger = logging.getLogger("ray_tpu_torch")

_DISPATCH_ORDER = itertools.count(1).__next__

# Locality- and load-aware placement. Every site reads this one module
# attribute; disarmed, pick_node is the classic policy. Armed from
# locality_aware_scheduling at Runtime init and at daemon boot.
LOCALITY_ON: bool = True

# How much deeper (in queued tasks) the classic choice's backlog must be
# than another node's before the scorer moves a task: small deltas keep
# the classic placement.
_SPILL_MARGIN = 2.0


def init_sched_from_config() -> None:
    """Arm or disarm locality-aware placement from config."""
    global LOCALITY_ON
    LOCALITY_ON = bool(GLOBAL_CONFIG.locality_aware_scheduling)


init_sched_from_config()

# How long a node's own availability report stays authoritative. Reports
# go out only on change, so a lost one would otherwise pin a stale low
# mark; past the TTL admission falls back to this driver's ledger (and a
# busy node is found by spillback). Longer than the node watcher's 10 s
# resync, which refreshes the report from the head's table.
REPORTED_AVAILABILITY_TTL_S = 12.0


@dataclass
class NodeState:
    """One node's resource ledger.

    ``available`` is this driver's ledger of its own leases; ``reported``
    is the node's own last report, which also holds other drivers' load.
    Admission takes the smaller of the two, per resource, while the
    report is fresh; the report is corrected by this driver's leases
    taken or returned since it was measured (``inflight`` against
    ``reported_inflight``)."""

    node_id: NodeID
    total: dict[str, float]
    available: dict[str, float]
    labels: dict[str, str] = field(default_factory=dict)
    alive: bool = True
    # The cards behind the GPU count, and each one's free share.
    cards: CardLedger = None
    reported: dict[str, float] | None = None
    reported_at: float = 0.0
    inflight: dict[str, float] = field(default_factory=dict)
    reported_inflight: dict[str, float] = field(default_factory=dict)
    # The node's last stats report (running tasks, admission depth, the
    # p50 wait of its admit and exec stages) and when it was received
    # (monotonic; 0.0: never), for the load-aware scorer.
    stats_running: float = 0.0
    stats_depth: float = 0.0
    stats_wait_s: float = 0.0
    stats_at: float = 0.0

    def __post_init__(self):
        if self.cards is None:
            self.cards = CardLedger.for_count(self.total.get("GPU", 0.0))

    def effective_available(self, key: str) -> float:
        avail = self.available.get(key, 0.0)
        if self.reported is None or key not in self.reported \
                or time.monotonic() - self.reported_at \
                > REPORTED_AVAILABILITY_TTL_S:
            return avail
        rep = self.reported[key] + (self.reported_inflight.get(key, 0.0)
                                    - self.inflight.get(key, 0.0))
        return min(avail, rep)

    def fits(self, demand: dict[str, float]) -> bool:
        return all(self.effective_available(k) + 1e-9 >= v
                   for k, v in demand.items()) \
            and self.cards.pick(demand.get("GPU", 0.0)) is not None

    def feasible(self, demand: dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) + 1e-9 >= v
                   for k, v in demand.items())

    def acquire(self, demand: dict[str, float]) -> dict[int, float]:
        """Take ``demand`` (it fits); the card shares of its GPU."""
        shares = self.cards.pick(demand.get("GPU", 0.0))
        self.cards.take(shares)
        for key, value in demand.items():
            self.available[key] = self.available.get(key, 0.0) - value
            self.inflight[key] = self.inflight.get(key, 0.0) + value
        return shares

    def release(self, demand: dict[str, float],
                shares: dict[int, float]) -> None:
        self.cards.give(shares)
        for key, value in demand.items():
            self.available[key] = self.available.get(key, 0.0) + value
            self.inflight[key] = self.inflight.get(key, 0.0) - value

    def utilization(self) -> float:
        return max((1.0 - self.available.get(k, 0.0) / total
                    for k, total in self.total.items() if total > 0),
                   default=0.0)


class ClusterState:
    """Cluster-wide resource view and node selection."""

    def __init__(self, spread_threshold: float = 0.5):
        self._lock = threading.Condition()
        self._nodes: dict[NodeID, NodeState] = {}
        self._spread_threshold = spread_threshold
        self._rr_counter = 0
        self._infeasible_warned: set[str] = set()
        # Placement decisions (under self._lock in pick_node), read by
        # execution_pipeline_stats()["sched"] and /metrics.
        self.sched = {"locality_hits": 0, "locality_bytes_saved": 0,
                      "load_spillbacks": 0, "stale_stats_skips": 0}

    def add_node(self, node: NodeState) -> None:
        with self._lock:
            self._nodes[node.node_id] = node
            self._lock.notify_all()

    def remove_node(self, node_id: NodeID) -> None:
        """Take a dead node out of scheduling: its resources, and its
        cards, leave the cluster's totals."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.alive = False
            self._lock.notify_all()

    def revive_node(self, node_id: NodeID) -> bool:
        """Bring back a node that was dropped for a while, keeping its
        ledger: its tasks in flight still hold what they took. False for
        a node never seen (add it instead)."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return False
            node.alive = True
            self._lock.notify_all()
            return True

    def nodes(self) -> list[NodeState]:
        with self._lock:
            return [n for n in self._nodes.values() if n.alive]

    def update_reported(self, node_id: NodeID,
                        available: dict[str, float]) -> None:
        """A node's own report of what is free arrived; it wakes the
        dispatcher, as freed capacity is a chance to schedule."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.reported = dict(available)
                node.reported_at = time.monotonic()
                node.reported_inflight = dict(node.inflight)
                self._lock.notify_all()

    def _sum(self, attr: str) -> dict[str, float]:
        with self._lock:
            out: dict[str, float] = {}
            for node in self._nodes.values():
                if node.alive:
                    for k, v in getattr(node, attr).items():
                        out[k] = out.get(k, 0.0) + v
            return out

    def total_resources(self) -> dict[str, float]:
        return self._sum("total")

    def available_resources(self) -> dict[str, float]:
        return self._sum("available")

    def get_node(self, node_id: NodeID) -> NodeState | None:
        with self._lock:
            return self._nodes.get(node_id)

    def pick_node(self, demand: dict[str, float], strategy,
                  exclude: set[NodeID] | None = None,
                  locality: dict | None = None) -> NodeState | None:
        """A node the demand fits on now, by policy; None if none fits.
        DEFAULT packs onto the nodes under the spread threshold, the
        least utilized first, and past it takes the least utilized of
        all; SPREAD round-robins over the nodes it fits; NODE_AFFINITY
        takes its node (a soft one falls back to DEFAULT). While
        LOCALITY_ON, ``locality`` ({node hex: resident bytes of the
        task's large arguments}) and the node-stats feed refine a
        DEFAULT choice (``_pick_scored``)."""
        with self._lock:
            candidates = [n for n in self._nodes.values() if n.alive
                          and (exclude is None or n.node_id not in exclude)]
            if strategy is not None and strategy.kind == "NODE_AFFINITY":
                target = [n for n in candidates
                          if n.node_id.hex() == strategy.node_id]
                if target and target[0].fits(demand):
                    return target[0]
                if not strategy.soft:
                    return None
            fitting = [n for n in candidates if n.fits(demand)]
            if not fitting:
                return None
            if strategy is not None and strategy.kind == "SPREAD":
                self._rr_counter += 1
                return fitting[self._rr_counter % len(fitting)]
            if LOCALITY_ON:
                chosen = self._pick_scored(fitting, locality)
                if chosen is not None:
                    return chosen
            under = [n for n in fitting
                     if n.utilization() < self._spread_threshold]
            return min(under or fitting,
                       key=lambda n: (n.utilization(), n.node_id.hex()))

    def _pick_scored(self, fitting: "list[NodeState]",
                     locality: dict | None) -> NodeState | None:
        """The locality- and load-aware refinement (caller holds the
        lock): the chosen node, its decision counted, or None for the
        classic ordering.

        1. Locality wins outright: the fitting node holding the most
           large-argument bytes; ties by load, then (utilization, hex).
        2. Else the classic pool is ranked by the load score ``running +
           depth + p50 wait`` of the node-stats feed, and the classic
           choice loses only to a real skew (at least _SPILL_MARGIN) or
           when its own report is stale (a wedged daemon looks idle)."""
        now = time.monotonic()
        try:
            stale_s = float(GLOBAL_CONFIG.sched_stats_stale_s)
        except Exception:  # noqa: BLE001 — config gone mid-teardown
            stale_s = 6.0

        def load(n: NodeState) -> "float | None":
            if n.stats_at <= 0.0 or now - n.stats_at > stale_s:
                return None  # never reported, or decayed out
            return n.stats_running + n.stats_depth + n.stats_wait_s

        if locality:
            best = 0.0
            best_nodes: list[NodeState] = []
            for n in fitting:
                b = float(locality.get(n.node_id.hex(), 0.0))
                if b > best:
                    best, best_nodes = b, [n]
                elif b == best and best > 0.0:
                    best_nodes.append(n)
            if best > 0.0:
                chosen = min(best_nodes, key=lambda n: (
                    load(n) if load(n) is not None else float("inf"),
                    n.utilization(), n.node_id.hex()))
                self.sched["locality_hits"] += 1
                self.sched["locality_bytes_saved"] += int(best)
                return chosen
        under = [n for n in fitting
                 if n.utilization() < self._spread_threshold]
        pool = under if under else fitting
        loads = {id(n): load(n) for n in pool}
        if all(v is None for v in loads.values()):
            return None  # no live feed: the classic ordering
        default = min(pool, key=lambda n: (n.utilization(),
                                           n.node_id.hex()))
        chosen = min(pool, key=lambda n: (
            loads[id(n)] if loads[id(n)] is not None else float("inf"),
            n.utilization(), n.node_id.hex()))
        if chosen is default:
            return default
        default_load = loads[id(default)]
        chosen_load = loads[id(chosen)]
        if default_load is None:
            # The classic choice went silent: a node with a fresh report.
            self.sched["stale_stats_skips"] += 1
            if tracing.TRACE_ON:
                tracing.instant("sched:stale_stats_skip", {
                    "skipped": default.node_id.hex()[:16],
                    "chosen": chosen.node_id.hex()[:16]})
            return chosen
        if chosen_load is not None \
                and default_load - chosen_load >= _SPILL_MARGIN:
            self.sched["load_spillbacks"] += 1
            if tracing.TRACE_ON:
                tracing.instant("sched:load_spillback", {
                    "from": default.node_id.hex()[:16],
                    "to": chosen.node_id.hex()[:16],
                    "load_delta": round(default_load - chosen_load, 3)})
            return chosen
        return default

    def update_node_stats(self, node_id: NodeID, running: float,
                          depth: float, wait_s: float,
                          age_s: float = 0.0) -> None:
        """Fold one node's stats report into the load view; ``age_s``
        is its age at the head when fetched, so it keeps ageing
        between syncs."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            node.stats_running = float(running)
            node.stats_depth = float(depth)
            node.stats_wait_s = float(wait_s)
            node.stats_at = time.monotonic() - max(0.0, float(age_s))

    def record_locality_hit(self, bytes_saved: float) -> None:
        """A placement outside the scored scan (a batch fill that kept
        the holder) kept a task next to its bytes: count it as a hit."""
        with self._lock:
            self.sched["locality_hits"] += 1
            self.sched["locality_bytes_saved"] += int(bytes_saved)

    def sched_counters(self) -> dict:
        with self._lock:
            return dict(self.sched)

    def is_feasible(self, demand: dict[str, float]) -> bool:
        with self._lock:
            return any(n.feasible(demand) for n in self._nodes.values()
                       if n.alive)

    def warn_if_infeasible(self, name: str,
                           demand: dict[str, float]) -> None:
        """Warn once per name about a demand no node can ever meet (a
        ``num_gpus`` demand on a machine without a card): the work waits
        for such a node and never runs anywhere else."""
        if self.is_feasible(demand):
            return
        with self._lock:
            if name in self._infeasible_warned:
                return
            self._infeasible_warned.add(name)
        logger.warning(
            "%s demands %s which no node can ever satisfy; it will hang "
            "until matching nodes join.", name, demand)

    def try_acquire(self, node_id: NodeID, demand: dict[str, float]
                    ) -> "dict[int, float] | None":
        """Take ``demand`` on the node: the card shares of its GPU
        (``{}`` without one), or None when it does not fit."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive or not node.fits(demand):
                return None
            return node.acquire(demand)

    def force_acquire(self, node_id: NodeID,
                      demand: dict[str, float]) -> bool:
        """Take ``demand`` on a live node even past what is free (a
        batch filled past the node's slots; the node parks the excess).
        Its availability may go negative until the releases come. Never
        for a ``GPU`` demand."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive or demand.get("GPU", 0.0):
                return False
            node.acquire(demand)
            return True

    def release(self, node_id: NodeID, demand: dict[str, float],
                shares: dict[int, float] | None = None) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.release(demand, shares or {})
            self._lock.notify_all()

    def release_many(self, node_id: NodeID, demands: list) -> None:
        """Give back a completion group's demands (no card shares) in
        one lock pass."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                for demand in demands:
                    node.release(demand, {})
            self._lock.notify_all()

    def notify_change(self) -> None:
        """Wake the waiters of ``wait_for_change`` (a bundle's share came
        back)."""
        with self._lock:
            self._lock.notify_all()

    def wait_for_change(self, timeout: float) -> None:
        with self._lock:
            self._lock.wait(timeout)


@dataclass(eq=False)
class _QueuedTask:
    # eq=False: tasks hash by identity, for the waiting set and the
    # per-dependency index. Cancelled and claimed entries are purged
    # lazily by the next dispatch pass.
    spec: TaskSpec
    run: Callable[[TaskSpec, NodeState], None]
    order: int = field(default_factory=_DISPATCH_ORDER)
    dep_ids: set = field(default_factory=set)
    claimed: bool = False
    cancelled: bool = False


class Dispatcher:
    """Dependency-gated, resource-admitting task dispatcher with one
    thread per launched task."""

    def __init__(self, cluster: ClusterState, store, placement_groups):
        self._cluster = cluster
        self._store = store
        self._placement_groups = placement_groups
        self._lock = threading.Condition()
        # Tasks waiting on argument seals, indexed by dependency id.
        self._waiting: set[_QueuedTask] = set()
        self._dep_index: dict = {}
        # Ready tasks in FIFO queues per admission signature.
        self._ready_groups: dict[tuple, collections.deque] = {}
        self._num_ready_live = 0
        self._num_running = 0
        # Return-object id -> queued task, for cancel; entries leave at
        # claim (a running task is past cancellation).
        self._by_return_id: dict = {}
        # Deadline-armed queued tasks ordered by expiry.
        self._deadline_heap: list = []
        self._deadline_armed = 0
        self._on_deadline = None
        self._on_unplaceable = None
        # spec -> {node hex: resident bytes of its large arguments}
        # (set_locality_hook).
        self._locality_hook = None
        # Batched dispatch (set_batch_hooks) and its counters.
        self._batch_key = None
        self._run_batch = None
        from ray_tpu_torch._private.rpc import _ThreadRecycler

        self._batch_runners = _ThreadRecycler("ray_tpu_torch-batch")
        self.batches_launched = 0
        self.batch_tasks_launched = 0
        self.singles_launched = 0
        self.batch_overcommit = 0
        self._shutdown = False
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="ray_tpu_torch-dispatcher",
            daemon=True)
        self._dispatch_thread.start()
        store.add_seal_listener(self._on_object_sealed)

    @staticmethod
    def _sig(spec: TaskSpec) -> tuple:
        strategy = spec.scheduling_strategy
        pg = strategy.placement_group
        return (tuple(sorted(spec.resources.items())), strategy.kind,
                strategy.node_id, strategy.soft,
                pg.id if pg is not None else None,
                strategy.placement_group_bundle_index,
                frozenset(getattr(spec, "_avoid_nodes", None) or ()))

    def set_deadline_hook(self, on_deadline) -> None:
        """``on_deadline(spec, stage)`` seals a task whose deadline expired
        while queued (stage "queued") or at its claim (stage "dispatch")."""
        self._on_deadline = on_deadline

    def set_unplaceable_hook(self, on_unplaceable) -> None:
        """``on_unplaceable(spec, error)`` seals a placement-group task
        that can never be admitted (its group removed, its bundle too
        small)."""
        self._on_unplaceable = on_unplaceable

    def set_batch_hooks(self, batch_key, run_batch) -> None:
        """Batched dispatch: ``batch_key(spec, node, run)`` gives a key
        (the tasks of one pass with one key form one batch) or None for
        a thread of its own; ``run_batch(specs, node, complete)`` runs a
        batch and calls ``complete(spec)`` (or ``complete.many(specs)``)
        as each task finishes."""
        self._batch_key = batch_key
        self._run_batch = run_batch

    def set_locality_hook(self, hook) -> None:
        """``hook(spec)`` gives {node hex: resident bytes of the spec's
        large arguments} (or a falsy value): the locality input that
        pick_node scores while LOCALITY_ON."""
        self._locality_hook = hook

    def _locality(self, spec: TaskSpec) -> dict | None:
        if not LOCALITY_ON:
            return None
        hook = self._locality_hook
        if hook is None:
            return None
        try:
            return hook(spec) or None
        except Exception:  # noqa: BLE001 — never wedge dispatch
            return None

    def _enqueue_ready_locked(self, task: _QueuedTask) -> None:
        self._num_ready_live += 1
        self._ready_groups.setdefault(
            self._sig(task.spec), collections.deque()).append(task)

    # ------------------------------------------------------------ submission

    def submit(self, spec: TaskSpec,
               run: Callable[[TaskSpec, NodeState], None],
               deps: list) -> None:
        self.submit_many(((spec, run, deps),))

    def submit_many(self, items) -> None:
        """Queue (spec, run, deps) items under one lock, with one
        wakeup (a submit-ring flush)."""
        now = time.time() if perf.PERF_ON else 0.0
        with self._lock:
            for spec, run, deps in items:
                if now and not spec.submit_ts:
                    spec.submit_ts = now
                task = _QueuedTask(spec=spec, run=run)
                # Checked under the lock: a dependency sealing
                # concurrently either shows in contains() or finds the
                # task indexed.
                task.dep_ids = {d.id() for d in deps
                                if not self._store.contains(d.id())}
                if task.dep_ids:
                    self._waiting.add(task)
                    for dep_id in task.dep_ids:
                        self._dep_index.setdefault(dep_id, set()).add(task)
                else:
                    self._enqueue_ready_locked(task)
                for rid in spec.return_ids:
                    self._by_return_id[rid] = task
                if spec.deadline is not None:
                    heapq.heappush(self._deadline_heap,
                                   (spec.deadline, task.order, task))
                    self._deadline_armed += 1
            self._lock.notify_all()

    def _on_object_sealed(self, object_id) -> None:
        with self._lock:
            dependents = self._dep_index.pop(object_id, None)
            for task in dependents or ():
                if task.cancelled:
                    continue
                task.dep_ids.discard(object_id)
                if not task.dep_ids:
                    self._waiting.discard(task)
                    self._enqueue_ready_locked(task)
            if dependents:
                self._lock.notify_all()

    # -------------------------------------------------------------- dispatch

    def _expire_deadlines(self) -> None:
        """Cancel queued tasks whose deadline passed and hand them to the
        deadline hook to seal."""
        if not self._deadline_heap:
            return
        now = time.time()
        expired: list = []
        with self._lock:
            if self._deadline_armed <= 0:
                self._deadline_heap.clear()
                return
            while self._deadline_heap and self._deadline_heap[0][0] <= now:
                _, _, task = heapq.heappop(self._deadline_heap)
                if task.claimed or task.cancelled:
                    continue
                self._cancel_locked(task)
                expired.append(task.spec)
        for spec in expired:
            if self._on_deadline is not None:
                self._on_deadline(spec, "queued")

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                while not self._num_ready_live and not self._shutdown:
                    self._lock.wait(timeout=0.2)
                    if self._deadline_armed:
                        break  # sweep expiries while idle
                if self._shutdown:
                    return
            self._expire_deadlines()
            batches = {} if self._run_batch is not None else None
            launched = self._drain_groups(batches)
            if batches:
                self._flush_batches(batches)
            if not launched:
                # Nothing admitted: wait for resources to free up.
                self._cluster.wait_for_change(0.05)

    def _drain_groups(self, batches: dict | None = None) -> int:
        """One pass over the signature groups: each launches from its FIFO
        head until its demand no longer fits. With ``batches``, a claim
        for a remote node joins that node's batch, and once a batch is
        open the pass fills it past the node's free slots, up to the
        backlog's share of ``dispatch_batch_max``."""
        launched = 0
        with self._lock:
            for sig in [s for s, dq in self._ready_groups.items() if not dq]:
                del self._ready_groups[sig]
            groups = list(self._ready_groups.values())
        n_nodes = max(1, len(self._cluster.nodes()))
        for dq in groups:
            sticky: NodeState | None = None
            staged_remote = False
            fill_left = 0
            fill_budget = 0
            if batches is not None:
                with self._lock:
                    backlog = len(dq)
                fill_budget = min(self._batch_max(), backlog // n_nodes)
            while True:
                with self._lock:
                    while dq and (dq[0].claimed or dq[0].cancelled):
                        dq.popleft()
                    if not dq:
                        break
                    task = dq[0]
                spec = task.spec
                node = None
                overcommitted = False
                hints = self._locality(spec)
                best = max(hints.values()) if hints else 0.0
                if sticky is not None and staged_remote and fill_left > 0 \
                        and spec.scheduling_strategy.kind == "DEFAULT" \
                        and float((hints or {}).get(
                            sticky.node_id.hex(), 0.0)) >= best:
                    # Fill the open batch: the sticky node's real capacity
                    # while it fits, else past it. A task whose bytes are
                    # mostly on another node takes the scored scan below.
                    shares = self._cluster.try_acquire(sticky.node_id,
                                                       spec.resources)
                    if shares is None and self._cluster.force_acquire(
                            sticky.node_id, spec.resources):
                        shares = {}
                        overcommitted = True
                        self.batch_overcommit += 1
                    if shares is not None:
                        spec.gpu_shares = shares
                        node = sticky
                        fill_left -= 1
                        if best > 0.0:
                            self._cluster.record_locality_hit(best)
                if node is None:
                    node = self._try_admit(task, hints)
                    if node is None:
                        break  # this signature is saturated for this pass
                    sticky = node
                    staged_remote = False
                    fill_left = fill_budget
                with self._lock:
                    if dq and dq[0] is task:
                        dq.popleft()
                if not self._claim(task, node):
                    continue
                spec._overcommit = overcommitted
                staged = None if batches is None \
                    else self._stage_batch(batches, task, node)
                if staged is None:
                    self._launch(task, node)
                elif not overcommitted:
                    staged_remote = True
                launched += 1
        return launched

    @staticmethod
    def _batch_max() -> int:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return max(1, int(GLOBAL_CONFIG.dispatch_batch_max))

    def _stage_batch(self, batches: dict, task: _QueuedTask,
                     node: NodeState):
        """Put a claimed task into this pass's batch for its key; the
        key, or None when the task takes a thread of its own."""
        try:
            key = self._batch_key(task.spec, node, task.run)
        except Exception:  # noqa: BLE001 — never wedge dispatch
            key = None
        if key is None:
            return None
        entry = batches.get(key)
        if entry is None:
            entry = batches[key] = (node, [])
        entry[1].append(task)
        if len(entry[1]) >= self._batch_max():
            del batches[key]
            self._launch_batch(entry[1], entry[0])
        return key

    def _flush_batches(self, batches: dict) -> None:
        # A batch of one rides the batch RPC too (the reference sends it
        # on the single path, but its columnar lanes, not ported, carry
        # such a task into a fused run): a plain task then runs fused on
        # its daemon however the ring's flushes cut a burst.
        for node, tasks in batches.values():
            self._launch_batch(tasks, node)
        batches.clear()

    def _launch_batch(self, tasks: "list[_QueuedTask]",
                      node: NodeState) -> None:
        """One runner drives the whole batch; each task's resources come
        back as its completion streams in (no wait for the slowest)."""
        run_batch = self._run_batch
        by_spec = {id(t.spec): (t, dict(t.spec.gpu_shares)) for t in tasks}
        done_lock = threading.Lock()
        self.batches_launched += 1
        self.batch_tasks_launched += len(tasks)

        def complete(spec) -> None:
            with done_lock:
                item = by_spec.pop(id(spec), None)
            if item is None:
                return  # completed already
            self._release(item[0], node, item[1])
            with self._lock:
                self._num_running -= 1
                self._lock.notify_all()

        def complete_many(specs) -> None:
            """A completion group: one ledger pass and one wakeup."""
            with done_lock:
                done = [item for item in (by_spec.pop(id(s), None)
                                          for s in specs)
                        if item is not None]
            if not done:
                return
            self._cluster.release_many(
                node.node_id, [t.spec.resources for t, _ in done])
            with self._lock:
                self._num_running -= len(done)
                self._lock.notify_all()

        complete.many = complete_many

        def runner() -> None:
            try:
                run_batch([t.spec for t in tasks], node, complete)
            finally:
                # A runner that died must not leak its admissions.
                with done_lock:
                    leftover = [t.spec for t, _ in by_spec.values()]
                for spec in leftover:
                    complete(spec)

        self._batch_runners.submit(runner)

    def _try_admit(self, task: _QueuedTask,
                   locality: dict | None = None) -> NodeState | None:
        spec = task.spec
        if spec.scheduling_strategy.kind == "PLACEMENT_GROUP":
            return self._admit_to_bundle(task)
        node = self._cluster.pick_node(
            spec.resources, spec.scheduling_strategy,
            exclude=getattr(spec, "_avoid_nodes", None) or None,
            locality=locality)
        if node is None:
            self._cluster.warn_if_infeasible(f"Task {spec.name}",
                                             spec.resources)
            return None
        shares = self._cluster.try_acquire(node.node_id, spec.resources)
        if shares is None:
            return None
        spec.gpu_shares = shares
        return node

    def _admit_to_bundle(self, task: _QueuedTask) -> NodeState | None:
        """Take the task's demand from its bundle's reservation; None
        while the group is pending or the bundle full. A task that can
        never be admitted is cancelled and handed to the unplaceable
        hook."""
        spec = task.spec
        strategy = spec.scheduling_strategy
        pgs = self._placement_groups
        args = (strategy.placement_group.id,
                strategy.placement_group_bundle_index, spec.resources)
        reason = pgs.unplaceable(*args)
        if reason is None:
            try:
                node_id, spec.gpu_shares = pgs.acquire_from_bundle(*args)
                return self._cluster.get_node(node_id)
            except PlacementGroupError:
                return None  # pending, or the bundle is full for now
        with self._lock:
            if task.claimed or task.cancelled:
                return None
            self._cancel_locked(task)
        if self._on_unplaceable is not None:
            self._on_unplaceable(spec, PlacementGroupError(reason))
        return None

    def _release(self, task: _QueuedTask, node: NodeState,
                 shares: dict | None = None) -> None:
        """Give back what admission took: to the bundle or the node.
        ``shares``: the card shares taken at this admission (a task that
        spilled back may already hold its next admission's)."""
        spec = task.spec
        strategy = spec.scheduling_strategy
        shares = spec.gpu_shares if shares is None else shares
        if strategy.kind == "PLACEMENT_GROUP":
            self._placement_groups.release_to_bundle(
                strategy.placement_group.id,
                strategy.placement_group_bundle_index, spec.resources,
                shares)
        else:
            self._cluster.release(node.node_id, spec.resources, shares)

    def _claim(self, task: _QueuedTask, node: NodeState) -> bool:
        expired = False
        with self._lock:
            if task.cancelled:
                # Cancelled after admission: give the resources back.
                self._release(task, node)
                return False
            deadline = task.spec.deadline
            if deadline is not None and time.time() > deadline:
                # The budget died between enqueue and claim: never launch
                # dead work.
                self._cancel_locked(task)
                self._release(task, node)
                expired = True
            else:
                task.claimed = True
                if deadline is not None:
                    self._deadline_armed -= 1
                self._num_ready_live -= 1
                self._num_running += 1
                for rid in task.spec.return_ids:
                    self._by_return_id.pop(rid, None)
        if expired and self._on_deadline is not None:
            self._on_deadline(task.spec, "dispatch")
        if not expired and (perf.PERF_ON or tracing.TRACE_ON):
            # The claim's stamp: the trace's "dispatch" stage and the
            # performance plane's submit-to-claim hop, on this process's
            # clock (outside the scheduler's lock).
            task.spec.dispatch_ts = time.time()
            if perf.PERF_ON and task.spec.submit_ts:
                perf.record_stage("submit_dispatch", max(
                    0.0, task.spec.dispatch_ts - task.spec.submit_ts))
        return not expired

    def _launch(self, task: _QueuedTask, node: NodeState) -> None:
        shares = dict(task.spec.gpu_shares)

        def runner():
            try:
                task.run(task.spec, node)
            finally:
                self._release(task, node, shares)
                with self._lock:
                    self._num_running -= 1
                    self._lock.notify_all()

        self.singles_launched += 1
        threading.Thread(target=runner, daemon=True,
                         name=f"ray_tpu_torch-task-{task.spec.name}").start()

    # --------------------------------------------------------------- control

    def pipeline_stats(self) -> dict:
        """Batched and single launches, and the claims that filled a
        batch past a node's free slots."""
        with self._lock:
            return {"batches_launched": self.batches_launched,
                    "batch_tasks_launched": self.batch_tasks_launched,
                    "singles_launched": self.singles_launched,
                    "batch_overcommit": self.batch_overcommit}

    def pending_count(self) -> int:
        """Tasks waiting on arguments, ready and running: the depth that
        admission control caps."""
        with self._lock:
            return (len(self._waiting) + self._num_ready_live
                    + self._num_running)

    def wait_idle(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while (len(self._waiting) + self._num_ready_live
                   + self._num_running) > 0:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._lock.wait(timeout=0.1 if remaining is None
                                else min(remaining, 0.1))
            return True

    def _cancel_locked(self, task: _QueuedTask) -> None:
        # Caller holds the lock: flag the queued task (the dispatch pass
        # purges it) and drop it from every index.
        task.cancelled = True
        if task.spec.deadline is not None:
            self._deadline_armed -= 1
        for rid in task.spec.return_ids:
            self._by_return_id.pop(rid, None)
        if not task.dep_ids:
            self._num_ready_live -= 1
            return
        self._waiting.discard(task)
        for dep_id in task.dep_ids:
            dependents = self._dep_index.get(dep_id)
            if dependents is not None:
                dependents.discard(task)
                if not dependents:
                    del self._dep_index[dep_id]

    def cancel_by_return_id(self, object_id) -> "TaskSpec | None":
        """Cancel the not-yet-dispatched task producing ``object_id``;
        None if it already started (a running thread cannot be stopped:
        the reference's non-force cancel)."""
        with self._lock:
            task = self._by_return_id.get(object_id)
            if task is None or task.claimed or task.cancelled:
                return None
            self._cancel_locked(task)
            return task.spec

    def reset_unsatisfiable_avoids(self, alive_ids: set) -> None:
        """A node died: a spillback avoid set made against the old
        membership may now exclude every live node, so clear those (the
        next refusal builds it again)."""
        with self._lock:
            for dq in self._ready_groups.values():
                for task in dq:
                    avoid = getattr(task.spec, "_avoid_nodes", None)
                    if avoid and avoid >= alive_ids:
                        task.spec._avoid_nodes = set()
            self._lock.notify_all()

    def fail_hard_affinity(self, node_id_hex: str) -> "list[TaskSpec]":
        """Cancel every queued task hard-pinned to a node that just died
        (it can never run elsewhere, and would hang its waiters) and
        return their specs; the caller seals their returns."""
        def pinned(task: _QueuedTask) -> bool:
            strategy = task.spec.scheduling_strategy
            return (strategy.kind == "NODE_AFFINITY" and not strategy.soft
                    and strategy.node_id == node_id_hex
                    and not task.claimed and not task.cancelled)

        with self._lock:
            victims = [t for t in self._waiting if pinned(t)]
            for dq in self._ready_groups.values():
                victims += [t for t in dq if pinned(t)]
            for task in victims:
                self._cancel_locked(task)
            return [task.spec for task in victims]

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()
        self._dispatch_thread.join(timeout=5.0)


class BlockedResourceContext:
    """Gives the running task's CPU back while it is blocked in ``get()``
    or ``wait()``, and takes it again when it wakes. Accelerators stay
    held: a task blocked on its GPU's results keeps its GPU."""

    _tls = threading.local()

    @classmethod
    def current(cls):
        return getattr(cls._tls, "ctx", None)

    def __init__(self, cluster: ClusterState, node_id: NodeID,
                 resources: dict[str, float],
                 on_release: Callable[[], None] | None = None,
                 on_reacquire: Callable[[], None] | None = None):
        """``on_release``/``on_reacquire``: the task runs on a node
        daemon, whose own admission ledger gives the CPU back too."""
        self._cluster = cluster
        self._node_id = node_id
        self._cpu_only = {k: v for k, v in resources.items() if k == "CPU"}
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._on_release = on_release
        self._on_reacquire = on_reacquire

    def __enter__(self):
        self._tls.ctx = self
        return self

    def __exit__(self, *exc):
        self._tls.ctx = None
        return False

    def block(self):
        with self._depth_lock:
            release = self._depth == 0 and bool(self._cpu_only)
            self._depth += 1
        if release:
            self._cluster.release(self._node_id, self._cpu_only)
            if self._on_release is not None:
                self._on_release()

    def unblock(self, force: bool = False):
        """Take the CPU again once the last nested wait ends. ``force``
        (whatever the depth): take it at once even past what is free,
        as the reference does: the caller is a stream's or a
        connection's reader, and a reader that waited for capacity
        would wait on the completions it is the one to read."""
        with self._depth_lock:
            if self._depth <= 0:
                return
            self._depth = 0 if force else self._depth - 1
            reacquire = self._depth == 0 and bool(self._cpu_only)
        if reacquire and self._on_reacquire is not None:
            self._on_reacquire()
        if reacquire and force:
            self._cluster.force_acquire(self._node_id, self._cpu_only)
            return
        # Spinning is fine: we only woke because our object sealed, so the
        # release that makes room is imminent. A node that died meanwhile
        # is left alone.
        while reacquire and self._cluster.try_acquire(
                self._node_id, self._cpu_only) is None:
            node = self._cluster.get_node(self._node_id)
            if node is None or not node.alive:
                return
            time.sleep(0.001)

    def drain(self):
        """Undo a wait that was given up (or whose worker died while
        blocked): the task holds its CPU again."""
        self.unblock(force=True)


def format_traceback(exc: BaseException) -> str:
    return "".join(traceback.format_exception(type(exc), exc,
                                              exc.__traceback__))
