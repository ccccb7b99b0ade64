"""Straggler speculation: the driver-side watcher over in-flight tasks.

The port of ``ray_tpu/_private/speculation.py``, speculative execution
after the Ray paper's stragglers discussion (arxiv 1712.05889) and
Spark's ``spark.speculation``: an in-flight task whose elapsed wall exceeds
``speculation_p99_factor`` x the cluster-merged per-function p99 from
the perf plane (``perf_plane.record_task_wall`` — every node's
executions of the function land in the owner's sample ring) gets a
speculative copy re-dispatched to a DIFFERENT node. First seal wins
through the existing seal path:

- the sealing member calls :meth:`SpeculationWatcher.claim_win` BEFORE
  touching the store; the first claimant seals normally, the loser's
  seal is skipped (a nondeterministic function must not have its
  winning value overwritten by a late loser);
- the loser is cancelled best-effort: a still-queued copy via the
  dispatcher's O(1) cancel bookkeeping (no error is sealed — the
  winner's value already lives in the store), an in-flight one via the
  daemon's ``cancel_task`` token (checked before the user function
  runs, so a straggler held in admission/chaos delay provably never
  executes — the side-effect exactly-once property the chaos tests
  assert with marker files);
- a member that FAILS while its sibling is still live (e.g. the
  original's node died under it) is absorbed (:meth:`absorb_failure`)
  instead of sealing an error over a result the sibling can still
  produce — speculation doubles as a latency hedge against node death.

Disarmed cost is one module-attribute branch per site (``SPEC_ON`` —
the chaos.ACTIVE / perf_plane.PERF_ON discipline); the watcher thread
only exists while armed (``speculation_enabled``).

Counters (``execution_pipeline_stats()["sched"]``):
``speculations_launched`` / ``speculations_won`` (the copy sealed
first) / ``speculations_lost`` (the original beat its copy). Decisions
also land as instant pins in merged trace timelines while tracing is
armed.
"""

from __future__ import annotations

import logging
import threading
import time

from ray_tpu_torch._private import perf_plane
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.task import SchedulingStrategy, TaskSpec
from ray_tpu_torch.util import tracing

logger = logging.getLogger("ray_tpu_torch")

# The ONE production branch: every integration site in worker.py reads
# this module attribute and pays nothing else while disarmed.
SPEC_ON: bool = False


def enable() -> None:
    global SPEC_ON
    SPEC_ON = True


def disable() -> None:
    global SPEC_ON
    SPEC_ON = False


def init_from_config() -> None:
    global SPEC_ON
    SPEC_ON = bool(GLOBAL_CONFIG.speculation_enabled)


init_from_config()


def should_speculate(elapsed_s: float, sample_count: int, p99_s: float,
                     factor: float, min_samples: int) -> bool:
    """The trigger math, factored out for direct test coverage: an
    in-flight elapsed wall past ``factor x p99`` triggers, but only
    once the function has a trustworthy sample base and a non-trivial
    p99 (a sub-millisecond p99 floor keeps noise from speculating
    every microtask)."""
    if sample_count < max(1, min_samples):
        return False
    return elapsed_s > factor * max(p99_s, 1e-3)


class _Tracked:
    __slots__ = ("spec", "node_id", "start", "copies", "no_speculate")

    def __init__(self, spec, node_id, no_speculate: bool):
        self.spec = spec
        self.node_id = node_id
        self.start = time.monotonic()
        self.copies = 0
        self.no_speculate = no_speculate


class _Pair:
    """One original/copy speculation pair, keyed by the shared return
    ids. ``winner`` is the member that claimed the seal first; ``done``
    holds the members whose lifecycle has fully resolved."""

    __slots__ = ("orig", "copy", "winner", "done", "failed")

    def __init__(self, orig, copy):
        self.orig = orig
        self.copy = copy
        self.winner = None
        self.done: set[int] = set()
        self.failed: set[int] = set()

    def other(self, spec):
        return self.copy if spec is self.orig else self.orig


class SpeculationWatcher:
    """Tracks in-flight tasks, launches speculative copies, resolves
    first-seal-wins. Owned by the Runtime; one daemon thread."""

    def __init__(self, runtime):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._inflight: dict[int, _Tracked] = {}   # id(spec) -> entry
        self._pairs: dict = {}                     # return ObjectID -> _Pair
        self.launched = 0
        self.won = 0
        self.lost = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="ray_tpu_torch-speculation")
        self._thread.start()

    def counters(self) -> dict:
        with self._lock:
            return {"speculations_launched": self.launched,
                    "speculations_won": self.won,
                    "speculations_lost": self.lost}

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------ tracking

    @staticmethod
    def _eligible(spec) -> bool:
        strategy = spec.scheduling_strategy
        if strategy is not None:
            if strategy.kind == "PLACEMENT_GROUP":
                return False  # bundle-pinned: a copy can't leave the gang
            if strategy.kind == "NODE_AFFINITY" \
                    and not getattr(strategy, "soft", False):
                return False  # hard pin can never run elsewhere
        return spec.func is not None

    def track(self, spec, node) -> bool:
        """Register an in-flight execution (copies register too — their
        node is needed for loser cancellation — but never re-speculate).
        Returns True when the caller must untrack on completion."""
        if not self._eligible(spec):
            return False
        entry = _Tracked(
            spec, node.node_id if node is not None else None,
            no_speculate=getattr(spec, "_speculative_of", None)
            is not None)
        with self._lock:
            self._inflight[id(spec)] = entry
        return True

    def untrack(self, spec, completed: bool = False) -> None:
        with self._lock:
            entry = self._inflight.pop(id(spec), None)
        if entry is not None and completed:
            # Completed-wall sample for the perf plane's per-function
            # ring: the owner clock sees every node's executions, so
            # this IS the cluster-merged distribution the trigger
            # compares against. Only SUCCESSFUL completions feed it —
            # spillbacks and failures would skew the baseline short.
            perf_plane.record_task_wall(
                spec.name, time.monotonic() - entry.start)

    # -------------------------------------------------------- watcher loop

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                period = max(0.02, float(
                    GLOBAL_CONFIG.speculation_watch_period_ms) / 1000.0)
            except Exception:  # noqa: BLE001 — config mid-teardown
                period = 0.2
            if self._stop.wait(period):
                return
            if not SPEC_ON:
                continue
            try:
                self._sweep()
            except Exception:  # noqa: BLE001 — watcher must survive
                logger.exception("speculation sweep failed")

    def _sweep(self) -> None:
        factor = float(GLOBAL_CONFIG.speculation_p99_factor)
        max_copies = int(GLOBAL_CONFIG.speculation_max_copies)
        min_samples = int(GLOBAL_CONFIG.speculation_min_samples)
        now = time.monotonic()
        with self._lock:
            entries = list(self._inflight.values())
        for entry in entries:
            if entry.no_speculate or entry.copies >= max_copies:
                continue
            spec = entry.spec
            if not spec.return_ids:
                continue
            with self._lock:
                if spec.return_ids[0] in self._pairs:
                    continue  # already speculated (bounded per task)
            count, p99 = perf_plane.wall_quantile(spec.name, 0.99)
            if not should_speculate(now - entry.start, count, p99,
                                    factor, min_samples):
                continue
            self._launch_copy(entry, p99)

    def _launch_copy(self, entry: _Tracked, p99_s: float) -> None:
        runtime = self._runtime
        spec = entry.spec
        avoid = {entry.node_id} if entry.node_id is not None else set()
        # A copy is only worth launching when a DIFFERENT node could
        # actually host it.
        if not any(n.node_id not in avoid and n.feasible(spec.resources)
                   for n in runtime.cluster.nodes()):
            return
        copy = TaskSpec(
            task_id=TaskID(), name=spec.name, func=spec.func,
            args=spec.args, kwargs=spec.kwargs,
            num_returns=spec.num_returns,
            resources=dict(spec.resources),
            scheduling_strategy=SchedulingStrategy(),
            return_ids=list(spec.return_ids),
            runtime_env=spec.runtime_env, deadline=spec.deadline)
        copy._speculative_of = spec.task_id
        copy._avoid_nodes = set(avoid)
        pair = _Pair(spec, copy)
        with self._lock:
            entry.copies += 1
            for rid in spec.return_ids:
                self._pairs[rid] = pair
            self.launched += 1
        from ray_tpu_torch._private.gcs import TaskEvent

        runtime.gcs.record_task_event(TaskEvent(
            copy.task_id, spec.name, "PENDING"))
        if tracing.TRACE_ON:
            tracing.instant("sched:speculate", {
                "task": spec.task_id.hex()[:16], "name": spec.name,
                "p99_s": round(p99_s, 6)})
        from ray_tpu_torch._private.object_ref import ref_args

        runtime.dispatcher.submit(copy, runtime._execute_task,
                                  ref_args(spec.args, spec.kwargs))
        logger.info(
            "speculating task %s (%s): elapsed > %gx p99 (%.3fs), copy "
            "avoids node %s", spec.name, spec.task_id.hex()[:8],
            float(GLOBAL_CONFIG.speculation_p99_factor), p99_s,
            entry.node_id.hex()[:8] if entry.node_id else "?")

    # ----------------------------------------------------- first-seal-wins

    def _pair_of(self, spec):
        # Caller holds self._lock.
        if not spec.return_ids:
            return None
        return self._pairs.get(spec.return_ids[0])

    def _cleanup_locked(self, pair: _Pair) -> None:
        if len(pair.done) >= 2:
            for rid in pair.orig.return_ids:
                self._pairs.pop(rid, None)

    def claim_win(self, spec) -> bool:
        """Called by every seal path BEFORE writing results. True =>
        seal normally (no pair, or this member claimed the win first);
        False => a sibling already sealed — skip the write entirely."""
        cancel_loser = None
        with self._lock:
            pair = self._pair_of(spec)
            if pair is None:
                return True
            member = spec if spec in (pair.orig, pair.copy) else None
            if member is None:
                return True
            if pair.winner is None:
                pair.winner = member
                pair.done.add(id(member))
                if member is pair.copy:
                    self.won += 1
                else:
                    self.lost += 1
                cancel_loser = pair.other(member)
                loser_entry = self._inflight.get(id(cancel_loser))
                loser_node = loser_entry.node_id if loser_entry else None
            elif pair.winner is member:
                return True  # idempotent reseal by the winner
            else:
                pair.done.add(id(member))
                self._cleanup_locked(pair)
                return False
        if tracing.TRACE_ON:
            tracing.instant(
                "sched:speculation_" + (
                    "won" if spec is not pair.orig else "lost"),
                {"task": pair.orig.task_id.hex()[:16],
                 "name": pair.orig.name})
        if cancel_loser is not None:
            self._cancel_loser(pair, cancel_loser, loser_node)
        return True

    def _cancel_loser(self, pair: _Pair, loser, loser_node) -> None:
        """Best-effort loser cancellation. A still-queued loser is
        flagged via the dispatcher's O(1) cancel bookkeeping (NO error
        seal — the winner's value is already in the store); an
        in-flight one gets its task token cancelled at its daemon so
        an execution that hasn't started yet never does."""
        runtime = self._runtime
        cancelled = runtime.dispatcher.cancel_by_return_id(
            loser.return_ids[0])
        if cancelled is not None:
            with self._lock:
                pair.done.add(id(loser))
                self._cleanup_locked(pair)
            return
        if loser_node is None:
            return
        with runtime._remote_nodes_lock:
            handle = runtime._remote_nodes.get(loser_node)
        if handle is None:
            return
        token = loser.task_id.hex()

        def rpc_cancel():
            try:
                handle._control.call("cancel_task", token)
            except Exception:  # noqa: BLE001 — best-effort
                pass

        threading.Thread(target=rpc_cancel, daemon=True,
                         name="ray_tpu_torch-spec-cancel").start()

    def mark_cancelled(self, spec) -> None:
        """The daemon refused ``spec``'s execution because its token
        was cancelled (it lost the race before ever running)."""
        with self._lock:
            pair = self._pair_of(spec)
            if pair is not None and spec in (pair.orig, pair.copy):
                pair.done.add(id(spec))
                self._cleanup_locked(pair)

    def absorb_failure(self, spec) -> bool:
        """Called by the failure path BEFORE retry/seal. True => the
        failure is absorbed (a sibling already won, or is still live
        and may yet produce the result); False => this was the last
        live member — fail normally."""
        with self._lock:
            pair = self._pair_of(spec)
            if pair is None or spec not in (pair.orig, pair.copy):
                return False
            other = pair.other(spec)
            if pair.winner is not None and pair.winner is not spec:
                pair.done.add(id(spec))
                self._cleanup_locked(pair)
                return True
            if id(other) not in pair.failed and pair.winner is None:
                # Sibling still live (queued or running): hedge holds.
                pair.failed.add(id(spec))
                pair.done.add(id(spec))
                return True
            # Last member standing failed too: surface the error.
            pair.done.add(id(spec))
            self._cleanup_locked(pair)
            return False
