"""Global Control Service: the runtime's control-plane tables.

The port of ``ray_tpu/_private/gcs.py``: a namespaced key-value store,
the job, node and actor tables with named actors per namespace, the
placement groups, the task events ``timeline()`` reads, an in-process
pub/sub hub (node and actor transitions), the per-node stats table the
heartbeats fill and the cluster's object directory, which the head
(``gcs_server.py``) serves. Each is thread-safe. Not ported: the write-
ahead log hooks, snapshots and shards of the reference's durable head
(ROADMAP item 10b), and the directory's spill marks (item 10a's node
spill tier).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, TaskID


class KVStore:
    """Namespaced key-value store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, dict[bytes, bytes]] = defaultdict(dict)

    def put(self, key: bytes, value: bytes, namespace: str = "default",
            overwrite: bool = True) -> bool:
        with self._lock:
            ns = self._data[namespace]
            if not overwrite and key in ns:
                return False
            ns[key] = value
            return True

    def get(self, key: bytes, namespace: str = "default") -> bytes | None:
        with self._lock:
            return self._data[namespace].get(key)

    def delete(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            return self._data[namespace].pop(key, None) is not None

    def exists(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            return key in self._data[namespace]

    def keys(self, prefix: bytes = b"",
             namespace: str = "default") -> list[bytes]:
        with self._lock:
            return [k for k in self._data[namespace] if k.startswith(prefix)]


class ObjectDirectory:
    """The cluster's object-location table: owners publish which nodes
    hold copies of their objects, in batches. Entries are leased per
    owner: an owner that stops refreshing (its driver exited) is pruned
    whole."""

    def __init__(self):
        self._lock = threading.Lock()
        # owner address -> {object hex -> {node hex, ...}}
        self._locations: dict[str, dict[str, set[str]]] = {}
        self._seen: dict[str, float] = {}

    def update(self, owner: str, adds: list, removes: list) -> int:
        """One owner's deltas; an empty update is a keepalive of its
        lease. ``adds`` holds (object hex, node hex or [node hex, ...])."""
        with self._lock:
            table = self._locations.setdefault(owner, {})
            for obj_hex, nodes in adds:
                holders = table.setdefault(obj_hex, set())
                if isinstance(nodes, str):
                    holders.add(nodes)
                else:
                    holders.update(nodes)
            for obj_hex in removes:
                table.pop(obj_hex, None)
            self._seen[owner] = time.monotonic()
            if not table:
                self._locations.pop(owner, None)
            return len(table)

    def locations(self, owner: str | None = None) -> dict:
        """{object hex -> sorted holders}, for one owner or all."""
        with self._lock:
            if owner is not None:
                return {o: sorted(nodes) for o, nodes
                        in self._locations.get(owner, {}).items()}
            out: dict[str, list[str]] = {}
            for table in self._locations.values():
                for obj_hex, nodes in table.items():
                    out[obj_hex] = sorted(set(out.get(obj_hex, ())) | nodes)
            return out

    def prune(self, ttl_s: float = 60.0) -> None:
        now = time.monotonic()
        with self._lock:
            for owner in [o for o, seen in self._seen.items()
                          if now - seen > ttl_s]:
                self._seen.pop(owner, None)
                self._locations.pop(owner, None)

    def prune_node(self, node_hex: str) -> list[str]:
        """A node died: drop it from every holder set. Returns the
        objects whose last holder it was."""
        orphaned: list[str] = []
        with self._lock:
            for owner in list(self._locations):
                table = self._locations[owner]
                for obj_hex in list(table):
                    holders = table[obj_hex]
                    if node_hex not in holders:
                        continue
                    holders.discard(node_hex)
                    if not holders:
                        del table[obj_hex]
                        orphaned.append(obj_hex)
                if not table:
                    self._locations.pop(owner, None)
        return orphaned


class PubSub:
    """In-process pub/sub: callbacks per channel."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[str, list[Callable[[Any], None]]] = \
            defaultdict(list)

    def subscribe(self, channel: str,
                  callback: Callable[[Any], None]) -> Callable[[], None]:
        with self._lock:
            self._subs[channel].append(callback)

        def unsubscribe():
            with self._lock:
                try:
                    self._subs[channel].remove(callback)
                except ValueError:
                    pass

        return unsubscribe

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            callbacks = list(self._subs.get(channel, ()))
        for cb in callbacks:
            try:
                cb(message)
            except Exception:  # noqa: BLE001 — one bad subscriber must not starve the rest
                import logging

                logging.getLogger("ray_tpu_torch").exception(
                    "pubsub callback on %r failed", channel)


@dataclass
class ActorRecord:
    actor_id: ActorID
    name: str | None
    namespace: str
    class_name: str
    state: str = "PENDING"  # PENDING / ALIVE / DEAD
    death_cause: str | None = None
    max_restarts: int = 0
    num_restarts: int = 0
    # Where the actor executes: its node (the driver's own for an actor
    # of this process) and its process.
    node_id_hex: str = ""
    pid: int | None = None
    # Per-method defaults declared with @method (num_returns).
    method_meta: dict = field(default_factory=dict)
    # The end-to-end budget (seconds) each call inherits; 0 = none.
    default_deadline_s: float = 0.0


@dataclass
class NodeRecord:
    node_id: NodeID
    address: str
    resources: dict[str, float]
    labels: dict[str, str] = field(default_factory=dict)
    # The RPC address of the node's executor service ("" for a node that
    # runs no tasks, such as a driver).
    executor_address: str = ""
    alive: bool = True
    # When the node last heartbeat (time.monotonic()); the health
    # monitor declares it dead once this is stale.
    last_heartbeat: float = field(default_factory=time.monotonic)
    # The availability its last heartbeat carried.
    available: dict[str, float] = field(default_factory=dict)


@dataclass
class JobRecord:
    job_id: JobID
    start_time: float = field(default_factory=time.time)
    end_time: float | None = None
    status: str = "RUNNING"
    entrypoint: str = ""       # a submitted job's shell command
    message: str = ""          # its status detail
    submission_id: str = ""    # the job submission API's id


@dataclass
class TaskEvent:
    """A task's latest state, for observability."""

    task_id: TaskID
    name: str
    state: str  # PENDING / RUNNING / FINISHED / FAILED
    start_time: float = 0.0
    end_time: float = 0.0
    node_id: str = ""
    error: str | None = None


class GlobalControlService:
    """All control-plane tables in one place."""

    TASK_EVENT_LIMIT = 100_000

    def __init__(self):
        self.kv = KVStore()
        self._lock = threading.Lock()
        self._actors: dict[ActorID, ActorRecord] = {}
        self._named_actors: dict[tuple[str, str], ActorID] = {}
        self._nodes: dict[NodeID, NodeRecord] = {}
        self._jobs: dict[JobID, JobRecord] = {}
        # PlacementGroupRecords, kept by the placement-group manager.
        self._placement_groups: dict = {}
        self._task_events: dict[TaskID, TaskEvent] = {}
        # Events refused at the cap.
        self.task_events_dropped = 0
        # Node ("ALIVE"/"DEAD", node id) and actor (state, actor id)
        # transitions.
        self.pubsub = PubSub()
        # node hex -> (the executor stats its heartbeat carried, when).
        self._node_stats: dict[str, tuple[dict, float]] = {}
        self._node_stats_lock = threading.Lock()

    # ---------------------------------------------------------------- actors

    def register_actor(self, record: ActorRecord) -> None:
        """Raises ValueError when a live actor holds the name already."""
        with self._lock:
            if record.name is not None:
                key = (record.namespace, record.name)
                existing = self._actors.get(self._named_actors.get(key))
                if existing is not None and existing.state != "DEAD":
                    raise ValueError(
                        f"Actor with name {record.name!r} already exists "
                        f"in namespace {record.namespace!r}")
                self._named_actors[key] = record.actor_id
            self._actors[record.actor_id] = record

    def update_actor_state(self, actor_id: ActorID, state: str,
                           death_cause: str | None = None) -> None:
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None:
                return
            record.state = state
            if death_cause is not None:
                record.death_cause = death_cause
        self.pubsub.publish("actors", (state, actor_id))

    def list_actors(self) -> list[ActorRecord]:
        with self._lock:
            return list(self._actors.values())

    @staticmethod
    def actor_plain(record: ActorRecord) -> dict:
        """The record as plain data, for the head's mirror."""
        return {
            "actor_id": record.actor_id.binary(), "name": record.name,
            "namespace": record.namespace,
            "class_name": record.class_name, "state": record.state,
            "max_restarts": record.max_restarts,
            "num_restarts": record.num_restarts,
            "death_cause": record.death_cause,
            "node_id_hex": record.node_id_hex, "pid": record.pid,
            "method_meta": dict(record.method_meta),
            "default_deadline_s": record.default_deadline_s,
        }

    def upsert_actor_mirror(self, plain: dict) -> bool:
        """The head's copy of a driver's actor record. A record the head
        saw DEAD is never brought back to life; False when refused."""
        record = ActorRecord(
            actor_id=ActorID(plain["actor_id"]), name=plain.get("name"),
            namespace=plain.get("namespace", "default"),
            class_name=plain.get("class_name", ""),
            state=plain.get("state", "PENDING"),
            death_cause=plain.get("death_cause"),
            max_restarts=int(plain.get("max_restarts", 0)),
            num_restarts=int(plain.get("num_restarts", 0)),
            node_id_hex=plain.get("node_id_hex", ""), pid=plain.get("pid"),
            method_meta=dict(plain.get("method_meta") or {}),
            default_deadline_s=float(plain.get("default_deadline_s", 0.0)))
        with self._lock:
            existing = self._actors.get(record.actor_id)
            if existing is not None and existing.state == "DEAD" \
                    and record.state != "DEAD":
                return False
            self._actors[record.actor_id] = record
            if record.name is not None:
                key = (record.namespace, record.name)
                if record.state == "DEAD":
                    if self._named_actors.get(key) == record.actor_id:
                        self._named_actors.pop(key, None)
                else:
                    self._named_actors[key] = record.actor_id
        return True

    def get_actor(self, actor_id: ActorID) -> ActorRecord | None:
        with self._lock:
            return self._actors.get(actor_id)

    def get_named_actor(self, name: str,
                        namespace: str = "default") -> ActorRecord | None:
        with self._lock:
            record = self._actors.get(
                self._named_actors.get((namespace, name)))
            if record is None or record.state == "DEAD":
                return None
            return record

    # ----------------------------------------------------------------- nodes

    def register_node(self, record: NodeRecord) -> None:
        with self._lock:
            self._nodes[record.node_id] = record
        self.pubsub.publish("nodes", ("ALIVE", record.node_id))

    def get_node(self, node_id: NodeID) -> NodeRecord | None:
        with self._lock:
            return self._nodes.get(node_id)

    def list_nodes(self) -> list[NodeRecord]:
        with self._lock:
            return list(self._nodes.values())

    def mark_node_dead(self, node_id: NodeID) -> None:
        with self._lock:
            record = self._nodes.get(node_id)
            if record is None or not record.alive:
                return
            record.alive = False
        self.pubsub.publish("nodes", ("DEAD", node_id))

    def heartbeat(self, node_id: NodeID,
                  available: dict | None = None) -> bool:
        """Refresh a node's liveness (and the availability it reports);
        False for an unknown or dead node, which must register again (a
        dead node is never revived in place)."""
        with self._lock:
            record = self._nodes.get(node_id)
            if record is None or not record.alive:
                return False
            record.last_heartbeat = time.monotonic()
            if available is not None:
                record.available = dict(available)
            return True

    # ----------------------------------------------------------- node stats

    def record_node_stats(self, node_hex: str, stats: dict) -> None:
        """A node's executor stats, stamped when they arrived."""
        with self._node_stats_lock:
            self._node_stats[node_hex] = (stats, time.monotonic())

    def drop_node_stats(self, node_hex: str) -> None:
        with self._node_stats_lock:
            self._node_stats.pop(node_hex, None)

    def node_stats(self) -> dict:
        """{node hex -> its last stats, with ``age_s`` since arrival}."""
        now = time.monotonic()
        with self._node_stats_lock:
            return {node_hex: {**stats, "age_s": now - at}
                    for node_hex, (stats, at) in self._node_stats.items()}

    # ------------------------------------------------------ placement groups

    def register_placement_group(self, record) -> None:
        with self._lock:
            self._placement_groups[record.pg_id] = record

    def get_placement_group(self, pg_id):
        with self._lock:
            return self._placement_groups.get(pg_id)

    def list_placement_groups(self) -> list:
        with self._lock:
            return list(self._placement_groups.values())

    # ------------------------------------------------------------------ jobs

    def register_job(self, record: JobRecord) -> None:
        with self._lock:
            self._jobs[record.job_id] = record

    def finish_job(self, job_id: JobID, status: str = "SUCCEEDED") -> None:
        with self._lock:
            record = self._jobs.get(job_id)
            if record is not None:
                record.status = status
                record.end_time = time.time()

    def list_jobs(self) -> list[JobRecord]:
        with self._lock:
            return list(self._jobs.values())

    # ----------------------------------------------------------- task events

    def record_task_event(self, event: TaskEvent) -> None:
        """Keep the task's latest state; a new task past the cap is
        counted in ``task_events_dropped`` instead."""
        with self._lock:
            if len(self._task_events) >= self.TASK_EVENT_LIMIT \
                    and event.task_id not in self._task_events:
                self.task_events_dropped += 1
                return
            self._task_events[event.task_id] = event

    def list_task_events(self) -> list[TaskEvent]:
        with self._lock:
            return list(self._task_events.values())
