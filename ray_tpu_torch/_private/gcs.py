"""Global Control Service: the runtime's control-plane tables.

The port of ``ray_tpu/_private/gcs.py``: a namespaced key-value store,
the job, node and actor tables with named actors per namespace, the
placement groups, the task events ``timeline()`` reads, an in-process
pub/sub hub (node and actor transitions), the per-node stats table the
heartbeats fill and the cluster's object directory, which the head
(``gcs_server.py``) serves, with the spilled marks its daemons report.
Each is thread-safe. The tables the head persists count their mutations
(``version``, ``table_versions``) and hand each to ``wal_emit`` while
their lock is held, so the WAL's order is the order of application;
``control_snapshot``/``restore_control``/``apply_op`` are the snapshot
and replay sides. Not ported: the sharded tables (ROADMAP).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, TaskID


class StaleEpochError(Exception):
    """A control-plane write carried the epoch of an earlier head
    incarnation (a daemon or driver cut off across a head restart). It
    was refused; the caller re-syncs (registers or publishes again under
    ``current_epoch``) and retries."""

    def __init__(self, current_epoch: int, stale_epoch: int | None = None):
        super().__init__(
            f"stale epoch {stale_epoch} (head is at epoch "
            f"{current_epoch}); re-sync and retry")
        self.current_epoch = current_epoch
        self.stale_epoch = stale_epoch

    def __reduce__(self):
        # Crosses RPC as its own type, with its epochs.
        return (StaleEpochError, (self.current_epoch, self.stale_epoch))


class KVStore:
    """Namespaced key-value store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, dict[bytes, bytes]] = defaultdict(dict)
        # Counts mutations: the head snapshots only when it moved.
        self.version = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {ns: dict(kv) for ns, kv in self._data.items()}

    def restore(self, data: dict) -> None:
        with self._lock:
            for ns, kv in data.items():
                self._data[ns].update(kv)
            self.version += 1

    def put(self, key: bytes, value: bytes, namespace: str = "default",
            overwrite: bool = True) -> bool:
        with self._lock:
            ns = self._data[namespace]
            if not overwrite and key in ns:
                return False
            ns[key] = value
            self.version += 1
            return True

    def get(self, key: bytes, namespace: str = "default") -> bytes | None:
        with self._lock:
            return self._data[namespace].get(key)

    def delete(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            existed = self._data[namespace].pop(key, None) is not None
            if existed:
                self.version += 1
            return existed

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
    whole. A holder whose copy went to its disk tier keeps its place in
    the holder set and is marked spilled; the mark dies with the node."""

    def __init__(self):
        self._lock = threading.Lock()
        # owner address -> {object hex -> {node hex, ...}}
        self._locations: dict[str, dict[str, set[str]]] = {}
        # owner address -> {object hex -> node hex}: copies on disk.
        self._spilled: dict[str, dict[str, str]] = {}
        self._seen: dict[str, float] = {}
        # object hex -> when its newest mark landed: a mark under a
        # daemon's owner key waits one lease for the owner's publish.
        self._marked_at: dict[str, float] = {}
        # Mutations the head persists (TTL pruning is not one: it
        # derives again from the lease clocks a restore resets).
        self.version = 0
        self.wal_emit = None

    def _mutated(self, op) -> None:
        # Caller holds self._lock.
        self.version += 1
        if self.wal_emit is not None:
            self.wal_emit(op)

    def snapshot_state(self) -> dict:
        """Plain data for the head's snapshot (holder sets as sorted
        lists)."""
        with self._lock:
            return {
                "locations": {
                    owner: {obj: sorted(nodes)
                            for obj, nodes in table.items()}
                    for owner, table in self._locations.items()},
                "spilled": {owner: dict(table)
                            for owner, table in self._spilled.items()},
            }

    def restore_state(self, state: dict) -> None:
        """Rehydrate from a snapshot; every owner's lease restarts now
        (a live owner publishes again, a dead one ages out)."""
        now = time.monotonic()
        with self._lock:
            for owner, table in (state.get("locations") or {}).items():
                dst = self._locations.setdefault(owner, {})
                for obj_hex, nodes in table.items():
                    dst.setdefault(obj_hex, set()).update(nodes)
                self._seen[owner] = now
            for owner, table in (state.get("spilled") or {}).items():
                self._spilled.setdefault(owner, {}).update(table)
                self._marked_at.update(dict.fromkeys(table, now))

    def update(self, owner: str, adds: list, removes: list) -> int:
        """One owner's deltas; an empty update is a keepalive of its
        lease. ``adds`` holds (object hex, node hex or [node hex, ...])."""
        with self._lock:
            table = self._locations.setdefault(owner, {})
            spilled = self._spilled.get(owner)
            for obj_hex, nodes in adds:
                holders = table.setdefault(obj_hex, set())
                if isinstance(nodes, str):
                    holders.add(nodes)
                else:
                    holders.update(nodes)
            for obj_hex in removes:
                table.pop(obj_hex, None)
                if spilled is not None:
                    spilled.pop(obj_hex, None)
            self._seen[owner] = time.monotonic()
            if not table:
                self._locations.pop(owner, None)
            if spilled is not None and not spilled:
                self._spilled.pop(owner, None)
            if adds or removes:
                self._mutated(("dir_update", owner, list(adds),
                               list(removes)))
            return len(table)

    def mark_spilled(self, owner: str, obj_hex: str,
                     node_hex: str) -> None:
        """A holder moved its copy to its disk tier (a heartbeat's spill
        event). The daemon names the owner by its client endpoint, the
        driver publishes under its export address: the mark joins the
        bucket that holds the object, else the daemon's owner key."""
        with self._lock:
            bucket = owner
            for loc_owner, table in self._locations.items():
                if obj_hex in table:
                    bucket = loc_owner
                    break
            self._spilled.setdefault(bucket, {})[obj_hex] = node_hex
            self._marked_at[obj_hex] = time.monotonic()
            self._mutated(("dir_spill", bucket, obj_hex, node_hex))

    def clear_spilled(self, owner: str, obj_hex: str) -> None:
        """The holder restored its copy into memory."""
        with self._lock:
            for bucket in [b for b, spilled in self._spilled.items()
                           if obj_hex in spilled]:
                spilled = self._spilled[bucket]
                spilled.pop(obj_hex, None)
                if not spilled:
                    self._spilled.pop(bucket, None)
                self._mutated(("dir_unspill", bucket, obj_hex))

    def spilled(self, owner: str | None = None) -> dict:
        """{object hex -> the node holding it on disk}, one owner or
        all."""
        with self._lock:
            if owner is not None:
                return dict(self._spilled.get(owner, {}))
            out: dict[str, str] = {}
            for table in self._spilled.values():
                out.update(table)
            return out

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
                self._spilled.pop(owner, None)
            # Marks under a daemon's owner key with no lease behind them
            # go once their objects are in no bucket and the mark is a
            # lease old. A heartbeat's mark often lands before the
            # owner's first publish of the object, and the daemon never
            # sends it again: dropped at once, it was lost for good
            # (and came back only from a WAL no snapshot had covered).
            for owner in [o for o in self._spilled if o not in self._seen]:
                table = self._spilled[owner]
                for obj_hex in [h for h in table if not any(
                        h in t for t in self._locations.values())
                        and now - self._marked_at.get(h, 0.0) > ttl_s]:
                    del table[obj_hex]
                if not table:
                    self._spilled.pop(owner, None)
            marked = set().union(*self._spilled.values())
            for obj_hex in [h for h in self._marked_at if h not in marked]:
                del self._marked_at[obj_hex]

    def prune_node(self, node_hex: str) -> list[str]:
        """A node died: drop it from every holder set, and its spilled
        marks (its disk died with it). Returns the objects whose last
        holder it was."""
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
            for owner in list(self._spilled):
                spilled = self._spilled[owner]
                for obj_hex in [o for o, n in spilled.items()
                                if n == node_hex]:
                    del spilled[obj_hex]
                if not spilled:
                    self._spilled.pop(owner, None)
            self._mutated(("dir_prune_node", node_hex))
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
    # The host's identity (same_host.host_identity): daemons of equal
    # host_id share POSIX shared memory and map each other's objects
    # instead of pulling them in chunks.
    host_id: str = ""
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

    def __init__(self, kv=None):
        # A head's GcsServer passes the native engine
        # (gcs_kv_native.make_kv_store); a driver's own tables keep the
        # Python store and never build native code.
        self.kv = kv if kv is not None else KVStore()
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
        # Mutations of the persisted tables (a liveness refresh is not
        # one), and the head's WAL hook, called under self._lock.
        self.table_versions = {"actors": 0, "nodes": 0, "jobs": 0}
        self.wal_emit = None

    # ----------------------------------------------------------- persistence

    def _mutated(self, table: str, op) -> None:
        # Caller holds self._lock.
        self.table_versions[table] += 1
        if self.wal_emit is not None:
            self.wal_emit(op)

    @staticmethod
    def _actor_from_plain(plain: dict) -> "ActorRecord":
        return ActorRecord(
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

    @staticmethod
    def _node_plain(record: "NodeRecord") -> dict:
        return {"node_id": record.node_id.binary(), "address": record.address,
                "resources": dict(record.resources),
                "labels": dict(record.labels),
                "executor_address": record.executor_address,
                "host_id": record.host_id,
                "alive": record.alive, "available": dict(record.available)}

    @staticmethod
    def _job_plain(record: "JobRecord") -> dict:
        return {"job_id": record.job_id.binary(),
                "start_time": record.start_time,
                "end_time": record.end_time, "status": record.status,
                "entrypoint": record.entrypoint, "message": record.message,
                "submission_id": record.submission_id}

    def control_snapshot(self) -> dict:
        """The persisted tables as plain data (the KV has its own
        ``snapshot()``; task events and node stats are not persisted)."""
        with self._lock:
            return {"actors": [self.actor_plain(r)
                               for r in self._actors.values()],
                    "nodes": [self._node_plain(r)
                              for r in self._nodes.values()],
                    "jobs": [self._job_plain(r)
                             for r in self._jobs.values()]}

    def restore_control(self, state: dict) -> None:
        """Rehydrate actors, nodes and jobs from a snapshot (nothing is
        published: subscribers connect after the server starts)."""
        for plain in state.get("actors", []):
            self.apply_op(("actor", plain))
        for plain in state.get("nodes", []):
            self.apply_op(("node", plain))
        for plain in state.get("jobs", []):
            self.apply_op(("job", plain))

    def apply_op(self, op: tuple) -> None:
        """Apply one WAL record: a whole-record upsert, so applying one a
        snapshot already covers changes nothing."""
        kind, plain = op[0], op[1]
        if kind == "actor":
            record = self._actor_from_plain(plain)
            with self._lock:
                self._actors[record.actor_id] = record
                self._index_name_locked(record)
        elif kind == "node":
            # last_heartbeat restarts now: a node restored alive has a
            # whole timeout to heartbeat again.
            record = NodeRecord(
                node_id=NodeID(plain["node_id"]),
                address=plain.get("address", ""),
                resources=dict(plain.get("resources") or {}),
                labels=dict(plain.get("labels") or {}),
                executor_address=plain.get("executor_address", ""),
                host_id=plain.get("host_id", ""),
                alive=bool(plain.get("alive", True)),
                available=dict(plain.get("available") or {}))
            with self._lock:
                self._nodes[record.node_id] = record
        elif kind == "job":
            with self._lock:
                self._jobs[JobID(plain["job_id"])] = JobRecord(
                    job_id=JobID(plain["job_id"]),
                    start_time=plain.get("start_time", 0.0),
                    end_time=plain.get("end_time"),
                    status=plain.get("status", "RUNNING"),
                    entrypoint=plain.get("entrypoint", ""),
                    message=plain.get("message", ""),
                    submission_id=plain.get("submission_id", ""))

    def _index_name_locked(self, record: "ActorRecord") -> None:
        if record.name is None:
            return
        key = (record.namespace, record.name)
        if record.state == "DEAD":
            if self._named_actors.get(key) == record.actor_id:
                self._named_actors.pop(key, None)
        else:
            self._named_actors[key] = record.actor_id

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
            self._mutated("actors", ("actor", self.actor_plain(record)))

    def update_actor_state(self, actor_id: ActorID, state: str,
                           death_cause: str | None = None) -> None:
        with self._lock:
            record = self._actors.get(actor_id)
            if record is None:
                return
            record.state = state
            if death_cause is not None:
                record.death_cause = death_cause
            self._mutated("actors", ("actor", self.actor_plain(record)))
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
        record = self._actor_from_plain(plain)
        with self._lock:
            existing = self._actors.get(record.actor_id)
            if existing is not None and existing.state == "DEAD" \
                    and record.state != "DEAD":
                return False
            self._actors[record.actor_id] = record
            self._index_name_locked(record)
            self._mutated("actors", ("actor", self.actor_plain(record)))
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
            self._mutated("nodes", ("node", self._node_plain(record)))
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
            # The death verdict is durable: a restarted head still
            # refuses the id.
            self._mutated("nodes", ("node", self._node_plain(record)))
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
            self._mutated("jobs", ("job", self._job_plain(record)))

    def finish_job(self, job_id: JobID, status: str = "SUCCEEDED") -> None:
        with self._lock:
            record = self._jobs.get(job_id)
            if record is not None:
                record.status = status
                record.end_time = time.time()
                self._mutated("jobs", ("job", self._job_plain(record)))

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
