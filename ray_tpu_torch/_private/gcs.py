"""Global Control Service: the runtime's control-plane tables.

The port of ``ray_tpu/_private/gcs.py``, its in-process tables: a
namespaced key-value store, the job, node and actor tables with named
actors per namespace, the placement groups, and the task events
``timeline()`` reads. Each is thread-safe.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
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


@dataclass
class ActorRecord:
    actor_id: ActorID
    name: str | None
    namespace: str
    class_name: str
    state: str = "PENDING"  # PENDING / ALIVE / DEAD
    death_cause: str | None = None
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
    alive: bool = True
    # When the node last heartbeat (time.monotonic()); the health
    # monitor declares it dead once this is stale.
    last_heartbeat: float = field(default_factory=time.monotonic)


@dataclass
class JobRecord:
    job_id: JobID
    start_time: float = field(default_factory=time.time)
    end_time: float | None = None
    status: str = "RUNNING"


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

    def list_nodes(self) -> list[NodeRecord]:
        with self._lock:
            return list(self._nodes.values())

    def mark_node_dead(self, node_id: NodeID) -> None:
        with self._lock:
            record = self._nodes.get(node_id)
            if record is not None:
                record.alive = False

    def heartbeat(self, node_id: NodeID) -> bool:
        """Refresh a node's liveness; False for an unknown or dead node
        (a dead node is never revived in place)."""
        with self._lock:
            record = self._nodes.get(node_id)
            if record is None or not record.alive:
                return False
            record.last_heartbeat = time.monotonic()
            return True

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
