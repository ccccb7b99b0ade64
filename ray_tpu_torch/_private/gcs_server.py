"""The head's control plane, served over RPC.

The port of ``ray_tpu/_private/gcs_server.py``. One ``RpcServer`` serves
a ``GlobalControlService``'s tables and the job manager to every node,
driver and tool of the cluster:

- nodes register, heartbeat (carrying their availability and executor
  stats) and drain; the monitor loop marks a node dead once its
  heartbeats stop for ``heartbeat_timeout_s``, and the death goes out on
  the ``nodes`` channel;
- availability that changed goes out on ``node_resources`` (the
  resource view is pushed, not polled);
- the object-location table, leased per owner and pruned by TTL, drops
  a dead node from every holder set and publishes the objects whose last
  holder it was on ``object_loss``;
- drivers mirror their actor records here, and their placement groups;
- a key-value store, and jobs: entrypoint processes with captured logs.

Not ported, each with its ROADMAP item: the write-ahead log, snapshots,
restart epochs and fencing (10b); the sharded tables (10b); the metrics
history, its watchdog and the heartbeat-shipped trace spans (10c).
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time

from ray_tpu_torch._private.gcs import (
    GlobalControlService,
    JobRecord,
    NodeRecord,
    ObjectDirectory,
)
from ray_tpu_torch._private.gcs_pubsub import ChannelHub
from ray_tpu_torch._private.ids import JobID, NodeID
from ray_tpu_torch._private.rpc import RpcServer

JOB_SUBMISSION_ENV = "RAY_TPU_TORCH_JOB_SUBMISSION_ID"


class JobManager:
    """Job submission at the head: each entrypoint is a shell process
    with its output captured to a log, and its end recorded."""

    def __init__(self, gcs: GlobalControlService, log_dir: str):
        self.gcs = gcs
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def submit(self, entrypoint: str, *, submission_id: str | None = None,
               env: dict | None = None, cwd: str | None = None) -> str:
        job_id = JobID()
        sub_id = submission_id or f"raysubmit_{job_id.hex()[:12]}"
        # Idempotent on submission_id: a retried request must not start
        # the entrypoint twice (check and register under one lock).
        with self._lock:
            if submission_id is not None \
                    and self._record(sub_id) is not None:
                return sub_id
            self.gcs.register_job(JobRecord(
                job_id=job_id, status="RUNNING", entrypoint=entrypoint,
                submission_id=sub_id))
        log_path = os.path.join(self.log_dir, f"{sub_id}.log")
        full_env = dict(os.environ)
        full_env[JOB_SUBMISSION_ENV] = sub_id
        # The entrypoint resolves the same installation as the head.
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        prior = full_env.get("PYTHONPATH", "")
        if pkg_root not in prior.split(os.pathsep):
            full_env["PYTHONPATH"] = \
                pkg_root + (os.pathsep + prior if prior else "")
        full_env.update(env or {})
        try:
            with open(log_path, "wb") as log_file:
                proc = subprocess.Popen(
                    entrypoint, shell=True, stdout=log_file,
                    stderr=subprocess.STDOUT, cwd=cwd, env=full_env,
                    start_new_session=True)
        except OSError as exc:
            self.gcs.finish_job(job_id, status="FAILED")
            record = self._record(sub_id)
            if record is not None:
                record.message = str(exc)
            return sub_id
        with self._lock:
            self._procs[sub_id] = proc
        threading.Thread(target=self._wait, args=(sub_id, job_id, proc),
                         daemon=True, name=f"job-wait-{sub_id}").start()
        return sub_id

    def _wait(self, sub_id: str, job_id: JobID,
              proc: subprocess.Popen) -> None:
        rc = proc.wait()
        record = self._record(sub_id)
        if record is not None and record.status == "STOPPED":
            # Stopped by the user: a nonzero exit is not a failure.
            self.gcs.finish_job(job_id, status="STOPPED")
        else:
            self.gcs.finish_job(
                job_id, status="SUCCEEDED" if rc == 0 else "FAILED")
            if record is not None:
                record.message = f"exit code {rc}"
        with self._lock:
            self._procs.pop(sub_id, None)

    def _record(self, sub_id: str) -> JobRecord | None:
        for record in self.gcs.list_jobs():
            if record.submission_id == sub_id:
                return record
        return None

    def status(self, sub_id: str) -> dict | None:
        record = self._record(sub_id)
        if record is None:
            return None
        return {"submission_id": record.submission_id,
                "status": record.status, "entrypoint": record.entrypoint,
                "message": record.message, "start_time": record.start_time,
                "end_time": record.end_time}

    def logs(self, sub_id: str, tail_bytes: int = 1 << 20) -> bytes:
        path = os.path.join(self.log_dir, f"{sub_id}.log")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - tail_bytes))
                return f.read()
        except FileNotFoundError:
            return b""

    def stop(self, sub_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(sub_id)
        if proc is None:
            return False
        # STOPPED first: the exit watcher reads it when the process ends.
        record = self._record(sub_id)
        if record is not None:
            record.status = "STOPPED"
            record.end_time = time.time()
        try:  # the whole session: an entrypoint may start children
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            proc.terminate()
        return True

    def list(self) -> list[dict]:
        return [self.status(r.submission_id)
                for r in self.gcs.list_jobs() if r.submission_id]

    def shutdown(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass  # the entrypoint has ended


class GcsServer:
    """The RPC face of the head's tables, jobs and channels."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 log_dir: str | None = None,
                 heartbeat_timeout_s: float | None = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = float(
                GLOBAL_CONFIG.gcs_heartbeat_timeout_s)
        if log_dir is None:
            import tempfile

            log_dir = os.path.join(tempfile.gettempdir(),
                                   f"ray_tpu_torch_head_{os.getpid()}")
        self.gcs = GlobalControlService()
        self.jobs = JobManager(self.gcs, os.path.join(log_dir, "jobs"))
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.object_directory = ObjectDirectory()
        self._pg_table: dict[str, list] = {}
        self._pg_lock = threading.Lock()
        self._server = RpcServer(host, port)
        self._shutdown = threading.Event()
        self.pubsub = ChannelHub()
        self.gcs.pubsub.subscribe("nodes", self._on_node_event)
        # The availability last published per node (change detection).
        self._last_published_avail: dict[str, dict] = {}
        self._avail_lock = threading.Lock()
        self._register_methods()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="ray_tpu_torch-gcs-monitor")

    @property
    def address(self) -> str:
        return self._server.address

    def _register_methods(self) -> None:
        s = self._server
        s.register("ping", lambda: "pong")
        s.register("kv_put", self.gcs.kv.put)
        s.register("kv_get", self.gcs.kv.get)
        s.register("kv_del", self.gcs.kv.delete)
        s.register("kv_exists", self.gcs.kv.exists)
        s.register("kv_keys", self.gcs.kv.keys)
        s.register("register_node", self._register_node)
        s.register("heartbeat", self._heartbeat)
        s.register("list_nodes", self._list_nodes)
        s.register("drain_node", self._drain_node)
        s.register("submit_job", self.jobs.submit)
        s.register("job_status", self.jobs.status)
        s.register("job_logs", self.jobs.logs)
        s.register("stop_job", self.jobs.stop)
        s.register("list_jobs", self.jobs.list)
        s.register("cluster_resources", self._cluster_resources)
        s.register("node_stats", self.gcs.node_stats)
        s.register("object_locations_update",
                   self.object_directory.update)
        s.register("list_object_locations",
                   self.object_directory.locations)
        s.register("actor_update", self._actor_update)
        s.register("list_cluster_actors", self._list_cluster_actors)
        s.register("pg_update", self._pg_update)
        s.register("list_cluster_placement_groups",
                   self._list_cluster_placement_groups)
        s.register("pubsub_subscribe", self.pubsub.subscribe)
        s.register("pubsub_unsubscribe", self.pubsub.unsubscribe)
        s.register("pubsub_publish", self.pubsub.publish)
        # A poll blocks: it runs off the connection's thread.
        s.register("pubsub_poll", self.pubsub.poll, concurrent=True)

    # ------------------------------------------------------------- nodes

    def _on_node_event(self, event) -> None:
        """Bridge membership onto the cluster channels; a death also
        prunes the node from the object directory and publishes the
        objects it was the last holder of."""
        kind, node_id = event
        if kind == "DEAD":
            orphaned = self.object_directory.prune_node(node_id.hex())
            if orphaned:
                self.pubsub.publish("object_loss", orphaned)
        self.pubsub.publish("nodes", (kind, node_id.hex()))

    def _register_node(self, address: str, resources: dict,
                       labels: dict | None = None,
                       executor_address: str = "",
                       prior_id: bytes | None = None) -> bytes:
        """``prior_id``: a node registering again asks to keep its id.
        Granted for an id this head never saw or a live record of the
        same address (a retried request); refused for an id the head
        declared dead, which comes back as a fresh node."""
        node_id = None
        if prior_id is not None:
            candidate = NodeID(prior_id)
            existing = self.gcs.get_node(candidate)
            if existing is None or (existing.alive
                                    and existing.address == address):
                node_id = candidate
        if node_id is None:
            node_id = NodeID()
        self.gcs.register_node(NodeRecord(
            node_id=node_id, address=address, resources=dict(resources),
            labels=dict(labels or {}), executor_address=executor_address))
        return node_id.binary()

    def _heartbeat(self, node_id_bytes: bytes,
                   available: dict | None = None,
                   stats: dict | None = None) -> bool:
        """False tells the agent its node is unknown or dead, and that
        it must register again."""
        accepted = self.gcs.heartbeat(NodeID(node_id_bytes), available)
        if accepted and stats is not None:
            self.gcs.record_node_stats(node_id_bytes.hex(), stats)
        if accepted and available is not None:
            # Only a change goes out: steady heartbeats publish nothing.
            hex_id = node_id_bytes.hex()
            with self._avail_lock:
                changed = self._last_published_avail.get(hex_id) \
                    != available
                if changed:
                    self._last_published_avail[hex_id] = dict(available)
            if changed:
                self.pubsub.publish("node_resources",
                                    (hex_id, dict(available)))
        return accepted

    def _list_nodes(self) -> list[dict]:
        return [{"node_id": r.node_id.hex(), "address": r.address,
                 "resources": dict(r.resources),
                 "available": dict(r.available), "labels": dict(r.labels),
                 "executor_address": r.executor_address, "alive": r.alive}
                for r in self.gcs.list_nodes()]

    def _drain_node(self, node_id_bytes: bytes) -> bool:
        self.gcs.mark_node_dead(NodeID(node_id_bytes))
        self.gcs.drop_node_stats(node_id_bytes.hex())
        return True

    def _cluster_resources(self) -> dict:
        total: dict[str, float] = {}
        for r in self.gcs.list_nodes():
            if r.alive:
                for k, v in r.resources.items():
                    total[k] = total.get(k, 0.0) + v
        return total

    # ------------------------------------------- actor and group mirrors

    def _actor_update(self, records: list) -> int:
        """Drivers' actor records (full upserts); a DEAD actor is never
        brought back. Returns how many were applied."""
        return sum(1 for plain in records
                   if self.gcs.upsert_actor_mirror(plain))

    def _list_cluster_actors(self) -> list[dict]:
        return [self.gcs.actor_plain(r) for r in self.gcs.list_actors()]

    def _pg_update(self, owner: str, records: list) -> int:
        """One driver's placement groups, whole (per owner, so drivers
        never overwrite each other's)."""
        with self._pg_lock:
            self._pg_table[owner] = list(records)
        return len(records)

    def _list_cluster_placement_groups(self) -> dict:
        with self._pg_lock:
            return {owner: list(records)
                    for owner, records in self._pg_table.items()}

    # --------------------------------------------------------- lifecycle

    def start(self) -> "GcsServer":
        self._server.start()
        self._monitor.start()
        return self

    def _monitor_loop(self) -> None:
        """Mark nodes dead whose heartbeats stopped; prune what dead
        nodes, silent owners and silent subscribers left behind."""
        while not self._shutdown.wait(min(1.0,
                                          self.heartbeat_timeout_s / 4)):
            now = time.monotonic()
            alive_ids = set()
            for record in self.gcs.list_nodes():
                if record.alive and (now - record.last_heartbeat
                                     > self.heartbeat_timeout_s):
                    self.gcs.mark_node_dead(record.node_id)
                elif record.alive:
                    alive_ids.add(record.node_id.hex())
            with self._avail_lock:
                for hex_id in list(self._last_published_avail):
                    if hex_id not in alive_ids:
                        del self._last_published_avail[hex_id]
            for hex_id in list(self.gcs.node_stats()):
                if hex_id not in alive_ids:
                    self.gcs.drop_node_stats(hex_id)
            self.object_directory.prune()
            self.pubsub.prune()

    def stop(self) -> None:
        self._shutdown.set()
        self.jobs.shutdown()
        self._server.stop()
        if self._monitor.is_alive():
            self._monitor.join(timeout=5.0)
