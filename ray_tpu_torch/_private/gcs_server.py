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
- a key-value store, and jobs: entrypoint processes with captured logs;
- with ``persist_path``, the durable head: every mutation of the hot set
  (KV, jobs, node table, actor registry, object directory with the
  spilled marks daemons report, placement groups) appends a WAL record,
  the whole set is snapshotted every ``gcs_snapshot_interval_s``, and a
  restart restores it (``gcs_persistence.py``). Each start mints a
  persisted epoch; every reply carries it, and a heartbeat, location,
  actor or group update stamped with an older one is refused typed
  (``StaleEpochError``) until its writer re-syncs. A dead node's id and
  a DEAD actor stay dead across restarts, and jobs left ``RUNNING`` are
  reported ``FAILED``. A failed persist write is counted and backs off
  for 5 s; it never stops the head.

Not ported, each with its ROADMAP item: the sharded tables; the metrics
history, its watchdog and the heartbeat-shipped trace spans (10c).
"""

from __future__ import annotations

import os
import pickle
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

# After a failed snapshot or WAL write the head leaves the disk alone for
# this long: durability degrades, the control plane goes on.
_PERSIST_BACKOFF_S = 5.0


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
                 heartbeat_timeout_s: float | None = None,
                 persist_path: str | None = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = float(
                GLOBAL_CONFIG.gcs_heartbeat_timeout_s)
        if log_dir is None:
            import tempfile

            log_dir = os.path.join(tempfile.gettempdir(),
                                   f"ray_tpu_torch_head_{os.getpid()}")
        # The head's KV in the native engine (reference: the GCS storage
        # layer is C++, in_memory_store_client.h:31) under gcs_kv_native.
        from ray_tpu_torch._private.gcs_kv_native import make_kv_store

        self.gcs = GlobalControlService(kv=make_kv_store())
        self.jobs = JobManager(self.gcs, os.path.join(log_dir, "jobs"))
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.object_directory = ObjectDirectory()
        self._pg_table: dict[str, list] = {}
        self._pg_version = 0
        self._pg_lock = threading.Lock()
        # Persistence. Armed: snapshot + WAL of the whole hot set and an
        # epoch minted per start. Disarmed (gcs_persistence off): the
        # legacy {kv, jobs} pickle, no epoch, no fencing.
        self._persist_path = persist_path
        self._persisted_version = None
        self._persist_armed = bool(persist_path) and bool(
            GLOBAL_CONFIG.gcs_persistence)
        self._fencing = self._persist_armed and bool(
            GLOBAL_CONFIG.gcs_epoch_fencing)
        self.epoch = 0
        self._wal = None
        self._wal_seq = 0
        self._persist_lock = threading.Lock()
        self._persist_backoff_until = 0.0
        self._last_snapshot_at = 0.0
        self._persist_stats = {
            "wal_records_written": 0, "wal_records_replayed": 0,
            "wal_replay_skipped": 0, "snapshots_written": 0,
            "snapshot_restore_ms": 0.0, "torn_wal_tails": 0,
            "torn_snapshots": 0, "persist_errors": 0,
            "fenced_writes": 0,
        }
        if self._persist_armed:
            from ray_tpu_torch._private import gcs_persistence as gp

            self.epoch = gp.mint_epoch(os.path.join(
                os.path.dirname(persist_path) or ".", "gcs_epoch"))
            self._restore_full()
            try:
                self._wal = gp.WalWriter(
                    persist_path + ".wal",
                    fsync=bool(GLOBAL_CONFIG.gcs_wal_fsync))
            except OSError:
                self._count_persist_error()
            # From here on every durable mutation appends its record
            # with its table's lock held.
            self.gcs.wal_emit = self._wal_append
            self.object_directory.wal_emit = self._wal_append
        elif persist_path:
            self._restore_snapshot()
        self._server = RpcServer(host, port)
        if self._fencing:
            # Every reply carries the epoch: daemons and drivers see a
            # restart on any call.
            self._server.reply_meta_fn = lambda: {"epoch": self.epoch}
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
        s.register("kv_put", self._kv_put)
        s.register("kv_get", self.gcs.kv.get)
        s.register("kv_del", self._kv_del)
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
        s.register("object_locations_update", self._object_locations_update)
        s.register("list_object_locations", self._list_object_locations)
        s.register("actor_update", self._actor_update)
        s.register("list_cluster_actors", self._list_cluster_actors)
        s.register("pg_update", self._pg_update)
        s.register("list_cluster_placement_groups",
                   self._list_cluster_placement_groups)
        s.register("gcs_epoch", lambda: self.epoch)
        s.register("gcs_persist_stats", self.persist_stats)
        s.register("pubsub_subscribe", self.pubsub.subscribe)
        s.register("pubsub_unsubscribe", self.pubsub.unsubscribe)
        s.register("pubsub_publish", self.pubsub.publish)
        # A poll blocks: it runs off the connection's thread.
        s.register("pubsub_poll", self.pubsub.poll, concurrent=True)

    # ------------------------------------------------------------- nodes

    def _on_node_event(self, event) -> None:
        """Bridge membership onto the cluster channels; a death also
        prunes the node (and its spilled marks) from the object
        directory and publishes the objects it was the last holder of."""
        kind, node_id = event
        if kind == "DEAD":
            orphaned = self.object_directory.prune_node(node_id.hex())
            if orphaned:
                self.pubsub.publish("object_loss", orphaned)
        self.pubsub.publish("nodes", (kind, node_id.hex()))

    def _register_node(self, address: str, resources: dict,
                       labels: dict | None = None,
                       executor_address: str = "",
                       prior_id: bytes | None = None,
                       host_id: str = "") -> bytes:
        """``prior_id``: a node registering again asks to keep its id.
        Granted for an id this head never saw or a live record of the
        same address (a retried request, or a daemon re-syncing after a
        restart restored its record); refused for an id the head
        declared dead, now or before a restart: it comes back as a fresh
        node."""
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
            labels=dict(labels or {}), executor_address=executor_address,
            host_id=host_id))
        return node_id.binary()

    def _heartbeat(self, node_id_bytes: bytes,
                   available: dict | None = None,
                   stats: dict | None = None,
                   trace: dict | None = None,
                   epoch: int | None = None) -> bool:
        """False tells the agent its node is unknown or dead, and that
        it must register again. A beat stamped with an earlier epoch is
        refused typed first. ``trace`` is the reference's span piggyback
        (not ported: ignored)."""
        self._check_epoch(epoch, "heartbeat")
        accepted = self.gcs.heartbeat(NodeID(node_id_bytes), available)
        if accepted and stats is not None:
            # The daemon's spill tier reports its spilled and restored
            # copies: deltas for the directory, not stats.
            events = stats.pop("spill_events", None)
            node_hex = node_id_bytes.hex()
            for owner, obj_hex, kind in events or ():
                if kind == "spilled":
                    self.object_directory.mark_spilled(owner, obj_hex,
                                                       node_hex)
                else:
                    self.object_directory.clear_spilled(owner, obj_hex)
            self.gcs.record_node_stats(node_hex, stats)
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
                 "executor_address": r.executor_address,
                 "host_id": r.host_id, "alive": r.alive}
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

    # ------------------------------------------------------------ objects

    def _object_locations_update(self, owner: str, adds: list,
                                 removes: list,
                                 epoch: int | None = None) -> int:
        """One owner's location deltas (empty: a keepalive). An owner of
        an earlier epoch is refused typed, so its deltas never land in a
        restored directory; it re-syncs and publishes everything."""
        self._check_epoch(epoch, "object_locations_update")
        return self.object_directory.update(owner, adds, removes)

    def _list_object_locations(self, owner: str | None = None,
                               include_spilled: bool = False):
        """The holders, and with ``include_spilled`` the spilled marks
        beside them."""
        locations = self.object_directory.locations(owner)
        if not include_spilled:
            return locations
        return (locations, self.object_directory.spilled(owner))

    # ------------------------------------------- actor and group mirrors

    def _actor_update(self, records: list,
                      epoch: int | None = None) -> int:
        """Drivers' actor records (full upserts). A stale epoch is
        refused typed, and a DEAD actor is never brought back by any
        publish. Returns how many were applied."""
        self._check_epoch(epoch, "actor_update")
        return sum(1 for plain in records
                   if self.gcs.upsert_actor_mirror(plain))

    def _list_cluster_actors(self) -> list[dict]:
        return [self.gcs.actor_plain(r) for r in self.gcs.list_actors()]

    def _pg_update(self, owner: str, records: list,
                   epoch: int | None = None) -> int:
        """One driver's placement groups, whole (per owner, so drivers
        never overwrite each other's)."""
        self._check_epoch(epoch, "pg_update")
        with self._pg_lock:
            self._pg_table[owner] = list(records)
            self._pg_version += 1
            if self._wal is not None:
                self._wal_append(("pg_owner", owner, list(records)))
        return len(records)

    def _list_cluster_placement_groups(self) -> dict:
        with self._pg_lock:
            return {owner: list(records)
                    for owner, records in self._pg_table.items()}

    # ------------------------------------------------------ epoch fence

    def _check_epoch(self, epoch: int | None, site: str) -> None:
        """Refuse a write stamped with an earlier incarnation's epoch.
        An unstamped write (a writer that has learned no epoch yet, or a
        cluster without fencing) passes."""
        if epoch is None or not self._fencing or epoch == self.epoch:
            return
        from ray_tpu_torch._private.gcs import StaleEpochError

        with self._persist_lock:
            self._persist_stats["fenced_writes"] += 1
        raise StaleEpochError(self.epoch, epoch)

    # ------------------------------------------------------------ the WAL

    def _kv_put(self, key: bytes, value: bytes,
                namespace: str = "default", overwrite: bool = True) -> bool:
        ok = self.gcs.kv.put(key, value, namespace, overwrite)
        if ok and self._wal is not None:
            self._wal_append(("kv_put", namespace, key, value))
        return ok

    def _kv_del(self, key: bytes, namespace: str = "default") -> bool:
        existed = self.gcs.kv.delete(key, namespace)
        if existed and self._wal is not None:
            self._wal_append(("kv_del", namespace, key))
        return existed

    def _wal_append(self, op: tuple) -> None:
        """Append one mutation (from the table mutators, their lock
        held). A failed append is counted and backs off; the next
        snapshot covers what it lost."""
        wal = self._wal
        if wal is None:
            return
        with self._persist_lock:
            if time.monotonic() < self._persist_backoff_until:
                return
            self._wal_seq += 1
            seq = self._wal_seq
        try:
            wal.append(seq, pickle.dumps(op,
                                         protocol=pickle.HIGHEST_PROTOCOL))
        except OSError:
            self._count_persist_error()
            return
        with self._persist_lock:
            self._persist_stats["wal_records_written"] += 1

    def _apply_wal_op(self, op: tuple) -> None:
        kind = op[0]
        if kind == "kv_put":
            _, namespace, key, value = op
            self.gcs.kv.put(key, value, namespace)
        elif kind == "kv_del":
            _, namespace, key = op
            self.gcs.kv.delete(key, namespace)
        elif kind in ("actor", "node", "job"):
            self.gcs.apply_op(op)
        elif kind == "dir_update":
            _, owner, adds, removes = op
            self.object_directory.update(owner, adds, removes)
        elif kind == "dir_spill":
            _, owner, obj_hex, node_hex = op
            self.object_directory.mark_spilled(owner, obj_hex, node_hex)
        elif kind == "dir_unspill":
            _, owner, obj_hex = op
            self.object_directory.clear_spilled(owner, obj_hex)
        elif kind == "dir_prune_node":
            self.object_directory.prune_node(op[1])
        elif kind == "pg_owner":
            _, owner, records = op
            with self._pg_lock:
                self._pg_table[owner] = list(records)
                self._pg_version += 1

    def _count_persist_error(self) -> None:
        with self._persist_lock:
            self._persist_stats["persist_errors"] += 1
            self._persist_backoff_until = (time.monotonic()
                                           + _PERSIST_BACKOFF_S)

    def persist_stats(self) -> dict:
        """The persistence counters, the live epoch and the switches."""
        with self._persist_lock:
            out = dict(self._persist_stats)
        out["epoch"] = self.epoch
        out["armed"] = self._persist_armed
        out["fencing"] = self._fencing
        return out

    # --------------------------------------------------------- snapshots

    def _dirty_version(self):
        """The persisted tables' change counters (the job statuses too:
        the job manager edits records in place)."""
        with self._pg_lock:
            pg_version = self._pg_version
        return (self.gcs.kv.version, dict(self.gcs.table_versions),
                self.object_directory.version, pg_version,
                tuple(sorted((r.submission_id, r.status, r.message)
                             for r in self.gcs.list_jobs())))

    def _persist_tick(self, force: bool = False) -> None:
        """Armed: the WAL already holds every mutation, so the whole
        snapshot lands every ``gcs_snapshot_interval_s``, when the WAL
        passes ``gcs_wal_max_mb``, or at shutdown, and the WAL rotates.
        Disarmed: the legacy snapshot whenever the KV or a job moved."""
        if not self._persist_armed:
            self._save_snapshot()
            return
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        now = time.monotonic()
        with self._persist_lock:
            if now < self._persist_backoff_until:
                return
        wal_over = (self._wal is not None and self._wal.size()
                    > float(GLOBAL_CONFIG.gcs_wal_max_mb) * 1024 * 1024)
        interval = float(GLOBAL_CONFIG.gcs_snapshot_interval_s)
        if not force and not wal_over \
                and now - self._last_snapshot_at < interval:
            return
        if self._dirty_version() == self._persisted_version \
                and not wal_over:
            self._last_snapshot_at = now
            return
        self._save_snapshot_full()

    def _save_snapshot_full(self) -> None:
        from ray_tpu_torch._private import gcs_persistence as gp
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        version = self._dirty_version()
        # The seq taken before the dump: a mutation landing between the
        # two is in the snapshot and replayed too (harmless: upserts).
        with self._persist_lock:
            wal_seq = self._wal_seq
        with self._pg_lock:
            pgs = {o: list(r) for o, r in self._pg_table.items()}
        state = {"format": 2, "wal_seq": wal_seq, "epoch": self.epoch,
                 "kv": self.gcs.kv.snapshot(),
                 **self.gcs.control_snapshot(),
                 "directory": self.object_directory.snapshot_state(),
                 "placement_groups": pgs}
        try:
            gp.write_snapshot(
                self._persist_path,
                pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL),
                fsync=bool(GLOBAL_CONFIG.gcs_wal_fsync))
            if self._wal is not None:
                self._wal.rotate()
        except OSError:
            self._count_persist_error()
            return
        self._persisted_version = version
        self._last_snapshot_at = time.monotonic()
        with self._persist_lock:
            self._persist_stats["snapshots_written"] += 1

    def _restore_full(self) -> None:
        """The newest good snapshot (current, else ``.prev``), then both
        WAL generations, seq-gated, torn tails truncated and counted."""
        from ray_tpu_torch._private import gcs_persistence as gp

        t0 = time.perf_counter()
        state = None
        for path in (self._persist_path, self._persist_path + ".prev"):
            try:
                state = pickle.loads(gp.read_snapshot(path))
                break
            except gp.TornSnapshotError:
                with self._persist_lock:
                    self._persist_stats["torn_snapshots"] += 1
            except gp.LegacySnapshotError:
                # A raw {kv, jobs} pickle of a disarmed head: load it,
                # then persist forward in the framed format.
                self._restore_snapshot()
                return
            except FileNotFoundError:
                continue  # a first start
            except (OSError, EOFError, pickle.UnpicklingError):
                with self._persist_lock:
                    self._persist_stats["persist_errors"] += 1
                continue
        base_seq = 0
        if state is not None:
            base_seq = int(state.get("wal_seq", 0))
            self.gcs.kv.restore(state.get("kv", {}))
            self.gcs.restore_control(state)
            self.object_directory.restore_state(
                state.get("directory") or {})
            with self._pg_lock:
                self._pg_table.update(state.get("placement_groups") or {})
        replayed = skipped = torn = 0
        last_seq = base_seq
        for wal_path in (self._persist_path + ".wal.prev",
                         self._persist_path + ".wal"):
            stats = gp.replay_wal(wal_path, base_seq, self._apply_wal_op)
            replayed += stats["replayed"]
            skipped += stats["skipped"]
            torn += stats["truncated"]
            last_seq = max(last_seq, stats["last_seq"])
        self._wal_seq = last_seq
        # The entrypoints of jobs left RUNNING died with the old head.
        for record in self.gcs.list_jobs():
            if record.status == "RUNNING":
                self.gcs.finish_job(record.job_id, status="FAILED")
        with self._persist_lock:
            self._persist_stats["wal_records_replayed"] += replayed
            self._persist_stats["wal_replay_skipped"] += skipped
            self._persist_stats["torn_wal_tails"] += torn
            self._persist_stats["snapshot_restore_ms"] = round(
                (time.perf_counter() - t0) * 1000.0, 3)

    def _save_snapshot(self) -> None:
        """The disarmed head's snapshot: a raw pickle of {kv, jobs},
        swapped in atomically; a failed write is counted and backs off."""
        if time.monotonic() < self._persist_backoff_until:
            return
        version = (self.gcs.kv.version,
                   tuple(sorted((r.submission_id, r.status)
                                for r in self.gcs.list_jobs())))
        if version == self._persisted_version:
            return
        state = {"kv": self.gcs.kv.snapshot(),
                 "jobs": [{"job_id": r.job_id.binary(), "status": r.status,
                           "entrypoint": r.entrypoint,
                           "message": r.message,
                           "submission_id": r.submission_id,
                           "start_time": r.start_time,
                           "end_time": r.end_time}
                          for r in self.gcs.list_jobs()]}
        tmp = self._persist_path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self._persist_path)
            self._persisted_version = version
        except OSError:
            self._count_persist_error()

    def _restore_snapshot(self) -> None:
        try:
            with open(self._persist_path, "rb") as f:
                state = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):
            return
        self.gcs.kv.restore(state.get("kv", {}))
        for j in state.get("jobs", []):
            # Entrypoints did not survive the restart.
            self.gcs.register_job(JobRecord(
                job_id=JobID(j["job_id"]), entrypoint=j["entrypoint"],
                message=j["message"], submission_id=j["submission_id"],
                start_time=j["start_time"], end_time=j["end_time"],
                status="FAILED" if j["status"] == "RUNNING"
                else j["status"]))

    # --------------------------------------------------------- lifecycle

    def start(self) -> "GcsServer":
        self._server.start()
        self._monitor.start()
        return self

    def _monitor_loop(self) -> None:
        """Mark nodes dead whose heartbeats stopped; prune what dead
        nodes, silent owners and silent subscribers left behind; persist
        when due."""
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
            if self._persist_path:
                self._persist_tick()

    def stop(self) -> None:
        """A clean stop: a last snapshot, then the transport."""
        self._shutdown.set()
        self.jobs.shutdown()
        if self._persist_path:
            self._persist_tick(force=True)
        if self._wal is not None:
            self._wal.close()
        self._server.stop()
        if self._monitor.is_alive():
            self._monitor.join(timeout=5.0)

    def crash(self) -> None:
        """The SIGKILL shape in this process: the transport and the
        monitor stop, with no last snapshot and the WAL as it stands (a
        killed process appends nothing more: the hooks are detached)."""
        self._shutdown.set()
        self.gcs.wal_emit = None
        self.object_directory.wal_emit = None
        wal, self._wal = self._wal, None
        if wal is not None:
            wal.close()
        self._server.stop()
        if self._monitor.is_alive():
            self._monitor.join(timeout=5.0)
