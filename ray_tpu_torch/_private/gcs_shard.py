"""The sharded head: ``gcs_shards`` in-head domains for the hot tables.

The port of ``ray_tpu/_private/gcs_shard.py``. The shards stay in the
head process: what they buy is fault isolation and lock-domain
parallelism, not placement on other hosts.

- A stable CRC32 router (``shard_of``) sends every node, object and
  task id to its shard. CRC32 over the raw bytes, not Python's
  ``hash()`` (salted per process): a router that moved keys across
  restarts would misroute the restored directory.
- Each shard has its own lock, its own RGW1-framed WAL and snapshot
  segment (``<snapshot>.shard<i>``, ``<snapshot>.shard<i>.wal``) and its
  own persisted epoch (``gcs_epoch_shard<i>``), so one shard
  crash-restarts alone, replaying only its WAL and fencing its stale
  writers with ``StaleEpochError``, while the others serve on.
- Degraded mode: a stalled shard serves its stale in-memory view
  (``age_s`` in its stats row) and queues writes, WAL-durable when
  queued so an acknowledged write survives a crash during the stall,
  and sheds ``SystemOverloadedError`` past
  ``gcs_shard_max_queued_writes``: it never hangs and never loses an
  acknowledged write.
- A changed count over a persisted layout is refused typed
  (``ReshardError``, gcs_persistence.py): a changed ring would misroute
  the whole directory.

With ``gcs_shards=1`` (the default) the head keeps its single snapshot
and WAL byte for byte; ``SHARDS_ON`` is the gate. The reference takes a
lock-witness lock per domain; the witness is not ported yet (ROADMAP
item 12), so these are plain ``threading.Lock``s.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
import zlib

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private import gcs_persistence as gp

# The gate of the ``gcs_shards`` key, latched by the head's boot through
# init_from_config(); hot paths branch on the shard state captured at
# construction, construction branches on this.
SHARDS_ON: bool = False
_SHARD_COUNT: int = 1

_MB = 1024 * 1024

# The per-shard stats row: ShardState.stats() builds it and
# metrics_agent.py exports each key as one
# ray_tpu_torch_gcs_shard{shard=,key=} gauge sample.
GCS_SHARD_STAT_KEYS = (
    "epoch",
    "wal_records_written",
    "wal_records_replayed",
    "snapshots_written",
    "restores",
    "fenced_writes",
    "queued_writes",
    "shed_writes",
    "age_s",
)


def init_from_config() -> int:
    """One-time arming read at head/GCS construction: latch the
    configured shard count and flip the gate."""
    global SHARDS_ON, _SHARD_COUNT
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    count = max(1, int(GLOBAL_CONFIG.gcs_shards))
    _SHARD_COUNT = count
    SHARDS_ON = count > 1
    return count


def shard_count() -> int:
    return _SHARD_COUNT


def shard_of(key: str, count: int | None = None) -> int:
    """Stable router: id hex / owner string -> shard index. Same id,
    same shard, every process and every incarnation."""
    if count is None:
        count = _SHARD_COUNT
    if count <= 1:
        return 0
    return zlib.crc32(key.encode()) % count


def apply_dir_op(directory, op: tuple):
    """Apply one WAL'd directory op to a shard's ObjectDirectory.
    Restore replay and the degraded-mode queue drain share this
    dispatch (the caller detaches/never-attached the WAL hook, so an
    already-durable op is not re-framed)."""
    kind = op[0]
    if kind == "dir_update":
        return directory.update(op[1], op[2], op[3])
    if kind == "dir_spill":
        return directory.mark_spilled(op[1], op[2], op[3])
    if kind == "dir_unspill":
        return directory.clear_spilled(op[1], op[2])
    if kind == "dir_prune_node":
        return directory.prune_node(op[1])
    raise ValueError(f"unknown shard wal op {kind!r}")


class NodeStatsShard:
    """One shard's slice of the heartbeat-piggybacked node-stats table:
    its own lock domain so record_node_stats lands without a
    global-lock pass. Volatile — repopulated by the next heartbeat."""

    def __init__(self, index: int):
        self.index = index
        self.lock = threading.Lock()
        # node hex -> (stats dict, monotonic received-at)
        self.rows: dict = {}


class TaskEventShard:
    """One shard's slice of the bounded task-event table (events and
    the per-shard drop counter). Volatile."""

    def __init__(self, index: int, limit: int):
        self.index = index
        self.lock = threading.Lock()
        self.events: dict = {}
        self.dropped = 0
        self.limit = limit


class ShardState:
    """One in-head shard domain: its slice of the object directory plus
    its own lock domain, WAL + snapshot segment, persisted incarnation
    epoch, and the degraded-mode (stall) write queue. gcs_server.py
    routes ops here and owns fencing/chaos; this class owns the
    mechanics."""

    def __init__(self, index: int, count: int, persist_path: str, *,
                 fsync: bool = False, queue_cap: int = 512):
        from ray_tpu_torch._private.gcs import ObjectDirectory

        self.index = index
        self.count = count
        self.snap_path = f"{persist_path}.shard{index}"
        self.wal_path = f"{persist_path}.shard{index}.wal"
        base_dir = os.path.dirname(persist_path) or "."
        self.epoch_path = os.path.join(base_dir, f"gcs_epoch_shard{index}")
        self.fsync = fsync
        self.queue_cap = queue_cap
        self.lock = threading.Lock()
        self.directory = ObjectDirectory()
        self.on_persist_error = None  # set by gcs_server: shared backoff
        self.epoch = 0
        self.wal = None
        self.wal_seq = 0
        self.persisted_version = -1
        self.last_snapshot_at = 0.0
        self.wal_records_written = 0
        self.wal_records_replayed = 0
        self.snapshots_written = 0
        self.restores = 0
        self.fenced_writes = 0
        self.shed_writes = 0
        self.stalled_until = 0.0
        self.stalled_since = 0.0
        self._queue: list = []

    # ------------------------------------------------------ persistence

    def boot(self) -> int:
        """First start of this head incarnation: mint the shard epoch,
        restore this shard's snapshot + WAL segment ONLY, then open the
        WAL and hook the directory's mutation stream into it."""
        with self.lock:
            self.epoch = gp.mint_epoch(self.epoch_path)
            replayed = self._restore_locked()
            self._open_wal_locked()
            return replayed

    def crash_restart(self, reason: str) -> int:
        """Shard crash + independent recovery: drop the in-memory
        domain, mint the NEXT persisted shard epoch (the fencing token
        — stale writers get typed StaleEpochError), rebuild from this
        shard's segment. Queued degraded-mode writes are already
        WAL-durable; the replay here is what keeps their acks honest."""
        from ray_tpu_torch._private.gcs import ObjectDirectory

        with self.lock:
            if self.wal is not None:
                self.wal.close()
                self.wal = None
            self._queue = []
            self.stalled_until = 0.0
            self.stalled_since = 0.0
            self.directory = ObjectDirectory()
            self.persisted_version = -1
            self.epoch = gp.mint_epoch(self.epoch_path)
            replayed = self._restore_locked()
            self._open_wal_locked()
            self.restores += 1
        flight_recorder.record("gcs.shard_restore", self.index, replayed,
                               reason)
        return replayed

    def _restore_locked(self) -> int:
        state = None
        for path in (self.snap_path, f"{self.snap_path}.prev"):
            try:
                state = pickle.loads(gp.read_snapshot(path))
                break
            except FileNotFoundError:
                continue
            except (gp.TornSnapshotError, gp.LegacySnapshotError,
                    OSError, EOFError, pickle.UnpicklingError):
                # Torn/unreadable shard snapshot: reject-don't-crash —
                # flight-record it and fall back to .prev + WAL replay
                # (same discipline as the head's full snapshot).
                flight_recorder.record("gcs.torn_snapshot", path,
                                       self.index)
                continue
        base_seq = 0
        if state is not None:
            recorded = int(state.get("gcs_shards", 0))
            if recorded != self.count:
                raise gp.ReshardError(recorded, self.count)
            base_seq = int(state.get("wal_seq", 0))
            self.directory.restore_state(state.get("directory") or {})
        replayed = 0
        last_seq = base_seq
        for wal_path in (f"{self.wal_path}.prev", self.wal_path):
            stats = gp.replay_wal(
                wal_path, base_seq,
                lambda op: apply_dir_op(self.directory, op))
            replayed += stats["replayed"]
            last_seq = max(last_seq, stats["last_seq"])
        self.wal_seq = last_seq
        self.wal_records_replayed += replayed
        return replayed

    def _open_wal_locked(self) -> None:
        self.wal = gp.WalWriter(self.wal_path, fsync=self.fsync)
        self.directory.wal_emit = self._wal_append

    def _wal_append(self, op: tuple) -> None:
        # Reached via ObjectDirectory._mutated with this shard's lock
        # held (every shard mutation funnels through gcs_server under
        # self.lock), so the seq is single-writer by construction.
        if self.wal is None:
            return
        self.wal_seq += 1
        try:
            self.wal.append(self.wal_seq,
                            pickle.dumps(op, pickle.HIGHEST_PROTOCOL))
        except OSError:
            if self.on_persist_error is not None:
                self.on_persist_error(f"shard{self.index}_wal")
            return
        self.wal_records_written += 1

    def maybe_snapshot(self, interval_s: float, max_wal_mb: float,
                       fsync: bool, force: bool = False) -> bool:
        """Periodic per-shard snapshot + WAL rotate (the head's persist
        tick fans out here). A wedged (stalled) domain is skipped —
        its durability rides the WAL until it heals."""
        now = time.monotonic()
        with self.lock:
            if self._stall_active_locked():
                return False
            wal_over = (self.wal is not None
                        and self.wal.size() > max_wal_mb * _MB)
            if not force and not wal_over \
                    and now - self.last_snapshot_at < interval_s:
                return False
            version = self.directory.version
            if not force and not wal_over \
                    and version == self.persisted_version:
                self.last_snapshot_at = now
                return False
            state = {
                "format": 1,
                "shard": self.index,
                "gcs_shards": self.count,
                "wal_seq": self.wal_seq,
                "epoch": self.epoch,
                "directory": self.directory.snapshot_state(),
            }
            payload = pickle.dumps(state, pickle.HIGHEST_PROTOCOL)
            try:
                gp.write_snapshot(self.snap_path, payload, fsync=fsync)
                if self.wal is not None:
                    self.wal.rotate()
            except OSError:
                if self.on_persist_error is not None:
                    self.on_persist_error(f"shard{self.index}_snapshot")
                return False
            self.persisted_version = version
            self.last_snapshot_at = now
            self.snapshots_written += 1
            return True

    def close(self) -> None:
        with self.lock:
            self._drain_locked()
            if self.wal is not None:
                self.wal.close()
                self.wal = None
            self.directory.wal_emit = None

    # ---------------------------------------------------- degraded mode

    def stall(self, duration_s: float) -> None:
        """Open (or extend) this shard's degraded window: reads keep
        serving the stale view, writes queue WAL-first."""
        with self.lock:
            now = time.monotonic()
            if now >= self.stalled_until:
                self.stalled_since = now
            self.stalled_until = max(self.stalled_until, now + duration_s)

    def stall_active(self) -> bool:
        with self.lock:
            return self._stall_active_locked()

    def _stall_active_locked(self) -> bool:
        # Heals lazily: the first check past the deadline drains the
        # queued writes into the live tables (ops already WAL'd, so the
        # emit hook is detached during the drain).
        if self.stalled_until <= 0.0:
            return False
        if time.monotonic() < self.stalled_until:
            return True
        self._drain_locked()
        self.stalled_until = 0.0
        self.stalled_since = 0.0
        return False

    def heal_tick(self) -> None:
        """Monitor-thread hook: bound post-stall staleness to one tick
        instead of waiting for the next write to trigger the drain."""
        with self.lock:
            self._stall_active_locked()

    def enqueue_locked(self, op: tuple) -> None:
        """Degraded-mode write (caller holds self.lock): WAL it NOW —
        the ack must survive even a crash during the stall — and queue
        the in-memory apply for heal. Past the cap the write sheds
        typed: never hang, never queue unboundedly, never drop an ack."""
        from ray_tpu_torch.exceptions import SystemOverloadedError

        if len(self._queue) >= self.queue_cap:
            self.shed_writes += 1
            flight_recorder.record("gcs.shard_backoff", self.index,
                                   "shed", len(self._queue))
            raise SystemOverloadedError(
                f"gcs shard {self.index} degraded: "
                f"{len(self._queue)} queued writes at cap",
                retry_after_s=max(
                    0.1, self.stalled_until - time.monotonic()))
        self._wal_append(op)
        self._queue.append(op)
        flight_recorder.record("gcs.shard_backoff", self.index,
                               len(self._queue))

    def queue_len(self) -> int:
        with self.lock:
            return len(self._queue)

    def _drain_locked(self) -> None:
        if not self._queue:
            return
        ops, self._queue = self._queue, []
        emit = self.directory.wal_emit
        self.directory.wal_emit = None
        try:
            for op in ops:
                apply_dir_op(self.directory, op)
        finally:
            self.directory.wal_emit = emit

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """One shard's live GCS_SHARD_STAT_KEYS row."""
        with self.lock:
            now = time.monotonic()
            stalled = 0.0 < now < self.stalled_until
            return {
                "epoch": self.epoch,
                "wal_records_written": self.wal_records_written,
                "wal_records_replayed": self.wal_records_replayed,
                "snapshots_written": self.snapshots_written,
                "restores": self.restores,
                "fenced_writes": self.fenced_writes,
                "queued_writes": len(self._queue),
                "shed_writes": self.shed_writes,
                "age_s": (now - self.stalled_since) if stalled else 0.0,
            }
