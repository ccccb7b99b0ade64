"""The head's durable state: checksummed snapshots and a write-ahead log.

The port of ``ray_tpu/_private/gcs_persistence.py``, byte for byte in
its frame layouts (each package reads the other's files). Every byte
that is read back is guarded by a length and a CRC32, so a crash can
tear a file but a restore never loads garbage.

- **Snapshot** (``RGS1``): the head's whole hot set (KV, jobs, node
  table, actor registry, object directory with its spilled marks,
  placement groups), pickled behind a 16-byte header (magic, payload
  length as u64 LE, CRC32), written tmp-then-rename with the previous
  good snapshot rotated to ``<path>.prev``. A torn snapshot (a crash
  mid-write, or the ``gcs.torn_snapshot`` chaos site) fails its check
  and the restore falls back to ``.prev``.
- **WAL** (``RGW1``): between snapshots each table mutation appends one
  ``(seq, op)`` record framed magic, seq, length, CRC32. Records are
  whole-record upserts, so replay is idempotent; a snapshot stores the
  seq it covers (``wal_seq``) and restore applies only later records.
  A torn tail (a SIGKILL mid-append, or the ``gcs.torn_wal`` site) is
  found by the frame check, truncated in place and counted.

After a snapshot commits the live WAL rotates to ``<wal>.prev``, so a
restore reads the current snapshot (else ``.prev``), then ``wal.prev``
and ``wal``, seq-gated.

A sharded head (``gcs_shards`` > 1, gcs_shard.py) writes the same two
frames per shard: ``<path>.shard<i>`` and ``<path>.shard<i>.wal``. Its
restore raises ``ReshardError`` when the layout on disk was written
under another count: a snapshot records the count it was written with,
and a WAL-only layout is judged by its segment indices and by
directory entries in the single WAL.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib

_SNAP_MAGIC = b"RGS1"
_SNAP_HEADER = struct.Struct("<4sQI")       # magic, payload len, crc32
_WAL_MAGIC = b"RGW1"
_WAL_HEADER = struct.Struct("<4sQQI")       # magic, seq, payload len, crc32


class TornSnapshotError(Exception):
    """A snapshot failed its magic, length or CRC check: the caller falls
    back to the previous good snapshot (and the WAL), never loads it."""


class LegacySnapshotError(Exception):
    """The file predates the framed format (a raw-pickle ``{kv, jobs}``
    snapshot): the caller may use the legacy loader."""


class ReshardError(Exception):
    """The persisted layout was written under another ``gcs_shards``
    count than the one configured: loading it would misroute entries."""

    def __init__(self, recorded, configured):
        super().__init__(
            f"persisted GCS layout has gcs_shards={recorded} but "
            f"gcs_shards={configured} is configured — resharding an "
            f"existing layout is refused (would misroute restored "
            f"entries); restart with gcs_shards={recorded} or use a "
            f"fresh persist path")
        self.recorded = recorded
        self.configured = configured


# ----------------------------------------------------------------- snapshots


def write_snapshot(path: str, payload: bytes, fsync: bool = False) -> None:
    """Write ``payload`` behind the RGS1 header, tmp-then-rename, with the
    previous good snapshot rotated to ``<path>.prev`` first. OSErrors
    propagate: the caller counts them and backs off."""
    from ray_tpu_torch._private import chaos

    torn = (chaos.ACTIVE is not None
            and chaos.ACTIVE.should("gcs.torn_snapshot"))
    header = _SNAP_HEADER.pack(_SNAP_MAGIC, len(payload),
                               zlib.crc32(payload) & 0xFFFFFFFF)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload[:len(payload) // 2] if torn else payload)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if os.path.exists(path):
        # ``.prev`` stays a good fallback: a torn current is discarded,
        # never rotated over the last good generation.
        try:
            read_snapshot(path)
        except LegacySnapshotError:
            os.replace(path, path + ".prev")  # readable: keep it
        except (TornSnapshotError, OSError):
            try:
                os.unlink(path)
            except OSError:
                pass  # already gone
        else:
            os.replace(path, path + ".prev")
    os.replace(tmp, path)


def read_snapshot(path: str) -> bytes:
    """Read and check one snapshot. Raises TornSnapshotError on a length
    or CRC mismatch, LegacySnapshotError without the magic, OSError when
    the file cannot be read."""
    with open(path, "rb") as f:
        header = f.read(_SNAP_HEADER.size)
        if len(header) < _SNAP_HEADER.size:
            raise TornSnapshotError(f"{path}: short header")
        magic, length, crc = _SNAP_HEADER.unpack(header)
        if magic != _SNAP_MAGIC:
            raise LegacySnapshotError(path)
        payload = f.read(length + 1)
    if len(payload) != length:
        raise TornSnapshotError(
            f"{path}: payload {len(payload)} != header {length}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TornSnapshotError(f"{path}: CRC mismatch")
    return payload


# ----------------------------------------------------------------------- WAL


class WalWriter:
    """The append-only framed WAL: one writer per head. The caller orders
    the appends (the table locks); a lock of its own guards the file
    across ``rotate()``."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._f = open(path, "ab")

    def append(self, seq: int, payload: bytes) -> None:
        """Frame and append one record, flushed to the OS: a SIGKILL
        loses at most the append in flight (restore truncates it)."""
        from ray_tpu_torch._private import chaos

        torn = (chaos.ACTIVE is not None
                and chaos.ACTIVE.should("gcs.torn_wal"))
        header = _WAL_HEADER.pack(_WAL_MAGIC, seq, len(payload),
                                  zlib.crc32(payload) & 0xFFFFFFFF)
        with self._lock:
            self._f.write(header)
            self._f.write(payload[:len(payload) // 2] if torn else payload)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())

    def size(self) -> int:
        with self._lock:
            try:
                return self._f.tell()
            except (OSError, ValueError):
                return 0

    def rotate(self) -> None:
        """Move the live WAL to ``<path>.prev`` (its records are covered
        by the snapshot that just committed) and open a fresh one."""
        with self._lock:
            self._f.close()
            os.replace(self.path, self.path + ".prev")
            self._f = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass  # already closed


def replay_wal(path: str, min_seq: int, apply_fn) -> dict:
    """Call ``apply_fn(op)`` for each record of ``path`` whose
    ``seq > min_seq``. A framing violation (short header, bad magic,
    short payload, CRC mismatch, undecodable payload) is a torn tail: the
    file is truncated at the last good record and replay stops. Returns
    ``{replayed, skipped, truncated, last_seq}``."""
    stats = {"replayed": 0, "skipped": 0, "truncated": 0,
             "last_seq": min_seq}
    try:
        f = open(path, "r+b")
    except OSError:
        return stats
    with f:
        good_end = 0
        while True:
            header = f.read(_WAL_HEADER.size)
            if not header:
                break  # clean end
            if len(header) < _WAL_HEADER.size:
                stats["truncated"] = 1
                break
            magic, seq, length, crc = _WAL_HEADER.unpack(header)
            if magic != _WAL_MAGIC:
                stats["truncated"] = 1
                break
            payload = f.read(length)
            if len(payload) != length \
                    or zlib.crc32(payload) & 0xFFFFFFFF != crc:
                stats["truncated"] = 1
                break
            try:
                op = pickle.loads(payload)
            except Exception:  # noqa: BLE001 — undecodable is torn
                stats["truncated"] = 1
                break
            good_end = f.tell()
            if seq <= min_seq:
                stats["skipped"] += 1
                continue
            apply_fn(op)
            stats["replayed"] += 1
            stats["last_seq"] = max(stats["last_seq"], seq)
        if stats["truncated"]:
            try:
                f.truncate(good_end)
            except OSError:
                pass  # a read-only file system: the replay still ran
    return stats


# --------------------------------------------------------------------- epoch


def mint_epoch(path: str) -> int:
    """Read the persisted incarnation number, persist it plus one
    (tmp-then-rename, fsynced) and return it: the fencing token a
    previous incarnation's clients can never present."""
    prior = 0
    try:
        with open(path) as f:
            prior = int(f.read().strip() or 0)
    except (OSError, ValueError):
        prior = 0
    epoch = prior + 1
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(epoch))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return epoch
