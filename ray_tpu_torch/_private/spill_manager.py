"""The managed spill tier: watermark-driven spilling to checksummed files.

The port of ``ray_tpu/_private/spill_manager.py``. When a store's resident
host bytes cross ``spill_high_watermark`` x its budget, a spiller thread
moves unpinned victims to files under ``<session dir>/spill/<pid>/`` and
frees their memory (and any shared-memory twin), until usage is under the
low watermark; the next read restores them.

- **File format**: a 16-byte header (magic ``RTS1``, the payload's length
  as u64 LE, its CRC32) before the payload, written tmp-then-rename
  (``spill_fsync`` adds an fsync). Every restore checks the length and
  the CRC: a torn file raises ``TornSpillError``, and the caller rebuilds
  the object from lineage (recovery.py) instead of returning garbage.
- **Hysteresis**: the spiller wakes above the high watermark and spills
  down to the low one, so churn near the boundary does not thrash.
- **Victims**: the store supplies them (sealed, unpinned, not protected,
  host objects only), largest first, least recently used as the
  tiebreak.
- **Disk full backs off**: any OSError on the write path raises
  ``SpillDiskFullError``; for ``spill_disk_full_backoff_s`` the manager
  spills nothing and admission sheds store pressure as host pressure.
- **Orphan sweep**: the pid in the directory's path lets any survivor on
  the host remove a killed owner's files (0-signal probe, same uid).

The session directory is ``$RAY_TPU_TORCH_SESSION_DIR``, else
``ray_tpu_torch`` under the temporary directory. With ``spill_enabled``
off no manager is built and the store spills inline past its budget.
"""

from __future__ import annotations

import errno
import os
import shutil
import struct
import tempfile
import threading
import time
import zlib
from typing import Callable

from ray_tpu_torch._private.same_host import pid_is_dead

SESSION_DIR_ENV = "RAY_TPU_TORCH_SESSION_DIR"

# Whether the runtime arms the tier; set from ``spill_enabled`` at init.
SPILL_ON = True


def init_from_config() -> None:
    """Arm or disarm the tier from the ``spill_enabled`` knob."""
    global SPILL_ON
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    SPILL_ON = bool(GLOBAL_CONFIG.spill_enabled)


class TornSpillError(Exception):
    """A spill file failed its length or CRC check on restore: the bytes
    on disk are not the object, which is lost (lineage rebuilds it)."""


class SpillDiskFullError(Exception):
    """A spill write could not land (ENOSPC or any OSError): the spiller
    backs off and admission sheds instead."""


_MAGIC = b"RTS1"
_HEADER = struct.Struct("<4sQI")  # magic, payload length, crc32


def session_spill_root() -> str:
    return os.path.join(
        os.environ.get(SESSION_DIR_ENV)
        or os.path.join(tempfile.gettempdir(), "ray_tpu_torch"), "spill")


def process_spill_dir(pid: int | None = None) -> str:
    """The process's spill directory: the pid in the path lets a
    survivor sweep a dead owner's files with one liveness probe."""
    return os.path.join(session_spill_root(), str(pid or os.getpid()))


def write_spill_file(path: str, payload, fsync: bool = False) -> None:
    """Write ``payload`` after its length and CRC header, tmp-then-rename.
    Raises SpillDiskFullError on any OSError of the write path."""
    header = _HEADER.pack(_MAGIC, len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as exc:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # nothing was written; the error is raised below
        raise SpillDiskFullError(
            f"spill write failed ({errno.errorcode.get(exc.errno, '?')}): "
            f"{exc}") from exc


def read_spill_file(path: str) -> bytes:
    """Read and check one spill file. Raises TornSpillError on a bad
    magic, length or CRC, OSError when the file is gone."""
    with open(path, "rb") as f:
        header = f.read(_HEADER.size)
        if len(header) != _HEADER.size:
            raise TornSpillError(f"{path}: truncated header")
        magic, length, crc = _HEADER.unpack(header)
        if magic != _MAGIC:
            raise TornSpillError(f"{path}: bad magic {magic!r}")
        payload = f.read(length + 1)  # +1 finds trailing garbage
    if len(payload) != length:
        raise TornSpillError(
            f"{path}: payload {len(payload)} != header length {length}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TornSpillError(f"{path}: CRC mismatch")
    return payload


class SpillManager:
    """The spiller of one store: watermark hysteresis, victims through
    the store's callbacks, checksummed files, the disk-full backoff and
    the restore counters.

    The store keeps its own locking and supplies:

    - ``usage_fn() -> int``: its resident host bytes now;
    - ``victims_fn(need_bytes) -> list``: spillable keys covering
      ``need_bytes``, in spill order;
    - ``extract_fn(key) -> payload | None``: the bytes to write (None
      when the object is no longer a victim);
    - ``commit_fn(key, path, size) -> bool``: swap the copy in memory for
      the file; False when a free or reseal raced the write (the manager
      then removes the file).
    """

    def __init__(self, role: str, capacity_bytes: int,
                 usage_fn: Callable[[], int],
                 victims_fn: Callable[[int], list],
                 extract_fn: Callable, commit_fn: Callable,
                 spill_dir: str | None = None,
                 high_watermark: float | None = None,
                 low_watermark: float | None = None,
                 fsync: bool | None = None,
                 backoff_s: float | None = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self.role = role
        self.capacity = int(capacity_bytes)
        self.spill_dir = spill_dir or process_spill_dir()
        self.high = float(high_watermark if high_watermark is not None
                          else GLOBAL_CONFIG.spill_high_watermark)
        self.low = float(low_watermark if low_watermark is not None
                         else GLOBAL_CONFIG.spill_low_watermark)
        self.fsync = bool(GLOBAL_CONFIG.spill_fsync
                          if fsync is None else fsync)
        self._backoff_s = float(GLOBAL_CONFIG.spill_disk_full_backoff_s
                                if backoff_s is None else backoff_s)
        self._usage = usage_fn
        self._victims = victims_fn
        self._extract = extract_fn
        self._commit = commit_fn
        self._lock = threading.Lock()
        self._backoff_until = 0.0
        self._forced = False
        self.spills = 0
        self.restores = 0
        self.spilled_bytes = 0
        self.restored_bytes = 0
        self.torn_restores = 0
        self.disk_full = 0
        self.files_deleted = 0
        self.orphan_dirs_swept = 0
        # Restore walls for the exact p50, and (bytes, seconds) of each
        # spill and restore for their rates; 512 samples each at most.
        self._restore_walls: list[float] = []
        self._timings: dict[str, list] = {"spill": [], "restore": []}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"ray_tpu_torch-spiller-{role}")
        self._thread.start()
        with _LIVE_LOCK:
            _LIVE.add(self)

    # ------------------------------------------------------------ triggers

    def high_bytes(self) -> int:
        return int(self.capacity * self.high)

    def low_bytes(self) -> int:
        return int(self.capacity * self.low)

    def notify(self) -> None:
        """The store's usage changed: wake the spiller above the high
        watermark (one comparison on the put path)."""
        if self._usage() > self.high_bytes():
            self._wake.set()

    def request_spill(self) -> None:
        """Admission's kick: spill toward the low watermark from wherever
        usage stands."""
        self._forced = True
        self._wake.set()

    def backing_off(self) -> bool:
        """Whether a disk-full backoff is open (spilling cannot relieve
        pressure now: admission must shed)."""
        with self._lock:
            return time.monotonic() < self._backoff_until

    # ---------------------------------------------------------- spill pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            forced, self._forced = self._forced, False
            try:
                self.spill_pass(force=forced)
            except Exception:  # noqa: BLE001 — the spiller must survive
                pass

    def spill_pass(self, force: bool = False) -> int:
        """One spill pass down to the low watermark, on the caller's
        thread (the spiller's body; tests call it directly). Nothing
        happens until usage crosses the high watermark, unless ``force``
        (admission's kick). Returns the number of objects spilled."""
        if self.backing_off():
            return 0
        if not force and self._usage() <= self.high_bytes():
            return 0
        spilled = 0
        target = self.low_bytes()
        need = self._usage() - target
        if need <= 0:
            return 0
        for key in self._victims(need):
            if self._usage() <= target:
                break
            if not self._spill_one(key):
                if self.backing_off():
                    break  # disk full: the backoff is open
                continue
            spilled += 1
        return spilled

    def _spill_one(self, key) -> bool:
        start = time.monotonic()
        payload = self._extract(key)
        if payload is None:
            return True  # no longer a victim: not a failure
        path = os.path.join(
            self.spill_dir, f"{key.hex()}-{os.urandom(4).hex()}.spill")
        try:
            write_spill_file(path, payload, fsync=self.fsync)
        except SpillDiskFullError:
            with self._lock:
                self.disk_full += 1
                self._backoff_until = time.monotonic() + self._backoff_s
            return False
        size = len(payload)
        if not self._commit(key, path, size):
            try:
                os.unlink(path)
            except OSError:
                pass  # lost the race to a sweep
            return True
        wall = time.monotonic() - start
        with self._lock:
            self.spills += 1
            self.spilled_bytes += size
            if len(self._timings["spill"]) < 512:
                self._timings["spill"].append((size, wall))
        return True

    # ------------------------------------------------------------- restore

    def restore(self, key, path: str) -> bytes:
        """Read and check one spilled object. A torn file is removed and
        TornSpillError raised: the caller rebuilds the object."""
        start = time.monotonic()
        try:
            payload = read_spill_file(path)
        except TornSpillError:
            with self._lock:
                self.torn_restores += 1
            try:
                os.unlink(path)
            except OSError:
                pass  # already gone; the tear is counted
            raise
        wall = time.monotonic() - start
        with self._lock:
            self.restores += 1
            self.restored_bytes += len(payload)
            if len(self._restore_walls) < 512:
                self._restore_walls.append(wall)
                self._timings["restore"].append((len(payload), wall))
        return payload

    def delete_file(self, path: str) -> None:
        """Remove one spill file (a free, an eviction, a loss)."""
        try:
            os.unlink(path)
        except OSError:
            return
        with self._lock:
            self.files_deleted += 1

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            walls = sorted(self._restore_walls)
            p50 = walls[len(walls) // 2] * 1000.0 if walls else 0.0
            return {
                "spills": self.spills,
                "restores": self.restores,
                "spilled_bytes": self.spilled_bytes,
                "restored_bytes": self.restored_bytes,
                "torn_restores": self.torn_restores,
                "disk_full": self.disk_full,
                "files_deleted": self.files_deleted,
                "orphan_dirs_swept": self.orphan_dirs_swept,
                "restore_p50_ms": round(p50, 3),
                "backing_off": time.monotonic() < self._backoff_until,
            }

    def timings(self) -> dict:
        """``{"spill": [(bytes, seconds)], "restore": [...]}``: each
        spill from its extract to its commit, each restore's read and
        check."""
        with self._lock:
            return {kind: list(rows) for kind, rows in self._timings.items()}

    def stop(self) -> None:
        """End the spiller thread (after the pass it is in)."""
        self._stop.set()
        self._wake.set()
        with _LIVE_LOCK:
            _LIVE.discard(self)
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=60.0)


# The live managers of this process: they share the per-pid directory,
# so it is removed only once the last one has stopped.
_LIVE: set = set()
_LIVE_LOCK = threading.Lock()


def live_manager_count() -> int:
    with _LIVE_LOCK:
        return len(_LIVE)


# The counters every manager's stats() has, summed by merged_stats.
SPILL_STAT_KEYS = ("spills", "restores", "spilled_bytes",
                   "restored_bytes", "torn_restores", "disk_full",
                   "files_deleted", "orphan_dirs_swept")


def merged_stats(*managers) -> dict:
    """The counters summed over ``managers`` (None skipped);
    restore_p50_ms is the largest (the worst store's)."""
    out = {key: 0 for key in SPILL_STAT_KEYS}
    out["restore_p50_ms"] = 0.0
    out["backing_off"] = False
    for mgr in managers:
        if mgr is None:
            continue
        stats = mgr.stats()
        for key in SPILL_STAT_KEYS:
            out[key] += stats[key]
        out["restore_p50_ms"] = max(out["restore_p50_ms"],
                                    stats["restore_p50_ms"])
        out["backing_off"] = out["backing_off"] or stats["backing_off"]
    return out


def sweep_orphan_spill_dirs(root: str | None = None) -> int:
    """Delete the per-pid spill directories of owners that died without
    cleaning up (same uid only). Returns how many were removed."""
    root = root or session_spill_root()
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    swept = 0
    for name in names:
        if not name.isdigit() or int(name) == os.getpid():
            continue
        if not pid_is_dead(int(name)):
            continue
        path = os.path.join(root, name)
        try:
            if os.stat(path).st_uid != os.getuid():
                continue
            shutil.rmtree(path, ignore_errors=True)
            swept += 1
        except OSError:
            continue  # raced another sweeper
    return swept
