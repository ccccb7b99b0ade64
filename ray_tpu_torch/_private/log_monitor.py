"""The log monitor: worker processes' output, tailed back to the driver.

The port of ``ray_tpu/_private/log_monitor.py``. Each worker process
writes its stdout and stderr to a file of its own under the session's
log directory; the monitor tails those files and writes each new line to
the driver's stdout, prefixed with the file's name (``(worker-w3) ...``).
It holds each tailed file open and compares the path's inode with the
held handle's, so a replaced file is read from its start and a file
truncated in place is read again from byte 0.
"""

from __future__ import annotations

import os
import sys
import threading


class LogMonitor:
    def __init__(self, log_dir: str, period_s: float = 0.2, out=None):
        self.log_dir = log_dir
        self.period_s = period_s
        self._out = out or sys.stdout
        # name -> (open file object, offset): the held handle pins the
        # inode, making rotation detection exact (see module docs).
        self._files: dict[str, list] = {}
        self._shutdown = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ray_tpu_torch-log-monitor")

    def start(self) -> "LogMonitor":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._shutdown.wait(self.period_s):
            self.poll_once()
        self.poll_once()  # final drain

    def poll_once(self) -> int:
        """Tail every log file once; returns lines emitted."""
        emitted = 0
        try:
            names = sorted(os.listdir(self.log_dir))
        except FileNotFoundError:
            return 0
        for name in names:
            if not name.endswith(".log"):
                continue
            path = os.path.join(self.log_dir, name)
            entry = self._files.get(name)
            try:
                if entry is not None:
                    held = os.fstat(entry[0].fileno())
                    current = os.stat(path)
                    if (current.st_ino, current.st_dev) != \
                            (held.st_ino, held.st_dev):
                        # Rotated: the path now names a DIFFERENT file
                        # (the held handle pins the old inode, so this
                        # comparison cannot be fooled by inode reuse).
                        entry[0].close()
                        entry = None
                    elif current.st_size < entry[1]:
                        # Truncated in place: rewind to the top.
                        entry[1] = 0
                if entry is None:
                    entry = [open(path, "rb"), 0]
                    self._files[name] = entry
                f, offset = entry
                f.seek(offset)
                chunk = f.read()
            except OSError:
                stale = self._files.pop(name, None)
                if stale is not None:
                    try:
                        stale[0].close()
                    except OSError:
                        pass  # rotated file already closed
                continue
            if not chunk:
                continue
            # Only complete lines; partial tail re-read next poll.
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue
            entry[1] = offset + last_nl + 1
            prefix = f"({name[:-len('.log')]}) "
            for line in chunk[:last_nl].decode(
                    "utf-8", errors="replace").splitlines():
                try:
                    self._out.write(prefix + line + "\n")
                    emitted += 1
                except Exception:  # noqa: BLE001 — closed stream
                    return emitted
        if emitted:
            try:
                self._out.flush()
            except Exception:  # noqa: BLE001
                pass
        return emitted

    def stop(self) -> None:
        self._shutdown.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        for entry in self._files.values():
            try:
                entry[0].close()
            except OSError:
                pass  # shutdown: handle may be closed
        self._files.clear()
