"""The fork server: CPU worker processes in milliseconds.

The port of ``ray_tpu/_private/worker_factory.py``. Instead of paying an
interpreter boot and the import of torch (seconds) for every worker, the
driver runs one template process that has imported the worker's stack;
every CPU worker is an ``os.fork()`` of it, sharing its pages copy on
write::

    driver
      └─ factory (python -m ray_tpu_torch._private.worker_factory <sock> <ppid>)
           ├─ forked worker 1 ── its end of a socketpair, passed over
           └─ forked worker 2    SCM_RIGHTS, runs worker_pool.worker_main

The factory is a separate interpreter started with
``CUDA_VISIBLE_DEVICES=""``, and it never touches ``torch.cuda``: a fork
of a process holding a CUDA context cannot use CUDA, and the driver
holds one. So only CPU workers fork from it; a process that needs a card
(a ``GPU`` process actor) boots a fresh interpreter instead. The factory
is single-threaded, reaps its children and exits when its parent dies.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import time

_LEN = struct.Struct(">I")


def _send_msg(sock: socket.socket, obj) -> None:
    blob = pickle.dumps(obj)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_msg(sock: socket.socket):
    buf = b""
    while len(buf) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(buf))
        if not chunk:
            raise EOFError("factory peer closed")
        buf += chunk
    (length,) = _LEN.unpack(buf)
    parts = []
    while length > 0:
        chunk = sock.recv(min(length, 1 << 20))
        if not chunk:
            raise EOFError("factory peer closed")
        parts.append(chunk)
        length -= len(chunk)
    return pickle.loads(b"".join(parts))


# --------------------------------------------------------------------------
# The factory process
# --------------------------------------------------------------------------


def _child_exec(req: dict, pipe_fd: int) -> None:
    """After the fork: the worker's environment, then its serve loop.
    Never returns."""
    rc = 1
    try:
        import gc
        import signal

        # The template froze its heap with the collector off; the worker
        # collects cycles again.
        gc.enable()
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        env = req.get("env") or {}
        # Replace the environment (what Popen does), never merge.
        os.environ.clear()
        os.environ.update({k: str(v) for k, v in env.items()})
        for p in reversed(env.get("PYTHONPATH", "").split(os.pathsep)):
            if p and p not in sys.path:
                sys.path.insert(0, p)
        if req.get("cwd"):
            try:
                os.chdir(req["cwd"])
            except OSError:
                pass  # a missing cwd: the worker runs where it is
        log_path = req.get("log_path")
        fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644) if log_path else os.open(os.devnull, os.O_WRONLY)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)
        from multiprocessing.connection import Connection

        from ray_tpu_torch._private.worker_pool import worker_main

        # The passed socketpair end is the authentication.
        worker_main(Connection(pipe_fd))
        rc = 0
    except BaseException:  # noqa: BLE001 — into the worker's own log
        import traceback

        traceback.print_exc()
    finally:
        os._exit(rc)


def _freeze_heap() -> None:
    # Everything imported so far goes to the permanent generation, so the
    # children's collector never walks (and copy-on-write faults) those
    # pages.
    import gc

    gc.disable()
    gc.collect()
    gc.freeze()


def factory_main(sock_path: str, parent_pid: int) -> None:
    # The worker's stack, once; every fork shares these pages. torch is
    # imported (worker_pool imports it), torch.cuda never touched.
    import multiprocessing.connection  # noqa: F401

    import numpy  # noqa: F401

    import ray_tpu_torch._private.worker_client  # noqa: F401
    import ray_tpu_torch._private.worker_pool  # noqa: F401

    _freeze_heap()
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(sock_path)
    server.listen(64)
    server.settimeout(1.0)
    # The parent waits for this line, so its first spawn request never
    # races the bind.
    print("FACTORY_READY", flush=True)
    while True:
        try:
            while os.waitpid(-1, os.WNOHANG)[0] != 0:
                pass
        except ChildProcessError:
            pass
        if os.getppid() != parent_pid:
            break  # the driver died: an orphaned factory must not linger
        try:
            conn, _ = server.accept()
        except socket.timeout:
            continue
        except OSError:
            break
        pipe_fd: int | None = None
        try:
            # Every request starts with a 2-byte marker; b"FD" carries the
            # worker's connected pipe end as ancillary data.
            marker, fds, _, _ = socket.recv_fds(conn, 2, 1)
            while len(marker) < 2:
                more = conn.recv(2 - len(marker))
                if not more:
                    raise EOFError("factory peer closed")
                marker += more
            if marker == b"FD" and fds:
                pipe_fd = fds[0]
            req = _recv_msg(conn)
            if req.get("op") == "exit":
                _send_msg(conn, {"ok": True})
                break
            if pipe_fd is None:
                raise ValueError("a spawn request carries no pipe")
            pid = os.fork()
            if pid == 0:
                server.close()
                conn.close()
                _child_exec(req, pipe_fd)  # never returns
            _send_msg(conn, {"ok": True, "pid": pid})
        except BaseException as exc:  # noqa: BLE001 — keep serving
            try:
                _send_msg(conn, {"ok": False, "error": repr(exc)})
            except OSError:
                pass  # the requester hung up
        finally:
            if pipe_fd is not None:
                try:
                    os.close(pipe_fd)  # the child has its copy
                except OSError:
                    pass
            try:
                conn.close()
            except OSError:
                pass
    try:
        server.close()
        os.unlink(sock_path)
    except OSError:
        pass


# --------------------------------------------------------------------------
# The driver's side
# --------------------------------------------------------------------------


class PidHandle:
    """A Popen-like handle of a process that is not our child (the
    factory's). Liveness and signals go through a pidfd, which stays
    bound to the process whatever reuses its pid later; where the kernel
    offers no pidfd (a sandbox may not), through the pid, as a signal 0
    for liveness."""

    def __init__(self, pid: int):
        self.pid = pid
        self._rc: int | None = None
        self._pidfd: int | None = None
        try:
            self._pidfd = os.pidfd_open(pid)
        except ProcessLookupError:
            self._rc = -1  # exited and reaped already
        except OSError:
            pass  # no pidfd here: the pid it is

    def __del__(self):
        if getattr(self, "_pidfd", None) is not None:
            try:
                os.close(self._pidfd)
            except OSError:
                pass

    def poll(self) -> int | None:
        if self._rc is not None:
            return self._rc
        if self._pidfd is None:
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                self._rc = -1
        else:
            import select

            readable, _, _ = select.select([self._pidfd], [], [], 0)
            if readable:
                self._rc = -1  # exited; the factory reaped its status
        return self._rc

    def wait(self, timeout: float | None = None) -> int:
        import subprocess

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(f"worker-{self.pid}",
                                                timeout)
            time.sleep(0.01)

    def _signal(self, sig: int) -> None:
        import signal

        if self.poll() is not None:
            return
        try:
            if self._pidfd is not None:
                signal.pidfd_send_signal(self._pidfd, sig)
            else:
                os.kill(self.pid, sig)
        except OSError:
            pass  # already gone

    def terminate(self) -> None:
        import signal

        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        import signal

        self._signal(signal.SIGKILL)


# The environment torch reads when it is imported, or when CUDA and its
# thread pools start: a fork of the template, which has imported torch,
# cannot honour another value, so such a worker boots a fresh
# interpreter.
_IMPORT_SENSITIVE_PREFIXES = ("CUDA_", "NCCL_", "OMP_", "MKL_", "OPENBLAS_",
                              "TORCH_", "PYTORCH_", "LD_", "PYTHONHASHSEED")


def import_sensitive_subset(env: dict) -> dict:
    return {k: v for k, v in env.items()
            if k.startswith(_IMPORT_SENSITIVE_PREFIXES)}


def cpu_worker_env(env: dict) -> dict:
    """``env`` for a process that must see no card."""
    return {**env, "CUDA_VISIBLE_DEVICES": ""}


class WorkerFactory:
    """A running factory; ``spawn`` forks one worker."""

    def __init__(self, proc, sock_path: str, baseline_env: dict):
        self.proc = proc
        self.sock_path = sock_path
        self.baseline_sensitive = import_sensitive_subset(baseline_env)

    def compatible(self, env: dict) -> bool:
        return import_sensitive_subset(env) == self.baseline_sensitive

    def spawn(self, *, env: dict, cwd: str | None, log_path: str | None,
              pipe_fd: int, timeout_s: float = 20.0) -> PidHandle:
        """Fork one worker, handing it ``pipe_fd`` (one end of a
        connected socketpair) over SCM_RIGHTS."""
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(timeout_s)
        try:
            conn.connect(self.sock_path)
            socket.send_fds(conn, [b"FD"], [pipe_fd])
            _send_msg(conn, {"op": "spawn", "env": env, "cwd": cwd,
                             "log_path": log_path})
            reply = _recv_msg(conn)
        finally:
            conn.close()
        if not reply.get("ok"):
            raise RuntimeError(
                f"worker factory spawn failed: {reply.get('error')}")
        return PidHandle(reply["pid"])

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> None:
        try:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.settimeout(2.0)
            conn.connect(self.sock_path)
            conn.sendall(b"NO")  # no pipe rides this request
            _send_msg(conn, {"op": "exit"})
            conn.close()
        except OSError:
            pass  # already exited
        try:
            self.proc.wait(timeout=2.0)
        except Exception:  # noqa: BLE001 — kill it instead
            self.proc.kill()
            self.proc.wait()
        try:
            os.rmdir(os.path.dirname(self.sock_path))
        except OSError:
            pass


def start_factory(timeout_s: float | None = None) -> WorkerFactory:
    """Start the template for this process's CPU workers, with the same
    environment they get."""
    import subprocess
    import tempfile

    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if timeout_s is None:
        timeout_s = max(60.0,
                        float(GLOBAL_CONFIG.worker_startup_timeout_s) * 2)
    sock_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_factory_")
    os.chmod(sock_dir, 0o700)
    sock_path = os.path.join(sock_dir, "factory.sock")
    env = cpu_worker_env(dict(os.environ))
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.worker_factory",
         sock_path, str(os.getpid())],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + timeout_s
    line = b""
    os.set_blocking(proc.stdout.fileno(), False)
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError("worker factory exited during startup")
        chunk = proc.stdout.read()
        if chunk:
            line += chunk
        if b"FACTORY_READY" in line:
            proc.stdout.close()
            return WorkerFactory(proc, sock_path, env)
        time.sleep(0.02)
    proc.kill()
    proc.wait()
    raise RuntimeError("worker factory never became ready")


if __name__ == "__main__":
    factory_main(sys.argv[1], int(sys.argv[2]))
