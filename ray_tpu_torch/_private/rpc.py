"""A small request/response RPC layer over TCP.

The port of the part of ``ray_tpu/_private/rpc.py`` that the client
server and the worker-side runtime use: the frame helpers, ``RpcServer``
(registered callables, long-running ones dispatched off the connection's
thread with out-of-order replies) and ``MuxRpcClient`` (one connection
carrying many calls in flight). Not ported: ``RpcClient`` (one call at a
time), which neither uses, and the retry and circuit-breaker helpers of
the reference's cross-machine clients: here both ends share one host,
and a failed call fails.

A frame is a little-endian uint64 length and a pickle of
``(seq, method, args, kwargs)`` (request) or ``(seq, status, value)``
(reply, status ``"ok"`` or ``"err"``).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import pickle
import socket
import struct
import threading
import traceback
from typing import Any, Callable

_LEN = struct.Struct("<Q")
MAX_FRAME = 1 << 34


class RpcError(Exception):
    """The call could not be completed (connection lost, timeout)."""


class RpcMethodError(Exception):
    """The remote method raised; carries the remote traceback."""

    def __init__(self, cause: BaseException, remote_tb: str):
        super().__init__(f"{type(cause).__name__}: {cause}")
        self.cause = cause
        self.remote_tb = remote_tb

    def __reduce__(self):
        return (RpcMethodError, (self.cause, self.remote_tb))


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) >= (1 << 16):
        sock.sendall(_LEN.pack(len(payload)))
        sock.sendall(payload)
    else:
        sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    off = 0
    while off < n:
        got = sock.recv_into(view[off:])
        if not got:
            raise RpcError("connection closed by peer")
        off += got
    return buf


def _recv_frame(sock: socket.socket) -> bytearray:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    return _recv_exact(sock, length)


def _parse_address(address: str) -> tuple[str, int]:
    host, port = address.rsplit(":", 1)
    return host, int(port)


def _error_reply(seq: int, exc: BaseException) -> bytes:
    tb = "".join(traceback.format_exception(type(exc), exc,
                                            exc.__traceback__))
    try:
        return pickle.dumps((seq, "err", (exc, tb)), protocol=5)
    except Exception:  # noqa: BLE001 — an exception that cannot be pickled
        return pickle.dumps(
            (seq, "err", (RpcError(f"{type(exc).__name__}: {exc}"), tb)),
            protocol=5)


class RpcServer:
    """Serves registered callables, one thread per connection.

    ``register(..., concurrent=True)`` runs a method on a thread of its
    own with its reply sent when it returns, so a long poll does not hold
    back the calls that follow it on the same connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]
        self._methods: dict[str, Callable] = {}
        self._concurrent: set[str] = set()
        self._shutdown = threading.Event()
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def register(self, name: str, fn: Callable,
                 concurrent: bool = False) -> None:
        self._methods[name] = fn
        if concurrent:
            self._concurrent.add(name)

    def start(self) -> "RpcServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="ray_tpu_torch-rpc-accept")
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        """Close the listener and every connection; the accept thread has
        ended when this returns (a close alone does not wake a blocked
        accept() on Linux: the shutdown does)."""
        self._shutdown.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # not listening any more
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
                conn.close()
            except OSError:
                pass
        accept = getattr(self, "_accept_thread", None)
        if accept is not None and accept is not threading.current_thread():
            accept.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="ray_tpu_torch-rpc-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()

        def reply(payload: bytes) -> None:
            with send_lock:
                try:
                    _send_frame(conn, payload)
                except OSError:
                    pass  # the client is gone

        def run(seq, name, args, kwargs) -> None:
            try:
                fn = self._methods.get(name)
                if fn is None:
                    raise RpcError(f"unknown rpc method {name!r}")
                result = fn(*args, **kwargs)
                payload = pickle.dumps((seq, "ok", result), protocol=5)
            except BaseException as exc:  # noqa: BLE001 — sent to the caller
                payload = _error_reply(seq, exc)
            reply(payload)

        try:
            while not self._shutdown.is_set():
                seq, name, args, kwargs = pickle.loads(_recv_frame(conn))
                if name in self._concurrent:
                    threading.Thread(target=run, args=(seq, name, args,
                                                       kwargs),
                                     daemon=True,
                                     name=f"ray_tpu_torch-rpc-{name}").start()
                else:
                    run(seq, name, args, kwargs)
        except (RpcError, OSError, EOFError, pickle.UnpicklingError):
            pass
        finally:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass


def _unpack_reply(status: str, value: Any) -> Any:
    if status == "ok":
        return value
    exc, tb = value
    raise RpcMethodError(exc, tb)


class MuxRpcClient:
    """One connection carrying many calls in flight: a reader thread
    matches the replies, which may arrive out of order, to their calls."""

    def __init__(self, address: str, timeout_s: float = 60.0):
        self.address = address
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._pending: dict[int, concurrent.futures.Future] = {}
        self._seq = itertools.count(1)
        self._closed = False

    def _connect(self) -> socket.socket:
        # Caller holds the lock.
        if self._sock is None:
            if self._closed:
                raise RpcError("client is closed")
            sock = socket.create_connection(_parse_address(self.address),
                                            timeout=self.timeout_s)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            threading.Thread(target=self._read_loop, args=(sock,),
                             daemon=True,
                             name="ray_tpu_torch-rpc-reader").start()
        return self._sock

    def _read_loop(self, sock: socket.socket) -> None:
        error: BaseException = RpcError("connection closed")
        try:
            while True:
                seq, status, value = pickle.loads(_recv_frame(sock))
                with self._lock:
                    fut = self._pending.pop(seq, None)
                if fut is not None:
                    fut.set_result((status, value))
        except (RpcError, OSError, EOFError, pickle.UnpicklingError) as exc:
            error = RpcError(f"connection to {self.address} lost: {exc!r}")
        with self._lock:
            if self._sock is sock:
                self._sock = None
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.set_exception(error)

    def call(self, method: str, *args, **kwargs) -> Any:
        payload_seq = next(self._seq)
        payload = pickle.dumps((payload_seq, method, args, kwargs),
                               protocol=5)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            sock = self._connect()
            self._pending[payload_seq] = fut
            try:
                _send_frame(sock, payload)
            except OSError as exc:
                self._pending.pop(payload_seq, None)
                raise RpcError(f"send to {self.address} failed: "
                               f"{exc!r}") from exc
        try:
            status, value = fut.result(timeout=self.timeout_s)
        except concurrent.futures.TimeoutError:
            with self._lock:
                self._pending.pop(payload_seq, None)
            raise RpcError(f"rpc {method} timed out after "
                           f"{self.timeout_s}s") from None
        return _unpack_reply(status, value)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
                sock.close()
            except OSError:
                pass
