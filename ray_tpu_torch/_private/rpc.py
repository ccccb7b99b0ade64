"""A small request/response RPC layer over TCP.

The port of ``ray_tpu/_private/rpc.py``: the frame helpers,
``RpcServer`` (registered callables, long-running ones dispatched off
the connection's thread with out-of-order replies), ``MuxRpcClient``
(one connection carrying many calls in flight), ``RpcClient`` (one call
at a time, with one transparent reconnect before the request is sent),
and the retry policy the node layer's idempotent control calls share:
``classify_rpc_failure``, ``call_with_retry`` and its per-destination
circuit breaker. Not ported: the coalesced batch frames, the streaming
replies and the tail payloads of the reference's fast paths (ROADMAP
item 10c).

A frame is a little-endian uint64 length and a pickle of
``(seq, method, args, kwargs)`` (request) or ``(seq, status, value)``
(reply, status ``"ok"`` or ``"err"``). A server with ``reply_meta_fn``
tags each ``"ok"`` reply ``"okm"`` and sends ``(meta, result)``: the head
stamps its epoch on every reply that way, and a client hands the meta to
its ``on_reply_meta`` before the call returns.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import pickle
import select
import socket
import struct
import threading
import time
import traceback
from typing import Any, Callable

_LEN = struct.Struct("<Q")
MAX_FRAME = 1 << 34


class RpcError(Exception):
    """The call could not be completed (connection lost, timeout).
    ``maybe_executed``: the request was sent, so the method may have
    run."""

    def __init__(self, message: str = "", maybe_executed: bool = False):
        super().__init__(message)
        self.maybe_executed = maybe_executed

    def __reduce__(self):
        return (RpcError, (str(self), self.maybe_executed))


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
        # () -> dict sent with every "ok" reply (tagged "okm").
        self.reply_meta_fn: Callable[[], dict] | None = None

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
                if self.reply_meta_fn is not None:
                    payload = pickle.dumps(
                        (seq, "okm", (self.reply_meta_fn(), result)),
                        protocol=5)
                else:
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


def _take_meta(status: str, value: Any, observer) -> tuple[str, Any]:
    """Strip the meta of an ``"okm"`` reply, handing it to ``observer``
    (which must not raise; an exception there is dropped)."""
    if status != "okm":
        return status, value
    meta, value = value
    if observer is not None:
        try:
            observer(meta)
        except Exception:  # noqa: BLE001 — an observer must not fail the call
            pass
    return "ok", value


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
        # Called on the reader thread with each reply's meta, before the
        # call it answers returns.
        self.on_reply_meta: Callable[[dict], None] | None = None

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
                status, value = _take_meta(status, value,
                                           self.on_reply_meta)
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

    def call(self, method: str, *args, timeout_s: float | None = None,
             **kwargs) -> Any:
        """One call; ``timeout_s`` (not sent) overrides the client's."""
        return self.call_async(method, *args, **kwargs).result(
            self.timeout_s if timeout_s is None else timeout_s)

    def call_async(self, method: str, *args, **kwargs) -> "_Slot":
        """Send one call and return its slot at once: ``result()`` waits
        for the reply (a chunked pull keeps several in flight)."""
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
        return _Slot(self, payload_seq, method, fut)

    def num_connections(self) -> int:
        """Sockets open: one at most, whatever the calls in flight."""
        with self._lock:
            return int(self._sock is not None)

    def ping(self) -> bool:
        try:
            return self.call("ping", timeout_s=5.0) == "pong"
        except (RpcError, RpcMethodError, OSError):
            return False

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


class _Slot:
    """The pending reply of one ``MuxRpcClient.call_async``."""

    __slots__ = ("_client", "_seq", "_method", "_fut")

    def __init__(self, client: MuxRpcClient, seq: int, method: str,
                 fut: concurrent.futures.Future):
        self._client = client
        self._seq = seq
        self._method = method
        self._fut = fut

    def result(self, timeout_s: float | None = None) -> Any:
        timeout_s = self._client.timeout_s if timeout_s is None \
            else timeout_s
        try:
            status, value = self._fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            with self._client._lock:
                self._client._pending.pop(self._seq, None)
            raise RpcError(f"rpc {self._method} timed out after "
                           f"{timeout_s}s", maybe_executed=True) from None
        except RpcError as exc:
            # The connection dropped with the request sent.
            raise RpcError(str(exc), maybe_executed=True) from None
        return _unpack_reply(status, value)


class RpcClient:
    """One connection; calls are serialized (seq-matched replies). A call
    whose socket turns out dead before the request was sent reconnects
    once; after the send, a failure raises with ``maybe_executed``."""

    def __init__(self, address: str, timeout_s: float = 30.0,
                 connect_timeout_s: float | None = None):
        host, port = _parse_address(address)
        self._addr = (host or "127.0.0.1", port)
        self.address = f"{self._addr[0]}:{self._addr[1]}"
        self._timeout = timeout_s
        # A long read timeout (a blocking task) must not make connecting
        # to a dead host block as long.
        self._connect_timeout = (connect_timeout_s
                                 if connect_timeout_s is not None
                                 else min(timeout_s, 10.0))
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._seq = 0
        self.on_reply_meta: Callable[[dict], None] | None = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout)
        sock.settimeout(self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    @staticmethod
    def _stale(sock: socket.socket) -> bool:
        """An idle socket that reads as ready has a pending EOF or reset:
        no reply is outstanding, so the peer closed it."""
        try:
            readable, _, _ = select.select([sock], [], [], 0)
            return bool(readable)
        except (OSError, ValueError):
            return True

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass  # replaced below either way
            self._sock = None

    def call(self, method: str, *args, **kwargs) -> Any:
        with self._lock:
            self._seq += 1
            seq = self._seq
            request = pickle.dumps((seq, method, args, kwargs), protocol=5)
            last_exc: Exception | None = None
            for _ in range(2):  # one transparent reconnect
                sent = False
                try:
                    if self._sock is not None and self._stale(self._sock):
                        self._drop_sock()
                    if self._sock is None:
                        self._sock = self._connect()
                    _send_frame(self._sock, request)
                    sent = True
                    rseq, status, payload = pickle.loads(
                        _recv_frame(self._sock))
                    if rseq != seq:
                        raise RpcError(f"out-of-order reply: {rseq} != "
                                       f"{seq}")
                    break
                except (OSError, RpcError, EOFError) as exc:
                    last_exc = exc
                    self._drop_sock()
                    if sent:
                        raise RpcError(
                            f"rpc {method} to {self.address} failed after "
                            f"send (may have executed): {exc}",
                            maybe_executed=True) from exc
            else:
                raise RpcError(f"rpc to {self.address} failed: "
                               f"{last_exc}") from last_exc
        status, payload = _take_meta(status, payload, self.on_reply_meta)
        return _unpack_reply(status, payload)

    def ping(self) -> bool:
        try:
            return self.call("ping") == "pong"
        except (RpcError, RpcMethodError):
            return False

    def close(self) -> None:
        with self._lock:
            self._drop_sock()


# --------------------------------------------------------------------------
# The retry policy of idempotent control calls
# --------------------------------------------------------------------------


def classify_rpc_failure(exc: BaseException) -> str:
    """How a failed call may be retried:

    - ``"retryable"``: the request never reached the server;
    - ``"maybe_executed"``: it was (or may have been) sent, so only an
      idempotent caller retries;
    - ``"poisoned"``: the remote method raised, and retrying re-raises.
    """
    if isinstance(exc, RpcMethodError):
        return "poisoned"
    if isinstance(exc, RpcError):
        return "maybe_executed" if exc.maybe_executed else "retryable"
    # Bare socket errors come from connecting only.
    return "retryable" if isinstance(exc, OSError) else "poisoned"


_FAULTS_LOCK = threading.Lock()
_RPC_RETRIES = 0


class _Breaker:
    """One destination's circuit breaker: open after
    ``rpc_breaker_failures`` consecutive failed logical calls, one
    half-open probe after ``rpc_breaker_reset_s``, closed when the probe
    succeeds."""

    __slots__ = ("failures", "open", "opened_at", "probing")

    def __init__(self):
        self.failures = 0
        self.open = False
        self.opened_at = 0.0
        self.probing = False


_BREAKERS_LOCK = threading.Lock()
_BREAKERS: dict[str, _Breaker] = {}
_BREAKER_OPENS = 0


def _breaker_knobs() -> tuple[int, float]:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return (int(GLOBAL_CONFIG.rpc_breaker_failures),
            float(GLOBAL_CONFIG.rpc_breaker_reset_s))


def breaker_allow(dest: str) -> bool:
    """May a logical call to ``dest`` go out now? An open breaker admits
    one probe per reset interval; ``rpc_breaker_failures`` 0 disables the
    breaker."""
    threshold, reset_s = _breaker_knobs()
    if threshold <= 0:
        return True
    with _BREAKERS_LOCK:
        breaker = _BREAKERS.get(dest)
        if breaker is None or not breaker.open:
            return True
        if breaker.probing:
            return False
        if time.monotonic() - breaker.opened_at >= reset_s:
            breaker.probing = True  # this caller is the probe
            return True
        return False


def breaker_record(dest: str, ok: bool) -> None:
    """The outcome of one logical call to ``dest`` (however many
    attempts it took)."""
    global _BREAKER_OPENS
    threshold, _ = _breaker_knobs()
    if threshold <= 0:
        return
    with _BREAKERS_LOCK:
        breaker = _BREAKERS.get(dest)
        if ok:
            if breaker is not None:
                breaker.failures = 0
                breaker.open = False
                breaker.probing = False
            return
        if breaker is None:
            breaker = _BREAKERS[dest] = _Breaker()
        was_open = breaker.open
        breaker.failures += 1
        breaker.probing = False
        if breaker.failures >= threshold or was_open:
            if not was_open:
                _BREAKER_OPENS += 1
            breaker.open = True
            breaker.opened_at = time.monotonic()


def breaker_stats() -> dict:
    """Opens so far and the destinations open now."""
    with _BREAKERS_LOCK:
        return {"opens": _BREAKER_OPENS,
                "open_now": sorted(d for d, b in _BREAKERS.items()
                                   if b.open)}


def reset_breakers() -> None:
    global _BREAKER_OPENS
    with _BREAKERS_LOCK:
        _BREAKERS.clear()
        _BREAKER_OPENS = 0


def rpc_retry_count() -> int:
    with _FAULTS_LOCK:
        return _RPC_RETRIES


def call_with_retry(call: Callable, method: str, *args,
                    attempts: int | None = None,
                    base_delay_s: float | None = None,
                    deadline_s: float | None = None, **kwargs) -> Any:
    """Retry, back off and give up by a deadline: the policy of
    idempotent control calls (heartbeats, registration, fetch plans,
    head reads). A failure that may have executed is retried too, so the
    method must be idempotent; task submits never come through here.

    The defaults are ``rpc_retry_attempts``, ``rpc_retry_base_ms`` and
    ``rpc_retry_deadline_s``. A destination that fails
    ``rpc_breaker_failures`` logical calls in a row opens its breaker,
    and further calls fail at once with a retryable ``RpcError``. A
    method that raised counts as a success (the node answered); a
    transport failure counts once per logical call."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    global _RPC_RETRIES
    attempts = (int(GLOBAL_CONFIG.rpc_retry_attempts) if attempts is None
                else attempts)
    attempts = max(1, attempts)
    if base_delay_s is None:
        base_delay_s = float(GLOBAL_CONFIG.rpc_retry_base_ms) / 1000.0
    if deadline_s is None:
        deadline_s = float(GLOBAL_CONFIG.rpc_retry_deadline_s)
    dest = getattr(getattr(call, "__self__", None), "address", None)
    counted = False
    deadline = time.monotonic() + deadline_s
    for attempt in range(attempts):
        if dest is not None and not breaker_allow(dest):
            raise RpcError(f"rpc {method} to {dest} rejected: circuit "
                           f"breaker open (destination failing "
                           f"consecutively)")
        try:
            result = call(method, *args, **kwargs)
        except RpcMethodError:
            if dest is not None:
                breaker_record(dest, True)
            raise
        except (RpcError, OSError) as exc:
            if dest is not None and not counted \
                    and classify_rpc_failure(exc) != "poisoned":
                counted = True
                breaker_record(dest, False)
            if attempt + 1 >= attempts or time.monotonic() >= deadline:
                raise
            with _FAULTS_LOCK:
                _RPC_RETRIES += 1
            time.sleep(min(base_delay_s * (2 ** attempt), 2.0))
        else:
            if dest is not None:
                breaker_record(dest, True)
            return result
    raise RpcError(f"rpc {method} retry loop exhausted")  # unreachable
