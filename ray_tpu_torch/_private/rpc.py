"""A small request/response RPC layer over TCP.

The port of ``ray_tpu/_private/rpc.py``: the frame helpers,
``RpcServer`` (registered callables; long-running ones dispatched on
recycled threads with out-of-order replies, streaming methods that send
``part`` frames before their reply, ``__batch__`` frames of many calls),
``MuxRpcClient`` (one connection carrying many calls in flight, with
per-destination coalescing into ``__batch__`` frames and streaming
calls), ``RpcClient`` (one call at a time, with one transparent
reconnect before the request is sent), and the retry policy the node
layer's idempotent control calls share: ``classify_rpc_failure``,
``call_with_retry`` and its per-destination circuit breaker.

A frame is a little-endian uint64 length and a pickle of
``(seq, method, args, kwargs)`` (request) or ``(seq, status, value)``
(reply, status ``"ok"``, ``"err"``, ``"part"`` or ``"tail"``). A tail
reply's raw bytes follow its pickle in the same frame. A server with
``reply_meta_fn`` tags each ``"ok"``, ``"part"`` and ``"tail"`` frame
with an ``"m"`` and sends ``(meta, value)``: the head stamps its epoch on
every reply that way, and a client hands the meta to its
``on_reply_meta`` before the call returns.
"""

from __future__ import annotations

import os
import pickle
import queue
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


class TailPayload:
    """A reply whose ``tail`` (any buffer) follows the pickled ``head``
    raw in the same frame: a chunk's bytes cross without a pickle copy
    on either side. The caller receives ``(head, tail view)``."""

    __slots__ = ("head", "tail")

    def __init__(self, head: Any, tail):
        self.head = head
        self.tail = tail


class _StreamEnd:
    """Closes a streaming call's queue of parts (the final reply or a
    failure resolved the call)."""


_STREAM_END = _StreamEnd()


class _Recycled:
    """One reusable dispatch thread: it parks in its pool's LIFO free
    list between jobs and ends after an idle timeout."""

    __slots__ = ("_pool", "_event", "_job", "_thread")

    def __init__(self, pool: "_ThreadRecycler"):
        self._pool = pool
        self._event = threading.Event()
        self._job = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=pool.name)
        self._thread.start()

    def run(self, fn, args) -> None:
        self._job = (fn, args)
        self._event.set()

    def _loop(self) -> None:
        while True:
            if not self._event.wait(self._pool.idle_s):
                # Idle expiry, unless a submitter popped this thread off
                # the free list meanwhile: then its job is on the way.
                with self._pool._lock:
                    try:
                        self._pool._idle.remove(self)
                        claimed = False
                    except ValueError:
                        claimed = True
                if not claimed:
                    return
                self._event.wait()
            self._event.clear()
            fn, args = self._job
            self._job = None
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001 — as a daemon thread would
                traceback.print_exc()
            with self._pool._lock:
                self._pool._idle.append(self)


class _ThreadRecycler:
    """An unbounded thread pool with LIFO reuse and idle expiry: the
    shape of a thread per request (no queue, so a nested call can never
    wait behind its caller), without a thread spawn per request."""

    def __init__(self, name: str, idle_s: float = 10.0):
        self.name = name
        self.idle_s = idle_s
        self._lock = threading.Lock()
        self._idle: list[_Recycled] = []
        self.spawns = 0
        self.reuses = 0

    def submit(self, fn, *args) -> None:
        with self._lock:
            worker = self._idle.pop() if self._idle else None
            if worker is None:
                self.spawns += 1
            else:
                self.reuses += 1
        if worker is None:
            worker = _Recycled(self)
        worker.run(fn, args)


# Shared by the servers' concurrent methods and the driver's batch
# launches.
DISPATCH_POOL = _ThreadRecycler("ray_tpu_torch-rpc-dispatch")


class RpcServer:
    """Serves registered callables, one thread per connection.

    ``register(..., concurrent=True)`` runs a method on a recycled
    thread with its reply sent when it returns, so a long call does not
    hold back the calls behind it on the same connection;
    ``concurrent="pooled"`` runs it on a bounded pool of
    ``rpc_io_pool_workers`` threads instead (short calls such as chunk
    fetches: no thread per chunk, and a flood of them queues).
    ``register(..., streaming=True)`` hands the method an ``_emit_part``
    keyword that sends ``part`` frames before the final reply
    (``MuxRpcClient.call_streaming`` reads them). A ``__batch__`` frame
    carries many seq-tagged calls, each answered on its own."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]
        self._methods: dict[str, Callable] = {}
        # Method name -> "thread" (a recycled thread per call) or
        # "pooled" (the bounded io pool, made at its first call).
        self._concurrent: dict[str, str] = {}
        self._streaming: set[str] = set()
        self._io_pool = None
        self._io_pool_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()
        # () -> dict sent with every "ok" reply and part (tagged "okm",
        # "partm").
        self.reply_meta_fn: Callable[[], dict] | None = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def register(self, name: str, fn: Callable,
                 concurrent: "bool | str" = False,
                 streaming: bool = False) -> None:
        self._methods[name] = fn
        if concurrent:
            self._concurrent[name] = (
                concurrent if isinstance(concurrent, str) else "thread")
        if streaming:
            self._streaming.add(name)

    def _get_io_pool(self):
        from concurrent.futures import ThreadPoolExecutor

        with self._io_pool_lock:
            if self._io_pool is None:
                from ray_tpu_torch._private.config import GLOBAL_CONFIG

                self._io_pool = ThreadPoolExecutor(
                    max_workers=int(GLOBAL_CONFIG.rpc_io_pool_workers),
                    thread_name_prefix="ray_tpu_torch-rpc-io")
            return self._io_pool

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
        with self._io_pool_lock:
            pool, self._io_pool = self._io_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

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
        try:
            while not self._shutdown.is_set():
                seq, name, args, kwargs = pickle.loads(_recv_frame(conn))
                if name == "__batch__":
                    # Many calls in one frame: each runs as its method
                    # says and is answered under its own seq.
                    for bseq, blob in args[0]:
                        try:
                            bname, bargs, bkwargs = pickle.loads(blob)
                        except Exception as exc:  # noqa: BLE001 — that entry's caller
                            self._send(conn, send_lock, _error_reply(
                                bseq, RpcError(f"bad batch entry: "
                                               f"{exc!r}")))
                            continue
                        self._dispatch(conn, send_lock, bseq, bname, bargs,
                                       bkwargs)
                    continue
                self._dispatch(conn, send_lock, seq, name, args, kwargs)
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

    def _dispatch(self, conn, send_lock, seq, name, args, kwargs) -> None:
        mode = self._concurrent.get(name)
        if mode == "pooled":
            try:
                self._get_io_pool().submit(self._handle_one, conn,
                                           send_lock, seq, name, args,
                                           kwargs)
            except RuntimeError:
                pass  # the server stopped: the connection is closing
        elif mode is not None:
            DISPATCH_POOL.submit(self._handle_one, conn, send_lock, seq,
                                 name, args, kwargs)
        else:
            self._handle_one(conn, send_lock, seq, name, args, kwargs)

    @staticmethod
    def _send(conn, send_lock, payload: bytes) -> bool:
        try:
            with send_lock:
                _send_frame(conn, payload)
            return True
        except OSError:
            return False  # the client is gone

    def _tagged(self, seq: int, status: str, value: Any) -> bytes:
        """A reply frame; with ``reply_meta_fn`` an ``ok``, ``part`` or
        ``tail`` one carries the meta (status + "m")."""
        if self.reply_meta_fn is not None:
            return pickle.dumps((seq, status + "m",
                                 (self.reply_meta_fn(), value)), protocol=5)
        return pickle.dumps((seq, status, value), protocol=5)

    def _send_tail(self, conn, send_lock, seq: int,
                   result: TailPayload) -> bool:
        """[length][pickled (seq, "tail", (head, n))][n raw bytes]."""
        tail = result.tail if isinstance(result.tail, memoryview) \
            else memoryview(result.tail)
        head = self._tagged(seq, "tail", (result.head, tail.nbytes))
        try:
            with send_lock:
                conn.sendall(_LEN.pack(len(head) + tail.nbytes))
                conn.sendall(head)
                conn.sendall(tail)
            return True
        except OSError:
            return False

    def _handle_one(self, conn, send_lock, seq, name, args, kwargs) -> None:
        try:
            fn = self._methods.get(name)
            if fn is None:
                raise RpcError(f"unknown rpc method {name!r}")
            if name in self._streaming:
                def _emit_part(value) -> None:
                    # A dead connection stops the producer.
                    if not self._send(conn, send_lock,
                                      self._tagged(seq, "part", value)):
                        raise RpcError("connection lost mid-stream")

                kwargs = dict(kwargs, _emit_part=_emit_part)
            result = fn(*args, **kwargs)
            if isinstance(result, TailPayload):
                self._send_tail(conn, send_lock, seq, result)
                return
            payload = self._tagged(seq, "ok", result)
        except BaseException as exc:  # noqa: BLE001 — sent to the caller
            payload = _error_reply(seq, exc)
        self._send(conn, send_lock, payload)


def _take_meta(status: str, value: Any, observer) -> tuple[str, Any]:
    """Strip the meta of an ``"okm"`` (``"partm"``, ``"tailm"``) reply,
    handing it to ``observer`` (which must not raise; an exception there
    is dropped)."""
    if not status.endswith("m"):
        return status, value
    meta, value = value
    if observer is not None:
        try:
            observer(meta)
        except Exception:  # noqa: BLE001 — an observer must not fail the call
            pass
    return status[:-1], value


def _decode_reply(frame, observer) -> tuple[int, str, Any]:
    """(seq, status, value) of a reply frame: meta handed to
    ``observer``, a tail frame's value ``(head, tail view)``."""
    seq, status, value = pickle.loads(frame)
    status, value = _take_meta(status, value, observer)
    if status == "tail":
        head, tail_len = value
        status = "ok"
        value = (head, memoryview(frame)[len(frame) - tail_len:]
                 if tail_len else b"")
    return seq, status, value


def _unpack_reply(status: str, value: Any) -> Any:
    if status == "ok":
        return value
    exc, tb = value
    raise RpcMethodError(exc, tb)


class _MuxSlot:
    """One call in flight: resolved by the reader thread or by the
    failure of its connection. ``conn`` is None while the call waits in
    the coalescing queue."""

    __slots__ = ("event", "reply", "error", "client", "conn", "seq",
                 "method", "parts")

    def __init__(self, client: "MuxRpcClient", method: str):
        self.event = threading.Event()
        self.reply = None
        self.error: BaseException | None = None
        self.client = client
        self.conn: "_MuxConn | None" = None
        self.seq = 0
        self.method = method
        # A streaming call's parts, closed by _STREAM_END.
        self.parts = None

    def done(self) -> bool:
        return self.event.is_set()

    def next_part(self, timeout_s: float | None = None):
        """The next part of a streaming call, or None once the stream
        ended (``result()`` then holds the final reply or raises).
        Raises RpcError on timeout."""
        try:
            item = self.parts.get(timeout=self.client.timeout_s
                                  if timeout_s is None else timeout_s)
        except queue.Empty:
            self.client._abandon(self)
            raise RpcError(f"rpc {self.method} to {self.client.address} "
                           f"stream timed out", maybe_executed=True) \
                from None
        return None if item is _STREAM_END else item

    def result(self, timeout_s: float | None = None) -> Any:
        client = self.client
        wait_s = client.timeout_s if timeout_s is None else timeout_s
        if not self.event.wait(wait_s):
            client._abandon(self)
            raise RpcError(f"rpc {self.method} to {client.address} timed "
                           f"out after {wait_s}s", maybe_executed=True)
        if self.error is not None:
            maybe = not isinstance(self.error, RpcError) \
                or self.error.maybe_executed
            raise RpcError(f"rpc {self.method} to {client.address} failed: "
                           f"{self.error}", maybe_executed=maybe) \
                from self.error
        return _unpack_reply(*self.reply)


class _MuxConn:
    """One live connection and the calls bound to it: a dead socket's
    failure never touches calls already on its successor."""

    __slots__ = ("sock", "pending")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.pending: dict[int, _MuxSlot] = {}


class MuxRpcClient:
    """One connection carrying many calls in flight: requests are
    seq-tagged and a reader thread matches the replies, which may arrive
    out of order. ``call_async(coalesce=True)`` queues a call for a
    ``__batch__`` frame with whatever else is pending to this address.
    No transparent retry: a lost connection fails exactly the calls
    that rode it (maybe executed), and the next call reconnects."""

    def __init__(self, address: str, timeout_s: float = 60.0,
                 connect_timeout_s: float = 10.0):
        self.address = address
        self.timeout_s = timeout_s
        self._connect_timeout = connect_timeout_s
        self._lock = threading.Lock()        # connection state and seq
        self._send_lock = threading.Lock()   # frame writes
        self._conn: _MuxConn | None = None
        self._seq = 0
        self._closed = False
        # Coalescing queue: (slot, pickled entry) pairs that the flusher
        # packs into __batch__ frames.
        self._batch_pending: list = []
        self._batch_event = threading.Event()
        self._batch_thread: threading.Thread | None = None
        # Called on the reader thread with each reply's meta, before the
        # call it answers returns.
        self.on_reply_meta: Callable[[dict], None] | None = None

    def _ensure_conn_locked(self) -> _MuxConn:
        if self._conn is None:
            sock = socket.create_connection(_parse_address(self.address),
                                            timeout=self._connect_timeout)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conn = _MuxConn(sock)
            threading.Thread(target=self._reader_loop, args=(self._conn,),
                             daemon=True,
                             name="ray_tpu_torch-rpc-reader").start()
        return self._conn

    def call(self, method: str, *args, timeout_s: float | None = None,
             coalesce: bool = False, **kwargs) -> Any:
        """One call; ``timeout_s`` (not sent) overrides the client's."""
        return self.call_async(method, *args, coalesce=coalesce,
                               **kwargs).result(timeout_s)

    def call_async(self, method: str, *args, coalesce: bool = False,
                   **kwargs) -> _MuxSlot:
        """Send one call and return its slot at once (``result()`` waits
        for the reply). ``coalesce``: ride a shared ``__batch__`` frame
        when the socket is busy (chatty control calls)."""
        if coalesce:
            return self._submit_coalesced(method, args, kwargs)
        return self._call_direct(method, args, kwargs)

    def call_streaming(self, method: str, *args, **kwargs) -> _MuxSlot:
        """A call to a streaming method: read ``slot.next_part()`` until
        it returns None, then ``slot.result()``."""
        return self._call_direct(method, args, kwargs,
                                 parts=queue.SimpleQueue())

    def _call_direct(self, method: str, args, kwargs,
                     parts=None) -> _MuxSlot:
        slot = _MuxSlot(self, method)
        slot.parts = parts
        with self._lock:
            if self._closed:
                raise RpcError(f"client to {self.address} is closed")
            try:
                conn = self._ensure_conn_locked()
            except OSError as exc:
                raise RpcError(f"cannot connect to {self.address}: "
                               f"{exc}") from exc
            self._seq += 1
            slot.seq = self._seq
        # Pickled before the slot is registered: an argument that cannot
        # be pickled raises here and leaks nothing.
        request = pickle.dumps((slot.seq, method, args, kwargs), protocol=5)
        with self._lock:
            if self._closed:
                raise RpcError(f"client to {self.address} is closed")
            slot.conn = conn
            conn.pending[slot.seq] = slot
        try:
            with self._send_lock:
                _send_frame(conn.sock, request)
        except OSError as exc:
            self._fail_conn(conn, exc)
            raise RpcError(f"rpc {method} to {self.address} failed: {exc}",
                           maybe_executed=True) from exc
        return slot

    def _abandon(self, slot: _MuxSlot) -> None:
        """The caller gave up on ``slot`` (a timeout): unregister it."""
        with self._lock:
            if slot.conn is not None:
                slot.conn.pending.pop(slot.seq, None)
            else:
                self._batch_pending = [(s, b) for s, b in self._batch_pending
                                       if s is not slot]

    # -- coalescing -------------------------------------------------------

    def _submit_coalesced(self, method: str, args, kwargs) -> _MuxSlot:
        # Pickled on the caller's thread: a bad argument fails its own
        # caller, never the frame's other entries.
        blob = pickle.dumps((method, args, kwargs), protocol=5)
        slot = _MuxSlot(self, method)
        with self._lock:
            if self._closed:
                raise RpcError(f"client to {self.address} is closed")
            # An idle socket with nothing queued sends at once; under a
            # burst (a writer mid-frame) entries queue for a shared
            # frame. Nothing queued is required, so the order of calls
            # to one destination holds.
            direct = (not self._batch_pending
                      and self._send_lock.acquire(blocking=False))
            if direct:
                try:
                    conn = self._ensure_conn_locked()
                except OSError as exc:
                    self._send_lock.release()
                    raise RpcError(f"cannot connect to {self.address}: "
                                   f"{exc}") from exc
                self._seq += 1
                slot.seq = self._seq
                slot.conn = conn
                conn.pending[slot.seq] = slot
            else:
                self._batch_pending.append((slot, blob))
                if self._batch_thread is None:
                    self._batch_thread = threading.Thread(
                        target=self._flush_loop, daemon=True,
                        name="ray_tpu_torch-rpc-flusher")
                    self._batch_thread.start()
        if not direct:
            self._batch_event.set()
            return slot
        frame = pickle.dumps((0, "__batch__", (((slot.seq, blob),),), {}),
                             protocol=5)
        try:
            _send_frame(conn.sock, frame)
        except OSError as exc:
            self._send_lock.release()
            self._fail_conn(conn, exc)
            return slot
        self._send_lock.release()
        return slot

    @staticmethod
    def _batch_limits() -> tuple[float, int]:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return (float(GLOBAL_CONFIG.rpc_batch_flush_ms) / 1000.0,
                max(1, int(GLOBAL_CONFIG.rpc_batch_max_entries)))

    def _flush_loop(self) -> None:
        while True:
            self._batch_event.wait()
            linger, max_entries = self._batch_limits()
            if linger > 0:
                time.sleep(linger)
            with self._lock:
                self._batch_event.clear()
                pending, self._batch_pending = self._batch_pending, []
                closed = self._closed
            if closed:
                for slot, _ in pending:
                    slot.error = RpcError("client closed")
                    slot.event.set()
                return
            while pending:
                self._flush_batch(pending[:max_entries])
                pending = pending[max_entries:]

    def _flush_batch(self, pending: list) -> None:
        error: BaseException = RpcError("client closed")
        with self._lock:
            conn = None
            if not self._closed:
                try:
                    conn = self._ensure_conn_locked()
                except OSError as exc:
                    # Never sent: retryable.
                    error = RpcError(f"cannot connect to {self.address}: "
                                     f"{exc}")
            if conn is None:
                for slot, _ in pending:
                    slot.error = error
                    slot.event.set()
                return
            entries = []
            for slot, blob in pending:
                self._seq += 1
                slot.seq = self._seq
                slot.conn = conn
                conn.pending[slot.seq] = slot
                entries.append((slot.seq, blob))
        frame = pickle.dumps((0, "__batch__", (entries,), {}), protocol=5)
        try:
            with self._send_lock:
                _send_frame(conn.sock, frame)
        except OSError as exc:
            self._fail_conn(conn, exc)

    def _reader_loop(self, conn: _MuxConn) -> None:
        while True:
            try:
                frame = _recv_frame(conn.sock)
                seq, status, value = _decode_reply(frame, self.on_reply_meta)
            except (RpcError, OSError, EOFError,
                    pickle.UnpicklingError) as exc:
                self._fail_conn(conn, exc)
                return
            if status == "part":
                # The call stays pending; its part goes to its queue.
                with self._lock:
                    slot = conn.pending.get(seq)
                if slot is not None and slot.parts is not None:
                    slot.parts.put(value)
                continue
            with self._lock:
                slot = conn.pending.pop(seq, None)
            if slot is not None:
                slot.reply = (status, value)
                slot.event.set()
                if slot.parts is not None:
                    slot.parts.put(_STREAM_END)

    def _fail_conn(self, conn: _MuxConn, exc: BaseException) -> None:
        """Fail exactly the calls riding ``conn`` (their requests were
        written: maybe executed); a reconnected successor is
        untouched."""
        with self._lock:
            if self._conn is conn:
                self._conn = None  # the next call reconnects
            pending = list(conn.pending.values())
            conn.pending.clear()
        try:
            conn.sock.close()
        except OSError:
            pass
        if not (isinstance(exc, RpcError) and exc.maybe_executed):
            exc = RpcError(f"connection to {self.address} lost with the "
                           f"call in flight: {exc!r}", maybe_executed=True)
        for slot in pending:
            slot.error = exc
            slot.event.set()
            if slot.parts is not None:
                slot.parts.put(_STREAM_END)

    def num_connections(self) -> int:
        """Sockets open: one at most, whatever the calls in flight."""
        with self._lock:
            return int(self._conn is not None)

    def ping(self) -> bool:
        try:
            return self.call("ping", timeout_s=5.0) == "pong"
        except (RpcError, RpcMethodError, OSError):
            return False

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
            pending = list(conn.pending.values()) if conn else []
            if conn:
                conn.pending.clear()
            queued, self._batch_pending = self._batch_pending, []
        self._batch_event.set()  # the flusher sees _closed and ends
        if conn is not None:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
                conn.sock.close()
            except OSError:
                pass
        for slot in pending + [s for s, _ in queued]:
            slot.error = RpcError("client closed")
            slot.event.set()
            if slot.parts is not None:
                slot.parts.put(_STREAM_END)


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
                    rseq, status, payload = _decode_reply(
                        _recv_frame(self._sock), self.on_reply_meta)
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
                from ray_tpu_torch._private import flight_recorder

                flight_recorder.record("breaker.open", dest)
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


def overload_retry_after(exc: BaseException) -> "float | None":
    """The retry hint of a remote ``SystemOverloadedError`` (a stalled
    head shard's shed), clamped to [0.05, 2.0] s so a long stall never
    wedges the caller; None for any other error."""
    from ray_tpu_torch.exceptions import SystemOverloadedError

    cause = getattr(exc, "cause", None)
    if isinstance(cause, SystemOverloadedError):
        return min(max(float(getattr(cause, "retry_after_s", 0.1)), 0.05),
                   2.0)
    return None


def _retry_pin() -> None:
    """While tracing, a retried control call leaves a ``fault:rpc_retry``
    pin at its time in the merged timeline: a daemon's is shipped back,
    the driver's recorded here."""
    from ray_tpu_torch.util import tracing

    if tracing.TRACE_ON:
        tag = os.environ.get("RAY_TPU_TORCH_NODE_TAG")
        if tag:
            tracing.buffer_instant("fault:rpc_retry", f"node:{tag[:8]}")
        else:
            tracing.instant("fault:rpc_retry")


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
            _retry_pin()
            time.sleep(min(base_delay_s * (2 ** attempt), 2.0))
        else:
            if dest is not None:
                breaker_record(dest, True)
            return result
    raise RpcError(f"rpc {method} retry loop exhausted")  # unreachable
