"""The port's pipelined transport against the JAX package's: seq-tagged
frames with out-of-order replies, per-call slots (``call_async``),
per-destination coalescing into ``__batch__`` frames, and reconnects
with calls in flight (the cases of tests/test_rpc_pipeline.py), plus the
streamed parts a batch RPC rides and the epoch meta on them.

Each case runs once against each package's ``rpc`` module on a server
of the same package and returns a record; the two records must be equal
(and equal to what the reference test asserts).
"""

import importlib
import threading
import time

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _rpc(name: str):
    return importlib.import_module(f"{name}._private.rpc")


def _server(rpc):
    srv = rpc.RpcServer(host="127.0.0.1", port=0)
    srv.register("ping", lambda: "pong")
    srv.register("echo", lambda x: x, concurrent=True)
    srv.register("echo_pooled", lambda x: x, concurrent="pooled")

    def slow(x, delay):
        time.sleep(delay)
        return x

    srv.register("slow", slow, concurrent=True)

    def boom(msg):
        raise ValueError(msg)

    srv.register("boom", boom, concurrent=True)
    srv.start()
    return srv


def _rebind(rpc, port: int, timeout: float = 15.0):
    """A fresh server on a port just freed (retries TIME_WAIT)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return rpc.RpcServer(host="127.0.0.1", port=port)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def both(scenario):
    records = {}
    for name in PACKAGES:
        rpc = _rpc(name)
        srv = _server(rpc)
        try:
            records[name] = scenario(rpc, srv)
        finally:
            srv.stop()
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def out_of_order(rpc, server) -> dict:
    client = rpc.MuxRpcClient(server.address)
    try:
        slow_slot = client.call_async("slow", "slow", 1.5)
        t0 = time.monotonic()
        fast_slot = client.call_async("slow", "fast", 0.01)
        fast = fast_slot.result(10)
        fast_wait_ok = time.monotonic() - t0 < 1.0
        return {"fast": fast, "fast_not_blocked": fast_wait_ok,
                "slow": slow_slot.result(10),
                "sockets": client.num_connections()}
    finally:
        client.close()


def test_out_of_order_replies_complete_independently():
    assert both(out_of_order) == {"fast": "fast", "fast_not_blocked": True,
                                  "slow": "slow", "sockets": 1}


def many_inflight(rpc, server) -> dict:
    client = rpc.MuxRpcClient(server.address)
    try:
        slots = [client.call_async("echo", i) for i in range(200)]
        pooled = [client.call_async("echo_pooled", i) for i in range(20)]
        return {"ok": [s.result(30) for s in slots] == list(range(200)),
                "pooled": [s.result(30) for s in pooled],
                "sockets": client.num_connections()}
    finally:
        client.close()


def test_pipeline_depth_many_inflight_one_socket():
    assert both(many_inflight) == {"ok": True, "pooled": list(range(20)),
                                   "sockets": 1}


def coalesced(rpc, server) -> dict:
    client = rpc.MuxRpcClient(server.address)
    try:
        slots = [client.call_async("echo", i, coalesce=True)
                 for i in range(100)]
        values = [s.result(30) for s in slots]
        good = client.call_async("echo", "ok", coalesce=True)
        bad = client.call_async("boom", "kaput", coalesce=True)
        with pytest.raises(rpc.RpcMethodError, match="kaput"):
            bad.result(10)
        return {"values": values == list(range(100)),
                "good": good.result(10)}
    finally:
        client.close()


def test_coalesced_calls_batch_and_resolve_individually():
    assert both(coalesced) == {"values": True, "good": "ok"}


def coalesced_order(rpc, server) -> list:
    received = []
    lock = threading.Lock()

    def record(i):
        with lock:
            received.append(i)
        return i

    server.register("record", record)  # sequential: order observable
    client = rpc.MuxRpcClient(server.address)
    try:
        slots = [client.call_async("record", i, coalesce=True)
                 for i in range(50)]
        [s.result(30) for s in slots]
        return received
    finally:
        client.close()


def test_coalesced_entries_preserve_enqueue_order():
    assert both(coalesced_order) == list(range(50))


def mixed(rpc, server) -> dict:
    client = rpc.MuxRpcClient(server.address)
    try:
        direct = [client.call_async("echo", ("d", i)) for i in range(20)]
        batched = [client.call_async("echo", ("b", i), coalesce=True)
                   for i in range(20)]
        return {"direct": [s.result(30) for s in direct],
                "batched": [s.result(30) for s in batched]}
    finally:
        client.close()


def test_mixed_coalesced_and_direct_traffic():
    assert both(mixed) == {"direct": [("d", i) for i in range(20)],
                           "batched": [("b", i) for i in range(20)]}


def reconnect(rpc, server) -> dict:
    port = server.port
    client = rpc.MuxRpcClient(server.address)
    inflight = [client.call_async("slow", i, 30.0) for i in range(4)]
    # The requests are in flight before the kill.
    assert client.call("ping", timeout_s=10) == "pong"
    server.stop()
    failures = 0
    for slot in inflight:
        with pytest.raises(rpc.RpcError):
            slot.result(10)
        failures += 1
    srv2 = _rebind(rpc, port)
    srv2.register("echo", lambda x: x, concurrent=True)
    srv2.start()
    try:
        return {"failures": failures,
                "direct": client.call("echo", "direct", timeout_s=15),
                "batched": client.call("echo", "batched", coalesce=True,
                                       timeout_s=15),
                "after": [s.result(15) for s in
                          [client.call_async("echo", i)
                           for i in range(10)]]}
    finally:
        client.close()
        srv2.stop()


def test_reconnect_fails_only_inflight_calls():
    assert both(reconnect) == {"failures": 4, "direct": "direct",
                               "batched": "batched",
                               "after": list(range(10))}


def coalesced_loss(rpc, server) -> dict:
    port = server.port
    client = rpc.MuxRpcClient(server.address)
    slots = [client.call_async("slow", i, 30.0, coalesce=True)
             for i in range(3)]
    deadline = time.monotonic() + 5
    while client.num_connections() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    server.stop()
    failed = 0
    for slot in slots:
        with pytest.raises(rpc.RpcError):
            slot.result(10)
        failed += 1
    srv2 = _rebind(rpc, port)
    srv2.register("ping", lambda: "pong")
    srv2.start()
    try:
        return {"failed": failed, "ping": client.ping()}
    finally:
        client.close()
        srv2.stop()


def test_coalesced_inflight_fail_on_connection_loss():
    assert both(coalesced_loss) == {"failed": 3, "ping": True}


def timeout_unregisters(rpc, server) -> dict:
    client = rpc.MuxRpcClient(server.address)
    try:
        slot = client.call_async("slow", 1, 5.0)
        with pytest.raises(rpc.RpcError, match="timed out"):
            slot.result(0.05)
        with client._lock:
            leaked = slot.seq in (client._conn.pending
                                  if client._conn else {})
        return {"leaked": leaked,
                "ping": client.call("ping", timeout_s=10)}
    finally:
        client.close()


def test_call_async_timeout_unregisters_slot():
    assert both(timeout_unregisters) == {"leaked": False, "ping": "pong"}


def unpicklable(rpc, server) -> dict:
    client = rpc.MuxRpcClient(server.address)
    try:
        with pytest.raises(Exception):
            client.call_async("echo", threading.Lock(), coalesce=True)
        return {"after": client.call("echo", 1, coalesce=True,
                                     timeout_s=10)}
    finally:
        client.close()


def test_unpicklable_coalesced_arg_fails_caller_only():
    assert both(unpicklable) == {"after": 1}


def closed_client(rpc, server) -> dict:
    client = rpc.MuxRpcClient(server.address)
    slots = [client.call_async("slow", i, 30.0, coalesce=True)
             for i in range(3)]
    time.sleep(0.1)
    client.close()
    failed = 0
    for slot in slots:
        with pytest.raises(rpc.RpcError):
            slot.result(5)
        failed += 1
    with pytest.raises(rpc.RpcError, match="closed"):
        client.call("ping")
    return {"failed": failed}


def test_closed_client_fails_pending_coalesced_calls():
    assert both(closed_client) == {"failed": 3}


# ---------------------------------------------- streamed parts (port side)


def streaming(rpc, server) -> dict:
    def produce(n, _emit_part=None):
        for i in range(n):
            _emit_part(("results", i))
        return ("done", n)

    server.register("produce", produce, concurrent=True, streaming=True)
    metas = []
    server.reply_meta_fn = lambda: {"epoch": 7}
    client = rpc.MuxRpcClient(server.address)
    client.on_reply_meta = metas.append
    try:
        slot = client.call_streaming("produce", 5)
        parts = []
        while True:
            part = slot.next_part(10)
            if part is None:
                break
            parts.append(part)
        return {"parts": parts, "final": slot.result(10),
                "metas": len(metas)}
    finally:
        client.close()


def test_streamed_parts_then_final_reply():
    """A streaming method's parts arrive in order before its final
    reply; on a server that stamps meta (the head's epoch), every frame
    of the stream carries it in the port (the reference stamps only the
    final reply), and the values are the same."""
    records = {}
    for name in PACKAGES:
        rpc = _rpc(name)
        srv = _server(rpc)
        try:
            records[name] = streaming(rpc, srv)
        finally:
            srv.stop()
    for record in records.values():
        assert record["parts"] == [("results", i) for i in range(5)]
        assert record["final"] == ("done", 5)
    assert records["ray_tpu"]["metas"] == 1
    assert records["ray_tpu_torch"]["metas"] == 6


def tail(rpc, server) -> dict:
    blob = bytes(range(256)) * 1024
    server.register("tail", lambda: rpc.TailPayload(len(blob), blob))
    mux = rpc.MuxRpcClient(server.address)
    plain = rpc.RpcClient(server.address)
    try:
        head, view = mux.call("tail")
        out = {"mux": (head, bytes(view) == blob)}
        if hasattr(plain, "call"):
            try:
                head2, view2 = plain.call("tail")
                out["plain"] = (head2, bytes(view2) == blob)
            except Exception as exc:  # noqa: BLE001 — recorded
                out["plain"] = type(exc).__name__
        return out
    finally:
        mux.close()
        plain.close()


def test_tail_payload_reaches_both_clients():
    """A tail reply (a chunk's bytes raw after the pickle) reads as
    (head, bytes) on the multiplexed client in both packages; the
    port's one-call client reads it too (the reference's does not)."""
    records = {}
    for name in PACKAGES:
        rpc = _rpc(name)
        srv = _server(rpc)
        try:
            records[name] = tail(rpc, srv)
        finally:
            srv.stop()
    size = 256 * 1024
    assert records["ray_tpu"]["mux"] == records["ray_tpu_torch"]["mux"] \
        == (size, True)
    assert records["ray_tpu_torch"]["plain"] == (size, True)


def test_dispatch_pool_recycles_threads():
    """The recycled dispatch threads: a second wave of jobs reuses the
    threads the first one parked, in both packages."""
    for name in PACKAGES:
        rpc = _rpc(name)
        pool = rpc._ThreadRecycler(f"{name}-test", idle_s=5.0)
        done = threading.Semaphore(0)
        for _ in range(4):
            pool.submit(done.release)
        for _ in range(4):
            assert done.acquire(timeout=5)
        time.sleep(0.05)
        for _ in range(4):
            pool.submit(done.release)
        for _ in range(4):
            assert done.acquire(timeout=5)
        assert pool.reuses >= 1, name
        assert pool.spawns + pool.reuses == 8, name
