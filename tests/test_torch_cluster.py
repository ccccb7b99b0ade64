"""The port's cluster control plane against the JAX package's: the RPC
layer, the head (``GcsServer``), node agents, job submission and the
driver's connected mode (the cases of tests/test_cluster.py).

Each mirrored case runs once through ``ray_tpu`` and once through
``ray_tpu_torch``, each against a head of its own package in this
process, and returns a plain record; the two must be equal, and equal to
what the reference test asserts. Waits are deadlines, not sleeps.

Where the port deliberately differs: the head has no persistence, no
restart epochs and no shards (ROADMAP item 10b). Two cases of
tests/test_cluster.py are not mirrored: ``test_cli_start_status_job_stop``
and ``test_head_daemon_executes_driver_tasks`` drive the
``python -m ray_tpu`` command line, which the port does not have yet
(item 12).
"""

import importlib
import sys

import pytest

from torch_cluster_sides import PACKAGES, wait_until


def _mods(name: str):
    return (importlib.import_module(f"{name}._private.rpc"),
            importlib.import_module(f"{name}._private.gcs_server"),
            importlib.import_module(f"{name}._private.node"))


def _with_head(scenario, tmp_path) -> dict:
    """The scenario's record through both packages, each with a head
    whose heartbeat timeout is 1 s; they must agree."""
    records = {}
    for name in PACKAGES:
        rpc, gcs_server, node = _mods(name)
        server = gcs_server.GcsServer(host="127.0.0.1",
                                      log_dir=str(tmp_path / name),
                                      heartbeat_timeout_s=1.0)
        server.start()
        try:
            records[name] = scenario(name, server.address, rpc, node)
        finally:
            server.stop()
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _both(scenario) -> dict:
    records = {name: scenario(*_mods(name)) for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


# ------------------------------------------------------------------- rpc


def rpc_roundtrip(rpc, gcs_server, node) -> dict:
    server = rpc.RpcServer(host="127.0.0.1")
    server.register("add", lambda a, b: a + b)
    server.register("boom", lambda: 1 / 0)
    server.register("ping", lambda: "pong")
    server.start()
    try:
        client = rpc.RpcClient(server.address)
        record = {"add": client.call("add", 2, 3),
                  "add_kwargs": client.call("add", a=10, b=20),
                  "ping": client.ping()}
        try:
            client.call("boom")
        except rpc.RpcMethodError as exc:
            record["boom"] = (type(exc.cause).__name__,
                              "ZeroDivisionError" in exc.remote_tb)
        try:
            client.call("no_such_method")
        except rpc.RpcMethodError as exc:
            record["unknown"] = type(exc).__name__
        client.close()
        return record
    finally:
        server.stop()


def test_rpc_roundtrip_and_errors():
    assert _both(rpc_roundtrip) == {
        "add": 5, "add_kwargs": 30, "ping": True,
        "boom": ("ZeroDivisionError", True), "unknown": "RpcMethodError"}


def rpc_reconnects(rpc, gcs_server, node) -> dict:
    server = rpc.RpcServer(host="127.0.0.1")
    server.register("echo", lambda x: x)
    server.start()
    client = rpc.RpcClient(server.address)
    first = client.call("echo", "a")
    # The client's socket dies under it: the next call reconnects.
    client._sock.close()
    second = client.call("echo", "b")
    server.stop()
    try:
        client.call("echo", "c")
        after_stop = None
    except rpc.RpcError as exc:
        after_stop = type(exc).__name__
    return {"first": first, "second": second, "after_stop": after_stop}


def test_rpc_client_reconnects():
    assert _both(rpc_reconnects) == {"first": "a", "second": "b",
                                     "after_stop": "RpcError"}


def rpc_large(rpc, gcs_server, node) -> dict:
    server = rpc.RpcServer(host="127.0.0.1")
    server.register("length", lambda blob: len(blob))
    server.start()
    try:
        return {"length": rpc.RpcClient(server.address).call(
            "length", b"x" * (5 << 20))}
    finally:
        server.stop()


def test_rpc_large_payload():
    assert _both(rpc_large) == {"length": 5 << 20}


# ------------------------------------------------------------- the head


def register_heartbeat_death(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    agent = node.NodeAgent(address, {"CPU": 4.0},
                           labels={"node_role": "worker"},
                           heartbeat_period_s=0.2)
    nodes = client.call("list_nodes")
    record = {"registered": [(n["alive"], n["resources"]) for n in nodes],
              "cluster": client.call("cluster_resources")}
    # Heartbeats stop (no drain): the monitor marks the node dead.
    agent._shutdown.set()
    record["marked_dead"] = wait_until(
        lambda: not client.call("list_nodes")[0]["alive"], 10)
    record["cluster_after"] = client.call("cluster_resources")
    agent.client.close()
    return record


def test_node_register_heartbeat_death(tmp_path):
    assert _with_head(register_heartbeat_death, tmp_path) == {
        "registered": [(True, {"CPU": 4.0})], "cluster": {"CPU": 4.0},
        "marked_dead": True, "cluster_after": {}}


def drain_on_stop(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    agent = node.NodeAgent(address, {"CPU": 2.0}, heartbeat_period_s=0.2)
    agent.stop(drain=True)
    return {"nodes": [n["alive"] for n in client.call("list_nodes")]}


def test_node_drain_on_stop(tmp_path):
    assert _with_head(drain_on_stop, tmp_path) == {"nodes": [False]}


def kv(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    client.call("kv_put", b"k1", b"v1")
    record = {"get": client.call("kv_get", b"k1"),
              "exists": client.call("kv_exists", b"k1"),
              "keys": client.call("kv_keys", b"k")}
    client.call("kv_del", b"k1")
    record["after_del"] = client.call("kv_get", b"k1")
    return record


def test_gcs_kv(tmp_path):
    assert _with_head(kv, tmp_path) == {
        "get": b"v1", "exists": True, "keys": [b"k1"], "after_del": None}


def _job_end(client, sub_id) -> dict:
    status = {}

    def ended():
        status.update(client.call("job_status", sub_id))
        return status["status"] in ("SUCCEEDED", "FAILED")

    wait_until(ended, 30)
    return status


def job_success(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    sub_id = client.call("submit_job", f"{sys.executable} -c 'print(6*7)'")
    status = _job_end(client, sub_id)
    return {"status": status["status"],
            "logs": b"42" in client.call("job_logs", sub_id),
            "listed": any(j["submission_id"] == sub_id
                          for j in client.call("list_jobs"))}


def test_job_submit_success_and_logs(tmp_path):
    assert _with_head(job_success, tmp_path) == {
        "status": "SUCCEEDED", "logs": True, "listed": True}


def job_failure(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    sub_id = client.call("submit_job",
                         f"{sys.executable} -c 'raise SystemExit(3)'")
    status = _job_end(client, sub_id)
    return {"status": status["status"],
            "exit_code": "exit code 3" in status["message"]}


def test_job_failure_reported(tmp_path):
    assert _with_head(job_failure, tmp_path) == {"status": "FAILED",
                                                 "exit_code": True}


def job_stop(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    sub_id = client.call(
        "submit_job", f"{sys.executable} -c 'import time; time.sleep(60)'")
    assert wait_until(lambda: client.call("job_status", sub_id)["status"]
                      == "RUNNING", 10)
    stopped = client.call("stop_job", sub_id)
    # The exit watcher has run once the job has no process to stop; it
    # must keep STOPPED (not FAILED).
    watcher_ran = wait_until(
        lambda: client.call("stop_job", sub_id) is False, 10)
    return {"stopped": stopped, "watcher_ran": watcher_ran,
            "status": client.call("job_status", sub_id)["status"],
            "unknown": client.call("job_status", "raysubmit_nonexistent")}


def test_job_stop(tmp_path):
    assert _with_head(job_stop, tmp_path) == {
        "stopped": True, "watcher_ran": True, "status": "STOPPED",
        "unknown": None}


def job_idempotent(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    sub = client.call("submit_job", f"{sys.executable} -c 'print(1)'",
                      submission_id="raysubmit_fixed")
    sub2 = client.call("submit_job", f"{sys.executable} -c 'print(1)'",
                       submission_id="raysubmit_fixed")
    records = [j for j in client.call("list_jobs")
               if j and j["submission_id"] == "raysubmit_fixed"]
    _job_end(client, sub)
    return {"ids": [sub, sub2], "records": len(records)}


def test_job_submit_idempotent_on_submission_id(tmp_path):
    assert _with_head(job_idempotent, tmp_path) == {
        "ids": ["raysubmit_fixed", "raysubmit_fixed"], "records": 1}


def driver_registers(name, address, rpc, node) -> dict:
    rt = PACKAGES[name][0]
    rt.shutdown()
    rt.init(num_cpus=2, address=address)
    try:
        client = rpc.RpcClient(address)
        roles = [n["labels"].get("node_role")
                 for n in client.call("list_nodes")]
        merged = [n["Labels"].get("node_role", "") for n in rt.nodes()]
        record = {"driver_at_head": "driver" in roles,
                  "driver_in_nodes": "driver" in merged}
    finally:
        rt.shutdown()
    drivers = [n for n in rpc.RpcClient(address).call("list_nodes")
               if n["labels"].get("node_role") == "driver"]
    record["drained"] = bool(drivers) and not drivers[0]["alive"]
    return record


def test_init_address_registers_driver(tmp_path):
    assert _with_head(driver_registers, tmp_path) == {
        "driver_at_head": True, "driver_in_nodes": True, "drained": True}


def usage_rides_heartbeats(name, address, rpc, node) -> dict:
    usage = {"value": {"CPU": 3.0}}
    agent = node.NodeAgent(address, {"CPU": 4.0}, heartbeat_period_s=0.1,
                           usage_fn=lambda: usage["value"])
    client = rpc.RpcClient(address)

    def available():
        return client.call("list_nodes")[0].get("available", {})

    first = wait_until(lambda: available() == {"CPU": 3.0}, 10)
    usage["value"] = {"CPU": 1.0}
    second = wait_until(lambda: available() == {"CPU": 1.0}, 10)
    agent.stop()
    return {"first": first, "second": second}


def test_heartbeat_carries_resource_usage(tmp_path):
    assert _with_head(usage_rides_heartbeats, tmp_path) == {
        "first": True, "second": True}


def reregisters(name, address, rpc, node) -> dict:
    client = rpc.RpcClient(address)
    agent = node.NodeAgent(address, {"CPU": 3.0}, heartbeat_period_s=0.2)
    old_id = agent.node_id
    # Marked dead behind the agent's back, as a stale heartbeat would.
    client.call("drain_node", old_id)
    refused = client.call("heartbeat", old_id, None) is False
    moved = wait_until(lambda: agent.node_id != old_id, 10)
    alive = [n for n in client.call("list_nodes") if n["alive"]]
    agent.stop()
    return {"refused": refused, "new_id": moved,
            "alive": [n["resources"] for n in alive]}


def test_heartbeat_rejects_dead_node_and_agent_reregisters(tmp_path):
    assert _with_head(reregisters, tmp_path) == {
        "refused": True, "new_id": True, "alive": [{"CPU": 3.0}]}


# --------------------------------------------------------------- port only


def test_call_with_retry_retries_transport_failures_only():
    """An idempotent call that fails in transport is retried; one whose
    method raised is not (the failure is the answer)."""
    from ray_tpu_torch._private import rpc

    calls = []

    def flaky(method, *args, **kwargs):
        calls.append(method)
        if len(calls) < 3:
            raise rpc.RpcError("dropped", maybe_executed=True)
        return "ok"

    assert rpc.call_with_retry(flaky, "m", attempts=3,
                               base_delay_s=0.0) == "ok"
    assert len(calls) == 3

    def raises(method, *args, **kwargs):
        calls.append(method)
        raise rpc.RpcMethodError(ValueError("no"), "tb")

    calls.clear()
    with pytest.raises(rpc.RpcMethodError):
        rpc.call_with_retry(raises, "m", attempts=3, base_delay_s=0.0)
    assert calls == ["m"]
    assert rpc.classify_rpc_failure(rpc.RpcError("x")) == "retryable"
    assert rpc.classify_rpc_failure(
        rpc.RpcError("x", maybe_executed=True)) == "maybe_executed"
    assert rpc.classify_rpc_failure(
        rpc.RpcMethodError(ValueError(), "")) == "poisoned"


def test_breaker_opens_after_consecutive_failures(monkeypatch):
    from ray_tpu_torch._private import rpc

    monkeypatch.setattr(rpc, "BREAKER_FAILURES", 2)
    monkeypatch.setattr(rpc, "BREAKER_RESET_S", 60.0)
    rpc.reset_breakers()
    try:
        class Dead:
            address = "127.0.0.1:1"

            def call(self, method, *args, **kwargs):
                raise OSError("refused")

        for _ in range(2):
            with pytest.raises(OSError):
                rpc.call_with_retry(Dead().call, "m", attempts=1,
                                    base_delay_s=0.0, deadline_s=1.0)
        with pytest.raises(rpc.RpcError, match="breaker open"):
            rpc.call_with_retry(Dead().call, "m", attempts=1,
                                base_delay_s=0.0, deadline_s=1.0)
        assert rpc.breaker_stats()["open_now"] == ["127.0.0.1:1"]
    finally:
        rpc.reset_breakers()


def test_head_publishes_node_death_and_resources(tmp_path):
    """The head pushes membership and availability on its channels."""
    from ray_tpu_torch._private.gcs_pubsub import GcsSubscriber
    from ray_tpu_torch._private.gcs_server import GcsServer
    from ray_tpu_torch._private.node import NodeAgent

    server = GcsServer(log_dir=str(tmp_path), heartbeat_timeout_s=1.0)
    server.start()
    try:
        sub = GcsSubscriber(server.address, ["nodes", "node_resources"])
        agent = NodeAgent(server.address, {"CPU": 2.0},
                          heartbeat_period_s=0.1,
                          usage_fn=lambda: {"CPU": 1.5})
        seen = []
        assert wait_until(lambda: seen.extend(sub.poll(0.2)) or (
            ("node_resources", (agent.node_id.hex(), {"CPU": 1.5}))
            in seen), 10)
        agent._shutdown.set()
        assert wait_until(lambda: seen.extend(sub.poll(0.2)) or (
            ("nodes", ("DEAD", agent.node_id.hex())) in seen), 10)
        assert ("nodes", ("ALIVE", agent.node_id.hex())) in seen
        sub.close()
        agent.client.close()
    finally:
        server.stop()


def test_a_pruned_subscriber_is_told_it_missed_messages(tmp_path):
    """A subscriber the head pruned subscribes again on its next poll,
    and that poll starts with ``("resubscribed", None)``, so the node
    watcher reads the node table again."""
    from ray_tpu_torch._private.gcs_pubsub import GcsSubscriber
    from ray_tpu_torch._private.gcs_server import GcsServer

    server = GcsServer(log_dir=str(tmp_path), heartbeat_timeout_s=1.0)
    server.start()
    try:
        sub = GcsSubscriber(server.address, ["nodes"])
        assert sub.poll(0.0) == []
        assert server.pubsub.unsubscribe(sub.sub_id)
        server.pubsub.publish("nodes", ("ALIVE", "missed"))
        assert sub.poll(0.0) == [("resubscribed", None)]
        server.pubsub.publish("nodes", ("ALIVE", "seen"))
        assert sub.poll(1.0) == [("nodes", ("ALIVE", "seen"))]
        sub.close()
    finally:
        server.stop()


def test_restart_head_is_refused(tmp_path):
    """Without a head there is nothing to restart; with a durable head
    (``persist_path``) the crash-shaped restart comes back on its port
    with its KV and the next epoch."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False)
    with pytest.raises(RuntimeError, match="no head"):
        cluster.restart_head()
    with pytest.raises(RuntimeError, match="no head"):
        cluster.address
    cluster = Cluster(log_dir=str(tmp_path / "log"),
                      persist_path=str(tmp_path / "gcs_snapshot.pkl"))
    try:
        address, epoch = cluster.address, cluster.gcs.epoch
        cluster.gcs._kv_put(b"k", b"v")
        cluster.restart_head(graceful=False)
        assert cluster.address == address
        assert cluster.gcs.epoch == epoch + 1
        assert cluster.gcs.gcs.kv.get(b"k") == b"v"
    finally:
        cluster.shutdown()
