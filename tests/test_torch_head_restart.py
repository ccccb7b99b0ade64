"""The port's head restart against the JAX package's: a head process is
SIGKILLed mid-workload and started again on the same port and session
directory, and the cluster must go on.

The three cases of tests/test_head_restart.py, each once through
``ray_tpu`` (``python -m ray_tpu._private.node``) and once through
``ray_tpu_torch`` (``python -m ray_tpu_torch._private.node``), returning
plain records that must be equal, and equal to what the reference case
asserts. Where the reference sleeps for work to be dispatched, these
wait for the state itself: the daemons' reported availability of the
``worker`` marker resource dropping. The first case runs on the port's
per-task ``execute_task`` path (the reference batches; the batch RPC is
ROADMAP item 10c). Each case has a time limit of its own.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import time

import ray_tpu
import ray_tpu_torch
from torch_time_limit import time_limit

PACKAGES = {
    "ray_tpu": (ray_tpu, "RAY_TPU_SESSION_DIR"),
    "ray_tpu_torch": (ray_tpu_torch, "RAY_TPU_TORCH_SESSION_DIR"),
}


def _mod(name: str, sub: str):
    return importlib.import_module(f"{name}.{sub}")


def _spawn_head(name: str, session_dir: str, port: int = 0) -> tuple:
    node = _mod(name, "_private.node")
    rpc = _mod(name, "_private.rpc")
    env = node.daemon_child_env({PACKAGES[name][1]: session_dir})
    args = {"port": port, "dashboard_port": None}
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{name}._private.node", "head",
         json.dumps(args)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    addr_file = os.path.join(session_dir, "head_address")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        assert proc.poll() is None, "head died during startup"
        try:
            with open(addr_file) as f:
                addr = f.read().strip()
            if addr:
                # The restarted head rewrites the file: hand out a live
                # address only.
                client = rpc.RpcClient(addr, timeout_s=2.0)
                try:
                    client.call("list_nodes")
                    return proc, addr
                except (rpc.RpcError, OSError):
                    pass
                finally:
                    client.close()
        except OSError:
            pass
        time.sleep(0.2)
    raise TimeoutError("head never advertised a live address")


def _spawn_worker_daemon(name: str, gcs_address: str):
    node = _mod(name, "_private.node")
    kwargs = {"gcs_address": gcs_address,
              "resources": {"CPU": 2.0, "worker": 4.0},
              "pool_size": 0, "heartbeat_period_s": 0.5}
    if name == "ray_tpu_torch":
        kwargs["parent_pid"] = os.getpid()
    return subprocess.Popen(
        [sys.executable, "-m", f"{name}._private.node", "worker",
         json.dumps(kwargs)],
        env=node.daemon_child_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _nodes(name: str, addr: str) -> list[dict]:
    rpc = _mod(name, "_private.rpc")
    client = rpc.RpcClient(addr, timeout_s=5.0)
    try:
        return client.call("list_nodes")
    except (rpc.RpcError, OSError):
        return []
    finally:
        client.close()


def _alive_nodes(name: str, addr: str) -> list[dict]:
    return [n for n in _nodes(name, addr) if n.get("alive")]


def _worker_available(name: str, addr: str) -> float:
    """The ``worker`` marker resource the daemons report free."""
    return sum(n.get("available", {}).get("worker", 0.0)
               for n in _alive_nodes(name, addr)
               if n.get("resources", {}).get("worker"))


def _wait(predicate, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.2)
    return predicate()


def _stop(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def _both(scenario, tmp_path, limit_s: int) -> dict:
    records = {}
    for name in PACKAGES:
        (tmp_path / name).mkdir()
        with time_limit(limit_s):
            records[name] = scenario(name, tmp_path / name)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def inflight_tasks_and_broadcast_drain(name, tmp_path):
    import numpy as np

    rt = PACKAGES[name][0]
    session = str(tmp_path / "session")
    os.makedirs(session)
    head_proc, addr = _spawn_head(name, session)
    port = int(addr.rsplit(":", 1)[1])
    workers = [_spawn_worker_daemon(name, addr) for _ in range(2)]
    runtime = None
    try:
        assert _wait(lambda: len(_alive_nodes(name, addr)) >= 3, 60)
        runtime = rt.init(address=addr, num_cpus=0)
        assert _wait(lambda: rt.cluster_resources().get("worker", 0) >= 8,
                     30)

        @rt.remote(num_cpus=1, resources={"worker": 1}, max_retries=3)
        def slow_batch(i):
            import time as _t

            _t.sleep(5.0)
            return i

        # Pulled by the daemons from the driver's export server, never
        # through the head.
        blob_ref = rt.put(np.arange(1_000_000, dtype=np.float64))

        @rt.remote(num_cpus=1, resources={"worker": 1}, max_retries=3)
        def touch(arr, i):
            return (i, float(arr[0]), len(arr))

        refs = [slow_batch.remote(i) for i in range(12)]
        bcast = [touch.remote(blob_ref, i) for i in range(6)]
        # Dispatched: the daemons report their worker slots taken.
        assert _wait(lambda: _worker_available(name, addr) < 8, 60)

        head_proc.send_signal(signal.SIGKILL)
        head_proc.wait(timeout=10)
        head_proc, addr2 = _spawn_head(name, session, port=port)
        record = {"same_port": addr2.rsplit(":", 1)[1] == str(port),
                  "results": sorted(rt.get(refs, timeout=180.0)),
                  "bcast": sorted(rt.get(bcast, timeout=180.0))}
        record["reregistered"] = _wait(
            lambda: len(_alive_nodes(name, addr)) >= 3, 90)
        record["new_work"] = rt.get(slow_batch.remote(99), timeout=120.0)
        return record
    finally:
        if runtime is not None:
            rt.shutdown()
        _stop([head_proc, *workers])


def test_head_kill_with_inflight_tasks_and_broadcast_drains(tmp_path):
    assert _both(inflight_tasks_and_broadcast_drain, tmp_path, 420) == {
        "same_port": True, "results": list(range(12)),
        "bcast": [(i, 0.0, 1_000_000) for i in range(6)],
        "reregistered": True, "new_work": 99}


def sigkill_mid_mutation_full_state_survives(name, tmp_path):
    rpc = _mod(name, "_private.rpc")
    stale_type = _mod(name, "_private.gcs").StaleEpochError
    session = str(tmp_path / "session")
    os.makedirs(session)
    head_proc, addr = _spawn_head(name, session)
    port = int(addr.rsplit(":", 1)[1])
    client = rpc.RpcClient(addr, timeout_s=10.0)
    acked = []
    try:
        old_epoch = client.call("gcs_epoch")
        node_id = client.call("register_node", "10.3.3.3:17",
                              {"CPU": 4.0}, {"rack": "r9"},
                              "10.3.3.3:900")
        client.call("object_locations_update", "owner-x",
                    [("ab" * 10, ["n1", "n2"]), ("cd" * 10, "n2")], [],
                    epoch=old_epoch)
        beat = client.call(
            "heartbeat", node_id, None,
            {"spill_events": [("owner-x", "cd" * 10, "spilled")]},
            None, epoch=old_epoch)
        client.call("actor_update", [{
            "actor_id": b"\x21" * 16, "name": "survivor",
            "namespace": "default", "class_name": "Keeper",
            "state": "RESTARTING", "max_restarts": 4,
            "num_restarts": 3}], epoch=old_epoch)
        client.call("pg_update", "job-x",
                    [{"pg_id": "ee" * 14, "state": "CREATED",
                      "strategy": "PACK", "bundles": []}],
                    epoch=old_epoch)
        # A write burst the SIGKILL lands in; every acked put is framed
        # on disk already.
        for i in range(50):
            client.call("kv_put", f"burst-{i}".encode(), b"v", "t")
            acked.append(i)
            if i == 29:
                head_proc.send_signal(signal.SIGKILL)
    except (rpc.RpcError, OSError):
        pass  # the burst died with the head
    finally:
        client.close()
    head_proc.wait(timeout=10)

    head_proc, addr2 = _spawn_head(name, session, port=port)
    client = rpc.RpcClient(addr2, timeout_s=10.0)
    try:
        stats = client.call("gcs_persist_stats")
        nodes = {n["address"]: n for n in client.call("list_nodes")}
        actors = {a["name"]: a for a in client.call("list_cluster_actors")}
        locs, spilled = client.call("list_object_locations", None, True)
        pgs = client.call("list_cluster_placement_groups")
        missing = [i for i in acked
                   if client.call("kv_get", f"burst-{i}".encode(), "t")
                   != b"v"]
        try:
            client.call("heartbeat", node_id, None, None, None,
                        epoch=old_epoch)
            fenced = None
        except rpc.RpcMethodError as exc:
            fenced = isinstance(exc.cause, stale_type)
        return {
            "old_epoch": isinstance(old_epoch, int) and old_epoch >= 1,
            "beat": beat, "burst_acked": len(acked) >= 30,
            "replayed": stats["wal_records_replayed"] > 0,
            "epoch_up": stats["epoch"] > old_epoch,
            "alive": nodes["10.3.3.3:17"]["alive"],
            "labels": nodes["10.3.3.3:17"]["labels"],
            "actor": (actors["survivor"]["state"],
                      actors["survivor"]["num_restarts"]),
            "locs": locs["ab" * 10],
            "spilled_on_node": spilled.get("cd" * 10) == node_id.hex(),
            "pg": pgs["job-x"][0]["pg_id"], "missing": missing,
            "fenced": fenced}
    finally:
        client.close()
        _stop([head_proc])


def test_head_sigkill_mid_mutation_full_state_survives(tmp_path):
    assert _both(sigkill_mid_mutation_full_state_survives, tmp_path,
                 180) == {
        "old_epoch": True, "beat": True, "burst_acked": True,
        "replayed": True, "epoch_up": True, "alive": True,
        "labels": {"rack": "r9"}, "actor": ("RESTARTING", 3),
        "locs": ["n1", "n2"], "spilled_on_node": True, "pg": "ee" * 14,
        "missing": [], "fenced": True}


def kill_restart_cluster_resumes(name, tmp_path):
    rt = PACKAGES[name][0]
    rpc = _mod(name, "_private.rpc")
    internal_kv = _mod(name, "experimental.internal_kv")
    session = str(tmp_path / "session")
    os.makedirs(session)
    head_proc, addr = _spawn_head(name, session)
    port = int(addr.rsplit(":", 1)[1])
    workers = [_spawn_worker_daemon(name, addr) for _ in range(2)]
    runtime = None
    try:
        assert _wait(lambda: len(_alive_nodes(name, addr)) >= 3, 60)
        runtime = rt.init(address=addr, num_cpus=0)
        assert _wait(lambda: rt.cluster_resources().get("worker", 0) >= 8,
                     30)
        internal_kv.internal_kv_put(b"durable-key", b"durable-value")

        head_client = rpc.RpcClient(addr, timeout_s=10.0)
        submission_id = head_client.call(
            "submit_job", f"{sys.executable} -c 'print(42)'")
        job = None

        def job_done():
            nonlocal job
            job = head_client.call("job_status", submission_id)
            return bool(job) and job.get("status") in ("SUCCEEDED",
                                                       "FAILED")

        _wait(job_done, 60)
        record = {"job_before": job["status"]}
        head_client.close()

        @rt.remote(num_cpus=1, resources={"worker": 1})
        class Keeper:
            def __init__(self):
                self.values = {}

            def put(self, k, v):
                self.values[k] = v
                return len(self.values)

            def get(self, k):
                return self.values.get(k)

        keeper = Keeper.options(name="keeper", lifetime="detached").remote()
        record["put_a"] = rt.get(keeper.put.remote("a", 1), timeout=60)
        # The keeper holds one worker slot once placed.
        assert _wait(lambda: _worker_available(name, addr) <= 7, 60)

        @rt.remote(num_cpus=1, resources={"worker": 1})
        def slow():
            import time as _t

            _t.sleep(8.0)
            return "survived"

        pending = slow.remote()
        # Running on a daemon: a second slot is taken.
        assert _wait(lambda: _worker_available(name, addr) <= 6, 60)

        head_proc.send_signal(signal.SIGKILL)
        head_proc.wait(timeout=10)
        head_proc, addr2 = _spawn_head(name, session, port=port)
        record["same_port"] = addr2.rsplit(":", 1)[1] == str(port)
        record["pending"] = rt.get(pending, timeout=120.0)
        record["reregistered"] = _wait(
            lambda: len(_alive_nodes(name, addr)) >= 3, 90)
        record["kv"] = internal_kv.internal_kv_get(b"durable-key")
        head_client = rpc.RpcClient(addr, timeout_s=10.0)
        record["job_after"] = (head_client.call("job_status",
                                                submission_id) or {}) \
            .get("status")
        head_client.close()
        again = rt.get_actor("keeper")
        record["get_a"] = rt.get(again.get.remote("a"), timeout=60)
        record["put_b"] = rt.get(again.put.remote("b", 2), timeout=60)
        return record
    finally:
        if runtime is not None:
            rt.shutdown()
        _stop([head_proc, *workers])


def test_head_kill_restart_cluster_resumes(tmp_path):
    assert _both(kill_restart_cluster_resumes, tmp_path, 420) == {
        "job_before": "SUCCEEDED", "put_a": 1, "same_port": True,
        "pending": "survived", "reregistered": True,
        "kv": b"durable-value", "job_after": "SUCCEEDED", "get_a": 1,
        "put_b": 2}
