"""The port's node layer against the JAX package's: worker-node daemons
run tasks, and objects move node to node without the driver relaying
them (the cases of tests/test_distributed_exec.py).

Each mirrored case is a scenario that runs once against a ``ray_tpu``
cluster and once against a ``ray_tpu_torch`` one (a head in this
process, daemons as processes, a driver with no CPU of its own) and
returns a plain record; the two records must be equal, and equal to what
the reference test asserts. A case that kills no node shares one
module-scoped cluster per package; the kill case starts its own, and
the admission case runs a node executor in this process. Waits are
deadlines on events, not sleeps.

Where the port deliberately differs:

- a task asks for ``GPU``, not ``TPU``; a ``GPU`` task runs in the
  daemon's own process, on the card its lease names, and a daemon that
  declares more ``GPU`` than it sees refuses to start (the port-only
  cases at the end; here ``RAY_TPU_TORCH_NUM_GPUS`` stands for a card);
- the tasks a dispatch pass claims for one node ride one
  ``execute_task_batch`` RPC, a claim of one too (the reference sends
  that on its single path, or in a columnar run of its dispatch lanes,
  which are not ported), so the spillback case makes both paths refuse
  once per node, as for the reference;
- the node tag is ``RAY_TPU_TORCH_NODE_TAG`` and the package cache
  ``ray_tpu_torch_pkg_cache``.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from torch_cluster_sides import (
    PACKAGES,
    Side,
    both,
    start_clusters,
    stop_clusters,
    wait_until,
)


@pytest.fixture(scope="module")
def two_node(tmp_path_factory):
    sides = start_clusters(tmp_path_factory.mktemp("dist"),
                            [{"num_cpus": 2}, {"num_cpus": 2}])
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


# ------------------------- mirrored, a cluster of their own (run first)


def daemon_death(side: Side) -> dict:
    tag_env = side.tag_env

    @side.rt.remote(max_retries=3, scheduling_strategy="SPREAD")
    def slowish(i):
        import os
        import time

        time.sleep(0.3)
        return i, os.environ.get(tag_env)

    refs = [slowish.remote(i) for i in range(12)]
    node_id = side.remote_node_ids()[0]
    with side.runtime._remote_nodes_lock:
        handle = side.runtime._remote_nodes[node_id]
    # Kill the daemon once tasks are running on it.
    assert wait_until(
        lambda: handle.pool.call("executor_stats")["running"] > 0)
    os.kill(handle.pool.call("exec_ping"), signal.SIGKILL)
    results = side.rt.get(refs, timeout=120)
    return {"all_done": sorted(i for i, _ in results) == list(range(12))}


def test_daemon_death_retries_on_survivor(tmp_path):
    sides = start_clusters(tmp_path, [{"num_cpus": 2}, {"num_cpus": 2}])
    try:
        assert both(daemon_death, sides) == {"all_done": True}
    finally:
        stop_clusters({n: s.cluster for n, s in sides.items()})


def admission(name: str) -> dict:
    """A full node answers busy instead of queueing foreign work."""
    import importlib

    serialization = importlib.import_module(f"{name}._private.serialization")
    executor_mod = importlib.import_module(f"{name}._private.node_executor")
    rpc = importlib.import_module(f"{name}._private.rpc")
    service = executor_mod.NodeExecutorService(
        host="127.0.0.1", resources={"CPU": 1.0}, pool_size=1).start()
    try:
        def make_args(seconds):
            return serialization.serialize_framed(((seconds,), {}))

        blob = serialization.dumps_function(
            lambda s: (time.sleep(s), "done")[1])
        slow_client = rpc.RpcClient(f"127.0.0.1:{service.port}")
        box = {}

        def run_slow():
            box["slow"] = slow_client.call(
                "execute_task", "digest-slow", blob, make_args(2.0), 1,
                [b"r" * 20], None, {"CPU": 1.0})

        thread = threading.Thread(target=run_slow)
        thread.start()
        assert wait_until(lambda: bool(service._running), 10)
        probe = rpc.RpcClient(f"127.0.0.1:{service.port}")
        reply = probe.call("execute_task", "digest-probe", blob,
                           make_args(0.0), 1, [b"p" * 20], None,
                           {"CPU": 1.0})
        thread.join(timeout=20)
        probe.close()
        slow_client.close()
        return {"probe": reply[0], "slow": box["slow"][0]}
    finally:
        service.stop()


def test_executor_admission_rejects_over_capacity():
    records = {name: admission(name) for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "probe": "busy", "slow": "ok"}


# --------------------------------------------------------------- port only


def test_gpu_task_runs_in_the_daemon_process_on_its_leased_card(tmp_path):
    """A ``num_gpus=1`` task runs in the daemon's own process (not a
    pool worker), with its lease's card; a second one waits for it, as
    the node has one card. Plain CPU tasks, alone or in a burst that
    rides batch RPCs, run in pool workers, which see no card: a node
    with a card fuses none of them into its own process."""
    sides = start_clusters(
        tmp_path, [{"num_cpus": 2, "resources": {"GPU": 1},
                    "env": {"RAY_TPU_TORCH_NUM_GPUS": "1"}}],
        names=("ray_tpu_torch",))
    side = sides["ray_tpu_torch"]
    try:
        rt = side.rt
        assert rt.cluster_resources().get("GPU") == 1.0
        daemon_pid = side.cluster.worker_nodes[0].pid

        @rt.remote(num_gpus=1)
        def on_card(x):
            import os

            import torch

            return os.getpid(), os.environ["CUDA_VISIBLE_DEVICES"], \
                torch.as_tensor(x) * 2

        pid, visible, doubled = rt.get(on_card.remote(21), timeout=60)
        assert pid == daemon_pid and visible == "0"
        assert doubled.item() == 42

        @rt.remote
        def on_pool():
            import os

            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

        pool_pid, pool_visible = rt.get(on_pool.remote(), timeout=60)
        assert pool_pid != daemon_pid and pool_visible == ""
        handle = side.handles()[0]
        rpcs0 = handle._control.call("executor_stats")["pipeline"][
            "batch_rpcs"]
        burst = rt.get([on_pool.remote() for _ in range(40)], timeout=60)
        assert {visible for _, visible in burst} == {""}
        assert daemon_pid not in {pid for pid, _ in burst}
        pipe = handle._control.call("executor_stats")["pipeline"]
        assert pipe["batch_rpcs"] > rpcs0 and pipe["fused_tasks"] == 0
        assert wait_until(lambda: rt.available_resources().get("GPU")
                           == 1.0)
    finally:
        stop_clusters({"ray_tpu_torch": side.cluster})


def test_a_gpu_daemon_without_a_card_refuses_to_start(tmp_path):
    from ray_tpu_torch._private.node import daemon_child_env

    env = daemon_child_env({"RAY_TPU_TORCH_NUM_GPUS": "0"})
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._private.node", "worker",
         '{"gcs_address": "127.0.0.1:1", "resources": {"CPU": 1, '
         '"GPU": 1}}'], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "does not run GPU work on the CPU" in out.stderr


# ------------------ mirrored: test_distributed_exec, on the shared cluster


def fanout(side: Side) -> dict:
    tag_env = side.tag_env

    @side.rt.remote(scheduling_strategy="SPREAD")
    def where():
        import os

        return os.environ.get(tag_env), os.getpid()

    results = side.rt.get([where.remote() for _ in range(50)],
                          timeout=120)
    tags = {tag for tag, _ in results}
    return {"ran_outside_daemon": None in tags,
            "daemons": len(tags) >= 2,
            "processes": len({pid for _, pid in results}) >= 2}


def test_fanout_executes_on_multiple_daemons(two_node):
    assert both(fanout, two_node) == {
        "ran_outside_daemon": False, "daemons": True, "processes": True}


def chain(side: Side) -> dict:
    node_a, node_b = side.remote_node_ids()[:2]

    @side.rt.remote
    def produce():
        import numpy as np

        return np.arange(500_000, dtype=np.float64)  # ~4 MB

    @side.rt.remote
    def consume(arr):
        return float(arr.sum())

    g_ref = produce.options(scheduling_strategy=side.affinity(
        node_id=node_a.hex(), soft=False)).remote()
    f_ref = consume.options(scheduling_strategy=side.affinity(
        node_id=node_b.hex(), soft=False)).remote(g_ref)
    total = side.rt.get(f_ref, timeout=120)
    placeholder = type(side.runtime.store._entries[g_ref.id()].value)
    record = {"sum": total,
              "driver_holds_placeholder":
                  placeholder is side.node_executor().RemoteBlob,
              "driver_reads_it": float(side.rt.get(g_ref).sum())}
    return record


def test_task_chain_across_nodes_driver_never_relays(two_node):
    expected = float(np.arange(500_000, dtype=np.float64).sum())
    assert both(chain, two_node) == {
        "sum": expected, "driver_holds_placeholder": True,
        "driver_reads_it": expected}


def task_error(side: Side) -> dict:
    @side.rt.remote
    def boom():
        raise ValueError("remote-boom")

    try:
        side.rt.get(boom.remote(), timeout=60)
    except Exception as exc:  # noqa: BLE001 — recorded
        return {"error": type(exc).__name__,
                "is_task_error": isinstance(exc,
                                            side.exceptions().TaskError),
                "message": "remote-boom" in str(exc)}
    return {"error": None}


def test_remote_task_error_propagates(two_node):
    assert both(task_error, two_node) == {
        "error": "TaskError", "is_task_error": True, "message": True}


def large_arg(side: Side) -> dict:
    before = side.runtime._export_store.stats()
    big = side.rt.put(np.arange(300_000, dtype=np.float64))  # ~2.4 MB

    @side.rt.remote(scheduling_strategy="SPREAD")
    def use(arr, i):
        return float(arr[i])

    out = side.rt.get([use.remote(big, i) for i in range(10)], timeout=120)
    after = side.runtime._export_store.stats()
    return {"out": out,
            "exported_once": after["num_blobs"] - before["num_blobs"] == 1,
            # At most one pull per node, of at most two chunks.
            "pulls_bounded": after["fetches_served"]
            - before["fetches_served"] <= 2 * 2}


def test_large_driver_arg_exported_and_cached(two_node):
    assert both(large_arg, two_node) == {
        "out": [float(i) for i in range(10)], "exported_once": True,
        "pulls_bounded": True}


def spill_on_busy(side: Side) -> dict:
    """Each node refuses its first lease; the task spills to the other
    node (or, once both refused, retries) and every task lands."""
    busy_error = side.node_executor().NodeBusyError
    busy_counts = {}
    patched = []
    for handle in side.handles():
        orig = handle.execute
        busy_counts[handle.address] = 0

        def flaky(*args, _orig=orig, _addr=handle.address, **kwargs):
            if busy_counts[_addr] < 1:
                busy_counts[_addr] += 1
                raise busy_error(_addr)
            return _orig(*args, **kwargs)

        handle.execute = flaky
        patched.append(handle)
        # The first task may go through the batch path instead; it
        # refuses once there too.
        orig_batch = handle.execute_batch

        def flaky_batch(entries, on_results, *args, _orig=orig_batch,
                        _addr=handle.address, **kwargs):
            if busy_counts[_addr] < 1:
                busy_counts[_addr] += 1
                on_results([(i, ("busy",)) for i in range(len(entries))])
                return len(entries), {}
            return _orig(entries, on_results, *args, **kwargs)

        handle.execute_batch = flaky_batch
    try:
        @side.rt.remote
        def plus(x):
            return x + 1

        out = side.rt.get([plus.remote(i) for i in range(6)], timeout=60)
    finally:
        for handle in patched:
            for attr in ("execute", "execute_batch"):
                handle.__dict__.pop(attr, None)
    return {"out": out, "busy_seen": sum(busy_counts.values()) >= 1}


def test_driver_spills_to_other_node_on_busy(two_node):
    assert both(spill_on_busy, two_node) == {
        "out": [1, 2, 3, 4, 5, 6], "busy_seen": True}


def py_modules(side: Side, tmp_path) -> dict:
    mod_dir = tmp_path / side.name / "shipped_mod"
    mod_dir.mkdir(parents=True)
    (mod_dir / "__init__.py").write_text("MAGIC = 'shipped-okay'\n")
    (mod_dir / "helper.py").write_text("def triple(x):\n    return x * 3\n")
    tag_env, cache = side.tag_env, side.pkg_cache

    @side.rt.remote(runtime_env={"py_modules": [str(mod_dir)]},
                    scheduling_strategy="SPREAD")
    def use_module(x):
        import os

        import shipped_mod
        from shipped_mod.helper import triple

        return (shipped_mod.MAGIC, triple(x),
                bool(os.environ.get(tag_env)),
                cache in shipped_mod.__file__)

    results = side.rt.get([use_module.remote(i) for i in range(6)],
                          timeout=120)
    return {"magic": {m for m, _, _, _ in results},
            "triples": [t for _, t, _, _ in results],
            "on_daemon": all(d for _, _, d, _ in results),
            "from_package_cache": all(c for _, _, _, c in results)}


def test_runtime_env_py_modules_ship_to_remote_nodes(two_node, tmp_path):
    assert both(lambda side: py_modules(side, tmp_path), two_node) == {
        "magic": {"shipped-okay"}, "triples": [0, 3, 6, 9, 12, 15],
        "on_daemon": True, "from_package_cache": True}


def working_dir(side: Side, tmp_path) -> dict:
    work = tmp_path / side.name / "workdir"
    work.mkdir(parents=True)
    (work / "data.txt").write_text("hello-from-driver")
    tag_env = side.tag_env

    @side.rt.remote(runtime_env={"working_dir": str(work)})
    def read_file():
        import os

        with open("data.txt") as f:
            return os.environ.get(tag_env) is not None, f.read()

    on_daemon, content = side.rt.get(read_file.remote(), timeout=60)
    return {"on_daemon": on_daemon, "content": content}


def test_runtime_env_working_dir_ships_to_remote_nodes(two_node, tmp_path):
    assert both(lambda side: working_dir(side, tmp_path), two_node) == {
        "on_daemon": True, "content": "hello-from-driver"}


def many_small_tasks(side: Side) -> dict:
    @side.rt.remote(scheduling_strategy="SPREAD")
    def tiny(i):
        return i + 1

    n = 5000
    results = side.rt.get([tiny.remote(i) for i in range(n)], timeout=600)
    handles = side.handles()
    return {"results": results == [i + 1 for i in range(n)],
            "nodes": len(handles) >= 2,
            "one_connection_each": all(h.pool.num_connections() <= 1
                                       for h in handles),
            "threads_bounded": all(
                h.pool.call("executor_stats")["threads"] < 64
                for h in handles)}


def test_mux_rpc_5k_tasks_few_sockets(two_node):
    assert both(many_small_tasks, two_node) == {
        "results": True, "nodes": True, "one_connection_each": True,
        "threads_bounded": True}


def strict_spread_group(side: Side) -> dict:
    """A STRICT_SPREAD placement group over the two daemons: one bundle
    on each, a task in each bundle runs on its bundle's node, and the
    driver mirrors the group to the head."""
    pg_mod = side._mod("util.placement_group")
    strategy = side._mod("util.scheduling_strategies") \
        .PlacementGroupSchedulingStrategy
    tag_env = side.tag_env
    pg = pg_mod.placement_group([{"CPU": 1}, {"CPU": 1}],
                                strategy="STRICT_SPREAD")
    side.rt.get(pg.ready(), timeout=60)

    @side.rt.remote(num_cpus=1)
    def where():
        import os

        return os.environ.get(tag_env)

    tags = side.rt.get([where.options(scheduling_strategy=strategy(
        pg, placement_group_bundle_index=i)).remote() for i in range(2)],
        timeout=60)
    head = side._mod("_private.rpc").RpcClient(side.cluster.address)

    def mirrored() -> bool:
        return any(g["pg_id"] == pg.id.hex()
                   and g["strategy"] == "STRICT_SPREAD"
                   and len(g["bundles"]) == 2
                   for groups in head.call(
                       "list_cluster_placement_groups").values()
                   for g in groups)

    record = {"on_daemons": None not in tags,
              "distinct": len(set(tags)) == 2,
              "mirrored_at_head": wait_until(mirrored, 30)}
    head.close()
    pg_mod.remove_placement_group(pg)
    return record


def test_strict_spread_group_spans_the_daemons(two_node):
    assert both(strict_spread_group, two_node) == {
        "on_daemons": True, "distinct": True, "mirrored_at_head": True}


def test_a_task_that_cannot_leave_the_driver_fails_on_its_node(two_node):
    """Port only: a task leased to a daemon whose function cannot be
    serialized fails there with the reason; it never runs in the driver
    on the node's lease."""
    side = two_node["ray_tpu_torch"]
    lock = threading.Lock()
    ran_here = []

    @side.rt.remote(num_cpus=1)
    def holds_a_lock():
        with lock:
            ran_here.append(os.getpid())
        return "ran"

    with pytest.raises(side.exceptions().TaskError,
                       match="cannot be serialized"):
        side.rt.get(holds_a_lock.remote(), timeout=60)
    assert ran_here == []
    assert wait_until(lambda: side.rt.available_resources().get("CPU")
                      == 4.0)
