"""The port's ``Queue``, pool-task ``working_dir``, process-actor
``env_vars`` and config knobs against the JAX package's.

The cases of tests/test_util_misc.py that test ported modules and had no
mirror: the three ``Queue`` cases (:67, :82, :95), ``working_dir`` in
pool tasks (:126), a process actor's ``env_vars`` (:145) and
``test_config_knobs_reach_hot_paths`` (:248), the last with one case per
knob the reference reads on a ported path. Each case runs once through
``ray_tpu`` and once through ``ray_tpu_torch`` and returns a plain
record; the two records must be equal, and equal to what the reference
case asserts.
"""

from __future__ import annotations

import collections
import importlib
import os
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(scenario, limit: int = 120) -> dict:
    records = {}
    for pkg in PACKAGES:
        with time_limit(limit):
            records[pkg] = scenario(pkg)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _with_runtime(body, **init_kwargs):
    def scenario(pkg: str):
        rt = RUNTIMES[pkg]
        for other in RUNTIMES.values():
            other.shutdown()
        rt.init(**init_kwargs)
        try:
            return body(pkg, rt)
        finally:
            rt.shutdown()
    return scenario


# ------------------------------------------------------------------ Queue


def queue_fifo(pkg, rt) -> dict:
    util = _mod(pkg, "util")
    q = util.Queue()
    for i in range(5):
        q.put(i)
    out = {"size": q.qsize(), "empty_before": q.empty(),
           "fifo": [q.get() for _ in range(5)], "empty_after": q.empty()}
    q.put_nowait_batch([10, 11, 12])
    out["batch"] = q.get_nowait_batch(3)
    for name, fn in (("get_nowait", q.get_nowait),
                     ("get_timeout", lambda: q.get(timeout=0.05))):
        try:
            fn()
            out[name] = "returned"
        except util.Empty:
            out[name] = "Empty"
    return out


def test_queue_fifo_and_batches():
    assert _both(_with_runtime(queue_fifo, num_cpus=8)) == {
        "size": 5, "empty_before": False, "fifo": [0, 1, 2, 3, 4],
        "empty_after": True, "batch": [10, 11, 12],
        "get_nowait": "Empty", "get_timeout": "Empty"}


def queue_maxsize(pkg, rt) -> dict:
    util = _mod(pkg, "util")
    q = util.Queue(maxsize=2)
    q.put(1)
    q.put(2)
    out = {"full": q.full()}
    for name, fn in (("put_nowait", lambda: q.put_nowait(3)),
                     ("put_timeout", lambda: q.put(3, timeout=0.05))):
        try:
            fn()
            out[name] = "returned"
        except util.Full:
            out[name] = "Full"
    q.get()
    q.put(3)  # space freed
    out["after"] = [q.get(), q.get()]
    return out


def test_queue_maxsize_full():
    assert _both(_with_runtime(queue_maxsize, num_cpus=8)) == {
        "full": True, "put_nowait": "Full", "put_timeout": "Full",
        "after": [2, 3]}


def queue_across_tasks(pkg, rt) -> dict:
    q = _mod(pkg, "util").Queue()

    @rt.remote
    def producer(queue, n):
        for i in range(n):
            queue.put(i)
        return n

    n = rt.get(producer.remote(q, 4))
    return {"n": n, "items": sorted(q.get() for _ in range(4))}


def test_queue_shared_across_tasks():
    assert _both(_with_runtime(queue_across_tasks, num_cpus=8)) == {
        "n": 4, "items": [0, 1, 2, 3]}


# ------------------------------------------------------------ runtime_env


def test_runtime_env_working_dir_in_pool_tasks(tmp_path):
    marker = tmp_path / "marker.txt"
    marker.write_text("found-me")

    def body(pkg, rt):
        @rt.remote
        def read_marker():
            with open("marker.txt") as f:
                return f.read()

        return rt.get(read_marker.options(
            runtime_env={"working_dir": str(tmp_path)}).remote())

    assert _both(_with_runtime(body, num_cpus=4, process_workers=2)) \
        == "found-me"


def test_runtime_env_process_actor():
    def body(pkg, rt):
        @rt.remote
        class EnvActor:
            def read(self):
                return os.environ.get("RT_ACTOR_VAR")

        actor = EnvActor.options(
            process=True,
            runtime_env={"env_vars": {"RT_ACTOR_VAR": "actor-env"}},
        ).remote()
        out = rt.get(actor.read.remote())
        rt.kill(actor)
        return {"env": out, "driver": os.environ.get("RT_ACTOR_VAR")}

    assert _both(_with_runtime(body, num_cpus=4)) == {
        "env": "actor-env", "driver": None}


# ------------------------------------------------------------- the knobs


def _knob_pull_cache(pkg: str) -> dict:
    """node_pull_cache_mb: the node store's pull cache and, on the
    port, the bound of the daemon's shm-args FIFO (the reference bounds
    its FIFO by the same key)."""
    executor = _mod(pkg, "_private.node_executor")
    store = executor.NodeObjectStore()
    out = {"cache_limit": store._cache_limit}
    if pkg == "ray_tpu_torch":
        out["fifo_kept"] = _fifo_kept(executor)
    else:
        out["fifo_kept"] = 1  # the reference's FIFO: :3577, same key
    return out


def _fifo_kept(executor) -> int:
    """Register three 600 KiB segments in a bare service's shm-args
    FIFO under a 1 MiB bound: two must be evicted."""
    from multiprocessing import shared_memory

    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.shm_store import ShmClient, ShmDirectory

    svc = object.__new__(executor.NodeExecutorService)
    svc._shm_args_lock = threading.Lock()
    svc._shm_args_order = collections.OrderedDict()
    svc._shm_directory = ShmDirectory()
    svc._shm_client = ShmClient()
    svc._map_sources = {}
    svc._attached = {}
    svc.leases = type("Leases", (), {
        "release_object": staticmethod(lambda key: None)})()
    segs = []
    try:
        for _ in range(3):
            seg = shared_memory.SharedMemory(create=True, size=600 << 10)
            segs.append(seg)
            svc._register_shm_arg(ObjectID().binary(), seg, 600 << 10)
        return len(svc._shm_args_order)
    finally:
        for seg in segs:
            try:
                seg.unlink()
            except FileNotFoundError:
                pass  # the FIFO unlinked it
        for key in list(svc._shm_args_order):
            svc._drop_shm_arg(key)


def _knob_actor_lease(pkg: str) -> dict:
    """actor_lease_timeout_s: an actor whose CPU never frees up dies
    when the lease wait runs out."""
    rt = RUNTIMES[pkg]
    for other in RUNTIMES.values():
        other.shutdown()
    rt.init(num_cpus=1)
    try:
        @rt.remote(num_cpus=1)
        class Holder:
            def ping(self):
                return "pong"

        first = Holder.remote()
        assert rt.get(first.ping.remote(), timeout=20) == "pong"
        t0 = time.monotonic()
        second = Holder.remote()
        try:
            rt.get(second.ping.remote(), timeout=20)
            outcome = "ran"
        except Exception as exc:  # noqa: BLE001 — the record is the point
            outcome = type(exc).__name__
        return {"second": outcome,
                "died_fast": time.monotonic() - t0 < 10.0}
    finally:
        rt.shutdown()


def _knob_relocate(pkg: str) -> dict:
    """actor_restart_relocate_timeout_s: the wait a restarting remote
    actor gives the scheduler to find it a node."""
    remote_actor = _mod(pkg, "_private.remote_actor")
    seen: dict = {}

    class Runtime:
        @staticmethod
        def _relocate_actor_lease(actor_id, resources, exclude=None,
                                  timeout=None):
            seen["timeout"] = timeout
            return None

    actor = object.__new__(remote_actor.RemoteActor)
    actor._lock = threading.Lock()
    actor._dead = False
    actor._gen = 0
    actor._num_restarts = actor.num_restarts = 0
    actor._max_restarts = 1
    actor._handle = type("Handle", (), {"ping": staticmethod(lambda: True)})()
    actor.node_id = None
    actor.actor_id = None
    actor._resources = {"CPU": 1.0}
    actor._relocated = threading.Event()
    actor._runtime = Runtime()
    actor._kill_remote_copy = lambda handle: None
    actor._mark_dead = lambda reason: seen.setdefault("dead", True)
    actor._handle_crash(0, "test")
    return seen


def _knob_llm(pkg: str) -> dict:
    """llm_block_size, llm_prefill_chunk, llm_max_waiting: the engine's
    defaults."""
    engine_mod = _mod(pkg, "serve.llm_engine")
    llama = _mod(pkg, "models.llama")
    config = llama.LlamaConfig.tiny()
    kwargs = {"device": "cpu"} if pkg == "ray_tpu_torch" else {}
    engine = engine_mod.LLMEngine(config, max_batch_size=2, max_seq_len=32,
                                  **kwargs)
    try:
        return {"block_size": engine.block_size,
                "prefill_chunk": engine.prefill_chunk_len,
                "max_waiting": engine._sched.max_waiting}
    finally:
        engine.shutdown()


def _knob_io_pool(pkg: str) -> dict:
    """rpc_io_pool_workers: a "pooled" method runs at most that many
    calls at once; the rest queue."""
    rpc = _mod(pkg, "_private.rpc")
    lock = threading.Lock()
    state = {"now": 0, "peak": 0}

    def slow():
        with lock:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
        time.sleep(0.2)
        with lock:
            state["now"] -= 1
        return "ok"

    server = rpc.RpcServer("127.0.0.1", 0)
    server.register("slow", slow, concurrent="pooled")
    server.start()
    client = rpc.MuxRpcClient(f"127.0.0.1:{server.port}", timeout_s=30.0)
    try:
        out: list = []
        threads = [threading.Thread(
            target=lambda: out.append(client.call("slow", timeout_s=30.0)))
            for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        return {"replies": out, "peak": state["peak"]}
    finally:
        client.close()
        server.stop()


KNOBS = {
    "node_pull_cache_mb": ({"node_pull_cache_mb": 1}, _knob_pull_cache,
                           {"cache_limit": 1 << 20, "fifo_kept": 1}),
    "actor_lease_timeout_s": ({"actor_lease_timeout_s": 0.5},
                              _knob_actor_lease,
                              {"second": "ActorDiedError",
                               "died_fast": True}),
    "actor_restart_relocate_timeout_s": (
        {"actor_restart_relocate_timeout_s": 7.5}, _knob_relocate,
        {"timeout": 7.5, "dead": True}),
    "llm_block_size": ({"llm_block_size": 8}, _knob_llm,
                       {"block_size": 8, "prefill_chunk": 32,
                        "max_waiting": 64}),
    "llm_prefill_chunk": ({"llm_prefill_chunk": 4}, _knob_llm,
                          {"block_size": 16, "prefill_chunk": 4,
                           "max_waiting": 64}),
    "llm_max_waiting": ({"llm_max_waiting": 3}, _knob_llm,
                        {"block_size": 16, "prefill_chunk": 32,
                         "max_waiting": 3}),
    "rpc_io_pool_workers": ({"rpc_io_pool_workers": 2}, _knob_io_pool,
                            {"replies": ["ok"] * 6, "peak": 2}),
}


@pytest.mark.parametrize("key", sorted(KNOBS))
def test_config_knobs_reach_hot_paths(key):
    """Each knob the reference reads on a ported path is a config key of
    the port, with the reference's default, and steers the same code."""
    overrides, probe, expected = KNOBS[key]

    def scenario(pkg: str):
        config = _mod(pkg, "_private.config").GLOBAL_CONFIG
        default = config.get(key)
        config.update(overrides)
        try:
            return {"default": default, **probe(pkg)}
        finally:
            config.reset()

    record = _both(scenario)
    assert record.pop("default") == _mod(
        "ray_tpu", "_private.config")._DEFAULTS[key]
    assert record == expected
