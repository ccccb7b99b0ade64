"""The port's object lifetime on a cluster against the JAX package's: the
node store's spill and restore and its per-owner free, the daemons'
sweep of a crashed driver's results and actors, the head's
object-location table, ``RpcMethodError``'s pickling, and refs borrowed
by daemon actors after their owner dropped every handle.

The cases of tests/test_object_lifetime.py on ported modules, each once
through ``ray_tpu`` and once through ``ray_tpu_torch``, returning plain
records that must be equal, and equal to what the reference case
asserts. The node store's cases run both halves, the ``python`` store
and the ``native`` one (``node_store.cpp``), and which of the two a
daemon takes. Where the reference sleeps for the
borrow to be flushed, these wait for the owner's borrower table to list
a borrower other than the driver itself. Each case that starts processes
has a time limit of its own.

Where the port deliberately differs: the node store's managed spill
files are ``RTS1`` files (``*.spill``); the record lists every file left
in the spill directory, whatever its name. The native store has no
silent fallback: where the reference skips without a toolchain, the
port's build raises.
"""

from __future__ import annotations

import gc
import importlib
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_cluster_sides import both, start_clusters, stop_clusters, wait_until
from torch_time_limit import time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
# The config prefix each package reads its environment overrides under.
ENV_PREFIX = {"ray_tpu": "RAY_TPU_", "ray_tpu_torch": "RAY_TPU_TORCH_"}


def _mod(name: str, sub: str):
    return importlib.import_module(f"{name}.{sub}")


def _node_store(name: str, impl: str = "python", **kwargs):
    if impl == "python":
        return _mod(name, "_private.node_executor").NodeObjectStore(**kwargs)
    lib = importlib.import_module(f"{name}._native").load()
    assert lib is not None
    return _mod(name, "_private.node_store_native").NativeNodeObjectStore(
        lib, **kwargs)


# ------------------------------------------------- the node store (python)


def spills_primaries_and_restores(name, tmp_path, impl="python") -> dict:
    spill_dir = tmp_path / name / impl / "spill"
    store = _node_store(name, impl, primary_limit_bytes=3 * 1024 * 1024,
                        spill_dir=str(spill_dir))
    blobs = {}
    for i in range(8):  # 8 x 1 MB against a 3 MB cap
        key = bytes([i]) * 16
        blobs[key] = bytes([i]) * (1024 * 1024)
        store.put(key, blobs[key], owner="owner-a")
    stats = store.stats()
    reads = []
    for key, blob in blobs.items():
        total, chunk = store.read_chunk(key, 512 * 1024, 1024)
        reads.append(store.get(key) == blob and total == len(blob)
                     and chunk == blob[512 * 1024:512 * 1024 + 1024])
    restored = store.stats()["restores"] > 0
    store.free(list(blobs))
    after = store.stats()
    return {"spilled_5_or_more": stats["spilled_blobs"] >= 5,
            "under_the_cap": stats["bytes"] <= 3 * 1024 * 1024 + 1024,
            "reads": reads, "restored": restored,
            "blobs_after_free": after["num_blobs"],
            "spilled_after_free": after["spilled_blobs"],
            "files_left": sorted(os.listdir(spill_dir))
            if spill_dir.exists() else []}


def test_node_store_spills_primaries_and_restores(tmp_path):
    records = {name: spills_primaries_and_restores(name, tmp_path)
               for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "spilled_5_or_more": True, "under_the_cap": True,
        "reads": [True] * 8, "restored": True, "blobs_after_free": 0,
        "spilled_after_free": 0, "files_left": []}, records


def owner_free(name, tmp_path, impl="python") -> dict:
    store = _node_store(name, impl,
                        spill_dir=str(tmp_path / name / impl / "spill"))
    store.put(b"a" * 16, b"x" * 100, owner="owner-a")
    store.put(b"b" * 16, b"y" * 100, owner="owner-b")
    store.put(b"c" * 16, b"z" * 100, owner="owner-a")
    return {"freed": store.free_owner("owner-a"),
            "kept": store.get(b"b" * 16), "gone": store.get(b"a" * 16),
            "owners": store.owners()}


def test_owner_free_drops_only_that_owners_blobs(tmp_path):
    records = {name: owner_free(name, tmp_path) for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "freed": 2, "kept": b"y" * 100, "gone": None,
        "owners": ["owner-b"]}, records


def test_native_node_store_spills_primaries_and_restores(tmp_path):
    """tests/test_object_lifetime.py:39, its ``native`` half."""
    records = {name: spills_primaries_and_restores(name, tmp_path, "native")
               for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "spilled_5_or_more": True, "under_the_cap": True,
        "reads": [True] * 8, "restored": True, "blobs_after_free": 0,
        "spilled_after_free": 0, "files_left": []}, records


def test_native_owner_free_drops_only_that_owners_blobs(tmp_path):
    """tests/test_object_lifetime.py:70, its ``native`` half."""
    records = {name: owner_free(name, tmp_path, "native")
               for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "freed": 2, "kept": b"y" * 100, "gone": None,
        "owners": ["owner-b"]}, records


def daemon_store_choice(name: str) -> dict:
    """Which store a daemon's executor takes: the native one exactly when
    ``node_store_native`` is on and the managed spill tier is off."""
    config = _mod(name, "_private.config").GLOBAL_CONFIG
    spill = _mod(name, "_private.spill_manager")
    executor = _mod(name, "_private.node_executor")
    out = {}
    try:
        for native in (True, False):
            for spill_on in (True, False):
                config.update({"node_store_native": native,
                               "spill_enabled": spill_on})
                spill.init_from_config()
                svc = executor.NodeExecutorService(
                    host="127.0.0.1", pool_size=0, resources={"CPU": 1})
                try:
                    out[f"native={native},spill={spill_on}"] = \
                        type(svc.store).__name__
                finally:
                    svc.stop()
    finally:
        config.reset()
        spill.init_from_config()
    return out


def test_daemon_store_is_native_exactly_when_the_spill_tier_is_off():
    records = {name: daemon_store_choice(name) for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "native=True,spill=True": "NodeObjectStore",
        "native=True,spill=False": "NativeNodeObjectStore",
        "native=False,spill=True": "NodeObjectStore",
        "native=False,spill=False": "NodeObjectStore"}, records


# ---------------------------------------------- the owner sweep of daemons

_CRASHING_DRIVER = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, {repo!r})
    os.environ.setdefault("RAY_TPU_SKIP_TPU_DETECTION", "1")
    import numpy as np
    import {pkg} as rt

    rt.init(num_cpus=0, address={address!r})
    deadline = time.time() + 30
    while time.time() < deadline and \\
            rt.cluster_resources().get("CPU", 0) < 2:
        time.sleep(0.05)

    @rt.remote
    def big():
        return np.zeros(400_000)  # 3.2 MB: it stays on the daemon

    @rt.remote(num_cpus=1)
    class Held:
        def ping(self):
            return "up"

    refs = [big.remote() for _ in range(3)]
    actor = Held.remote()
    assert rt.get(actor.ping.remote(), timeout=60) == "up"
    rt.wait(refs, num_returns=3, timeout=60)
    print("DRIVER-READY", flush=True)
    time.sleep(120)  # killed from outside; never exits cleanly
""")


def driver_crash_sweep(name, tmp_path) -> dict:
    rpc = _mod(name, "_private.rpc")
    PACKAGES[name].shutdown()
    prefix = ENV_PREFIX[name]
    cluster = _mod(name, "cluster_utils").Cluster(
        log_dir=str(tmp_path / name))
    cluster.add_node(num_cpus=2, env={
        prefix + "OWNER_SWEEP_PERIOD_MS": "1000",
        prefix + "OWNER_DEAD_GRACE_S": "4"})
    driver = gcs = probe = None
    try:
        assert cluster.wait_for_nodes(1, timeout=30), f"{name}: no node"
        script = _CRASHING_DRIVER.format(repo=REPO, pkg=name,
                                         address=cluster.address)
        driver = subprocess.Popen(
            [sys.executable, "-c", script], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        seen = b""
        while b"DRIVER-READY" not in seen:
            line = driver.stdout.readline()
            assert line or driver.poll() is None, \
                f"{name}: the driver ended: {seen.decode(errors='replace')}"
            seen += line
        gcs = rpc.RpcClient(cluster.address)
        exec_addr = next(
            n["executor_address"] for n in gcs.call("list_nodes")
            if n["alive"] and n["executor_address"])
        probe = rpc.RpcClient(exec_addr)
        held = probe.call("executor_stats")
        driver.kill()  # a crash: no cleanup, no frees
        driver.wait(timeout=10)
        swept = {}

        def empty() -> bool:
            swept.update(probe.call("executor_stats"))
            return (swept["store"]["num_blobs"] == 0
                    and swept["num_actors"] == 0)

        wait_until(empty, 40)
        return {"held_blobs_3_or_more": held["store"]["num_blobs"] >= 3,
                "held_actors": held["num_actors"],
                "swept_blobs": swept["store"]["num_blobs"],
                "swept_actors": swept["num_actors"]}
    finally:
        for client in (probe, gcs):
            if client is not None:
                client.close()
        if driver is not None and driver.poll() is None:
            driver.kill()
            driver.wait(timeout=10)
        cluster.shutdown()


def test_driver_crash_sweeps_daemon_blobs_and_actors(tmp_path):
    records = {}
    for name in PACKAGES:
        with time_limit(240):
            records[name] = driver_crash_sweep(name, tmp_path)
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "held_blobs_3_or_more": True, "held_actors": 1, "swept_blobs": 0,
        "swept_actors": 0}, records


def test_owner_sweep_keys_read_from_the_environment(monkeypatch):
    """The two keys the sweep case sets, with the reference's defaults,
    each read from its package's own environment prefix."""
    records = {}
    for name in PACKAGES:
        config = _mod(name, "_private.config")
        keys = [ENV_PREFIX[name] + "OWNER_SWEEP_PERIOD_MS",
                ENV_PREFIX[name] + "OWNER_DEAD_GRACE_S"]
        for key in keys:
            monkeypatch.delenv(key, raising=False)
        plain = config.Config()
        monkeypatch.setenv(keys[0], "1000")
        monkeypatch.setenv(keys[1], "4")
        fresh = config.Config()
        records[name] = [
            (plain.owner_sweep_period_ms, plain.owner_dead_grace_s),
            (fresh.owner_sweep_period_ms, fresh.owner_dead_grace_s)]
    assert records["ray_tpu"] == records["ray_tpu_torch"] == [
        (5000, 15.0), (1000, 4.0)], records


# ------------------------------------------------- the object-location table


def location_table(side) -> dict:
    rt, runtime = side.rt, side.runtime

    @rt.remote
    def big():
        import numpy

        return numpy.zeros(400_000)

    refs = [big.remote() for _ in range(3)]
    rt.wait(refs, num_returns=3, timeout=60)
    held = {r.id().hex() for r in refs}
    table = {}

    def listed(want_all: bool) -> bool:
        table.clear()
        table.update(runtime.gcs_client.call("list_object_locations",
                                             runtime._export_addr))
        return held <= set(table) if want_all else not held & set(table)

    published = wait_until(lambda: listed(True), 20)
    # Dropping the refs retracts the entries.
    del refs
    gc.collect()
    retracted = wait_until(lambda: listed(False), 20)
    return {"published": published, "retracted": retracted}


def borrowed_by(side, oid) -> set:
    """The borrowers the owner's client server lists for ``oid``, the
    driver's own claim left out."""
    server = side.runtime.worker_client_server
    with server._lock:
        return set(server._borrowers.get(oid.hex(), ())) - {"__direct__"}


def borrower_survives_owner_drop(side) -> dict:
    rt, runtime = side.rt, side.runtime

    @rt.remote(num_cpus=1)
    class Holder:
        def __init__(self, package):
            self.package = package
            self.ref = None

        def hold(self, boxed):
            self.ref = boxed[0]
            return "held"

        def read(self):
            import importlib

            package = importlib.import_module(self.package)
            return float(package.get(self.ref).sum())

        def drop(self):
            self.ref = None
            return "dropped"

    h = Holder.remote(side.name)
    big = rt.put(np.ones((512, 512), np.float32))
    oid = big.id()
    held = rt.get(h.hold.remote([big]), timeout=60)
    del big
    gc.collect()
    borrowed = wait_until(lambda: bool(borrowed_by(side, oid)), 30)
    # The borrower reads after the owner dropped every handle.
    read = rt.get(h.read.remote(), timeout=60)
    # Once the borrower lets go too, the object is freed by its owner.
    dropped = rt.get(h.drop.remote(), timeout=60)
    freed = wait_until(lambda: not runtime.store.contains(oid), 20)
    rt.kill(h)
    return {"held": held, "borrowed": borrowed, "read": read,
            "dropped": dropped, "freed": freed}


def two_borrowers(side) -> dict:
    rt = side.rt

    @rt.remote(num_cpus=1)
    class Holder:
        def __init__(self, package):
            self.package = package
            self.ref = None

        def hold(self, boxed):
            self.ref = boxed[0]
            return "held"

        def read(self):
            import importlib

            package = importlib.import_module(self.package)
            return float(package.get(self.ref).sum())

    a, b = Holder.remote(side.name), Holder.remote(side.name)
    big = rt.put(np.full((64, 64), 2.0, np.float32))
    oid = big.id()
    rt.get([a.hold.remote([big]), b.hold.remote([big])], timeout=60)
    del big
    gc.collect()
    borrowed = wait_until(lambda: len(borrowed_by(side, oid)) >= 2, 30)
    # Borrower A killed outright: B's claim keeps the object.
    rt.kill(a)
    read = rt.get(b.read.remote(), timeout=60)
    rt.kill(b)
    return {"borrowed": borrowed, "read": read}


@pytest.fixture(scope="module")
def lifetime_cluster(tmp_path_factory):
    sides = start_clusters(tmp_path_factory.mktemp("lifetime"),
                           [{"num_cpus": 2}])
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


def test_gcs_object_location_table_tracks_primaries(lifetime_cluster):
    with time_limit(120):
        assert both(location_table, lifetime_cluster) == {
            "published": True, "retracted": True}


def test_rpc_method_error_pickles():
    records = {}
    for name in PACKAGES:
        error_type = _mod(name, "_private.rpc").RpcMethodError
        back = pickle.loads(pickle.dumps(
            error_type(KeyError("nope"), "tb text")))
        records[name] = {"type": isinstance(back, error_type),
                         "tb": back.remote_tb,
                         "cause": type(back.cause).__name__}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "type": True, "tb": "tb text", "cause": "KeyError"}, records


def test_borrowed_ref_survives_owner_dropping_handles(lifetime_cluster):
    with time_limit(180):
        assert both(borrower_survives_owner_drop, lifetime_cluster) == {
            "held": "held", "borrowed": True, "read": 512 * 512.0,
            "dropped": "dropped", "freed": True}


def test_two_borrowers_release_independently(lifetime_cluster):
    with time_limit(180):
        assert both(two_borrowers, lifetime_cluster) == {
            "borrowed": True, "read": 64 * 64 * 2.0}


def dead_borrower_lease(side) -> dict:
    rt, runtime = side.rt, side.runtime

    @rt.remote(num_cpus=1)
    class Holder:
        def __init__(self):
            self.ref = None

        def hold(self, boxed):
            self.ref = boxed[0]
            return "held"

    h = Holder.remote()
    big = rt.put(np.ones((256, 256), np.float32))
    oid = big.id()
    held = rt.get(h.hold.remote([big]), timeout=60)
    del big
    gc.collect()
    borrowed = wait_until(lambda: bool(borrowed_by(side, oid)), 30)
    pinned = runtime.store.contains(oid)
    # The borrower killed without releasing: no keepalive follows.
    rt.kill(h)
    expired = wait_until(lambda: not runtime.store.contains(oid), 30)
    return {"held": held, "borrowed": borrowed, "pinned": pinned,
            "expired": expired}


@pytest.mark.slow  # as the reference marks it
def test_dead_borrower_lease_expires(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_BORROW_TTL_S", "4")
    monkeypatch.setenv("RAY_TPU_TORCH_BORROW_TTL_S", "4")
    sides = start_clusters(tmp_path, [{"num_cpus": 2}])
    try:
        with time_limit(240):
            assert both(dead_borrower_lease, sides) == {
                "held": "held", "borrowed": True, "pinned": True,
                "expired": True}
    finally:
        stop_clusters({n: s.cluster for n, s in sides.items()})


# ------------------------------------------------------------- port-only


def test_a_borrow_lands_before_the_calls_reply(lifetime_cluster):
    """A daemon actor handed a ref inside a list has registered its
    borrow with the owner by the time the call's reply arrives, so the
    owner dropping its handle at once cannot free the object first (the
    grace pin on the call's arguments may have lapsed while the actor
    started)."""
    side = lifetime_cluster["ray_tpu_torch"]
    rt = side.rt

    @rt.remote(num_cpus=1)
    class Holder:
        def hold(self, boxed):
            self.ref = boxed[0]
            return "held"

    with time_limit(120):
        holder = Holder.remote()
        landed = []
        for _ in range(5):
            ref = rt.put(np.ones(1024, np.float32))
            assert rt.get(holder.hold.remote([ref]), timeout=60) == "held"
            landed.append(bool(borrowed_by(side, ref.id())))
        rt.kill(holder)
    assert landed == [True] * 5


def test_spill_marks_survive_a_failed_heartbeat(monkeypatch):
    """A daemon's spill events ride its heartbeat; a beat that fails
    carries them again on the next one, so the head's directory still
    marks the object spilled."""
    from ray_tpu_torch._private import node, rpc
    from ray_tpu_torch._private.gcs_server import GcsServer

    dropped = []
    real_call = rpc.MuxRpcClient.call

    def flaky(self, method, *args, **kwargs):
        if method == "heartbeat" and len(dropped) < 2:
            dropped.append(method)  # both attempts of one beat
            raise rpc.RpcError("heartbeat dropped")
        return real_call(self, method, *args, **kwargs)

    monkeypatch.setattr(rpc.MuxRpcClient, "call", flaky)
    events = [[("owner-x", "ab" * 10, "spilled")]]
    head = GcsServer().start()
    agent = None
    try:
        agent = node.NodeAgent(
            head.address, {"CPU": 1.0}, heartbeat_period_s=0.05,
            stats_fn=lambda: {"spill_events": events.pop()} if events
            else {})
        marked = wait_until(lambda: "ab" * 10 in head._list_object_locations(
            None, True)[1], 10)
    finally:
        if agent is not None:
            agent.stop(drain=False)
        head.stop()
    assert len(dropped) == 2 and marked
