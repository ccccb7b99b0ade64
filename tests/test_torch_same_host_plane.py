"""The port's same-host plane (``_private/same_host.py`` and its halves in
``node_executor.py`` and ``worker.py``) against the JAX package's.

Each mirrored case of tests/test_same_host_plane.py runs once through
``ray_tpu`` and once through ``ray_tpu_torch`` and returns a plain
record; the two records must be equal, and equal to what the mirrored
test asserts. The executor cases run two node executors in this process
(owner and puller, this host's identity); the broadcast case runs one
cluster per package (a head here, two daemons, a driver of no CPU).
Waits are deadlines on states, not sleeps. Every case that starts
processes has a limit of its own (tests/torch_time_limit.py).

The arena cases (tests/test_same_host_plane.py:142, :171 and :284) run
on each package's native arena; :171 runs in its segment form too, on a
``LeaseTable`` whose ``on_release`` counts.

Where the port deliberately differs: the native arena has no silent
fallback (the reference skips these cases without a toolchain; the
port's build raises, so the arena is asserted). The knobs are
``RAY_TPU_TORCH_SAME_HOST_*`` and the host override
``RAY_TPU_TORCH_HOST_ID``.
"""

import importlib
import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from torch_native import load_reference_native
from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")
ENV_PREFIX = {"ray_tpu": "RAY_TPU_", "ray_tpu_torch": "RAY_TPU_TORCH_"}
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native library, loaded once its file is whole:
    its in-place build races the other processes of the run."""
    load_reference_native()


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(scenario) -> dict:
    records = {pkg: scenario(pkg) for pkg in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _service(pkg: str):
    svc = _mod(pkg, "_private.node_executor").NodeExecutorService(
        host="127.0.0.1", pool_size=1, resources={"CPU": 1})
    svc.advertised_address = f"127.0.0.1:{svc.port}"
    svc.start()
    return svc


def _store_exported(pkg: str, svc, payload: bytes) -> bytes:
    blob = _mod(pkg, "_private.serialization").serialize_framed(payload)
    oid = os.urandom(16)
    svc.store.put(oid, blob, owner="test-owner")
    svc._maybe_export_stored(oid, blob)
    return oid


def _wait(predicate, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def _pair_case(body):
    """Run ``body(pkg, owner, puller, fetch_ref)`` on an executor pair of
    each package."""

    def scenario(pkg: str):
        with time_limit(120):
            owner, puller = _service(pkg), _service(pkg)
            try:
                fetch_ref = _mod(pkg, "_private.node_executor").FetchRef
                return body(pkg, owner, puller, fetch_ref)
            finally:
                owner.stop()
                puller.stop()

    return _both(scenario)


# ---------------------------------------------------- the executor pair


def copy_short_circuits(pkg, owner, puller, fetch_ref) -> dict:
    payload = np.random.default_rng(1).bytes(3 << 20)
    oid = _store_exported(pkg, owner, payload)
    got = puller._load_object(fetch_ref(oid, owner.advertised_address))
    # The puller releases its lease as soon as it has copied (the unpin
    # is sent without waiting for its reply).
    released = _wait(lambda: owner.leases.stats()["active"] == 0)
    return {"equal": got == payload,
            "copy_hits": puller.same_host_copy_hits,
            "chunked_pulls": puller.chunked_pulls,
            "fetches_served": owner.store.stats().get("fetches_served", 0),
            "released": released, "leases": owner.leases.stats()}


def test_same_host_copy_short_circuits_chunk_pull():
    assert _pair_case(copy_short_circuits) == {
        "equal": True, "copy_hits": 1, "chunked_pulls": 0,
        "fetches_served": 0, "released": True,
        "leases": {"active": 0, "granted": 1, "released": 1, "expired": 0}}


def changed_argument_keeps_the_copy(pkg: str, value) -> dict:
    """A task in the puller daemon's own process changes the argument it
    copied out of the owner's segment, where the value lets it; the
    puller's cached copy stays as it was, for its next task and for a
    third daemon pulling the object from it in chunks."""
    with time_limit(120):
        owner, puller, peer = _service(pkg), _service(pkg), _service(pkg)
        try:
            blob = _mod(pkg, "_private.serialization").serialize_framed(
                value)
            oid = os.urandom(16)
            owner.store.put(oid, blob, owner="test-owner")
            owner._maybe_export_stored(oid, blob)
            fetch_ref = _mod(pkg, "_private.node_executor").FetchRef
            ref = fetch_ref(oid, owner.advertised_address)
            first = puller._load_object(ref)
            changed = bool(getattr(first, "flags", None) is None
                           or first.flags.writeable)
            if changed:
                first += 1
            original = value.copy() if hasattr(value, "copy") \
                else value.clone()
            again = puller._load_object(ref)
            served = puller.store.stats()["fetches_served"]
            pulled = peer._load_object(fetch_ref(oid,
                                                 puller.advertised_address))
            return {"copy_hits": puller.same_host_copy_hits,
                    "next_task_equal": bool((again == original).all()),
                    "peer_equal": bool((pulled == original).all()),
                    "peer_chunked": peer.chunked_pulls,
                    "served_by_puller": puller.store.stats()[
                        "fetches_served"] > served,
                    "changed_in_place": changed}
        finally:
            owner.stop()
            puller.stop()
            peer.stop()


def test_a_task_changing_its_copied_argument_keeps_the_cached_copy():
    """The copy a daemon keeps of a co-hosted peer's object is immutable,
    as a chunked pull's is (the reference's copy is ``bytes``)."""
    value = np.arange(1 << 19, dtype=np.float64)
    assert _both(lambda pkg: changed_argument_keeps_the_copy(pkg, value)) \
        == {"copy_hits": 1, "next_task_equal": True, "peer_equal": True,
            "peer_chunked": 1, "served_by_puller": True,
            "changed_in_place": False}


def test_a_task_changing_its_copied_tensor_keeps_the_cached_copy():
    """Port only: a tensor argument copies before it can be written, so
    a task's in-place change never reaches the daemon's cached copy."""
    import torch

    value = torch.arange(1 << 19, dtype=torch.float64)
    assert changed_argument_keeps_the_copy("ray_tpu_torch", value) == {
        "copy_hits": 1, "next_task_equal": True, "peer_equal": True,
        "peer_chunked": 1, "served_by_puller": True,
        "changed_in_place": True}


def map_hands_workers_the_owner_segment(pkg, owner, puller,
                                        fetch_ref) -> dict:
    payload = np.random.default_rng(2).bytes(3 << 20)
    oid = _store_exported(pkg, owner, payload)
    owner_source = owner._map_sources[oid]
    desc = puller._shm_fetch_blob(fetch_ref(oid, owner.advertised_address))
    record = {"owners_segment": desc.name == owner_source[1],
              "map_hits": puller.same_host_map_hits,
              "active_while_mapped": owner.leases.stats()["active"]}
    client = _mod(pkg, "_private.shm_store").ShmClient()
    try:
        record["equal"] = client.get(desc) == payload
    finally:
        client.close_all()
    puller.free_objects([oid])
    record["released_after_free"] = _wait(
        lambda: owner.leases.stats()["active"] == 0)
    return record


def test_same_host_map_hands_workers_the_owner_segment():
    assert _pair_case(map_hands_workers_the_owner_segment) == {
        "owners_segment": True, "map_hits": 1, "active_while_mapped": 1,
        "equal": True, "released_after_free": True}


def cross_host_falls_back(pkg: str) -> dict:
    env = ENV_PREFIX[pkg] + "HOST_ID"
    with time_limit(120):
        owner = _service(pkg)
        os.environ[env] = "other-host"
        try:
            puller = _service(pkg)
        finally:
            os.environ.pop(env, None)
        try:
            payload = np.random.default_rng(3).bytes(2 << 20)
            oid = _store_exported(pkg, owner, payload)
            fetch_ref = _mod(pkg, "_private.node_executor").FetchRef
            got = puller._load_object(fetch_ref(oid,
                                                owner.advertised_address))
            keys = _mod(pkg, "_private.node_executor").DATA_PLANE_STAT_KEYS
            return {"hosts_differ": puller.host_id != owner.host_id,
                    "stat_keys": sorted(puller.executor_stats()[
                        "data_plane"]) == sorted(keys),
                    "equal": got == payload,
                    "map_hits": puller.same_host_map_hits,
                    "copy_hits": puller.same_host_copy_hits,
                    "chunked_pulls": puller.chunked_pulls,
                    "granted": owner.leases.stats()["granted"]}
        finally:
            owner.stop()
            puller.stop()


def test_cross_host_pullers_fall_back_to_chunked():
    assert _both(cross_host_falls_back) == {
        "hosts_differ": True, "stat_keys": True, "equal": True,
        "map_hits": 0, "copy_hits": 0, "chunked_pulls": 1, "granted": 0}


# --------------------------------------------------- the lease protocol


def ttl_expires_dead_pullers(pkg: str) -> list:
    """tests/test_same_host_plane.py:171 in its segment form: the unpin
    is a counter (a segment needs no pin in memory)."""
    leases = _mod(pkg, "_private.same_host").LeaseTable()
    unpinned = []
    leases.grant(b"k" * 16, "dead-holder:1",
                 on_release=lambda: unpinned.append(1))
    return [
        # Within the TTL nothing expires, even with a dead holder.
        leases.sweep(ttl_s=60.0, probe=lambda a: False),
        # A live holder past the TTL keeps its lease.
        leases.sweep(ttl_s=0.0, probe=lambda a: True),
        leases.stats()["active"], len(unpinned),
        # A dead holder past the TTL: swept and unpinned.
        leases.sweep(ttl_s=0.0, probe=lambda a: False),
        leases.stats(), len(unpinned)]


def test_ttl_expires_pins_of_dead_pullers():
    assert _both(ttl_expires_dead_pullers) == [
        0, 0, 1, 0, 1,
        {"active": 0, "granted": 1, "released": 0, "expired": 1}, 1]


def _arena_case(body):
    """Run ``body(pkg, arena)`` on a fresh 1 MiB, 256-slot arena of each
    package."""

    def scenario(pkg: str):
        arena = _mod(pkg, "_private.arena_store").ArenaStore.create(
            f"/rtt_lease_{pkg}_{os.getpid()}", 1 << 20, 256)
        assert arena is not None
        try:
            return body(pkg, arena)
        finally:
            arena.close()

    return _both(scenario)


def _seal_arena_object(arena, payload: bytes) -> bytes:
    key = os.urandom(16)
    view = arena.create_for_write(key, len(payload))
    view[:] = payload
    arena.seal(key)
    return key


def lease_pins_through_arena_pressure(pkg: str, arena) -> dict:
    """An object pinned under a lease survives heavy arena pressure with
    its bytes in place; released, it is evictable like any other."""
    payload = b"M" * 100_000
    key = _seal_arena_object(arena, payload)
    leases = _mod(pkg, "_private.same_host").LeaseTable()
    pinned = arena.pin(key)
    token = leases.grant(key, "holder:1", on_release=lambda: arena.unpin(key))
    offset, size = arena.peek(key)
    for _ in range(40):  # evicts everything unpinned several times over
        arena.put_bytes(os.urandom(16), [b"p" * 200_000])
    record = {"pinned": pinned,
              "evictions": arena.stats()["num_evictions"] > 0,
              "bytes_in_place": bytes(arena.view_at(offset, size)) == payload,
              "same_place": arena.peek(key) == (offset, size)}
    leases.release(token)  # unpins
    for _ in range(10):
        arena.put_bytes(os.urandom(16), [b"q" * 300_000])
    record["after_release"] = arena.peek(key)
    return record


def test_lease_pins_object_through_arena_pressure():
    assert _arena_case(lease_pins_through_arena_pressure) == {
        "pinned": 100_000, "evictions": True, "bytes_in_place": True,
        "same_place": True, "after_release": None}


def ttl_expires_arena_pins(pkg: str, arena) -> list:
    """tests/test_same_host_plane.py:171 on the arena: the sweep of a dead
    holder's lease drops its pin, and the object becomes evictable."""
    key = _seal_arena_object(arena, b"T" * 50_000)
    leases = _mod(pkg, "_private.same_host").LeaseTable()
    pinned = arena.pin(key) is not None
    leases.grant(key, "dead-holder:1", on_release=lambda: arena.unpin(key))
    record = [
        pinned,
        # Within the TTL nothing expires, even with a dead holder.
        leases.sweep(ttl_s=60.0, probe=lambda a: False),
        # A live holder past the TTL keeps its lease.
        leases.sweep(ttl_s=0.0, probe=lambda a: True),
        leases.stats()["active"],
        # A dead holder past the TTL: swept, its pin dropped.
        leases.sweep(ttl_s=0.0, probe=lambda a: False),
        leases.stats()["active"]]
    for _ in range(10):
        arena.put_bytes(os.urandom(16), [b"r" * 300_000])
    return record + [arena.peek(key)]


def test_ttl_expires_arena_pins_of_dead_pullers():
    assert _arena_case(ttl_expires_arena_pins) == [
        True, 0, 0, 1, 1, 0, None]


def sweep_releases_dead_puller(pkg, owner, puller, fetch_ref) -> dict:
    config = _mod(pkg, "_private.config").GLOBAL_CONFIG
    env = ENV_PREFIX[pkg] + "SAME_HOST_PIN_TTL_S"
    payload = np.random.default_rng(4).bytes(2 << 20)
    oid = _store_exported(pkg, owner, payload)
    desc = puller._shm_fetch_blob(fetch_ref(oid, owner.advertised_address))
    record = {"mapped": desc is not None,
              "active": owner.leases.stats()["active"]}
    # The puller's death: its lease names a port nobody answers, and the
    # TTL is zero.
    os.environ[env] = "0.0"
    config.reset()
    try:
        with owner.leases._lock:
            for token, lease in list(owner.leases._leases.items()):
                owner.leases._leases[token] = (
                    lease[0], "127.0.0.1:1", lease[2], lease[3])
        owner._sweep_transfer_plane()
        stats = owner.leases.stats()
        record.update(active_after=stats["active"],
                      expired=stats["expired"])
    finally:
        os.environ.pop(env, None)
        config.reset()
    return record


def test_executor_sweep_releases_dead_puller_lease():
    assert _pair_case(sweep_releases_dead_puller) == {
        "mapped": True, "active": 1, "active_after": 0, "expired": 1}


# ------------------------------------------------------- the cluster


def broadcast_rides_the_map_path(pkg: str, log_dir) -> dict:
    rt = RUNTIMES[pkg]
    config = _mod(pkg, "_private.config").GLOBAL_CONFIG
    env = ENV_PREFIX[pkg] + "SAME_HOST_MAP_MIN_KB"
    rt.shutdown()
    os.environ[env] = "64"
    config.reset()
    cluster = _mod(pkg, "cluster_utils").Cluster(log_dir=str(log_dir / pkg))
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=1)
        assert cluster.wait_for_nodes(2, timeout=60)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        assert _wait(lambda: rt.cluster_resources().get("CPU", 0) >= 2, 30)

        ref = rt.put(np.arange(2 << 20, dtype=np.uint8))  # 2 MiB

        @rt.remote(num_cpus=1, scheduling_strategy="SPREAD")
        def touch(arr):
            return int(arr[-1]) + len(arr)

        outs = rt.get([touch.remote(ref) for _ in range(2)], timeout=120)
        # The head's node table carries the host's identity.
        host = _mod(pkg, "_private.same_host").host_identity()
        nodes = runtime.gcs_client.call("list_nodes")
        workers = [n for n in nodes if n.get("executor_address")]
        with runtime._remote_nodes_lock:
            handles = list(runtime._remote_nodes.values())
        planes = [h._control.call("executor_stats")["data_plane"]
                  for h in handles]
        return {"outs": outs,
                "host_ids": all(n.get("host_id") == host for n in workers),
                "map_hits_at_least_2": sum(
                    p["same_host_map_hits"] for p in planes) >= 2,
                "chunked": sum(p["chunked_pulls"] for p in planes)}
    finally:
        rt.shutdown()
        cluster.shutdown()
        os.environ.pop(env, None)
        config.reset()


def test_cluster_broadcast_rides_the_map_path(tmp_path):
    with time_limit(300):
        records = {pkg: broadcast_rides_the_map_path(pkg, tmp_path)
                   for pkg in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "outs": [255 + (2 << 20)] * 2, "host_ids": True,
        "map_hits_at_least_2": True, "chunked": 0}


def arena_export_feeds_workers(pkg: str, log_dir) -> dict:
    """An export of arena size (over the inline limit, under the arena's
    object cap and the map threshold) rides the driver's arena: the
    daemon hands its pool worker a peer-arena descriptor and the worker
    copies the payload out of the driver's arena once; nothing is
    pulled in chunks."""
    rt = RUNTIMES[pkg]
    rt.shutdown()
    cluster = _mod(pkg, "cluster_utils").Cluster(log_dir=str(log_dir / pkg))
    try:
        cluster.add_node(num_cpus=1)
        assert cluster.wait_for_nodes(1, timeout=60)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        assert runtime.arena is not None
        assert _wait(lambda: rt.cluster_resources().get("CPU", 0) >= 1, 30)
        ref = rt.put(np.full(90_000, 7, dtype=np.int64))  # ~720 KB

        @rt.remote(num_cpus=1)
        def consume(x):
            return int(x.sum())

        out = rt.get(consume.remote(ref), timeout=120)
        kinds = sorted({s[0] for s in runtime._export_sources.values()})
        with runtime._remote_nodes_lock:
            handles = list(runtime._remote_nodes.values())
        planes = [h._control.call("executor_stats")["data_plane"]
                  for h in handles]
        return {"out": out, "source_kinds": kinds,
                "map_hits_at_least_1": sum(
                    p["same_host_map_hits"] for p in planes) >= 1,
                "chunked": sum(p["chunked_pulls"] for p in planes)}
    finally:
        rt.shutdown()
        cluster.shutdown()


def test_cluster_arena_export_feeds_workers_cross_arena(tmp_path):
    with time_limit(300):
        records = {pkg: arena_export_feeds_workers(pkg, tmp_path)
                   for pkg in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "out": 7 * 90_000, "source_kinds": ["arena"],
        "map_hits_at_least_1": True, "chunked": 0}, records


# ------------------------------------------------------------ port only


def test_tasks_exporting_one_object_at_once_write_one_segment():
    """Port only (a fault logged in ROADMAP queue 3): tasks that ship
    the same large value to nodes at the same moment export it once.
    Each used to find it missing from the export store and write a
    segment of its own; the last one's overwrote the others' entries,
    which stayed in /dev/shm until the process exited (the reference
    does the same)."""
    import threading

    from ray_tpu_torch._private.gcs_server import GcsServer

    ray_tpu_torch.shutdown()
    head = GcsServer().start()
    try:
        with time_limit(120):
            runtime = ray_tpu_torch.init(num_cpus=1, address=head.address)
            real = runtime._register_export_source
            calls = []

            def slow_register(*args):
                calls.append(args[0])
                time.sleep(0.3)  # widens the window the race needs
                return real(*args)

            runtime._register_export_source = slow_register
            ref = ray_tpu_torch.put(np.arange(1 << 18, dtype=np.float64))
            barrier = threading.Barrier(4)

            def convert():
                barrier.wait()
                runtime._convert_remote_args((ref,), {})

            threads = [threading.Thread(target=convert) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            with runtime._export_lock:
                segments = len(runtime._export_segments)
            assert (len(calls), segments) == (1, 1)
    finally:
        ray_tpu_torch.shutdown()
        head.stop()


def _driver_on_a_head(body):
    """Run ``body(runtime)`` in a driver connected to a head of its own
    (the driver's export store needs one), then shut both down."""
    from ray_tpu_torch._private.gcs_server import GcsServer

    ray_tpu_torch.shutdown()
    head = GcsServer().start()
    try:
        with time_limit(120):
            return body(ray_tpu_torch.init(num_cpus=1,
                                           address=head.address))
    finally:
        ray_tpu_torch.shutdown()
        head.stop()


def test_exports_of_different_objects_are_written_at_once():
    """Port only: the single flight of a driver's export is per object.
    While one large value is being written into its segment, another
    task's export of a different value goes on; a global lock made it
    wait for the first."""
    import threading

    def body(runtime):
        real = runtime._register_export_source
        second_started = threading.Event()
        first_id = []

        def register(id_bytes, *args):
            if not first_id:
                first_id.append(id_bytes)
                # Held until the other export has begun, or 10 s.
                record["overlapped"] = second_started.wait(10.0)
            else:
                second_started.set()
            return real(id_bytes, *args)

        record: dict = {}
        runtime._register_export_source = register
        refs = [ray_tpu_torch.put(np.full(1 << 18, i, dtype=np.float64))
                for i in range(2)]
        first = threading.Thread(
            target=runtime._convert_remote_args, args=((refs[0],), {}))
        first.start()
        assert _wait(lambda: bool(first_id))
        runtime._convert_remote_args((refs[1],), {})
        first.join()
        with runtime._export_lock:
            record["segments"] = len(runtime._export_segments)
        return record

    assert _driver_on_a_head(body) == {"overlapped": True, "segments": 2}


def test_a_spilled_export_stays_on_disk_when_a_task_takes_it_again():
    """Port only: a task given a ref whose export the driver spilled
    gets its FetchRef without the driver restoring the export (a node
    reading it pays the restore, once)."""

    def body(runtime):
        ref = ray_tpu_torch.put(np.arange(1 << 18, dtype=np.float64))
        runtime._convert_remote_args((ref,), {})
        store, id_bytes = runtime._export_store, ref.binary()
        spilled = runtime._export_spill_mgr._spill_one(id_bytes)
        restores = store.restores
        runtime._convert_remote_args((ref,), {})
        return {"spilled": spilled, "on_disk": store.is_spilled(id_bytes),
                "restores": store.restores - restores}

    assert _driver_on_a_head(body) == {"spilled": True, "on_disk": True,
                                       "restores": 0}


def test_the_drivers_reads_map_what_is_in_memory_and_pull_what_spilled(
        tmp_path):
    """Port only: the driver's half on one daemon whose store spills. Of
    three results of one task, the two the daemon spilled have no
    segment: the driver reads them by the chunked pull, each plan saying
    spilled; the one left in memory it copies out of the daemon's segment
    under a lease, released at once."""
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    cluster = Cluster(log_dir=str(tmp_path / "cluster"))
    try:
        with time_limit(180):
            cluster.add_node(num_cpus=2, resources={"spl": 1.0},
                             heartbeat_period_s=0.5, env={
                                 "RAY_TPU_TORCH_NODE_STORE_PRIMARY_LIMIT_MB":
                                     "3",
                                 "RAY_TPU_TORCH_SPILL_MIN_OBJECT_KB": "16"})
            assert cluster.wait_for_nodes(1, timeout=60)
            runtime = ray_tpu_torch.init(num_cpus=0, address=cluster.address)
            assert _wait(lambda: ray_tpu_torch.cluster_resources().get(
                "spl", 0) >= 1, 30)

            @ray_tpu_torch.remote(resources={"spl": 1.0}, num_returns=3)
            def produce():
                import numpy

                rng = numpy.random.default_rng(5)
                return (rng.bytes(1_200_000), rng.bytes(1_200_000),
                        rng.bytes(1_100_000))

            refs = produce.remote()
            ray_tpu_torch.wait(refs, num_returns=3, timeout=60)
            with runtime._remote_nodes_lock:
                handle = next(iter(runtime._remote_nodes.values()))

            def store():
                return handle.pool.call("executor_stats")["store"]

            assert _wait(lambda: store()["spilled_blobs"] >= 2, 60)
            spilled = store()["spilled_blobs"]
            before = runtime.remote_get_stats()
            got = ray_tpu_torch.get(refs, timeout=60)
            after = runtime.remote_get_stats()
            rng = np.random.default_rng(5)
            want = [rng.bytes(1_200_000), rng.bytes(1_200_000),
                    rng.bytes(1_100_000)]
            record = {
                "equal": got == want, "spilled": spilled,
                "mapped": after["mapped"]["gets"] - before["mapped"]["gets"],
                "chunked": after["chunked"]["gets"]
                - before["chunked"]["gets"],
                "spilled_plans": after["spilled_plans"]
                - before["spilled_plans"],
                "released": _wait(lambda: handle.pool.call(
                    "executor_stats")["data_plane"]["leases"]["active"]
                    == 0)}
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    assert record == {"equal": True, "spilled": 2, "mapped": 1,
                      "chunked": 2, "spilled_plans": 2, "released": True}


def test_a_read_in_the_daemon_copies_the_drivers_arena_export_once():
    """Port only: what a ``num_gpus=1`` task on a daemon does with an
    arena-sized export (a read in the daemon's own process): one copy out
    of the driver's arena under the driver's lease, which the driver
    pins in its arena for the lease's life and releases after; no chunk
    is pulled and the driver serves none."""

    def body(runtime):
        value = np.arange(65_536, dtype=np.float64)  # 512 KiB
        ref = ray_tpu_torch.put(value)
        id_bytes = ref.id().binary()
        runtime._export_once(id_bytes, value)
        source = runtime._export_sources[id_bytes]
        served_before = runtime._export_store.stats()["fetches_served"]
        puller = _service("ray_tpu_torch")
        try:
            fetch_ref = _mod("ray_tpu_torch", "_private.node_executor").FetchRef
            got = puller._load_object(fetch_ref(id_bytes, runtime._export_addr))
            released = _wait(
                lambda: runtime._export_leases.stats()["active"] == 0)
            return {"kind": source[0], "name": source[1] == runtime.arena.name,
                    "equal": bool(np.array_equal(got, value)),
                    "copy_hits": puller.same_host_copy_hits,
                    "map_hits": puller.same_host_map_hits,
                    "chunked_pulls": puller.chunked_pulls,
                    "served": runtime._export_store.stats()["fetches_served"]
                    - served_before,
                    "released": released,
                    "leases": runtime._export_leases.stats()}
        finally:
            puller.stop()

    assert _driver_on_a_head(body) == {
        "kind": "arena", "name": True, "equal": True, "copy_hits": 1,
        "map_hits": 0, "chunked_pulls": 0, "served": 0, "released": True,
        "leases": {"active": 0, "granted": 1, "released": 1, "expired": 0}}


# A driver's arena in a child process: the object ``k``*16 in it, its name
# and the object's size on stdout, then it waits to be killed.
_ARENA_OWNER = """
import os, sys
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.arena_store import ArenaStore, default_arena_name
arena = ArenaStore.create(default_arena_name(), 1 << 20, 64)
blob = serialization.serialize_framed(b"payload-%d" % os.getpid())
assert arena.put_bytes(b"k" * 16, [blob])
print(arena.name, len(blob), flush=True)
sys.stdin.read()
"""


def _arena_owner():
    """A child process owning a driver-named arena: (process, its
    PeerArenaDescriptor of the object in it)."""
    import subprocess
    import sys

    desc_cls = _mod("ray_tpu_torch", "_private.shm_store").PeerArenaDescriptor
    proc = subprocess.Popen(
        [sys.executable, "-c", _ARENA_OWNER], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    name, size = proc.stdout.readline().split()
    return proc, desc_cls(name, b"k" * 16, int(size))


def _kill(proc) -> None:
    import signal

    proc.send_signal(signal.SIGKILL)  # dies without destroying its arena
    proc.wait()
    proc.stdin.close()
    proc.stdout.close()


def test_a_daemon_sweep_detaches_a_dead_drivers_arena():
    """Port only: a daemon's mapping of a driver's arena goes once that
    driver has died (its pages would stay committed while mapped), and
    the sweep unlinks the arena. While the driver lives, both stay."""
    same_host = _mod("ray_tpu_torch", "_private.same_host")
    with time_limit(60):
        proc, desc = _arena_owner()
        svc = _service("ray_tpu_torch")
        try:
            assert svc._peer_arenas.read(desc.arena, desc.key) is not None
            svc._sweep_transfer_plane()
            alive = (svc._peer_arenas.names(), svc.peer_arenas_detached)
            _kill(proc)
            svc._sweep_transfer_plane()
            dead = (svc._peer_arenas.names(), svc.peer_arenas_detached)
            left = os.path.exists("/dev/shm" + desc.arena)
        finally:
            if proc.poll() is None:
                _kill(proc)
            svc.stop()
            same_host.sweep_orphan_shm()
    assert (alive, dead, left) == (([desc.arena], 0), ([], 1), False)


def test_a_workers_client_lets_a_dead_drivers_arena_go_at_its_next_attach():
    """Port only: a pool worker's client, which has read out of a
    driver's arena that then died, detaches it when it attaches the next
    driver's arena; the live one stays."""
    shm_store = _mod("ray_tpu_torch", "_private.shm_store")
    same_host = _mod("ray_tpu_torch", "_private.same_host")
    with time_limit(60):
        first, first_desc = _arena_owner()
        second, second_desc = _arena_owner()
        client = shm_store.ShmClient(untrack_on_attach=True)
        try:
            got = [client.get(first_desc)]
            _kill(first)
            got.append(client.get(second_desc))
            names = client._peer_arenas.names()
        finally:
            client.close_all()
            for proc in (first, second):
                if proc.poll() is None:
                    _kill(proc)
            same_host.sweep_orphan_shm()
    assert got == [b"payload-%d" % first.pid, b"payload-%d" % second.pid]
    assert names == [second_desc.arena]
