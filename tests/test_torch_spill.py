"""The port's managed spill tier (``spill_manager.py`` and the store's
tier) against the JAX package's.

Each mirrored case runs the same scenario once through ``ray_tpu`` and
once through ``ray_tpu_torch``, each package with its own spill manager,
``ObjectStore``, ids and config, on the same values (random bytes from a
seed), and returns a plain record; the two records must be equal, and
equal to what the mirrored test of tests/test_spill.py asserts. The
three cases after them take tests/test_spill.py's contract for the node
store (the watermark hysteresis, the spiller waking on a put, restores
racing concurrent gets) onto the driver ``ObjectStore`` of both
packages, which has ``enable_managed_spill`` too.

The port-only cases at the end each state where the port differs: an
object holding a tensor on a card is never spilled by the tier (the
reference pickles ``jax.Array``s to disk); it moves to ``device_bytes``
and is never marked unspillable. ``meta`` tensors stand in for tensors
on a card here. The head's directory keeps a spill mark that landed
before its owner's publish for one lease (the reference drops it at the
next prune, and the mark is lost: F17.4); the two cases after the
mirrored directory case hold that.
"""

import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu._private import spill_manager as jax_spill
from ray_tpu._private.config import GLOBAL_CONFIG as JAX_CONFIG
from ray_tpu._private.ids import ObjectID as JaxObjectID
from ray_tpu._private.object_store import ObjectStore as JaxStore
from ray_tpu_torch._private import spill_manager as torch_spill
from ray_tpu_torch._private.config import GLOBAL_CONFIG as TORCH_CONFIG
from ray_tpu_torch._private.ids import ObjectID as TorchObjectID
from ray_tpu_torch._private.object_store import ObjectStore as TorchStore

PACKAGES = {
    "ray_tpu": {"spill": jax_spill, "store": JaxStore, "oid": JaxObjectID,
                "config": JAX_CONFIG, "pkg": "ray_tpu"},
    "ray_tpu_torch": {"spill": torch_spill, "store": TorchStore,
                      "oid": TorchObjectID, "config": TORCH_CONFIG,
                      "pkg": "ray_tpu_torch"},
}
WAIT_S = 10.0


def _monitor(p):
    import importlib

    return importlib.import_module(f"{p['pkg']}._private.memory_monitor")


def _reset(p) -> None:
    monitor = _monitor(p)
    monitor._set_usage_override(None)
    monitor._set_store_fraction_override(None)
    p["config"].reset()
    p["spill"].init_from_config()


@pytest.fixture(autouse=True)
def _spill_env(tmp_path, monkeypatch):
    """A session directory of its own for each package, the default
    config and the tier armed (restored after)."""
    monkeypatch.setenv("RAY_TPU_SESSION_DIR", str(tmp_path / "jax_session"))
    monkeypatch.setenv(torch_spill.SESSION_DIR_ENV,
                       str(tmp_path / "torch_session"))
    for p in PACKAGES.values():
        _reset(p)
    yield
    for p in PACKAGES.values():
        _reset(p)


def _both(scenario, tmp_path) -> dict:
    records = {}
    for name, p in PACKAGES.items():
        (tmp_path / name).mkdir()
        records[name] = scenario(p, tmp_path / name)
    return records


def _blob(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _error(fn) -> "str | None":
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        return type(exc).__name__
    return None


# ------------------------------------------------ mirrored: test_spill


def file_round_trip_and_tear_detection(p, tmp_path):
    spill = p["spill"]
    path = str(tmp_path / "x.spill")
    payload = _blob(0, 64 * 1024)
    spill.write_spill_file(path, payload)
    record = [spill.read_spill_file(path) == payload]
    # Truncation (a crash mid-write after the header landed).
    with open(path, "r+b") as f:
        f.truncate(16 + len(payload) // 2)
    record.append(_error(lambda: spill.read_spill_file(path)))
    # One flipped byte at full length fails the CRC.
    spill.write_spill_file(path, payload)
    with open(path, "r+b") as f:
        f.seek(16 + 1000)
        f.write(bytes([payload[1000] ^ 0xFF]))
    record.append(_error(lambda: spill.read_spill_file(path)))
    # A foreign file in the spill directory: bad magic.
    with open(path, "wb") as f:
        f.write(b"NOPE" + b"\0" * 32)
    record.append(_error(lambda: spill.read_spill_file(path)))
    # The header: magic, u64 length, CRC32, then the payload.
    spill.write_spill_file(path, b"abc")
    with open(path, "rb") as f:
        record.append(f.read().hex())
    return record


def test_spill_file_round_trip_and_tear_detection(tmp_path):
    records = _both(file_round_trip_and_tear_detection, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [
        True, "TornSpillError", "TornSpillError", "TornSpillError",
        "52545331" "0300000000000000" "c2412435" "616263"]


def driver_store_pinned_reader_never_spilled(p, tmp_path):
    store = p["store"](memory_limit_bytes=256 * 1024,
                       spill_dir=str(tmp_path / "legacy"))
    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"))
    try:
        pinned, other = p["oid"](), p["oid"]()
        store.put(pinned, _blob(1, 200 * 1024))
        with store._lock:
            store._entries[pinned].pin_count += 1
        try:
            store.put(other, _blob(2, 200 * 1024))
            mgr.spill_pass()
            with store._lock:
                pinned_spilled = store._entries[pinned].spilled_path
        finally:
            with store._lock:
                store._entries[pinned].pin_count -= 1
        # The unpinned one went instead (by the pass or the spiller).
        deadline = time.monotonic() + WAIT_S
        while store._entries[other].spilled_path is None \
                and time.monotonic() < deadline:
            mgr.spill_pass()
            time.sleep(0.01)
        return [pinned_spilled, store._entries[other].spilled_path
                is not None, store.get(pinned) == _blob(1, 200 * 1024)]
    finally:
        mgr.stop()


def test_driver_store_pinned_reader_never_spilled(tmp_path):
    records = _both(driver_store_pinned_reader_never_spilled, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [None, True, True]


def driver_store_torn_restore_fires_recovery_hook(p, tmp_path):
    store = p["store"](memory_limit_bytes=128 * 1024,
                       spill_dir=str(tmp_path / "legacy"))
    rebuilt = {"n": 0}
    oid = p["oid"]()
    value = _blob(3, 200 * 1024)

    def on_torn(object_id):
        rebuilt["n"] += 1
        store.put(object_id, value)  # the lineage rebuild's stand-in

    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"),
                                     on_torn=on_torn)
    try:
        store.put(oid, value)
        mgr.spill_pass()
        with store._lock:
            path = store._entries[oid].spilled_path
        with open(path, "r+b") as f:
            f.seek(20)
            f.write(b"\xff\xff\xff\xff")
        got = store.get(oid, timeout=30)
        return [path is not None, got == value, rebuilt["n"],
                mgr.stats()["torn_restores"], os.path.exists(path)]
    finally:
        mgr.stop()


def test_driver_store_torn_restore_fires_recovery_hook(tmp_path):
    records = _both(driver_store_torn_restore_fires_recovery_hook, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, True, 1, 1, False]


def driver_store_torn_without_hook_fails_typed(p, tmp_path):
    store = p["store"](memory_limit_bytes=64 * 1024,
                       spill_dir=str(tmp_path / "legacy"))
    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"))
    try:
        oid = p["oid"]()
        store.put(oid, _blob(4, 100 * 1024))
        mgr.spill_pass()
        with store._lock:
            path = store._entries[oid].spilled_path
        with open(path, "r+b") as f:
            f.truncate(40)
        return [path is not None,
                _error(lambda: store.get(oid, timeout=30)),
                mgr.stats()["torn_restores"]]
    finally:
        mgr.stop()


def test_driver_store_torn_without_hook_fails_typed(tmp_path):
    records = _both(driver_store_torn_without_hook_fails_typed, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, "ObjectLostError", 1]


def memory_pressure_two_axis_classification(p, tmp_path):
    monitor = _monitor(p)
    monitor._set_usage_override(0.5)
    record = [monitor.memory_pressure_kind(0.8)]
    # Over the watermark, but spilling the store's bytes brings it under.
    monitor._set_usage_override(0.9)
    monitor._set_store_fraction_override(0.5)
    record.append(monitor.memory_pressure_kind(0.8))
    # Over it with a negligible store share: host pressure.
    monitor._set_store_fraction_override(0.02)
    record.append(monitor.memory_pressure_kind(0.8))
    # A disabled watermark never classifies.
    record.append(monitor.memory_pressure_kind(0.0))
    return record


def test_memory_pressure_two_axis_classification(tmp_path):
    records = _both(memory_pressure_two_axis_classification, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [None, "store", "host", None]


def orphan_spill_dir_sweep(p, tmp_path):
    spill = p["spill"]
    root = spill.session_spill_root()
    # A dead pid: a child that ran and was reaped.
    proc = subprocess.Popen(["true"])
    proc.wait()
    dead = os.path.join(root, str(proc.pid))
    os.makedirs(dead, exist_ok=True)
    with open(os.path.join(dead, "x.spill"), "wb") as f:
        f.write(b"orphan")
    # This process's directory survives the sweep.
    mine = spill.process_spill_dir()
    os.makedirs(mine, exist_ok=True)
    with open(os.path.join(mine, "live.spill"), "wb") as f:
        f.write(b"live")
    return [spill.sweep_orphan_spill_dirs(), os.path.exists(dead),
            os.path.exists(os.path.join(mine, "live.spill")),
            spill.sweep_orphan_spill_dirs()]


def test_orphan_spill_dir_sweep(tmp_path):
    records = _both(orphan_spill_dir_sweep, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [1, False, True, 0]


# ------------------- test_spill.py's node-store contract, driver store


def watermark_hysteresis(p, tmp_path):
    """Nothing spills below the high watermark; crossing it spills down
    to the low one, not merely back under the high one."""
    p["config"].update({"spill_high_watermark": 0.8,
                        "spill_low_watermark": 0.4})
    store = p["store"](memory_limit_bytes=1000 * 1000,
                       spill_dir=str(tmp_path / "legacy"))
    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"))
    try:
        blobs = {}
        for i in range(7):  # 700 KB, under the 800 KB high watermark
            blobs[i] = _blob(10 + i, 100 * 1000)
            store.put(p["oid"](), blobs[i])
        quiet = [mgr.spill_pass(), mgr.stats()["spills"]]
        for i in range(7, 10):  # 1,000 KB: over it
            blobs[i] = _blob(10 + i, 100 * 1000)
            store.put(p["oid"](), blobs[i])
        deadline = time.monotonic() + WAIT_S
        while store._memory_used > mgr.low_bytes():
            # Forced, as admission's kick: the spiller's own pass may
            # have left usage between the watermarks.
            mgr.spill_pass(force=True)
            assert time.monotonic() < deadline, "never reached low"
        stats = mgr.stats()
        at_low = store._memory_used <= 400 * 1000
        readable = sorted(store.get(oid) for oid in list(store._entries))
        return [*quiet, at_low, stats["spills"] >= 6,
                stats["spilled_bytes"] >= 600 * 1000,
                readable == sorted(blobs.values())]
    finally:
        mgr.stop()


def test_driver_store_watermark_hysteresis(tmp_path):
    records = _both(watermark_hysteresis, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [0, 0, True, True, True, True]


def spiller_wakes_on_put(p, tmp_path):
    store = p["store"](memory_limit_bytes=512 * 1024,
                       spill_dir=str(tmp_path / "legacy"))
    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"))
    try:
        for i in range(4):
            store.put(p["oid"](), _blob(20 + i, 256 * 1024))
        deadline = time.monotonic() + WAIT_S
        while mgr.stats()["spills"] == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        woke = mgr.stats()["spills"] > 0
        # The same pass goes on down to the low watermark.
        while store._memory_used > mgr.low_bytes() \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        return [woke, store._memory_used <= mgr.low_bytes()]
    finally:
        mgr.stop()


def test_driver_store_spiller_thread_wakes_on_put(tmp_path):
    records = _both(spiller_wakes_on_put, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [True, True]


def restore_under_concurrent_gets(p, tmp_path):
    """Readers hammer spilled objects while spill passes keep running:
    every get returns the exact bytes, and the files on disk end as the
    ones the store has registered."""
    store = p["store"](memory_limit_bytes=600 * 1024,
                       spill_dir=str(tmp_path / "legacy"))
    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"))
    try:
        blobs = {}
        for i in range(8):
            oid = p["oid"]()
            blobs[oid] = _blob(30 + i, 150 * 1024)
            store.put(oid, blobs[oid])
        while store._memory_used > mgr.low_bytes() and mgr.spill_pass():
            pass
        spilled_first = mgr.stats()["spills"] > 0
        errors: list = []
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                for oid, blob in blobs.items():
                    if bytes(store.get(oid)) != blob:
                        errors.append("mismatch")
                        return

        def churner():
            while not stop.is_set():
                mgr.spill_pass()
                time.sleep(0.001)

        threads = [threading.Thread(target=reader) for _ in range(4)] \
            + [threading.Thread(target=churner)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        wedged = any(t.is_alive() for t in threads)
        stats = mgr.stats()
        # The spiller may be mid-write when the churners stop: its .tmp
        # file is no leak, so the sets are compared after it settles.
        deadline = time.monotonic() + WAIT_S
        while True:
            on_disk = set(os.listdir(mgr.spill_dir))
            with store._lock:
                registered = {os.path.basename(e.spilled_path)
                              for e in store._entries.values()
                              if e.spilled_path is not None}
            if on_disk == registered or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        return [spilled_first, wedged, errors, stats["restores"] > 0,
                stats["torn_restores"], on_disk == registered]
    finally:
        mgr.stop()


def test_driver_store_restore_under_concurrent_get_races(tmp_path):
    records = _both(restore_under_concurrent_gets, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, False, [], True, 0, True]


# ------------------------------------------------------------- port only


def _managed_torch_store(tmp_path, limit=1 << 20):
    store = TorchStore(limit, str(tmp_path / "legacy"))
    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"))
    return store, mgr


class _Slotted:
    """Holds a tensor where the size walk does not look."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor


def test_a_device_tensor_under_the_tier_moves_to_device_bytes(tmp_path):
    """An object whose tensor on a card the size walk cannot see (behind
    ``__slots__``) is chosen by the tier as a host object: the pickle
    refuses the tensor, and the object moves to ``device_bytes``, out of
    the budget, with no file written and without being marked
    unspillable. That brings the host bytes under the low watermark, so
    the host array beside it stays in memory."""
    store, mgr = _managed_torch_store(tmp_path)
    try:
        hidden, host = TorchObjectID(), TorchObjectID()
        value = {"state": _Slotted(torch.empty(1 << 20, device="meta")),
                 "batch": np.zeros(200_000, np.int32)}
        store.put(hidden, value)
        store.put(host, np.zeros(100_000, np.int32))
        # 1,200,064 host bytes, over the high watermark (891,289): the
        # largest victim goes first, and it holds the card's tensor.
        deadline = time.monotonic() + WAIT_S
        while not store._entries[hidden].on_device \
                and time.monotonic() < deadline:
            mgr.spill_pass()
            time.sleep(0.01)
        entry = store._entries[hidden]
        stats = store.stats()
        assert [entry.on_device, entry.spilled_path, entry.size_bytes,
                stats["device_bytes"], hidden in store._unspillable,
                store._entries[host].spilled_path,
                os.listdir(mgr.spill_dir) if os.path.isdir(mgr.spill_dir)
                else [], store._host_used(),
                store.get(hidden) is value] == \
            [True, None, 800_064, 800_064, False, None, [], 400_000, True]
    finally:
        mgr.stop()


def test_an_object_seen_on_a_card_is_never_a_victim(tmp_path):
    """An object the size walk sees on a card is charged as device bytes
    from its put: the tier never picks it, whatever its size, and spills
    the host object instead."""
    store, mgr = _managed_torch_store(tmp_path)
    try:
        weights, host = TorchObjectID(), TorchObjectID()
        tree = {"w": torch.empty(1 << 22, device="meta")}
        store.put(weights, tree)
        store.put(host, np.zeros(250_000, np.int32))
        deadline = time.monotonic() + WAIT_S
        while store._entries[host].spilled_path is None \
                and time.monotonic() < deadline:
            mgr.spill_pass(force=True)
            time.sleep(0.01)
        stats = store.stats()
        assert [store._entries[weights].spilled_path,
                store._entries[host].spilled_path is not None,
                stats["device_bytes"], stats["spilled_bytes_total"],
                mgr.stats()["spills"], store.get(weights) is tree] == \
            [None, True, 1 << 24, 1_000_000, 1, True]
    finally:
        mgr.stop()


def test_mark_lost_of_a_device_entry_leaves_device_bytes_right(tmp_path):
    """A lost object that held a tensor on a card gives back its bytes on
    both counts; a reseal (the rebuild) charges them again."""
    store, mgr = _managed_torch_store(tmp_path)
    try:
        oid = TorchObjectID()
        store.put(oid, {"w": torch.empty(1024, device="meta")})
        before = store.stats()
        assert store.mark_lost(oid) and store.is_lost(oid)
        lost = store.stats()
        store.put(oid, {"w": torch.empty(1024, device="meta")})
        after = store.stats()
        assert [before["memory_used_bytes"], before["device_bytes"],
                lost["memory_used_bytes"], lost["device_bytes"],
                store.is_lost(oid), after["device_bytes"]] == \
            [4096, 4096, 0, 0, False, 4096]
    finally:
        mgr.stop()


def test_disarmed_tier_keeps_the_inline_spill(tmp_path):
    """``spill_enabled=False``: no manager is built and a put past the
    budget spills inline, synchronously, to the spill directory."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=30_000,
                       system_config={"spill_enabled": False})
    try:
        runtime = ray_tpu_torch._private.worker.global_runtime()
        refs = [ray_tpu_torch.put(torch.full((4096,), float(i)))
                for i in range(2)]
        assert runtime.store._spill is None
        assert runtime.store.stats()["spilled_bytes_total"] == 16384
        assert runtime.spill_stats()["spills"] == 0
        assert [ray_tpu_torch.get(r)[0].item() for r in refs] == [0.0, 1.0]
    finally:
        ray_tpu_torch.shutdown()


# -------------------------------------- mirrored: the node store's tier


def _node_executor(p):
    import importlib

    return importlib.import_module(f"{p['pkg']}._private.node_executor")


def _managed_blob_store(p, tmp_path, limit_bytes, **kwargs):
    p["config"].update({"spill_min_object_kb": 1})
    store = _node_executor(p).NodeObjectStore(
        primary_limit_bytes=limit_bytes, spill_dir=str(tmp_path / "legacy"))
    mgr = store.enable_managed_spill(spill_dir=str(tmp_path / "managed"),
                                     **kwargs)
    return store, mgr


def _key(i: int) -> bytes:
    return np.random.default_rng(1000 + i).bytes(16)


def leased_objects_never_spilled(p, tmp_path):
    leased_key = _key(0)
    store, mgr = _managed_blob_store(p, tmp_path, 512 * 1024,
                                     leased_fn=lambda: {leased_key})
    try:
        store.put(leased_key, _blob(30, 400 * 1024), owner="o")
        for i in range(3):
            store.put(_key(1 + i), _blob(31 + i, 200 * 1024), owner="o")
        while store._primary_bytes > mgr.low_bytes() and mgr.spill_pass():
            pass
        with store._lock:
            return [leased_key in store._blobs,
                    leased_key in store._spilled, len(store._spilled) > 0]
    finally:
        mgr.stop()


def test_node_store_leased_objects_never_spilled(tmp_path):
    records = _both(leased_objects_never_spilled, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, False, True]


def pulled_cache_copies_never_spilled(p, tmp_path):
    store, mgr = _managed_blob_store(p, tmp_path, 256 * 1024)
    try:
        cached_key = _key(10)
        store.put(cached_key, _blob(40, 300 * 1024), cached=True)
        for i in range(2):
            store.put(_key(11 + i), _blob(41 + i, 200 * 1024), owner="o")
        while store._primary_bytes > mgr.low_bytes() and mgr.spill_pass():
            pass
        with store._lock:
            return [cached_key in store._spilled,
                    cached_key in store._blobs, len(store._spilled) > 0]
    finally:
        mgr.stop()


def test_node_store_pulled_cache_copies_never_spilled(tmp_path):
    records = _both(pulled_cache_copies_never_spilled, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [False, True, True]


def directory_spilled_location_pruned_on_node_death(p, tmp_path):
    import importlib

    directory = importlib.import_module(
        f"{p['pkg']}._private.gcs").ObjectDirectory()
    directory.update("owner-a", [("obj1", "nodeX"), ("obj2", "nodeX"),
                                 ("obj2", "nodeY")], [])
    directory.mark_spilled("owner-a", "obj1", "nodeX")
    directory.mark_spilled("owner-a", "obj2", "nodeX")
    record = [directory.spilled("owner-a")]
    # A restore clears the mark (the holder never left the set).
    directory.clear_spilled("owner-a", "obj2")
    record.append(directory.spilled("owner-a"))
    directory.mark_spilled("owner-a", "obj2", "nodeX")
    record += [directory.prune_node("nodeX"), directory.spilled("owner-a"),
               directory.locations("owner-a")]
    # The owner's free drops the mark with the holders.
    directory.mark_spilled("owner-a", "obj2", "nodeY")
    directory.update("owner-a", [], ["obj2"])
    return record + [directory.spilled("owner-a")]


def test_directory_spilled_location_pruned_on_node_death(tmp_path):
    records = _both(directory_spilled_location_pruned_on_node_death,
                    tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [
        {"obj1": "nodeX", "obj2": "nodeX"}, {"obj1": "nodeX"}, ["obj1"],
        {}, {"obj2": ["nodeY"]}, {}]


def spill_mark_before_the_owners_publish(p, tmp_path):
    """A daemon's heartbeat marks a result spilled under its own name for
    the owner before the owner's first publish of the object lands; the
    head's monitor prunes in between. Then the same from a restored
    directory, before the owner's republish."""
    import importlib

    directory_type = importlib.import_module(
        f"{p['pkg']}._private.gcs").ObjectDirectory
    directory = directory_type()
    directory.mark_spilled("client-endpoint", "obj1", "nodeX")
    directory.prune()
    directory.update("export-owner", [("obj1", "nodeX")], [])
    record = [directory.spilled()]
    restored = directory_type()
    restored.restore_state(
        {"locations": {}, "spilled": {"client-endpoint": {"obj1": "nodeX"}}})
    restored.prune()
    restored.update("export-owner", [("obj1", "nodeX")], [])
    return record + [restored.spilled()]


def test_a_spill_mark_before_the_owners_publish_survives_the_prune(
        tmp_path):
    """Port only (F17.4): the reference drops such a mark at the prune
    and the daemon never sends it again, so the spilled result has no
    mark for good; the port keeps an unowned mark for one lease."""
    records = _both(spill_mark_before_the_owners_publish, tmp_path)
    assert records["ray_tpu"] == [{}, {}]
    assert records["ray_tpu_torch"] == [{"obj1": "nodeX"}] * 2


def test_an_orphan_spill_mark_goes_a_lease_after_it_landed():
    """Port only (F17.4): a mark whose object no owner ever publishes is
    kept for one lease, then pruned."""
    from ray_tpu_torch._private.gcs import ObjectDirectory

    directory = ObjectDirectory()
    directory.mark_spilled("client-endpoint", "obj1", "nodeX")
    directory.prune(ttl_s=60.0)
    kept = directory.spilled()
    time.sleep(0.05)
    directory.prune(ttl_s=0.01)
    assert [kept, directory.spilled(), directory._marked_at] == [
        {"obj1": "nodeX"}, {}, {}]


def _executor(p, plane: bool = False):
    """A node executor with the tier armed; the same-host plane off in
    both packages (both take the chunked pull) unless ``plane``, with
    every object then given a segment twin."""
    config = {"spill_min_object_kb": 1}
    if plane:
        config["same_host_map_min_kb"] = 1
    else:
        config["same_host_plane"] = False
    p["config"].update(config)
    svc = _node_executor(p).NodeExecutorService(
        host="127.0.0.1", pool_size=1, resources={"CPU": 1})
    svc.advertised_address = f"127.0.0.1:{svc.port}"
    return svc


def fetch_plan_reply_is_spill_aware(p, tmp_path):
    from ray_tpu_torch._private import serialization

    svc = _executor(p)
    svc.start()
    try:
        armed = svc._spill_mgr is not None
        blob = serialization.serialize_framed(_blob(50, 200 * 1024))
        oid = _key(20)
        svc.store.put(oid, blob, owner="test-owner")
        svc._spill_mgr.capacity = 1
        svc._spill_mgr.spill_pass()
        spilled = svc.store.is_spilled(oid)
        plan = svc.fetch_plan(oid, None)
        record = [armed, spilled, plan[0] == len(blob),
                  plan[-1]["spilled"]]
        # A read restores the in-memory copy transparently.
        record.append(svc.store.get(oid) == blob)
        record.append(svc.fetch_plan(oid, None)[-1]["spilled"])
        events = svc._drain_spill_events()
        record.append(sorted({(owner, kind) for owner, _hex, kind
                              in events}))
        return record
    finally:
        svc.stop()


def test_fetch_plan_reply_is_spill_aware(tmp_path):
    records = _both(fetch_plan_reply_is_spill_aware, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [
        True, True, True, True, True, False,
        [("test-owner", "restored"), ("test-owner", "spilled")]]


def fetch_plan_spill_aware_with_the_plane(p, tmp_path):
    """tests/test_spill.py:340 as it runs there (the plane on, a segment
    twin for every object): a spilled primary's plan has no map source
    (the twin went with the spill) and says spilled; a read restores it."""
    from ray_tpu_torch._private import serialization

    svc = _executor(p, plane=True)
    svc.start()
    try:
        blob = serialization.serialize_framed(_blob(51, 200 * 1024))
        oid = _key(21)
        svc.store.put(oid, blob, owner="test-owner")
        svc._maybe_export_stored(oid, blob)
        with svc._shm_args_lock:
            record = [svc._spill_mgr is not None, oid in svc._map_sources]
        svc._spill_mgr.capacity = 1
        svc._spill_mgr.spill_pass()
        with svc._shm_args_lock:
            record += [svc.store.is_spilled(oid), oid in svc._map_sources]
        plan = svc.fetch_plan(oid, None, None)
        record += [plan[3]["spilled"], plan[0] == len(blob), plan[2]]
        # A puller on this host is granted no lease on a spilled copy.
        plan = svc.fetch_plan(oid, "127.0.0.1:1", svc.host_id)
        record += [plan[2], svc.leases.stats()["granted"]]
        record.append(svc.store.get(oid) == blob)
        record.append(svc.fetch_plan(oid, None, None)[3]["spilled"])
        kinds = {(owner, kind) for owner, _hex, kind
                 in svc._drain_spill_events()}
        record.append(sorted(kinds))
        return record
    finally:
        svc.stop()


def test_fetch_plan_spill_aware_with_the_plane(tmp_path):
    records = _both(fetch_plan_spill_aware_with_the_plane, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [
        True, True, True, False, True, True, None, None, 0, True, False,
        [("test-owner", "restored"), ("test-owner", "spilled")]]


def disk_full_backoff_degrades_to_host_pressure(p, tmp_path):
    monitor = _monitor(p)
    p["config"].update({"admission_memory_watermark": 0.8})
    svc = _node_executor(p).NodeExecutorService(
        host="127.0.0.1", pool_size=1, resources={"CPU": 1})
    try:
        monitor._set_usage_override(0.9)
        monitor._set_store_fraction_override(0.5)
        record = [svc._overload_reason()]
        with svc._spill_mgr._lock:
            svc._spill_mgr._backoff_until = time.monotonic() + 30
        reason = svc._overload_reason()
        record.append(reason is not None and "disk is full" in reason)
        with svc._spill_mgr._lock:
            svc._spill_mgr._backoff_until = 0.0
        monitor._set_store_fraction_override(0.02)
        record.append("host memory" in svc._overload_reason())
        return record
    finally:
        svc.stop()


def test_disk_full_backoff_degrades_to_host_pressure(tmp_path):
    records = _both(disk_full_backoff_degrades_to_host_pressure, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [None, True, True]


def spilled_arg_restored_for_a_task(p, tmp_path):
    import importlib

    from ray_tpu_torch._private import serialization

    node_executor = _node_executor(p)
    shm_store = importlib.import_module(f"{p['pkg']}._private.shm_store")
    svc = _executor(p)
    svc.start()
    try:
        payload = _blob(60, 300 * 1024)
        blob = serialization.serialize_framed(payload)
        oid = _key(30)
        svc.store.put(oid, blob, owner="test-owner")
        svc._spill_mgr.capacity = 1
        svc._spill_mgr.spill_pass()
        spilled = svc.store.is_spilled(oid)
        args, _ = svc._resolve_fetch_args(
            (node_executor.FetchRef(oid, svc.advertised_address),), {},
            to_shm=True)
        client = shm_store.ShmClient(untrack_on_attach=True)
        try:
            mapped = bytes(client.get(args[0].desc)) == payload
        finally:
            client.close_all()
        return [spilled, mapped,
                svc._spill_mgr.stats()["restores"] >= 1]
    finally:
        svc.stop()


def test_spilled_arg_restored_for_a_task(tmp_path):
    records = _both(spilled_arg_restored_for_a_task, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, True, True]


def cluster_spill_and_restore_end_to_end(p, tmp_path):
    """A working set past a daemon's store: results spill on the node,
    tasks taking spilled arguments restore them there, the driver's gets
    restore the rest; the counters come over RPC."""
    import importlib

    rt = p["pkg"] == "ray_tpu" and __import__("ray_tpu") or ray_tpu_torch
    env_prefix = "RAY_TPU_" if p["pkg"] == "ray_tpu" else "RAY_TPU_TORCH_"
    cluster_cls = importlib.import_module(
        f"{p['pkg']}.cluster_utils").Cluster
    rt.shutdown()
    cluster = cluster_cls(log_dir=str(tmp_path / "cluster"))
    cluster.add_node(num_cpus=4, resources={"spl": 10.0}, pool_size=2,
                     heartbeat_period_s=0.5,
                     env={env_prefix + "NODE_STORE_PRIMARY_LIMIT_MB": "1",
                          env_prefix + "SPILL_MIN_OBJECT_KB": "16"})
    runtime = None
    try:
        assert cluster.wait_for_nodes(1, timeout=60)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        deadline = time.monotonic() + 30
        while rt.cluster_resources().get("spl", 0) <= 0:
            assert time.monotonic() < deadline
            time.sleep(0.2)

        @rt.remote(resources={"spl": 1.0})
        def produce(i):
            import numpy

            return b"%d:" % i + numpy.random.default_rng(i).bytes(
                600 * 1024)

        @rt.remote(resources={"spl": 1.0})
        def consume(blob, i):
            assert blob.startswith(b"%d:" % i)
            return len(blob)

        refs = [produce.remote(i) for i in range(6)]  # ~3.6 MB on 1 MB
        sizes = rt.get([consume.remote(r, i) for i, r in enumerate(refs)],
                       timeout=120)
        blobs = rt.get(refs, timeout=120)
        with runtime._remote_nodes_lock:
            handle = next(iter(runtime._remote_nodes.values()))
        stats = handle.pool.call("executor_stats")["spill"]
        return [sizes == [600 * 1024 + len(b"%d:" % i) for i in range(6)],
                [b[:2] for b in blobs], stats["spills"] > 0,
                stats["restores"] > 0, stats["torn_restores"]]
    finally:
        if runtime is not None:
            rt.shutdown()
        cluster.shutdown()


def test_cluster_spill_and_restore_end_to_end(tmp_path):
    from torch_time_limit import time_limit

    with time_limit(300):
        records = _both(cluster_spill_and_restore_end_to_end, tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [
        True, [b"%d:" % i for i in range(6)], True, True, 0]


def disarmed_node_store_is_the_legacy_inline_spill(p, tmp_path):
    monitor = _monitor(p)
    config = {"spill_enabled": False, "admission_memory_watermark": 0.8}
    if p["pkg"] == "ray_tpu":
        config["node_store_native"] = False
    p["config"].update(config)
    p["spill"].init_from_config()
    legacy_dir = str(tmp_path / "legacy")
    node_executor = _node_executor(p)
    store = node_executor.NodeObjectStore(primary_limit_bytes=256 * 1024,
                                          spill_dir=legacy_dir)
    record = [p["spill"].SPILL_ON, store._spill_mgr]
    blobs = {}
    for i in range(4):
        blobs[_key(40 + i)] = _blob(70 + i, 200 * 1024)
        store.put(_key(40 + i), blobs[_key(40 + i)], owner="o")
    names = os.listdir(legacy_dir)
    record += [store.stats()["spills"] > 0,
               bool(names) and all(n.startswith(f"{os.getpid()}-")
                                   and n.endswith(".blob") for n in names),
               os.path.isdir(p["spill"].process_spill_dir()),
               all(store.get(k) == b for k, b in blobs.items())]
    svc = node_executor.NodeExecutorService(
        host="127.0.0.1", pool_size=1, resources={"CPU": 1})
    try:
        record.append(svc._spill_mgr)
        # One axis: the host watermark sheds even for store bytes.
        monitor._set_usage_override(0.9)
        monitor._set_store_fraction_override(0.9)
        record.append("host memory" in svc._overload_reason())
    finally:
        svc.stop()
    return record


def test_disarmed_node_store_is_the_legacy_inline_spill(tmp_path):
    records = _both(disarmed_node_store_is_the_legacy_inline_spill,
                    tmp_path)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [
        False, None, True, True, False, True, None, True]
