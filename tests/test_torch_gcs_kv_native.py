"""The port's native KV engine (``ray_tpu_torch/_private/gcs_kv_native.py``
over ``ray_tpu_torch/_native/gcs_kv.cpp``) against the JAX package's.

Each case of tests/test_gcs_kv_native.py runs once through ``ray_tpu``
and once through ``ray_tpu_torch`` with the same operations, for the
Python store and for the native engine, and returns a plain record; the
records must be equal, and equal to what the reference case asserts.
Beyond the reference: a head's snapshot and WAL written with one engine
restore into the other, both ways, so the durable head restarts across
the ``gcs_kv_native`` knob.

The JAX package's library is loaded through ``tests/torch_native.py``
(its in-place build races the other processes of a run).

Where the port deliberately differs: the native engine has no silent
fallback. The reference skips these cases when its toolchain is missing
(and its head then keeps the Python store); the port's build raises, so
here the native engine is asserted, not probed. ``gcs_kv_native=False``
is the only way to the Python store.
"""

from __future__ import annotations

import importlib
import pickle
import struct
import time

import pytest

from torch_native import load_reference_native

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}._private.{name}")


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native library, loaded once its file is whole:
    its in-place build races the other processes of the run."""
    load_reference_native()


def _native(pkg: str):
    lib = load_reference_native() if pkg == "ray_tpu" \
        else importlib.import_module(f"{pkg}._native").load()
    assert lib is not None and hasattr(lib, "gcs_kv_create")
    return _mod(pkg, "gcs_kv_native").NativeKVStore(lib)


def _kv(pkg: str, impl: str):
    return _mod(pkg, "gcs").KVStore() if impl == "python" else _native(pkg)


def _both(scenario) -> dict:
    records = {pkg: scenario(pkg) for pkg in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def semantics(kv) -> dict:
    record = {"put": kv.put(b"a", b"1"),
              "no_overwrite": kv.put(b"a", b"2", overwrite=False),
              "kept": kv.get(b"a"), "overwrite": kv.put(b"a", b"3"),
              "new": kv.get(b"a"), "missing": kv.get(b"missing"),
              "exists": (kv.exists(b"a"), kv.exists(b"zz"))}
    kv.put(b"pre_1", b"x", namespace="ns2")
    kv.put(b"pre_2", b"y", namespace="ns2")
    kv.put(b"other", b"z", namespace="ns2")
    record["prefixed"] = sorted(kv.keys(b"pre_", namespace="ns2"))
    record["all"] = sorted(kv.keys(namespace="ns2"))
    record["none"] = kv.keys(b"zzz")
    version = kv.version
    record["delete"] = (kv.delete(b"a"), kv.delete(b"a"))
    record["version_moved"] = kv.version > version
    record["after_delete"] = (kv.exists(b"a"), kv.get(b"a"))
    return record


@pytest.mark.parametrize("impl", ["python", "native"])
def test_kv_semantics_parity(impl):
    assert _both(lambda pkg: semantics(_kv(pkg, impl))) == {
        "put": True, "no_overwrite": False, "kept": b"1", "overwrite": True,
        "new": b"3", "missing": None, "exists": (True, False),
        "prefixed": [b"pre_1", b"pre_2"],
        "all": [b"other", b"pre_1", b"pre_2"], "none": [],
        "delete": (True, False), "version_moved": True,
        "after_delete": (False, None)}


def large_and_binary(kv) -> dict:
    big = bytes(range(256)) * 4096  # 1 MiB, every byte value
    key = b"\x00\xff\x01binary"
    return {"put": kv.put(key, big), "get": kv.get(key) == big,
            "keys": kv.keys(b"\x00")}


@pytest.mark.parametrize("impl", ["python", "native"])
def test_kv_large_values_and_binary_keys(impl):
    assert _both(lambda pkg: large_and_binary(_kv(pkg, impl))) == {
        "put": True, "get": True, "keys": [b"\x00\xff\x01binary"]}


def snapshot_roundtrip(pkg: str, impl: str) -> dict:
    kv = _kv(pkg, impl)
    kv.put(b"k1", b"v1")
    kv.put(b"k2", b"v2" * 1000, namespace="big")
    # The persistence layer pickles this dict: it must round-trip.
    snap = pickle.loads(pickle.dumps(kv.snapshot()))
    fresh = _mod(pkg, "gcs_kv_native").make_kv_store()
    fresh.restore(snap)
    return {"fresh": type(fresh).__name__, "k1": fresh.get(b"k1"),
            "k2": fresh.get(b"k2", namespace="big") == b"v2" * 1000}


@pytest.mark.parametrize("impl", ["python", "native"])
def test_kv_snapshot_restore_roundtrip(impl):
    assert _both(lambda pkg: snapshot_roundtrip(pkg, impl)) == {
        "fresh": "NativeKVStore", "k1": b"v1", "k2": True}


def corrupt_restore(pkg: str) -> dict:
    """A forged count or a truncated image is refused (-1): no crash, no
    half-applied image, and the engine serves on."""
    kv = _native(pkg)
    forged_count = b"\xff\xff\xff\xffgarbage"
    truncated_blob = struct.pack("<I", 1) + struct.pack("<I", 999999) + b"x"
    codes = [kv._lib.gcs_kv_restore(kv._h, image, len(image))
             for image in (forged_count, truncated_blob)]
    return {"codes": codes, "put": kv.put(b"still", b"alive"),
            "get": kv.get(b"still"), "keys": kv.keys(namespace="default")}


def test_native_corrupt_restore_fails_cleanly():
    assert _both(corrupt_restore) == {
        "codes": [-1, -1], "put": True, "get": b"alive",
        "keys": [b"still"]}


def gcs_server_native_and_persists(pkg: str, tmp_path) -> dict:
    """The head's KV is the native engine by default, and its snapshot
    and restore work through it."""
    gcs_server = _mod(pkg, "gcs_server")
    log_dir = tmp_path / pkg
    log_dir.mkdir()
    snap = str(log_dir / "snap.pkl")
    server = gcs_server.GcsServer(host="127.0.0.1", port=0,
                                  log_dir=str(log_dir), persist_path=snap)
    engine = type(server.gcs.kv).__name__
    server.start()
    try:
        server.gcs.kv.put(b"funcs/abc", b"blob")
        server._save_snapshot()
    finally:
        server.stop()
    server2 = gcs_server.GcsServer(host="127.0.0.1", port=0,
                                   log_dir=str(log_dir), persist_path=snap)
    try:
        return {"engine": engine, "restarted": type(server2.gcs.kv).__name__,
                "kv": server2.gcs.kv.get(b"funcs/abc")}
    finally:
        server2.stop()


def test_gcs_server_uses_native_engine_and_persists(tmp_path):
    assert _both(lambda pkg: gcs_server_native_and_persists(
        pkg, tmp_path)) == {
        "engine": "NativeKVStore", "restarted": "NativeKVStore",
        "kv": b"blob"}


def restart_across_the_knob(pkg: str, tmp_path, first: bool) -> dict:
    """A durable head writes its KV with one engine (``first``: the
    native one when True), through a snapshot and then a WAL record, and
    restarts with the other: both come back."""
    gcs_server = _mod(pkg, "gcs_server")
    config = _mod(pkg, "config").GLOBAL_CONFIG
    log_dir = tmp_path / f"{pkg}-{first}"
    log_dir.mkdir()
    snap = str(log_dir / "snap.pkl")
    engines = []
    try:
        config.update({"gcs_kv_native": first})
        server = gcs_server.GcsServer(host="127.0.0.1", port=0,
                                      log_dir=str(log_dir), persist_path=snap)
        engines.append(type(server.gcs.kv).__name__)
        server.start()
        try:
            server._kv_put(b"snap/key", b"in the snapshot", "ns")
            server._save_snapshot()
            server._kv_put(b"wal/key", b"in the WAL", "ns")
            server._kv_put(b"gone", b"x", "ns")
            server._kv_del(b"gone", "ns")
        finally:
            server.stop()
        config.update({"gcs_kv_native": not first})
        server2 = gcs_server.GcsServer(host="127.0.0.1", port=0,
                                       log_dir=str(log_dir),
                                       persist_path=snap)
        try:
            engines.append(type(server2.gcs.kv).__name__)
            kv = server2.gcs.kv
            return {"engines": engines,
                    "snap": kv.get(b"snap/key", namespace="ns"),
                    "wal": kv.get(b"wal/key", namespace="ns"),
                    "deleted": kv.exists(b"gone", namespace="ns"),
                    "keys": sorted(kv.keys(namespace="ns"))}
        finally:
            server2.stop()
    finally:
        config.reset()


@pytest.mark.parametrize("first", [True, False],
                         ids=["native_to_python", "python_to_native"])
def test_head_restarts_across_the_kv_engine_knob(tmp_path, first):
    engines = ["NativeKVStore", "KVStore"]
    assert _both(lambda pkg: restart_across_the_knob(
        pkg, tmp_path, first)) == {
        "engines": engines if first else engines[::-1],
        "snap": b"in the snapshot", "wal": b"in the WAL", "deleted": False,
        "keys": [b"snap/key", b"wal/key"]}


# ------------------------------------------- the reference's racy build


@pytest.mark.parametrize("shape", ["cached_failure", "half_written_file"])
def test_reference_loader_retries_after_a_concurrent_writer(
        shape, tmp_path, monkeypatch):
    """``load_reference_native`` gets the library where a plain load
    caches a failure: a process that found the file before its writer
    finished (here, the cached failure itself; and a copy of the
    library that another thread is still writing) waits for the writer,
    clears the failure and loads."""
    import threading

    native = importlib.import_module("ray_tpu._native")
    real = load_reference_native()
    assert real is not None
    loads = []
    plain_load = native.load

    def counted_load():
        lib = plain_load()
        loads.append(lib is not None)
        return lib

    monkeypatch.setattr(native, "load", counted_load)
    monkeypatch.setattr(native, "_lib", False)
    writer = None
    if shape == "half_written_file":
        copy = tmp_path / "libray_tpu_native.so"
        with open(native._LIB, "rb") as f:
            blob = f.read()
        copy.write_bytes(blob[:32])
        monkeypatch.setattr(native, "_LIB", str(copy))
        monkeypatch.setattr(native, "_lib", None)

        def finish():
            time.sleep(0.7)
            with open(copy, "ab") as f:
                f.write(blob[32:])

        writer = threading.Thread(target=finish)
        writer.start()
    try:
        lib = load_reference_native(native, deadline_s=30.0)
    finally:
        if writer is not None:
            writer.join()
    assert loads[0] is False and loads[-1] is True, loads
    assert lib is not None and hasattr(lib, "gcs_kv_create")
    assert lib._name == native._LIB
