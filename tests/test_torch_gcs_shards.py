"""The port's sharded head (``ray_tpu_torch/_private/gcs_shard.py`` and
the shard plane of ``gcs_server.py`` and ``gcs.py``) against the JAX
package's.

Each of the 23 cases of tests/test_gcs_shards.py runs once through
``ray_tpu`` and once through ``ray_tpu_torch`` and returns a plain record
(routes, stats rows, epochs as differences, error types, flight-ring
kinds, files on disk); the records must be equal, and equal to what the
reference case asserts. The crash shape is the reference's (the
transport and the monitor stop, no last snapshot); the port's
``GcsServer.crash()`` also closes the WAL files, which changes nothing
on disk. The shard gate (``gcs_shard.init_from_config``) is a latched
module global in each package: every case leaves both disarmed.

The port's head records task events one at a time and keeps no
task-event groups or late stage stamps (no submit path of the port uses
them), so :600 is held over the calls it has; with ``gcs_shards=1`` its
one stats and task-event domain is held against the reference's
single-lock tables.
"""

from __future__ import annotations

import glob
import importlib
import os
import pickle
import time

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
STALL_ENV = {"ray_tpu": "RAY_TPU_SHARD_STALL_S",
             "ray_tpu_torch": "RAY_TPU_TORCH_SHARD_STALL_S"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}._private.{name}")


def _config(pkg: str):
    return _mod(pkg, "config").GLOBAL_CONFIG


def _reset(pkg: str) -> None:
    _mod(pkg, "chaos").disable()
    _config(pkg).reset()
    _mod(pkg, "gcs_shard").init_from_config()


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PACKAGES:
        _reset(pkg)
        # A recorder without a flusher, its ring cleared, so the shard
        # events of each case can be read.
        _mod(pkg, "flight_recorder").install("test")._ring.clear()
    yield
    for pkg in PACKAGES:
        _reset(pkg)


def _both(scenario, tmp_path) -> dict:
    records = {}
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
        try:
            records[pkg] = scenario(pkg, tmp_path / pkg)
        finally:
            _reset(pkg)
            _mod(pkg, "flight_recorder").get()._ring.clear()
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _arm(pkg: str, n: int = 4, queue_cap: int | None = None) -> None:
    overrides: dict = {"gcs_shards": n}
    if queue_cap is not None:
        overrides["gcs_shard_max_queued_writes"] = queue_cap
    _config(pkg).update(overrides)
    _mod(pkg, "gcs_shard").init_from_config()


def _crash(server) -> None:
    server._shutdown.set()
    server._server.stop()


def _head(pkg: str, tmp_path):
    return _mod(pkg, "gcs_server").GcsServer(
        host="127.0.0.1", port=0, log_dir=str(tmp_path / "log"),
        persist_path=str(tmp_path / "gcs_snapshot.pkl"))


def _objs_for_shard(pkg: str, target: int, n: int, count: int) -> list:
    out, i = [], 0
    shard_of = _mod(pkg, "gcs_shard").shard_of
    while len(out) < count:
        key = f"{i:040x}"
        if shard_of(key, n) == target:
            out.append(key)
        i += 1
    return out


def _ring_kinds(pkg: str) -> set:
    rec = _mod(pkg, "flight_recorder").get()
    return set() if rec is None else {kind for _, kind, _ in rec._ring}


def _error(fn) -> "str | None":
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        return type(exc).__name__
    return None


# ------------------------------------------------------------------ router


def router_stable(pkg, tmp_path):
    gs = _mod(pkg, "gcs_shard")
    return {"routes": [gs.shard_of("aa" * 10, 4), gs.shard_of("bb" * 10, 4),
                       gs.shard_of("0123456789abcdef0123", 4),
                       gs.shard_of("node-hex-1", 4), gs.shard_of("aa" * 10, 2),
                       gs.shard_of("anything", 1)],
            "cover": sorted({gs.shard_of(f"{i:040x}", 4)
                             for i in range(64)})}


def test_router_stable_across_processes_and_restarts(tmp_path):
    """tests/test_gcs_shards.py:108."""
    assert _both(router_stable, tmp_path) == {
        "routes": [2, 0, 2, 3, 0, 0], "cover": [0, 1, 2, 3]}


def init_latches_gate(pkg, tmp_path):
    gs = _mod(pkg, "gcs_shard")
    out = [(gs.shard_count(), gs.SHARDS_ON)]
    _arm(pkg, 4)
    out.append((gs.shard_count(), gs.SHARDS_ON))
    _config(pkg).reset()
    gs.init_from_config()
    out.append((gs.shard_count(), gs.SHARDS_ON))
    return {"gate": out}


def test_init_from_config_latches_gate(tmp_path):
    """tests/test_gcs_shards.py:127."""
    assert _both(init_latches_gate, tmp_path) == {
        "gate": [(1, False), (4, True), (1, False)]}


# ------------------------------------------------- disarmed byte-identity


def disarmed_layout(pkg, tmp_path):
    gp = _mod(pkg, "gcs_persistence")
    server = _head(pkg, tmp_path)
    record = {"shards": server._shards, "stats": server.shard_stats(),
              "kill": server._kill_shard()}
    server._object_locations_update("owner-1", [("aa" * 10, ["n1"])], [],
                                    epoch=server.epoch)
    server._kv_put(b"k", b"v")
    server._persist_tick(force=True)
    _crash(server)
    base = str(tmp_path / "gcs_snapshot.pkl")
    state = pickle.loads(gp.read_snapshot(base))
    record.update(segments=glob.glob(base + ".shard*"),
                  stamp="gcs_shards" in state,
                  directory=bool(state["directory"]["locations"]),
                  files=sorted(os.listdir(tmp_path)))
    restarted = _head(pkg, tmp_path)
    try:
        record["restored"] = restarted._list_object_locations()["aa" * 10]
    finally:
        _crash(restarted)
    return record


def test_disarmed_layout_byte_identical_to_single_wal(tmp_path):
    """tests/test_gcs_shards.py:138. The files of the persist directory
    are named alike in both packages (the single snapshot, its WAL and
    the epoch file: no shard segment)."""
    record = _both(disarmed_layout, tmp_path)
    assert record["shards"] is None and record["stats"] == []
    assert record["kill"] == -1 and record["segments"] == []
    assert not record["stamp"] and record["directory"]
    assert record["restored"] == ["n1"]


def disarmed_bytes(pkg, tmp_path):
    gp = _mod(pkg, "gcs_persistence")
    server = _head(pkg, tmp_path)
    server._object_locations_update("owner-1", [("aa" * 10, ["n1"])], [],
                                    epoch=server.epoch)
    server._kv_put(b"k", b"v")
    server._persist_tick(force=True)
    server._kv_put(b"k2", b"v2")
    server._object_locations_update("owner-1", [], ["aa" * 10],
                                    epoch=server.epoch)
    _crash(server)
    base = tmp_path / "gcs_snapshot.pkl"
    wals = {}
    for suffix in (".wal.prev", ".wal"):
        with open(f"{base}{suffix}", "rb") as f:
            wals[suffix] = f.read()
    state = pickle.loads(gp.read_snapshot(str(base)))
    return {"files": sorted(os.listdir(tmp_path)), "wals": wals,
            "snapshot_keys": sorted(state)}


def test_disarmed_layout_bytes_match_the_reference(tmp_path):
    """With ``gcs_shards=1`` the port's head writes the unsharded layout
    byte for byte: the same operations give the same files, and WAL
    files equal to the byte to the JAX package's (whose frames the port
    shares), with the same snapshot keys (the snapshot's bytes carry
    the epoch and lease clocks, so its keys are compared)."""
    record = _both(disarmed_bytes, tmp_path)
    assert record["files"] == ["gcs_epoch", "gcs_snapshot.pkl",
                               "gcs_snapshot.pkl.wal",
                               "gcs_snapshot.pkl.wal.prev", "log"]
    assert record["wals"][".wal"] and record["wals"][".wal.prev"]
    assert "gcs_shards" not in record["snapshot_keys"]


def disarmed_legacy(pkg, tmp_path):
    with open(tmp_path / "gcs_snapshot.pkl", "wb") as f:
        pickle.dump({"kv": {"default": {b"legacy": b"1"}}, "jobs": []}, f)
    server = _head(pkg, tmp_path)
    try:
        return {"legacy": server.gcs.kv.get(b"legacy"),
                "shards": server._shards}
    finally:
        _crash(server)


def test_disarmed_legacy_raw_pickle_snapshot_still_loads(tmp_path):
    """tests/test_gcs_shards.py:166."""
    assert _both(disarmed_legacy, tmp_path) == {"legacy": b"1",
                                                "shards": None}


# ------------------------------------------------------- sharded layout


def sharded_boot(pkg, tmp_path):
    gp = _mod(pkg, "gcs_persistence")
    gs = _mod(pkg, "gcs_shard")
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    try:
        keys = [f"{i:040x}" for i in range(16)]
        server._object_locations_update("owner-1", [(k, ["n1"]) for k in keys],
                                        [], epoch=server.epoch)
        routed = all(gs.shard_of(key, 4) == shard.index
                     for shard in server._shards
                     for key in shard.directory.locations())
        base = str(tmp_path / "gcs_snapshot.pkl")
        wals = [os.path.exists(f"{base}.shard{i}.wal") for i in range(4)]
        server._persist_tick(force=True)
        segs = []
        for i in range(4):
            state = pickle.loads(gp.read_snapshot(f"{base}.shard{i}"))
            segs.append((state["gcs_shards"], state["shard"]))
        main = pickle.loads(gp.read_snapshot(base))
        return {"n": len(server._shards), "routed": routed,
                "merged": set(server._list_object_locations()) == set(keys),
                "wals": wals, "segs": segs, "stamp": main["gcs_shards"],
                "main_dir": bool(main["directory"].get("locations"))}
    finally:
        _crash(server)


def test_sharded_boot_segments_and_routing(tmp_path):
    """tests/test_gcs_shards.py:183."""
    assert _both(sharded_boot, tmp_path) == {
        "n": 4, "routed": True, "merged": True, "wals": [True] * 4,
        "segs": [(4, i) for i in range(4)], "stamp": 4, "main_dir": False}


def sharded_full_restart(pkg, tmp_path):
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    keys = [f"{i:040x}" for i in range(12)]
    server._object_locations_update(
        "owner-1", [(k, ["n1", "n2"]) for k in keys], [], epoch=server.epoch)
    first = server.epoch
    _crash(server)
    restarted = _head(pkg, tmp_path)
    try:
        return {"bumped": restarted.epoch - first,
                "keys": set(restarted._list_object_locations()) == set(keys),
                "replayed": sum(r["wal_records_replayed"]
                                for r in restarted.shard_stats()) > 0}
    finally:
        _crash(restarted)


def test_sharded_full_restart_recovers_all_shards(tmp_path):
    """tests/test_gcs_shards.py:215. Head base and every shard mint
    their next epoch: the advertised epoch moves by 5."""
    assert _both(sharded_full_restart, tmp_path) == {
        "bumped": 5, "keys": True, "replayed": True}


# --------------------------------------------------------- shard failover


def shard_kill_independent(pkg, tmp_path):
    gs = _mod(pkg, "gcs_shard")
    stale = _mod(pkg, "gcs").StaleEpochError
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    try:
        keys = [f"{i:040x}" for i in range(20)]
        server._object_locations_update("owner-1", [(k, ["n1"]) for k in keys],
                                        [], epoch=server.epoch)
        victim = 2
        owned = [k for k in keys if gs.shard_of(k, 4) == victim]
        before = server.epoch
        replayed = server._kill_shard(victim)
        rows = {r["shard"]: r for r in server.shard_stats()}
        record = {"owned": bool(owned), "replayed": replayed >= 1,
                  "bump": server.epoch - before,
                  "restores": [rows[i]["restores"] for i in range(4)],
                  "restore_event": "gcs.shard_restore" in _ring_kinds(pkg),
                  "kept": set(server._list_object_locations()) == set(keys)}
        try:
            server._object_locations_update(
                "owner-1", [(owned[0], ["n9"])], [], epoch=before)
            record["fenced"] = None
        except stale as exc:
            record["fenced"] = type(exc).__name__
        record["fenced_row"] = server.shard_stats()[victim]["fenced_writes"]
        record["fence_event"] = "gcs.shard_fenced_write" in _ring_kinds(pkg)
        server._object_locations_update(
            "owner-1", [(owned[0], ["n9"])], [], epoch=server.epoch)
        record["landed"] = "n9" in server._list_object_locations()[owned[0]]
        return record
    finally:
        _crash(server)


def test_shard_kill_failover_is_independent(tmp_path):
    """tests/test_gcs_shards.py:237."""
    assert _both(shard_kill_independent, tmp_path) == {
        "owned": True, "replayed": True, "bump": 1,
        "restores": [0, 0, 1, 0], "restore_event": True, "kept": True,
        "fenced": "StaleEpochError", "fenced_row": 1, "fence_event": True,
        "landed": True}


def shard_kill_volatile(pkg, tmp_path):
    gs = _mod(pkg, "gcs_shard")
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    try:
        nodes = {}
        for i in range(16):
            hexid = f"{i:032x}"
            server.gcs.record_node_stats(hexid, {"cpu": i})
            nodes[hexid] = gs.shard_of(hexid, 4)
        server._kill_shard(1)
        stats = server.gcs.node_stats()
        return {"victim_used": 1 in nodes.values(),
                "kept": all((h in stats) == (s != 1)
                            for h, s in nodes.items())}
    finally:
        _crash(server)


def test_shard_kill_drops_volatile_slices_only(tmp_path):
    """tests/test_gcs_shards.py:282."""
    assert _both(shard_kill_volatile, tmp_path) == {"victim_used": True,
                                                    "kept": True}


# ------------------------------------------------------- reshard refusal


def _reshard_error(pkg, tmp_path):
    gp = _mod(pkg, "gcs_persistence")
    try:
        _crash(_head(pkg, tmp_path))
    except gp.ReshardError as exc:
        return (exc.recorded, exc.configured, "refused" in str(exc))
    return None


def reshard_snapshot(pkg, tmp_path):
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    server._object_locations_update("owner-1", [("aa" * 10, ["n1"])], [],
                                    epoch=server.epoch)
    server._persist_tick(force=True)
    _crash(server)
    _arm(pkg, 2)
    refused = _reshard_error(pkg, tmp_path)
    _arm(pkg, 4)
    restarted = _head(pkg, tmp_path)
    try:
        return {"refused": refused,
                "kept": restarted._list_object_locations()["aa" * 10]}
    finally:
        _crash(restarted)


def test_reshard_refused_snapshot_layout(tmp_path):
    """tests/test_gcs_shards.py:309."""
    assert _both(reshard_snapshot, tmp_path) == {
        "refused": (4, 2, True), "kept": ["n1"]}


def reshard_wal_only(pkg, tmp_path):
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    server._object_locations_update("owner-1", [("aa" * 10, ["n1"])], [],
                                    epoch=server.epoch)
    _crash(server)
    out = []
    for configured in (2, 8):
        _arm(pkg, configured)
        out.append(_reshard_error(pkg, tmp_path))
    return {"refused": out}


def test_reshard_refused_wal_only_layout(tmp_path):
    """tests/test_gcs_shards.py:335."""
    assert _both(reshard_wal_only, tmp_path) == {
        "refused": [(4, 2, True), (4, 8, True)]}


def reshard_disarming(pkg, tmp_path):
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    server._object_locations_update("owner-1", [("aa" * 10, ["n1"])], [],
                                    epoch=server.epoch)
    _crash(server)
    _config(pkg).reset()
    _mod(pkg, "gcs_shard").init_from_config()
    refused = _reshard_error(pkg, tmp_path)
    return {"configured": refused[1]}


def test_reshard_refused_disarming_over_sharded_layout(tmp_path):
    """tests/test_gcs_shards.py:352."""
    assert _both(reshard_disarming, tmp_path) == {"configured": 1}


def reshard_arming(pkg, tmp_path):
    server = _head(pkg, tmp_path)
    server._object_locations_update("owner-1", [("aa" * 10, ["n1"])], [],
                                    epoch=server.epoch)
    _crash(server)
    _arm(pkg, 4)
    return {"refused": _reshard_error(pkg, tmp_path)}


def test_reshard_refused_arming_over_single_wal_layout(tmp_path):
    """tests/test_gcs_shards.py:367."""
    assert _both(reshard_arming, tmp_path) == {"refused": (1, 4, True)}


# -------------------------------------------------------- degraded mode


def stall_queues(pkg, tmp_path):
    overloaded = importlib.import_module(f"{pkg}.exceptions") \
        .SystemOverloadedError
    _arm(pkg, 4, queue_cap=3)
    server = _head(pkg, tmp_path)
    try:
        victim = server._shards[0]
        k_live, *queued, k_shed = _objs_for_shard(pkg, 0, 4, 5)
        server._object_locations_update("owner-1", [(k_live, ["n1"])], [],
                                        epoch=server.epoch)
        victim.stall(30.0)
        for key in queued:
            server._object_locations_update("owner-1", [(key, ["n2"])], [],
                                            epoch=server.epoch)
        view = server._list_object_locations()
        row = server.shard_stats()[0]
        record = {"live": view[k_live],
                  "hidden": [key in view for key in queued],
                  "queued": row["queued_writes"], "aged": row["age_s"] > 0.0,
                  "backoff": "gcs.shard_backoff" in _ring_kinds(pkg)}
        try:
            server._object_locations_update("owner-1", [(k_shed, ["n3"])],
                                            [], epoch=server.epoch)
            record["shed"] = None
        except overloaded as exc:
            record["shed"] = exc.retry_after_s > 0
        record["shed_row"] = server.shard_stats()[0]["shed_writes"]
        k_other = _objs_for_shard(pkg, 1, 4, 1)[0]
        server._object_locations_update("owner-1", [(k_other, ["n1"])], [],
                                        epoch=server.epoch)
        record["other"] = server._list_object_locations()[k_other]
        victim.stalled_until = time.monotonic() - 0.01
        victim.heal_tick()
        view = server._list_object_locations()
        row = server.shard_stats()[0]
        record.update(healed=[view.get(key) for key in queued],
                      shed_absent=k_shed not in view,
                      after=(row["queued_writes"], row["age_s"]))
        return record
    finally:
        _crash(server)


def test_stall_serves_stale_reads_and_queues_writes(tmp_path):
    """tests/test_gcs_shards.py:383."""
    assert _both(stall_queues, tmp_path) == {
        "live": ["n1"], "hidden": [False] * 3, "queued": 3, "aged": True,
        "backoff": True, "shed": True, "shed_row": 1, "other": ["n1"],
        "healed": [["n2"]] * 3, "shed_absent": True, "after": (0, 0.0)}


def queued_durable(pkg, tmp_path):
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    try:
        victim = server._shards[0]
        victim.stall(30.0)
        key = _objs_for_shard(pkg, 0, 4, 1)[0]
        server._object_locations_update("owner-1", [(key, ["n1"])], [],
                                        epoch=server.epoch)
        queued = victim.queue_len()
        server._kill_shard(0)
        return {"queued": queued,
                "kept": server._list_object_locations()[key],
                "replayed": server.shard_stats()[0]["wal_records_replayed"]
                >= 1}
    finally:
        _crash(server)


def test_queued_write_is_wal_durable_across_shard_crash(tmp_path):
    """tests/test_gcs_shards.py:438."""
    assert _both(queued_durable, tmp_path) == {"queued": 1, "kept": ["n1"],
                                               "replayed": True}


def persist_skips_stalled(pkg, tmp_path):
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    try:
        server._object_locations_update(
            "owner-1", [(_objs_for_shard(pkg, 0, 4, 1)[0], ["n1"]),
                        (_objs_for_shard(pkg, 1, 4, 1)[0], ["n1"])], [],
            epoch=server.epoch)
        server._shards[0].stall(30.0)
        server._persist_tick(force=True)
        base = str(tmp_path / "gcs_snapshot.pkl")
        return {"shard0": os.path.exists(f"{base}.shard0"),
                "shard1": os.path.exists(f"{base}.shard1")}
    finally:
        _crash(server)


def test_persist_tick_skips_stalled_shard(tmp_path):
    """tests/test_gcs_shards.py:456."""
    assert _both(persist_skips_stalled, tmp_path) == {"shard0": False,
                                                      "shard1": True}


# ------------------------------------------------------------ chaos sites


def chaos_shard_die(pkg, tmp_path):
    chaos = _mod(pkg, "chaos")
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    try:
        key = _objs_for_shard(pkg, 0, 4, 1)[0]
        epoch = server.epoch
        chaos.configure("seed=5,gcs.shard_die=1.0x1")
        fenced = _error(lambda: server._object_locations_update(
            "owner-1", [(key, ["n1"])], [], epoch=epoch))
        chaos.disable()
        record = {"fenced": fenced, "bump": server.epoch - epoch,
                  "restored": any(r["restores"] == 1
                                  for r in server.shard_stats()),
                  "chaos_event": "chaos" in _ring_kinds(pkg)}
        server._object_locations_update("owner-1", [(key, ["n1"])], [],
                                        epoch=server.epoch)
        record["landed"] = server._list_object_locations()[key]
        return record
    finally:
        _crash(server)


def test_chaos_shard_die_mid_mutation_fences_typed(tmp_path):
    """tests/test_gcs_shards.py:476, with the reference's seed. Beyond
    it: the fire is in the flight ring of both packages."""
    assert _both(chaos_shard_die, tmp_path) == {
        "fenced": "StaleEpochError", "bump": 1, "restored": True,
        "chaos_event": True, "landed": ["n1"]}


def chaos_shard_stall(pkg, tmp_path):
    chaos = _mod(pkg, "chaos")
    os.environ[STALL_ENV[pkg]] = "0.2"
    try:
        _arm(pkg, 4)
        server = _head(pkg, tmp_path)
        try:
            key = _objs_for_shard(pkg, 0, 4, 1)[0]
            chaos.configure("seed=7,gcs.shard_stall=1.0x1")
            server._object_locations_update("owner-1", [(key, ["n1"])], [],
                                            epoch=server.epoch)
            chaos.disable()
            victim = server._shards[0]
            acked = victim.stall_active() or victim.queue_len() == 0
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                victim.heal_tick()
                if server._list_object_locations().get(key) == ["n1"]:
                    break
                time.sleep(0.05)
            return {"acked": acked,
                    "landed": server._list_object_locations()[key]}
        finally:
            _crash(server)
    finally:
        os.environ.pop(STALL_ENV[pkg], None)


def test_chaos_shard_stall_opens_degraded_window(tmp_path):
    """tests/test_gcs_shards.py:501, with the reference's seed."""
    assert _both(chaos_shard_stall, tmp_path) == {"acked": True,
                                                  "landed": ["n1"]}


# --------------------------------------- heartbeat plane + sharded tables


def heartbeat_spill_routes(pkg, tmp_path):
    gs = _mod(pkg, "gcs_shard")
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    server.start()
    client = _mod(pkg, "rpc").MuxRpcClient(server.address)
    try:
        node_id = client.call("register_node", "10.0.0.1:42", {"CPU": 4.0},
                              {}, "", host_id="hostA")
        objs = [f"{i:040x}" for i in range(8)]
        client.call("object_locations_update", "owner-1",
                    [(o, ["n1"]) for o in objs], [], epoch=server.epoch)
        accepted = client.call(
            "heartbeat", node_id, None,
            {"spill_events": [("owner-1", o, "spilled") for o in objs]},
            None, epoch=server.epoch)
        _locs, spilled = server._list_object_locations(None,
                                                       include_spilled=True)
        return {"accepted": accepted,
                "marked": all(spilled[o] == node_id.hex() for o in objs),
                "routed": all(gs.shard_of(o, 4) == shard.index
                              for shard in server._shards
                              for o in shard.directory.spilled())}
    finally:
        client.close()
        _crash(server)


def test_heartbeat_spill_events_route_per_shard(tmp_path):
    """tests/test_gcs_shards.py:529."""
    assert _both(heartbeat_spill_routes, tmp_path) == {
        "accepted": True, "marked": True, "routed": True}


def heartbeat_absorbs(pkg, tmp_path):
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    server.start()
    client = _mod(pkg, "rpc").MuxRpcClient(server.address)
    try:
        node_id = client.call("register_node", "10.0.0.1:42", {"CPU": 4.0},
                              {}, "", host_id="hostA")
        victim = server._shards[0]
        victim.stall(30.0)
        victim.queue_cap = 0
        key = _objs_for_shard(pkg, 0, 4, 1)[0]
        accepted = client.call(
            "heartbeat", node_id, None,
            {"spill_events": [("owner-1", key, "spilled")]}, None,
            epoch=server.epoch)
        return {"accepted": accepted,
                "shed": server.shard_stats()[0]["shed_writes"] >= 1}
    finally:
        client.close()
        _crash(server)


def test_heartbeat_absorbs_degraded_shard_overload(tmp_path):
    """tests/test_gcs_shards.py:556."""
    assert _both(heartbeat_absorbs, tmp_path) == {"accepted": True,
                                                  "shed": True}


def node_stats_merge(pkg, tmp_path):
    _arm(pkg, 4)
    gcs = _mod(pkg, "gcs").GlobalControlService()
    snap = {"counts": [1, 2], "sum": 3.0, "count": 3}
    for i in range(8):
        gcs.record_node_stats(f"{i:032x}",
                              {"cpu": i, "stage_hist": {"exec": snap}})
    stats = gcs.node_stats()
    merged = gcs.cluster_stage_latency()
    record = {"sharded": gcs._stats_shards is not None, "n": len(stats),
              "ages": all(row["age_s"] >= 0.0 for row in stats.values()),
              "exec": (merged["exec"]["count"], merged["exec"]["sum"])}
    gcs.drop_node_stats(f"{0:032x}")
    record["after_drop"] = len(gcs.node_stats())
    return record


def test_sharded_node_stats_merge_and_stage_latency(tmp_path):
    """tests/test_gcs_shards.py:581."""
    assert _both(node_stats_merge, tmp_path) == {
        "sharded": True, "n": 8, "ages": True, "exec": (24, 24.0),
        "after_drop": 7}


def task_events_route(pkg, tmp_path):
    gcs_mod = _mod(pkg, "gcs")
    task_id = _mod(pkg, "ids").TaskID
    _arm(pkg, 4)
    gcs = gcs_mod.GlobalControlService()
    ids = [task_id(bytes([i]) * 16) for i in range(12)]
    for i, t in enumerate(ids):
        gcs.record_task_event(gcs_mod.TaskEvent(t, f"f{i}", "RUNNING"))
    gcs.record_task_event(gcs_mod.TaskEvent(ids[0], "f0", "FINISHED"))
    events = gcs.list_task_events()
    record = {"shards": len(gcs._task_shards),
              "homes": all(t in gcs._task_domain(t).events for t in ids),
              "states": sorted(e.state for e in events), "n": len(events)}
    fresh = task_id(bytes([200]) * 16)
    gcs._task_domain(fresh).limit = 0
    gcs.record_task_event(gcs_mod.TaskEvent(fresh, "late", "FINISHED"))
    record["dropped"] = gcs.task_events_dropped
    record["late"] = any(e.task_id == fresh for e in gcs.list_task_events())
    return record


def test_sharded_task_events_route_and_merge(tmp_path):
    """tests/test_gcs_shards.py:600, over the task-event calls the port
    has: its head records one event at a time and keeps no task-event
    groups or late stage stamps (no submit path of the port uses them)."""
    assert _both(task_events_route, tmp_path) == {
        "shards": 4, "homes": True, "states": ["FINISHED"] + ["RUNNING"] * 11,
        "n": 12, "dropped": 1, "late": False}


def unsharded_tables(pkg, tmp_path):
    gcs_mod = _mod(pkg, "gcs")
    task_id = _mod(pkg, "ids").TaskID
    _arm(pkg, 1)
    gcs = gcs_mod.GlobalControlService()
    # The cap: the reference's single-lock table's, the port's one
    # task-event domain's.
    if pkg == "ray_tpu":
        gcs._task_event_limit = 3
    else:
        gcs._task_shards[0].limit = 3
    ids = [task_id(bytes([i]) * 16) for i in range(5)]
    for i, t in enumerate(ids):
        gcs.record_task_event(gcs_mod.TaskEvent(t, f"f{i}", "PENDING"))
    gcs.record_task_event(gcs_mod.TaskEvent(ids[1], "f1", "FINISHED"))
    for i in range(3):
        gcs.record_node_stats(f"{i:032x}", {"cpu": i})
    gcs.drop_node_stats(f"{1:032x}")
    return {"events": [(e.name, e.state) for e in gcs.list_task_events()],
            "dropped": gcs.task_events_dropped,
            "stats": sorted((k, v["cpu"]) for k, v in gcs.node_stats().items())}


def test_unsharded_head_keeps_one_domain_with_the_whole_cap(tmp_path):
    """With gcs_shards=1 the port's one stats and task-event domain keeps
    the reference's single-lock tables' cap, order and drop count."""
    assert _both(unsharded_tables, tmp_path) == {
        "events": [("f0", "PENDING"), ("f1", "FINISHED"), ("f2", "PENDING")],
        "dropped": 2,
        "stats": [(f"{0:032x}", 0), (f"{2:032x}", 2)]}


# ------------------------------------------------------------- RPC plane


def overload_hint(pkg, tmp_path):
    rpc = _mod(pkg, "rpc")
    overloaded = importlib.import_module(f"{pkg}.exceptions") \
        .SystemOverloadedError
    shed = rpc.RpcMethodError(
        overloaded("gcs shard 0 degraded", retry_after_s=0.4), "tb")
    long = rpc.RpcMethodError(overloaded("x", retry_after_s=60.0), "tb")
    return {"hints": [rpc.overload_retry_after(shed),
                      rpc.overload_retry_after(long),
                      rpc.overload_retry_after(
                          rpc.RpcMethodError(ValueError("x"), "tb")),
                      rpc.overload_retry_after(ValueError("x"))]}


def test_overload_retry_after_extracts_typed_hint(tmp_path):
    """tests/test_gcs_shards.py:632."""
    assert _both(overload_hint, tmp_path) == {"hints": [0.4, 2.0, None,
                                                        None]}


def stats_rpc_and_kill(pkg, tmp_path):
    gs = _mod(pkg, "gcs_shard")
    _arm(pkg, 4)
    server = _head(pkg, tmp_path)
    server.start()
    client = _mod(pkg, "rpc").MuxRpcClient(server.address)
    try:
        rows = client.call("gcs_shard_stats")
        record = {"shards": [r["shard"] for r in rows],
                  "keys": all(key in row for row in rows
                              for key in gs.GCS_SHARD_STAT_KEYS),
                  "kill": client.call("gcs_kill_shard", 3) >= 0,
                  "restores": client.call("gcs_shard_stats")[3]["restores"]}
        return record
    finally:
        client.close()
        _crash(server)


def test_shard_stats_rpc_and_kill_seam(tmp_path):
    """tests/test_gcs_shards.py:646."""
    assert _both(stats_rpc_and_kill, tmp_path) == {
        "shards": [0, 1, 2, 3], "keys": True, "kill": True, "restores": 1}


def test_shard_stat_keys_match_the_reference():
    assert _mod("ray_tpu_torch", "gcs_shard").GCS_SHARD_STAT_KEYS == \
        _mod("ray_tpu", "gcs_shard").GCS_SHARD_STAT_KEYS
