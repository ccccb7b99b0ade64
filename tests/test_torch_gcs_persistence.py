"""The port's durable, fenced head against the JAX package's.

Each case of tests/test_gcs_persistence.py runs once through ``ray_tpu``
and once through ``ray_tpu_torch`` (the frame helpers, the chaos sites
with the reference tests' own seeds, the head's snapshot, WAL, restore,
epoch fence and reply meta, the node agent's re-sync and the driver's
mirrors) and returns a plain record; the records must be equal, and
equal to what the reference case asserts. Node ids, epochs and counts go
into the records as relations (equal, greater) or as the values both
packages must reach. A last case has each package read the other's
``RGS1`` and ``RGW1`` files.

The crash shape is the reference's: the transport and the monitor stop,
with no last snapshot (``_crash``; the port's ``GcsServer.crash()``).
"""

from __future__ import annotations

import os
import pickle
import struct
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import chaos as jax_chaos
from ray_tpu._private import gcs_persistence as jax_gp
from ray_tpu._private.config import GLOBAL_CONFIG as JAX_CONFIG
from ray_tpu._private.gcs import StaleEpochError as JaxStale
from ray_tpu._private.gcs_server import GcsServer as JaxGcsServer
from ray_tpu._private.ids import NodeID as JaxNodeID
from ray_tpu._private.node import NodeAgent as JaxNodeAgent
from ray_tpu._private.rpc import MuxRpcClient as JaxMux
from ray_tpu._private.rpc import RpcMethodError as JaxMethodError
from ray_tpu.cluster_utils import Cluster as JaxCluster
from ray_tpu_torch._private import chaos as torch_chaos
from ray_tpu_torch._private import gcs_persistence as torch_gp
from ray_tpu_torch._private.config import GLOBAL_CONFIG as TORCH_CONFIG
from ray_tpu_torch._private.gcs import StaleEpochError as TorchStale
from ray_tpu_torch._private.gcs_server import GcsServer as TorchGcsServer
from ray_tpu_torch._private.ids import NodeID as TorchNodeID
from ray_tpu_torch._private.node import NodeAgent as TorchNodeAgent
from ray_tpu_torch._private.rpc import MuxRpcClient as TorchMux
from ray_tpu_torch._private.rpc import RpcMethodError as TorchMethodError
from ray_tpu_torch.cluster_utils import Cluster as TorchCluster
from torch_time_limit import time_limit


def _jax_crash(server) -> None:
    server._shutdown.set()
    server._server.stop()


PACKAGES = {
    "ray_tpu": {"gp": jax_gp, "chaos": jax_chaos, "config": JAX_CONFIG,
                "server": JaxGcsServer, "stale": JaxStale, "mux": JaxMux,
                "method_error": JaxMethodError, "crash": _jax_crash,
                "agent": JaxNodeAgent, "node_id": JaxNodeID,
                "cluster": JaxCluster, "pkg": ray_tpu},
    "ray_tpu_torch": {"gp": torch_gp, "chaos": torch_chaos,
                      "config": TORCH_CONFIG, "server": TorchGcsServer,
                      "stale": TorchStale, "mux": TorchMux,
                      "method_error": TorchMethodError,
                      "crash": lambda server: server.crash(),
                      "agent": TorchNodeAgent, "node_id": TorchNodeID,
                      "cluster": TorchCluster, "pkg": ray_tpu_torch},
}


@pytest.fixture(autouse=True)
def _clean():
    for p in PACKAGES.values():
        p["chaos"].disable()
    yield
    for p in PACKAGES.values():
        p["chaos"].disable()
        p["config"].reset()


def _both(scenario, tmp_path) -> dict:
    records = {}
    for name, p in PACKAGES.items():
        (tmp_path / name).mkdir()
        records[name] = scenario(p, tmp_path / name)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _head(p, tmp_path, port: int = 0):
    deadline = time.monotonic() + 15
    while True:
        try:
            return p["server"](
                host="127.0.0.1", port=port,
                log_dir=str(tmp_path / "log"),
                persist_path=str(tmp_path / "gcs_snapshot.pkl"))
        except OSError:
            # A same-port restart: the crashed incarnation's sockets may
            # hold the port a moment.
            if port == 0 or time.monotonic() >= deadline:
                raise
            time.sleep(0.2)


def _error(fn) -> "str | None":
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        return type(exc).__name__
    return None


# ------------------------------------------------------------- file framing


def snapshot_round_trip_and_prev_rotation(p, tmp_path):
    gp = p["gp"]
    path = str(tmp_path / "snap")
    gp.write_snapshot(path, b"generation-1")
    first = gp.read_snapshot(path)
    gp.write_snapshot(path, b"generation-2")
    return [first, gp.read_snapshot(path), gp.read_snapshot(path + ".prev")]


def test_snapshot_round_trip_and_prev_rotation(tmp_path):
    assert _both(snapshot_round_trip_and_prev_rotation, tmp_path) == [
        b"generation-1", b"generation-2", b"generation-1"]


def torn_snapshot_rejected_never_served(p, tmp_path):
    gp = p["gp"]
    path = str(tmp_path / "snap")
    gp.write_snapshot(path, b"x" * 4096)
    with open(path, "r+b") as f:
        f.truncate(16 + 1000)
    record = [_error(lambda: gp.read_snapshot(path))]
    gp.write_snapshot(path, b"y" * 4096)
    with open(path, "r+b") as f:
        f.seek(16 + 100)
        f.write(b"Z" * 8)
    record.append(_error(lambda: gp.read_snapshot(path)))
    return record


def test_torn_snapshot_rejected_never_served(tmp_path):
    assert _both(torn_snapshot_rejected_never_served, tmp_path) == [
        "TornSnapshotError", "TornSnapshotError"]


def legacy_raw_pickle_detected(p, tmp_path):
    path = str(tmp_path / "snap")
    with open(path, "wb") as f:
        pickle.dump({"kv": {}, "jobs": []}, f)
    return _error(lambda: p["gp"].read_snapshot(path))


def test_legacy_raw_pickle_detected(tmp_path):
    assert _both(legacy_raw_pickle_detected, tmp_path) \
        == "LegacySnapshotError"


def wal_replay_is_seq_gated(p, tmp_path):
    gp = p["gp"]
    path = str(tmp_path / "wal")
    w = gp.WalWriter(path)
    for seq in range(1, 6):
        w.append(seq, pickle.dumps(("op", seq)))
    w.close()
    seen = []
    stats = gp.replay_wal(path, 3, lambda op: seen.append(op[1]))
    return [seen, stats]


def test_wal_replay_is_seq_gated(tmp_path):
    assert _both(wal_replay_is_seq_gated, tmp_path) == [
        [4, 5], {"replayed": 2, "skipped": 3, "truncated": 0,
                 "last_seq": 5}]


def wal_torn_tail_truncated_in_place(p, tmp_path):
    gp = p["gp"]
    path = str(tmp_path / "wal")
    w = gp.WalWriter(path)
    for seq in range(1, 4):
        w.append(seq, pickle.dumps(("op", seq)))
    w.close()
    header = struct.Struct("<4sQQI")
    with open(path, "ab") as f:
        f.write(header.pack(b"RGW1", 4, 1000, 0xDEADBEEF))
        f.write(b"short")
    good_size = os.path.getsize(path) - header.size - 5
    seen = []
    stats = gp.replay_wal(path, 0, lambda op: seen.append(op[1]))
    return [seen, stats["truncated"], os.path.getsize(path) == good_size]


def test_wal_torn_tail_truncated_in_place(tmp_path):
    assert _both(wal_torn_tail_truncated_in_place, tmp_path) == [
        [1, 2, 3], 1, True]


def mint_epoch_monotonic_and_persisted(p, tmp_path):
    gp = p["gp"]
    path = str(tmp_path / "epoch")
    minted = [gp.mint_epoch(path) for _ in range(3)]
    with open(path) as f:
        return [minted, int(f.read())]


def test_mint_epoch_monotonic_and_persisted(tmp_path):
    assert _both(mint_epoch_monotonic_and_persisted, tmp_path) == [
        [1, 2, 3], 3]


# --------------------------------------------------- full-state crash cycle


def full_hot_set_survives_crash_restart(p, tmp_path):
    server = _head(p, tmp_path)
    server.start()
    client = p["mux"](server.address)
    try:
        node_id = client.call("register_node", "10.0.0.1:42",
                              {"CPU": 4.0}, {"rack": "r1"},
                              "10.0.0.1:999")
        dead_id = client.call("register_node", "10.0.0.2:43",
                              {"CPU": 2.0}, {}, "")
        client.call("drain_node", dead_id)
        client.call("kv_put", b"k1", b"v1", "ns")
        client.call("object_locations_update", "owner-1",
                    [("aa" * 10, ["n1", "n2"]), ("bb" * 10, "n1")], [],
                    epoch=server.epoch)
        beat = client.call(
            "heartbeat", node_id, None,
            {"spill_events": [("owner-1", "bb" * 10, "spilled")]},
            None, epoch=server.epoch)
        client.call("actor_update", [{
            "actor_id": b"\x07" * 16, "name": "keeper",
            "namespace": "default", "class_name": "Keeper",
            "state": "RESTARTING", "max_restarts": 5,
            "num_restarts": 2}], epoch=server.epoch)
        client.call("pg_update", "job-1",
                    [{"pg_id": "cc" * 14, "state": "CREATED",
                      "strategy": "STRICT_SPREAD", "bundles": []}],
                    epoch=server.epoch)
    finally:
        client.close()
    first_epoch = server.epoch
    p["crash"](server)

    restarted = _head(p, tmp_path)
    try:
        stats = restarted.persist_stats()
        by_addr = {r.address: r for r in restarted.gcs.list_nodes()}
        actor = restarted.gcs.list_actors()[0]
        locs, spilled = restarted._list_object_locations(
            None, include_spilled=True)
        pgs = restarted._list_cluster_placement_groups()
        return {
            "beat": beat,
            "replayed": stats["wal_records_replayed"] > 0,
            "restore_ms": stats["snapshot_restore_ms"] >= 0,
            "epoch_up": restarted.epoch > first_epoch,
            "kv": restarted.gcs.kv.get(b"k1", "ns"),
            "live": by_addr["10.0.0.1:42"].alive,
            "labels": by_addr["10.0.0.1:42"].labels,
            "dead": by_addr["10.0.0.2:43"].alive,
            "actor": (actor.name, actor.state, actor.num_restarts),
            "locs": locs["aa" * 10],
            "spilled_on_node": spilled.get("bb" * 10) == node_id.hex(),
            "pg": pgs["job-1"][0]["pg_id"],
        }
    finally:
        p["crash"](restarted)


def test_full_hot_set_survives_crash_restart(tmp_path):
    assert _both(full_hot_set_survives_crash_restart, tmp_path) == {
        "beat": True, "replayed": True, "restore_ms": True,
        "epoch_up": True, "kv": b"v1", "live": True,
        "labels": {"rack": "r1"}, "dead": False,
        "actor": ("keeper", "RESTARTING", 2), "locs": ["n1", "n2"],
        "spilled_on_node": True, "pg": "cc" * 14}


def dead_node_id_refused_across_restart(p, tmp_path):
    server = _head(p, tmp_path)
    server.start()
    client = p["mux"](server.address)
    try:
        dead_id = client.call("register_node", "10.9.9.9:1",
                              {"CPU": 1.0}, {}, "")
        client.call("drain_node", dead_id)
    finally:
        client.close()
    p["crash"](server)
    restarted = _head(p, tmp_path)
    restarted.start()
    client = p["mux"](restarted.address)
    try:
        granted = client.call("register_node", "10.9.9.9:1",
                              {"CPU": 1.0}, {}, "", prior_id=dead_id)
        return granted != dead_id
    finally:
        client.close()
        p["crash"](restarted)


def test_dead_node_id_refused_across_restart(tmp_path):
    assert _both(dead_node_id_refused_across_restart, tmp_path) is True


def torn_snapshot_falls_back_to_prev_plus_wal(p, tmp_path):
    server = _head(p, tmp_path)
    server.gcs.kv.put(b"a", b"1")
    server._persist_tick(force=True)  # a good snapshot
    server._kv_put(b"b", b"2")        # into the WAL rotated out next
    p["chaos"].configure("seed=11,gcs.torn_snapshot=1.0x1")
    server._persist_tick(force=True)  # a torn snapshot, and a rotate
    p["chaos"].disable()
    server._kv_put(b"c", b"3")        # into the fresh WAL
    p["crash"](server)

    restarted = _head(p, tmp_path)
    try:
        return [restarted.persist_stats()["torn_snapshots"],
                [restarted.gcs.kv.get(k) for k in (b"a", b"b", b"c")]]
    finally:
        p["crash"](restarted)


def test_torn_snapshot_falls_back_to_prev_plus_wal(tmp_path):
    assert _both(torn_snapshot_falls_back_to_prev_plus_wal, tmp_path) \
        == [1, [b"1", b"2", b"3"]]


def crash_mid_wal_append_truncates_tail_only(p, tmp_path):
    server = _head(p, tmp_path)
    for i in range(8):
        server._kv_put(f"k{i}".encode(), b"v")
    p["chaos"].configure("seed=3,gcs.torn_wal=1.0x1")
    server._kv_put(b"torn-tail", b"v")
    p["chaos"].disable()
    p["crash"](server)

    restarted = _head(p, tmp_path)
    try:
        stats = restarted.persist_stats()
        return [stats["torn_wal_tails"], stats["wal_records_replayed"],
                [restarted.gcs.kv.get(f"k{i}".encode()) for i in range(8)],
                restarted.gcs.kv.get(b"torn-tail")]
    finally:
        p["crash"](restarted)


def test_crash_mid_wal_append_truncates_tail_only(tmp_path):
    assert _both(crash_mid_wal_append_truncates_tail_only, tmp_path) == [
        1, 8, [b"v"] * 8, None]


# ---------------------------------------------------------------- dirty check


def actor_and_directory_mutations_trigger_snapshot(p, tmp_path):
    server = _head(p, tmp_path)
    server._persist_tick(force=True)
    base = server.persist_stats()["snapshots_written"]
    server._persist_tick(force=True)
    counts = [server.persist_stats()["snapshots_written"] - base]
    server._actor_update([{"actor_id": b"\x01" * 16, "name": None,
                           "namespace": "default", "class_name": "A",
                           "state": "ALIVE"}])
    server._persist_tick(force=True)
    counts.append(server.persist_stats()["snapshots_written"] - base)
    server.object_directory.update("o", [("dd" * 10, "n1")], [])
    server._persist_tick(force=True)
    counts.append(server.persist_stats()["snapshots_written"] - base)
    server._pg_update("j", [{"pg_id": "ee" * 14, "state": "PENDING",
                             "strategy": "PACK", "bundles": []}])
    server._persist_tick(force=True)
    counts.append(server.persist_stats()["snapshots_written"] - base)
    p["crash"](server)
    return counts


def test_actor_and_directory_mutations_trigger_snapshot(tmp_path):
    assert _both(actor_and_directory_mutations_trigger_snapshot,
                 tmp_path) == [0, 1, 2, 3]


def persist_error_counts_and_backs_off(p, tmp_path):
    server = _head(p, tmp_path)
    server._persist_path = str(tmp_path / "missing-dir" / "snap.pkl")
    server.gcs.kv.put(b"x", b"y")
    server._persist_tick(force=True)
    first = server.persist_stats()["persist_errors"]
    server.gcs.kv.put(b"x2", b"y2")
    server._persist_tick(force=True)
    second = server.persist_stats()["persist_errors"]
    p["crash"](server)
    return [first, second]


def test_persist_error_counts_and_backs_off(tmp_path):
    assert _both(persist_error_counts_and_backs_off, tmp_path) == [1, 1]


# -------------------------------------------------------------- epoch fencing


def reply_meta_carries_epoch_on_every_call(p, tmp_path):
    server = _head(p, tmp_path)
    server.start()
    client = p["mux"](server.address)
    metas = []
    client.on_reply_meta = metas.append
    try:
        client.call("ping")
        client.call("list_nodes")
        return [m["epoch"] for m in metas] == [server.epoch] * 2
    finally:
        client.close()
        p["crash"](server)


def test_reply_meta_carries_epoch_on_every_call(tmp_path):
    assert _both(reply_meta_carries_epoch_on_every_call, tmp_path) is True


def stale_epoch_write_rejected_typed_then_accepted(p, tmp_path):
    server = _head(p, tmp_path)
    server.start()
    port = server._server.port
    client = p["mux"](server.address)
    try:
        node_id = client.call("register_node", "10.1.1.1:7",
                              {"CPU": 1.0}, {}, "")
        old_epoch = server.epoch
        first = client.call("heartbeat", node_id, None, None, None,
                            epoch=old_epoch)
    finally:
        client.close()
    p["crash"](server)

    restarted = _head(p, tmp_path, port=port)
    restarted.start()
    client = p["mux"](restarted.address)
    try:
        record = {"first": first, "epoch_up": restarted.epoch > old_epoch}
        try:
            client.call("heartbeat", node_id, None, None, None,
                        epoch=old_epoch)
            record["fenced"] = None
        except p["method_error"] as exc:
            record["fenced"] = type(exc.cause).__name__
            record["typed"] = isinstance(exc.cause, p["stale"])
            record["carries_epoch"] = \
                exc.cause.current_epoch == restarted.epoch
        record["fenced_writes"] = \
            restarted.persist_stats()["fenced_writes"]
        granted = client.call("register_node", "10.1.1.1:7",
                              {"CPU": 1.0}, {}, "", prior_id=node_id)
        record["same_id"] = granted == node_id
        record["accepted"] = client.call("heartbeat", node_id, None, None,
                                         None, epoch=restarted.epoch)
        return record
    finally:
        client.close()
        p["crash"](restarted)


def test_stale_epoch_write_rejected_typed_then_accepted(tmp_path):
    assert _both(stale_epoch_write_rejected_typed_then_accepted,
                 tmp_path) == {
        "first": True, "epoch_up": True, "fenced": "StaleEpochError",
        "typed": True, "carries_epoch": True, "fenced_writes": 1,
        "same_id": True, "accepted": True}


def dead_actor_never_resurrected(p, tmp_path):
    server = _head(p, tmp_path)
    plain = {"actor_id": b"\x09" * 16, "name": "ghost",
             "namespace": "default", "class_name": "G",
             "state": "ALIVE"}
    applied = [server._actor_update([plain]),
               server._actor_update([{**plain, "state": "DEAD",
                                      "death_cause": "killed"}]),
               server._actor_update([{**plain, "state": "ALIVE"}]),
               server._actor_update([{**plain, "state": "RESTARTING"}])]
    state = server.gcs.list_actors()[0].state
    p["crash"](server)
    restarted = _head(p, tmp_path)
    try:
        return [applied, state, restarted.gcs.list_actors()[0].state,
                restarted._actor_update([{**plain, "state": "ALIVE"}])]
    finally:
        p["crash"](restarted)


def test_dead_actor_never_resurrected(tmp_path):
    assert _both(dead_actor_never_resurrected, tmp_path) == [
        [1, 1, 0, 0], "DEAD", "DEAD", 0]


def node_agent_resyncs_across_head_restart(p, tmp_path):
    server = _head(p, tmp_path)
    server.start()
    port = server._server.port
    agent = p["agent"](f"127.0.0.1:{port}", {"CPU": 1.0},
                       heartbeat_period_s=0.2)
    try:
        record = {"learned": agent.gcs_epoch == server.epoch}
        first_epoch = server.epoch
        p["crash"](server)
        server = _head(p, tmp_path, port=port)
        server.start()
        record["epoch_up"] = server.epoch > first_epoch
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and agent.gcs_epoch != server.epoch:
            time.sleep(0.1)
        record["resynced"] = agent.gcs_epoch == server.epoch
        record["fenced"] = server.persist_stats()["fenced_writes"] >= 1
        node = server.gcs.get_node(p["node_id"](agent.node_id))
        record["alive"] = node is not None and node.alive
        return record
    finally:
        agent.stop(drain=False)
        p["crash"](server)


def test_node_agent_resyncs_across_head_restart(tmp_path):
    with time_limit(120):
        record = _both(node_agent_resyncs_across_head_restart, tmp_path)
    assert record == {
        "learned": True, "epoch_up": True, "resynced": True,
        "fenced": True, "alive": True}


# ------------------------------------------------------------- disarmed path


def disarmed_is_legacy_raw_pickle_no_epoch(p, tmp_path):
    p["config"].update({"gcs_persistence": False})
    path = str(tmp_path / "gcs_snapshot.pkl")
    server = p["server"](host="127.0.0.1", port=0,
                         log_dir=str(tmp_path / "log"), persist_path=path)
    server.start()
    record = {"epoch": server.epoch, "wal": server._wal,
              "meta_fn": server._server.reply_meta_fn}
    client = p["mux"](server.address)
    metas = []
    client.on_reply_meta = metas.append
    try:
        client.call("kv_put", b"k", b"v")
        record["metas"] = list(metas)
        nid = client.call("register_node", "1.1.1.1:1", {}, {}, "")
        record["unfenced"] = client.call("heartbeat", nid, None, None,
                                         None, epoch=12345)
    finally:
        client.close()
    server._save_snapshot()
    with open(path, "rb") as f:
        record["keys"] = sorted(pickle.load(f))
    record["no_wal"] = not os.path.exists(path + ".wal")
    record["no_prev"] = not os.path.exists(path + ".prev")
    server.stop()

    p["config"].update({"gcs_persistence": True})
    restarted = p["server"](host="127.0.0.1", port=0,
                            log_dir=str(tmp_path / "log"),
                            persist_path=path)
    try:
        record["restored"] = restarted.gcs.kv.get(b"k")
    finally:
        p["crash"](restarted)
    return record


def test_disarmed_is_legacy_raw_pickle_no_epoch(tmp_path):
    assert _both(disarmed_is_legacy_raw_pickle_no_epoch, tmp_path) == {
        "epoch": 0, "wal": None, "meta_fn": None, "metas": [],
        "unfenced": True, "keys": ["jobs", "kv"], "no_wal": True,
        "no_prev": True, "restored": b"v"}


def driver_mirrors_actors_and_pgs_to_head(p, tmp_path):
    pkg = p["pkg"]
    pkg.shutdown()
    cluster = p["cluster"](log_dir=str(tmp_path / "cluster"),
                           persist_path=str(tmp_path / "gcs_snapshot.pkl"))
    runtime = None
    try:
        cluster.add_node(num_cpus=2, pool_size=0)
        assert cluster.wait_for_nodes(1, timeout=60)
        runtime = pkg.init(num_cpus=2, address=cluster.address)

        @pkg.remote
        class Mirrored:
            def ping(self):
                return "pong"

        handle = Mirrored.options(name="mirrored").remote()
        record = {"ping": pkg.get(handle.ping.remote(), timeout=60)}
        deadline = time.monotonic() + 30
        names = set()
        while time.monotonic() < deadline:
            names = {a.get("name")
                     for a in cluster.gcs._list_cluster_actors()}
            if "mirrored" in names:
                break
            time.sleep(0.3)
        record["mirrored"] = "mirrored" in names
        record["epoch"] = runtime._gcs_epoch == cluster.gcs.epoch
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and runtime.job_id.hex() \
                not in cluster.gcs._list_cluster_placement_groups():
            time.sleep(0.3)
        record["pgs"] = runtime.job_id.hex() in \
            cluster.gcs._list_cluster_placement_groups()
        return record
    finally:
        if runtime is not None:
            pkg.shutdown()
        cluster.shutdown()


def test_driver_mirrors_actors_and_pgs_to_head(tmp_path):
    with time_limit(240):
        record = _both(driver_mirrors_actors_and_pgs_to_head, tmp_path)
    assert record == {"ping": "pong", "mirrored": True, "epoch": True,
                      "pgs": True}


def torn_current_never_clobbers_good_prev(p, tmp_path):
    gp = p["gp"]
    path = str(tmp_path / "snap")
    gp.write_snapshot(path, b"good-gen-1")
    p["chaos"].configure("seed=2,gcs.torn_snapshot=1.0x1")
    gp.write_snapshot(path, b"torn-gen-2")
    p["chaos"].disable()
    record = [gp.read_snapshot(path + ".prev"),
              _error(lambda: gp.read_snapshot(path))]
    gp.write_snapshot(path, b"good-gen-3")
    return record + [gp.read_snapshot(path + ".prev"),
                     gp.read_snapshot(path)]


def test_torn_current_never_clobbers_good_prev(tmp_path):
    assert _both(torn_current_never_clobbers_good_prev, tmp_path) == [
        b"good-gen-1", "TornSnapshotError", b"good-gen-1", b"good-gen-3"]


# ------------------------------------------------------ the frames, crossed


@pytest.mark.parametrize("writer,reader", [
    ("ray_tpu", "ray_tpu_torch"), ("ray_tpu_torch", "ray_tpu")])
def test_each_package_reads_the_others_frames(tmp_path, writer, reader):
    """A raw-bytes payload written by one package's RGS1 and RGW1 code
    reads back through the other's, torn tail included."""
    w, r = PACKAGES[writer]["gp"], PACKAGES[reader]["gp"]
    payload = bytes(range(256)) * 17
    snap = str(tmp_path / "snap")
    w.write_snapshot(snap, payload)
    assert r.read_snapshot(snap) == payload
    w.write_snapshot(snap, payload[::-1])
    assert r.read_snapshot(snap + ".prev") == payload

    wal = str(tmp_path / "wal")
    writer_wal = w.WalWriter(wal)
    for seq in range(1, 5):
        writer_wal.append(seq, pickle.dumps(payload[:seq * 10]))
    writer_wal.close()
    with open(wal, "ab") as f:
        f.write(struct.Struct("<4sQQI").pack(b"RGW1", 5, 99, 1))
    seen = []
    stats = r.replay_wal(wal, 1, seen.append)
    assert seen == [payload[:seq * 10] for seq in (2, 3, 4)]
    assert stats == {"replayed": 3, "skipped": 1, "truncated": 1,
                     "last_seq": 4}


@pytest.mark.parametrize("writer,reader", [
    ("ray_tpu", "ray_tpu_torch"), ("ray_tpu_torch", "ray_tpu")])
def test_each_package_restores_the_others_node_host(tmp_path, writer,
                                                    reader):
    """A node registered with its host's identity on one package's
    durable head (its record in the snapshot and the WAL) comes back with
    that ``host_id`` in the other package's head, which a same-host
    puller's check reads."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    with time_limit(120):
        server = _head(w, tmp_path)
        server.start()
        client = w["mux"](server.address)
        try:
            node_id = client.call("register_node", "10.0.0.1:42",
                                  {"CPU": 4.0}, {}, "10.0.0.1:999",
                                  host_id="host-x")
        finally:
            client.close()
        w["crash"](server)
        restarted = _head(r, tmp_path)
        try:
            records = [(n.node_id.binary() == node_id, n.host_id, n.alive,
                        n.executor_address)
                       for n in restarted.gcs.list_nodes()]
            listed = [n["host_id"] for n in restarted._list_nodes()]
        finally:
            r["crash"](restarted)
    assert records == [(True, "host-x", True, "10.0.0.1:999")]
    assert listed == ["host-x"]
