"""The port's flight recorder (``ray_tpu_torch/_private/flight_recorder.py``)
against the JAX package's.

Each case runs once through ``ray_tpu`` and once through ``ray_tpu_torch``
and returns a plain record; the records must be equal. The ring's
install, upgrade, dump, collection and pruning come first; then the
flight-ring half of tests/test_chaos.py:1113: a daemon SIGKILLed in a
two-node cluster leaves its ring file in the session's ``flight/``
folder, and ``collect_session_dumps`` returns it with the daemon's
failure counters and stage histograms beside the ring. The reference
case kills its daemon through the ``daemon.die`` chaos site, which the
port does not have yet (ROADMAP 10c): here the cluster kills it.
"""

from __future__ import annotations

import importlib
import json
import os
import time

import pytest

from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")
SESSION_ENV = {"ray_tpu": "RAY_TPU_SESSION_DIR",
               "ray_tpu_torch": "RAY_TPU_TORCH_SESSION_DIR"}


def _fr(pkg: str):
    return importlib.import_module(f"{pkg}._private.flight_recorder")


@pytest.fixture
def fresh_recorders():
    """Each package's process recorder taken away for the case and put
    back after (other files install theirs)."""
    saved = {pkg: _fr(pkg)._REC for pkg in PACKAGES}
    for pkg in PACKAGES:
        _fr(pkg)._REC = None
    yield
    for pkg in PACKAGES:
        rec = _fr(pkg)._REC
        if rec is not None and rec is not saved[pkg]:
            rec.stop()
        _fr(pkg)._REC = saved[pkg]


def _both(scenario, tmp_path, monkeypatch) -> dict:
    records = {}
    for pkg in PACKAGES:
        session = tmp_path / pkg / "session"
        with monkeypatch.context() as m:
            m.setenv(SESSION_ENV[pkg], str(session))
            records[pkg] = scenario(pkg, session)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def ring_install_and_dump(pkg, session):
    fr = _fr(pkg)
    rec = fr.install("worker-x")
    fr.record("epoch.bump", 3, 4)
    fr.record("spill.spill", "ab" * 8, 1024)
    again = fr.install("other", extra_fn=lambda: {"fault_stats": {"a": 1}})
    path = fr.dump("test")
    with open(path) as f:
        doc = json.load(f)
    for _ in range(600):
        rec.record("noise")
    return {"same": again is rec, "role": doc["role"],
            "file": os.path.basename(path) == f"worker-x-{os.getpid()}.json",
            "kinds": [e["kind"] for e in doc["events"]],
            "args": doc["events"][1]["args"], "reason": doc["reason"],
            "extra": doc["fault_stats"], "bounded": len(rec._ring),
            "no_flusher": rec._thread is None}


def test_ring_install_upgrade_dump_and_bound(tmp_path, monkeypatch,
                                             fresh_recorders):
    assert _both(ring_install_and_dump, tmp_path, monkeypatch) == {
        "same": True, "role": "worker-x", "file": True,
        "kinds": ["start", "epoch.bump", "spill.spill"],
        "args": ["3", "4"], "reason": "test", "extra": {"a": 1},
        "bounded": 512, "no_flusher": True}


def flusher_and_collect(pkg, session):
    fr = _fr(pkg)
    config = importlib.import_module(f"{pkg}._private.config").GLOBAL_CONFIG
    config.update({"flight_recorder_flush_s": 0.1})
    try:
        flight = session / "flight"
        flight.mkdir(parents=True)
        stale = flight / "daemon-old-1.json"
        stale.write_text("{}")
        os.utime(stale, (time.time() - 4 * 86400,) * 2)
        (flight / "torn-2.json").write_text("{not json")
        # A bare ring first (a head before its restore), upgraded with a
        # flusher: the first dump holds what came before it.
        rec = fr.install("daemon-t")
        rec.record("gcs.restore", 2, 1.5)
        fr.install("daemon-t", flush=True)

        def kinds_on_disk():
            docs = [d for d in fr.collect_session_dumps()
                    if d.get("role") == "daemon-t"]
            return docs, [e["kind"] for e in docs[0]["events"]] \
                if docs else []

        deadline = time.monotonic() + 5
        while "gcs.restore" not in kinds_on_disk()[1] \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        first = kinds_on_disk()[1]
        rec.record("heartbeat.stale_epoch", 7)
        deadline = time.monotonic() + 5
        while "heartbeat.stale_epoch" not in kinds_on_disk()[1] \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        docs, kinds = kinds_on_disk()
        rec.stop()
        return {"pruned": not stale.exists(),
                "files": [d["file"] for d in docs] ==
                [f"daemon-t-{os.getpid()}.json"],
                "first": first, "kinds": kinds, "reason": docs[0]["reason"]}
    finally:
        config.reset()


def test_flusher_rewrites_the_ring_and_collect_skips_torn_files(
        tmp_path, monkeypatch, fresh_recorders):
    assert _both(flusher_and_collect, tmp_path, monkeypatch) == {
        "pruned": True, "files": True, "first": ["start", "gcs.restore"],
        "kinds": ["start", "gcs.restore", "heartbeat.stale_epoch"],
        "reason": "periodic"}


def test_full_ring_still_flushes_new_events(tmp_path, monkeypatch,
                                            fresh_recorders):
    """Port only: the flusher tells new events by the ring's newest
    entry, so a full ring (whose length no longer moves) still reaches
    the disk. The reference compares lengths and stops flushing a full
    ring."""
    monkeypatch.setenv(SESSION_ENV["ray_tpu_torch"], str(tmp_path))
    fr = _fr("ray_tpu_torch")
    rec = fr.FlightRecorder("daemon-full", capacity=8)
    for i in range(8):
        rec.record("fill", i)
    rec.arm_flush(0.05)
    try:
        path = rec.path()
        deadline = time.monotonic() + 5
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.02)
        rec.record("epoch.bump", 1, 2)
        kinds: list = []
        while "epoch.bump" not in kinds and time.monotonic() < deadline:
            time.sleep(0.02)
            with open(path) as f:
                kinds = [e["kind"] for e in json.load(f)["events"]]
        assert len(rec._ring) == 8 and kinds[-1] == "epoch.bump", kinds
    finally:
        rec.stop()


def sigkilled_daemon(pkg, session):
    fr = _fr(pkg)
    cluster_mod = importlib.import_module(f"{pkg}.cluster_utils")
    cluster = cluster_mod.Cluster(log_dir=str(session.parent / "cluster"))
    try:
        cluster.add_node(num_cpus=1)
        victim = cluster.add_node(num_cpus=1)
        assert cluster.wait_for_nodes(2, timeout=90)

        def victim_dump():
            return [d for d in fr.collect_session_dumps()
                    if d.get("pid") == victim.pid]

        deadline = time.monotonic() + 30
        while not victim_dump() and time.monotonic() < deadline:
            time.sleep(0.2)
        # One flush period and a second: the ring as the daemon left it.
        time.sleep(2.0 + 1.0)
        cluster.remove_node(victim, allow_graceful=False)
        killed_at = time.time()
        (dead,) = victim_dump()
        kinds = [e["kind"] for e in dead["events"]]
        if pkg == "ray_tpu_torch":
            # The port's flusher also writes the install's own "start",
            # recorded while the first dump was being written; the
            # reference's length check misses it.
            assert "start" in kinds, kinds
        return {"role": dead["role"].startswith("daemon-"),
                "file": dead["file"] == f"{dead['role']}-{victim.pid}.json",
                "stop": "daemon.stop" in kinds,
                "reason": dead["reason"],
                "fresh": killed_at - dead["dumped_at"] < 60,
                "post_mortem": all(key in dead for key in (
                    "fault_stats", "breaker", "spill", "stage_hist")),
                "survivor": sum(1 for d in fr.collect_session_dumps()
                                if d.get("role", "").startswith("daemon-"))
                == 2}
    finally:
        cluster.shutdown()


def test_sigkilled_daemon_leaves_its_flight_ring(tmp_path, monkeypatch):
    """The flight-ring half of tests/test_chaos.py:1113: the dead
    daemon's ring is on disk (its flusher wrote it at install), ends
    without a ``daemon.stop``, and carries the post-mortem state."""
    with time_limit(150):
        assert _both(sigkilled_daemon, tmp_path, monkeypatch) == {
            "role": True, "file": True, "stop": False,
            "reason": "periodic", "fresh": True, "post_mortem": True,
            "survivor": True}
