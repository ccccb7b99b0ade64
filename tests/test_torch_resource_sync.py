"""The port's pushed resource view against the JAX package's: a node's
load change pokes an immediate heartbeat, the head publishes the new
availability on ``node_resources``, and the driver's scheduler admits on
the smaller of its own ledger and the node's fresh report (the cases of
tests/test_resource_sync.py).

Each mirrored case runs once through ``ray_tpu`` and once through
``ray_tpu_torch`` and returns a plain record; the two must be equal, and
equal to what the reference test asserts. The cluster case runs on one
cluster per package (torch_cluster_sides.py) whose daemon's periodic
heartbeat is 20 s away, so whatever the driver sees within the test's
window was pushed.

Where the port deliberately differs: the head has no persistence and no
restart epochs (ROADMAP item 10b); nothing else here.
"""

import importlib
import threading
import time

import pytest

from torch_cluster_sides import PACKAGES, both, start_clusters, stop_clusters


def _scheduler(name: str):
    return (importlib.import_module(f"{name}._private.scheduler"),
            importlib.import_module(f"{name}._private.ids").NodeID)


def _units(scenario) -> dict:
    records = {name: scenario(*_scheduler(name)) for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def fresh_report_only(scheduler, NodeID) -> dict:
    node = scheduler.NodeState(node_id=NodeID(), total={"CPU": 8.0},
                               available={"CPU": 8.0})
    record = {"ledger_only": node.fits({"CPU": 8.0})}
    # A fresh low report (another driver's load) holds admission back.
    node.reported = {"CPU": 1.0}
    node.reported_at = time.monotonic()
    record["fresh_one"] = node.fits({"CPU": 1.0})
    record["fresh_two"] = node.fits({"CPU": 2.0})
    # A stale report ages out: back to the ledger.
    node.reported_at = time.monotonic() \
        - scheduler.REPORTED_AVAILABILITY_TTL_S - 1
    record["stale"] = node.fits({"CPU": 8.0})
    return record


def test_effective_available_uses_fresh_report_only():
    assert _units(fresh_report_only) == {
        "ledger_only": True, "fresh_one": True, "fresh_two": False,
        "stale": True}


def wakes_waiters(scheduler, NodeID) -> dict:
    cluster = scheduler.ClusterState()
    node = scheduler.NodeState(node_id=NodeID(), total={"CPU": 2.0},
                               available={"CPU": 2.0})
    cluster.add_node(node)
    woke = threading.Event()
    waiting = threading.Event()

    def waiter():
        waiting.set()
        cluster.wait_for_change(timeout=5.0)
        woke.set()

    thread = threading.Thread(target=waiter)
    thread.start()
    waiting.wait(5.0)
    # Reported until the waiter wakes: a report sent before it parked in
    # wait_for_change wakes nobody.
    deadline = time.monotonic() + 2.0
    while not woke.is_set() and time.monotonic() < deadline:
        cluster.update_reported(node.node_id, {"CPU": 1.0})
        woke.wait(0.05)
    thread.join(timeout=2.0)
    return {"woke": woke.is_set(),
            "reported": cluster.get_node(node.node_id).reported}


def test_update_reported_wakes_waiters():
    assert _units(wakes_waiters) == {"woke": True, "reported": {"CPU": 1.0}}


@pytest.fixture
def slow_heartbeat_cluster(tmp_path):
    sides = start_clusters(tmp_path, [{"num_cpus": 2,
                                       "heartbeat_period_s": 20.0}],
                           heartbeat_timeout_s=90.0)
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


def pushed(side) -> dict:
    rt, runtime = side.rt, side.runtime

    @rt.remote(num_cpus=1)
    def hold(seconds: float):
        import time

        time.sleep(seconds)
        return "done"

    node = next(n for n in runtime.cluster.nodes() if n.labels.get("remote"))

    def seen(check) -> bool:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if node.reported is not None and check(node.reported):
                return True
            time.sleep(0.05)
        return False

    ref = hold.remote(6.0)
    # The admission's push must arrive well before the 20 s heartbeat.
    busy = seen(lambda r: r.get("CPU", 2.0) <= 1.0)
    done = rt.get(ref, timeout=30)
    free = seen(lambda r: r.get("CPU", 0.0) >= 2.0)
    return {"busy_pushed": busy, "done": done, "free_pushed": free}


def test_load_change_pushes_availability_to_driver(slow_heartbeat_cluster):
    assert both(pushed, slow_heartbeat_cluster) == {
        "busy_pushed": True, "done": "done", "free_pushed": True}
