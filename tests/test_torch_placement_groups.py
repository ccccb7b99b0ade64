"""The port's placement groups, scheduling strategies and admission
shedding against the JAX package's.

Each mirrored case is a scenario that runs once through ``ray_tpu`` and
once through ``ray_tpu_torch``, each under its own ``init`` and
``shutdown``, and returns a plain record; the two records must be equal,
and equal to what the mirrored test of tests/test_placement_groups.py
(or tests/test_overload.py for the shed) asserts. Waits are bounded.

The port-only cases at the end each state how the port differs: bundles
hold ``GPU`` (the reference folds ``num_gpus`` into ``TPU``); a task
whose bundle is full waits for it, where the reference fails it with
``PlacementGroupError``; NODE_AFFINITY and STRICT_SPREAD are shown on the
one head node, since the reference's multi-node fixture
(``ray_start_cluster``) waits for the port's remote nodes.
"""

import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private.config import GLOBAL_CONFIG as JAX_CONFIG
from ray_tpu.util import placement_group as jax_pg
from ray_tpu.util import scheduling_strategies as jax_ss
from ray_tpu_torch._private.config import GLOBAL_CONFIG as TORCH_CONFIG
from ray_tpu_torch.util import placement_group as torch_pg
from ray_tpu_torch.util import scheduling_strategies as torch_ss

RUNTIMES = {"ray_tpu": (ray_tpu, jax_pg, jax_ss, JAX_CONFIG),
            "ray_tpu_torch": (ray_tpu_torch, torch_pg, torch_ss,
                              TORCH_CONFIG)}
WAIT_S = 10.0


def _run(scenario, name, **init):
    rt, pg, ss, config = RUNTIMES[name]
    rt.shutdown()
    rt.init(**{"num_cpus": 8, **init})
    try:
        return scenario(rt, pg, ss)
    finally:
        rt.shutdown()
        config.reset()


def _both(scenario, **init) -> dict:
    return {name: _run(scenario, name, **init) for name in RUNTIMES}


def _error(fn) -> "str | None":
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        return type(exc).__name__
    return None


def _until(predicate) -> bool:
    """Poll ``predicate`` for up to WAIT_S."""
    deadline = time.monotonic() + WAIT_S
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


# ------------------------------------------ mirrored: test_placement_groups


def create_and_ready(rt, pg, ss):
    group = pg.placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
    return [group.wait(timeout_seconds=5), group.bundle_count,
            any(v["state"] == "CREATED"
                for v in pg.placement_group_table().values())]


def reserves_resources(rt, pg, ss):
    group = pg.placement_group([{"CPU": 4}], strategy="PACK")
    ready = group.wait(timeout_seconds=5)
    held = rt.available_resources().get("CPU", 0)
    pg.remove_placement_group(group)
    back = _until(lambda: rt.available_resources().get("CPU", 0) == 8)
    states = [v["state"] for v in pg.placement_group_table().values()]
    return [ready, held, back, states]


def task_scheduling(rt, pg, ss):
    group = pg.placement_group([{"CPU": 2}], strategy="PACK")

    @rt.remote(num_cpus=2)
    def inside():
        return "in-bundle"

    strategy = ss.PlacementGroupSchedulingStrategy(
        placement_group=group, placement_group_bundle_index=0)
    return rt.get(inside.options(scheduling_strategy=strategy).remote(),
                  timeout=WAIT_S)


def task_scheduling_by_option(rt, pg, ss):
    group = pg.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="SPREAD")

    @rt.remote(num_cpus=1)
    def inside(i):
        return i

    refs = [inside.options(placement_group=group,
                           placement_group_bundle_index=i).remote(i)
            for i in range(2)]
    return rt.get(refs, timeout=WAIT_S)


def actor_scheduling(rt, pg, ss):
    group = pg.placement_group([{"CPU": 1}], strategy="PACK")

    @rt.remote(num_cpus=1)
    class Worker:
        def ping(self):
            return "pong"

    strategy = ss.PlacementGroupSchedulingStrategy(placement_group=group)
    worker = Worker.options(scheduling_strategy=strategy).remote()
    out = rt.get(worker.ping.remote(), timeout=WAIT_S)
    rt.kill(worker)
    return out


def pending_until_capacity(rt, pg, ss):
    # 8 CPUs: a 6-CPU group fits, a second one stays pending.
    pg1 = pg.placement_group([{"CPU": 6}], strategy="PACK")
    first = pg1.wait(timeout_seconds=5)
    pg2 = pg.placement_group([{"CPU": 6}], strategy="PACK")
    pending = pg2.wait(timeout_seconds=0.3)
    pg.remove_placement_group(pg1)
    return [first, pending, pg2.wait(timeout_seconds=5)]


def strict_pack_two_bundles_one_node(rt, pg, ss):
    group = pg.placement_group([{"CPU": 3}, {"CPU": 3}],
                               strategy="STRICT_PACK")
    return [group.wait(timeout_seconds=5),
            rt.available_resources().get("CPU")]


def invalid_strategy(rt, pg, ss):
    return _error(lambda: pg.placement_group([{"CPU": 1}], strategy="BOGUS"))


def invalid_bundle(rt, pg, ss):
    return [_error(lambda: pg.placement_group([{}], strategy="PACK")),
            _error(lambda: pg.placement_group([], strategy="PACK")),
            _error(lambda: pg.placement_group([{"CPU": 0}]))]


def tpu_slice_bundle_shape(rt, pg, ss):
    return [pg.tpu_slice_bundle(num_chips=8, cpus_per_host=4,
                                chips_per_host=4),
            pg.tpu_slice_bundle(num_chips=6)]


PG_CASES = {
    create_and_ready: [True, 2, True],
    reserves_resources: [True, 4, True, ["REMOVED"]],
    task_scheduling: "in-bundle",
    task_scheduling_by_option: [0, 1],
    actor_scheduling: "pong",
    pending_until_capacity: [True, False, True],
    strict_pack_two_bundles_one_node: [True, 2.0],
    invalid_strategy: "ValueError",
    invalid_bundle: ["ValueError"] * 3,
    tpu_slice_bundle_shape: [[{"TPU": 4.0, "CPU": 4.0}] * 2,
                             [{"TPU": 4.0, "CPU": 8.0},
                              {"TPU": 2.0, "CPU": 8.0}]],
}


@pytest.mark.parametrize("scenario", list(PG_CASES), ids=lambda f: f.__name__)
def test_placement_group_parity(scenario):
    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"]
    assert records["ray_tpu_torch"] == PG_CASES[scenario]


def test_queue_depth_shed_parity():
    """The mirror of tests/test_overload.py's queue-depth case: over
    ``admission_max_queue_depth`` a deadline-armed submit is shed with
    ``SystemOverloadedError`` and counted; deadline-free work queues and
    completes."""
    def scenario(rt, pg, ss):
        runtime = rt._private.worker.global_runtime()
        runtime_config = RUNTIMES[rt.__name__][3]
        runtime_config.update({"admission_max_queue_depth": 5})
        release, started = threading.Event(), threading.Event()

        @rt.remote(num_cpus=1)
        def blocker():
            started.set()
            release.wait(WAIT_S)
            return "b"

        @rt.remote(num_cpus=1)
        def quick(x):
            return x

        first = blocker.remote()
        started.wait(WAIT_S)
        backlog = [quick.remote(i) for i in range(6)]
        built = _until(lambda: runtime.dispatcher.pending_count() > 5)
        shed = _error(lambda: rt.get(quick.remote(-1, _deadline_s=30),
                                     timeout=WAIT_S))
        release.set()
        counters = runtime.fault_stats() if rt is ray_tpu \
            else runtime.stats()
        return [built, shed, counters["admission_shed"],
                rt.get(first, timeout=WAIT_S),
                rt.get(backlog, timeout=WAIT_S)]

    records = _both(scenario, num_cpus=1)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, "SystemOverloadedError", 1, "b", list(range(6))]


# ------------------------------------------------------------- port only


def test_a_gpu_bundle_holds_the_card_until_removed():
    """A ``GPU`` bundle takes the card from the node: a plain
    ``num_gpus=1`` task waits while a ``num_gpus=1`` task in the bundle
    runs (and sees the ``GPU`` assigned); after removal the waiting task
    runs and ``GPU`` is back. A second task into the full bundle waits
    for the first to give its share back (the reference fails it)."""
    def scenario(rt, pg, ss):
        group = pg.placement_group([{"GPU": 1, "CPU": 1}],
                                   strategy="STRICT_PACK")
        ready = group.wait(timeout_seconds=WAIT_S)
        held = rt.available_resources()["GPU"]
        release, started = threading.Event(), threading.Event()

        @rt.remote(num_gpus=1)
        def on_card(gate=None):
            if gate is not None:
                started.set()
                gate.wait(WAIT_S)
            return rt.get_runtime_context().get_assigned_resources()

        outside = on_card.remote()
        bundled = on_card.options(scheduling_strategy=(
            ss.PlacementGroupSchedulingStrategy(
                placement_group=group, placement_group_bundle_index=0)))
        first = bundled.remote(release)
        started.wait(WAIT_S)
        second = bundled.remote()
        waiting = rt.wait([outside, second], num_returns=2, timeout=0.3)[0]
        release.set()
        in_bundle = rt.get([first, second], timeout=WAIT_S)
        outside_ready = rt.wait([outside], timeout=0.3)[0]
        pg.remove_placement_group(group)
        return [ready, held, waiting, in_bundle, outside_ready,
                rt.get(outside, timeout=WAIT_S),
                _until(lambda: rt.available_resources()["GPU"] == 1.0)]

    assigned = {"CPU": 1.0, "GPU": 1.0}
    assert _run(scenario, "ray_tpu_torch", num_gpus=1) == \
        [True, 0.0, [], [assigned, assigned], [], assigned, True]


def test_a_bundled_actor_gives_its_share_back_when_its_call_returns(
        monkeypatch):
    """An actor in a ``GPU`` bundle holds its share; killed while a call
    runs, the share goes back to the bundle when the call returns (the
    port's rule for a killed actor's resources), and a bundled task then
    runs."""
    from ray_tpu_torch._private import worker

    monkeypatch.setattr(worker, "_KILL_WAIT_S", 0.2)

    def scenario(rt, pg, ss):
        group = pg.placement_group([{"GPU": 1}], strategy="PACK")
        strategy = ss.PlacementGroupSchedulingStrategy(placement_group=group)
        release, started = threading.Event(), threading.Event()

        @rt.remote(num_gpus=1, num_cpus=0)
        class Holder:
            def hold(self):
                started.set()
                release.wait(WAIT_S)
                return "held"

        @rt.remote(num_gpus=1, num_cpus=0)
        def task():
            return "ran"

        actor = Holder.options(scheduling_strategy=strategy).remote()
        call = actor.hold.remote()
        started.wait(WAIT_S)
        rt.kill(actor)
        ref = task.options(scheduling_strategy=strategy).remote()
        blocked = rt.wait([ref], timeout=0.3)[0]
        release.set()
        return [blocked, rt.get(call, timeout=WAIT_S),
                rt.get(ref, timeout=WAIT_S),
                rt.available_resources()["GPU"]]

    assert _run(scenario, "ray_tpu_torch", num_gpus=1) == \
        [[], "held", "ran", 0.0]


def test_a_task_its_bundle_can_never_hold_fails_typed():
    """A demand larger than its bundle, and a task into a removed group,
    seal ``PlacementGroupError`` instead of waiting forever."""
    def scenario(rt, pg, ss):
        group = pg.placement_group([{"CPU": 1}])
        group.wait(WAIT_S)

        @rt.remote(num_cpus=2)
        def big():
            return "ran"

        @rt.remote(num_cpus=1)
        def small():
            return "ran"

        too_big = big.options(placement_group=group).remote()
        no_bundle = small.options(placement_group=group,
                                  placement_group_bundle_index=3).remote()
        pg.remove_placement_group(group)
        removed = small.options(placement_group=group).remote()
        return [_error(lambda: rt.get(ref, timeout=WAIT_S))
                for ref in (too_big, no_bundle, removed)]

    assert _run(scenario, "ray_tpu_torch") == ["PlacementGroupError"] * 3


def test_node_affinity_on_the_head_node():
    """NODE_AFFINITY to the head node runs there; a hard affinity to a
    node that is not there waits (warned as no other), a soft one falls
    back to the default policy."""
    def scenario(rt, pg, ss):
        head = rt.nodes()[0]["NodeID"]

        @rt.remote
        def where():
            return rt.get_runtime_context().get_node_id()

        def on(node_id, soft=False):
            return where.options(scheduling_strategy=(
                ss.NodeAffinitySchedulingStrategy(node_id, soft=soft)))

        missing = "0" * 32
        hard = on(missing).remote()
        return [rt.get(on(head).remote(), timeout=WAIT_S) == head,
                rt.get(on(missing, soft=True).remote(),
                       timeout=WAIT_S) == head,
                rt.wait([hard], timeout=0.3)[0]]

    assert _run(scenario, "ray_tpu_torch") == [True, True, []]


def test_strict_spread_stays_pending_on_one_node():
    """Two STRICT_SPREAD bundles need two nodes: on the one head node the
    group stays pending and holds nothing; removing it ends its
    reservation thread."""
    def scenario(rt, pg, ss):
        group = pg.placement_group([{"CPU": 1}, {"CPU": 1}],
                                   strategy="STRICT_SPREAD")
        pending = group.wait(timeout_seconds=0.3)
        cpus = rt.available_resources()["CPU"]
        pg.remove_placement_group(group)
        return [pending, cpus, group.wait(timeout_seconds=0.1)]

    assert _run(scenario, "ray_tpu_torch") == [False, 8.0, False]


def test_placement_group_pickles_and_reaches_a_task():
    """A handle passed into a task names the same group there."""
    def scenario(rt, pg, ss):
        group = pg.placement_group([{"CPU": 1}])

        @rt.remote
        def inspect(handle):
            return [handle.id == group.id, handle.wait(WAIT_S),
                    handle.bundle_count]

        return rt.get(inspect.remote(group), timeout=WAIT_S)

    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [True, True, 1]
