"""The port's lineage recovery and node health checks
(``recovery.py``, ``kill_node``) against the JAX package's.

Each mirrored case of tests/test_recovery.py runs once through
``ray_tpu`` and once through ``ray_tpu_torch``, each under its own
``init(num_cpus=4)`` with the fast health checks of that file (a 50 ms
period, 3 misses), and returns a plain record; the two records must be
equal, and equal to what the mirrored test asserts. A task's side effect
(a file it appends to) shows that lineage really re-ran it.

The port-only case at the end states how the port differs: a virtual
node's ``GPU`` names the process's cards from 0 (the nodes share them),
so a ``num_gpus=1`` task pinned softly to a node with a card runs on card
0 there, and its rebuild after the node's death runs on the head's
``GPU``; the dead node's cards leave the cluster's totals.
"""

import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private.config import GLOBAL_CONFIG as JAX_CONFIG
from ray_tpu._private.ids import ObjectID as JaxObjectID
from ray_tpu._private.ids import TaskID as JaxTaskID
from ray_tpu._private.recovery import LineageTable as JaxLineageTable
from ray_tpu._private.task import SchedulingStrategy as JaxStrategy
from ray_tpu._private.task import TaskSpec as JaxTaskSpec
from ray_tpu_torch._private.config import GLOBAL_CONFIG as TORCH_CONFIG
from ray_tpu_torch._private.ids import ObjectID as TorchObjectID
from ray_tpu_torch._private.ids import TaskID as TorchTaskID
from ray_tpu_torch._private.recovery import LineageTable as TorchLineageTable
from ray_tpu_torch._private.task import SchedulingStrategy as TorchStrategy
from ray_tpu_torch._private.task import TaskSpec as TorchTaskSpec

RUNTIMES = {"ray_tpu": (ray_tpu, JAX_CONFIG, JaxStrategy),
            "ray_tpu_torch": (ray_tpu_torch, TORCH_CONFIG, TorchStrategy)}
FAST_HEALTH = {"health_check_period_ms": 50,
               "health_check_failure_threshold": 3}
WAIT_S = 10.0


def _run(scenario, name, **init):
    rt, config, strategy = RUNTIMES[name]
    rt.shutdown()
    runtime = rt.init(**{"num_cpus": 4, **init,
                         "system_config": dict(FAST_HEALTH)})
    try:
        return scenario(runtime, strategy)
    finally:
        rt.shutdown()
        config.reset()


def _both(scenario, **init) -> dict:
    return {name: _run(scenario, name, **init) for name in RUNTIMES}


def _affinity(strategy, node_id):
    # Soft: a rebuild may be placed on the nodes that survive.
    return strategy(kind="NODE_AFFINITY", node_id=node_id.hex(), soft=True)


def _wait_node_dead(runtime, node_id) -> bool:
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        record = [n for n in runtime.gcs.list_nodes()
                  if n.node_id == node_id][0]
        if not record.alive:
            return True
        time.sleep(0.02)
    return False


def _error(fn) -> "str | None":
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        return type(exc).__name__
    return None


# --------------------------------------------- mirrored: test_recovery


def test_lost_object_recovered_by_lineage(tmp_path):
    def scenario(runtime, strategy):
        node_b = runtime.add_node({"CPU": 2.0})
        counter = tmp_path / f"runs-{type(runtime).__module__}"

        def produce():
            with open(counter, "a") as f:
                f.write("x")
            return 41 + 1

        refs = runtime.submit_task(
            produce, (), {}, name="produce", resources={"CPU": 1.0},
            scheduling_strategy=_affinity(strategy, node_b))
        first = [runtime.get(refs)[0], counter.read_text()]
        runtime.kill_node(node_b)
        dead = _wait_node_dead(runtime, node_b)
        # The object was on the dead node: a get re-runs its lineage.
        return first + [dead, runtime.get(refs, timeout=WAIT_S)[0],
                        counter.read_text(),
                        runtime.recovery.num_recoveries >= 1]

    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [42, "x", True, 42, "xx", True]


def test_chain_recovery_rebuilds_dependencies():
    def scenario(runtime, strategy):
        node_b = runtime.add_node({"CPU": 2.0})
        a_refs = runtime.submit_task(
            lambda: 10, (), {}, name="a", resources={"CPU": 1.0},
            scheduling_strategy=_affinity(strategy, node_b))
        b_refs = runtime.submit_task(
            lambda x: x + 5, (a_refs[0],), {}, name="b",
            resources={"CPU": 1.0},
            scheduling_strategy=_affinity(strategy, node_b))
        first = runtime.get(b_refs)[0]
        runtime.kill_node(node_b)
        dead = _wait_node_dead(runtime, node_b)
        # a and b were both lost with the node; b's rebuild needs a's.
        return [first, dead, runtime.get(b_refs, timeout=WAIT_S)[0],
                runtime.get(a_refs, timeout=WAIT_S)[0],
                runtime.recovery.num_recoveries]

    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [15, True, 15, 10, 2]


def test_put_object_without_lineage_errors():
    def scenario(runtime, strategy):
        node_b = runtime.add_node({"CPU": 2.0})
        ref = runtime.put({"payload": 1})
        # As if its primary copy were on node B: a put has no lineage.
        runtime._record_location(ref.id(), node_b)
        runtime.kill_node(node_b)
        dead = _wait_node_dead(runtime, node_b)
        return [dead, _error(lambda: runtime.get([ref], timeout=WAIT_S))]

    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, "ObjectLostError"]


def test_tasks_reschedule_off_dead_node():
    """Work keeps completing after its preferred node dies."""
    def scenario(runtime, strategy):
        node_b = runtime.add_node({"CPU": 2.0})
        first = runtime.submit_task(
            lambda: "before", (), {}, name="w0", resources={"CPU": 1.0},
            scheduling_strategy=_affinity(strategy, node_b))
        before = runtime.get(first)[0]
        runtime.kill_node(node_b)
        dead = _wait_node_dead(runtime, node_b)
        later = [runtime.submit_task(lambda i=i: i * 2, (), {},
                                     name=f"w{i}",
                                     resources={"CPU": 1.0})[0]
                 for i in range(1, 5)]
        return [before, dead, runtime.get(later, timeout=WAIT_S),
                runtime.cluster_resources()]

    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["before", True, [2, 4, 6, 8], {"CPU": 4.0}]


def test_unrecoverable_dep_surfaces_object_lost():
    """A task whose lost argument has no lineage fails with
    ObjectLostError (not a retry loop ending in TaskError)."""
    def scenario(runtime, strategy):
        node_b = runtime.add_node({"CPU": 2.0})
        payload = runtime.put([1, 2, 3])
        runtime._record_location(payload.id(), node_b)
        child = runtime.submit_task(
            lambda x: sum(x), (payload,), {}, name="child",
            resources={"CPU": 1.0},
            scheduling_strategy=_affinity(strategy, node_b))
        first = runtime.get(child)[0]
        runtime.kill_node(node_b)
        dead = _wait_node_dead(runtime, node_b)
        return [first, dead,
                _error(lambda: runtime.get(child, timeout=WAIT_S))]

    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [6, True, "ObjectLostError"]


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_lineage_table_is_bounded(package):
    table_cls, spec_cls, object_id, task_id = {
        "ray_tpu": (JaxLineageTable, JaxTaskSpec, JaxObjectID, JaxTaskID),
        "ray_tpu_torch": (TorchLineageTable, TorchTaskSpec, TorchObjectID,
                          TorchTaskID)}[package]
    table = table_cls(max_entries=10)
    specs = []
    for i in range(25):
        spec = spec_cls(task_id=task_id(), name=f"t{i}", func=lambda: None,
                        args=(), kwargs={}, return_ids=[object_id()])
        table.record(spec)
        specs.append(spec)
    assert len(table) == 10
    assert table.lookup(specs[0].return_ids[0]) is None  # evicted
    assert table.lookup(specs[-1].return_ids[0]) is specs[-1]
    table.forget([specs[-1].return_ids[0]])
    assert len(table) == 9


# ------------------------------------------------------------- port only


def test_hard_affinity_to_a_dead_node_fails_fast():
    """Lineage never rebuilds a task hard-pinned to a dead node (it could
    never be placed): the lost object seals ObjectLostError, as in the
    reference's ``recover``."""
    def scenario(runtime, strategy):
        node_b = runtime.add_node({"CPU": 2.0})
        pinned = strategy(kind="NODE_AFFINITY", node_id=node_b.hex(),
                          soft=False)
        refs = runtime.submit_task(lambda: 7, (), {}, name="pinned",
                                   resources={"CPU": 1.0},
                                   scheduling_strategy=pinned)
        first = runtime.get(refs)[0]
        runtime.kill_node(node_b)
        dead = _wait_node_dead(runtime, node_b)
        return [first, dead, _error(lambda: runtime.get(refs,
                                                        timeout=WAIT_S)),
                runtime.recovery.num_recoveries]

    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [7, True, "ObjectLostError", 0]


def test_a_gpu_task_on_a_dead_node_is_rebuilt_on_the_heads_gpu():
    """A ``num_gpus=1`` task pinned softly to a node with a card runs
    there on card 0; after the node dies the rebuild runs on the head's
    ``GPU`` (card 0 too), the dead node's ``GPU`` leaves the totals and
    both ledgers end with their cards free."""
    def scenario(runtime, strategy):
        node_b = runtime.add_node({"CPU": 2.0, "GPU": 1.0})

        def where():
            ctx = ray_tpu_torch.get_runtime_context()
            return ctx.get_node_id(), ctx.get_gpu_ids()

        refs = runtime.submit_task(
            where, (), {}, name="where", resources={"CPU": 1.0, "GPU": 1.0},
            scheduling_strategy=_affinity(strategy, node_b))
        first = runtime.get(refs)[0]
        totals = runtime.cluster_resources()
        runtime.kill_node(node_b)
        dead = _wait_node_dead(runtime, node_b)
        rebuilt = runtime.get(refs, timeout=WAIT_S)[0]
        head = runtime.cluster.get_node(runtime.head_node_id)
        dead_node = runtime.cluster.get_node(node_b)
        return [first == (node_b.hex(), [0]), totals["GPU"], dead,
                rebuilt == (runtime.head_node_id.hex(), [0]),
                runtime.cluster_resources()["GPU"],
                runtime.available_resources()["GPU"],
                head.cards.free, dead_node.cards.free,
                runtime.stats()["lineage_rebuilds"]]

    assert _run(scenario, "ray_tpu_torch", num_gpus=1) == \
        [True, 2.0, True, True, 1.0, 1.0, {0: 1.0}, {0: 1.0}, 1]


def _hold_the_gil(seconds: float) -> None:
    """Stall every thread of this process: one C call that never lets
    the GIL go, sized from a timed shorter one."""
    n = 1_000_000
    start = time.perf_counter()
    sum(range(n))
    per_item = (time.perf_counter() - start) / n
    sum(range(int(seconds / per_item)))


def test_a_stalled_process_does_not_kill_its_nodes():
    """The health checks count missed checks, not seconds: a stall of
    the whole process (the GIL held for eight periods, five times) delays
    the beats and the checks alike, so no node is declared dead and work
    still runs on the head."""
    def scenario(runtime, strategy):
        for _ in range(5):
            _hold_the_gil(8 * FAST_HEALTH["health_check_period_ms"]
                          / 1000.0)
            time.sleep(0.2)
        alive = [n.alive for n in runtime.gcs.list_nodes()]
        done = runtime.submit_task(lambda: "ran", (), {}, name="after",
                                   resources={"CPU": 1.0})
        return [alive, runtime.get(done, timeout=WAIT_S)[0]]

    assert _run(scenario, "ray_tpu_torch") == [[True], "ran"]
