"""The port's remote actors against the JAX package's: actors live on
worker-node daemons, not in the driver, and restart on a surviving node
when theirs dies (the cases of tests/test_remote_actors.py).

Each mirrored case runs once against a ``ray_tpu`` cluster and once
against a ``ray_tpu_torch`` one (torch_cluster_sides.py) and returns a
plain record; the records must be equal, and equal to what the reference
test asserts. Cases that kill no node share one module-scoped cluster
per package and kill the actors they made; the node-kill case and the
one-CPU case start their own. Waits are deadlines, not sleeps.

Where the port deliberately differs:

- an actor asks for ``GPU``, not ``TPU``; a ``GPU`` actor on a node
  boots a fresh interpreter that sees only its leased cards and is never
  forked from the daemon (the port-only case at the end; here
  ``RAY_TPU_TORCH_NUM_GPUS`` stands for a card);
- the head has no persistence or restart epochs, and nodes no same-host
  plane (ROADMAP item 10b);
- the actor table is read from the driver's own records: the port has no
  ``util.state`` yet (item 12);
- the node tag is ``RAY_TPU_TORCH_NODE_TAG``.
"""

import os
import time

import pytest

from torch_cluster_sides import both, start_clusters, stop_clusters, wait_until


@pytest.fixture(scope="module")
def actor_cluster(tmp_path_factory):
    sides = start_clusters(tmp_path_factory.mktemp("ractor"),
                           [{"num_cpus": 2}, {"num_cpus": 2}],
                           heartbeat_timeout_s=5.0)
    yield sides
    stop_clusters({name: side.cluster for name, side in sides.items()})


def _parent_pid(pid: int) -> int:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("PPid:"):
                return int(line.split()[1])
    raise RuntimeError(f"no PPid for {pid}")


# ------------------------- mirrored, a cluster of their own (run first)


def restart_on_survivor(side) -> dict:
    node_a = side.remote_node_ids()[0]
    tag_env = side.tag_env

    @side.rt.remote(num_cpus=1, max_restarts=2, scheduling_strategy=(
        side.affinity(node_id=node_a.hex(), soft=False)))
    class Survivor:
        def tag(self):
            import os

            return os.environ.get(tag_env)

    actor = Survivor.remote()
    first_tag = side.rt.get(actor.tag.remote(), timeout=60)
    with side.runtime._remote_nodes_lock:
        handle = side.runtime._remote_nodes[node_a]
    victim_pid = handle.pool.call("exec_ping")
    victim = next(n for n in side.cluster.worker_nodes
                  if n.pid == victim_pid)
    side.cluster.remove_node(victim, allow_graceful=False)
    # Calls fail while the actor is dead, then succeed on the survivor.
    deadline = time.monotonic() + 90
    new_tag = None
    while new_tag is None and time.monotonic() < deadline:
        try:
            new_tag = side.rt.get(actor.tag.remote(), timeout=15)
        except Exception:  # noqa: BLE001 — the dead window
            time.sleep(0.2)
    return {"first_on_daemon": first_tag is not None,
            "came_back": new_tag is not None,
            "moved": new_tag != first_tag}


def test_actor_restarts_on_survivor_after_daemon_kill(tmp_path):
    sides = start_clusters(tmp_path, [{"num_cpus": 2}, {"num_cpus": 2}],
                           heartbeat_timeout_s=5.0)
    try:
        assert both(restart_on_survivor, sides) == {
            "first_on_daemon": True, "came_back": True, "moved": True}
    finally:
        stop_clusters({n: s.cluster for n, s in sides.items()})


def nested_get_one_cpu(side) -> dict:
    @side.rt.remote
    def inner(x):
        return x * 2

    @side.rt.remote
    def outer(x, rt_name):
        import importlib

        rt = importlib.import_module(rt_name)
        return rt.get(inner.remote(x)) + 1

    return {"value": side.rt.get(outer.remote(10, side.name), timeout=90)}


def test_nested_get_releases_daemon_admission(tmp_path):
    """One daemon of one CPU: a parent blocked in get() on its child gives
    the CPU back, so the child is admitted (no deadlock)."""
    sides = start_clusters(tmp_path, [{"num_cpus": 1, "pool_size": 1}])
    try:
        assert both(nested_get_one_cpu, sides) == {"value": 21}
    finally:
        stop_clusters({n: s.cluster for n, s in sides.items()})


# --------------------------------------------------------------- port only


def test_gpu_actor_boots_a_fresh_interpreter_on_its_card(tmp_path):
    """A ``num_gpus=1`` actor on a node runs in a fresh interpreter the
    daemon started (its parent is the daemon, not the fork server), sees
    only its card, and holds the node's GPU until it is killed."""
    sides = start_clusters(
        tmp_path, [{"num_cpus": 2, "resources": {"GPU": 1},
                    "env": {"RAY_TPU_TORCH_NUM_GPUS": "1"}}],
        names=("ray_tpu_torch",))
    side = sides["ray_tpu_torch"]
    try:
        rt = side.rt

        @rt.remote(num_gpus=1)
        class OnCard:
            def where(self):
                import os

                return os.getpid(), os.environ["CUDA_VISIBLE_DEVICES"]

        actor = OnCard.remote()
        pid, visible = rt.get(actor.where.remote(), timeout=120)
        assert visible == "0"
        assert _parent_pid(pid) == side.cluster.worker_nodes[0].pid
        assert rt.available_resources().get("GPU") == 0.0
        rt.kill(actor)
        assert wait_until(lambda: rt.available_resources().get("GPU")
                          == 1.0)
    finally:
        stop_clusters({"ray_tpu_torch": side.cluster})


def test_a_node_death_is_one_restart_with_calls_in_flight(tmp_path):
    """With ``max_restarts=1`` the actor comes back on the survivor even
    when calls keep going while its node is killed: a call that finds
    the dead node while the restart is under way waits for the new node,
    and is not counted as a second crash."""
    import threading

    sides = start_clusters(tmp_path, [{"num_cpus": 2}, {"num_cpus": 2}],
                           heartbeat_timeout_s=5.0,
                           names=("ray_tpu_torch",))
    side = sides["ray_tpu_torch"]
    try:
        rt, runtime = side.rt, side.runtime
        node_a = side.remote_node_ids()[0]
        tag_env = side.tag_env

        @rt.remote(num_cpus=1, max_restarts=1, scheduling_strategy=(
            side.affinity(node_id=node_a.hex(), soft=False)))
        class Survivor:
            def tag(self):
                import os

                return os.environ.get(tag_env)

        actor = Survivor.remote()
        first = rt.get(actor.tag.remote(), timeout=60)
        stop, seen = threading.Event(), []

        def hammer():
            while not stop.is_set():
                try:
                    seen.append(rt.get(actor.tag.remote(), timeout=60))
                except Exception as exc:  # noqa: BLE001 — the dead window
                    seen.append(type(exc).__name__)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for thread in threads:
            thread.start()
        with runtime._remote_nodes_lock:
            handle = runtime._remote_nodes[node_a]
        victim_pid = handle.pool.call("exec_ping")
        side.cluster.remove_node(next(
            n for n in side.cluster.worker_nodes if n.pid == victim_pid),
            allow_graceful=False)
        came_back = wait_until(lambda: any(
            t not in (first, "ActorDiedError", "ActorError")
            and t is not None for t in seen[-8:]), 90)
        stop.set()
        for thread in threads:
            thread.join(timeout=60)
        record = runtime.gcs.get_actor(actor._actor_id)
        assert came_back, seen[-8:]
        assert record.state == "ALIVE" and record.num_restarts == 1
        rt.kill(actor)
    finally:
        stop_clusters({"ray_tpu_torch": side.cluster})


# ------------------- mirrored: test_remote_actors, on the shared cluster


def process_tree(side) -> dict:
    node_a = side.remote_node_ids()[0]
    tag_env = side.tag_env

    @side.rt.remote(num_cpus=1, scheduling_strategy=(
        side.affinity(node_id=node_a.hex(), soft=False)))
    class Where:
        def whoami(self):
            import os

            return os.getpid(), os.environ.get(tag_env)

    actor = Where.remote()
    pid, tag = side.rt.get(actor.whoami.remote(), timeout=60)
    daemon_pids = {n.pid for n in side.cluster.worker_nodes}
    ancestors = {_parent_pid(pid)}
    try:
        ancestors.add(_parent_pid(next(iter(ancestors))))
    except (RuntimeError, OSError):
        pass
    side.rt.kill(actor)
    return {"on_daemon": tag is not None, "not_driver": pid != os.getpid(),
            "under_a_daemon": bool(ancestors & daemon_pids)}


def test_actor_executes_in_daemon_process_tree(actor_cluster):
    assert both(process_tree, actor_cluster) == {
        "on_daemon": True, "not_driver": True, "under_a_daemon": True}


def ordering(side) -> dict:
    @side.rt.remote(num_cpus=1)
    class Counter:
        def __init__(self):
            self.value = 0
            self.history = []

        def add(self, amount):
            self.value += amount
            self.history.append(amount)
            return self.value

        def get_history(self):
            return list(self.history)

    counter = Counter.remote()
    results = side.rt.get([counter.add.remote(i) for i in range(50)],
                          timeout=120)
    history = side.rt.get(counter.get_history.remote(), timeout=60)
    side.rt.kill(counter)
    return {"results": results, "history": history}


def test_actor_state_and_call_ordering(actor_cluster):
    assert both(ordering, actor_cluster) == {
        "results": [sum(range(i + 1)) for i in range(50)],
        "history": list(range(50))}


def stays_on_driver(side) -> dict:
    sentinel = {"touched": False}

    @side.rt.remote
    class Local:
        def touch(self):
            import os

            sentinel["touched"] = True
            return os.getpid()

    actor = Local.remote()
    pid = side.rt.get(actor.touch.remote(), timeout=30)
    side.rt.kill(actor)
    return {"in_driver": pid == os.getpid(), "touched": sentinel["touched"]}


def test_zero_resource_default_actor_stays_on_driver(actor_cluster):
    assert both(stays_on_driver, actor_cluster) == {
        "in_driver": True, "touched": True}


def lease_accounting(side) -> dict:
    node_a = side.remote_node_ids()[0]

    @side.rt.remote(num_cpus=2, scheduling_strategy=(
        side.affinity(node_id=node_a.hex(), soft=False)))
    class Hog:
        def ping(self):
            return "up"

    actor = Hog.remote()
    up = side.rt.get(actor.ping.remote(), timeout=60)
    held_here = side.runtime.cluster.get_node(node_a).available.get("CPU")
    with side.runtime._remote_nodes_lock:
        handle = side.runtime._remote_nodes[node_a]
    actors_there = handle.pool.call("executor_stats")["num_actors"]
    side.rt.kill(actor)
    released = wait_until(
        lambda: side.runtime.cluster.get_node(node_a).available.get("CPU")
        == pytest.approx(2.0), 30)
    return {"up": up, "driver_ledger_after_create": held_here,
            "node_actors": actors_there, "released": released,
            "node_actors_after_kill":
                handle.pool.call("executor_stats")["num_actors"]}


def test_remote_actor_lease_accounting_is_honest(actor_cluster):
    assert both(lease_accounting, actor_cluster) == {
        "up": "up", "driver_ledger_after_create": pytest.approx(0.0),
        "node_actors": 1, "released": True, "node_actors_after_kill": 0}


def concurrency(side) -> dict:
    @side.rt.remote(num_cpus=1, max_concurrency=4)
    class Overlap:
        def __init__(self):
            import threading

            self.active = 0
            self.peak = 0
            self.lock = threading.Lock()
            self.all_in = threading.Barrier(2, timeout=10)

        def hold(self):
            with self.lock:
                self.active += 1
                self.peak = max(self.peak, self.active)
            try:
                # Two calls meet here only if they run at once.
                self.all_in.wait()
            except Exception:  # noqa: BLE001 — a broken barrier: no overlap
                pass
            with self.lock:
                self.active -= 1
            return self.peak

    actor = Overlap.remote()
    peaks = side.rt.get([actor.hold.remote() for _ in range(4)],
                        timeout=60)
    side.rt.kill(actor)
    return {"overlapped": max(peaks) >= 2}


def test_remote_actor_concurrency_overlaps_calls(actor_cluster):
    assert both(concurrency, actor_cluster) == {"overlapped": True}


def actor_error(side) -> dict:
    @side.rt.remote(num_cpus=1)
    class Boom:
        def explode(self):
            raise ValueError("remote-actor-boom")

    actor = Boom.remote()
    try:
        side.rt.get(actor.explode.remote(), timeout=60)
        record = {"raised": None}
    except Exception as exc:  # noqa: BLE001 — recorded
        record = {"raised": type(exc).__name__,
                  "is_actor_error": isinstance(
                      exc, side.exceptions().ActorError),
                  "message": "remote-actor-boom" in str(exc)}
    side.rt.kill(actor)
    return record


def test_actor_error_propagates_with_traceback(actor_cluster):
    assert both(actor_error, actor_cluster) == {
        "raised": "ActorError", "is_actor_error": True, "message": True}


def nested_submission(side) -> dict:
    node_a, node_b = side.remote_node_ids()[:2]
    tag_env = side.tag_env
    rt_name = side.name

    @side.rt.remote
    def child():
        import os

        return os.environ.get(tag_env)

    @side.rt.remote(scheduling_strategy=(
        side.affinity(node_id=node_a.hex(), soft=False)))
    def parent(other_node_hex):
        import importlib
        import os

        rt = importlib.import_module(rt_name)
        affinity = importlib.import_module(
            f"{rt_name}.util.scheduling_strategies"
        ).NodeAffinitySchedulingStrategy
        refs = [child.options(scheduling_strategy=affinity(
            node_id=other_node_hex, soft=False)).remote()
            for _ in range(3)]
        return os.environ.get(tag_env), rt.get(refs)

    my_tag, child_tags = side.rt.get(parent.remote(node_b.hex()),
                                     timeout=120)
    return {"parent_on_daemon": my_tag is not None,
            "children_on_daemons": all(t is not None for t in child_tags),
            "children_elsewhere": all(t != my_tag for t in child_tags)}


def test_nested_submission_from_daemon_task(actor_cluster):
    assert both(nested_submission, actor_cluster) == {
        "parent_on_daemon": True, "children_on_daemons": True,
        "children_elsewhere": True}


def named_actor(side) -> dict:
    @side.rt.remote(num_cpus=1, name="reg-svc")
    class Registry:
        def __init__(self):
            self.data = {}

        def set(self, k, v):
            self.data[k] = v
            return True

        def get(self, k):
            return self.data.get(k)

    actor = Registry.remote()
    stored = side.rt.get(actor.set.remote("k", 42), timeout=60)
    again = side.rt.get_actor("reg-svc")
    value = side.rt.get(again.get.remote("k"), timeout=60)
    side.rt.kill(actor)
    return {"stored": stored, "value": value}


def test_named_remote_actor_resolves(actor_cluster):
    assert both(named_actor, actor_cluster) == {"stored": True, "value": 42}


def _placement(side, actor) -> tuple:
    """(node hex, pid) the actor table records."""
    if side.name == "ray_tpu":
        from ray_tpu.util import state

        row = state.get_actor(actor._actor_id.hex())
        return row["node_id"], row["pid"]
    record = side.runtime.gcs.get_actor(actor._actor_id)
    return record.node_id_hex, record.pid


def placement(side) -> dict:
    node_a = side.remote_node_ids()[0]

    @side.rt.remote(num_cpus=1, scheduling_strategy=(
        side.affinity(node_id=node_a.hex(), soft=False)))
    class Placed:
        def pid(self):
            import os

            return os.getpid()

    actor = Placed.remote()
    remote_pid = side.rt.get(actor.pid.remote(), timeout=60)
    node_hex, pid = _placement(side, actor)

    @side.rt.remote
    class Local:
        def ping(self):
            return "ok"

    local = Local.remote()
    side.rt.get(local.ping.remote(), timeout=30)
    local_node, _ = _placement(side, local)
    side.rt.kill(actor)
    side.rt.kill(local)
    return {"remote_node": node_hex == node_a.hex(),
            "remote_pid": pid == remote_pid,
            "local_on_driver_node":
                local_node == side.runtime.head_node_id.hex()}


def test_actor_table_records_placement(actor_cluster):
    assert both(placement, actor_cluster) == {
        "remote_node": True, "remote_pid": True,
        "local_on_driver_node": True}


@pytest.mark.parametrize("slowed", ["ray_tpu_torch-ractor-create-",
                                    "ray_tpu_torch-actor-create-"],
                         ids=["creation_reply", "actor_start"])
def test_actor_results_wait_for_the_actors_placement(actor_cluster,
                                                     monkeypatch, slowed):
    """Port only: the actor table has an actor's node and pid once any of
    its results is seen, with the driver's recording slowed by a second
    in one thread. ``creation_reply``: a call sent behind its remote
    actor's creation is answered once the constructor ran, which can be
    before the driver has taken in the creation's reply; its result is
    sealed after that reply. ``actor_start``: a local actor is recorded
    before it takes calls."""
    import threading

    side = actor_cluster["ray_tpu_torch"]
    runtime_cls = type(side.runtime)
    record = runtime_cls._record_actor_placement

    def slow_record(self, actor):
        if threading.current_thread().name.startswith(slowed):
            time.sleep(1.0)
        record(self, actor)

    monkeypatch.setattr(runtime_cls, "_record_actor_placement", slow_record)
    assert placement(side) == {"remote_node": True, "remote_pid": True,
                               "local_on_driver_node": True}
