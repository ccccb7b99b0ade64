"""The port's core runtime (tasks, objects, resources) against the JAX
package's.

Each mirrored case is a scenario that runs once through ``ray_tpu`` and
once through ``ray_tpu_torch``, each under its own ``init(num_cpus=8)``
and ``shutdown()``. It returns a plain record (values, exception class
names, ``.cause`` types, resource dicts, readiness flags); the two records
must be equal, and equal to what the mirrored test of
tests/test_core_tasks.py asserts. Waits that the reference tests spend in
``time.sleep`` are events and barriers here.

The port-only cases at the end each state where the port deliberately
differs from the reference: ``num_gpus`` demands ``GPU`` (not ``TPU``),
the head node's ``GPU`` count is detected, ``_sizeof`` counts tensors, a
``put`` keeps the tensor itself, and an infeasible ``GPU`` demand warns.
"""

import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStore, _on_device, _sizeof
from ray_tpu_torch.parallel.train_step import TrainState

RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
WAIT_S = 10.0  # bound on every event and barrier wait


def _run(scenario, rt, **init):
    rt.shutdown()
    rt.init(**{"num_cpus": 8, **init})
    try:
        return scenario(rt)
    finally:
        rt.shutdown()


def _error(fn) -> "tuple | None":
    """(class name, .cause class name) of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        cause = getattr(exc, "cause", None)
        return type(exc).__name__, type(cause).__name__ if cause else None
    return None


# ------------------------------------------------ mirrored: test_core_tasks


def put_get(rt):
    return rt.get(rt.put(42))


def put_get_list(rt):
    return rt.get([rt.put(i) for i in range(10)])


def simple_task(rt):
    @rt.remote
    def f(x):
        return x * 2

    return rt.get(f.remote(21))


def task_with_kwargs(rt):
    @rt.remote
    def f(a, b=10, *, c=100):
        return a + b + c

    return rt.get(f.remote(1, b=2, c=3))


def task_dependency_chain(rt):
    @rt.remote
    def inc(x):
        return x + 1

    ref = rt.put(0)
    for _ in range(10):
        ref = inc.remote(ref)
    return rt.get(ref)


def task_fan_out_fan_in(rt):
    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    def total(*xs):
        return sum(xs)

    return rt.get(total.remote(*[square.remote(i) for i in range(10)]))


def nested_tasks(rt):
    @rt.remote
    def child(x):
        return x + 1

    @rt.remote
    def parent(x):
        return rt.get(child.remote(x)) + 1

    return rt.get(parent.remote(0))


def deeply_nested_tasks_no_deadlock(rt):
    @rt.remote
    def recurse(depth):
        if depth == 0:
            return 0
        return rt.get(recurse.remote(depth - 1)) + 1

    # Deeper than num_cpus=8: passes only if blocked tasks give their CPU
    # back.
    return rt.get(recurse.remote(20), timeout=60)


def num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    return rt.get(list(three.remote()))


def task_error_propagation(rt):
    @rt.remote
    def fail():
        raise ValueError("boom")

    ref = fail.remote()
    try:
        rt.get(ref)
    except rt.exceptions.TaskError as exc:
        return ["boom" in str(exc), type(exc.cause).__name__]
    return None


def error_propagates_through_dependency(rt):
    @rt.remote
    def fail():
        raise ValueError("boom")

    @rt.remote
    def consume(x):
        return x

    return _error(lambda: rt.get(consume.remote(fail.remote())))


def get_timeout(rt):
    release = threading.Event()

    @rt.remote
    def slow():
        release.wait(WAIT_S)

    ref = slow.remote()
    try:
        return _error(lambda: rt.get(ref, timeout=0.2))
    finally:
        release.set()


def wait(rt):
    release = threading.Event()

    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        release.wait(WAIT_S)
        return "slow"

    fast_ref, slow_ref = fast.remote(), slow.remote()
    try:
        ready, not_ready = rt.wait([fast_ref, slow_ref], num_returns=1,
                                   timeout=2.0)
        return [ready == [fast_ref], not_ready == [slow_ref]]
    finally:
        release.set()


def wait_timeout_returns_partial(rt):
    release = threading.Event()

    @rt.remote
    def slow():
        release.wait(WAIT_S)

    try:
        ready, not_ready = rt.wait([slow.remote()], num_returns=1,
                                   timeout=0.1)
        return [len(ready), len(not_ready)]
    finally:
        release.set()


def options_override(rt):
    @rt.remote(num_cpus=1)
    def f():
        return 1

    return rt.get(f.options(num_cpus=2, name="custom").remote())


def retries(rt):
    attempts = []
    lock = threading.Lock()

    @rt.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        with lock:
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("transient")
        return "ok"

    return [rt.get(flaky.remote()), len(attempts)]


def calling_remote_function_directly_raises(rt):
    @rt.remote
    def f():
        return 1

    return _error(f)


def parallelism(rt):
    # 8 tasks on 8 CPUs meet at one barrier: they pass only if all 8 run
    # at once.
    barrier = threading.Barrier(8, timeout=WAIT_S)

    @rt.remote
    def meet():
        barrier.wait()
        return 1

    return sum(rt.get([meet.remote() for _ in range(8)]))


def resource_limit_enforced(rt):
    running, peak = [], []
    lock = threading.Lock()
    pair = threading.Barrier(2, timeout=WAIT_S)

    @rt.remote(num_cpus=4)
    def heavy(idx):
        with lock:
            running.append(idx)
            peak.append(len(running))
        pair.wait()  # two at a time fit on 8 CPUs
        with lock:
            running.remove(idx)
        return idx

    return [rt.get([heavy.remote(i) for i in range(4)]), max(peak)]


def object_ref_in_container_not_resolved(rt):
    @rt.remote
    def f(container):
        (ref,) = container
        return rt.get(ref) + 1

    return rt.get(f.remote([rt.put(1)]))


def cluster_resources(rt):
    return rt.cluster_resources()


def nodes_listing(rt):
    listing = rt.nodes()
    return [len(listing), listing[0]["Alive"]]


def timeline_records_tasks(rt):
    @rt.remote
    def f():
        return 1

    rt.get(f.remote())
    return any(e["name"].endswith("f") for e in rt.timeline())


def runtime_context_inside_task(rt):
    @rt.remote
    def whoami():
        return rt.get_runtime_context().get_task_id()

    task_id = rt.get(whoami.remote())
    return task_id is not None and len(task_id) == 32


def cancel_pending_task(rt):
    release, started = threading.Event(), threading.Event()

    @rt.remote(num_cpus=8)
    def blocker():
        started.set()
        release.wait(WAIT_S)
        return "done"

    @rt.remote(num_cpus=8)
    def queued():
        return "ran"

    blocker_ref = blocker.remote()
    started.wait(WAIT_S)
    queued_ref = queued.remote()  # stuck behind blocker (8/8 CPUs)
    rt.cancel(queued_ref)
    release.set()
    return [rt.get(blocker_ref),
            _error(lambda: rt.get(queued_ref, timeout=5))]


def cancel_running_task_is_noop(rt):
    release, started = threading.Event(), threading.Event()

    @rt.remote
    def running():
        started.set()
        release.wait(WAIT_S)
        return "finished"

    ref = running.remote()
    started.wait(WAIT_S)
    rt.cancel(ref)  # already running: best-effort no-op
    release.set()
    return rt.get(ref)


# Each scenario and what the mirrored reference test asserts of it.
TASK_CASES = {
    put_get: 42,
    put_get_list: list(range(10)),
    simple_task: 42,
    task_with_kwargs: 6,
    task_dependency_chain: 10,
    task_fan_out_fan_in: sum(i * i for i in range(10)),
    nested_tasks: 2,
    deeply_nested_tasks_no_deadlock: 20,
    num_returns: [1, 2, 3],
    task_error_propagation: [True, "ValueError"],
    error_propagates_through_dependency: ("TaskError", "ValueError"),
    get_timeout: ("GetTimeoutError", None),
    wait: [True, True],
    wait_timeout_returns_partial: [0, 1],
    options_override: 1,
    retries: ["ok", 3],
    calling_remote_function_directly_raises: ("TypeError", None),
    parallelism: 8,
    resource_limit_enforced: [[0, 1, 2, 3], 2],
    object_ref_in_container_not_resolved: 2,
    cluster_resources: {"CPU": 8.0},
    nodes_listing: [1, True],
    timeline_records_tasks: True,
    runtime_context_inside_task: True,
    cancel_pending_task: ["done", ("TaskCancelledError", None)],
    cancel_running_task_is_noop: "finished",
}


@pytest.mark.parametrize("scenario", list(TASK_CASES),
                         ids=lambda f: f.__name__)
def test_task_parity(scenario):
    records = {name: _run(scenario, rt) for name, rt in RUNTIMES.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"]
    assert records["ray_tpu_torch"] == TASK_CASES[scenario]


# ------------------------------------------------------------- port only


def test_num_gpus_demands_gpu_not_tpu():
    """Deliberate difference: the reference folds ``num_gpus`` into
    ``TPU``; the port schedules a ``GPU`` resource. ``num_tpus`` keeps
    its meaning in both."""
    def f():
        return 1

    def demand(rt, **opts):
        return rt.remote(**opts)(f)._call_kwargs["resources"]

    assert demand(ray_tpu, num_gpus=1) == {"CPU": 1.0, "TPU": 1.0}
    assert demand(ray_tpu_torch, num_gpus=1) == {"CPU": 1.0, "GPU": 1.0}
    assert demand(ray_tpu_torch, num_tpus=2) == {"CPU": 1.0, "TPU": 2.0}
    assert demand(ray_tpu_torch, num_gpus=0.5, num_cpus=0) == {"GPU": 0.5}


def test_gpu_detection(monkeypatch):
    """The head node's ``GPU`` is ``torch.cuda.device_count()``, which
    the reference's TPU-only detection never reports; the override and the
    skip flag mirror ``RAY_TPU_NUM_TPU_CHIPS`` and
    ``RAY_TPU_SKIP_TPU_DETECTION``."""
    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS", raising=False)
    monkeypatch.delenv("RAY_TPU_TORCH_SKIP_GPU_DETECTION", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert accelerators.detect_resources() == {"GPU": 2.0}
    resources = _run(lambda rt: rt.cluster_resources(), ray_tpu_torch)
    assert resources == {"CPU": 8.0, "GPU": 2.0}
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "3")
    assert accelerators.detect_resources() == {"GPU": 3.0}
    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS")
    monkeypatch.setenv("RAY_TPU_TORCH_SKIP_GPU_DETECTION", "1")
    assert accelerators.detect_resources() == {}
    monkeypatch.delenv("RAY_TPU_TORCH_SKIP_GPU_DETECTION")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert _run(lambda rt: rt.cluster_resources(), ray_tpu_torch) \
        == {"CPU": 8.0}
    # init(num_gpus=) wins over detection.
    assert _run(lambda rt: rt.cluster_resources(), ray_tpu_torch,
                num_gpus=1) == {"CPU": 8.0, "GPU": 1.0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.int64],
                         ids=str)
def test_sizeof_counts_tensor_bytes(dtype):
    """The reference counts any ``torch.Tensor`` as 64 bytes; the port
    counts ``numel() * element_size()`` (a strided view: its elements)."""
    t = torch.zeros((3, 5, 7), dtype=dtype)
    assert _sizeof(t) == 105 * t.element_size()
    assert _sizeof(t[:, ::2]) == 3 * 3 * 7 * t.element_size()


def test_sizeof_counts_a_parameter_tree_at_its_leaves_bytes():
    """A nested dict of tensors is charged exactly the sum of its leaves'
    ``nbytes`` (the reference adds 64 bytes and the keys per dict and 64
    per tensor)."""
    tree = {"embed": {"tokens": torch.zeros((11, 8), dtype=torch.bfloat16)},
            "layers": {"wq": torch.zeros((2, 8, 8)),
                       "attn_norm": torch.ones((2, 8), dtype=torch.float16)},
            "final_norm": torch.ones(8)}
    nbytes = 11 * 8 * 2 + 2 * 8 * 8 * 4 + 2 * 8 * 2 + 8 * 4
    assert _sizeof(tree) == nbytes
    assert _sizeof([np.zeros(4, np.float32), torch.zeros(2)]) == 16 + 8


def test_put_keeps_the_tensor_and_charges_its_bytes():
    """``put`` seals the tensor itself: ``get`` and a task's argument see
    the same storage (``data_ptr()``), and the store is charged
    ``nbytes``."""
    def scenario(rt):
        runtime = ray_tpu_torch._private.worker.global_runtime()
        tree = {"w": torch.arange(12.0).reshape(3, 4),
                "b": {"x": torch.ones(5, dtype=torch.bfloat16)}}
        before = runtime.store.stats()["memory_used_bytes"]
        ref = rt.put(tree)
        charged = runtime.store.stats()["memory_used_bytes"] - before

        @rt.remote
        def pointers(t):
            return t["w"].data_ptr(), t["b"]["x"].data_ptr()

        got = rt.get(ref)
        return [charged, got["w"] is tree["w"],
                rt.get(pointers.remote(ref)) == (tree["w"].data_ptr(),
                                                 tree["b"]["x"].data_ptr())]

    assert _run(scenario, ray_tpu_torch) == [48 + 10, True, True]


def test_objects_on_a_device_are_charged_but_never_spilled():
    """Past the budget, an object holding a tensor outside host memory
    stays where it is (the same tensor comes back), is charged its bytes,
    and pushes no host object out: only host objects count against the
    budget. ``meta`` tensors stand in here for tensors on a card."""
    def scenario(rt):
        runtime = ray_tpu_torch._private.worker.global_runtime()
        weights = {"w": torch.empty(16384, device="meta"),
                   "b": torch.zeros(4)}
        ref = rt.put(weights)
        host = rt.put(torch.ones(4096))
        stats = runtime.store.stats()
        return [stats["memory_used_bytes"], stats["device_bytes"],
                stats["spilled_bytes_total"], rt.get(ref)["w"] is weights["w"],
                rt.get(host).sum().item()]

    assert _run(scenario, ray_tpu_torch, object_store_memory=30_000) == \
        [65536 + 16 + 16384, 65536 + 16, 0, True, 4096.0]


def _store_scenario(tmp_path, device_object) -> list:
    """ROADMAP queue 3's steps on an ``ObjectStore`` of 1 MiB: ``put``
    the object beside a 800,000-byte batch, then a 1,600,000-byte array.
    [charged, on_device, device_bytes, spilled_bytes_total, the first
    object's spill path, files left in the spill directory, the same
    object back]."""
    store = ObjectStore(1 << 20, str(tmp_path))
    first, second = ObjectID(), ObjectID()
    value = {"state": device_object, "batch": np.zeros(200_000, np.int32)}
    store.put(first, value)
    store.put(second, np.zeros(400_000, np.int32))
    entry = store._entries[first]
    stats = store.stats()
    files = sorted(os.listdir(tmp_path)) if tmp_path.exists() else []
    return [entry.size_bytes, entry.on_device, stats["device_bytes"],
            stats["spilled_bytes_total"], entry.spilled_path,
            files == [second.hex()], store.get(first) is value]


def test_a_train_state_holding_a_device_tensor_is_charged_and_never_spilled(
        tmp_path):
    """A dataclass (the port's ``TrainState``) holding a tensor on a card
    is charged its leaves' bytes and stays in memory; only the host array
    put after it spills. The parent store saw 64 bytes of host memory
    there and pickled the tensor to disk."""
    state = TrainState(params={"w": torch.empty(1 << 20, device="meta")},
                       opt_state={})
    assert _sizeof(state) == (4 << 20) + 64 and _on_device(state)
    charged = (4 << 20) + 64 + 800_000
    assert _store_scenario(tmp_path, state) == \
        [charged, True, charged, 1_600_000, None, True, True]


def test_a_list_of_1100_device_tensors_is_charged_and_never_spilled(tmp_path):
    """No entry cap: a list past 1,024 entries is walked (the parent
    charged it 64 bytes and spilled it)."""
    tensors = [torch.empty(1024, device="meta") for _ in range(1100)]
    assert _sizeof(tensors) == 1100 * 4096 and _on_device(tensors)
    charged = 1100 * 4096 + 800_000
    assert _store_scenario(tmp_path, tensors) == \
        [charged, True, charged, 1_600_000, None, True, True]


class _Slotted:
    """Holds a tensor where the size walk does not look."""

    __slots__ = ("tensor", "me")

    def __init__(self, tensor):
        self.tensor, self.me = tensor, self


def test_the_spill_refuses_a_device_tensor_the_size_walk_cannot_see(tmp_path):
    """The pickle of a spill raises on a tensor outside host memory: the
    object stays in memory, its bytes move to ``device_bytes`` and no
    partial file is left. A self-referencing object ends the walk."""
    class Cyclic:
        pass

    cyclic = Cyclic()
    cyclic.me, cyclic.data = cyclic, np.zeros(4, np.int64)
    assert _sizeof(cyclic) == 32 and not _on_device([cyclic, {"c": cyclic}])
    hidden = _Slotted(torch.empty(1 << 20, device="meta"))
    assert _sizeof(hidden) == 64 and not _on_device(hidden)
    charged = 64 + 800_000
    assert _store_scenario(tmp_path, hidden) == \
        [charged, True, charged, 1_600_000, None, True, True]


def test_infeasible_gpu_demand_warns_and_never_runs(caplog):
    """On a machine without a card a ``num_gpus=1`` task cannot be placed:
    the dispatcher warns once and the task waits (it never moves to the
    CPU), while other work goes on."""
    def scenario(rt):
        ran = threading.Event()

        @rt.remote(num_gpus=1)
        def on_card():
            ran.set()

        @rt.remote
        def on_cpu():
            return "cpu"

        with caplog.at_level(logging.WARNING, logger="ray_tpu_torch"):
            ref = on_card.remote()
            ready, _ = rt.wait([ref], timeout=0.5)
            warned = [r.getMessage() for r in caplog.records
                      if "can ever satisfy" in r.getMessage()]
        return [ready, ran.is_set(), rt.get(on_cpu.remote()),
                len(warned), "'GPU': 1.0" in warned[0]]

    assert _run(scenario, ray_tpu_torch) == [[], False, "cpu", 1, True]


def test_gpu_task_holds_its_gpu_and_sees_it_assigned():
    """With a ``GPU`` in the cluster (``init(num_gpus=1)``), a
    ``num_gpus=1`` task holds it while it runs and sees it in
    ``get_assigned_resources()`` (the reference gives ``{}`` there); a
    second one waits for it, and CPU tasks are not held back."""
    def scenario(rt):
        release, started = threading.Event(), threading.Event()

        @rt.remote(num_gpus=1)
        def hold():
            started.set()
            release.wait(WAIT_S)
            return rt.get_runtime_context().get_assigned_resources()

        first = hold.remote()
        started.wait(WAIT_S)
        second = hold.remote()
        during = rt.available_resources()["GPU"]
        blocked, _ = rt.wait([second], timeout=0.3)

        @rt.remote
        def cpu():
            return 1

        cpu_ok = rt.get(cpu.remote(), timeout=WAIT_S)
        release.set()
        return [during, blocked, cpu_ok, rt.get(first), rt.get(second),
                rt.available_resources()["GPU"]]

    assigned = {"CPU": 1.0, "GPU": 1.0}
    assert _run(scenario, ray_tpu_torch, num_gpus=1) == \
        [0.0, [], 1, assigned, assigned, 1.0]


def test_deadline_expired_in_the_queue_seals_typed():
    """A task whose budget dies while it waits for its resources seals
    ``TaskTimeoutError`` at the same stage in both runtimes."""
    def scenario(rt):
        release, started = threading.Event(), threading.Event()

        @rt.remote(num_cpus=8)
        def blocker():
            started.set()
            release.wait(WAIT_S)

        @rt.remote(num_cpus=8)
        def late():
            return "ran"

        first = blocker.remote()
        started.wait(WAIT_S)
        ref = late.options(_deadline_s=0.2).remote()
        try:
            rt.get(ref, timeout=WAIT_S)
        except rt.exceptions.TaskTimeoutError as exc:
            return [exc.stage, type(exc.cause).__name__]
        finally:
            release.set()
            rt.get(first)

    records = {name: _run(scenario, rt) for name, rt in RUNTIMES.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["queued", "TimeoutError"]


def test_object_ref_future_and_await():
    """``ObjectRef.future()`` and ``await ref`` resolve to the value."""
    import asyncio

    def scenario(rt):
        @rt.remote
        def f(x):
            return x + 1

        async def awaited():
            return await f.remote(2)

        return [f.remote(1).future().result(timeout=WAIT_S),
                asyncio.run(awaited())]

    records = {name: _run(scenario, rt) for name, rt in RUNTIMES.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [2, 3]


def test_free_and_spill_restore():
    """A freed object raises ``ObjectFreedError``; past the store's
    budget the oldest object is pickled to disk and restored on ``get``
    (a tensor comes back equal). Pinned to the inline spill
    (``spill_enabled=False``), which spills within the ``put``; the
    managed tier's twin follows."""
    def scenario(rt):
        runtime = ray_tpu_torch._private.worker.global_runtime()
        first = rt.put(torch.arange(4096.0))
        second = rt.put(torch.ones(4096))
        spilled = runtime.store.stats()["spilled_bytes_total"]
        value = rt.get(first)
        freed = rt.put(1)
        runtime.free([freed])
        return [spilled, bool(torch.equal(value, torch.arange(4096.0))),
                runtime.store.stats()["restored_bytes_total"],
                rt.get(second).sum().item(),
                _error(lambda: rt.get(freed))]

    try:
        assert _run(scenario, ray_tpu_torch, object_store_memory=30_000,
                    system_config={"spill_enabled": False}) == \
            [16384, True, 16384, 4096.0, ("ObjectFreedError", None)]
    finally:
        ray_tpu_torch._private.config.GLOBAL_CONFIG.reset()


def test_free_and_managed_spill_restore():
    """The twin through the managed tier: over its high watermark
    (25,500 of 30,000 bytes) the spiller moves the least recently used of
    the two equal tensors to a checksummed file, off the ``put``; a
    ``get`` checks and restores it."""
    def scenario(rt):
        runtime = ray_tpu_torch._private.worker.global_runtime()
        first = rt.put(torch.arange(4096.0))
        second = rt.put(torch.ones(4096))
        runtime.store._spill.spill_pass()
        deadline = time.monotonic() + WAIT_S
        while runtime.spill_stats()["spills"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        spilled = runtime.store.stats()["spilled_bytes_total"]
        on_disk = runtime.store._entries[first.id()].spilled_path
        value = rt.get(first)
        restored = runtime.store.stats()["restored_bytes_total"]
        freed = rt.put(1)
        runtime.free([freed])
        return [spilled, on_disk is not None and on_disk.endswith(".spill"),
                bool(torch.equal(value, torch.arange(4096.0))), restored,
                runtime.spill_stats()["restores"],
                rt.get(second).sum().item(), _error(lambda: rt.get(freed))]

    assert _run(scenario, ray_tpu_torch, object_store_memory=30_000) == \
        [16384, True, True, 16384, 1, 4096.0, ("ObjectFreedError", None)]


def test_dispatcher_wait_idle():
    """``Dispatcher.wait_idle`` returns False while a task runs and True
    once every queued and running task has finished."""
    def scenario(rt):
        dispatcher = ray_tpu_torch._private.worker.global_runtime().dispatcher
        release = threading.Event()

        @rt.remote
        def hold():
            release.wait(WAIT_S)

        ref = hold.remote()
        busy = dispatcher.wait_idle(timeout=0.1)
        release.set()
        rt.get(ref)
        return [busy, dispatcher.wait_idle(timeout=WAIT_S)]

    assert _run(scenario, ray_tpu_torch) == [False, True]


def test_gcs_kv_store_parity():
    """The control plane's namespaced key-value store answers as the
    reference's does."""
    def scenario(rt):
        kv = rt._private.worker.global_runtime().gcs.kv
        return [kv.put(b"a/1", b"x"), kv.put(b"a/1", b"y", overwrite=False),
                kv.put(b"a/2", b"z", namespace="other"), kv.get(b"a/1"),
                kv.exists(b"a/2"), sorted(kv.keys(b"a/", "other")),
                kv.delete(b"a/1"), kv.delete(b"a/1"), kv.get(b"a/1")]

    records = {name: _run(scenario, rt) for name, rt in RUNTIMES.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, False, True, b"x", False, [b"a/2"], True, False, None]
