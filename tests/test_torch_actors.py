"""The port's actors against the JAX package's.

Each mirrored case is a scenario that runs once through ``ray_tpu`` and
once through ``ray_tpu_torch``, each under its own ``init(num_cpus=8)``
and ``shutdown()``, and returns a plain record (values, exception class
names, ``.cause`` types, resource dicts); the two records must be equal,
and equal to what the mirrored test of tests/test_core_actors.py asserts.
The reference tests' sleeps that prove concurrency are barriers here.

The port-only cases at the end state where the port differs: an actor's
``GPU`` lease, and the runtime context inside an actor (the reference
sets none for in-process actors).
"""

import asyncio
import gc
import threading
import time
import weakref

import pytest
import torch

import ray_tpu
import ray_tpu_torch

RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
WAIT_S = 10.0  # bound on every barrier and poll


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


class Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value

    def get_value(self):
        return self.value

    def fail(self):
        raise RuntimeError("method failure")


def _counter(rt, **options):
    cls = rt.remote(Counter)
    return cls.options(**options).remote() if options else cls.remote()


# ------------------------------------------------ mirrored: test_core_actors


def actor_basic(rt):
    counter = _counter(rt)
    return [rt.get(counter.increment.remote()),
            rt.get(counter.increment.remote(5)),
            rt.get(counter.get_value.remote())]


def actor_constructor_args(rt):
    return rt.get(rt.remote(Counter).remote(start=100).get_value.remote())


def actor_ordered_execution(rt):
    counter = _counter(rt)
    return rt.get([counter.increment.remote() for _ in range(50)])


def actor_method_error_keeps_actor_alive(rt):
    counter = _counter(rt)
    first = rt.get(counter.increment.remote())
    error = _error(lambda: rt.get(counter.fail.remote()))
    return [first, error, rt.get(counter.increment.remote())]


def actor_constructor_failure(rt):
    @rt.remote
    class Broken:
        def __init__(self):
            raise ValueError("bad init")

        def ping(self):
            return "pong"

    return _error(lambda: rt.get(Broken.remote().ping.remote(),
                                 timeout=WAIT_S))


def kill_actor(rt):
    counter = _counter(rt)
    rt.get(counter.increment.remote())
    rt.kill(counter)
    return _error(lambda: rt.get(counter.increment.remote(), timeout=WAIT_S))


def exit_actor(rt):
    @rt.remote
    class Quitter:
        def quit(self):
            rt.exit_actor()

        def ping(self):
            return "pong"

    quitter = Quitter.remote()
    pong = rt.get(quitter.ping.remote())
    rt.get(quitter.quit.remote())
    return [pong, _error(lambda: rt.get(quitter.ping.remote(),
                                        timeout=WAIT_S))]


def named_actor(rt):
    _counter(rt, name="global_counter")
    handle = rt.get_actor("global_counter")
    return rt.get(handle.increment.remote())


def named_actor_duplicate_raises(rt):
    _counter(rt, name="dup")
    return _error(lambda: _counter(rt, name="dup"))


def get_if_exists(rt):
    a = _counter(rt, name="shared", get_if_exists=True)
    rt.get(a.increment.remote())
    b = _counter(rt, name="shared", get_if_exists=True)
    return rt.get(b.get_value.remote())


def get_missing_named_actor_raises(rt):
    return _error(lambda: rt.get_actor("does_not_exist"))


def actor_handle_serialization(rt):
    counter = _counter(rt)
    rt.get(counter.increment.remote())

    @rt.remote
    def use_handle(handle):
        return rt.get(handle.increment.remote())

    return rt.get(use_handle.remote(counter))


def actor_max_concurrency(rt):
    # 4 calls meet at one barrier: they pass only if all 4 run at once.
    barrier = threading.Barrier(4, timeout=WAIT_S)

    @rt.remote(max_concurrency=4)
    class Parallel:
        def meet(self):
            barrier.wait()
            return 1

    actor = Parallel.remote()
    return sum(rt.get([actor.meet.remote() for _ in range(4)]))


def async_actor(rt):
    @rt.remote(max_concurrency=8)
    class AsyncActor:
        def __init__(self):
            self.arrived = 0

        async def work(self, x):
            # Every call waits until all 8 are in: they pass only if the
            # loop runs them at once.
            self.arrived += 1
            for _ in range(int(WAIT_S / 0.01)):
                if self.arrived >= 8:
                    return x * 2
                await asyncio.sleep(0.01)
            return None

    actor = AsyncActor.remote()
    return rt.get([actor.work.remote(i) for i in range(8)])


def actor_resource_release_on_death(rt):
    @rt.remote(num_cpus=8)
    class Hog:
        def ping(self):
            return "pong"

    hog = Hog.remote()
    pong = rt.get(hog.ping.remote())
    held = rt.available_resources().get("CPU", 0)
    rt.kill(hog)
    return [pong, held, rt.available_resources().get("CPU", 0)]


def actor_restart(rt):
    @rt.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.state = "alive"

        def ping(self):
            return self.state

    phoenix = Phoenix.remote()
    before = rt.get(phoenix.ping.remote())
    rt.kill(phoenix, no_restart=False)
    return [before, rt.get(phoenix.ping.remote(), timeout=WAIT_S)]


def actor_pass_objectref_arg(rt):
    return rt.get(_counter(rt).increment.remote(rt.put(10)))


def method_num_returns(rt):
    @rt.remote
    class Multi:
        @rt.method(num_returns=2)
        def pair(self):
            return 1, 2

    a, b = Multi.remote().pair.remote()
    return rt.get([a, b])


def restarted_actor_keeps_name_and_resources(rt):
    @rt.remote(num_cpus=2, max_restarts=1)
    class Phoenix:
        def ping(self):
            return "alive"

    phoenix = Phoenix.options(name="phx").remote()
    first = rt.get(phoenix.ping.remote())
    before = rt.available_resources().get("CPU", 0)
    rt.kill(phoenix, no_restart=False)
    # The lease is kept across the restart, and so is the name.
    after = rt.available_resources().get("CPU", 0)
    handle = rt.get_actor("phx")
    return [first, before, after,
            rt.get(handle.ping.remote(), timeout=WAIT_S)]


# Each scenario and what the mirrored reference test asserts of it.
ACTOR_CASES = {
    actor_basic: [1, 6, 6],
    actor_constructor_args: 100,
    actor_ordered_execution: list(range(1, 51)),
    actor_method_error_keeps_actor_alive:
        [1, ("ActorError", "RuntimeError"), 2],
    actor_constructor_failure: ("ActorDiedError", None),
    kill_actor: ("ActorDiedError", None),
    exit_actor: ["pong", ("ActorDiedError", None)],
    named_actor: 1,
    named_actor_duplicate_raises: ("ValueError", None),
    get_if_exists: 1,
    get_missing_named_actor_raises: ("ValueError", None),
    actor_handle_serialization: 2,
    actor_max_concurrency: 4,
    async_actor: [i * 2 for i in range(8)],
    actor_resource_release_on_death: ["pong", 0, 8.0],
    actor_restart: ["alive", "alive"],
    actor_pass_objectref_arg: 10,
    method_num_returns: [1, 2],
    restarted_actor_keeps_name_and_resources: ["alive", 6.0, 6.0, "alive"],
}


@pytest.mark.parametrize("scenario", list(ACTOR_CASES),
                         ids=lambda f: f.__name__)
def test_actor_parity(scenario):
    records = {name: _run(scenario, rt) for name, rt in RUNTIMES.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"]
    assert records["ray_tpu_torch"] == ACTOR_CASES[scenario]


def test_actor_call_deadline_dead_in_the_queue():
    """A call whose budget is already dead when the actor reaches it
    seals ``TaskTimeoutError`` at stage ``actor_queue`` in both."""
    def scenario(rt):
        counter = _counter(rt)
        rt.get(counter.increment.remote())
        ref = counter.increment.options(_deadline_s=-1.0).remote()
        try:
            rt.get(ref, timeout=WAIT_S)
        except rt.exceptions.TaskTimeoutError as exc:
            return [exc.stage, rt.get(counter.get_value.remote())]

    records = {name: _run(scenario, rt) for name, rt in RUNTIMES.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["actor_queue", 1]


# ------------------------------------------------------------- port only


def test_gpu_actor_holds_its_gpu_until_killed():
    """A ``num_gpus=1`` actor (0 CPU by default, as in the reference)
    leases the ``GPU`` for its lifetime: a ``num_gpus=1`` task waits until
    the actor is killed, then runs. Inside the actor the runtime context
    names the actor and its resources (the reference sets no context in
    an in-process actor)."""
    def scenario(rt):
        @rt.remote(num_gpus=1)
        class OnCard:
            def where(self):
                ctx = rt.get_runtime_context()
                return [ctx.get_actor_id(), ctx.get_assigned_resources()]

        @rt.remote(num_gpus=1)
        def task():
            return "ran"

        actor = OnCard.remote()
        actor_id, assigned = rt.get(actor.where.remote())
        held = rt.available_resources()
        ref = task.remote()
        waiting, _ = rt.wait([ref], timeout=0.3)
        rt.kill(actor)
        return [actor_id == actor._actor_id.hex(), assigned, held["GPU"],
                held["CPU"], waiting, rt.get(ref, timeout=WAIT_S),
                rt.available_resources()["GPU"]]

    assert _run(scenario, ray_tpu_torch, num_gpus=1) == \
        [True, {"GPU": 1.0}, 0.0, 8.0, [], "ran", 1.0]


def test_killed_actor_keeps_its_gpu_until_its_running_call_returns(
        monkeypatch):
    """A killed thread-pool actor refuses new calls at once, but its GPU
    goes back only when the call that was running returns: a queued
    ``num_gpus=1`` task is not admitted while that call may still use the
    card. ``kill`` waits a while for such a call (shortened here)."""
    monkeypatch.setattr(ray_tpu_torch._private.worker, "_KILL_WAIT_S", 0.2)

    def scenario(rt):
        started, release = threading.Event(), threading.Event()

        @rt.remote(num_gpus=1, max_concurrency=2)
        class Busy:
            def run(self):
                started.set()
                release.wait(WAIT_S)
                return "done"

            def ping(self):
                return "pong"

        @rt.remote(num_gpus=1)
        def task():
            return "ran"

        busy = Busy.remote()
        running = busy.run.remote()
        started.wait(WAIT_S)
        rt.kill(busy)
        refused = _error(lambda: rt.get(busy.ping.remote(), timeout=WAIT_S))
        held = rt.available_resources()["GPU"]
        queued = task.remote()
        waiting, _ = rt.wait([queued], timeout=0.3)
        release.set()
        return [refused, held, waiting, rt.get(running, timeout=WAIT_S),
                rt.get(queued, timeout=WAIT_S)]

    assert _run(scenario, ray_tpu_torch, num_gpus=1) == \
        [("ActorDiedError", None), 0.0, [], "done", "ran"]


def test_actor_killed_before_it_is_built_releases_nothing_twice():
    """An actor killed while it still waits for its resources never
    starts, and the resources it waited for stay free."""
    def scenario(rt):
        release, started = threading.Event(), threading.Event()

        @rt.remote(num_gpus=1)
        def hold():
            started.set()
            release.wait(WAIT_S)

        @rt.remote(num_gpus=1)
        class Late:
            def ping(self):
                return "pong"

        first = hold.remote()
        started.wait(WAIT_S)
        late = Late.remote()  # waits for the GPU
        rt.kill(late)
        release.set()
        rt.get(first)
        return [_error(lambda: rt.get(late.ping.remote(), timeout=WAIT_S)),
                rt.available_resources()["GPU"]]

    assert _run(scenario, ray_tpu_torch, num_gpus=1) == \
        [("ActorDiedError", None), 1.0]


def test_dead_actor_lets_go_of_its_instance_and_arguments():
    """A killed actor drops its instance and constructor arguments as its
    thread ends, without waiting for the cyclic collector (an engine
    actor's weights and KV pool live on the card)."""
    def scenario(rt):
        @rt.remote
        class Holder:
            def __init__(self, weights):
                self.weights = weights

            def size(self):
                return self.weights.numel()

        weights = torch.zeros(1000)
        alive = weakref.ref(weights)
        actor = Holder.remote(weights)
        size = rt.get(actor.size.remote())
        del weights
        gc.disable()
        try:
            rt.kill(actor)
            deadline = time.monotonic() + WAIT_S
            while alive() is not None and time.monotonic() < deadline:
                time.sleep(0.01)
            return [size, alive() is None]
        finally:
            gc.enable()

    assert _run(scenario, ray_tpu_torch) == [1000, True]


def test_an_actor_built_during_shutdown_is_not_started():
    """An actor whose creation is still under way when the runtime shuts
    down is never started: no actor thread outlives ``shutdown()``."""
    import threading

    for _ in range(5):
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=2)
        _counter(ray_tpu_torch, name="late")
        ray_tpu_torch.shutdown()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and any(
            t.name.startswith("ray_tpu_torch-actor-")
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch-actor-")] == []
