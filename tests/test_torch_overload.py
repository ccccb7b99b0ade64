"""The port's overload control (deadlines, admission shedding, the RPC
circuit breaker, Serve's shedding) against the JAX package's.

The tier-1 cases of tests/test_overload.py, each once through
``ray_tpu`` and once through ``ray_tpu_torch`` with the same operations,
returning plain records (values, exception types and stages, counters);
the two records must be equal, and equal to what the reference case
asserts. One case is left out: :462 is ``slow``. Each case has a time limit of
its own. Where the reference sleeps for a deadline to pass in a queue,
these sleep the same: the deadline is the subject.
"""

from __future__ import annotations

import importlib
import time

import pytest

import ray_tpu
import ray_tpu_torch
from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _exc(pkg: str, name: str):
    return getattr(_mod(pkg, "exceptions"), name)


def _both(scenario, limit: int = 120) -> dict:
    records = {}
    for pkg in PACKAGES:
        with time_limit(limit):
            records[pkg] = scenario(pkg)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _outcome(fn) -> tuple:
    """("ok", value) or (exception class name, its stage if it has one)."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the record is the point
        return (type(exc).__name__, getattr(exc, "stage", None))


def _tiny(body):
    """Run ``body(pkg, rt, runtime, sleeper, quick)`` on a 1-CPU runtime
    of each package: one blocker saturates it."""

    def scenario(pkg: str):
        rt = RUNTIMES[pkg]
        config = _mod(pkg, "_private.config").GLOBAL_CONFIG
        monitor = _mod(pkg, "_private.memory_monitor")
        rpc = _mod(pkg, "_private.rpc")
        rt.shutdown()
        runtime = rt.init(num_cpus=1, ignore_reinit_error=True)

        @rt.remote(num_cpus=1)
        def sleeper(t, x):
            time.sleep(t)
            return x

        @rt.remote(num_cpus=1)
        def quick(x):
            return x

        try:
            return body(pkg, rt, runtime, sleeper, quick)
        finally:
            rt.shutdown()
            config.reset()
            monitor._set_usage_override(None)
            rpc.reset_breakers()

    return _both(scenario)


# --------------------------------------------------------------- deadlines


def deadline_in_queue(pkg, rt, runtime, sleeper, quick) -> dict:
    blocker = sleeper.remote(0.8, "b")
    ref = quick.remote(1, _deadline_s=0.2)
    kind, stage = _outcome(lambda: rt.get(ref, timeout=20))
    return {"kind": kind,
            # Queued at the dispatcher or refused at the claim; never run.
            "stage_ok": stage in ("queued", "dispatch", "execute"),
            "blocker": rt.get(blocker, timeout=20),
            "counted": runtime.fault_stats()["task_timeouts"] >= 1}


def test_deadline_expires_in_queue_seals_task_timeout():
    assert _tiny(deadline_in_queue) == {
        "kind": "TaskTimeoutError", "stage_ok": True, "blocker": "b",
        "counted": True}


def live_deadline(pkg, rt, runtime, sleeper, quick) -> list:
    return [rt.get(quick.remote(7, _deadline_s=30), timeout=20),
            # The option on the remote function works too.
            rt.get(quick.options(_deadline_s=30).remote(8), timeout=20)]


def test_live_deadline_executes_normally():
    assert _tiny(live_deadline) == [7, 8]


def both_orderings(pkg, rt, runtime, sleeper, quick) -> dict:
    # A: the task's deadline seals first -> its TaskTimeoutError.
    blocker = sleeper.remote(0.6, "b")
    ref = quick.remote(1, _deadline_s=0.15)
    time.sleep(0.4)  # sealed while still blocked
    first = _outcome(lambda: rt.get(ref, timeout=5))[0]
    # B: get()'s own timeout fires while the task (deadline live) waits.
    ref2 = quick.remote(2, _deadline_s=30)
    second = _outcome(lambda: rt.get(ref2, timeout=0.05))[0]
    return {"task_first": first, "get_first": second,
            "blocker": rt.get(blocker, timeout=20),
            "later": rt.get(ref2, timeout=20)}


def test_get_timeout_vs_task_timeout_both_orderings():
    assert _tiny(both_orderings) == {
        "task_first": "TaskTimeoutError", "get_first": "GetTimeoutError",
        "blocker": "b", "later": 2}


def ring_deadline_before_flush(pkg, rt, runtime, sleeper, quick) -> dict:
    # The ring's drain is held, so the submit's budget dies BUFFERED.
    ring = runtime._submit_ring
    armed = ring is not None
    ring._gate.clear()
    try:
        ref = quick.remote(1, _deadline_s=0.1)
        time.sleep(0.3)
    finally:
        ring._gate.set()
    kind, stage = _outcome(lambda: rt.get(ref, timeout=20))
    # The seal came first: a get with its own short timeout still raises
    # the task's error.
    again = _outcome(lambda: rt.get(ref, timeout=0.01))[0]
    return {"armed": armed, "kind": kind, "stage": stage, "again": again}


def test_buffered_ring_submit_deadline_expires_before_flush():
    assert _tiny(ring_deadline_before_flush) == {
        "armed": True, "kind": "TaskTimeoutError", "stage": "submit",
        "again": "TaskTimeoutError"}


def default_deadline(pkg, rt, runtime, sleeper, quick) -> dict:
    config = _mod(pkg, "_private.config").GLOBAL_CONFIG
    config.update({"task_default_deadline_s": 0.2})
    blocker = sleeper.remote(0.8, "b")
    ref = quick.remote(1)  # inherits the default budget
    kind = _outcome(lambda: rt.get(ref, timeout=20))[0]
    config.update({"task_default_deadline_s": 0.0})
    return {"kind": kind, "blocker": rt.get(blocker, timeout=20)}


def test_default_deadline_config_applies():
    assert _tiny(default_deadline) == {"kind": "TaskTimeoutError",
                                       "blocker": "b"}


def actor_call_deadline(pkg, rt, runtime, sleeper, quick) -> dict:
    @rt.remote
    class A:
        def slow(self):
            time.sleep(0.5)
            return "s"

        def fast(self):
            return "f"

    a = A.remote()
    fast = rt.get(a.fast.remote(), timeout=20)
    slow_ref = a.slow.remote()
    dead_ref = a.fast.options(_deadline_s=0.1).remote()
    return {"fast": fast, "dead": _outcome(lambda: rt.get(dead_ref,
                                                          timeout=20)),
            "slow": rt.get(slow_ref, timeout=20)}


def test_actor_call_deadline():
    assert _tiny(actor_call_deadline) == {
        "fast": "f", "dead": ("TaskTimeoutError", "actor_queue"),
        "slow": "s"}


def actor_default_deadline(pkg, rt, runtime, sleeper, quick) -> dict:
    @rt.remote(_deadline_s=0.1)
    class B:
        def slow(self):
            time.sleep(0.5)
            return "s"

        def fast(self):
            return "f"

    b = B.remote()
    first = b.slow.remote()  # starts at once: its budget is live
    queued = b.fast.remote()  # inherits 0.1 s and dies in the queue
    return {"queued": _outcome(lambda: rt.get(queued, timeout=20))[0],
            "first": rt.get(first, timeout=20)}


def test_actor_default_deadline_option():
    assert _tiny(actor_default_deadline) == {"queued": "TaskTimeoutError",
                                             "first": "s"}


def cancel_wins(pkg, rt, runtime, sleeper, quick) -> dict:
    blocker = sleeper.remote(0.5, "b")
    ref = quick.remote(1, _deadline_s=30)
    rt.cancel(ref)
    return {"cancelled": _outcome(lambda: rt.get(ref, timeout=20))[0],
            "blocker": rt.get(blocker, timeout=20)}


def test_cancel_still_wins_over_deadline():
    assert _tiny(cancel_wins) == {"cancelled": "TaskCancelledError",
                                  "blocker": "b"}


# ------------------------------------------------------- admission control


def queue_depth_shed(pkg, rt, runtime, sleeper, quick) -> dict:
    config = _mod(pkg, "_private.config").GLOBAL_CONFIG
    config.update({"admission_max_queue_depth": 5})
    backlog = [sleeper.remote(0.05, i) for i in range(40)]
    deadline = time.monotonic() + 10
    while runtime.dispatcher.pending_count() <= 5:
        assert time.monotonic() < deadline, "backlog never built up"
        time.sleep(0.01)
    shed = _outcome(lambda: rt.get(quick.remote(1, _deadline_s=30),
                                   timeout=30))[0]
    # Deadline-free work is never lost: it all lands once the backlog
    # drains.
    return {"shed": shed, "backlog": rt.get(backlog, timeout=60),
            "counted": runtime.fault_stats()["admission_shed"] >= 1}


def test_queue_depth_shed_and_bounded_blocking():
    assert _tiny(queue_depth_shed) == {
        "shed": "SystemOverloadedError", "backlog": list(range(40)),
        "counted": True}


def memory_watermark_shed(pkg, rt, runtime, sleeper, quick) -> dict:
    config = _mod(pkg, "_private.config").GLOBAL_CONFIG
    monitor = _mod(pkg, "_private.memory_monitor")
    config.update({"admission_memory_watermark": 0.9})
    monitor._set_usage_override(0.95)
    try:
        shed = _outcome(lambda: rt.get(quick.remote(1, _deadline_s=30),
                                       timeout=30))[0]
    finally:
        monitor._set_usage_override(None)
    # The pressure is gone: admission opens again.
    return {"shed": shed,
            "after": rt.get(quick.remote(2, _deadline_s=30), timeout=20)}


def test_memory_watermark_shed():
    assert _tiny(memory_watermark_shed) == {"shed": "SystemOverloadedError",
                                            "after": 2}


# --------------------------------------------------------- circuit breaker


class _FlakyClient:
    """A call_with_retry target whose failure mode the case sets."""

    def __init__(self, rpc, address="10.99.0.1:7"):
        self.rpc = rpc
        self.address = address
        self.calls = 0
        self.mode = "fail"  # fail | fail_maybe | ok | poisoned

    def call(self, method, *args, **kwargs):
        self.calls += 1
        if self.mode == "fail":
            raise self.rpc.RpcError("connect refused")
        if self.mode == "fail_maybe":
            raise self.rpc.RpcError("lost in flight", maybe_executed=True)
        if self.mode == "poisoned":
            raise self.rpc.RpcMethodError(ValueError("app"), "tb")
        return "ok"


def _breaker_case(body):
    """Run ``body(rpc, client)`` with a 3-failure, 0.3 s breaker."""

    def scenario(pkg: str):
        rpc = _mod(pkg, "_private.rpc")
        config = _mod(pkg, "_private.config").GLOBAL_CONFIG
        rpc.reset_breakers()
        config.update({"rpc_breaker_failures": 3, "rpc_breaker_reset_s": 0.3,
                       "rpc_retry_base_ms": 1})
        try:
            return body(rpc, _FlakyClient(rpc))
        finally:
            rpc.reset_breakers()
            config.reset()

    return _both(scenario)


def _fails(rpc, client, attempts: int) -> str:
    return _outcome(lambda: rpc.call_with_retry(
        client.call, "m", attempts=attempts, deadline_s=5))[0]


def opens_and_fails_fast(rpc, client) -> dict:
    failures = [_fails(rpc, client, 2) for _ in range(3)]
    stats = rpc.breaker_stats()
    wire = client.calls
    try:
        rpc.call_with_retry(client.call, "m", attempts=3, deadline_s=5)
        fast = "ok"
    except rpc.RpcError as exc:
        fast = "breaker" in str(exc)
    # The open breaker never let the call reach the wire.
    return {"failures": failures, "opens": stats["opens"],
            "open_now": stats["open_now"], "fails_fast": fast,
            "no_wire": client.calls == wire}


def test_breaker_opens_and_fails_fast():
    assert _breaker_case(opens_and_fails_fast) == {
        "failures": ["RpcError"] * 3, "opens": 1, "open_now": ["10.99.0.1:7"],
        "fails_fast": True, "no_wire": True}


def one_failure_per_logical_call(rpc, client) -> list:
    """Two attempts per call, one failure counted per call: the breaker
    opens at the third call, not during the second."""
    record = [_fails(rpc, client, 2), _fails(rpc, client, 2)]
    record.append(rpc.breaker_stats()["opens"])
    record.append(_fails(rpc, client, 2))
    return record + [rpc.breaker_stats()["opens"]]


def test_breaker_counts_one_failure_per_logical_call():
    assert _breaker_case(one_failure_per_logical_call) == [
        "RpcError", "RpcError", 0, "RpcError", 1]


def maybe_executed_and_oserror(rpc, client) -> list:
    """Bare OSErrors and maybe-executed RpcErrors both count."""
    client.mode = "fail_maybe"
    record = [_fails(rpc, client, 1)]

    class OsClient:
        address = client.address

        def call(self, method, *a, **k):
            raise OSError("raw socket error")

    for _ in range(2):
        record.append(_fails(rpc, OsClient(), 1))
    return record + [rpc.breaker_stats()["opens"]]  # 1 + 2 = 3 failures


def test_breaker_counts_maybe_executed_and_oserror():
    assert _breaker_case(maybe_executed_and_oserror) == [
        "RpcError", "OSError", "OSError", 1]


def half_open_probe(rpc, client) -> dict:
    for _ in range(3):
        _fails(rpc, client, 1)
    record = {"open_now": rpc.breaker_stats()["open_now"]}
    # A failed half-open probe opens it again, not counted as a new open.
    time.sleep(0.35)
    record["probe"] = _fails(rpc, client, 1)
    record["opens"] = rpc.breaker_stats()["opens"]
    # The next probe succeeds: closed, and calls flow again.
    time.sleep(0.35)
    client.mode = "ok"
    record["recovered"] = rpc.call_with_retry(client.call, "m", attempts=1,
                                              deadline_s=5)
    record["open_after"] = rpc.breaker_stats()["open_now"]
    return record


def test_breaker_half_open_probe_and_recovery():
    assert _breaker_case(half_open_probe) == {
        "open_now": ["10.99.0.1:7"], "probe": "RpcError", "opens": 1,
        "recovered": "ok", "open_after": []}


def poisoned_is_alive(rpc, client) -> dict:
    """A remote method that raised proves the node answers: it never
    opens the breaker."""
    client.mode = "poisoned"
    return {"outcomes": sorted({_fails(rpc, client, 1) for _ in range(10)}),
            "opens": rpc.breaker_stats()["opens"]}


def test_breaker_poisoned_counts_as_alive():
    assert _breaker_case(poisoned_is_alive) == {
        "outcomes": ["RpcMethodError"], "opens": 0}


# ------------------------------------------------------------- serve tier


def _serve_case(body):
    def scenario(pkg: str):
        rt = RUNTIMES[pkg]
        serve = _mod(pkg, "serve")
        rt.shutdown()
        rt.init(num_cpus=8, ignore_reinit_error=True)
        try:
            serve.start()
            try:
                return body(pkg, serve)
            finally:
                serve.shutdown()
        finally:
            rt.shutdown()

    return _both(scenario, limit=180)


def max_queued_sheds(pkg, serve) -> dict:
    overloaded = _exc(pkg, "SystemOverloadedError")

    @serve.deployment(num_replicas=1, max_ongoing_requests=2,
                      max_queued_requests=3)
    class Sleepy:
        def __call__(self, body):
            time.sleep(0.4)
            return body

    serve.run(Sleepy.bind(), name="odl_shed", route_prefix="/shed")
    handle = serve.get_app_handle("odl_shed")
    first = handle.remote({"i": 0}).result(timeout_s=30)
    accepted, sheds = [], 0
    for i in range(12):
        try:
            accepted.append(handle.remote({"i": i}))
        except overloaded:
            sheds += 1
    # What was admitted all completes: the shed loses nothing admitted.
    done = [resp.result(timeout_s=30) for resp in accepted]
    return {"first": first, "shed": sheds > 0,
            "admitted_done": len(done) == 12 - sheds}


def test_serve_max_queued_requests_sheds():
    assert _serve_case(max_queued_sheds) == {
        "first": {"i": 0}, "shed": True, "admitted_done": True}


def deadline_inheritance(pkg, serve) -> dict:
    """The handle's deadline_s rides to the replica's actor call: a
    request whose budget dies behind a slow one is refused, not run
    late."""

    @serve.deployment(num_replicas=1, max_ongoing_requests=1)
    class OneAtATime:
        def __call__(self, body):
            time.sleep(0.5)
            return body

    serve.run(OneAtATime.bind(), name="odl_ddl", route_prefix="/ddl")
    handle = serve.get_app_handle("odl_ddl")
    warm = handle.remote("warm").result(timeout_s=30)
    slow_resp = handle.remote("first")
    dead_resp = handle.options(deadline_s=0.15).remote("second")
    dead = _outcome(lambda: dead_resp.result(timeout_s=10))[0]
    return {"warm": warm,
            "refused": dead in ("TaskTimeoutError", "GetTimeoutError"),
            "slow": slow_resp.result(timeout_s=30)}


def test_serve_deadline_inheritance():
    assert _serve_case(deadline_inheritance) == {
        "warm": "warm", "refused": True, "slow": "first"}


# --------------------------------------------------- closed-loop overload


def overload_soak(pkg: str, duration_s: float = 4.0,
                  arrival_factor: int = 5) -> dict:
    """Keep ``arrival_factor`` x the box's concurrency in flight with
    short deadlines: every ref resolves (a value or a typed shed), the
    queue stays bounded, nothing hangs."""
    import resource

    rt = RUNTIMES[pkg]
    timeout_error = _exc(pkg, "TaskTimeoutError")
    overloaded = _exc(pkg, "SystemOverloadedError")
    rt.shutdown()
    runtime = rt.init(num_cpus=1, ignore_reinit_error=True)
    try:
        @rt.remote(num_cpus=1)
        def unit(i):
            time.sleep(0.01)
            return i

        rss_start = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        inflight: list = []
        outcomes = {"ok": 0, "timeout": 0, "shed": 0}
        max_pending = 0
        stop_at = time.monotonic() + duration_s
        i = 0

        def harvest(ref):
            try:
                rt.get(ref, timeout=30)
                outcomes["ok"] += 1
            except timeout_error:
                outcomes["timeout"] += 1
            except overloaded:
                outcomes["shed"] += 1

        while time.monotonic() < stop_at:
            while len(inflight) < arrival_factor * 8:
                # A budget of about half the queue's wait: the window's
                # head survives, its tail sheds as typed timeouts.
                inflight.append(unit.remote(i, _deadline_s=0.2))
                i += 1
            max_pending = max(max_pending,
                              runtime.dispatcher.pending_count())
            harvest(inflight.pop(0))
        for ref in inflight:
            harvest(ref)
        rss_end = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return {"all_resolved": sum(outcomes.values()) == i,
                "timeouts": outcomes["timeout"] > 0,
                "oks": outcomes["ok"] > 0,
                "bounded": max_pending <= arrival_factor * 8 + 16,
                "rss_bounded": rss_end - rss_start < 512 * 1024,
                "enough": sum(outcomes.values()) > 50}
    finally:
        rt.shutdown()


def test_closed_loop_overload_short():
    assert _both(overload_soak) == {
        "all_resolved": True, "timeouts": True, "oks": True,
        "bounded": True, "rss_bounded": True, "enough": True}
