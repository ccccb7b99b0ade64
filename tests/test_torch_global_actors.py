"""The port's named actors across drivers against the JAX package's: a
driver in another process registers a named actor, and this process, a
second driver on the same head, resolves the name through the head's
actor directory and calls it there.

The four cases of tests/test_global_actors.py, each once through
``ray_tpu`` and once through ``ray_tpu_torch`` (the head, the owner
script and this driver all of the package under test), returning plain
records that must be equal, and equal to what the reference case
asserts. The owner's readiness and shutdown are read from its output,
not slept for. Then port-only cases: a ref argument resolved in the
caller, an owner lost to SIGKILL, ``kill`` of a foreign handle, and a
foreign handle passed into a task. Each case has a time limit of its
own.

Where the port deliberately differs: the directory entry names the
owner's client server at ``127.0.0.1`` (the port binds every server to
loopback), where the reference names the host's address.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu
import ray_tpu_torch
from torch_time_limit import time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}

OWNER_SCRIPT = textwrap.dedent("""
    import os, sys, time
    import {pkg} as rt

    rt.init(address=sys.argv[1], num_cpus=1)

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, x):
            self.n += x
            return self.n

        def owner_pid(self):
            return os.getpid()

        def hang(self):
            print("HANGING", flush=True)
            time.sleep(600)

    @rt.remote
    class Pair:
        @rt.method(num_returns=2)
        def split(self, a, b):
            return a, b

    c = Counter.options(name="global_counter").remote()
    p = Pair.options(name="pair_actor").remote()
    assert rt.get(c.add.remote(0)) == 0
    rt.get(p.split.remote(0, 0))
    print("READY", flush=True)
    sys.stdin.readline()  # a clean shutdown on a newline or EOF
    rt.shutdown()
    print("DONE", flush=True)
""")


def _mod(name: str, sub: str):
    return importlib.import_module(f"{name}.{sub}")


def _head(name: str, log_dir: str, **kwargs):
    head = _mod(name, "_private.gcs_server").GcsServer(
        host="127.0.0.1", port=0, log_dir=log_dir, **kwargs)
    head.start()
    return head


def _read_until(proc: subprocess.Popen, marker: str) -> str:
    """The owner's output up to the line holding ``marker``; the case's
    time limit bounds the wait."""
    seen = ""
    while True:
        line = proc.stdout.readline()
        seen += line
        if marker in line:
            return seen
        assert line or proc.poll() is None, f"owner ended: {seen}"


def _start_owner(name: str, address: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["RAY_TPU_SKIP_TPU_DETECTION"] = "1"
    owner = subprocess.Popen(
        [sys.executable, "-c", OWNER_SCRIPT.format(pkg=name), address],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _read_until(owner, "READY")
    except BaseException:
        _stop_owner(owner)
        raise
    return owner


def _stop_owner(owner: subprocess.Popen) -> None:
    if owner.poll() is None:
        owner.kill()
    owner.wait(timeout=10)
    for pipe in (owner.stdout, owner.stdin):
        try:
            pipe.close()
        except OSError:
            pass  # the owner is gone


def _with_owner(name: str, tmp_path, body) -> dict:
    """``body(rt, owner)`` with a head, an owner driver and this driver,
    all of package ``name``; everything stops after."""
    rt = PACKAGES[name]
    rt.shutdown()
    head = _head(name, str(tmp_path / name))
    owner = None
    try:
        owner = _start_owner(name, head.address)
        rt.init(address=head.address, num_cpus=1)
        return body(rt, owner)
    finally:
        rt.shutdown()
        if owner is not None:
            _stop_owner(owner)
        head.stop()


def _both(scenario, tmp_path, limit_s: int) -> dict:
    records = {}
    for name in PACKAGES:
        with time_limit(limit_s):
            records[name] = scenario(name, tmp_path)
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _unpublished(rt, actor_name: str, wait_s: float) -> bool:
    """Whether resolving ``actor_name`` raises ValueError within
    ``wait_s``."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            rt.get_actor(actor_name)
        except ValueError:
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)


# --------------------------------------------------------------- mirrored


def visible_across_drivers(name, tmp_path) -> dict:
    def body(rt, owner):
        handle = rt.get_actor("global_counter")
        # The calls run in the owner's process: its state accumulates
        # and the pid is the owner's.
        adds = [rt.get(handle.add.remote(5), timeout=60),
                rt.get(handle.add.remote(3), timeout=60)]
        pid = rt.get(handle.owner_pid.remote(), timeout=60)
        copy = pickle.loads(pickle.dumps(handle))
        return {"handle": type(handle).__name__, "adds": adds,
                "owner_pid": pid == owner.pid,
                "pickled": rt.get(copy.add.remote(2), timeout=60),
                "pickled_equal": copy == handle
                and hash(copy) == hash(handle)}

    return _with_owner(name, tmp_path, body)


def test_named_actor_visible_across_drivers(tmp_path):
    assert _both(visible_across_drivers, tmp_path, 180) == {
        "handle": "ForeignActorHandle", "adds": [5, 8], "owner_pid": True,
        "pickled": 10, "pickled_equal": True}


def unknown_name(name, tmp_path) -> dict:
    rt = PACKAGES[name]
    rt.shutdown()
    head = _head(name, str(tmp_path / name))
    try:
        rt.init(address=head.address, num_cpus=1)
        try:
            rt.get_actor("does_not_exist_anywhere")
            raised = None
        except ValueError:
            raised = "ValueError"
        return {"unknown": raised}
    finally:
        rt.shutdown()
        head.stop()


def test_unknown_named_actor_raises(tmp_path):
    assert _both(unknown_name, tmp_path, 60) == {"unknown": "ValueError"}


def persistence_survives_restart(name, tmp_path) -> dict:
    rpc = _mod(name, "_private.rpc")
    root = tmp_path / name
    snap = str(root / "gcs_snapshot.pkl")
    gcs = _head(name, str(root / "s1"), persist_path=snap)
    client = rpc.RpcClient(gcs.address)
    try:
        client.call("kv_put", b"mykey", b"myvalue", "default")
        client.call("kv_put", b"ns1/actorA", b"entry", "named_actors")
        sub_id = client.call("submit_job", "true",
                             submission_id="job-echo")
        deadline = time.monotonic() + 20
        while True:
            status = client.call("job_status", sub_id)
            if status and status["status"] in ("SUCCEEDED", "FAILED") \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        before = status["status"]
    finally:
        client.close()
        gcs.stop()  # takes the last snapshot
    gcs2 = _head(name, str(root / "s2"), persist_path=snap)
    client2 = rpc.RpcClient(gcs2.address)
    try:
        return {"job_before": before,
                "kv": client2.call("kv_get", b"mykey", "default"),
                "entry": client2.call("kv_get", b"ns1/actorA",
                                      "named_actors"),
                "job_after": (client2.call("job_status", sub_id)
                              or {}).get("status")}
    finally:
        client2.close()
        gcs2.stop()


def test_gcs_persistence_survives_restart(tmp_path):
    assert _both(persistence_survives_restart, tmp_path, 90) == {
        "job_before": "SUCCEEDED", "kv": b"myvalue", "entry": b"entry",
        "job_after": "SUCCEEDED"}


def multi_return_and_stale_cleanup(name, tmp_path) -> dict:
    def body(rt, owner):
        handle = rt.get_actor("pair_actor")
        r1, r2 = handle.split.remote("x", "y")
        split = rt.get([r1, r2], timeout=60)
        # The owner's clean shutdown withdraws its directory entries.
        owner.stdin.write("\n")
        owner.stdin.flush()
        _read_until(owner, "DONE")
        return {"split": split,
                "gone": _unpublished(rt, "pair_actor", 10.0)
                and _unpublished(rt, "global_counter", 10.0)}

    return _with_owner(name, tmp_path, body)


def test_foreign_actor_multi_return_and_stale_cleanup(tmp_path):
    assert _both(multi_return_and_stale_cleanup, tmp_path, 180) == {
        "split": ["x", "y"], "gone": True}


# -------------------------------------------------------------- port-only


def test_ref_argument_is_resolved_in_the_caller(tmp_path):
    """The owner cannot read this driver's store: a ref argument goes to
    it as its value."""
    def body(rt, owner):
        handle = rt.get_actor("global_counter")
        return rt.get(handle.add.remote(rt.put(7)), timeout=60)

    with time_limit(120):
        assert _with_owner("ray_tpu_torch", tmp_path, body) == 7


def test_owner_sigkill_fails_only_the_unsealed_returns(tmp_path):
    """A result sealed before the owner died stays; the call in flight
    and the one queued behind it fail with ActorDiedError."""
    from ray_tpu_torch.exceptions import ActorDiedError

    def body(rt, owner):
        handle = rt.get_actor("global_counter")
        first = handle.add.remote(1)
        assert rt.get(first, timeout=60) == 1
        hung = handle.hang.remote()
        queued = handle.add.remote(1)
        _read_until(owner, "HANGING")
        owner.kill()
        owner.wait(timeout=10)
        failed = []
        for ref in (hung, queued):
            with pytest.raises(ActorDiedError):
                rt.get(ref, timeout=60)
            failed.append(True)
        return {"first": rt.get(first, timeout=5), "failed": failed}

    with time_limit(120):
        assert _with_owner("ray_tpu_torch", tmp_path, body) == {
            "first": 1, "failed": [True, True]}


def test_kill_of_a_foreign_handle_kills_the_actor_in_its_owner(tmp_path):
    from ray_tpu_torch.exceptions import ActorDiedError

    def body(rt, owner):
        handle = rt.get_actor("global_counter")
        assert rt.get(handle.add.remote(2), timeout=60) == 2
        rt.kill(handle)
        with pytest.raises(ActorDiedError):
            rt.get(handle.add.remote(1), timeout=60)
        # Its death in the owner withdrew the name; the owner lives on.
        return {"gone": _unpublished(rt, "global_counter", 10.0),
                "owner_alive": owner.poll() is None,
                "other": rt.get(rt.get_actor("pair_actor").split.remote(
                    1, 2)[0], timeout=60)}

    with time_limit(120):
        assert _with_owner("ray_tpu_torch", tmp_path, body) == {
            "gone": True, "owner_alive": True, "other": 1}


def test_foreign_handle_passed_into_a_task(tmp_path):
    def body(rt, owner):
        handle = rt.get_actor("global_counter")

        @rt.remote
        def call_through(h, x):
            import ray_tpu_torch

            return ray_tpu_torch.get(h.add.remote(x), timeout=60)

        return [rt.get(call_through.remote(handle, 4), timeout=60),
                rt.get(handle.add.remote(1), timeout=60)]

    with time_limit(120):
        assert _with_owner("ray_tpu_torch", tmp_path, body) == [4, 5]
