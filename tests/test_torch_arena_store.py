"""The port's native shared arena (``ray_tpu_torch/_private/arena_store.py``
over ``ray_tpu_torch/_native/plasma_store.cpp``) against the JAX
package's.

Each case of tests/test_arena_store.py and tests/test_arena_stress.py
runs once through ``ray_tpu`` and once through ``ray_tpu_torch`` with the
same operations and returns a plain record (bytes, sizes, stats, flags);
the two records must be equal, and equal to what the reference case
asserts. Each package works on an arena of its own name. The stress case
SIGKILLs writer processes it started, never this one. Every case that
starts processes has a time limit of its own.

Where the port deliberately differs: the native layer has no silent
fallback. The reference skips these cases when its toolchain is missing
and its runtime may come up without an arena; the port's build raises,
so here the arena is asserted, not probed. The driver's arena is
``/ray_tpu_torch_arena_<pid>`` (the reference's ``/ray_tpu_arena_<pid>``),
and no init may leave it in ``/dev/shm`` after shutdown.
"""

from __future__ import annotations

import importlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from torch_time_limit import time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ray_tpu", "ray_tpu_torch")
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
# The driver's arena of each package, under /dev/shm.
DRIVER_ARENA = {"ray_tpu": "ray_tpu_arena_{pid}",
                "ray_tpu_torch": "ray_tpu_torch_arena_{pid}"}


def _store_cls(pkg: str):
    return importlib.import_module(f"{pkg}._private.arena_store").ArenaStore


def _both(scenario) -> dict:
    records = {pkg: scenario(pkg) for pkg in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def _arena_case(body):
    """Run ``body(arena)`` on a fresh 1 MiB, 256-slot arena of each
    package."""

    def scenario(pkg: str):
        store = _store_cls(pkg).create(f"/rtt_{pkg}_{os.getpid()}", 1 << 20,
                                       256)
        assert store is not None
        try:
            return body(store)
        finally:
            store.close()

    return _both(scenario)


def _key() -> bytes:
    return os.urandom(16)


# ------------------------------------------------------- the store alone


def put_get_roundtrip(arena) -> dict:
    oid = _key()
    return {"put": arena.put_bytes(oid, [b"abc", b"def"]),
            "contains": arena.contains(oid), "get": arena.get_bytes(oid),
            "missing": arena.get_bytes(_key())}


def test_put_get_roundtrip():
    assert _arena_case(put_get_roundtrip) == {
        "put": True, "contains": True, "get": b"abcdef", "missing": None}


def create_seal_visibility(arena) -> dict:
    oid = _key()
    view = arena.create_for_write(oid, 4)
    record = {"view": view is not None,
              # Unsealed objects are invisible to get and contains.
              "contains_unsealed": arena.contains(oid),
              "get_unsealed": arena.get_bytes(oid)}
    view[:] = b"1234"
    arena.seal(oid)
    record["get_sealed"] = arena.get_bytes(oid)
    return record


def test_create_seal_visibility():
    assert _arena_case(create_seal_visibility) == {
        "view": True, "contains_unsealed": False, "get_unsealed": None,
        "get_sealed": b"1234"}


def delete_frees_space(arena) -> dict:
    used0 = arena.stats()["used_bytes"]
    oid = _key()
    arena.put_bytes(oid, [b"x" * 10000])
    grew = arena.stats()["used_bytes"] - used0
    arena.delete(oid)
    return {"grew": grew, "back": arena.stats()["used_bytes"] == used0,
            "contains": arena.contains(oid)}


def test_delete_frees_space():
    assert _arena_case(delete_frees_space) == {
        "grew": 10000, "back": True, "contains": False}


def allocator_coalesces(arena) -> dict:
    blob = b"y" * 65536
    ids = []
    for _ in range(12):  # 12 x 64 KiB in a ~1 MiB heap
        oid = _key()
        assert arena.put_bytes(oid, [blob])
        ids.append(oid)
    # Interleaved deletes: merges on both sides.
    for oid in ids[::2] + ids[1::2]:
        arena.delete(oid)
    used = arena.stats()["used_bytes"]
    # One object near the heap's capacity fits only if every fragment
    # merged back into one block.
    cap = arena.stats()["capacity_bytes"]
    return {"used": used,
            "big_fits": arena.put_bytes(_key(), [b"z" * (cap - 4096)]),
            "evictions": arena.stats()["num_evictions"]}


def test_allocator_coalesces_freed_space():
    assert _arena_case(allocator_coalesces) == {
        "used": 0, "big_fits": True, "evictions": 0}


def eviction_lru_order(arena) -> dict:
    a, b, c = _key(), _key(), _key()
    arena.put_bytes(a, [b"a" * 300_000])
    arena.put_bytes(b, [b"b" * 300_000])
    touched = arena.get_bytes(a) is not None  # b is now the oldest
    put = arena.put_bytes(c, [b"c" * 600_000])  # forces an eviction
    return {"touched": touched, "put": put,
            "evicted": arena.stats()["num_evictions"] >= 1,
            "lru_victim": arena.get_bytes(b),
            "new_one": arena.get_bytes(c) is not None}


def test_eviction_lru_order():
    assert _arena_case(eviction_lru_order) == {
        "touched": True, "put": True, "evicted": True, "lru_victim": None,
        "new_one": True}


def oversized_put(arena) -> dict:
    oid, ok = _key(), _key()
    return {"put": arena.put_bytes(oid, [b"z" * (2 << 20)]),  # > capacity
            "contains": arena.contains(oid),
            "after": arena.put_bytes(ok, [b"fine"]) and arena.get_bytes(ok)}


def test_oversized_put_fails_cleanly():
    assert _arena_case(oversized_put) == {
        "put": False, "contains": False, "after": b"fine"}


def attach_sees_owner_objects(arena) -> dict:
    oid = _key()
    arena.put_bytes(oid, [b"shared-visibility"])
    other = type(arena).attach(arena.name)
    try:
        return {"attached": other is not None, "get": other.get_bytes(oid)}
    finally:
        other.close()


def test_attach_sees_owner_objects():
    assert _arena_case(attach_sees_owner_objects) == {
        "attached": True, "get": b"shared-visibility"}


def seal_pinned_survives_pressure(arena) -> dict:
    pinned = _key()
    view = arena.create_for_write(pinned, 100_000)
    view[:5] = b"keep!"
    arena.seal_pinned(pinned)
    for _ in range(30):  # heavy pressure of evictable objects
        arena.put_bytes(_key(), [b"p" * 200_000])
    kept = arena.get_bytes(pinned)[:5]
    arena.unpin(pinned)  # now evictable like anything else
    for _ in range(10):
        arena.put_bytes(_key(), [b"q" * 300_000])
    return {"kept": kept, "after_unpin": arena.get_bytes(pinned)}


def test_seal_pinned_survives_pressure():
    assert _arena_case(seal_pinned_survives_pressure) == {
        "kept": b"keep!", "after_unpin": None}


_LEAKING_WRITER = """
import sys
sys.path.insert(0, {repo!r})
from {pkg}._private.arena_store import ArenaStore
a = ArenaStore.attach({name!r})
v = a.create_for_write({key!r}, 400_000)
# exits without sealing: a writer that died mid-write
"""


def dead_writer_reclaimed(arena) -> dict:
    pkg = type(arena).__module__.split(".")[0]
    leak_key = b"L" * 16
    with time_limit(60):
        subprocess.run([sys.executable, "-c", _LEAKING_WRITER.format(
            repo=REPO, pkg=pkg, name=arena.name, key=leak_key)],
            check=True, timeout=60)
    leaked = arena.stats()["used_bytes"] >= 400_000
    # Pressure reclaims the dead writer's unsealed entry.
    for _ in range(6):
        arena.put_bytes(_key(), [b"r" * 150_000])
    return {"leaked": leaked, "contains": arena.contains(leak_key),
            "reclaimed": arena.stats()["num_evictions"] >= 1}


def test_dead_writer_created_leak_is_reclaimed():
    assert _arena_case(dead_writer_reclaimed) == {
        "leaked": True, "contains": False, "reclaimed": True}


def peek_without_pinning(arena) -> dict:
    oid = _key()
    payload = b"peekable" * 1000
    arena.put_bytes(oid, [payload])
    offset, size = arena.peek(oid)
    record = {"size": size,
              "bytes": bytes(arena.view_at(offset, size)) == payload,
              "absent": arena.peek(_key())}
    # The peek took no reference: pressure evicts the object.
    for _ in range(8):
        arena.put_bytes(_key(), [b"e" * 200_000])
    record["after_pressure"] = arena.peek(oid)
    return record


def test_peek_locates_without_pinning():
    assert _arena_case(peek_without_pinning) == {
        "size": 8000, "bytes": True, "absent": None, "after_pressure": None}


def pin_blocks_eviction(arena) -> dict:
    oid = _key()
    arena.put_bytes(oid, [b"pinme" * 1000])
    pinned = arena.pin(oid)
    for _ in range(10):
        arena.put_bytes(_key(), [b"x" * 200_000])
    kept = arena.get_bytes(oid)
    arena.unpin(oid)
    for _ in range(10):
        arena.put_bytes(_key(), [b"y" * 200_000])
    return {"pinned": pinned, "kept": kept == b"pinme" * 1000,
            "after_unpin": arena.get_bytes(oid)}


def test_pin_blocks_eviction_until_unpin():
    assert _arena_case(pin_blocks_eviction) == {
        "pinned": 5000, "kept": True, "after_unpin": None}


def empty_object(arena) -> dict:
    oid = _key()
    return {"put": arena.put_bytes(oid, []), "contains": arena.contains(oid),
            "get": arena.get_bytes(oid)}


def test_empty_object_roundtrip():
    assert _arena_case(empty_object) == {
        "put": True, "contains": True, "get": b""}


def tombstone_cleanup(arena) -> dict:
    churned = 0
    for _ in range(3000):  # 256 slots, ~12x churn
        oid = _key()
        churned += arena.put_bytes(oid, [b"t"])
        arena.delete(oid)
    start = time.perf_counter()
    for _ in range(1000):
        arena.contains(_key())  # misses, every one
    per_miss = (time.perf_counter() - start) / 1000
    return {"churned": churned, "misses_fast": per_miss < 200e-6}


def test_tombstone_cleanup_keeps_lookups_fast():
    assert _arena_case(tombstone_cleanup) == {
        "churned": 3000, "misses_fast": True}


# --------------------------------------------------- the transport path


def pool_results_ride_the_arena(pkg: str) -> dict:
    """Mid-size task results cross the process boundary in the arena,
    large ones in segments; a promoted argument rides the arena, and
    freeing it deletes its entry. The torch tensor (400 KB) is over the
    inline limit and under the arena's object cap."""
    rt = RUNTIMES[pkg]
    rt.shutdown()
    pid = os.getpid()
    with time_limit(180):
        runtime = rt.init(num_cpus=4, process_workers=2)
        try:
            arena = runtime.arena
            record = {"arena_is_native": type(arena).__name__ == "ArenaStore",
                      "arena_name": arena.name == "/" + DRIVER_ARENA[
                          pkg].format(pid=pid)}
            stats0 = arena.stats()

            @rt.remote
            def mid():
                return np.arange(50_000, dtype=np.int64)  # ~400 KB

            @rt.remote
            def big():
                return np.zeros(1 << 21, dtype=np.uint8)  # 2 MiB > the cap

            @rt.remote
            def mid_tensor(seed):
                gen = torch.Generator().manual_seed(seed)
                return torch.randn(100_000, generator=gen)  # 400 KB

            # The refs are held: a freed result leaves the arena.
            mid_ref = mid.remote()
            out = rt.get(mid_ref)
            record["mid"] = bool(np.array_equal(out, np.arange(50_000)))
            stats1 = arena.stats()
            record["mid_rode_arena"] = \
                stats1["num_objects"] > stats0["num_objects"]
            tensor_ref = mid_tensor.remote(7)
            tensor = rt.get(tensor_ref)
            record["tensor_bitwise"] = bool(torch.equal(
                tensor, torch.randn(100_000,
                                    generator=torch.Generator().manual_seed(7))))
            record["tensor_rode_arena"] = \
                arena.stats()["num_objects"] > stats1["num_objects"]
            record["big_nbytes"] = rt.get(big.remote()).nbytes

            ref = rt.put(np.full(30_000, 7, dtype=np.int64))

            @rt.remote
            def consume(x):
                return int(x.sum())

            record["consume"] = rt.get(consume.remote(ref))
            before = arena.stats()["num_objects"]
            runtime.free([ref])
            record["free_deletes"] = before - arena.stats()["num_objects"]
        finally:
            rt.shutdown()
    # The shutdown destroyed the arena: nothing is left in /dev/shm.
    record["left_in_dev_shm"] = os.path.exists(
        "/dev/shm/" + DRIVER_ARENA[pkg].format(pid=pid))
    return record


def test_pool_results_ride_the_arena():
    assert _both(pool_results_ride_the_arena) == {
        "arena_is_native": True, "arena_name": True, "mid": True,
        "mid_rode_arena": True, "tensor_bitwise": True,
        "tensor_rode_arena": True, "big_nbytes": 1 << 21, "consume": 210_000,
        "free_deletes": 1, "left_in_dev_shm": False}


def process_actor_args_outlive_their_refs(pkg: str, n: int) -> dict:
    """A process actor busy with a first call is handed a ``put`` value
    whose ref the caller drops at once: the queued call still gets the
    value. In the port the argument crosses in shared memory (the arena
    up to its object cap, a segment above it), and the call holds its
    refs until its results are stored; the reference pickles the value
    into the pipe."""
    import gc

    rt = RUNTIMES[pkg]
    rt.shutdown()
    with time_limit(120):
        rt.init(num_cpus=2)
        try:
            @rt.remote(process=True)
            class Summer:
                def block(self, seconds):
                    time.sleep(seconds)
                    return "blocked"

                def total(self, x):
                    return int(x.sum())

            actor = Summer.remote()
            first = actor.block.remote(0.5)
            second = actor.total.remote(rt.put(np.arange(n, dtype=np.int64)))
            gc.collect()
            return {"first": rt.get(first), "second": rt.get(second)}
        finally:
            rt.shutdown()


@pytest.mark.parametrize("n", [50_000, 1 << 18],
                         ids=["arena_400KB", "segment_2MiB"])
def test_process_actor_args_outlive_their_refs(n):
    assert _both(lambda pkg: process_actor_args_outlive_their_refs(pkg, n)) \
        == {"first": "blocked", "second": n * (n - 1) // 2}


def test_both_runtimes_in_one_process_keep_their_own_arenas():
    """Both packages' runtimes up at once in this pid: two arenas, and
    each package's workers write their results into their own."""
    pid = os.getpid()
    for rt in RUNTIMES.values():
        rt.shutdown()
    with time_limit(240):
        runtimes = {}
        try:
            for pkg, rt in RUNTIMES.items():
                runtimes[pkg] = rt.init(num_cpus=2, process_workers=1)
            names = {pkg: r.arena.name for pkg, r in runtimes.items()}
            assert names == {pkg: "/" + DRIVER_ARENA[pkg].format(pid=pid)
                             for pkg in PACKAGES}
            for pkg, rt in RUNTIMES.items():
                before = {p: r.arena.stats()["num_objects"]
                          for p, r in runtimes.items()}

                @rt.remote
                def mid():
                    return np.arange(50_000, dtype=np.int64)

                assert rt.get(mid.remote())[-1] == 49_999
                grew = {p: r.arena.stats()["num_objects"] - before[p]
                        for p, r in runtimes.items()}
                assert grew == {p: int(p == pkg) for p in PACKAGES}, grew
        finally:
            for rt in RUNTIMES.values():
                rt.shutdown()
    for pkg in PACKAGES:
        assert not os.path.exists("/dev/shm/" + DRIVER_ARENA[pkg].format(
            pid=pid)), pkg


# ------------------------------------------------------------ stress


_STRESS_WRITER = r"""
import os, random, sys, time
sys.path.insert(0, %(repo)r)
from %(pkg)s._private.arena_store import ArenaStore

arena = ArenaStore.attach(%(name)r)
assert arena is not None
rng = random.Random(os.getpid())
deadline = time.time() + %(seconds)f
wrote = 0
while time.time() < deadline:
    oid = os.urandom(20)
    size = rng.randrange(64, 64 * 1024)
    view = arena.create_for_write(oid, size)
    if view is not None:
        view[:8] = oid[:8]  # a payload that names itself
        arena.seal(oid)
        wrote += 1
        if rng.random() < 0.3:
            blob = arena.get_bytes(oid)
            assert blob is not None and bytes(blob[:8]) == oid[:8], \
                "corrupted read-back"
        if rng.random() < 0.2:
            arena.delete(oid)
    if rng.random() < 0.05:
        arena.stats()
print(wrote, flush=True)
"""


def concurrent_writers_and_sigkill(pkg: str, kill_rounds: int) -> dict:
    """Four writer processes on one 32 MiB arena; in each round one is
    SIGKILLed mid-flight and replaced. The arena must still serve and
    its accounting hold: the robust mutex recovers a lock its holder
    died with, and eviction reclaims dead writers' entries."""
    name = f"rtt_stress_{pkg}_{os.getpid()}"
    arena = _store_cls(pkg).create(name, 32 * 1024 * 1024)
    assert arena is not None

    def spawn(seconds):
        return subprocess.Popen(
            [sys.executable, "-c", _STRESS_WRITER % {
                "repo": REPO, "pkg": pkg, "name": name, "seconds": seconds}],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = []
    try:
        with time_limit(120):
            procs = [spawn(6.0) for _ in range(4)]
            for _ in range(kill_rounds):
                time.sleep(1.0)
                victim = procs.pop(0)
                os.kill(victim.pid, signal.SIGKILL)  # a child, never us
                victim.wait()
                procs.append(spawn(3.0))
            outputs = [p.communicate(timeout=60)[0] for p in procs]
            exits = [p.returncode for p in procs]
            wrote = sum(int(out.strip().splitlines()[-1])
                        for out, rc in zip(outputs, exits) if rc == 0)
            oid = b"final-check-object--"
            view = arena.create_for_write(oid, 1024)
            if view is not None:
                view[:4] = b"DONE"
                arena.seal(oid)
            return {"exits": exits, "progress": wrote > 100,
                    "writable": view is not None,
                    "final": bytes((arena.get_bytes(oid) or b"")[:4]),
                    "used_within": arena.stats()["used_bytes"]
                    <= 32 * 1024 * 1024,
                    "outputs_ok": all(rc == 0 for rc in exits)
                    or outputs}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        arena.close()


@pytest.mark.parametrize("kill_rounds", [2])
def test_arena_survives_concurrent_writers_and_sigkill(kill_rounds):
    assert _both(lambda pkg: concurrent_writers_and_sigkill(
        pkg, kill_rounds)) == {
        "exits": [0, 0, 0, 0], "progress": True, "writable": True,
        "final": b"DONE", "used_within": True, "outputs_ok": True}
