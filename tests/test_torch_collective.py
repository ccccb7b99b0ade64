"""The port's collective API against the JAX package's.

The store backend: each mirrored case of tests/test_collective.py is a
scenario that runs once through ``ray_tpu`` and once through
``ray_tpu_torch`` (4 thread actors under ``init(num_cpus=8)``). It
returns a plain record (values as lists, dtypes, exception class names
and messages); the two records must be equal, and equal to what the
mirrored test asserts.

The device plane: ``collective.nccl`` against ``collective.xla``. A
module-scoped fixture spawns 8 gloo ranks once
(``tests/torch_collective_ranks.py``, which imports no JAX); each runs
the host helpers on the reference's ``[n, ...]`` arrays and the in-SPMD
primitives on its shard under the ambient mesh. This process computes
the same through ``col.xla``'s helpers and the ``lax`` ops in
``shard_map`` on its 8 virtual CPU devices (outputs sharded over the
axis). Every input is integer-valued, so sums are exact in any order:
everything is compared bitwise (``atol=0``), gradients included.

Where the port deliberately differs (port-only cases at the end):

- ``collective.nccl`` is exported where the reference exports ``xla``;
  its primitives run on ``torch.distributed`` (NCCL on ``cuda``, gloo
  here) and its helpers take the mesh's device (``device="cpu"`` here);
- the store carries tensors as they come: a ``torch.Tensor`` stays a
  tensor on its own device and keeps its dtype (bf16 included),
  promotion follows ``torch.promote_types``, every rank gets its own
  copy; a tensor and a numpy array in one op are refused;
- ``pmax``/``pmin``'s backward raises NotImplementedError, as JAX's
  differentiation of them does.
"""


import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import ray_tpu
import ray_tpu_torch
import torch_parallel_ranks
from ray_tpu._private.jax_compat import shard_map
from ray_tpu.util import collective as jax_col
from ray_tpu_torch.util import collective as port_col

RUNTIMES = {"ray_tpu": (ray_tpu, jax_col),
            "ray_tpu_torch": (ray_tpu_torch, port_col)}
JOIN_TIMEOUT_S = 120.0


def _run(scenario, name):
    rt, col = RUNTIMES[name]
    rt.shutdown()
    rt.init(num_cpus=8)
    try:
        return scenario(rt, col)
    finally:
        rt.shutdown()


def _both(scenario):
    """The scenario's record through both packages; they must agree."""
    records = {name: _run(scenario, name) for name in RUNTIMES}
    assert records["ray_tpu_torch"] == records["ray_tpu"], records
    return records["ray_tpu_torch"]


def _plain(x):
    """A record of a result: (dtype name, values as lists)."""
    if x is None:
        return None
    if isinstance(x, list):
        return [_plain(v) for v in x]
    arr = np.asarray(x)
    return str(arr.dtype), arr.tolist()


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded
        return type(exc).__name__, str(exc)
    return None


def _group_actors(rt, col, world=4, name="g"):
    """The reference test's Worker (every op), one per rank."""

    @rt.remote
    class Worker:
        def __init__(self, rank, world):
            self.rank = rank
            self.world = world
            col.init_collective_group(world, rank, group_name=name)

        def do_allreduce(self):
            return col.allreduce(np.full((4,), self.rank + 1.0),
                                 group_name=name)

        def do_allgather(self):
            return col.allgather(np.array([self.rank]), group_name=name)

        def do_broadcast(self):
            t = (np.arange(3) * 7 if self.rank == 1
                 else np.zeros(3, dtype=np.int64))
            return col.broadcast(t, src_rank=1, group_name=name)

        def do_reducescatter(self):
            return col.reducescatter(
                np.arange(8, dtype=np.float64) + self.rank, group_name=name)

        def do_sendrecv(self):
            if self.rank == 0:
                col.send(np.array([42.0]), dst_rank=1, group_name=name)
            elif self.rank == 1:
                return col.recv(src_rank=0, group_name=name)
            return None

        def do_barrier(self):
            col.barrier(group_name=name)
            return self.rank

        def stats(self):
            return (col.get_rank(name), col.get_world_size(name))

        def call(self, fn):
            return fn(self.rank)

    workers = [Worker.remote(r, world) for r in range(world)]
    rt.get([w.stats.remote() for w in workers])
    return workers


def _run_all(rt, workers, method):
    return rt.get([getattr(w, method).remote() for w in workers])


# ------------------------------------------- mirrored: test_collective


def test_allreduce():
    def scenario(rt, col):
        return _plain(_run_all(rt, _group_actors(rt, col), "do_allreduce"))

    record = _both(scenario)
    assert record == [("float64", [10.0] * 4)] * 4


def test_allgather():
    def scenario(rt, col):
        return _plain(_run_all(rt, _group_actors(rt, col), "do_allgather"))

    record = _both(scenario)
    assert [[v[1][0] for v in r] for r in record] == [[0, 1, 2, 3]] * 4


def test_broadcast():
    def scenario(rt, col):
        return _plain(_run_all(rt, _group_actors(rt, col), "do_broadcast"))

    record = _both(scenario)
    assert all(r[1] == [0, 7, 14] for r in record)


def test_reducescatter():
    def scenario(rt, col):
        return _plain(_run_all(rt, _group_actors(rt, col),
                               "do_reducescatter"))

    record = _both(scenario)
    full = (4 * np.arange(8, dtype=np.float64) + 6).tolist()
    assert [r[1] for r in record] == [full[i:i + 2] for i in range(0, 8, 2)]


def test_sendrecv():
    def scenario(rt, col):
        return _plain(_run_all(rt, _group_actors(rt, col), "do_sendrecv"))

    record = _both(scenario)
    assert record[0] is None and record[1] == ("float64", [42.0])


def test_barrier_and_rank():
    def scenario(rt, col):
        workers = _group_actors(rt, col)
        return (sorted(_run_all(rt, workers, "do_barrier")),
                _run_all(rt, workers, "stats"))

    ranks, stats = _both(scenario)
    assert ranks == [0, 1, 2, 3]
    assert stats == [(r, 4) for r in range(4)]


def test_uninitialized_group_raises():
    def scenario(rt, col):
        return _error(lambda: col.allreduce(np.ones(2), group_name="nope"))

    name, message = _both(scenario)
    assert name == "RuntimeError" and "not initialized" in message


def test_world_size_mismatch_raises():
    def scenario(rt, col):
        @rt.remote
        class W:
            def go(self, world, rank):
                col.init_collective_group(world, rank, group_name="mm")
                return True

        a = W.remote()
        first = rt.get(a.go.remote(2, 0))
        b = W.remote()
        err = _error(lambda: rt.get(b.go.remote(3, 0)))
        return first, "world_size" in err[1]

    assert _both(scenario) == (True, True)


def test_sendrecv_queue_preserves_order():
    def scenario(rt, col):
        @rt.remote
        class Pair:
            def __init__(self, rank):
                col.init_collective_group(2, rank, group_name="q")

            def producer(self):
                for i in range(5):
                    col.send(np.array([float(i)]), dst_rank=1,
                             group_name="q")
                return True

            def consumer(self):
                return [float(col.recv(src_rank=0, group_name="q")[0])
                        for _ in range(5)]

        a, b = Pair.remote(0), Pair.remote(1)
        return rt.get(a.producer.remote()), rt.get(b.consumer.remote())

    assert _both(scenario) == (True, [0.0, 1.0, 2.0, 3.0, 4.0])


def test_broadcast_invalid_src_rank_fails_fast():
    def scenario(rt, col):
        @rt.remote
        class Solo:
            def __init__(self):
                col.init_collective_group(1, 0, group_name="solo")

            def bad(self):
                try:
                    col.broadcast(np.ones(2), src_rank=5, group_name="solo")
                    return "no-error"
                except ValueError as exc:
                    return str(exc)

        return rt.get(Solo.remote().bad.remote())

    assert "src_rank 5" in _both(scenario)


def test_allreduce_mixed_dtype_promotes_deterministically():
    def scenario(rt, col):
        @rt.remote
        class Rank:
            def __init__(self, rank):
                col.init_collective_group(2, rank, group_name="dt")
                self.rank = rank

            def run(self):
                arr = (np.full(3, 0.1, dtype=np.float64) if self.rank == 0
                       else np.full(3, 0.2, dtype=np.float32))
                return col.allreduce(arr, group_name="dt")

        return _plain(rt.get([Rank.remote(r).run.remote() for r in range(2)]))

    record = _both(scenario)
    want = float(np.float64(0.1) + np.float32(0.2))
    assert record == [("float64", [want] * 3)] * 2


def _process_group_allreduce(rt, col, values):
    """Two ``process=True`` actors in one store group, each contributing
    ``values[rank]``: the group's actor lives in the driver's runtime and
    the ranks reach it across the process boundary."""
    rt.shutdown()
    rt.init(num_cpus=8, process_workers=2)
    try:
        @rt.remote(process=True)
        class Rank:
            def __init__(self, rank):
                col.init_collective_group(2, rank, group_name="p")

            def allreduce(self, value):
                return col.allreduce(value, group_name="p"), os.getpid()

        ranks = [Rank.remote(r) for r in range(2)]
        out = rt.get([r.allreduce.remote(v) for r, v in zip(ranks, values)],
                     timeout=JOIN_TIMEOUT_S)
        pids = {pid for _, pid in out}
        assert os.getpid() not in pids and len(pids) == 2
        return [reduced for reduced, _ in out]
    finally:
        rt.shutdown()


def test_store_group_of_process_actors():
    """f32 numpy arrays through both packages; in the port, bf16 tensors
    too, which come back as bf16 tensors."""
    arrays = [np.full((4,), r + 1.0, np.float32) for r in range(2)]
    records = {name: _plain(_process_group_allreduce(rt, col, arrays))
               for name, (rt, col) in RUNTIMES.items()}
    assert records["ray_tpu_torch"] == records["ray_tpu"] \
        == [("float32", [3.0] * 4)] * 2
    tensors = [torch.full((4,), r + 1.0, dtype=torch.bfloat16)
               for r in range(2)]
    for got in _process_group_allreduce(ray_tpu_torch, port_col, tensors):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert got.tolist() == [3.0] * 4


# ------------------------------------- port only: tensors in the store


def _port_group(world=2, name="t"):
    return _group_actors(ray_tpu_torch, port_col, world, name)


@pytest.fixture
def port_runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_ops_keep_dtype_and_are_each_ranks_own(port_runtime, dtype):
    """Every op on tensors gives tensors of the input's dtype, with the
    reference's values; allreduce's results are separate copies."""
    rt = port_runtime
    workers = _port_group(4)

    def ops(rank):
        t = torch.full((4, 2), rank + 1.0, dtype=dtype)
        reduced = port_col.allreduce(t, group_name="t")
        gathered = port_col.allgather(t[0], group_name="t")
        shard = port_col.reducescatter(t * 2, group_name="t",
                                       op=port_col.ReduceOp.MAX)
        src = port_col.broadcast(t + 10, src_rank=2, group_name="t")
        return reduced, gathered, shard, src

    results = rt.get([w.call.remote(ops) for w in workers])
    for rank, (reduced, gathered, shard, src) in enumerate(results):
        for t in (reduced, *gathered, shard, src):
            assert isinstance(t, torch.Tensor) and t.dtype == dtype
        assert torch.equal(reduced, torch.full((4, 2), 10.0, dtype=dtype))
        assert [g.tolist() for g in gathered] == [[r + 1.0] * 2
                                                  for r in range(4)]
        assert torch.equal(shard, torch.full((1, 2), 8.0, dtype=dtype))
        assert torch.equal(src, torch.full((4, 2), 13.0, dtype=dtype))
    ptrs = {r[0].data_ptr() for r in results}
    assert len(ptrs) == 4
    results[0][0].add_(1)
    assert torch.equal(results[1][0], torch.full((4, 2), 10.0, dtype=dtype))


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32), (torch.int64, torch.float16),
    (torch.bfloat16, torch.float16), (torch.int32, torch.int64)])
def test_tensor_promotion_follows_torch(port_runtime, dtypes):
    rt = port_runtime
    workers = _port_group(2)

    def run(rank):
        return port_col.allreduce(torch.full((3,), rank + 2).to(dtypes[rank]),
                                  group_name="t")

    out = rt.get([w.call.remote(run) for w in workers])
    want = torch.promote_types(*dtypes)
    for t in out:
        assert t.dtype == want and t.tolist() == [5, 5, 5]


def test_tensor_and_array_in_one_op_are_refused(port_runtime):
    rt = port_runtime
    workers = _port_group(2)

    def run(rank):
        value = torch.ones(2) if rank == 0 else np.ones(2)
        try:
            port_col.allreduce(value, group_name="t")
        except Exception as exc:  # noqa: BLE001 — the store's TypeError
            return type(getattr(exc, "cause", exc)).__name__, str(exc)
        return "no-error"

    out = rt.get([w.call.remote(run) for w in workers])
    assert all(name == "TypeError" and "every rank" in message
               for name, message in out), out


def test_tensor_send_is_a_copy(port_runtime):
    rt = port_runtime
    workers = _port_group(2)
    sent = torch.arange(4.0)

    def run(rank):
        if rank == 0:
            port_col.send(sent, dst_rank=1, group_name="t")
            sent.add_(100)
            return None
        return port_col.recv(src_rank=0, group_name="t")

    assert rt.get([w.call.remote(run) for w in workers])[1].tolist() == \
        [0.0, 1.0, 2.0, 3.0]


# --------------------------------------------------- nccl against xla


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:8]), ("x",))


def _helper_inputs() -> dict:
    rng = np.random.default_rng(0)
    return {
        "device_allreduce": np.stack([np.full((3,), float(i))
                                      for i in range(8)]),
        "device_allreduce:rand": rng.integers(-50, 50, (8, 4, 3))
        .astype(np.float32),
        "device_allgather": np.arange(8, dtype=np.float32)[:, None],
        "device_reducescatter": np.stack(
            [np.arange(8, dtype=np.float32) + i for i in range(8)]),
        "device_reducescatter:rand": rng.integers(-50, 50, (8, 16, 2))
        .astype(np.float32),
        "device_ring_shift": np.arange(8, dtype=np.float32)[:, None],
    }


def _jax_ops() -> dict:
    ring = [(i, (i + 1) % 8) for i in range(8)]
    return {
        "psum": lambda s: lax.psum(s, "x"),
        "pmean": lambda s: lax.pmean(s, "x"),
        "pmax": lambda s: lax.pmax(s, "x"),
        "pmin": lambda s: lax.pmin(s, "x"),
        "all_gather": lambda s: lax.all_gather(s, "x"),
        "all_gather_tiled_1": lambda s: lax.all_gather(s, "x", axis=1,
                                                       tiled=True),
        "ppermute_ring": lambda s: lax.ppermute(s, "x", ring),
        "ppermute_partial": lambda s: lax.ppermute(s, "x", [(0, 3), (5, 1)]),
        "all_to_all_tiled": lambda s: lax.all_to_all(s, "x", 1, 0,
                                                     tiled=True),
        "all_to_all": lambda s: lax.all_to_all(s, "x", 1, 0),
        "axis_index": lambda s: jnp.full((1,), lax.axis_index("x")),
    }


def _spmd(fn):
    return shard_map(fn, mesh=_jax_mesh(), in_specs=P("x"),
                     out_specs=P("x"), check_vma=False)


def _jax_device_plane(inputs: dict) -> dict:
    want = {}
    for name, x in inputs["helpers"].items():
        want[f"helper_{name}"] = np.asarray(
            getattr(jax_col.xla, name.split(":")[0])(x))
    want["helper_device_ring_shift:3"] = np.asarray(
        jax_col.xla.device_ring_shift(inputs["helpers"]["device_ring_shift"],
                                      shift=3))
    x = jnp.asarray(inputs["x"])
    for name, fn in _jax_ops().items():
        want[f"op_{name}"] = np.asarray(_spmd(fn)(x))
    from torch_collective_ranks import DIFFERENTIABLE

    for name in DIFFERENTIABLE:
        w = jnp.asarray(inputs["w"][name])
        want[f"grad_{name}"] = np.asarray(jax.grad(
            lambda x: jnp.sum(_spmd(_jax_ops()[name])(x) * w))(x))
    return want


def _inputs() -> dict:
    from torch_collective_ranks import DIFFERENTIABLE

    rng = np.random.default_rng(1)
    x = rng.integers(-8, 8, (16, 8)).astype(np.float32)
    # Untiled all_to_all's weights too: its gradient is held by the
    # ranks against the tiled form's and finite differences.
    shapes = {name: _spmd(_jax_ops()[name])(jnp.asarray(x)).shape
              for name in (*DIFFERENTIABLE, "all_to_all")}
    return {"helpers": _helper_inputs(), "x": x,
            "w": {name: rng.integers(-4, 4, shape).astype(np.float32)
                  for name, shape in shapes.items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the port's records, one per rank; the JAX results)."""
    out_dir = tmp_path_factory.mktemp("torch_collective")
    inputs = _inputs()
    procs = torch_parallel_ranks.start_ranks(out_dir, inputs,
                                             "torch_collective_ranks")
    try:
        want = _jax_device_plane(inputs)
    finally:
        records = torch_parallel_ranks.join_ranks(procs, out_dir,
                                                  JOIN_TIMEOUT_S)
    return records, want


def _rank_results(world, case: str) -> list:
    records, _ = world
    assert all(r is not None for r in records), "a rank wrote no record"
    for r in records:
        assert case not in r["errors"], r["errors"][case]
    return [r["results"] for r in records]


@pytest.mark.parametrize("name", sorted(_helper_inputs()) +
                         ["device_ring_shift:3"])
def test_nccl_host_helpers_match_xla(world, name):
    ranks = _rank_results(world, "case_helpers")
    want = world[1][f"helper_{name}"]
    for got in ranks:
        got = got[f"helper_{name}"]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(_jax_ops()))
def test_nccl_primitives_match_lax_in_shard_map(world, name):
    ranks = _rank_results(world, "case_primitives")
    got = np.concatenate([r[f"op_{name}"] for r in ranks])
    want = world[1][f"op_{name}"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["psum", "pmean", "all_gather",
                                  "all_gather_tiled_1", "ppermute_ring",
                                  "ppermute_partial", "all_to_all_tiled"])
def test_nccl_primitive_gradients_match_jax(world, name):
    ranks = _rank_results(world, "case_primitives")
    got = np.concatenate([r[f"grad_{name}"] for r in ranks])
    np.testing.assert_array_equal(got, world[1][f"grad_{name}"])


@pytest.mark.parametrize("against", ["grad_all_to_all_via_tiled",
                                     "grad_all_to_all_fd"])
def test_nccl_untiled_all_to_all_gradient(world, against):
    """The gradient of the untiled all_to_all (the inverse all_to_all of
    the cotangent) on 8 gloo ranks equals the gradient of the tiled form
    and the finite differences of the global sum, exactly (integer
    values at f32), and is nonzero everywhere an input reaches the
    output."""
    ranks = _rank_results(world, "case_primitives")
    assert all(r["all_to_all_is_tiled_reshaped"] for r in ranks)
    got = np.concatenate([r["grad_all_to_all"] for r in ranks])
    want = np.concatenate([r[against] for r in ranks])
    assert got.shape == want.shape == (16, 8)
    np.testing.assert_array_equal(got, want)
    # The weights reach every input: the gradient is the weights moved
    # back, a permutation of them.
    weights = _inputs()["w"]["all_to_all"]
    assert sorted(got.ravel()) == sorted(weights.ravel())


def test_nccl_errors(world):
    for r in _rank_results(world, "case_errors"):
        assert r["unbound"].startswith("unbound axis name: x")
        assert "'pmax' not implemented" in r["pmax_grad"]
        assert "num_devices=4" in r["partial_mesh"]


def test_nccl_at_a_world_of_one_runs_each_collective_on_its_group():
    """The card's world of one, on gloo: the axis is a dim of the mesh
    (of size 1), so every helper and primitive runs its collective on
    that group and gives back its input; psum's gradient is ones."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import set_mesh

    nccl = port_col.nccl
    assert not dist.is_initialized()
    mesh = nccl.default_mesh(device="cpu")
    try:
        assert dist.get_backend() == "gloo" and mesh.size() == 1
        x = np.random.default_rng(7).integers(-8, 9, (1, 8, 4)) \
            .astype(np.float32)
        for name, want in (("device_allreduce", x[0]),
                           ("device_allgather", x),
                           ("device_reducescatter", x),
                           ("device_ring_shift", x)):
            np.testing.assert_array_equal(getattr(nccl, name)(x, mesh), want)
        t = torch.tensor(x[0])
        with set_mesh(mesh):
            for got, want in ((nccl.psum(t, "x"), t),
                              (nccl.pmax(t, "x"), t),
                              (nccl.all_gather(t, "x"), t[None]),
                              (nccl.ppermute(t, "x", [(0, 0)]), t),
                              (nccl.ppermute(t, "x", []), t * 0),
                              (nccl.all_to_all(t, "x", 1, 0, tiled=True),
                               t)):
                assert torch.equal(got, want)
            assert nccl.axis_index("x") == 0
            assert torch.equal(nccl.psum(t, "absent"), t)
            leaf = t.clone().requires_grad_(True)
            nccl.psum(leaf, "x").sum().backward()
            assert torch.equal(leaf.grad, torch.ones_like(t))
    finally:
        dist.destroy_process_group()
