"""The slice as a whole, through both packages: two daemons, A and B,
and a driver with no CPU, so every task rides the pipelined path (the
submit ring, batched dispatch, the batch RPC). The flash-attention
forward runs on A; eight RMSNorm tasks over its output run on B,
submitted at once through the ring (pinned to B by node affinity);
eight CPU tasks take their results
as ref arguments and ride batch RPCs down the classic branch; then a
burst of 200 plain tasks fuses in the daemons.

The same numpy-seeded inputs go through ``ray_tpu`` (flash in Pallas
interpret mode, RMSNorm's Pallas kernel interpreted, as the JAX
package's own tests run them on the CPU) and through ``ray_tpu_torch``
(their plain PyTorch versions, the CPU's path); the tensors agree to
atol 1e-5 (f32). Every task leaves one marker file per run, so each ran
exactly once, and the counters' invariants are equal.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

from torch_cluster_sides import wait_until
from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")
SHAPE = (1, 256, 4, 64)  # [B, L, H, D]
N_NORM = 8
ATOL = 1e-5
SLICE_KEYS = ("rpc_batch_flush_ms", "rpc_batch_max_entries",
              "dispatch_batch_max", "worker_pipeline_depth",
              "fused_execution", "fused_max_run_tasks",
              "fused_run_wall_budget_s", "submit_pipeline",
              "submit_ring_size", "submit_flush_max")


def _inputs():
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal(SHAPE, dtype=np.float32)
               for _ in range(3))
    scale = rng.standard_normal(SHAPE[2] * SHAPE[3], dtype=np.float32)
    return q, k, v, scale


def _flash(pkg):
    if pkg == "ray_tpu":
        def flash(q, k, v):
            import jax.numpy as jnp
            import numpy as np

            from ray_tpu.ops import flash_attention

            return np.asarray(flash_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                block_q=128, block_k=128, interpret=True))
    else:
        def flash(q, k, v):
            import torch

            from ray_tpu_torch.ops import flash_attention

            return flash_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=True,
                                   block_q=128, block_k=128).numpy()
    return flash


def _norm(pkg):
    """RMSNorm of one eighth of the output's rows; leaves a marker."""
    if pkg == "ray_tpu":
        def norm(o, scale, part, mdir):
            import os

            import jax.numpy as jnp
            import numpy as np

            from ray_tpu.ops import rms_norm

            open(os.path.join(mdir, f"norm-{part}-{os.getpid()}-"
                              f"{os.urandom(4).hex()}"), "w").close()
            x = o.reshape(o.shape[0] * o.shape[1], -1)
            rows = x.shape[0] // 8
            return np.asarray(rms_norm(
                jnp.asarray(x[part * rows:(part + 1) * rows]),
                jnp.asarray(scale), 1e-5, interpret=True))
    else:
        def norm(o, scale, part, mdir):
            import os

            import torch

            from ray_tpu_torch.ops import rms_norm

            open(os.path.join(mdir, f"norm-{part}-{os.getpid()}-"
                              f"{os.urandom(4).hex()}"), "w").close()
            x = o.reshape(o.shape[0] * o.shape[1], -1)
            rows = x.shape[0] // 8
            return rms_norm(torch.tensor(x[part * rows:(part + 1) * rows]),
                            torch.tensor(scale), 1e-5).numpy()
    return norm


def _daemon_pipeline(runtime) -> dict:
    with runtime._remote_nodes_lock:
        handles = list(runtime._remote_nodes.values())
    agg: dict = {}
    for handle in handles:
        pipe = handle._control.call("executor_stats")["pipeline"]
        for key, value in pipe.items():
            agg[key] = agg.get(key, 0) + int(value)
    return agg


def slice_run(pkg, tmp_path):
    rt = importlib.import_module(pkg)
    cluster_cls = importlib.import_module(f"{pkg}.cluster_utils").Cluster
    rt.shutdown()
    root = tmp_path / pkg
    mdir = root / "markers"
    mdir.mkdir(parents=True)
    cluster = cluster_cls(log_dir=str(root / "cluster"))
    runtime = None
    try:
        cluster.add_node(num_cpus=2, resources={"node_a": 1})
        cluster.add_node(num_cpus=2, resources={"node_b": 1})
        assert cluster.wait_for_nodes(2, timeout=90)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        assert wait_until(lambda: rt.cluster_resources().get("CPU", 0) >= 4)
        q, k, v, scale = _inputs()
        o_ref = rt.remote(resources={"node_a": 1})(_flash(pkg)).remote(
            q, k, v)
        affinity = importlib.import_module(
            f"{pkg}.util.scheduling_strategies").NodeAffinitySchedulingStrategy
        node_b = next(
            n["node_id"] for n in cluster.gcs._list_nodes()
            if n["alive"] and n["resources"].get("node_b"))
        norm = rt.remote(scheduling_strategy=affinity(node_b, soft=False))(
            _norm(pkg))
        submits0 = runtime.execution_pipeline_stats()["submit"]
        norm_refs = [norm.remote(o_ref, scale, i, str(mdir))
                     for i in range(N_NORM)]

        @rt.remote(num_cpus=1)
        def checksum(x, i, mdir):
            import os

            import numpy as np

            open(os.path.join(mdir, f"sum-{i}-{os.getpid()}-"
                              f"{os.urandom(4).hex()}"), "w").close()
            return float(np.asarray(x, dtype=np.float64).sum())

        sum_refs = [checksum.remote(r, i, str(mdir))
                    for i, r in enumerate(norm_refs)]
        sums = rt.get(sum_refs, timeout=180)
        norms = rt.get(norm_refs, timeout=60)
        o = rt.get(o_ref, timeout=60)
        pipe_mid = _daemon_pipeline(runtime)

        @rt.remote(num_cpus=1)
        def tick(i, mdir):
            import os

            open(os.path.join(mdir, f"tick-{i}-{os.urandom(4).hex()}"),
                 "w").close()
            return i * 2

        burst = rt.get([tick.remote(i, str(mdir)) for i in range(200)],
                       timeout=120)
        pipe = _daemon_pipeline(runtime)
        stats = runtime.execution_pipeline_stats()
        names = os.listdir(mdir)
        runs = {kind: [sum(1 for n in names if n.startswith(f"{kind}-{i}-"))
                       for i in range(count)]
                for kind, count in (("norm", N_NORM), ("sum", N_NORM),
                                    ("tick", 200))}
        record = {
            "burst": burst == [i * 2 for i in range(200)],
            "once": {kind: set(r) == {1} for kind, r in runs.items()},
            # The reference's columnar lanes take the plain submits
            # (col_submits); the port's ring takes them all.
            "submitted": sum(stats["submit"].get(key, 0) - submits0.get(key, 0)
                             for key in ("ring_submits", "col_submits"))
            >= 2 * N_NORM + 200,
            "fused": pipe["fused_tasks"] - pipe_mid["fused_tasks"] > 0,
            "accounted": (pipe["fused_tasks"] - pipe_mid["fused_tasks"])
            + (pipe["fused_fallbacks"] - pipe_mid["fused_fallbacks"])
            + (pipe["worker_lease_tasks"] - pipe_mid["worker_lease_tasks"])
            >= 200,
            "sealed_in_groups": stats["seal"]["batch_sealed_objects"]
            >= stats["seal"]["batch_seals"] > 0,
            "driver_mirror": wait_until(
                lambda: runtime.execution_pipeline_stats()["fused"]
                ["fused_tasks"] == _daemon_pipeline(runtime)["fused_tasks"],
                30)}
        # The ref-bearing tasks rode batch RPCs (the port sends every
        # claim for a daemon in one; the reference sends a claim of one
        # on its single path).
        record["batched"] = pipe_mid["batch_rpcs"] > 0 \
            if pkg == "ray_tpu_torch" else None
        return record, np.asarray(o), [np.asarray(n) for n in norms], sums
    finally:
        if runtime is not None:
            rt.shutdown()
        cluster.shutdown()


def test_flash_rmsnorm_and_a_fused_burst_ride_the_pipelined_path(tmp_path):
    with time_limit(400):
        results = {pkg: slice_run(pkg, tmp_path) for pkg in PACKAGES}
    records = {pkg: r[0] for pkg, r in results.items()}
    assert records["ray_tpu_torch"].pop("batched") is True
    assert records["ray_tpu"].pop("batched") is None
    assert records["ray_tpu"] == records["ray_tpu_torch"] == {
        "burst": True, "once": {"norm": True, "sum": True, "tick": True},
        "submitted": True, "fused": True, "accounted": True,
        "sealed_in_groups": True, "driver_mirror": True}, records
    o_ref, norms_ref, sums_ref = results["ray_tpu"][1:]
    o_port, norms_port, sums_port = results["ray_tpu_torch"][1:]
    assert o_port.shape == o_ref.shape == SHAPE
    np.testing.assert_allclose(o_port, o_ref, atol=ATOL, rtol=0)
    for a, b in zip(norms_port, norms_ref):
        assert a.shape == b.shape == (SHAPE[1] // N_NORM, SHAPE[2] * SHAPE[3])
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    # Each checksum is its own norm's sum: the refs reached the right
    # tasks in both packages.
    for port_sum, norm in zip(sums_port, norms_port):
        assert abs(port_sum - float(norm.astype(np.float64).sum())) < 1e-6
    np.testing.assert_allclose(sums_port, sums_ref, atol=1e-2, rtol=0)


def test_config_keys_have_the_reference_defaults_and_env_overrides(
        monkeypatch):
    """The ten keys the pipelined path reads have the reference's
    defaults, and the port's environment prefix overrides them."""
    port = importlib.import_module("ray_tpu_torch._private.config")
    ref = importlib.import_module("ray_tpu._private.config")
    for key in SLICE_KEYS:
        assert port._DEFAULTS[key] == ref._DEFAULTS[key], key
    monkeypatch.setenv("RAY_TPU_TORCH_FUSED_EXECUTION", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_SUBMIT_RING_SIZE", "32")
    monkeypatch.setenv("RAY_TPU_TORCH_FUSED_RUN_WALL_BUDGET_S", "0.5")
    config = port.Config()
    assert (config.fused_execution, config.submit_ring_size,
            config.fused_run_wall_budget_s) == (False, 32, 0.5)


def test_pinned_ref_bearing_burst_completes_after_spillbacks(tmp_path):
    """Port only: a burst of ref-bearing tasks that only node B can hold
    (a custom resource it alone has) is batched past B's free slots; B
    answers the excess busy (a ref-bearing entry takes the classic path,
    which does not park), and the spillback's avoid set must not exclude
    the one node that can ever run them. The reference parks them for
    good there (ROADMAP queue 3): 4 of 8 ran in 180 s."""
    rt = importlib.import_module("ray_tpu_torch")
    from ray_tpu_torch.cluster_utils import Cluster

    rt.shutdown()
    cluster = Cluster(log_dir=str(tmp_path / "cluster"))
    try:
        with time_limit(200):
            cluster.add_node(num_cpus=2)
            cluster.add_node(num_cpus=2, resources={"node_b": 1})
            assert cluster.wait_for_nodes(2, timeout=90)
            rt.init(num_cpus=0, address=cluster.address)
            assert wait_until(
                lambda: rt.cluster_resources().get("CPU", 0) >= 4)
            base = rt.put(np.arange(8.0))

            @rt.remote(resources={"node_b": 1})
            def scaled(x, i):
                import time

                time.sleep(0.05)
                return float(x.sum()) * i

            out = rt.get([scaled.remote(base, i) for i in range(8)],
                         timeout=120)
            assert out == [28.0 * i for i in range(8)]
    finally:
        rt.shutdown()
        cluster.shutdown()
