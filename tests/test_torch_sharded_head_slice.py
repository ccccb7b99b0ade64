"""The slice as a whole, through both packages: a durable ``Cluster`` with
a sharded head (``gcs_shards=4``) and two daemons, A and B, a driver
connected with ``metrics_port=0``; the flash-attention forward on A,
its output's shard killed, RMSNorm over the output on B.

The same numpy-seeded inputs go through ``ray_tpu`` (flash in Pallas
interpret mode, RMSNorm's Pallas kernel interpreted, as the JAX
package's own tests run them on the CPU) and through ``ray_tpu_torch``
(their plain PyTorch versions, the CPU's path); the outputs agree to
atol 1e-5 (f32). The records of the control plane are equal: the
output's id in the directory of the shard ``shard_of`` names, the kill
replaying its records and moving only that shard's epoch and restores,
the task over the output after the kill, the scrape's shard rows and
per-node ``exec`` counts, the history's samples for both nodes, and the
watchdog's zero verdicts.
"""

from __future__ import annotations

import importlib
import re
import time
import urllib.request

import numpy as np

from torch_time_limit import time_limit

PACKAGES = ("ray_tpu", "ray_tpu_torch")
SHAPE = (1, 384, 4, 64)  # [B, L, H, D]: 384 KiB of f32, kept on A
ATOL = 1e-5


def _inputs():
    rng = np.random.default_rng(19)
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
    if pkg == "ray_tpu":
        def norm(o, scale):
            import jax.numpy as jnp
            import numpy as np

            from ray_tpu.ops import rms_norm

            x = o.reshape(o.shape[0] * o.shape[1], -1)
            return np.asarray(rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                       1e-5, interpret=True))
    else:
        def norm(o, scale):
            import torch

            from ray_tpu_torch.ops import rms_norm

            x = torch.tensor(o.reshape(o.shape[0] * o.shape[1], -1))
            return rms_norm(x, torch.tensor(scale), 1e-5).numpy()
    return norm


def _wait(predicate, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


def _scrape(port: int) -> str:
    return urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics",
        timeout=10).read().decode().replace("ray_tpu_torch_", "ray_tpu_")


def slice_run(pkg, tmp_path):
    rt = importlib.import_module(pkg)
    config = importlib.import_module(f"{pkg}._private.config").GLOBAL_CONFIG
    gcs_shard = importlib.import_module(f"{pkg}._private.gcs_shard")
    cluster_cls = importlib.import_module(f"{pkg}.cluster_utils").Cluster
    # Past the first tick's snapshot the shards write only their WALs
    # (an hour's interval), so the kill replays the output's location.
    config.update({"gcs_shards": 4, "metrics_history_interval_s": 0.5,
                   "gcs_snapshot_interval_s": 3600.0})
    rt.shutdown()
    root = tmp_path / pkg
    cluster = cluster_cls(log_dir=str(root / "cluster"),
                          persist_path=str(root / "gcs_snapshot.pkl"))
    head = cluster.gcs
    try:
        nodes = {"A": cluster.add_node(num_cpus=2, resources={"node_a": 1}),
                 "B": cluster.add_node(num_cpus=2, resources={"node_b": 1})}
        assert cluster.wait_for_nodes(2, timeout=90)
        runtime = rt.init(num_cpus=0, address=cluster.address,
                          metrics_port=0)
        _wait(lambda: rt.cluster_resources().get("CPU", 0) >= 4, 60,
              "the nodes to join the driver")
        q, k, v, scale = _inputs()
        o_ref = rt.remote(resources={"node_a": 1})(_flash(pkg)).remote(
            q, k, v)
        rt.wait([o_ref], timeout=180)
        o_hex = o_ref.hex()
        victim = gcs_shard.shard_of(o_hex, 4)
        # The driver publishes the output's holder (A) to its shard.
        _wait(lambda: o_hex in head._shards[victim].directory.locations(),
              30, "the output's location in its shard")
        routed = all(gcs_shard.shard_of(key, 4) == shard.index
                     for shard in head._shards
                     for key in shard.directory.locations())
        before = head.shard_stats()
        epoch = head.epoch
        replayed = head._kill_shard(victim)
        after = head.shard_stats()
        n_ref = rt.remote(resources={"node_b": 1})(_norm(pkg)).remote(
            o_ref, scale)
        out = rt.get(n_ref, timeout=180)
        o = rt.get(o_ref, timeout=60)
        # The drivers and daemons re-sync: the output's holder is back
        # in its shard under the new epoch.
        _wait(lambda: o_hex in head._shards[victim].directory.locations(),
              30, "the output's location after the kill")
        port = runtime.metrics_agent.port
        node_hex = {name: next(
            n["node_id"] for n in head._list_nodes()
            if n["alive"] and n["resources"].get(f"node_{name.lower()}"))
            for name in nodes}

        def exec_counts():
            body = _scrape(port)
            counts = {}
            for name, h in node_hex.items():
                m = re.search(r'ray_tpu_stage_latency_count\{stage="exec",'
                              r'node="%s"\} (\d+)' % h[:16], body)
                counts[name] = int(m.group(1)) if m else 0
            return counts if min(counts.values()) >= 1 else None

        counts = _wait(exec_counts, 30, "both nodes' exec histograms")
        body = _scrape(port)
        history = _wait(lambda: (lambda h: h if h and all(
            any(n.startswith(x[:16]) for n in h["nodes"])
            for x in node_hex.values()) else None)(
            runtime.metrics_history(window_s=60.0)), 30,
            "both nodes in the history")
        health = runtime.cluster_health()
        record = {
            "routed": routed,
            "replayed": replayed >= 1, "epoch_bump": head.epoch - epoch,
            "victim_only": [a["restores"] - b["restores"]
                            for a, b in zip(after, before)]
            == [int(i == victim) for i in range(4)],
            "epochs_moved": [a["epoch"] - b["epoch"]
                             for a, b in zip(after, before)]
            == [int(i == victim) for i in range(4)],
            "shape": list(np.asarray(out).shape),
            "exec_counts": counts,
            "shard_rows": sorted(set(re.findall(
                r'ray_tpu_gcs_shard\{shard="(\d)",key="restores"\}', body))),
            "history_nodes": len(history["nodes"]) >= 2,
            "verdicts": health["verdicts"], "armed": health["armed"]}
        return record, np.asarray(o), np.asarray(out)
    finally:
        rt.shutdown()
        cluster.shutdown()
        config.reset()
        gcs_shard.init_from_config()


def test_flash_and_rmsnorm_results_survive_a_shard_kill(tmp_path):
    with time_limit(300):
        results = {pkg: slice_run(pkg, tmp_path) for pkg in PACKAGES}
    records = {pkg: r[0] for pkg, r in results.items()}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    assert records["ray_tpu_torch"] == {
        "routed": True, "replayed": True, "epoch_bump": 1,
        "victim_only": True, "epochs_moved": True,
        "shape": [SHAPE[1], SHAPE[2] * SHAPE[3]],
        "exec_counts": {"A": 1, "B": 1}, "shard_rows": ["0", "1", "2", "3"],
        "history_nodes": True, "verdicts": [], "armed": True}
    for i in (1, 2):  # the flash output, then the norm
        np.testing.assert_allclose(results["ray_tpu_torch"][i],
                                   results["ray_tpu"][i], atol=ATOL,
                                   rtol=0)
