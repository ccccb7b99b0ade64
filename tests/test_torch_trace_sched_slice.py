"""The twenty-first slice as a whole, on the CPU, through both packages:
tracing, locality-scored placement and straggler speculation on a daemon
cluster, with the flash forward and RMSNorm as the tasks.

Two daemons, A (``node_a``, every execution straggled by the
``sched.straggle`` chaos site) and B (``node_b``), and a tracing driver
of no CPU. A traced flash forward runs pinned to A (the reference's in
Pallas interpret mode, the port's plain version); its output stays on A.
An RMSNorm task over it, with the DEFAULT strategy and no affinity, must
land on A, the holder, in both packages. Then speculation is armed: a
function warmed on B, submitted soft-pinned to A, gets a copy on B that
wins, and A's straggler is cancelled inside its delay, so its marker file
is never written. The flash inputs ride as refs, so both tasks take the
single execute path on both packages (the port sends a lone plain task on
the batch RPC, the reference on the single path).

Tensors agree to atol 1e-5 (f32). The merged traces' structure (each
task's stages in order, its ``daemon:execute`` span on A's lane under the
driver's submit span, the lanes) is equal.
"""

from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np
from torch_cluster_sides import wait_until
from torch_time_limit import time_limit

SHAPE = (1, 512, 4, 64)  # [B, L, H, D]: 512 KiB, over the inline reply
ATOL = 1e-5
STRAGGLE_S = "1.5"
TAG_ENV = {"ray_tpu": "RAY_TPU_NODE_TAG",
           "ray_tpu_torch": "RAY_TPU_TORCH_NODE_TAG"}
SLOW_NODE_ENV = {
    "RAY_TPU_CHAOS": "seed=13,sched.straggle=1.0",
    "RAY_TPU_TORCH_CHAOS": "seed=13,sched.straggle=1.0",
    "RAY_TPU_STRAGGLE_S": STRAGGLE_S,
    "RAY_TPU_TORCH_STRAGGLE_S": STRAGGLE_S,
}


def _inputs():
    rng = np.random.default_rng(21)
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


def _norm(pkg, tag_env):
    """RMSNorm over the output's rows, and the node it ran on."""
    if pkg == "ray_tpu":
        def norm(o, scale):
            import os

            import jax.numpy as jnp
            import numpy as np

            from ray_tpu.ops import rms_norm

            x = o.reshape(o.shape[0] * o.shape[1], -1)
            return (np.asarray(rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                        1e-5, interpret=True)),
                    os.environ.get(tag_env, "?"))
    else:
        def norm(o, scale):
            import os

            import torch

            from ray_tpu_torch.ops import rms_norm

            x = o.reshape(o.shape[0] * o.shape[1], -1)
            return (rms_norm(torch.tensor(x), torch.tensor(scale),
                             1e-5).numpy(),
                    os.environ.get(tag_env, "?"))
    return norm


def _task_record(tracing, ev, submit_span, spans, lane) -> dict:
    """One traced task's structure: its stages in STAGES order, and
    whether a daemon:execute span sits on ``lane`` under the driver's
    submit span, in its trace."""
    present = [s for s in tracing.STAGES if s in ev.stage_ts]
    linked = [s for s in spans if s.name == "daemon:execute"
              and s.parent_id == submit_span.span_id
              and s.trace_id == submit_span.trace_id]
    return {"stages": present,
            "ordered": [ev.stage_ts[s] for s in present]
            == sorted(ev.stage_ts[s] for s in present),
            "daemon_span_on_holder": [s.proc for s in linked] == [lane],
            "worker_span": any(s.name == "worker:execute"
                               and s.parent_id == submit_span.span_id
                               for s in spans)}


def slice_run(pkg: str, tmp_path) -> dict:
    rt = importlib.import_module(pkg)
    tracing = importlib.import_module(f"{pkg}.util.tracing")
    config = importlib.import_module(f"{pkg}._private.config").GLOBAL_CONFIG
    strategies = importlib.import_module(f"{pkg}.util.scheduling_strategies")
    affinity = strategies.NodeAffinitySchedulingStrategy
    tag_env = TAG_ENV[pkg]
    rt.shutdown()
    root = tmp_path / pkg
    mdir = root / "markers"
    mdir.mkdir(parents=True)
    cluster = importlib.import_module(f"{pkg}.cluster_utils").Cluster(
        log_dir=str(root / "cluster"))
    runtime = None
    tracing.clear()
    tracing.enable()
    try:
        cluster.add_node(num_cpus=2, resources={"node_a": 1.0},
                         heartbeat_period_s=0.5, env=SLOW_NODE_ENV)
        cluster.add_node(num_cpus=2, resources={"node_b": 1.0},
                         heartbeat_period_s=0.5)
        assert cluster.wait_for_nodes(2, timeout=90)
        runtime = rt.init(num_cpus=0, address=cluster.address)
        assert wait_until(lambda: rt.cluster_resources().get("CPU", 0) >= 4)
        hexes = {name: next(n["NodeID"] for n in rt.nodes()
                            if name in n["Resources"])
                 for name in ("node_a", "node_b")}

        @rt.remote(num_cpus=1)
        def tag(env_name):
            import os as _os

            return _os.environ.get(env_name, "?")

        a_tag = rt.get(tag.options(scheduling_strategy=affinity(
            node_id=hexes["node_a"], soft=False)).remote(tag_env),
            timeout=60)
        q, k, v, scale = _inputs()
        q_ref, k_ref, v_ref = rt.put(q), rt.put(k), rt.put(v)

        # The traced flash forward, pinned to A; its output stays there.
        flash = rt.remote(num_cpus=1, scheduling_strategy=affinity(
            node_id=hexes["node_a"], soft=False))(_flash(pkg))
        with tracing.trace_span("submit:flash") as flash_span:
            o_ref = flash.remote(q_ref, k_ref, v_ref)
        assert wait_until(lambda: runtime.store.contains(o_ref.id()), 120)
        base = runtime.execution_pipeline_stats()["sched"]

        # RMSNorm over it, DEFAULT strategy: placed by locality.
        norm = rt.remote(num_cpus=1)(_norm(pkg, tag_env))
        with tracing.trace_span("submit:norm") as norm_span:
            norm_ref = norm.remote(o_ref, scale)
        normed, norm_tag = rt.get(norm_ref, timeout=120)
        sched = runtime.execution_pipeline_stats()["sched"]
        o = rt.get(o_ref, timeout=60)

        # The merged trace.
        path = str(root / "trace.json")
        n_events = tracing.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        spans = tracing.get_spans()
        by_name = {}
        for ev in runtime.gcs.list_task_events():
            by_name.setdefault(ev.name.rsplit(".", 1)[-1], ev)
        lane = f"node:{a_tag[:8]}"
        traces = {
            "flash": _task_record(tracing, by_name["flash"], flash_span,
                                  spans, lane),
            "norm": _task_record(tracing, by_name["norm"], norm_span,
                                 spans, lane),
            "events": n_events == len(events) > 0,
            "lanes": sorted({p.split(":")[0] for p in
                             (e["args"]["name"] for e in events
                              if e["ph"] == "M"
                              and e["name"] == "process_name")}),
        }
        tracing.disable()

        # A speculated straggler: warmed on B, soft-pinned to A.
        config.update({"speculation_min_samples": 4,
                       "speculation_p99_factor": 3.0,
                       "speculation_watch_period_ms": 50})
        runtime.configure_speculation(True)

        @rt.remote(num_cpus=1)
        def work(i, mdir, env_name):
            import os as _os

            open(f"{mdir}/ran-{i}-{_os.environ.get(env_name, '?')}",
                 "w").close()
            return i * 10

        fast = affinity(node_id=hexes["node_b"], soft=True)
        warm = [rt.get(work.options(scheduling_strategy=fast).remote(
            i, str(mdir), tag_env), timeout=60) for i in range(5)]
        spec_base = runtime.execution_pipeline_stats()["sched"]
        t0 = time.monotonic()
        straggler = rt.get(work.options(scheduling_strategy=affinity(
            node_id=hexes["node_a"], soft=True)).remote(
                99, str(mdir), tag_env), timeout=60)
        wall = time.monotonic() - t0
        assert wait_until(lambda: runtime.execution_pipeline_stats()[
            "sched"]["speculations_won"] > spec_base["speculations_won"],
            30)
        # The loser's cancel reached A inside its delay: wait that long,
        # then A must have written no marker.
        time.sleep(float(STRAGGLE_S) + 1.0)
        markers = sorted(f.split("-", 2)[2] != a_tag
                         for f in os.listdir(mdir)
                         if f.startswith("ran-99-"))
        spec_after = runtime.execution_pipeline_stats()["sched"]
        return {
            "o": o, "normed": normed,
            "placement": {
                "norm_on_holder": norm_tag == a_tag,
                "hits": sched["locality_hits"] - base["locality_hits"] >= 1,
                "bytes_saved": sched["locality_bytes_saved"]
                - base["locality_bytes_saved"] >= o.nbytes},
            "traces": traces,
            "speculation": {
                "warm": warm, "value": straggler,
                "cut_the_straggle": wall < float(STRAGGLE_S),
                "launched": spec_after["speculations_launched"]
                - spec_base["speculations_launched"],
                "won": spec_after["speculations_won"]
                - spec_base["speculations_won"],
                # One marker, written by the winner on B.
                "markers_off_a": markers},
        }
    finally:
        tracing.disable()
        tracing.clear()
        if runtime is not None:
            runtime.configure_speculation(False)
        config.reset()
        rt.shutdown()
        cluster.shutdown()


def test_traced_flash_locality_norm_and_speculated_straggler(tmp_path):
    results = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        with time_limit(300):
            results[pkg] = slice_run(pkg, tmp_path)
    ref, port = results["ray_tpu"], results["ray_tpu_torch"]
    np.testing.assert_allclose(port.pop("o"), ref.pop("o"), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(port.pop("normed"), ref.pop("normed"),
                               atol=ATOL, rtol=0)
    assert ref == port, results
    full = list(importlib.import_module("ray_tpu_torch.util.tracing").STAGES)
    assert port == {
        "placement": {"norm_on_holder": True, "hits": True,
                      "bytes_saved": True},
        "traces": {
            "flash": {"stages": full, "ordered": True,
                      "daemon_span_on_holder": True, "worker_span": True},
            "norm": {"stages": full, "ordered": True,
                     "daemon_span_on_holder": True, "worker_span": True},
            "events": True, "lanes": ["driver", "node", "worker"]},
        "speculation": {"warm": [0, 10, 20, 30, 40], "value": 990,
                        "cut_the_straggle": True, "launched": 1, "won": 1,
                        "markers_off_a": [True]},
    }
