"""The port's GPipe pipeline, the model's manual tensor-parallel path and
the expert-parallel MoE against the JAX package.

The multi-rank cases mirror tests/test_pipeline_moe.py. One
module-scoped fixture spawns 8 gloo ranks once
(``tests/torch_pipeline_ranks.py``, which imports no JAX); each rank runs
every case on the mesh it needs. While they run, this process computes
the same cases through the JAX package on its 8 virtual CPU devices from
the same numpy inputs and weights (``params_from_numpy``). Each test then
holds one case against its JAX result, at the reference tests' bounds,
all in f32:

- ``pipeline_apply``'s toy stages at pp=4 x dp=2 against JAX's
  ``pipeline_apply``: 1e-5;
- ``llama_pipeline_forward`` at pp=2 x dp=2 x tp=2 (without tp_axis,
  and with tp_axis="tp", MHA and GQA) against JAX's: 2e-4;
- the gradient of the pipelined tp loss on every leaf against JAX's
  gradient of the unpipelined loss (``llama.forward``): 1e-4;
- MoE in the pipeline at pp=2 x dp=4: logits 2e-4, aux 1e-5;
- the ep-sharded MoE forward at dp=2 x ep=4 against JAX's unsharded
  forward: logits 2e-4, aux rel 1e-4;
- 8 steps of the MoE train step at dp=2 x ep=2 x tp=2 against JAX's
  trajectory from the same weights: rtol 2e-2, the bound of
  ``__graft_entry__.py``'s MoE pass (top-1 routing is discrete).

The ranks' default group times out a collective after 60 s, the mesh's
groups after 300 s, each rank writes its results after every case, and
the fixture kills the ranks after ``JOIN_TIMEOUT_S``, so a hang fails
the cases it reaches instead of stalling the suite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks
from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import train_step as jax_train
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.parallel.pipeline import (
    llama_pipeline_forward as jax_pipeline_forward,
    pipeline_apply as jax_pipeline_apply,
    split_stages as jax_split_stages,
)
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import pipeline

JOIN_TIMEOUT_S = 300
TRAIN_STEPS = 8
TOY_TOL = 1e-5
LOGITS_TOL = 2e-4
GRAD_TOL = 1e-4
AUX_TOL = 1e-5
EP_AUX_RTOL = 1e-4
MOE_TRAIN_RTOL = 2e-2
LEAVES = ("embed.tokens", "final_norm", "layers.attn_norm", "layers.mlp_norm",
          "layers.w_down", "layers.w_gate", "layers.w_up", "layers.wk",
          "layers.wo", "layers.wq", "layers.wv", "lm_head")


def _tiny(num_experts=0, **changes):
    return dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                               dtype=jnp.float32, num_experts=num_experts,
                               **changes)


def _np_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jax_llama.init_params(cfg, jax.random.PRNGKey(seed)))


def _tokens(shape, seed):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         256))


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {
        "toy_w": rng.standard_normal((8, 16, 16)).astype(np.float32) * 0.3,
        "toy_x": rng.standard_normal((8, 16)).astype(np.float32),
        "pp_params": _np_params(_tiny()),
        "pp_gqa_params": _np_params(_tiny(num_kv_heads=2)),
        "pp_tokens": _tokens((4, 16), 1),
        "pp_grad_tokens": _tokens((4, 17), 1),
        "moe_params": _np_params(_tiny(4)),
        "moe_tokens": _tokens((8, 16), 1),
        "ep_tokens": _tokens((4, 16), 1),
        "train_params": _np_params(_tiny(2)),
        "train_tokens": _tokens((4, 17), 1),
        "train_steps": TRAIN_STEPS,
    }


def _jax_pipeline(inputs) -> dict:
    out = {}

    def toy_stage(stage_w, h):
        h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), h, stage_w)
        return h

    mesh = build_mesh(MeshConfig(pp=4, dp=2))
    with jax.set_mesh(mesh):
        staged = jax.device_put(jax_split_stages(jnp.asarray(
            inputs["toy_w"]), 4), NamedSharding(mesh, P("pp")))
        xs = jax.device_put(jnp.asarray(inputs["toy_x"]),
                            NamedSharding(mesh, P(("dp", "fsdp"))))
        out["toy_out"] = np.asarray(jax.jit(lambda p, h: jax_pipeline_apply(
            toy_stage, p, h, num_microbatches=2))(staged, xs))

    mesh = build_mesh(MeshConfig(pp=2, dp=2, tp=2))
    tokens = jnp.asarray(inputs["pp_tokens"])
    with jax.set_mesh(mesh):
        for name, kv_heads, key, tp_axis in (
                ("pp_logits", 4, "pp_params", None),
                ("pp_tp_logits", 4, "pp_params", "tp"),
                ("pp_tp_gqa_logits", 2, "pp_gqa_params", "tp")):
            cfg = _tiny(num_kv_heads=kv_heads)
            out[name] = np.asarray(jax.jit(
                lambda p, t: jax_pipeline_forward(
                    p, t, cfg, num_stages=2, num_microbatches=2,
                    tp_axis=tp_axis))(inputs[key], tokens))

    # The pipelined gradient's oracle: the unpipelined loss's gradient.
    toks = jnp.asarray(inputs["pp_grad_tokens"])
    loss, grads = jax.value_and_grad(
        lambda p: jax_llama.cross_entropy(
            jax_llama.forward(p, toks[:, :-1], _tiny()), toks[:, 1:]))(
        jax.tree.map(jnp.asarray, inputs["pp_params"]))
    out["pp_tp_loss"] = float(loss)
    out["pp_tp_grads"] = [np.asarray(g) for g in jax.tree.leaves(grads)]

    mesh = build_mesh(MeshConfig(pp=2, dp=4))
    with jax.set_mesh(mesh):
        logits, aux = jax.jit(lambda p, t: jax_pipeline_forward(
            p, t, _tiny(4), num_stages=2, num_microbatches=2,
            with_aux=True))(inputs["moe_params"],
                            jnp.asarray(inputs["moe_tokens"]))
    out["pp_moe_logits"], out["pp_moe_aux"] = np.asarray(logits), float(aux)
    return out


def _jax_moe(inputs) -> dict:
    cfg = _tiny(4)
    logits, aux = jax_llama.forward(
        jax.tree.map(jnp.asarray, inputs["moe_params"]),
        jnp.asarray(inputs["ep_tokens"]), cfg, with_aux=True)
    out = {"ep_logits": np.asarray(logits), "ep_aux": float(aux)}

    cfg = _tiny(2)
    mesh = build_mesh(MeshConfig(dp=2, ep=2, tp=2))
    with jax.set_mesh(mesh):
        optimizer = jax_train.default_optimizer(
            learning_rate=1e-2, warmup_steps=1, total_steps=50)
        state = jax_train.create_train_state(
            jax.tree.map(jnp.asarray, inputs["train_params"]), optimizer,
            mesh, jax_llama.param_logical_axes(cfg))
        step = jax_train.build_train_step(
            lambda p, b: jax_llama.loss_fn(p, b["tokens"], b["targets"],
                                           cfg), optimizer)
        tokens = jnp.asarray(inputs["train_tokens"])
        batch = jax_train.shard_batch(
            {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}, mesh)
        trajectory = []
        for _ in range(TRAIN_STEPS):
            state, metrics = step(state, batch)
            trajectory.append((float(metrics["loss"]),
                               float(metrics["grad_norm"])))
    out["moe_train_trajectory"] = trajectory
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the port's records, one per rank; the JAX results)."""
    out_dir = tmp_path_factory.mktemp("torch_pipeline")
    inputs = _inputs()
    procs = torch_parallel_ranks.start_ranks(out_dir, inputs,
                                             "torch_pipeline_ranks")
    try:
        want = {**_jax_pipeline(inputs), **_jax_moe(inputs)}
    finally:
        records = torch_parallel_ranks.join_ranks(procs, out_dir,
                                                  JOIN_TIMEOUT_S)
    return records, want


def _got(world, *keys):
    """Rank 0's results for ``keys``, after checking that every rank
    computed them and that every rank computed the same global values."""
    records = world[0]
    missing = [r for r, rec in enumerate(records) if rec is None]
    assert not missing, f"ranks {missing} wrote no results (hung or died)"
    for rec in records:
        lost = [k for k in keys if k not in rec["results"]]
        assert not lost, f"{lost} not computed: {rec['errors']}"
    values = [records[0]["results"][k] for k in keys]
    for rec in records[1:]:
        for key, value in zip(keys, values):
            theirs = rec["results"][key]
            if isinstance(value, list) and value and isinstance(
                    value[0], np.ndarray):
                for a, b in zip(theirs, value):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(np.asarray(theirs),
                                              np.asarray(value))
    return values


# ------------------------------------------------------- single process


def test_split_merge_stages_roundtrip():
    params = {"w": torch.arange(24.0).reshape(4, 3, 2)}
    staged = pipeline.split_stages(params, 2)
    assert staged["w"].shape == (2, 2, 3, 2)
    torch.testing.assert_close(pipeline.merge_stages(staged)["w"],
                               params["w"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        pipeline.split_stages(params, 3)


def test_staged_param_specs_follow_megatron():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    staged = pipeline.split_stages(params["layers"], 2)
    assert pipeline._staged_param_specs(staged, None, "pp") == {
        key: ("pp",) for key in staged}
    specs = pipeline._staged_param_specs(staged, "tp", "pp")
    assert specs["wq"] == ("pp", None, None, "tp", None)
    assert specs["wo"] == ("pp", None, "tp", None, None)
    assert specs["w_gate"] == ("pp", None, None, "tp")
    assert specs["w_down"] == ("pp", None, "tp", None)
    assert specs["attn_norm"] == ("pp",)


def test_pipeline_rejects_positions():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    tokens = torch.zeros((4, 16), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="contiguous positions"):
        pipeline.llama_pipeline_forward({}, tokens, cfg, 2, 2,
                                        positions=tokens)


def test_pipeline_moe_rejects_tp():
    """tests/test_pipeline_moe.py::test_llama_pipeline_moe_rejects_tp."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                              num_experts=4)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="pp x ep"):
        pipeline.llama_pipeline_forward(
            params, torch.zeros((4, 16), dtype=torch.long), cfg,
            num_stages=2, num_microbatches=2, tp_axis="tp", with_aux=True)


def test_pipeline_needs_a_mesh():
    with pytest.raises(ValueError, match="no mesh"):
        pipeline.pipeline_apply(lambda w, h: h, torch.zeros((2, 1, 4, 4)),
                                torch.zeros((4, 4)), num_microbatches=2)


# ------------------------------------------------------------ 8 ranks


def test_pipeline_apply_matches_jax(world):
    (got,) = _got(world, "toy_out")
    np.testing.assert_allclose(got, world[1]["toy_out"], atol=TOY_TOL,
                               rtol=TOY_TOL)


def test_pipeline_stage_count_must_match_mesh(world):
    """4 stages on a pp=2 mesh: every rank would hold 2 stages."""
    (refused,) = _got(world, "toy_refused")
    assert refused is not None and "mesh axis size" in refused


@pytest.mark.parametrize("name", ["pp_logits", "pp_tp_logits",
                                  "pp_tp_gqa_logits"],
                         ids=["replicated_tp", "tp_axis_mha", "tp_axis_gqa"])
def test_llama_pipeline_forward_matches_jax(world, name):
    (got,) = _got(world, name)
    np.testing.assert_allclose(got, world[1][name], atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


def test_pipelined_tp_loss_matches_unpipelined_jax(world):
    (got,) = _got(world, "pp_tp_loss")
    np.testing.assert_allclose(got, world[1]["pp_tp_loss"], atol=GRAD_TOL,
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("leaf", range(len(LEAVES)),
                         ids=lambda i: LEAVES[i])
def test_pipelined_tp_grad_matches_unpipelined_jax(world, leaf):
    """pp x tp's gradient, through the stage shift's backward, Megatron's
    f and g and local_map's gradient placements, against jax.grad of
    the plain forward's loss (a gradient scaled by the tp or pp size, or
    missing from a stage, fails here and nowhere else)."""
    (got,) = _got(world, "pp_tp_grads")
    np.testing.assert_allclose(got[leaf], world[1]["pp_tp_grads"][leaf],
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_llama_pipeline_moe_matches_jax_with_aux(world):
    logits, aux = _got(world, "pp_moe_logits", "pp_moe_aux")
    np.testing.assert_allclose(logits, world[1]["pp_moe_logits"],
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(aux, world[1]["pp_moe_aux"], atol=AUX_TOL,
                               rtol=AUX_TOL)


def test_moe_ep_sharded_matches_single_device_jax(world):
    logits, aux, placed = _got(world, "ep_logits", "ep_aux",
                               "ep_w_gate_placements")
    np.testing.assert_allclose(logits, world[1]["ep_logits"],
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert aux == pytest.approx(world[1]["ep_aux"], rel=EP_AUX_RTOL)
    # The mesh is (dp, ep): w_gate [L, E, H, M] has its experts over ep.
    assert placed == "[Replicate(), Shard(dim=1)]"


def test_moe_train_step_matches_jax_trajectory(world):
    (got,) = _got(world, "moe_train_trajectory")
    np.testing.assert_allclose(got, world[1]["moe_train_trajectory"],
                               rtol=MOE_TRAIN_RTOL)
    # Warmup 1: the first update has lr 0, then the loss falls.
    assert got[-1][0] < got[1][0]


def test_moe_train_step_keeps_placements(world):
    (placed,) = _got(world, "moe_train_placed")
    assert placed
