"""The port's sharded path across 8 gloo ranks, against the JAX package on
its 8 virtual CPU devices.

One module-scoped fixture spawns the 8 ranks once
(``tests/torch_parallel_ranks.py``, which imports no JAX): each rank runs
every case, each on the mesh it needs, and writes its results. While they
run, this process computes the same cases through the JAX package from
the same numpy inputs: ring attention through ``ring_attention_sharded``,
Ulysses through ``shard_map``, flash attention through
``flash_attention_gspmd`` (Pallas in interpret mode), the model with
``attention="ring"``, and the sharded train step. Each test then holds
one case against its JAX result:

- ring and Ulysses attention, f32: atol/rtol 2e-5, the reference's own
  bound against plain attention (tests/test_parallel.py); the ring's
  gradient 2e-4 (ditto);
- ``flash_attention_gspmd`` at dp=2 x tp=2 (and sp=2, over which its spec
  gathers the sequence), GQA 4/2 heads, f32: output 1e-5, gradients 1e-4,
  the bounds of tests/test_ops.py;
- the tiny Llama's logits with ``attention="ring"`` (and ``"ring_local"``
  inside ``local_map``) at sp=4 x dp=2, f32:
  atol/rtol 1e-4 (both sides compute the same blockwise ring in f32, in
  other orders of summation; the reference holds ring against plain
  attention at 3e-2);
- 8 steps of the sharded train step at dp=2 x fsdp=2 x tp=2 (the recipe
  of tests/test_llama.py::test_sharded_train_step_dp_fsdp_tp, in f32):
  loss and grad norm at rtol 2e-3, atol 1e-4, ``__graft_entry__``'s
  trajectory bound.

One case has no JAX counterpart: the lm head that the card runs on local
shards (``_lm_head_local``), held against the unsplit product on the
three meshes at f32 rounding.

The ranks' default group times out a collective after 60 s, the mesh's
groups after ``_private/dist.py``'s 300 s, and the fixture kills the
ranks after 300 s in all, so a hang fails the tests instead of stalling
the suite. Set ``GLOO_SOCKET_IFNAME`` to choose the interface gloo binds (the
ranks default it to ``lo``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from ray_tpu.models import llama as jax_llama
from ray_tpu.ops.flash_attention import flash_attention_gspmd
from ray_tpu.parallel import train_step as jax_train
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.parallel.ring_attention import (
    ring_attention_sharded,
    ulysses_attention,
)

JOIN_TIMEOUT_S = 300
TRAIN_STEPS = 8
ATTN_TOL = 2e-5
RING_GRAD_TOL = 2e-4
FLASH_TOL, FLASH_GRAD_TOL = 1e-5, 1e-4
LOGITS_TOL = 1e-4
PARITY_RTOL, PARITY_ATOL = 2e-3, 1e-4


def _tiny_f32():
    return dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                               dtype=jnp.float32)


def _inputs() -> dict:
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cfg = _tiny_f32()
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    return {
        "ring_qkv": [normal(2, 32, 4, 8) for _ in range(3)],
        "ring_grad_q": normal(2, 16, 2, 4),
        "ulysses_qkv": [normal(2, 32, 8, 4) for _ in range(3)],
        "flash_qkv": [normal(4, 32, 4, 16), normal(4, 32, 2, 16),
                      normal(4, 32, 2, 16)],
        "flash_dout": normal(4, 32, 4, 16),
        "llama_params": jax.tree.map(np.asarray, params),
        "ring_tokens": np.asarray(jax.random.randint(
            jax.random.PRNGKey(2), (2, 32), 0, cfg.vocab_size)),
        "train_tokens": np.asarray(jax.random.randint(
            jax.random.PRNGKey(0), (4, 32), 0, cfg.vocab_size)),
        "train_steps": TRAIN_STEPS,
        "lm_head": [normal(4, 8, 16), normal(16, 24), normal(4, 8, 24)],
    }


def _jax_attention(inputs) -> dict:
    out = {}
    mesh = build_mesh(MeshConfig(sp=4, dp=2))
    q, k, v = map(jnp.asarray, inputs["ring_qkv"])
    with mesh:
        for causal in (True, False):
            out[f"ring_{causal}"] = np.asarray(
                ring_attention_sharded(q, k, v, mesh, causal=causal))

    def ring_loss(q):
        with mesh:
            return ring_attention_sharded(q, q, q, mesh, causal=True).sum()

    out["ring_grad"] = np.asarray(
        jax.grad(ring_loss)(jnp.asarray(inputs["ring_grad_q"])))

    spec = P(("dp",), "sp", None, None)
    q, k, v = map(jnp.asarray, inputs["ulysses_qkv"])
    for causal in (True, False):
        inner = jax.shard_map(
            functools.partial(ulysses_attention, axis_name="sp",
                              causal=causal),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False)
        with jax.set_mesh(mesh):
            out[f"ulysses_{causal}"] = np.asarray(inner(q, k, v))

    flash_mesh = build_mesh(MeshConfig(dp=2, sp=2, tp=2))
    q, k, v = map(jnp.asarray, inputs["flash_qkv"])
    with jax.set_mesh(flash_mesh):
        o, vjp = jax.vjp(
            lambda q, k, v: flash_attention_gspmd(q, k, v, causal=True),
            q, k, v)
        grads = vjp(jnp.asarray(inputs["flash_dout"]))
    out["flash_o"] = np.asarray(o)
    for name, g in zip("qkv", grads):
        out[f"flash_d{name}"] = np.asarray(g)
    return out


def _jax_model(inputs) -> dict:
    params = jax.tree.map(jnp.asarray, inputs["llama_params"])
    cfg = _tiny_f32()
    ring_cfg = dataclasses.replace(cfg, attention="ring")
    mesh = build_mesh(MeshConfig(sp=4, dp=2))
    with jax.set_mesh(mesh):
        logits = jax.jit(lambda p, t: jax_llama.forward(p, t, ring_cfg))(
            params, jnp.asarray(inputs["ring_tokens"]))
    out = {"ring_logits": np.asarray(logits)}

    mesh = build_mesh(MeshConfig(dp=2, fsdp=2, tp=2))
    with jax.set_mesh(mesh):
        optimizer = jax_train.default_optimizer(
            learning_rate=1e-2, warmup_steps=1, total_steps=50)
        state = jax_train.create_train_state(
            params, optimizer, mesh, jax_llama.param_logical_axes(cfg))

        def loss(p, batch):
            return jax_llama.loss_fn(p, batch["tokens"], batch["targets"],
                                     cfg)

        step = jax_train.build_train_step(loss, optimizer)
        tokens = jnp.asarray(inputs["train_tokens"])
        batch = jax_train.shard_batch(
            {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}, mesh)
        trajectory = []
        for _ in range(TRAIN_STEPS):
            state, metrics = step(state, batch)
            trajectory.append((float(metrics["loss"]),
                               float(metrics["grad_norm"])))
    out["train_trajectory"] = trajectory
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the port's records, one per rank; the JAX results; the inputs)."""
    out_dir = tmp_path_factory.mktemp("torch_parallel")
    inputs = _inputs()
    procs = ranks.start_ranks(out_dir, inputs)
    try:
        want = {**_jax_attention(inputs), **_jax_model(inputs)}
    finally:
        records = ranks.join_ranks(procs, out_dir, JOIN_TIMEOUT_S)
    return records, want, inputs


def _got(world, *keys):
    """Rank 0's results for ``keys``, after checking that every rank
    finished the cases that produce them and that every rank computed
    the same global values."""
    records = world[0]
    missing = [r for r, rec in enumerate(records) if rec is None]
    assert not missing, f"ranks {missing} wrote no results (hung or died)"
    for rec in records:
        errors = {c: e for c, e in rec["errors"].items()}
        lost = [k for k in keys if k not in rec["results"]]
        assert not lost, f"{lost} not computed: {errors}"
    values = [records[0]["results"][k] for k in keys]
    for rec in records[1:]:
        for key, value in zip(keys, values):
            theirs = rec["results"][key]
            if isinstance(value, tuple) and isinstance(value[0], np.ndarray):
                for a, b in zip(theirs, value):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(np.asarray(theirs),
                                              np.asarray(value))
    return values


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax(world, causal):
    (got,) = _got(world, f"ring_{causal}")
    np.testing.assert_allclose(got, world[1][f"ring_{causal}"],
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_ring_attention_grad_matches_jax(world):
    (got,) = _got(world, "ring_grad")
    np.testing.assert_allclose(got, world[1]["ring_grad"],
                               atol=RING_GRAD_TOL, rtol=RING_GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ulysses_attention_matches_jax(world, causal):
    (got,) = _got(world, f"ulysses_{causal}")
    np.testing.assert_allclose(got, world[1][f"ulysses_{causal}"],
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_flash_attention_gspmd_matches_jax(world):
    got, placed = _got(world, "flash_o", "flash_o_placements")
    np.testing.assert_allclose(got, world[1]["flash_o"], atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    # Batch over dp, the sequence whole over sp, heads over tp.
    assert placed == ["S(0)", "R", "S(2)"]


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_flash_attention_gspmd_grads_match_jax(world, name):
    (got,) = _got(world, f"flash_{name}")
    np.testing.assert_allclose(got, world[1][f"flash_{name}"],
                               atol=FLASH_GRAD_TOL, rtol=FLASH_GRAD_TOL)


@pytest.mark.parametrize("attention", ["ring", "ring_local"])
def test_ring_model_logits_match_jax(world, attention):
    """"ring" on DTensor params; "ring_local" on each rank's shard of the
    tokens and the global positions inside local_map: both the JAX
    model's "ring" logits."""
    (got,) = _got(world, f"{attention}_logits")
    np.testing.assert_allclose(got, world[1]["ring_logits"],
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_sharded_train_step_matches_jax_trajectory(world):
    (got,) = _got(world, "train_trajectory")
    want = world[1]["train_trajectory"]
    np.testing.assert_allclose(got, want, rtol=PARITY_RTOL,
                               atol=PARITY_ATOL)
    # Warmup 1: the first update has lr 0, then the loss falls.
    assert got[1][0] == pytest.approx(got[0][0], abs=1e-6)
    assert got[-1][0] < got[1][0]


def test_sharded_train_step_keeps_placements(world):
    all_dtensor, got, want, moments = _got(
        world, "train_all_dtensor", "train_placements",
        "train_expected_placements", "train_moments_placed")
    assert all_dtensor and moments
    assert got == want
    # The mesh is (dp, fsdp, tp): wq (None, embed, heads, None) is split
    # over fsdp by its embed dim and over tp by its heads.
    assert "[Replicate(), Shard(dim=1), Shard(dim=2)]" in got


def test_shard_batch_placements(world):
    dp_fsdp_tp, sp_dp = _got(world, "shard_batch_dp_fsdp_tp",
                             "shard_batch_sp_dp")
    assert dp_fsdp_tp == {
        "tokens": ("[Shard(dim=0), Shard(dim=0), Replicate()]", (1, 32),
                   "torch.int64"),
        "mask": ("[Shard(dim=0), Shard(dim=0), Replicate()]", (1,),
                 "torch.float32"),
        "scale": ("[Replicate(), Replicate(), Replicate()]", (),
                  "torch.float32"),
    }
    # The mesh is (dp, sp): the sequence over sp.
    assert sp_dp == {
        "tokens": ("[Shard(dim=0), Shard(dim=1)]", (2, 8), "torch.int64"),
        "mask": ("[Shard(dim=0), Replicate()]", (2,), "torch.float32"),
        "scale": ("[Replicate(), Replicate()]", (), "torch.float32"),
    }


@pytest.mark.parametrize("mesh", ["dp_fsdp_tp", "sp_dp", "tp"])
def test_lm_head_on_local_shards_matches_the_product(world, mesh):
    """The card's f32-logit lm head on DTensors (``_lm_head_local``) on
    the CPU, its ``mm(out_dtype=)`` stood in by an f32 product (no CPU
    kernel): logits, x's gradient (a partial sum over tp) and w's (a
    partial sum over the token axes) against the unsplit f32 product and
    its gradients, at f32 rounding (1e-5)."""
    ((logits, dx, dw),) = _got(world, f"lm_head_{mesh}")
    x, w, dout = (np.asarray(a, np.float64)
                  for a in world[2]["lm_head"])
    np.testing.assert_allclose(logits, x @ w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dx, dout @ w.T, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        dw, x.reshape(-1, x.shape[-1]).T @ dout.reshape(-1, dout.shape[-1]),
        atol=1e-5, rtol=1e-5)
