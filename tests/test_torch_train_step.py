"""The training step: the PyTorch port against ``ray_tpu.parallel.train_step``.

The (loss, grad_norm) trajectory over 3 steps of the tiny Llama, from the
same numpy parameters and tokens, against the JAX step on a one-device
mesh: the shape and tolerances of ``__graft_entry__``'s parity harness
(rtol 2e-3, atol 1e-4), in float32. With warmup 0 every step updates;
with warmup > 0 the first update has lr 0, as optax's schedule gives.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import train_step as jax_train
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel.train_step import (
    build_train_step,
    create_train_state,
    default_optimizer,
    place_batch,
)

PARITY_STEPS = 3
PARITY_RTOL = 2e-3
PARITY_ATOL = 1e-4


def _jax_trajectory(cfg, params, tokens, warmup):
    mesh = build_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    with jax.set_mesh(mesh):
        optimizer = jax_train.default_optimizer(
            learning_rate=1e-3, warmup_steps=warmup, total_steps=10)
        state = jax_train.create_train_state(
            params, optimizer, mesh, jax_llama.param_logical_axes(cfg))

        def loss(p, batch):
            return jax_llama.loss_fn(p, batch["tokens"], batch["targets"],
                                     cfg)

        step = jax_train.build_train_step(loss, optimizer)
        batch = jax_train.shard_batch(
            {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}, mesh)
        out = []
        for _ in range(PARITY_STEPS):
            state, metrics = step(state, batch)
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return out


def _port_trajectory(cfg, params, tokens, warmup):
    optimizer = default_optimizer(learning_rate=1e-3, warmup_steps=warmup,
                                  total_steps=10)
    state = create_train_state(params, optimizer, device="cpu")

    def loss(p, batch):
        return llama.loss_fn(p, batch["tokens"], batch["targets"], cfg)

    step = build_train_step(loss, optimizer)
    batch = place_batch({"tokens": tokens[:, :-1], "targets": tokens[:, 1:]},
                        "cpu")
    out = []
    for _ in range(PARITY_STEPS):
        state, metrics = step(state, batch)
        out.append((metrics["loss"].item(), metrics["grad_norm"].item()))
    return out


@pytest.mark.parametrize("warmup", [0, 2])
def test_trajectory_matches_jax_train_step(warmup):
    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  dtype=jnp.float32)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    jax_params = jax_llama.init_params(jax_cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    ref = _jax_trajectory(jax_cfg, jax_params, jnp.asarray(tokens), warmup)
    got = _port_trajectory(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu"),
        tokens, warmup)
    np.testing.assert_allclose(got, ref, rtol=PARITY_RTOL, atol=PARITY_ATOL)
    # The loss moves after every update with lr > 0, and not after one
    # with lr 0.
    if warmup:
        assert got[1][0] == pytest.approx(got[0][0], abs=1e-6)
        assert got[2][0] < got[1][0]
    else:
        assert got[2][0] < got[1][0] < got[0][0]


def test_schedule_matches_optax():
    opt = default_optimizer(learning_rate=3e-4, warmup_steps=10,
                            total_steps=1000)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 1000)
    for count, want in [(0, 0.0), (1, 3e-5), (10, 3e-4), (11, 3e-4),
                        (1000, 0.0)]:
        assert opt.lr(count) == pytest.approx(want, abs=1e-9)
    # optax evaluates in float32: agree to float32 precision of the peak.
    for count in (0, 1, 5, 10, 11, 500, 999, 1000, 1200):
        assert opt.lr(count) == pytest.approx(float(ref(count)),
                                              abs=3e-4 * 1e-6)
    flat = default_optimizer(learning_rate=3e-4, warmup_steps=0,
                             total_steps=10)
    assert flat.lr(0) == pytest.approx(3e-4)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_update_matches_optax(grad_scale):
    """Four updates of random parameters against optax's chain, with the
    global norm below and above max_grad_norm; float32 on both sides."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((3, 5), dtype=np.float32),
              "b": {"c": rng.standard_normal((4,), dtype=np.float32)}}
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * grad_scale)
                          .astype(np.float32), params) for _ in range(4)]
    ref_opt = jax_train.default_optimizer(learning_rate=1e-2,
                                          warmup_steps=2, total_steps=10)
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_state = ref_opt.init(ref_params)
    opt = default_optimizer(learning_rate=1e-2, warmup_steps=2,
                            total_steps=10)
    state = create_train_state(params_from_numpy(params, "cpu"), opt,
                               device="cpu")
    leaves = tree_leaves(state.params)
    for g in grads:
        updates, ref_state = ref_opt.update(jax.tree.map(jnp.asarray, g),
                                            ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        tg = [torch.tensor(x) for x in tree_leaves(g)]
        norm = torch.sqrt(sum((x * x).sum() for x in tg))
        assert (norm.item() >= 1.0) == (grad_scale > 1)
        opt.update_(leaves, tg, state.opt_state, norm)
    for got, want in zip(leaves, jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


def test_train_state_copies_callers_params():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = params["lm_head"].clone()
    opt = default_optimizer(learning_rate=1e-3, warmup_steps=0,
                            total_steps=10)
    state = create_train_state(params, opt, device="cpu")
    step = build_train_step(
        lambda p, b: llama.loss_fn(p, b["tokens"], b["targets"], cfg), opt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    state, metrics = step(state, place_batch(
        {"tokens": toks[:, :-1], "targets": toks[:, 1:]}, "cpu"))
    assert metrics["step"] == 0 and state.step == 1
    assert state.opt_state["count"] == 1
    assert torch.equal(params["lm_head"], before)
    assert not torch.equal(state.params["lm_head"], before)
    assert math.isfinite(metrics["grad_norm"].item())


def test_place_batch_makes_int64_index_tensors():
    batch = place_batch({"tokens": np.zeros((2, 3), dtype=np.int32)}, "cpu")
    assert batch["tokens"].dtype == torch.int64
