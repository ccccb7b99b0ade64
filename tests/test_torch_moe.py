"""The port's MoE layer, the MoE model and the chunked loss against the
JAX package, in one process on the CPU.

Weights cross from JAX's init through ``params_from_numpy``, and the same
numpy inputs go through both packages, in float32, where the two differ
only in the order of their sums:

- ``moe_mlp``: output and aux to 1e-5, gradients to 1e-4 (the bounds of
  tests/test_ops.py), with and without tokens over capacity;
- the MoE model (``tiny(num_experts=4)``): ``forward(with_aux=True)`` and
  ``loss_fn`` with remat "full" and "dots" to 2e-4 (the pipelined
  model's bound in tests/test_pipeline_moe.py), every gradient to 2e-4;
- the chunked loss (``ce_chunk=4`` at L=16) and its gradients: 1e-5 and
  1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.models import moe as jax_moe
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.models.convert import params_from_numpy

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
MODEL_TOL = 2e-4


def _layer_inputs(hidden=16, mlp=32, experts=4, shape=(2, 12), seed=0):
    """One MoE layer's weights (JAX's init, numpy) and x [B, T, H]."""
    params = jax_moe.init_moe_params(jax.random.PRNGKey(seed), hidden, mlp,
                                     experts, 1)
    layer = {k: np.asarray(v[0]) for k, v in params.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (*shape, hidden)).astype(np.float32)
    return layer, x


def _jax_moe(layer, x, cf):
    def f(layer, x):
        out, aux = jax_moe.moe_mlp(layer, x, capacity_factor=cf,
                                   dtype=jnp.float32)
        return out, aux

    return f(jax.tree.map(jnp.asarray, layer), jnp.asarray(x))


def _torch_layer(layer):
    return {k: torch.tensor(v, requires_grad=True) for k, v in layer.items()}


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
def test_moe_mlp_matches_jax(cf):
    layer, x = _layer_inputs()
    want_out, want_aux = _jax_moe(layer, x, cf)
    out, aux = moe.moe_mlp(_torch_layer(layer), torch.tensor(x),
                           capacity_factor=cf, dtype=torch.float32)
    assert out.shape == x.shape and aux.shape == ()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=OUT_TOL,
                               rtol=OUT_TOL)
    # Perfectly balanced top-1 routing gives aux == 1; collapse gives E.
    assert 0.9 <= aux.item() <= 4.1


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
def test_moe_mlp_grads_match_jax(cf):
    """Gradients of sum(out * dout) + 3 * aux for every weight and x: the
    router's through the gate and the aux, the experts' through the
    dispatch and combine einsums."""
    layer, x = _layer_inputs()
    dout = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jax_loss(layer, x):
        out, aux = jax_moe.moe_mlp(layer, x, capacity_factor=cf,
                                   dtype=jnp.float32)
        return jnp.sum(out * dout) + 3.0 * aux

    want = jax.grad(jax_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    tl = _torch_layer(layer)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_mlp(tl, tx, capacity_factor=cf, dtype=torch.float32)
    (out * torch.tensor(dout)).sum().add(3.0 * aux).backward()
    for name in layer:
        np.testing.assert_allclose(tl[name].grad.numpy(),
                                   np.asarray(want[0][name]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[1]),
                               atol=GRAD_TOL, rtol=GRAD_TOL)


def test_moe_capacity_drops_tokens():
    """tests/test_pipeline_moe.py::test_moe_capacity_drops_tokens: every
    token routed to expert 0, capacity 0.5 * 8 / 2 = 2, so the slots of
    tokens 3-8 are past capacity (one_hot of an index >= C) and those
    tokens get exactly zero; the experts they did not pick (index -1)
    give zero too. The same as JAX's output."""
    layer, _ = _layer_inputs(hidden=8, mlp=16, experts=2)
    layer["w_router"] = np.zeros_like(layer["w_router"])
    layer["w_router"][:, 0] = 1.0
    x = np.abs(np.random.default_rng(1).standard_normal((1, 8, 8))).astype(
        np.float32) + 0.1
    out, _ = moe.moe_mlp(_torch_layer(layer), torch.tensor(x),
                         capacity_factor=0.5, dtype=torch.float32)
    out = out.detach().numpy()
    assert np.any(out[0, :2] != 0.0)
    np.testing.assert_array_equal(out[0, 2:], np.zeros_like(out[0, 2:]))
    want, _ = _jax_moe(layer, x, 0.5)
    np.testing.assert_allclose(out, np.asarray(want), atol=OUT_TOL,
                               rtol=OUT_TOL)


def test_init_moe_params_shapes_and_scale():
    params = moe.init_moe_params(torch.Generator().manual_seed(0), hidden=16,
                                 mlp=32, num_experts=4, num_layers=3,
                                 device="cpu")
    want = jax_moe.init_moe_params(jax.random.PRNGKey(0), 16, 32, 4, 3)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    # std fan_in ** -0.5: 16 ** -0.5 for the router, gate and up, 32 **
    # -0.5 for down.
    for name, fan_in in (("w_router", 16), ("w_gate", 16), ("w_up", 16),
                         ("w_down", 32)):
        assert params[name].std().item() == pytest.approx(fan_in ** -0.5,
                                                          rel=0.15)


def test_moe_param_logical_axes_match_jax():
    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  num_experts=4)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_experts=4)
    want = jax_llama.param_logical_axes(jax_cfg)
    got = llama.param_logical_axes(cfg)
    assert got == want
    assert got["layers"]["w_gate"] == (None, "expert", "embed", "mlp")
    assert moe.moe_logical_axes() == jax_moe.moe_logical_axes()
    # Dense configs keep the dense MLP's axes.
    assert llama.param_logical_axes(llama.LlamaConfig.tiny()) == \
        jax_llama.param_logical_axes(jax_llama.LlamaConfig.tiny())


@pytest.mark.parametrize("experts", [0, 2, 8])
def test_param_counts_and_flops_match_jax(experts):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_experts=experts)
    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  num_experts=experts)
    assert cfg.num_params == jax_cfg.num_params
    assert cfg.num_active_params == jax_cfg.num_active_params
    assert llama.flops_per_token(cfg, 64) == jax_llama.flops_per_token(
        jax_cfg, 64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in tree_leaves(params)) == cfg.num_params


def test_moe_flops_accounting_uses_active_params():
    """tests/test_pipeline_moe.py's case, on the port's config."""
    dense = llama.LlamaConfig.tiny()
    moe_cfg = dataclasses.replace(dense, num_experts=8)
    assert moe_cfg.num_params > dense.num_params
    assert moe_cfg.num_active_params == pytest.approx(
        dense.num_params + moe_cfg.num_layers * dense.hidden_size * 8,
        rel=0.01)
    assert llama.flops_per_token(moe_cfg, 64) < \
        llama.flops_per_token(dense, 64) * 1.1


def _model(experts=4, **changes):
    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  dtype=jnp.float32, num_experts=experts,
                                  **changes)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                              num_experts=experts, **changes)
    jax_params = jax_llama.init_params(jax_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    toks = np.random.default_rng(1).integers(0, 256, (2, 17))
    return jax_cfg, cfg, jax_params, params, toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_moe_model_matches_jax(remat):
    """``forward(with_aux=True)``, ``loss_fn`` (cross-entropy plus 0.01 x
    the aux) and every gradient of the tiny MoE model; under remat the
    checkpointed layer carries (x, aux)."""
    changes = ({"remat": False} if remat == "none"
               else {"remat": True, "remat_policy": remat})
    jax_cfg, cfg, jax_params, params, inputs, targets = _model(**changes)
    want_logits, want_aux = jax_llama.forward(jax_params,
                                              jnp.asarray(inputs), jax_cfg,
                                              with_aux=True)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jnp.asarray(inputs),
                                    jnp.asarray(targets), jax_cfg))(
        jax_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    logits, aux = llama.forward(params, torch.tensor(inputs), cfg,
                                with_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    # Two layers: the aux sum lies between 2 (balance) and 2 E.
    assert 2 * 0.9 <= aux.item() <= 2 * 4.1
    loss = llama.loss_fn(params, torch.tensor(inputs), torch.tensor(targets),
                         cfg)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    grads = torch.autograd.grad(loss, leaves)
    for got, want in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)


def test_dense_forward_with_aux_is_zero():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    logits, aux = llama.forward(params, tokens, cfg, with_aux=True)
    assert aux.item() == 0.0
    torch.testing.assert_close(logits, llama.forward(params, tokens, cfg),
                               rtol=0, atol=0)


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
def test_chunked_loss_matches_jax(experts):
    """``ce_chunk=4`` at L=16 against JAX's chunked loss: the loss and
    every gradient (the lm head's summed over the chunks)."""
    jax_cfg, cfg, jax_params, params, inputs, targets = _model(
        experts, ce_chunk=4)
    inputs, targets = inputs[:, :16], targets[:, :16]
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jnp.asarray(inputs),
                                    jnp.asarray(targets), jax_cfg))(
        jax_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = llama.loss_fn(params, torch.tensor(inputs), torch.tensor(targets),
                         cfg)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=OUT_TOL,
                               rtol=OUT_TOL)
    grads = torch.autograd.grad(loss, leaves)
    for got, want in zip(grads, jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
    # And the port's own full-logits loss on the same weights.
    full = llama.loss_fn(params, torch.tensor(inputs), torch.tensor(targets),
                         dataclasses.replace(cfg, ce_chunk=0))
    np.testing.assert_allclose(loss.item(), full.item(), atol=OUT_TOL,
                               rtol=OUT_TOL)


def test_chunked_loss_with_mask():
    _, cfg, _, params, inputs, targets = _model(0, ce_chunk=8)
    inputs, targets = torch.tensor(inputs[:, :16]), torch.tensor(
        targets[:, :16])
    mask = torch.tensor(np.random.default_rng(3).integers(0, 2, (2, 16)),
                        dtype=torch.float32)
    got = llama.loss_fn(params, inputs, targets, cfg, mask=mask)
    want = llama.loss_fn(params, inputs, targets,
                         dataclasses.replace(cfg, ce_chunk=0), mask=mask)
    np.testing.assert_allclose(got.item(), want.item(), atol=OUT_TOL,
                               rtol=OUT_TOL)


def test_ce_chunk_must_divide_the_sequence():
    _, cfg, _, params, inputs, targets = _model(0, ce_chunk=5)
    with pytest.raises(ValueError, match="must divide the sequence length"):
        llama.loss_fn(params, torch.tensor(inputs), torch.tensor(targets),
                      cfg)


def test_forward_return_features_matches_jax():
    """The final-norm features the chunked loss starts from."""
    jax_cfg, cfg, jax_params, params, inputs, _ = _model(4)
    want, want_aux = jax_llama.forward(jax_params, jnp.asarray(inputs),
                                       jax_cfg, with_aux=True,
                                       return_features=True)
    got, aux = llama.forward(params, torch.tensor(inputs), cfg,
                             with_aux=True, return_features=True)
    assert got.shape == (2, 16, cfg.hidden_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


def test_dots_policy_recomputes_the_expert_products():
    """Under remat "dots" a MoE layer keeps its matrix products (``mm``:
    the projections and the router) and recomputes the batched expert
    products (``bmm``), as the reference's
    dots_with_no_batch_dims_saveable does: the saved tensors hold no
    [E, B, C, M] expert activation."""
    from torch.utils.checkpoint import CheckpointPolicy

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                              num_experts=4, remat=True, remat_policy="dots")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    decided = {}

    def policy(ctx, op, *args, **kwargs):
        decision = llama._save_matmuls(ctx, op, *args, **kwargs)
        decided.setdefault(str(op), set()).add(decision)
        return decision

    real = llama._REMAT_CONTEXT["dots"]
    llama._REMAT_CONTEXT["dots"] = lambda: \
        torch.utils.checkpoint.create_selective_checkpoint_contexts(policy)
    try:
        loss = llama.loss_fn(params, torch.zeros((2, 16), dtype=torch.long),
                             torch.zeros((2, 16), dtype=torch.long), cfg)
    finally:
        llama._REMAT_CONTEXT["dots"] = real
    loss.backward()
    assert decided["aten.mm.default"] == {CheckpointPolicy.MUST_SAVE}
    assert decided["aten.bmm.default"] == {
        CheckpointPolicy.PREFER_RECOMPUTE}
