"""The Llama model: the PyTorch port against the JAX package.

The JAX init's parameters, as numpy arrays, go through
``params_from_numpy`` into the port, and the same numpy tokens go through
both models on the CPU (JAX's flash kernels in interpret mode, the port's
plain flash versions). In float32 the two differ only in the order of
their sums: logits to atol 1e-4, every parameter grad to atol 1e-4 and
rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

LOGIT_TOL = dict(atol=1e-4, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _configs(kv_heads: int, attention: str, f32: bool = True):
    jax_cfg = dataclasses.replace(
        jax_llama.LlamaConfig.tiny(), num_kv_heads=kv_heads,
        attention=attention, dtype=jnp.float32 if f32 else jnp.bfloat16)
    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(), num_kv_heads=kv_heads, attention=attention,
        dtype=torch.float32 if f32 else torch.bfloat16)
    return jax_cfg, cfg


def _tokens(b=2, l=33, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, l))


def _jax_params(jax_cfg):
    return jax_llama.init_params(jax_cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("attention", ["plain", "flash"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_logits_loss_and_grads_match_jax(kv_heads, attention):
    jax_cfg, cfg = _configs(kv_heads, attention)
    jax_params = _jax_params(jax_cfg)
    toks = _tokens()
    inputs, targets = toks[:, :-1], toks[:, 1:]

    ref_logits = jax_llama.forward(jax_params, jnp.asarray(inputs), jax_cfg)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jnp.asarray(inputs),
                                    jnp.asarray(targets), jax_cfg))(jax_params)

    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    logits = llama.forward(params, torch.tensor(inputs), cfg)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), **LOGIT_TOL)
    loss = llama.loss_fn(params, torch.tensor(inputs), torch.tensor(targets),
                         cfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), **LOGIT_TOL)
    grads = torch.autograd.grad(loss, leaves)
    # jax.tree_util flattens dicts in sorted key order, as tree_leaves does.
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    assert len(grads) == len(ref_leaves)
    for got, want in zip(grads, ref_leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_keeps_loss_and_grads(policy):
    """Recomputation reruns the same float32 arithmetic: equal to 1e-6."""
    _, cfg = _configs(2, "flash")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = torch.tensor(_tokens())
    results = []
    for c in (cfg, dataclasses.replace(cfg, remat=True, remat_policy=policy)):
        loss = llama.loss_fn(params, toks[:, :-1], toks[:, 1:], c)
        results.append((loss, torch.autograd.grad(loss, leaves)))
    (loss0, grads0), (loss1, grads1) = results
    torch.testing.assert_close(loss1, loss0, atol=1e-6, rtol=0)
    for a, b in zip(grads1, grads0):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_bf16_smoke_close_to_jax():
    """bf16 compute on both sides: the two frameworks round at different
    sites (XLA fuses elementwise chains and keeps f32 inside them; PyTorch
    rounds after each op), so logits differ by a few bf16 steps. Loss to
    rtol 1e-2, logits to atol 0.1 against logits of magnitude ~1."""
    jax_cfg, cfg = _configs(2, "flash", f32=False)
    jax_params = _jax_params(jax_cfg)
    toks = _tokens()
    ref = np.asarray(jax_llama.forward(jax_params, jnp.asarray(toks), jax_cfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    logits = llama.forward(params, torch.tensor(toks), cfg)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), ref, atol=0.1, rtol=0)
    ref_loss = jax_llama.cross_entropy(jnp.asarray(ref[:, :-1]),
                                       jnp.asarray(toks[:, 1:]))
    loss = llama.cross_entropy(logits[:, :-1], torch.tensor(toks[:, 1:]))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-2)


def test_causality():
    """Changing a future token must not affect earlier logits."""
    _, cfg = _configs(4, "flash")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor(_tokens(b=1, l=16))
    toks2 = toks.clone()
    toks2[0, 12] = (toks2[0, 12] + 7) % cfg.vocab_size
    a, b = (llama.forward(params, t, cfg) for t in (toks, toks2))
    torch.testing.assert_close(a[0, :12], b[0, :12], atol=1e-6, rtol=0)
    assert not torch.allclose(a[0, 12:], b[0, 12:], atol=1e-3)


def test_init_params_tree_and_counts():
    """Same keys, shapes and parameter count as the JAX init; norms are
    ones and dense weights have std fan_in ** -0.5."""
    jax_cfg, cfg = _configs(2, "plain")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree.map(np.asarray, _jax_params(jax_cfg))
    assert jax.tree.map(np.shape, params_to_numpy(params)) == \
        jax.tree.map(np.shape, ref)
    assert sum(p.numel() for p in tree_leaves(params)) == cfg.num_params \
        == jax_cfg.num_params
    assert torch.equal(params["final_norm"], torch.ones(cfg.hidden_size))
    std = params["layers"]["w_down"].std().item()
    assert abs(std * cfg.intermediate_size ** 0.5 - 1) < 0.05
    bench = dataclasses.replace(
        llama.LlamaConfig(), vocab_size=32000, hidden_size=1024,
        intermediate_size=2816, num_layers=24, num_heads=16, num_kv_heads=8,
        head_dim=64)
    jax_bench = dataclasses.replace(
        jax_llama.LlamaConfig(), vocab_size=32000, hidden_size=1024,
        intermediate_size=2816, num_layers=24, num_heads=16, num_kv_heads=8,
        head_dim=64)
    assert bench.num_params == jax_bench.num_params
    assert llama.flops_per_token(bench, 2048) == \
        jax_llama.flops_per_token(jax_bench, 2048)


def test_convert_round_trip_is_exact():
    jax_cfg, _ = _configs(2, "plain")
    tree = jax.tree.map(np.asarray, _jax_params(jax_cfg))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_forward_rejects_unported_attention():
    _, cfg = _configs(4, "ring")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        llama.forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg)
