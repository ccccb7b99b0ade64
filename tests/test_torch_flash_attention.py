"""Flash attention: the PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through
``ray_tpu.ops.flash_attention`` (its Pallas kernels in interpret mode on
the CPU) and ``ray_tpu_torch.ops.flash_attention`` (on the CPU, its plain
PyTorch versions through the autograd Function). Every case of
tests/test_ops.py appears here. All in float32, where the two differ only
in the order of their sums: outputs to atol/rtol 1e-5, gradients (which
go through three products) to 1e-4, the bars test_ops.py sets.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jax_flash
from ray_tpu.ops.flash_attention import _flash_bwd, _flash_fwd

port = importlib.import_module("ray_tpu_torch.ops.flash_attention")

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _qkv(b=2, l=128, h=4, kvh=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, d), dtype=np.float32),
            rng.standard_normal((b, l, kvh, d), dtype=np.float32),
            rng.standard_normal((b, l, kvh, d), dtype=np.float32))


# (shape kwargs, causal, block_q, block_k): the cases of tests/test_ops.py.
CASES = {
    "causal": (dict(), True, 32, 32),
    "noncausal": (dict(l=64), False, 32, 32),
    "gqa": (dict(h=8, kvh=2), True, 32, 32),
    "uneven_blocks": (dict(l=96), True, 96, 32),
    "grads_causal": (dict(l=64), True, 32, 32),
    "grads_noncausal": (dict(l=64), False, 32, 32),
    "grads_uneven_gqa": (dict(l=96, h=8, kvh=2), True, 96, 32),
    "non_divisible_seq": (dict(l=200), True, 128, 128),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_matches_jax(name):
    shape, causal, bq, bk = CASES[name]
    q, k, v = _qkv(**shape)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=bq, block_k=bk)
    out = port.flash_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=causal,
                               block_q=bq, block_k=bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **OUT_TOL)


@pytest.mark.parametrize("name", sorted(n for n in CASES if "grads" in n)
                         + ["non_divisible_seq"])
def test_grads_match_jax(name):
    shape, causal, bq, bk = CASES[name]
    q, k, v = _qkv(**shape)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (port.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                          block_k=bk) ** 2).sum().backward()
    for got, want in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def _heads_first(x):
    b, l, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, l, d)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_fwd_bwd_match_tpu_kernels(causal):
    """Each plain version against the Pallas kernel it stands beside:
    lse (the forward's residual) to 1e-5, and dq/dk/dv from the same
    (q, k, v, o, lse, dO) to 1e-4."""
    b, l, h, d = 2, 64, 4, 32
    q, k, v = _qkv(b=b, l=l, h=h, kvh=h, d=d, seed=3)
    do = np.random.default_rng(4).standard_normal((b, l, h, d),
                                                  dtype=np.float32)
    o_ref, lse_ref = _flash_fwd(_heads_first(q), _heads_first(k),
                                _heads_first(v), causal, 32, 32, True)
    o, lse = port.flash_fwd_plain(*map(torch.tensor, (q, k, v)), causal)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, l),
                               np.asarray(lse_ref)[..., 0], **OUT_TOL)
    grads_ref = _flash_bwd(_heads_first(q), _heads_first(k), _heads_first(v),
                           o_ref, lse_ref, _heads_first(do), causal, 32, 32,
                           True)
    grads = port.flash_bwd_plain(*map(torch.tensor, (q, k, v)), o, lse,
                                 torch.tensor(do), causal)
    for got, want in zip(grads, grads_ref):
        want = np.asarray(want).reshape(b, h, l, d).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize("shape", [(2, 64, 4, 32), (1, 33, 2, 16)])
def test_plain_delta_matches_the_tpu_kernels_rowsum(shape):
    """delta = rowsum(dO * O), which ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel`` take per q tile, as [B, H, L] f32."""
    rng = np.random.default_rng(5)
    o, do = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    want = jnp.sum(jnp.asarray(do) * jnp.asarray(o), axis=-1)
    got = port.flash_bwd_delta_plain(torch.tensor(o), torch.tensor(do))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1), **OUT_TOL)


def test_plain_delta_of_bf16_inputs_sums_in_f32():
    rng = np.random.default_rng(6)
    o, do = (torch.tensor(rng.standard_normal((1, 8, 2, 64),
                                              dtype=np.float32))
             .to(torch.bfloat16) for _ in range(2))
    got = port.flash_bwd_delta_plain(o, do)
    want = (o.double() * do.double()).sum(-1).transpose(1, 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)


def test_block_sizes_must_be_positive():
    q, k, v = map(torch.tensor, _qkv(l=16))
    with pytest.raises(ValueError):
        port.flash_attention(q, k, v, block_q=0)
