"""RMSNorm: the PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through
``ray_tpu.ops.rms_norm`` (its Pallas kernel in interpret mode on the CPU,
as tests/test_ops.py runs it) and ``ray_tpu_torch.ops.rms_norm`` (on the
CPU, the plain PyTorch version through the autograd Function). In float32
the two compute the same formula and differ only in the order of the
row sum: forward to 1e-6 (test_ops.py's bar against llama.rms_norm),
gradients of x and scale, which add one more row or column sum, to 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import rms_norm as jax_rms_norm
from ray_tpu_torch.ops import rms_norm

fused = importlib.import_module("ray_tpu_torch.ops.fused")

FWD_TOL = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
# The shapes of tests/test_ops.py, and a D that is no multiple of the
# kernel's vector width (8 bf16 or 4 f32 values).
SHAPES = [(4, 32, 128), (64, 128), (5, 3, 37)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    scale = rng.standard_normal(shape[-1], dtype=np.float32) + 1.0
    g = rng.standard_normal(shape, dtype=np.float32)
    return x, scale, g


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_jax(shape):
    x, scale, _ = _inputs(shape)
    want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                   interpret=True))
    before = dict(fused.launches)
    got = rms_norm(torch.tensor(x), torch.tensor(scale))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    assert fused.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_grads_match_jax(shape):
    """dx and dscale for the same cotangent g, through the reference's
    custom_vjp and the port's autograd Function."""
    x, scale, g = _inputs(shape, seed=1)
    _, vjp = jax.vjp(lambda a, s: jax_rms_norm(a, s, interpret=True),
                     jnp.asarray(x), jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(scale, requires_grad=True)
    dx, ds = torch.autograd.grad(rms_norm(xt, st), (xt, st), torch.tensor(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **GRAD_TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), **GRAD_TOL)


def test_no_grad_call_skips_the_autograd_function():
    """Under no_grad (the serving engine's call) rms_norm calls the
    forward directly: the plain version's values, no grad_fn. With grad
    it still goes through the autograd Function, and its gradients still
    match the reference's."""
    x, scale, g = _inputs((4, 32, 128), seed=6)
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(scale, requires_grad=True)
    with torch.no_grad():
        got = rms_norm(xt, st)
    assert got.grad_fn is None and not got.requires_grad
    want = fused.rms_norm_plain(torch.tensor(x).reshape(-1, 128),
                                torch.tensor(scale), 1e-5).reshape(x.shape)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert rms_norm(torch.tensor(x), torch.tensor(scale)).grad_fn is None

    out = rms_norm(xt, st)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), got, atol=0, rtol=0)
    _, vjp = jax.vjp(lambda a, s: jax_rms_norm(a, s, interpret=True),
                     jnp.asarray(x), jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(g))
    dx, ds = torch.autograd.grad(out, (xt, st), torch.tensor(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **GRAD_TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), **GRAD_TOL)


def test_bf16_forward_matches_jax():
    """bf16 in and out, f32 statistics on both sides: each side rounds
    one f32 value to bf16 once, so an element may differ by one bf16 step
    (2^-7 of its magnitude at most) where the two f32 values straddle a
    rounding boundary."""
    x, scale, _ = _inputs((16, 256), seed=2)
    want = np.asarray(jax_rms_norm(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(scale, jnp.bfloat16),
                                   interpret=True).astype(jnp.float32))
    got = rms_norm(torch.tensor(x).to(torch.bfloat16),
                   torch.tensor(scale).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_plain_version_matches_the_reference_formula():
    """rms_norm_plain is llama.rms_norm's formula, the one the reference
    engine runs: the same f32 arithmetic in the same order."""
    from ray_tpu.models.llama import rms_norm as jax_llama_rms_norm

    x, scale, _ = _inputs((8, 64), seed=3)
    want = np.asarray(jax_llama_rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                         1e-5))
    got = fused.rms_norm_plain(torch.tensor(x), torch.tensor(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_strided_rows_and_non_contiguous_input():
    """A view of every other row, and a transposed input whose last dim is
    strided, give what their contiguous copies give."""
    x, scale, _ = _inputs((12, 64), seed=4)
    xt, st = torch.tensor(x), torch.tensor(scale)
    torch.testing.assert_close(rms_norm(xt[::2], st),
                               rms_norm(xt[::2].contiguous(), st),
                               atol=0, rtol=0)
    wide = torch.tensor(_inputs((64, 12), seed=5)[0]).t()
    assert wide.stride(-1) != 1
    torch.testing.assert_close(rms_norm(wide, st),
                               rms_norm(wide.contiguous(), st),
                               atol=0, rtol=0)


def test_tensors_off_cpu_and_cuda_are_refused():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms_norm(x, torch.ones(8, device="meta"))
