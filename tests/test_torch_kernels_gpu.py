"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA card.
The file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Both sides get the same bf16 inputs. Both round p and ds to bf16 before
their products and the outputs to bf16, and sum in f32 in different
orders. An element then differs by one bf16 step where the two f32 sums
straddle a rounding boundary, plus the spread of the intermediate
roundings: each element is held to atol + 2^-6 * |plain| (two steps at
the bottom of a binade), and the whole tensor to a relative RMS error.
o: atol 2e-3, RMS 5e-3; dq, dk, dv: atol 1e-3, RMS 1e-3 (the bounds
chip_smoke.py holds the kernels to, where the reasons are given). lse is
f32 on both sides: 1e-4.
"""

import importlib

import pytest
import torch

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want, atol, rms_tol, rtol=2 ** -6):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert (err <= atol + rtol * want.abs()).all(), err.max().item()
    assert (err.norm() / want.norm()).item() <= rms_tol


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h,kvh,d,causal", [
    (2, 256, 8, 2, 64, True),     # GQA 4:1
    (1, 200, 4, 4, 64, False),    # ragged tail, non-causal
    (1, 130, 4, 2, 128, True),    # widest head dim, ragged
    (2, 96, 4, 4, 32, True),
    (1, 70, 2, 1, 16, False),
])
def test_kernels_match_plain(cuda_device, b, l, h, kvh, d, causal):
    gen = torch.Generator(cuda_device).manual_seed(l)
    q, do = _bf16(gen, b, l, h, d), _bf16(gen, b, l, h, d)
    k, v = _bf16(gen, b, l, kvh, d), _bf16(gen, b, l, kvh, d)
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    grads = (fa.flash_bwd_dq_kernel(q, k, v, o_ref, lse_ref, do, causal),
             *fa.flash_bwd_dkv_kernel(q, k, v, o_ref, lse_ref, do, causal))
    grads_ref = fa.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    _assert_close(o, o_ref, atol=2e-3, rms_tol=5e-3)
    for got, want in zip(grads, grads_ref):
        _assert_close(got, want, atol=1e-3, rms_tol=1e-3)


@pytest.mark.gpu
def test_strided_views_and_launch_counts(cuda_device):
    """q, k and v as head-sliced views of one packed projection (strides,
    not copies), through the autograd Function: same result as contiguous
    inputs, one launch of each kernel per forward and backward."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    b, l, h, kvh, d = 2, 128, 4, 2, 64
    packed = _bf16(gen, b, l, h + 2 * kvh, d)
    q, k, v = packed.split([h, kvh, kvh], dim=2)
    assert not q.is_contiguous()
    before = dict(fa.launches)
    views = [x.detach().requires_grad_(True) for x in (q, k, v)]
    dense = [x.detach().contiguous().requires_grad_(True) for x in (q, k, v)]
    outs = [fa.flash_attention(*xs) for xs in (views, dense)]
    for out in outs:
        out.float().square().sum().backward()
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    for a, c in zip(views, dense):
        torch.testing.assert_close(a.grad, c.grad, atol=0, rtol=0)
    assert {k: fa.launches[k] - before[k] for k in before} == {
        "fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 16, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_fwd_kernel(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        fa.flash_fwd_kernel(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError):
        fa.flash_fwd_kernel(q, q[:, :, :1].expand(1, 16, 3, 64), q)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_reruns_the_forward_kernel(cuda_device, policy):
    """Under remat the backward reruns the forward kernel through its
    autograd Function (one more forward launch per layer) and, the kernels
    being deterministic, gives bit-identical grads."""
    import dataclasses

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), attention="flash",
                              num_kv_heads=2, head_dim=32, hidden_size=128)
    params = llama.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (2, 97), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    results = []
    for c in (cfg, dataclasses.replace(cfg, remat=True, remat_policy=policy)):
        before = dict(fa.launches)
        loss = llama.loss_fn(params, toks[:, :-1], toks[:, 1:], c)
        grads = torch.autograd.grad(loss, leaves)
        launched = {k: fa.launches[k] - before[k] for k in before}
        results.append((loss, grads, launched))
    (loss0, grads0, n0), (loss1, grads1, n1) = results
    layers = cfg.num_layers
    assert n0 == {"fwd": layers, "bwd_dq": layers, "bwd_dkv": layers}
    assert n1 == {"fwd": 2 * layers, "bwd_dq": layers, "bwd_dkv": layers}
    torch.testing.assert_close(loss1, loss0, atol=0, rtol=0)
    for a, b in zip(grads1, grads0):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.gpu
def test_lm_head_logits_stay_f32(cuda_device):
    """bf16 operands, f32 logits: equal to the f32 product of the same bf16
    values up to f32 summation order (1e-4 relative), never rounded
    through bf16 (which would be off by ~2^-9 relative). The weight grad
    comes out in bf16: one rounding, within 2^-7 relative."""
    from ray_tpu_torch.models.llama import _lm_head

    gen = torch.Generator(cuda_device).manual_seed(0)
    x = _bf16(gen, 2, 16, 256).requires_grad_(True)
    w = _bf16(gen, 256, 1000).requires_grad_(True)
    logits = _lm_head(x, w)
    assert logits.dtype == torch.float32 and logits.shape == (2, 16, 1000)
    want = x.detach().float() @ w.detach().float()
    torch.testing.assert_close(logits.detach(), want, atol=1e-4, rtol=1e-4)
    assert not torch.equal(logits.detach(), want.to(torch.bfloat16).float())
    logits.sum().backward()
    torch.testing.assert_close(
        w.grad.float(), x.detach().float().reshape(-1, 256).sum(0)[:, None]
        .expand(256, 1000), atol=1e-2, rtol=2 ** -7)
