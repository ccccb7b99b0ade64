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
f32 on both sides: 1e-4. delta (the backward pre-pass) is an f32 sum of D
bf16 products on both sides, in other orders: 1e-5 + 1e-5 * |plain|.

The RMSNorm kernel against ``rms_norm_plain``: both compute the row's
statistics in f32 (in other orders) and round one f32 value to x's dtype
once. A bf16 element may then differ by one bf16 step, at most 2^-7 of its
magnitude, and the tensor by a relative RMS of 4e-3; an f32 element by
1e-5 of its magnitude (plus 1e-6 near 0).
"""

import importlib
import time

import pytest
import torch

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
fused = importlib.import_module("ray_tpu_torch.ops.fused")


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


def _qkvdo(device, b, l, h, kvh, d, seed):
    gen = torch.Generator(device).manual_seed(seed)
    q, do = _bf16(gen, b, l, h, d), _bf16(gen, b, l, h, d)
    k, v = _bf16(gen, b, l, kvh, d), _bf16(gen, b, l, kvh, d)
    return q, k, v, do


# The forward tiles 128 q rows by 128 keys, dq 128 q rows by 64 keys and
# dk/dv 128 keys by 64 q rows. L = 127, 128, 129 and 255 sit on either
# side of those boundaries.
BOUNDARY_CASES = [(2, n, 4, 2, 64, causal) for n in (127, 128, 129, 255)
                  for causal in (True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h,kvh,d,causal", [
    (2, 256, 8, 2, 64, True),     # GQA 4:1
    (1, 200, 4, 4, 64, False),    # ragged tail, non-causal
    (1, 130, 4, 2, 128, True),    # widest head dim, ragged
    (2, 96, 4, 4, 32, True),
    (1, 70, 2, 1, 16, False),
    *BOUNDARY_CASES,
    (1, 1000, 8, 2, 128, True),   # widest head dim, GQA 4:1, ragged
    (1, 256, 8, 1, 64, True),     # GQA 8:1
])
def test_kernels_match_plain(cuda_device, b, l, h, kvh, d, causal):
    q, k, v, do = _qkvdo(cuda_device, b, l, h, kvh, d, seed=l)
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.flash_bwd_delta_kernel(o_ref, do)
    grads = (fa.flash_bwd_dq_kernel(q, k, v, lse_ref, do, delta, causal),
             *fa.flash_bwd_dkv_kernel(q, k, v, lse_ref, do, delta, causal))
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
    inputs, one launch of each kernel per forward and backward (one delta
    pre-pass for both backward kernels)."""
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
        "fwd": 2, "bwd_dq": 2, "bwd_dkv": 2, "bwd_delta": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_two_launches_give_identical_bits(cuda_device, d):
    """No atomics and a fixed order of every sum: the forward, dq and
    dk/dv kernels give the same bits on every launch."""
    q, k, v, do = _qkvdo(cuda_device, 2, 300, 8, 2, d, seed=d)
    first = fa.flash_fwd_kernel(q, k, v, True)
    second = fa.flash_fwd_kernel(q, k, v, True)
    o, lse = first
    delta = fa.flash_bwd_delta_kernel(o, do)
    grads = [(fa.flash_bwd_dq_kernel(q, k, v, lse, do, delta, True),
              *fa.flash_bwd_dkv_kernel(q, k, v, lse, do, delta, True))
             for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h,d", [(2, 300, 8, 64), (1, 1000, 4, 128),
                                     (3, 77, 2, 16), (1, 129, 4, 32)])
def test_bwd_delta_matches_plain(cuda_device, b, l, h, d):
    """The pre-pass against its plain version, on a strided view of dO."""
    gen = torch.Generator(cuda_device).manual_seed(l)
    o = _bf16(gen, b, l, h, d)
    do = _bf16(gen, b, l, 2 * h, d)[:, :, ::2]
    before = fa.launches["bwd_delta"]
    got = fa.flash_bwd_delta_kernel(o, do)
    want = fa.flash_bwd_delta_plain(o, do)
    torch.cuda.synchronize()
    assert fa.launches["bwd_delta"] == before + 1
    assert got.shape == (b, h, l) and got.dtype == torch.float32
    _assert_close(got, want, atol=1e-5, rms_tol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 16, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_fwd_kernel(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        fa.flash_fwd_kernel(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError):
        fa.flash_fwd_kernel(q, q[:, :, :1].expand(1, 16, 3, 64), q)
    lse = torch.zeros((1, 2, 16), device=cuda_device)
    before = dict(fa.launches)
    for kernel in (fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel):
        with pytest.raises(ValueError):  # delta of the wrong shape
            kernel(q, q, q, lse, q, lse[:, :, :8].contiguous())
        with pytest.raises(ValueError):  # delta of the wrong dtype
            kernel(q, q, q, lse, q, lse.to(torch.bfloat16))
    assert fa.launches == before


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
    assert n0 == {"fwd": layers, "bwd_dq": layers, "bwd_dkv": layers,
                  "bwd_delta": layers}
    assert n1 == {"fwd": 2 * layers, "bwd_dq": layers, "bwd_dkv": layers,
                  "bwd_delta": layers}
    torch.testing.assert_close(loss1, loss0, atol=0, rtol=0)
    for a, b in zip(grads1, grads0):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.gpu
def test_flash_attention_gspmd_on_a_world_of_one(cuda_device):
    """flash_attention_gspmd on DTensors over a CUDA mesh of one rank
    (NCCL) against flash_attention on the same tensors: the kernels run on
    the local shards (one launch of each per forward and backward) and
    give the same bits, output and gradients."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import logical_to_spec, placements

    created = not dist.is_initialized()
    mesh = build_mesh(MeshConfig(dp=1))
    try:
        q, k, v, do = _qkvdo(cuda_device, 2, 256, 8, 2, 64, seed=3)
        where = placements(mesh, logical_to_spec(
            ("batch", "sequence", "heads", None)))
        placed = [distribute_tensor(x, mesh, where).requires_grad_(True)
                  for x in (q, k, v)]
        plain = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        before = dict(fa.launches)
        out = fa.flash_attention_gspmd(*placed, causal=True)
        assert isinstance(out, DTensor)
        out.backward(distribute_tensor(do, mesh, where))
        launched = {kind: fa.launches[kind] - before[kind] for kind in before}
        want = fa.flash_attention(*plain, causal=True)
        want.backward(do)
        assert launched == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1,
                            "bwd_delta": 1}
        torch.testing.assert_close(out.full_tensor(), want, atol=0, rtol=0)
        for a, b in zip(placed, plain):
            torch.testing.assert_close(a.grad.full_tensor(), b.grad, atol=0,
                                       rtol=0)
    finally:
        if created:
            dist.destroy_process_group()


@pytest.mark.gpu
def test_moe_mlp_on_the_card_matches_the_cpu(cuda_device):
    """moe_mlp at f32 on the card against the same call on the CPU, on
    the same weights and input (TF32 is off, so both sum f32 products in
    other orders): output and aux to 1e-5, every gradient to 1e-4."""
    from ray_tpu_torch.models import moe

    gen = torch.Generator().manual_seed(0)
    layer = {k: v[0] for k, v in moe.init_moe_params(
        gen, 64, 128, 4, 1, device="cpu").items()}
    x = torch.randn((2, 64, 64), generator=gen)
    runs = []
    for device in ("cpu", cuda_device):
        weights = {k: v.detach().clone().to(device).requires_grad_(True)
                   for k, v in layer.items()}
        xd = x.clone().to(device).requires_grad_(True)
        out, aux = moe.moe_mlp(weights, xd, dtype=torch.float32)
        (out.square().sum() + aux).backward()
        runs.append((out, aux, xd.grad,
                     *(weights[k].grad for k in sorted(weights))))
    (out, aux, *grads), (out_gpu, aux_gpu, *grads_gpu) = runs
    torch.testing.assert_close(out_gpu.cpu(), out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux_gpu.cpu(), aux, atol=1e-5, rtol=1e-5)
    for a, b in zip(grads_gpu, grads):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_llama_pipeline_forward_on_a_world_of_one(cuda_device):
    """llama_pipeline_forward with flash attention (bf16) on a CUDA mesh
    of one rank (NCCL), params placed per param_logical_axes: at one
    microbatch it computes what llama.forward does, bit for bit; at two,
    the same logits from half-size products (bf16 rounding apart), each
    microbatch's stage launching the forward kernel once a layer."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.pipeline import llama_pipeline_forward
    from ray_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), attention="flash",
                              num_kv_heads=2)
    params = llama.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), device=cuda_device,
                           generator=torch.Generator(cuda_device).manual_seed(1))
    created = not dist.is_initialized()
    mesh = build_mesh(MeshConfig(pp=1))
    try:
        placed = shard_params(params, mesh, llama.param_logical_axes(cfg))
        with torch.no_grad():
            want = llama.forward(params, tokens, cfg)
            one = llama_pipeline_forward(placed, tokens, cfg, 1, 1)
            before = fa.launches["fwd"]
            two = llama_pipeline_forward(placed, tokens, cfg, 1, 2)
            launched = fa.launches["fwd"] - before
        assert isinstance(one, DTensor)
        torch.testing.assert_close(one.full_tensor(), want, atol=0, rtol=0)
        assert launched == 2 * cfg.num_layers
        two = two.full_tensor()
        assert torch.isfinite(two).all()
        assert ((two - want).norm() / want.norm()).item() < 1e-2
    finally:
        if created:
            dist.destroy_process_group()


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


# (rows, D, dtype, row stride or None for contiguous rows): the shapes of
# chip_smoke.py's rmsnorm phase. 999 and 1001 are no multiple of the
# vector width: the first is read one element at a time (unaligned rows),
# the second as vectors with a scalar tail.
RMSNORM_CASES = {
    "decode_bf16": (8, 4096, torch.bfloat16, None),
    "prefill_bf16": (256, 4096, torch.bfloat16, None),
    "train_bf16": (16384, 1024, torch.bfloat16, None),
    "decode_f32": (8, 4096, torch.float32, None),
    "odd_d_bf16": (7, 999, torch.bfloat16, None),
    "tail_view_bf16": (7, 1001, torch.bfloat16, 1024),
    "strided_rows_bf16": (64, 4096, torch.bfloat16, 2 * 4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RMSNORM_CASES))
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32],
                         ids=["scale_bf16", "scale_f32"])
def test_rmsnorm_kernel_matches_plain(cuda_device, case, scale_dtype):
    rows, d, dtype, stride = RMSNORM_CASES[case]
    gen = torch.Generator(cuda_device).manual_seed(rows + d)
    width = stride or d
    base = torch.randn((rows, width), generator=gen, device=cuda_device)
    x = (3 * base).to(dtype)[:, :d]
    if stride is None:
        x = x.contiguous()
    scale = (torch.randn(d, generator=gen, device=cuda_device) + 1).to(
        scale_dtype)
    before = fused.launches["rmsnorm"]
    got = fused.rms_norm_kernel(x, scale, 1e-5)
    want = fused.rms_norm_plain(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert fused.launches["rmsnorm"] == before + 1
    assert got.dtype == dtype and got.shape == (rows, d)
    if dtype == torch.bfloat16:
        _assert_close(got, want, atol=1e-6, rms_tol=4e-3, rtol=2 ** -7)
    else:
        _assert_close(got, want, atol=1e-6, rms_tol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_rmsnorm_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((4, 64), device=cuda_device, dtype=torch.bfloat16)
    before = dict(fused.launches)
    with pytest.raises(TypeError):
        fused.rms_norm_kernel(x.half(), torch.ones(64, device=cuda_device))
    with pytest.raises(ValueError):
        fused.rms_norm_kernel(x.t(), torch.ones(4, device=cuda_device))
    with pytest.raises(ValueError):
        fused.rms_norm_kernel(x, torch.ones(32, device=cuda_device))
    with pytest.raises(ValueError):
        fused.rms_norm_kernel(x, torch.ones(64))
    assert fused.launches == before


@pytest.mark.gpu
def test_rmsnorm_entry_point_backward_on_the_card(cuda_device):
    """The autograd Function: the forward launches the kernel, the
    backward is the analytic formula; both as on the CPU to f32 order."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    x = torch.randn((4, 33, 256), generator=gen, device=cuda_device)
    scale = torch.randn(256, generator=gen, device=cuda_device) + 1
    g = torch.randn((4, 33, 256), generator=gen, device=cuda_device)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        xs, ss = (t.to(device).requires_grad_(True) for t in (x, scale))
        out = fused.rms_norm(xs, ss)
        results.append((out, *torch.autograd.grad(out, (xs, ss),
                                                  g.to(device))))
    for got, want in zip(*results):
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_rmsnorm_without_grad_launches_once(cuda_device):
    """Under no_grad (the serving call) rms_norm launches the kernel once,
    without the autograd Function: no grad_fn, the kernel's own output."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((2, 4, 4096), generator=gen, device=cuda_device).to(
        torch.bfloat16).requires_grad_(True)
    scale = torch.randn(4096, generator=gen, device=cuda_device).to(
        torch.bfloat16).requires_grad_(True)
    before = fused.launches["rmsnorm"]
    with torch.no_grad():
        out = fused.rms_norm(x, scale)
    assert fused.launches["rmsnorm"] == before + 1
    assert out.grad_fn is None and out.shape == x.shape
    want = fused.rms_norm_kernel(x.detach().reshape(-1, 4096),
                                 scale.detach())
    assert torch.equal(out.reshape(-1, 4096), want)


@pytest.mark.gpu
def test_serving_norms_run_on_the_kernel(cuda_device):
    """Every forward of the paged engine on the card launches the kernel
    2 x layers + 1 times (attention, MLP and final norm), and greedy
    decoding equals the full-context forward's (float32)."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    engine = LLMEngine(cfg, max_batch_size=2, max_seq_len=64, block_size=8,
                       prefill_chunk=8)
    try:
        prompt = [5, 9, 2, 7, 11, 3, 8, 1, 40, 2]
        before = fused.launches["rmsnorm"]
        out = engine.result(engine.submit(prompt, max_new_tokens=6),
                            timeout_s=120)
        stats = engine.engine_stats()
        forwards = stats["prefill_chunks"] + stats["decode_steps"]
        assert fused.launches["rmsnorm"] - before \
            == (2 * cfg.num_layers + 1) * forwards
        toks, expected = list(prompt), []
        for _ in range(6):
            logits = llama.forward(engine.params,
                                   torch.tensor([toks], device=cuda_device),
                                   cfg)
            expected.append(int(torch.argmax(logits[0, -1])))
            toks.append(expected[-1])
        assert out == expected
    finally:
        engine.shutdown()


@pytest.mark.gpu
def test_gpu_task_runs_the_kernels_on_objects_in_the_store(cuda_device):
    """A ``num_gpus=1`` task of the port's runtime takes CUDA tensors
    ``put`` into its store (the same storage, not a copy) and runs
    ``rms_norm`` and ``flash_attention`` on them through the kernels."""
    import ray_tpu_torch

    gen = torch.Generator(cuda_device).manual_seed(7)
    q, k, v, _ = _qkvdo(cuda_device, 2, 256, 8, 2, 64, seed=7)
    x = _bf16(gen, 16, 4096)
    scale = _bf16(gen, 4096) + 1
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == \
            torch.cuda.device_count()
        ref = ray_tpu_torch.put({"q": q, "k": k, "v": v, "x": x,
                                 "scale": scale})

        @ray_tpu_torch.remote(num_gpus=1)
        def run(tensors):
            with torch.no_grad():
                return (tensors["q"].data_ptr(),
                        ray_tpu_torch.get_runtime_context()
                        .get_assigned_resources(),
                        fused.rms_norm(tensors["x"], tensors["scale"]),
                        fa.flash_attention(tensors["q"], tensors["k"],
                                           tensors["v"], causal=True))

        before = dict(fa.launches), dict(fused.launches)
        ptr, assigned, normed, attn = ray_tpu_torch.get(run.remote(ref),
                                                        timeout=300)
        assert fa.launches["fwd"] == before[0]["fwd"] + 1
        assert fused.launches["rmsnorm"] == before[1]["rmsnorm"] + 1
    finally:
        ray_tpu_torch.shutdown()
    assert ptr == q.data_ptr() and assigned["GPU"] == 1.0
    _assert_close(normed, fused.rms_norm_plain(x, scale, 1e-5),
                  atol=1e-6, rms_tol=4e-3, rtol=2 ** -7)
    _assert_close(attn, fa.flash_fwd_plain(q, k, v, True)[0],
                  atol=2e-3, rms_tol=5e-3)


@pytest.mark.gpu
def test_put_of_cuda_tensors_past_the_budget_is_not_spilled(cuda_device):
    """A ``put`` of CUDA tensors larger than the store's budget keeps the
    tensors (the same ``data_ptr()``), charges their bytes and spills
    nothing."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker

    tree = {"w": torch.zeros(1 << 20, device=cuda_device),
            "b": torch.zeros(4, device=cuda_device)}
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, object_store_memory=1 << 20)
    try:
        ref = ray_tpu_torch.put(tree)
        got = ray_tpu_torch.get(ref)
        stats = worker.global_runtime().store.stats()
    finally:
        ray_tpu_torch.shutdown()
    assert got["w"].data_ptr() == tree["w"].data_ptr()
    assert stats["device_bytes"] == (1 << 22) + 16
    assert stats["spilled_bytes_total"] == 0


@pytest.mark.gpu
def test_store_allreduce_of_cuda_bf16_tensors(cuda_device):
    """Two thread actors allreduce bf16 tensors on the card through the
    collective store: the sum stays bf16 on the card, each rank's its
    own copy, bitwise the same sum taken on the CPU."""
    import ray_tpu_torch
    from ray_tpu_torch.util import collective

    @ray_tpu_torch.remote(num_gpus=0.5)
    class Rank:
        def __init__(self, rank):
            self.rank = rank
            collective.init_collective_group(2, rank, group_name="gpu_ar")

        def run(self, device):
            gen = torch.Generator().manual_seed(self.rank)
            x = torch.randint(-64, 64, (1024, 1024), generator=gen)
            return collective.allreduce(
                x.to(device, torch.bfloat16), group_name="gpu_ar")

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        ranks = [Rank.remote(r) for r in range(2)]
        on_card = ray_tpu_torch.get([a.run.remote(cuda_device)
                                     for a in ranks], timeout=120)
        on_cpu = ray_tpu_torch.get([a.run.remote("cpu") for a in ranks],
                                   timeout=120)
    finally:
        ray_tpu_torch.shutdown()
    assert on_card[0].data_ptr() != on_card[1].data_ptr()
    for got, want in zip(on_card, on_cpu):
        assert got.is_cuda and got.dtype == torch.bfloat16
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_torch_trainer_hooks_on_the_card_keep_replicas_equal(cuda_device):
    """Two TorchTrainer workers on one card: the gradient hooks wait for
    the other rank, so they must run on the worker's thread and not on
    the card's one autograd thread; the fit ends well inside the
    deadline, the gradients are bitwise equal across ranks once clipped,
    and the replicas after every step."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import _group_name, prepare_model
    from ray_tpu_torch.util import collective

    def loop(config):
        rank = train.get_context().get_world_rank()
        gen = torch.Generator(cuda_device).manual_seed(rank)
        model = torch.nn.Sequential(
            torch.nn.Linear(64, 128), torch.nn.Tanh(),
            torch.nn.Linear(128, 1)).to(cuda_device)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=cuda_device) * 0.1)
        model = prepare_model(model)
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        x = torch.randn((256, 64), generator=gen, device=cuda_device)
        equal = []
        for _ in range(5):
            opt.zero_grad()
            model(x).pow(2).mean().backward()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 0.5)
            grads = collective.allgather(
                torch.cat([p.grad.flatten() for p in model.parameters()]),
                group_name=_group_name())
            opt.step()
            flat = torch.cat([p.detach().flatten()
                              for p in model.parameters()])
            gathered = collective.allgather(flat, group_name=_group_name())
            equal.append(torch.equal(grads[0], grads[1])
                         and torch.equal(gathered[0], gathered[1]))
        train.report({"equal": equal})

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        start = time.perf_counter()
        result = train.TorchTrainer(
            loop, scaling_config=train.ScalingConfig(
                num_workers=2, use_gpu=True, gpus_per_worker=0.5),
            run_config=train.RunConfig(report_timeout_s=30)).fit()
        seconds = time.perf_counter() - start
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    assert seconds < 30
    assert result.metrics["equal"] == [True] * 5


@pytest.mark.gpu
def test_dcp_round_trip_of_a_cuda_train_state(cuda_device, tmp_path):
    """A TrainState on the card after one step: restored into a fresh
    state on the card bit for bit, step and count included."""
    import dataclasses

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.train_step import (
        build_train_step,
        create_train_state,
        default_optimizer,
        place_batch,
    )
    from ray_tpu_torch.train import Checkpoint

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    optimizer = default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                  total_steps=50)
    params = llama.init_params(
        cfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)
    state = create_train_state(params, optimizer)
    tokens = torch.randint(0, 256, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    batch = place_batch({"tokens": tokens[:, :-1],
                         "targets": tokens[:, 1:]})
    step = build_train_step(
        lambda p, b: llama.loss_fn(p, b["tokens"], b["targets"], cfg),
        optimizer)
    state, _ = step(state, batch)
    restored = Checkpoint.from_state(state, str(tmp_path / "c")).to_state(
        create_train_state(params, optimizer))

    def leaves(s):
        return tree_leaves(s.params) + tree_leaves(s.opt_state["mu"]) \
            + tree_leaves(s.opt_state["nu"])

    assert (restored.step, restored.opt_state["count"]) == (1, 1)
    for got, want in zip(leaves(restored), leaves(state)):
        assert got.is_cuda and torch.equal(got, want.detach())


@pytest.mark.gpu
def test_cuda_tensors_cross_into_worker_processes(cuda_device):
    """A CUDA bf16 tensor sent to a pool worker (which sees no card)
    arrives there as a CPU tensor, bitwise; sent to a ``num_gpus=1``
    process actor it arrives on the actor's card, bitwise, and what the
    actor returns from its card arrives here on ``cuda``."""
    import os

    import ray_tpu_torch as rt

    gen = torch.Generator(cuda_device).manual_seed(0)
    x = _bf16(gen, 64, 128)
    rt.init(num_cpus=4, process_workers=1)
    try:
        @rt.remote
        def on_pool(t):
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.cuda.device_count(), t.device.type, t)

        visible, cards, device, back = rt.get(on_pool.remote(x), timeout=120)
        assert (visible, cards, device) == ("", 0, "cpu")
        assert torch.equal(back, x.cpu())

        @rt.remote(process=True, num_gpus=1)
        class OnCard:
            def take(self, t):
                return t.device.type, os.environ.get("CUDA_VISIBLE_DEVICES"), \
                    t * 2

        actor = OnCard.remote()
        device, visible, doubled = rt.get(actor.take.remote(x), timeout=300)
        assert (device, visible) == ("cuda", "0")
        assert doubled.device.type == "cuda"
        assert torch.equal(doubled, x * 2)
        rt.kill(actor)
    finally:
        rt.shutdown()


def _busy(device, n=24):
    """Queue a chain of matrix products on the current stream: it keeps
    that stream busy for milliseconds after the host moves on."""
    a = torch.randn(2048, 2048, device=device)
    for _ in range(n):
        a = torch.tanh(a @ a)
    return a


def _feed_batches(n, rows=2048, cols=2048):
    """Host batches whose every element is an integer (sums in f64 are
    exact) and differs from batch to batch."""
    import numpy as np

    base = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols) % 97
    return [{"x": base + np.float32(1000 * i)} for i in range(n)]


@pytest.mark.gpu
def test_device_feed_lands_each_copy_before_the_consumer_reads(
        cuda_device):
    """The first double-buffer hazard, a batch read before its copy has
    landed. A 64 MB batch is followed by a 16 KB one, so the feed hands
    out the large batch well inside its copy's milliseconds (staging the
    small one takes microseconds), and a kernel on the consumer's stream
    reads it at once; every fourth batch is taken while that stream is
    kept busy by a chain of products queued before ``next()``. Every
    batch must be bitwise its host rows."""
    from ray_tpu_torch.data._device_feed import stage_batches

    host = [b for big, small in zip(_feed_batches(8, rows=4096, cols=4096),
                                    _feed_batches(8, rows=1, cols=4096))
            for b in (big, small)]
    feed = stage_batches(iter(host), cuda_device)
    reads = []
    for i in range(len(host)):
        if i % 4 == 3:
            _busy(cuda_device)
        batch = next(feed)
        assert batch["x"].device.type == "cuda"
        reads.append(batch["x"].clone())
    assert next(feed, None) is None
    torch.cuda.synchronize()
    for got, want in zip(reads, host):
        assert torch.equal(got.cpu(), torch.from_numpy(want["x"]))


@pytest.mark.gpu
def test_device_feed_reuses_no_buffer_under_a_copy_in_flight(cuda_device):
    """The second hazard, a buffer freed or reused under a copy (or a
    read) still in flight: 64 batches through a feed whose consumer
    queues a reduction behind a busy stream and drops the batch at once.
    The sums are those of the host batches."""
    from ray_tpu_torch.data._device_feed import stage_batches

    host = _feed_batches(64, rows=1024)
    sums = []
    for batch in stage_batches(iter(host), cuda_device):
        _busy(cuda_device, n=4)
        sums.append(torch.sum(batch["x"], dtype=torch.float64))
        del batch
    torch.cuda.synchronize()
    want = [float(b["x"].astype("float64").sum()) for b in host]
    assert [s.item() for s in sums] == want


@pytest.mark.gpu
def test_gpu_task_on_a_node_daemon_returns_the_drivers_bits(cuda_device):
    """A ``num_gpus=1`` task on a one-daemon cluster runs the RMSNorm and
    flash-attention kernels in the daemon's process (its pid is not the
    driver's) on inputs it makes from a seed; what comes back to the
    driver is a CUDA tensor bitwise equal to the driver's own launches on
    the same seed."""
    import os
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    def compute(seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        x = torch.randn(64, 1024, generator=gen, device="cuda")
        scale = torch.randn(1024, generator=gen, device="cuda") + 1
        q, k, v = (torch.randn(1, 256, h, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (8, 2, 2))
        with torch.no_grad():
            return (os.getpid(), fused.rms_norm(x, scale),
                    fa.flash_attention(q, k, v, causal=True))

    rt.shutdown()
    cluster = Cluster()
    cluster.add_node(num_cpus=2, resources={"GPU": 1})
    try:
        assert cluster.wait_for_nodes(1, timeout=120)
        rt.init(num_cpus=0, num_gpus=0, address=cluster.address)
        deadline = time.monotonic() + 60
        while rt.cluster_resources().get("GPU", 0) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        pid, normed, attn = rt.get(
            rt.remote(num_gpus=1)(compute).remote(3), timeout=300)
        daemon_pids = {node.pid for node in cluster.worker_nodes}
    finally:
        rt.shutdown()
        cluster.shutdown()
    assert pid != os.getpid() and pid in daemon_pids
    _, want_normed, want_attn = compute(3)
    assert normed.device.type == "cuda" and attn.device.type == "cuda"
    assert torch.equal(normed, want_normed)
    assert torch.equal(attn, want_attn)


@pytest.mark.gpu
def test_a_fwd_result_maps_between_co_hosted_daemons(cuda_device):
    """Two daemons on this host (both on card 0): a ``fwd`` result made
    on A is read by a ``num_gpus=1`` task on B through the same-host
    plane (one copy out of A's segment under a lease A grants, no chunk
    served), arrives on ``cuda`` there, and comes back to the driver
    bitwise the driver's own launch on the same seed."""
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    def attend(seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        q, k, v = (torch.randn(8, 2048, h, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (16, 8, 8))
        with torch.no_grad():
            return fa.flash_attention(q, k, v, causal=True)

    def echo(o):
        return o.device.type, o

    rt.shutdown()
    cluster = Cluster()
    nodes = [cluster.add_node(num_cpus=2, resources={"GPU": 1})
             for _ in range(2)]
    try:
        assert cluster.wait_for_nodes(2, timeout=120)
        runtime = rt.init(num_cpus=0, num_gpus=0, address=cluster.address)
        deadline = time.monotonic() + 120
        while rt.cluster_resources().get("GPU", 0) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        with runtime._remote_nodes_lock:
            by_pid = {h.pool.call("exec_ping"): (nid, h)
                      for nid, h in runtime._remote_nodes.items()}
        (id_a, handle_a), (id_b, handle_b) = (by_pid[n.pid] for n in nodes)

        def on(node_id):
            return NodeAffinitySchedulingStrategy(node_id.hex(), soft=False)

        o_ref = rt.remote(num_gpus=1, scheduling_strategy=on(id_a))(
            attend).remote(5)
        device_on_b, got = rt.get(rt.remote(
            num_gpus=1, scheduling_strategy=on(id_b))(echo).remote(o_ref),
            timeout=300)
        plane_b = handle_b.pool.call("executor_stats")["data_plane"]
        stats_a = handle_a.pool.call("executor_stats")
    finally:
        rt.shutdown()
        cluster.shutdown()
    assert device_on_b == "cuda" and got.device.type == "cuda"
    assert torch.equal(got, attend(5))
    assert plane_b["same_host_copy_hits"] + plane_b["same_host_map_hits"] \
        >= 1 and plane_b["chunked_pulls"] == 0
    assert stats_a["data_plane"]["leases"]["granted"] >= 1
    assert stats_a["store"]["fetches_served"] == 0


@pytest.mark.gpu
def test_spilled_kernel_result_survives_a_head_restart(cuda_device,
                                                       tmp_path):
    """A ``fwd`` result (67 MB) made on a daemon whose node store is
    capped at 48 MiB spills to the daemon's disk and is marked spilled in
    the durable head's directory; the head restarts in the crash shape
    (no last snapshot), the mark comes back from its WAL, and the driver
    reads the result back from the daemon's disk bitwise its own launch."""
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    def attend(seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        q, k, v = (torch.randn(16, 2048, h, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (16, 8, 8))
        with torch.no_grad():
            return fa.flash_attention(q, k, v, causal=True)

    def wait(predicate, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not predicate():
            assert time.monotonic() < deadline
            time.sleep(0.1)

    rt.shutdown()
    cluster = Cluster(log_dir=str(tmp_path / "log"),
                      persist_path=str(tmp_path / "gcs_snapshot.pkl"))
    cluster.add_node(num_cpus=2, resources={"GPU": 1}, heartbeat_period_s=0.5,
                     env={"RAY_TPU_TORCH_NODE_STORE_PRIMARY_LIMIT_MB": "48"})
    try:
        assert cluster.wait_for_nodes(1, timeout=120)
        runtime = rt.init(num_cpus=0, num_gpus=0, address=cluster.address)
        wait(lambda: rt.cluster_resources().get("GPU", 0) >= 1)
        ref = rt.remote(num_gpus=1)(attend).remote(5)
        rt.wait([ref], timeout=300)
        with runtime._remote_nodes_lock:
            handle = next(iter(runtime._remote_nodes.values()))
        wait(lambda: handle.pool.call("executor_stats")["store"][
            "spilled_blobs"] == 1)
        wait(lambda: ref.hex() in cluster.gcs._list_object_locations(
            None, True)[1])
        epoch = cluster.gcs.epoch
        cluster.restart_head(graceful=False)
        assert cluster.gcs.epoch == epoch + 1
        assert ref.hex() in cluster.gcs._list_object_locations(None, True)[1]
        assert cluster.wait_for_nodes(1, timeout=120)
        got = rt.get(ref, timeout=300)
        restores = handle.pool.call("executor_stats")["spill"]["restores"]
    finally:
        rt.shutdown()
        cluster.shutdown()
    assert restores >= 1
    assert got.device.type == "cuda" and torch.equal(got, attend(5))


@pytest.mark.gpu
def test_borrowed_fwd_result_is_normed_by_a_daemon_actor(cuda_device,
                                                         tmp_path):
    """The driver's own ``fwd`` result, ``put`` and handed to a
    ``num_gpus=1`` actor on a daemon inside a list, is borrowed there: it
    outlives every handle in the driver, the actor reads it on its card
    and its RMSNorm over it is bitwise the driver's own launch, and the
    driver's store lets the object go once the actor drops it."""
    import gc
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    gen = torch.Generator("cuda").manual_seed(9)
    q, k, v = (torch.randn(2, 1024, h, 64, generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (16, 8, 8))
    scale = torch.randn(1024, generator=gen, device="cuda") + 1
    with torch.no_grad():
        o = fa.flash_attention(q, k, v, causal=True)
        want = fused.rms_norm(o.float().reshape(-1, 1024), scale)

    class Holder:
        def __init__(self):
            self.ref = None

        def hold(self, boxed):
            self.ref = boxed[0]
            return "held"

        def norm(self, scale):
            import ray_tpu_torch

            got = ray_tpu_torch.get(self.ref)
            with torch.no_grad():
                return got.device.type, fused.rms_norm(
                    got.float().reshape(-1, 1024), scale)

        def drop(self):
            self.ref = None
            return "dropped"

    def wait(predicate, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not predicate():
            assert time.monotonic() < deadline
            time.sleep(0.05)

    rt.shutdown()
    cluster = Cluster(log_dir=str(tmp_path / "log"))
    cluster.add_node(num_cpus=2, resources={"GPU": 1})
    try:
        assert cluster.wait_for_nodes(1, timeout=120)
        runtime = rt.init(num_cpus=0, num_gpus=0, address=cluster.address)
        wait(lambda: rt.cluster_resources().get("GPU", 0) >= 1)
        holder = rt.remote(num_gpus=1)(Holder).remote()
        ref = rt.put(o)
        oid = ref.id()
        assert rt.get(holder.hold.remote([ref]), timeout=300) == "held"
        del ref
        gc.collect()
        server = runtime.worker_client_server

        def borrowed():
            with server._lock:
                return bool(set(server._borrowers.get(oid.hex(), ()))
                            - {"__direct__"})

        wait(borrowed, 30)
        assert runtime.store.contains(oid)
        device, normed = rt.get(holder.norm.remote(scale), timeout=300)
        assert rt.get(holder.drop.remote(), timeout=60) == "dropped"
        wait(lambda: not runtime.store.contains(oid), 30)
    finally:
        rt.shutdown()
        cluster.shutdown()
    assert device == "cuda" and normed.device.type == "cuda"
    assert torch.equal(normed, want)


@pytest.mark.gpu
def test_node_results_survive_a_shard_kill(cuda_device, tmp_path):
    """chip_smoke.py's node_cluster (a') on the card: a durable head with
    four shards and two daemons on card 0; the flash forward in a
    ``num_gpus=1`` task on A, RMSNorm over its output on B, the shard
    that owns the output's id killed (it replays its records; its epoch
    and restores move, no other shard's), and RMSNorm on B again over
    the same output: bitwise the first, one kernel launch each."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import gcs_shard
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.cluster_utils import Cluster

    # The tasks are defined here: they go to the daemons by value.
    def _daemon_flash(seed: int):
        """On daemon A: the flash forward on inputs made on its card
        from ``seed``, and the forward kernel's launches there."""
        import importlib

        import torch

        fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
        gen = torch.Generator("cuda").manual_seed(seed)
        q, k, v = (torch.randn((1, 512, 4, 64), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        before = fa.launches["fwd"]
        with torch.no_grad():
            o = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        return o, fa.launches["fwd"] - before

    def _daemon_norm(o):
        """On daemon B: RMSNorm over the flash output as f32 rows, and
        the kernel's launches there."""
        import importlib

        import torch

        fused = importlib.import_module("ray_tpu_torch.ops.fused")
        scale = torch.linspace(0.5, 1.5, o.shape[2] * o.shape[3],
                               device=o.device)
        before = fused.launches["rmsnorm"]
        with torch.no_grad():
            out = fused.rms_norm(o.float().reshape(o.shape[1], -1), scale)
        torch.cuda.synchronize()
        return out, fused.launches["rmsnorm"] - before

    rt.shutdown()
    # Past the first tick's snapshot the shards write only their WALs,
    # so the kill replays the output's location.
    GLOBAL_CONFIG.update({"gcs_shards": 4,
                          "gcs_snapshot_interval_s": 3600.0})
    cluster = Cluster(log_dir=str(tmp_path / "cluster"),
                      persist_path=str(tmp_path / "gcs_snapshot.pkl"))
    try:
        cluster.add_node(num_cpus=1, resources={"GPU": 1, "node_a": 1})
        cluster.add_node(num_cpus=1, resources={"GPU": 1, "node_b": 1})
        assert cluster.wait_for_nodes(2, timeout=300)
        rt.init(num_cpus=0, num_gpus=0, address=cluster.address)
        deadline = time.monotonic() + 120
        while rt.cluster_resources().get("GPU", 0) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        head = cluster.gcs
        o_ref, fwd_ref = rt.remote(
            num_gpus=1, num_returns=2, resources={"node_a": 1})(
            _daemon_flash).remote(31)
        norm = rt.remote(num_gpus=1, num_returns=2,
                         resources={"node_b": 1})(_daemon_norm)
        n_ref, n_launch_ref = norm.remote(o_ref)
        assert rt.get(fwd_ref, timeout=300) == 1
        assert rt.get(n_launch_ref, timeout=300) == 1
        first = rt.get(n_ref, timeout=300)
        o_hex = o_ref.hex()
        victim = gcs_shard.shard_of(o_hex, 4)
        deadline = time.monotonic() + 30
        while o_hex not in head._shards[victim].directory.locations():
            assert time.monotonic() < deadline, "o never published"
            time.sleep(0.05)
        before = head.shard_stats()
        epoch = head.epoch
        assert head._kill_shard(victim) >= 1
        after = head.shard_stats()
        assert head.epoch == epoch + 1
        assert [a["restores"] - b["restores"]
                for a, b in zip(after, before)] == \
            [int(i == victim) for i in range(4)]
        again_ref, again_launch_ref = norm.remote(o_ref)
        assert rt.get(again_launch_ref, timeout=300) == 1
        again = rt.get(again_ref, timeout=300)
        assert again.device.type == "cuda" and torch.equal(again, first)
        deadline = time.monotonic() + 60
        while o_hex not in head._shards[victim].directory.locations():
            assert time.monotonic() < deadline, "o's holder never re-synced"
            time.sleep(0.05)
    finally:
        rt.shutdown()
        cluster.shutdown()
        GLOBAL_CONFIG.reset()
        gcs_shard.init_from_config()


@pytest.mark.gpu
def test_rmsnorm_tasks_ride_the_submit_ring_to_a_daemon(cuda_device,
                                                        tmp_path):
    """chip_smoke.py's node_cluster (a'') on the card, on one daemon:
    ``num_gpus=1`` RMSNorm tasks over inputs the driver put, submitted
    at once through the submit ring, each bitwise the driver's own
    launch with one kernel launch; then CPU tasks taking those results
    as ref arguments, which ride execute_task_batch RPCs down its
    classic branch, their checksums the driver's."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    # The tasks are defined here: they go to the daemon by value.
    def _norm(x, scale):
        import importlib

        import torch

        fused = importlib.import_module("ray_tpu_torch.ops.fused")
        before = fused.launches["rmsnorm"]
        with torch.no_grad():
            out = fused.rms_norm(x, scale, 1e-5)
        torch.cuda.synchronize()
        return out, fused.launches["rmsnorm"] - before

    def _checksum(x):
        import torch

        return float(torch.as_tensor(x).cpu().double().sum())

    gen = torch.Generator(cuda_device).manual_seed(43)
    xs = [torch.randn(8, 4096, generator=gen, device=cuda_device)
          for _ in range(8)]
    scale = torch.randn(4096, generator=gen, device=cuda_device)
    with torch.no_grad():
        want = [fused.rms_norm(x, scale, 1e-5) for x in xs]
    torch.cuda.synchronize()
    rt.shutdown()
    cluster = Cluster(log_dir=str(tmp_path / "cluster"))
    try:
        cluster.add_node(num_cpus=2, resources={"GPU": 1})
        assert cluster.wait_for_nodes(1, timeout=300)
        runtime = rt.init(num_cpus=0, num_gpus=0, address=cluster.address)
        deadline = time.monotonic() + 120
        while rt.cluster_resources().get("GPU", 0) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        assert runtime._submit_ring is not None
        handle = next(iter(runtime._remote_nodes.values()))
        rpcs0 = handle.pool.call("executor_stats")["pipeline"]["batch_rpcs"]
        ring0 = runtime.execution_pipeline_stats()["submit"]["ring_submits"]
        scale_ref = rt.put(scale)
        norm = rt.remote(num_gpus=1, num_returns=2)(_norm)
        pairs = [norm.remote(rt.put(x), scale_ref) for x in xs]
        got = rt.get([p[0] for p in pairs], timeout=300)
        assert rt.get([p[1] for p in pairs], timeout=60) == [1] * 8
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        sums = rt.get([rt.remote(num_cpus=1)(_checksum).remote(p[0])
                       for p in pairs], timeout=300)
        assert sums == [float(w.cpu().double().sum()) for w in want]
        stats = handle.pool.call("executor_stats")["pipeline"]
        assert stats["batch_rpcs"] > rpcs0
        assert runtime.execution_pipeline_stats()["submit"][
            "ring_submits"] - ring0 >= 16
    finally:
        rt.shutdown()
        cluster.shutdown()


@pytest.mark.gpu
def test_traced_rmsnorm_task_links_its_daemon_span(cuda_device, tmp_path):
    """chip_smoke.py's node_cluster (a''') on the card, on one daemon: a
    traced ``num_gpus=1`` RMSNorm task, bitwise the driver's own launch
    with one kernel launch; its ``daemon:execute`` span sits on the
    daemon's lane under the driver's submit span, in its trace, and its
    stages come in STAGES order."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import tracing

    def _norm(x, scale):
        import importlib
        import os

        import torch

        fused = importlib.import_module("ray_tpu_torch.ops.fused")
        before = fused.launches["rmsnorm"]
        with torch.no_grad():
            out = fused.rms_norm(x, scale, 1e-5)
        torch.cuda.synchronize()
        return (out, fused.launches["rmsnorm"] - before,
                os.environ.get("RAY_TPU_TORCH_NODE_TAG", "?"))

    gen = torch.Generator(cuda_device).manual_seed(47)
    x = torch.randn(64, 4096, generator=gen, device=cuda_device)
    scale = torch.randn(4096, generator=gen, device=cuda_device)
    with torch.no_grad():
        want = fused.rms_norm(x, scale, 1e-5)
    torch.cuda.synchronize()
    rt.shutdown()
    tracing.clear()
    tracing.enable()
    cluster = Cluster(log_dir=str(tmp_path / "cluster"))
    try:
        cluster.add_node(num_cpus=2, resources={"GPU": 1})
        assert cluster.wait_for_nodes(1, timeout=300)
        runtime = rt.init(num_cpus=0, num_gpus=0, address=cluster.address)
        deadline = time.monotonic() + 120
        while rt.cluster_resources().get("GPU", 0) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        norm = rt.remote(num_gpus=1, num_returns=3)(_norm)
        with tracing.trace_span("submit:norm") as submit:
            out_ref, n_ref, tag_ref = norm.remote(rt.put(x), rt.put(scale))
        got = rt.get(out_ref, timeout=300)
        assert rt.get(n_ref, timeout=60) == 1
        assert torch.equal(got, want)
        lane = f"node:{rt.get(tag_ref, timeout=60)[:8]}"
        linked = [s for s in tracing.get_spans()
                  if s.name == "daemon:execute"
                  and s.parent_id == submit.span_id
                  and s.trace_id == submit.trace_id]
        assert [s.proc for s in linked] == [lane]
        event = next(ev for ev in runtime.gcs.list_task_events()
                     if ev.name.endswith("_norm"))
        present = [s for s in tracing.STAGES if s in event.stage_ts]
        assert {"submit", "dispatch", "rpc_sent", "admitted", "exec_start",
                "exec_end", "seal"} <= set(present)
        assert [event.stage_ts[s] for s in present] \
            == sorted(event.stage_ts[s] for s in present)
    finally:
        tracing.disable()
        tracing.clear()
        rt.shutdown()
        cluster.shutdown()
