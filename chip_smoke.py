#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card (an H100 is what the
bounds below are taken against):

    python3 chip_smoke.py

It builds the CUDA kernels from ``ray_tpu_torch/ops/csrc/``, holds each
kernel against its plain PyTorch version at the training shapes, checks
the flash model against the plain one, then trains ``bench.py``'s Llama
(~349M parameters, 24 layers, GQA 16/8, head dim 64, flash attention,
"dots" remat, bf16 compute with f32 master weights) for 2 warm-up and 5
timed steps at batch 8 x 2048. Each phase prints one JSON line. The
line before the last lists every kernel with its launches in the train
phase, its error against the plain version and its times; the last line
is ``{"ok": true, "device": {...}}``. Any failure exits nonzero, and
without a card the script fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# The kernels of the main path and the TPU kernels they replace.
KERNELS = {
    "fwd": ("_fwd_kernel", "ray_tpu/ops/flash_attention.py:56"),
    "bwd_dq": ("_bwd_dq_kernel", "ray_tpu/ops/flash_attention.py:153"),
    "bwd_dkv": ("_bwd_dkv_kernel", "ray_tpu/ops/flash_attention.py:195"),
}
SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"
KERNEL_OUTPUTS = {"fwd": ("o",), "bwd_dq": ("dq",),
                  "bwd_dkv": ("dk", "dv")}

# Kernel against plain version, both bf16 on the same inputs. Both round p
# and ds to bf16 before their products and the outputs to bf16, and sum in
# f32 in different orders. An element then differs by one bf16 step where
# the two f32 sums straddle a rounding boundary, plus the spread of the
# intermediate roundings: rtol allows two steps at the bottom of a binade
# (2^-6). The spread follows the typical element of a row, not this one:
# atol covers it where the element is near 0. rms_tol bounds
# ||kernel - plain|| / ||plain|| over the whole tensor. The forward rounds
# p against the running row max where the plain version uses the final
# max, so o spreads more (relative RMS 1.3e-3 to 1.9e-3 on the H100) than
# dq, dk and dv (5e-5 to 2e-4); the RMS bounds are 2.5x or more above
# those, and the worst element came to 0.73 of its bound. A kernel that
# drops one middle key tile must fail (checked in every run, see
# _dropped_tile: 61x over the element bound, relative RMS 6.8e-2).
O_TOL = {"rtol": 2 ** -6, "atol": 2e-3, "rms_tol": 5e-3}
GRAD_TOL = {"rtol": 2 ** -6, "atol": 1e-3, "rms_tol": 1e-3}
TOLERANCES = {"o": O_TOL, "dq": GRAD_TOL, "dk": GRAD_TOL, "dv": GRAD_TOL}
# lse is f32 on both sides (|lse| < 16: an f32 step is under 2e-6).
LSE_TOL = {"rtol": 0.0, "atol": 1e-4, "rms_tol": 1e-6}
# Flash model against plain-attention model, both bf16 on the same weights.
# The plain path rounds scores and probabilities to bf16 where the kernels
# keep f32, so the two differ by that rounding (~2^-9 of each score and
# probability), carried through two layers. Measured on the H100: loss
# 9.3e-6 relative; layer 0's attention 3.8e-3 relative RMS, 0.56 of the
# element bound; logits 1.15e-2 relative RMS, largest error 0.064; grads
# up to 1.6e-2 relative RMS and 1.7e-2 of the leaf's largest grad. The
# bounds sit 2.5x or more above those.
MODEL_LOSS_RTOL = 1e-4
ATTENTION_TOL = {"rtol": 2 ** -5, "atol": 1e-2, "rms_tol": 1e-2}  # layer 0
LOGITS_TOL = {"rtol": 2 ** -5, "atol": 0.16, "rms_tol": 3e-2}
MODEL_GRAD_REL_TOL = 5e-2  # of the largest |plain| grad of each leaf
MODEL_GRAD_RMS_TOL = 4e-2  # ||flash - plain|| / ||plain|| of each leaf

def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def compare(got: torch.Tensor, want: torch.Tensor, tol: dict) -> dict:
    """Each element within ``atol + rtol * |want|`` of ``want``, and the
    whole tensor within ``rms_tol`` relative RMS error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    over = (err / (tol["atol"] + tol["rtol"] * want.abs())).max().item()
    rms = (err.norm() / want.norm()).item()
    return {"max_abs_err": err.max().item(), "max_err_over_bound": over,
            "rel_rms": rms, **tol, "ok": over <= 1 and rms <= tol["rms_tol"]}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_config(llama):
    """``bench.py``'s model (bench.py:50-54)."""
    return dataclasses.replace(
        llama.LlamaConfig(), vocab_size=32000, hidden_size=1024,
        intermediate_size=2816, num_layers=24, num_heads=16, num_kv_heads=8,
        head_dim=64, max_seq_len=2048, attention="flash", remat_policy="dots")


def phase_device() -> tuple[dict, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    require(torch.cuda.device_count() >= 1 and smi, "no CUDA card")
    print(smi[0], flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", **device, nvidia_smi=smi[0], torch=torch.__version__,
         cuda=torch.version.cuda)
    return device, smi[0]


def _ptxas_report(log: str) -> dict:
    """Registers, spills and static shared memory per kernel (D=64)."""
    report, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = next((k for k in KERNELS if re.search(
                rf"{k}_kernelILi64E", entry.group(1))), None)
            continue
        props = re.search(r"Function properties for (\S+)", line)
        if props:
            current = next((k for k in KERNELS if re.search(
                rf"{k}_kernelILi64E", props.group(1))), None)
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            report.setdefault(current, {}).update(
                spill_store_bytes=int(spill.group(1)),
                spill_load_bytes=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            report.setdefault(current, {}).update(
                registers=int(used.group(1)),
                static_smem_bytes=int(smem.group(1)) if smem else 0)
    return report


def phase_build(build, fa) -> None:
    start = time.perf_counter()
    info = build.build("flash_attention")
    report = _ptxas_report(info["ptxas"])
    for kind in KERNELS:
        require(kind in report and "registers" in report[kind],
                f"no ptxas report for the {kind} kernel")
        report[kind]["dynamic_smem_bytes"] = fa.smem_bytes(kind, 64)
    emit("build", source=SOURCE, nvcc_s=round(info["seconds"], 3),
         wall_s=round(time.perf_counter() - start, 3),
         kernels_d64=report)


def _inputs(b, l, h, kvh, d, seed):
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return (randn(b, l, h, d), randn(b, l, kvh, d), randn(b, l, kvh, d),
            randn(b, l, h, d))


def _bound(kind, b, l, h, kvh, d, causal) -> tuple[float, str]:
    """Least time for the work: tensor-core operations at the bf16 peak,
    or each input read once and each output written once at the memory
    rate, whichever is larger."""
    pairs = l * (l + 1) // 2 if causal else l * l
    products = {"fwd": 2, "bwd_dq": 3, "bwd_dkv": 4}[kind]
    flops = 2 * products * d * pairs * b * h
    q_bytes, kv_bytes, lse_bytes = 2 * b * l * h * d, 2 * b * l * kvh * d, \
        4 * b * h * l
    if kind == "fwd":
        moved = 2 * q_bytes + 2 * kv_bytes + lse_bytes
    elif kind == "bwd_dq":
        moved = 4 * q_bytes + 2 * kv_bytes + lse_bytes
    else:
        moved = 3 * q_bytes + 4 * kv_bytes + lse_bytes
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, moved / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernels(fa) -> dict:
    """Each kernel against its plain version; times at the slice shapes."""
    cases = {
        "slice": (8, 2048, 16, 8, 64, True),
        "mha": (2, 1024, 16, 16, 64, True),
        "tail_L200_noncausal": (2, 200, 16, 8, 64, False),
    }
    results = {}
    for name, (b, l, h, kvh, d, causal) in cases.items():
        q, k, v, do = _inputs(b, l, h, kvh, d, seed=len(results))
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
        o, lse = fa.flash_fwd_kernel(q, k, v, causal)
        dq = fa.flash_bwd_dq_kernel(q, k, v, o_ref, lse_ref, do, causal)
        dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, o_ref, lse_ref, do, causal)
        ref = fa.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, causal)
        torch.cuda.synchronize()
        case = {"lse": compare(lse, lse_ref, LSE_TOL)}
        for out, (got, want) in {"o": (o, o_ref), "dq": (dq, ref[0]),
                                 "dk": (dk, ref[1]),
                                 "dv": (dv, ref[2])}.items():
            case[out] = compare(got, want, TOLERANCES[out])
        results[name] = {"shape": [b, l, h, kvh, d], "causal": causal,
                         "outputs": case,
                         "ok": all(c["ok"] for c in case.values())}
        if name == "slice":
            dropped = _dropped_tile(fa, q, k, v, o_ref, causal)
            times = _time_slice(fa, q, k, v, o_ref, lse_ref, do, causal)
        del q, k, v, do, o_ref, lse_ref, o, lse, dq, dk, dv, ref
        torch.cuda.empty_cache()
    for kind in KERNELS:
        bound_ms, bound_by = _bound(kind, *cases["slice"])
        times[kind].update(bound_ms=bound_ms, bound_by=bound_by)
    emit("kernels", cases=results, times_ms=times,
         dropped_tile_check=dropped)
    bad = [name for name, r in results.items() if not r["ok"]]
    require(not bad, f"kernels disagree with their plain versions in {bad}")
    require(not dropped["ok"], "the tolerance passes an output that lost a "
                               "middle key tile")
    slice_outputs = results["slice"]["outputs"]
    rows = {}
    for kind, (tpu_kernel, replaces) in KERNELS.items():
        # The worst of the kernel's outputs on the slice.
        outs = [slice_outputs[out] for out in KERNEL_OUTPUTS[kind]]
        rows[kind] = {
            "name": kind, "route": "cuda", "source": SOURCE,
            "replaces": f"{replaces} ({tpu_kernel})",
            "max_abs_err": max(c["max_abs_err"] for c in outs),
            "max_err_over_bound": max(c["max_err_over_bound"] for c in outs),
            "rel_rms": max(c["rel_rms"] for c in outs),
            "tolerance": {out: TOLERANCES[out]
                          for out in KERNEL_OUTPUTS[kind]},
            "ms": times[kind]["kernel_ms"], **{
                key: times[kind][key] for key in (
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_call")},
        }
    return rows


def _dropped_tile(fa, q, k, v, o_ref, causal) -> dict:
    """The tolerance must fail a kernel that loses part of its sum: here
    the plain forward with the p.V terms of keys 1024-1087 (one middle key
    tile) left out, held to the same bound as the kernel's o."""
    v_cut = v.clone()
    v_cut[:, 1024:1088] = 0
    return compare(fa.flash_fwd_plain(q, k, v_cut, causal)[0], o_ref, O_TOL)


def _time_slice(fa, q, k, v, o, lse, do, causal) -> dict:
    """Kernel, plain and library times at the slice shapes. The library
    yardstick is scaled_dot_product_attention (the port never calls it):
    its forward for ``fwd``, its backward (dq, dk and dv together) for
    both backward kernels."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    table = {
        "fwd": {
            "kernel_ms": cuda_ms(lambda: fa.flash_fwd_kernel(q, k, v, causal),
                                 20),
            "plain_ms": cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, causal),
                                3, warmup=1),
            "library_ms": cuda_ms(lambda: sdpa(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20),
            "library_call": "scaled_dot_product_attention forward",
        },
        "bwd_dq": {
            "kernel_ms": cuda_ms(lambda: fa.flash_bwd_dq_kernel(
                q, k, v, o, lse, do, causal), 20),
        },
        "bwd_dkv": {
            "kernel_ms": cuda_ms(lambda: fa.flash_bwd_dkv_kernel(
                q, k, v, o, lse, do, causal), 20),
        },
    }
    plain_bwd = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do,
                                                   causal), 3, warmup=1)
    library_bwd = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
    for kind in ("bwd_dq", "bwd_dkv"):
        # One plain function computes dq, dk and dv together.
        table[kind].update(plain_ms=plain_bwd, library_ms=library_bwd,
                           library_call="scaled_dot_product_attention "
                                        "backward (dq, dk, dv together)")
    return table


def _leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """Dotted key paths in the order of ``tree_leaves``."""
    if isinstance(tree, dict):
        return [name for key in sorted(tree)
                for name in _leaf_names(tree[key], f"{prefix}{key}.")]
    return [prefix[:-1]]


def _model_run(llama, params, tokens, targets, config):
    """Logits, loss and every param grad (in ``tree_leaves`` order)."""
    from ray_tpu_torch._private.tree import tree_leaves

    logits = llama.forward(params, tokens, config)
    loss = llama.cross_entropy(logits, targets)
    return logits.detach(), loss.item(), torch.autograd.grad(
        loss, tree_leaves(params))


@torch.no_grad()
def _layer0_attention(llama, params, tokens, config) -> dict:
    """Layer 0's attention on the model's own q, k and v (bf16, rope
    applied), through the flash kernels and through plain attention with
    the kv heads repeated."""
    from ray_tpu_torch.ops import flash_attention
    from ray_tpu_torch.parallel.ring_attention import plain_attention

    dtype, reps = config.dtype, config.num_heads // config.num_kv_heads
    layer = {name: w[0] for name, w in params["layers"].items()}
    x = params["embed"]["tokens"].to(dtype)[tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(
        tokens.shape)
    normed = llama.rms_norm(x, layer["attn_norm"], config.rms_norm_eps)
    q, k = (llama.rope(llama._proj(normed, layer[w], dtype), positions,
                       config.rope_theta) for w in ("wq", "wk"))
    v = llama._proj(normed, layer["wv"], dtype)
    flash = flash_attention(q, k, v, causal=True)
    plain = plain_attention(q, k.repeat_interleave(reps, dim=2),
                            v.repeat_interleave(reps, dim=2), causal=True)
    return compare(flash, plain, ATTENTION_TOL)


def phase_model(llama) -> None:
    """2 layers at bench widths, B=1, L=256: flash against plain on the
    same bf16 weights and tokens, remat "dots" as in the slice."""
    from ray_tpu_torch._private.tree import tree_leaves

    config = dataclasses.replace(bench_config(llama), num_layers=2)
    params = llama.init_params(config, torch.Generator("cuda").manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator("cuda").manual_seed(1)
    toks = torch.randint(0, config.vocab_size, (1, 257), generator=gen,
                         device="cuda")
    tokens, targets = toks[:, :-1], toks[:, 1:]
    attention = _layer0_attention(llama, params, tokens, config)
    flash_logits, flash_loss, flash_grads = _model_run(
        llama, params, tokens, targets, config)
    plain_logits, plain_loss, plain_grads = _model_run(
        llama, params, tokens, targets,
        dataclasses.replace(config, attention="plain"))
    logits = compare(flash_logits, plain_logits, LOGITS_TOL)
    grads = {}
    for name, a, b in zip(_leaf_names(params), flash_grads, plain_grads):
        grads[name] = {
            "max_err_over_max": ((a - b).abs().max() / b.abs().max()).item(),
            "rel_rms": ((a - b).norm() / b.norm()).item()}
    loss_rel = abs(flash_loss - plain_loss) / abs(plain_loss)
    emit("model_check", layers=2, batch=[1, 256], flash_loss=flash_loss,
         plain_loss=plain_loss, loss_rel_err=loss_rel,
         loss_rtol=MODEL_LOSS_RTOL, layer0_attention=attention,
         logits=logits, grads=grads,
         grad_tol={"max_err_over_max": MODEL_GRAD_REL_TOL,
                   "rel_rms": MODEL_GRAD_RMS_TOL})
    require(math.isfinite(flash_loss) and loss_rel <= MODEL_LOSS_RTOL,
            f"flash loss {flash_loss} vs plain {plain_loss}")
    require(attention["ok"], "layer 0 flash attention disagrees with plain")
    require(logits["ok"], "flash logits disagree with plain logits")
    bad = {n: e for n, e in grads.items()
           if not (e["max_err_over_max"] <= MODEL_GRAD_REL_TOL
                   and e["rel_rms"] <= MODEL_GRAD_RMS_TOL)}
    require(not bad, f"flash grads disagree with plain grads: {bad}")


def phase_train(llama, train_step, fa, device: dict,
                power: str) -> dict:
    """The slice: bench.py's model and batch through the port's entry
    points, 2 warm-up and 5 timed steps."""
    config = bench_config(llama)
    batch_size, seq_len, warmup, timed = 8, 2048, 2, 5
    params = llama.init_params(config, torch.Generator("cuda").manual_seed(0))
    optimizer = train_step.default_optimizer(
        learning_rate=3e-4, warmup_steps=10, total_steps=1000)
    state = train_step.create_train_state(params, optimizer)
    del params

    def loss(params, batch):
        return llama.loss_fn(params, batch["tokens"], batch["targets"],
                             config)

    step = train_step.build_train_step(loss, optimizer)
    tokens = torch.randint(0, config.vocab_size, (batch_size, seq_len + 1),
                           generator=torch.Generator("cuda").manual_seed(1),
                           device="cuda")
    batch = train_step.place_batch(
        {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kind in fa.launches:
        fa.launches[kind] = 0
    losses, norms, times = [], [], []
    for _ in range(warmup + timed):
        start = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    launches = dict(fa.launches)
    step_s = statistics.median(times[warmup:])
    tokens_per_step = batch_size * seq_len
    flops = llama.flops_per_token(config, seq_len) * tokens_per_step
    result = {
        "config": "bench.py:50-54", "params": config.num_params,
        "batch": [batch_size, seq_len], "steps": warmup + timed,
        "step_s": times[warmup:], "step_s_median": step_s,
        "tokens_per_s": tokens_per_step / step_s,
        "mfu": flops / step_s / PEAK_BF16_FLOPS,
        "mfu_peak": "989 TFLOP/s bf16 dense (H100 SXM data sheet)",
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "loss": losses, "grad_norm": norms, "launches": launches,
        "launches_per_step": {k: n / (warmup + timed)
                              for k, n in launches.items()},
        "card": device["kind"], "nvidia_smi": power,
    }
    emit("train", **result)
    require(all(math.isfinite(x) for x in losses + norms),
            "non-finite loss or grad norm")
    ln_vocab = math.log(config.vocab_size)
    require(0.5 * ln_vocab < losses[0] < 2.5 * ln_vocab,
            f"initial loss {losses[0]} is far from ln(vocab) = {ln_vocab}")
    missing = [k for k, n in launches.items() if n == 0]
    require(not missing, f"kernels not launched in the train phase: {missing}")
    emit("profile", **_profile_step(step, state, batch, step_s))
    return launches


def _kernel_class(name: str) -> str:
    if re.search(r"(fwd|bwd_dq|bwd_dkv)_kernel", name):
        return "flash_attention"
    lowered = name.lower()
    for cls, marks in (("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                       ("reduction", ("reduce",)),
                       ("index_scatter_gather", ("index", "scatter",
                                                 "gather")),
                       ("elementwise", ("elementwise",))):
        if any(mark in lowered for mark in marks):
            return cls
    return "other"


def _profile_step(step, state, batch, step_s: float) -> dict:
    """One more step under torch.profiler: device busy time (the union of
    kernel intervals), its share of the unprofiled median step, and device
    time by kernel class and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    spans, by_class, by_name = [], {}, {}
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        begin, end = event.time_range.start, event.time_range.end
        spans.append((begin, end))
        cls = _kernel_class(event.name)
        by_class[cls] = by_class.get(cls, 0.0) + (end - begin) / 1e3
        count, total = by_name.get(event.name, (0, 0.0))
        by_name[event.name] = (count + 1, total + (end - begin) / 1e3)
    if not spans:
        return {"device_time": "not measured (no device events traced)"}
    busy, cur_start, cur_end = 0.0, None, None
    for begin, end in sorted(spans):
        if cur_end is None or begin > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = begin, end
        else:
            cur_end = max(cur_end, end)
    busy_ms = (busy + cur_end - cur_start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "profiled_step_wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_events": len(spans),
        "busy_share_of_median_step": busy_ms / (step_s * 1e3),
        "device_ms_by_class": by_class,
        "top_kernels": [{"name": name[:120], "count": c, "ms": t}
                        for name, (c, t) in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import importlib

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import train_step

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    device, power = phase_device()
    phase_build(_build, fa)
    rows = phase_kernels(fa)
    phase_model(llama)
    launches = phase_train(llama, train_step, fa, device, power)
    for kind, row in rows.items():
        row["launches"] = launches[kind]
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
