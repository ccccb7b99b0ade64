#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card (an H100 is what the
bounds below are taken against):

    python3 chip_smoke.py

It builds the CUDA kernels from ``ray_tpu_torch/ops/csrc/`` (one nvcc per
source, all started together) and drives the port's two paths:

- training: holds each flash-attention kernel (and the delta pre-pass
  that both backward kernels read) against its plain PyTorch version at
  the training shapes, times the whole backward beside SDPA's, checks
  the flash model against the plain one, then trains
  ``bench.py``'s Llama (~349M parameters, 24 layers, GQA 16/8, head dim
  64, flash attention, "dots" remat, bf16 compute with f32 master
  weights) for 2 warm-up and 5 timed steps at batch 8 x 2048;
- the mesh path: the same steps through bench.py's own path (a
  ``DeviceMesh`` of one rank on NCCL, the params as DTensors placed per
  ``param_logical_axes``, the batch by ``shard_batch``, the flash kernels
  through ``flash_attention_gspmd``), held against the train phase's
  losses and grad norms (mesh_train); then ring and Ulysses attention at
  [8, 2048, 16, 64] against plain attention (f32) and the fwd kernel
  (bf16), and bench.py's model with ``attention="ring"`` against
  ``"plain"`` (ring_check);
- MoE, the pipeline and the chunked loss: bench.py's model as a top-1
  MoE of 8 experts (1.8B parameters, 349M active) through the mesh path,
  its first 2 steps against the same steps on plain tensors
  (moe_train); the dense model through ``llama_pipeline_forward`` (1
  stage, 2 microbatches) against train, with one microbatch bitwise
  train's and the plain model's own microbatched drift beside
  (pipeline_train); ``ce_chunk=256`` against the full logits
  (ce_chunk_check);
- the collective API and Train: four thread actors on a quarter of the
  card each run every op of ``util/collective`` on [4096, 4096] f32 and
  bf16 tensors on the card, bitwise against the same ops on the CPU;
  ``util/collective/nccl.py``'s helpers and primitives on NCCL at a
  world of one; ``TorchTrainer`` with two workers on half the card each,
  its replicas bitwise equal after every step (collective_check); then
  bench.py's mesh path as ``MeshTrainer``'s train loop (one worker on the
  card's ``GPU``, ``train.get_mesh()``): 7 steps with the TrainState
  checkpointed at steps 1, 3 and 5 (two kept), failing after step 3 and
  resuming from its checkpoint, held against mesh_train and bitwise it
  on steps 4-6 (trainer);
- the data package: bench.py's batches (a seeded int32 token array in a
  ``ray_tpu_torch.data`` Dataset of 4 blocks, split into tokens and
  targets by ``map_batches``) fed through ``iter_device_batches``, 7
  steps bitwise the same batches placed in memory, each fed batch
  bitwise its rows, with the wait in ``next()``, the peak memory and
  whether the feed's copies overlap two profiled steps' kernels; then
  ``MeshTrainer`` with ``datasets=``, its loop fed through the mesh,
  bitwise the mesh step on the same batches placed by ``shard_batch``
  (data_feed);
- serving: holds the RMSNorm kernel against its plain version at the
  serving and training shapes, takes the host cost of its launch path
  piece by piece at the decode shape, checks the paged engine's greedy
  output at Llama-3-8B widths (2 layers, f32) against full-context
  decoding, with and without preemption, then serves 16 concurrent
  ragged requests with the full Llama-3-8B (32 layers, bf16, random
  weights from a seed) through ``LLMEngine``;
- the core runtime (``ray_tpu_torch.init``, ``@remote``, actors, the
  object store): a ``num_gpus=1`` actor serves serve_check's
  configuration token for token while a ``num_gpus=1`` task of 2 train
  steps waits for the card and then matches the same steps taken in the
  main thread, and a stalled engine seals a call's deadline typed
  (runtime_check); then a ``num_gpus=1`` actor serves the serve phase's
  16 requests as 16 concurrent actor calls, on the serve phase's weights
  ``put`` into the store without a copy (runtime);
- placement groups: a ``GPU`` bundle takes the card from the node, a
  ``num_gpus=1`` task in it takes runtime_check's 2 train steps bitwise
  as the driver thread does while a plain one waits for the group's
  removal, and admission sheds a deadline-armed submit past its queue
  cap (placement_check);
- the serve control plane: serve_check's configuration as a deployment
  of 2 half-GPU replicas, answered token for token through the handle,
  streamed and over HTTP, with a deadline sealed typed through the
  router (serve_deployment_check); then the serve phase's model, weights
  and 16 requests as a one-replica deployment, streamed through the
  handle from 16 threads (serve_deployment);
- worker processes: ``init(process_workers=2)``, a pool task (no card)
  and a ``num_gpus=1`` process actor (its one card) taking CUDA tensors
  across the boundary, the actor's ``fwd`` launch bitwise the driver's,
  RMSNorm in the actor on 512 KiB inputs the driver put, argument and
  result each through the driver's native arena (and at 2 MiB, past the
  arena's cap, for contrast), bitwise the driver's launches, its crash
  and the card's memory coming back, a 2-process gloo gang
  (process_check); the trainer phase's resumed run through a gang of
  one process (NCCL world of one, the crash an exit of the process),
  held to the trainer phase (process_trainer); the runtime phase's
  serving actor as a process actor making Llama-3-8B on its own card,
  greedy outputs token for token the serve phase's (process_serve);
- the managed spill tier, lineage recovery and the memory monitor:
  bench.py's TrainState (4.18 GB in f32) copied to host memory and
  ``put`` into a store of 2 GiB, spilled to checksummed files and
  restored, its next 3 steps bitwise those of the state that never left
  the card, which the store charges as device bytes and never spills; a
  ``fwd`` result and the RMSNorm over it, made on a virtual node's card,
  rebuilt bitwise from lineage on the head's card after the node is
  killed; a torn spill file rebuilt by re-running its task; an OOM kill
  retried on its budget and the memory watermark's shed and store
  pressure (store_recovery);
- node daemons: a head in this process and two daemons on card 0, the
  flash kernels on one and RMSNorm on the other, the flash output moved
  between them by the same-host plane (one copy out of the holder's
  shared-memory segment under a lease), a gloo train gang spread over
  both daemons and a one-process GPU gang on one training bench.py's
  Llama bitwise the train phase, 512 KiB RMSNorm inputs the driver put
  read on one daemon out of the driver's arena and normed bitwise (the
  head's KV in the native engine), a burst of tiny tasks and RMSNorm
  tasks through the driver's submit ring and batch RPCs (fused on a
  third daemon with no card), Llama-3-8B served from a remote actor
  that restarts on the survivor when its node is killed (node_cluster);
- the durable head and the node store's spill tier: a head process and
  a daemon with a 48 MiB store, the flash results spilled to its disk
  and marked in the head's directory, Llama-3-8B served from a named,
  detached actor there while the head is SIGKILLed and started again on
  its port and session dir; the in-flight request, the name, the KV, the
  job, the daemon's NodeID and the spilled results all come back, and
  the results and RMSNorm over them are bitwise the driver's launches,
  the spilled ones read back by the chunked pull and the one left in
  memory by the same-host plane (head_restart); then a second driver, a process with no card,
  resolves the named actor through the restarted head's directory and
  is served through the foreign handle token for token, and an actor on
  the daemon borrows the driver's ``fwd`` output past every handle of
  the driver and norms it bitwise (the ``cross_driver`` line).

Each phase prints one JSON line, with the seconds since the phase began
(``phase_wall_s``); a ``phase_walls`` line lists every phase's wall. The build phase gives each kernel's
registers, shared memory and spills (the Hopper kernels at every head
dim). The line before the last lists every kernel with its launches on
its path (the train phase for the attention kernels, the serve phase for
RMSNorm), through the mesh path (``mesh_launches``), through the MoE and
the pipeline (``moe_launches``, ``pipeline_launches``), through
``MeshTrainer`` (``trainer_launches``), through the data feed
(``data_launches``), through the runtime
(``runtime_launches``), through the serve deployments
(``deployment_launches``), in worker processes
(``process_launches``), through the store_recovery phase
(``store_launches``), on the node daemons (``node_launches``), in the
GPU gang on a daemon (``daemon_gang_launches``), across the head
restart (``restart_launches``) and on inputs that rode the driver's
native arena (``arena_launches``), its error
against the plain version, its times, and for the attention kernels the
achieved TFLOP/s and share of the bound, then the whole backward
(pre-pass, dq and dk/dv) against SDPA's; the last line is ``{"ok": true,
"device": {...}}``. Any failure exits nonzero, and without a card the
script fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

DEVICE = "cuda"

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# The kernels of the main paths and the TPU kernels they replace.
KERNELS = {
    "fwd": ("_fwd_kernel", "ray_tpu/ops/flash_attention.py:56"),
    "bwd_dq": ("_bwd_dq_kernel", "ray_tpu/ops/flash_attention.py:153"),
    "bwd_dkv": ("_bwd_dkv_kernel", "ray_tpu/ops/flash_attention.py:195"),
    "bwd_delta": ("the rowsum(dO * O) inside _bwd_dq_kernel and "
                  "_bwd_dkv_kernel", "ray_tpu/ops/flash_attention.py:227"),
    "rmsnorm": ("_rmsnorm_kernel", "ray_tpu/ops/fused.py:27"),
}
# The library each kernel is built into, its source, and the entry
# function(s) of its ptxas report (the flash kernels at head dim 64).
SOURCES = {"flash_attention": "ray_tpu_torch/ops/csrc/flash_attention.cu",
           "fused": "ray_tpu_torch/ops/csrc/fused.cu"}
KERNEL_LIBRARY = {"fwd": "flash_attention", "bwd_dq": "flash_attention",
                  "bwd_dkv": "flash_attention", "bwd_delta": "flash_attention",
                  "rmsnorm": "fused"}
PTXAS_ENTRY = {"fwd": r"fwd_kernelILi64E", "bwd_dq": r"bwd_dq_kernelILi64E",
               "bwd_dkv": r"bwd_dkv_kernelILi64E",
               "bwd_delta": r"bwd_delta_kernelILi64E",
               "rmsnorm": r"rmsnorm_kernel"}
# The kernels built for Hopper's wgmma/TMA path (and their pre-pass): the
# build phase reports them at every head dim.
HOPPER_KERNELS = ("fwd", "bwd_dq", "bwd_dkv", "bwd_delta")
HEAD_DIMS = (16, 32, 64, 128)
KERNEL_OUTPUTS = {"fwd": ("o",), "bwd_dq": ("dq",),
                  "bwd_dkv": ("dk", "dv"), "bwd_delta": ("delta",)}
# The port's whole backward, one row of the kernels line beside the
# kernels: the TPU function whose two kernels it replaces.
WHOLE_BACKWARD = ("_flash_bwd", "ray_tpu/ops/flash_attention.py:242")

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
# lse is f32 on both sides (|lse| < 16: an f32 step is under 2e-6).
LSE_TOL = {"rtol": 0.0, "atol": 1e-4, "rms_tol": 1e-6}
# delta is an f32 sum of D bf16 products on both sides, in other orders:
# a few f32 steps of |delta| (< 40 here).
DELTA_TOL = {"rtol": 1e-5, "atol": 1e-5, "rms_tol": 1e-6}
TOLERANCES = {"o": O_TOL, "dq": GRAD_TOL, "dk": GRAD_TOL, "dv": GRAD_TOL,
              "delta": DELTA_TOL}
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

# RMSNorm kernel against rms_norm_plain on the same inputs. Both sum the
# row's squares in f32 (in other orders; the kernel's rsqrtf and fused
# multiply-adds differ from PyTorch's in the last bits) and round one f32
# value to x's dtype once. A bf16 element then differs by at most one bf16
# step, 2^-7 of its magnitude, where the two f32 values straddle a
# rounding boundary; rare flips keep the relative RMS small. An f32
# element differs by a few f32 steps.
RMS_BF16_TOL = {"rtol": 2 ** -7, "atol": 1e-6, "rms_tol": 4e-3}
RMS_F32_TOL = {"rtol": 1e-5, "atol": 1e-6, "rms_tol": 1e-5}
RMS_EPS = 1e-5
# (rows, D, x dtype, scale dtype, row stride or None for contiguous rows):
# one decode step's norm, one prefill chunk's, the training activations,
# f32 (the exactness check), a D of 999 (rows not 16-byte aligned: one
# element at a time), a D of 1001 read as vectors with a scalar tail from
# rows 1024 apart, and every other row of a [128, 4096] tensor.
RMSNORM_CASES = {
    "decode_8x4096": (8, 4096, torch.bfloat16, torch.bfloat16, None),
    "prefill_256x4096": (256, 4096, torch.bfloat16, torch.bfloat16, None),
    "train_16384x1024": (16384, 1024, torch.bfloat16, torch.bfloat16, None),
    "f32_8x4096": (8, 4096, torch.float32, torch.float32, None),
    "f32_scale_8x4096": (8, 4096, torch.bfloat16, torch.float32, None),
    "odd_d_7x999": (7, 999, torch.bfloat16, torch.bfloat16, None),
    "tail_7x1001_stride_1024": (7, 1001, torch.bfloat16, torch.bfloat16,
                                1024),
    "strided_rows_64x4096": (64, 4096, torch.bfloat16, torch.bfloat16,
                             8192),
}

# The serving engine on Llama-3-8B widths at 2 layers in f32 against
# full-context decoding with the plain model (plain attention, plain
# norm). The two sum in other orders (paged vs dense attention, the
# kernel's row sums, matrix products of other shapes), which moves a
# logit by ~1e-5 of the logits' spread (~1); a wrong mask, position or
# block moves it by ~0.1 to 1.
SERVE_CHECK_PROMPT_LENGTHS = (5, 40, 97, 150)
SERVE_CHECK_LOGITS_TOL = {"rtol": 0.0, "atol": 5e-4, "rms_tol": 1e-4}

# What a runtime phase may leave allocated on the card once its engine is
# shut down, its actor killed and the runtime shut down: the cuBLAS
# workspaces of the threads it ran on, far below an engine's KV pool
# (2.15 GB) or serve_check's weights (5.95 GB).
MEMORY_LEFT_BYTES = 512 << 20


# The phase main() is running and when it started; each phase's wall.
_PHASE_START: list[float] = []
PHASE_WALLS: dict[str, float] = {}


def emit(phase: str, **fields) -> None:
    """A phase's JSON line, with the seconds since its phase started."""
    if _PHASE_START:
        fields.setdefault("phase_wall_s",
                          time.perf_counter() - _PHASE_START[-1])
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(phase, *args, **kwargs):
    """Run a phase function; its wall goes into PHASE_WALLS."""
    _PHASE_START.append(time.perf_counter())
    try:
        return phase(*args, **kwargs)
    finally:
        PHASE_WALLS[phase.__name__.removeprefix("phase_")] = \
            time.perf_counter() - _PHASE_START.pop()


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
    # The same-host plane's segments live in /dev/shm: a tmpfs too small
    # for a 100 MB result would fault the daemon writing it.
    dev_shm = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    emit("device", **device, nvidia_smi=smi[0], torch=torch.__version__,
         cuda=torch.version.cuda, dev_shm=dev_shm.splitlines())
    return device, smi[0]


def _ptxas_report(log: str, entries: dict) -> dict:
    """Registers, spills and static shared memory per kernel: of the entry
    function matching ``entries[kind]`` (a regex), the largest over its
    instantiations where there are several."""
    report, current = {}, None
    for line in log.splitlines():
        entry = (re.search(r"Compiling entry function '(\S+)'", line)
                 or re.search(r"Function properties for (\S+)", line))
        if entry:
            current = next((k for k, pattern in entries.items()
                            if re.search(pattern, entry.group(1))), None)
            continue
        if current is None:
            continue
        stats = report.setdefault(current, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            for key, value in (("spill_store_bytes", spill.group(1)),
                               ("spill_load_bytes", spill.group(2))):
                stats[key] = max(stats.get(key, 0), int(value))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            stats["registers"] = max(stats.get("registers", 0),
                                     int(used.group(1)))
            stats["static_smem_bytes"] = max(
                stats.get("static_smem_bytes", 0),
                int(smem.group(1)) if smem else 0)
    return report


def _hopper_report(log: str, fa) -> dict:
    """Registers, spills and shared memory of each Hopper kernel at every
    head dim, and the compiler's warnings (setmaxnreg or wgmma
    serialisation would show here)."""
    by_dim = {}
    for kind in HOPPER_KERNELS:
        for d in HEAD_DIMS:
            pattern = PTXAS_ENTRY[kind].replace("Li64E", f"Li{d}E")
            stats = _ptxas_report(log, {kind: pattern}).get(kind, {})
            require("registers" in stats, f"no ptxas report for {kind} at "
                                          f"head dim {d}")
            stats["dynamic_smem_bytes"] = fa.smem_bytes(kind, d)
            by_dim.setdefault(kind, {})[d] = stats
    warnings = [line.strip() for line in log.splitlines()
                if "warning" in line.lower()]
    return {"by_head_dim": by_dim, "ptxas_warnings": warnings}


def phase_build(build, fa) -> None:
    """Build every source at once, one nvcc each."""
    start = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        infos = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    report = {}
    for name, info in infos.items():
        report.update(_ptxas_report(info["ptxas"], {
            k: PTXAS_ENTRY[k] for k in KERNELS if KERNEL_LIBRARY[k] == name}))
    for kind in KERNELS:
        require(kind in report and "registers" in report[kind],
                f"no ptxas report for the {kind} kernel")
        report[kind]["dynamic_smem_bytes"] = (
            fa.smem_bytes(kind, 64) if KERNEL_LIBRARY[kind] ==
            "flash_attention" else 0)
    emit("build", sources=SOURCES,
         nvcc_s={name: round(info["seconds"], 3)
                 for name, info in infos.items()},
         wall_s=round(time.perf_counter() - start, 3),
         kernels=report, flash_head_dim=64,
         hopper_kernels=_hopper_report(infos["flash_attention"]["ptxas"],
                                       fa))


def _inputs(b, l, h, kvh, d, seed):
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return (randn(b, l, h, d), randn(b, l, kvh, d), randn(b, l, kvh, d),
            randn(b, l, h, d))


def _bound(kind, b, l, h, kvh, d, causal) -> tuple[float, str, float]:
    """Least time for the work, and its operations: tensor-core operations
    at the bf16 peak (the delta pre-pass: f32 operations at the f32 peak),
    or each input read once and each output written once at the memory
    rate, whichever is larger. The whole backward ("flash_bwd") needs five
    products per (row, key) pair (S, dP, dV, dK, dQ), however its kernels
    split them."""
    q_bytes, kv_bytes, lse_bytes = 2 * b * l * h * d, 2 * b * l * kvh * d, \
        4 * b * h * l
    if kind == "bwd_delta":
        flops = 2 * b * l * h * d
        t_ops = flops / PEAK_F32_FLOPS
        moved = 2 * q_bytes + lse_bytes
    else:
        pairs = l * (l + 1) // 2 if causal else l * l
        products = {"fwd": 2, "bwd_dq": 3, "bwd_dkv": 4,
                    "flash_bwd": 5}[kind]
        flops = 2 * products * d * pairs * b * h
        t_ops = flops / PEAK_BF16_FLOPS
        # lse and delta are [B, H, L] f32 each.
        moved = {"fwd": 2 * q_bytes + 2 * kv_bytes + lse_bytes,
                 "bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * lse_bytes,
                 "bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * lse_bytes,
                 "flash_bwd": 4 * q_bytes + 4 * kv_bytes + lse_bytes}[kind]
    t_bytes = moved / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops


def phase_kernels(fa) -> dict:
    """Each kernel against its plain version; times at the slice shapes."""
    cases = {
        "slice": (8, 2048, 16, 8, 64, True),
        "mha": (2, 1024, 16, 16, 64, True),
        "tail_L200_noncausal": (2, 200, 16, 8, 64, False),
        "d128_gqa4_L1000": (2, 1000, 16, 4, 128, True),
    }
    results = {}
    for name, (b, l, h, kvh, d, causal) in cases.items():
        q, k, v, do = _inputs(b, l, h, kvh, d, seed=len(results))
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
        o, lse = fa.flash_fwd_kernel(q, k, v, causal)
        delta = fa.flash_bwd_delta_kernel(o_ref, do)
        dq = fa.flash_bwd_dq_kernel(q, k, v, lse_ref, do, delta, causal)
        dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, lse_ref, do, delta, causal)
        ref = fa.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, causal)
        delta_ref = fa.flash_bwd_delta_plain(o_ref, do)
        # The whole backward is these three launches, bit for bit.
        whole = fa.flash_bwd(q, k, v, o_ref, lse_ref, do, causal)
        torch.cuda.synchronize()
        case = {"lse": compare(lse, lse_ref, LSE_TOL)}
        for out, (got, want) in {"o": (o, o_ref), "dq": (dq, ref[0]),
                                 "dk": (dk, ref[1]), "dv": (dv, ref[2]),
                                 "delta": (delta, delta_ref)}.items():
            case[out] = compare(got, want, TOLERANCES[out])
        same = all(torch.equal(x, y) for x, y in zip(whole, (dq, dk, dv)))
        results[name] = {"shape": [b, l, h, kvh, d], "causal": causal,
                         "outputs": case, "flash_bwd_same_bits": same,
                         "ok": same and all(c["ok"] for c in case.values())}
        if name == "slice":
            dropped = _dropped_tile(fa, q, k, v, o_ref, causal)
            times = _time_slice(fa, q, k, v, o_ref, lse_ref, do, causal)
        del q, k, v, do, o_ref, lse_ref, o, lse, dq, dk, dv, ref, delta, \
            delta_ref, whole
        torch.cuda.empty_cache()
    for kind in times:
        bound_ms, bound_by, flops = _bound(kind, *cases["slice"])
        ms = times[kind]["kernel_ms"]
        times[kind].update(bound_ms=bound_ms, bound_by=bound_by,
                           bound_share=bound_ms / ms,
                           tflops=flops / (ms * 1e-3) / 1e12)
    emit("kernels", cases=results, times_ms=times,
         dropped_tile_check=dropped)
    bad = [name for name, r in results.items() if not r["ok"]]
    require(not bad, f"kernels disagree with their plain versions in {bad}")
    require(not dropped["ok"], "the tolerance passes an output that lost a "
                               "middle key tile")
    slice_outputs = results["slice"]["outputs"]
    outputs = dict(KERNEL_OUTPUTS, flash_bwd=("dq", "dk", "dv"))
    replaced = dict(KERNELS, flash_bwd=WHOLE_BACKWARD)
    rows = {}
    for kind in times:
        tpu_kernel, replaces = replaced[kind]
        # The worst of the kernel's outputs on the slice.
        outs = [slice_outputs[out] for out in outputs[kind]]
        rows[kind] = {
            "name": kind, "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": f"{replaces} ({tpu_kernel})",
            "max_abs_err": max(c["max_abs_err"] for c in outs),
            "max_err_over_bound": max(c["max_err_over_bound"] for c in outs),
            "rel_rms": max(c["rel_rms"] for c in outs),
            "tolerance": {out: TOLERANCES[out] for out in outputs[kind]},
            "ms": times[kind]["kernel_ms"], **{
                key: times[kind][key] for key in (
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_call", "tflops", "bound_share")},
        }
    rows["flash_bwd"]["launches_note"] = (
        "calls of flash_bwd in the train phase; each launched bwd_delta, "
        "bwd_dq and bwd_dkv once")
    return rows


def _dropped_tile(fa, q, k, v, o_ref, causal) -> dict:
    """The tolerance must fail a kernel that loses part of its sum: here
    the plain forward with the p.V terms of keys 1024-1087 (one middle key
    tile) left out, held to the same bound as the kernel's o."""
    v_cut = v.clone()
    v_cut[:, 1024:1088] = 0
    return compare(fa.flash_fwd_plain(q, k, v_cut, causal)[0], o_ref, O_TOL)


def _time_slice(fa, q, k, v, o, lse, do, causal) -> dict:
    """Kernel, plain and library times at the slice shapes, each kernel
    alone, and the whole backward (``flash_bwd``: the delta pre-pass, dq
    and dk/dv). The library yardstick is scaled_dot_product_attention
    (the port never calls it): its forward for ``fwd``, its backward (dq,
    dk and dv together) for the whole backward. No one PyTorch call
    computes dq alone, dk and dv alone, or f32 rowsums of bf16 products
    as [B, H, L]."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    delta = fa.flash_bwd_delta_kernel(o, do)
    plain_bwd = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do,
                                                   causal), 3, warmup=1)
    # One plain function computes dq, dk and dv together.
    plain_note = "flash_bwd_plain: dq, dk and dv together"
    return {
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
                q, k, v, lse, do, delta, causal), 20),
            "plain_ms": plain_bwd, "plain_call": plain_note,
            "library_ms": None, "library_call": None,
        },
        "bwd_dkv": {
            "kernel_ms": cuda_ms(lambda: fa.flash_bwd_dkv_kernel(
                q, k, v, lse, do, delta, causal), 20),
            "plain_ms": plain_bwd, "plain_call": plain_note,
            "library_ms": None, "library_call": None,
        },
        "bwd_delta": {
            "kernel_ms": cuda_ms(lambda: fa.flash_bwd_delta_kernel(o, do), 20),
            "plain_ms": cuda_ms(lambda: fa.flash_bwd_delta_plain(o, do), 20),
            "library_ms": None, "library_call": None,
        },
        "flash_bwd": {
            "kernel_ms": cuda_ms(lambda: fa.flash_bwd(
                q, k, v, o, lse, do, causal), 20),
            "plain_ms": plain_bwd, "plain_call": plain_note,
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), 20),
            "library_call": "scaled_dot_product_attention backward "
                            "(dq, dk, dv together)",
        },
    }


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


class _LaunchCount:
    """The kernels' launches over one stretch of the run: the counts of
    ``fa`` and of each of ``others`` set to 0 on entry and read on exit.
    The whole flash backward, the kernels line's flash_bwd row, is no
    kernel: its calls are counted where the autograd backward makes
    them."""

    def __init__(self, fa, *others):
        self.fa, self.counts = fa, {}
        self.tables = (fa.launches, *(module.launches for module in others))

    def __enter__(self):
        for table in self.tables:
            for kind in table:
                table[kind] = 0
        self.whole_bwd, self.bwd_calls = self.fa.flash_bwd, [0]

        def counted_bwd(*args, **kwargs):
            self.bwd_calls[0] += 1
            return self.whole_bwd(*args, **kwargs)

        self.fa.flash_bwd = counted_bwd
        return self

    def __exit__(self, *exc):
        self.fa.flash_bwd = self.whole_bwd
        for table in self.tables:
            self.counts.update(table)
        self.counts["flash_bwd"] = self.bwd_calls[0]
        return False


def _bench_training(llama, train_step, config=None):
    """bench.py's model (or ``config``), its params from seed 0, the
    optimizer and the step of the train phases."""
    config = config or bench_config(llama)
    params = llama.init_params(config, torch.Generator("cuda").manual_seed(0))
    optimizer = train_step.default_optimizer(
        learning_rate=3e-4, warmup_steps=10, total_steps=1000)

    def loss(params, batch):
        return llama.loss_fn(params, batch["tokens"], batch["targets"],
                             config)

    return config, params, optimizer, train_step.build_train_step(
        loss, optimizer)


def _bench_batch(config, batch_size: int, seq_len: int) -> dict:
    """bench.py's batch from seed 1: tokens and next-token targets."""
    tokens = torch.randint(0, config.vocab_size, (batch_size, seq_len + 1),
                           generator=torch.Generator("cuda").manual_seed(1),
                           device="cuda")
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _run_steps(llama, fa, config, step, state, batch, warmup: int,
               timed: int, batch_size: int, seq_len: int, device: dict,
               power: str) -> tuple[dict, dict]:
    """``warmup + timed`` steps with the kernels' launches counted: the
    phase's result (losses, grad norms, step times, tokens/s, MFU, peak
    memory) and the state after the steps."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    with _LaunchCount(fa) as count:
        for _ in range(warmup + timed):
            start = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
    launches = count.counts
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
    return result, state


def _check_train_launches(phase: str, launches: dict, layers: int,
                          steps: int, microbatches: int = 1) -> None:
    """Remat "dots" (or the pipeline's checkpointed stage) reruns the
    forward in the backward: two forward launches per layer, microbatch
    and step, one whole backward and one of each of its kernels."""
    missing = [k for k, n in launches.items() if n == 0]
    require(not missing, f"kernels not launched in the {phase} phase: "
                         f"{missing}")
    calls = layers * microbatches * steps
    expected = {"fwd": 2 * calls, "bwd_dq": calls, "bwd_dkv": calls,
                "bwd_delta": calls, "flash_bwd": calls}
    require(launches == expected, f"{phase} phase launches {launches}, "
                                  f"expected {expected}")


def phase_train(llama, train_step, fa, device: dict,
                power: str) -> dict:
    """The slice: bench.py's model and batch through the port's entry
    points, 2 warm-up and 5 timed steps. Returns the phase's result."""
    batch_size, seq_len, warmup, timed = 8, 2048, 2, 5
    config, params, optimizer, step = _bench_training(llama, train_step)
    state = train_step.create_train_state(params, optimizer)
    del params
    batch = train_step.place_batch(_bench_batch(config, batch_size, seq_len))
    result, state = _run_steps(llama, fa, config, step, state, batch, warmup,
                               timed, batch_size, seq_len, device, power)
    emit("train", **result)
    losses, norms = result["loss"], result["grad_norm"]
    require(all(math.isfinite(x) for x in losses + norms),
            "non-finite loss or grad norm")
    ln_vocab = math.log(config.vocab_size)
    require(0.5 * ln_vocab < losses[0] < 2.5 * ln_vocab,
            f"initial loss {losses[0]} is far from ln(vocab) = {ln_vocab}")
    _check_train_launches("train", result["launches"], config.num_layers,
                          warmup + timed)
    emit("profile", **_profile_step(lambda: step(state, batch),
                                    result["step_s_median"]))
    return result


# The mesh path against the train phase, on the same seed and batch:
# __graft_entry__.py:42-44's trajectory bound.
MESH_TRAIN_RTOL, MESH_TRAIN_ATOL = 2e-3, 1e-4


def phase_mesh_train(llama, train_step, fa, device: dict, power: str,
                     train: dict) -> dict:
    """bench.py's own mesh path (bench.py:67-81) at its full width: a
    mesh of one rank on NCCL (``build_mesh(MeshConfig(dp=1))``), the
    params placed per ``param_logical_axes`` as DTensors by
    ``create_train_state``, the batch by ``shard_batch``, the flash
    kernels through ``flash_attention_gspmd``; 2 warm-up and 5 timed
    steps on the train phase's seed and batch, held against its losses
    and grad norms. Returns the phase's result."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    require(not dist.is_initialized(), "a process group exists already")
    mesh = build_mesh(MeshConfig(dp=1))
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"mesh on {dist.get_backend()} over {dist.get_world_size()} "
                f"ranks, expected NCCL over 1")
        batch_size, seq_len, warmup, timed = 8, 2048, 2, 5
        config, params, optimizer, step = _bench_training(llama, train_step)
        state = train_step.create_train_state(
            params, optimizer, mesh, llama.param_logical_axes(config))
        del params

        def placed(state) -> bool:
            return all(isinstance(p, DTensor) and p.device_mesh is mesh
                       for p in tree_leaves(state.params)
                       + tree_leaves(state.opt_state["mu"]))

        require(placed(state), "params are not DTensors on the mesh")
        batch = train_step.shard_batch(
            _bench_batch(config, batch_size, seq_len), mesh)
        require(all(isinstance(t, DTensor) for t in batch.values()),
                "the batch is not DTensors")
        result, state = _run_steps(llama, fa, config, step, state, batch,
                                   warmup, timed, batch_size, seq_len,
                                   device, power)
        require(placed(state), "params left the mesh during the steps")
        got = np.array([result["loss"], result["grad_norm"]])
        want = np.array([train["loss"], train["grad_norm"]])
        diff = np.abs(got - want)
        ok = bool(np.all(diff <= MESH_TRAIN_ATOL
                         + MESH_TRAIN_RTOL * np.abs(want)))
        placements = {name: str(list(p.placements)) for name, p in zip(
            _leaf_names(state.params), tree_leaves(state.params))}
        result.update(
            mesh={"dim_names": list(mesh.mesh_dim_names),
                  "shape": list(mesh.shape), "backend": "nccl",
                  "world_size": 1},
            param_placements=placements,
            against_train={
                "max_abs_loss_diff": float(diff[0].max()),
                "max_abs_grad_norm_diff": float(diff[1].max()),
                "bitwise": bool(np.array_equal(got, want)),
                "rtol": MESH_TRAIN_RTOL, "atol": MESH_TRAIN_ATOL, "ok": ok,
                "train_step_s_median": train["step_s_median"],
                "train_tokens_per_s": train["tokens_per_s"],
                "train_mfu": train["mfu"],
                "train_peak_memory_bytes": train["peak_memory_bytes"]})
        emit("mesh_train", **result)
        require(ok, f"mesh path losses/grad norms {got.tolist()} disagree "
                    f"with the train phase's {want.tolist()}")
        _check_train_launches("mesh_train", result["launches"],
                              config.num_layers, warmup + timed)
        emit("mesh_profile", **_profile_step(lambda: step(state, batch),
                                             result["step_s_median"]))
        del state, batch
        return result
    finally:
        dist.destroy_process_group()


# Ring and Ulysses attention at bench.py's attention shape in a world of
# one. At f32 against plain attention: tests/test_parallel.py:88-89's
# bound. At bf16 against the fwd kernel: the ring rounds its scores,
# probabilities and row sums to bf16, and Ulysses (plain attention on
# its heads) its scores and probabilities, as the reference's bf16
# einsums do, where the kernel keeps them in f32. A score s rounded to
# bf16 moves by up to 2^-9 |s| (|s| < 6 at this shape), which moves its
# probability by up to ~1%; the first causal rows attend to a few keys,
# so that change reaches their outputs unaveraged: ~1% of |v| (< 4.5),
# up to ~4e-2. Elsewhere the roundings average out: the whole tensor
# stays within phase_model's relative RMS bound for plain attention
# against the kernels (ATTENTION_TOL's 1e-2). A wrong mask or a lost
# block moves the RMS by 1e-1 or more. Measured on the CPU at
# [1, 2048, 2, 64] before the first card run: relative RMS 5.1e-3 and
# 6.2e-3 (ring, causal and full), 4.2e-3 and 5.0e-3 (plain), above
# phase_kernels' O_TOL (5e-3, which holds a kernel against a plain
# version with its own roundings).
RING_F32_TOL = {"rtol": 2e-5, "atol": 2e-5, "rms_tol": 2e-5}
RING_BF16_TOL = {"rtol": 2 ** -5, "atol": 4e-2, "rms_tol": 1e-2}
# The model with attention="ring" against "plain", f32 (test_llama.py:
# 110-111).
RING_LOGITS_TOL = {"rtol": 3e-2, "atol": 3e-2, "rms_tol": 3e-2}


def phase_ring_check(llama, fa) -> dict:
    """ring_attention_sharded and ulysses_attention (inside local_map) on
    a mesh of one rank at [8, 2048, 16, 64], causal and full: f32 against
    plain_attention, bf16 against the fwd kernel; then a no_grad forward
    of bench.py's model (f32) with attention="ring", its params placed on
    the mesh, against attention="plain"."""
    import functools

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.ring_attention import (
        RING_SPEC,
        plain_attention,
        ring_attention_sharded,
        ulysses_attention,
    )
    from ray_tpu_torch.parallel.sharding import placements, shard_params

    require(not dist.is_initialized(), "a process group exists already")
    mesh = build_mesh(MeshConfig(dp=1))
    try:
        b, l, h, d = 8, 2048, 16, 64
        gen = torch.Generator("cuda").manual_seed(5)
        qkv32 = [torch.randn((b, l, h, d), generator=gen, device="cuda")
                 for _ in range(3)]
        where = placements(mesh, RING_SPEC)
        checks = {}
        for dtype, tol in ((torch.float32, RING_F32_TOL),
                           (torch.bfloat16, RING_BF16_TOL)):
            q, k, v = (x.to(dtype) for x in qkv32)
            for causal in (True, False):
                if dtype == torch.float32:
                    want = plain_attention(q, k, v, causal=causal)
                else:
                    want = fa.flash_fwd_kernel(q, k, v, causal)[0]
                ring = ring_attention_sharded(q, k, v, mesh, causal=causal)
                ulysses = local_map(
                    functools.partial(ulysses_attention, axis_name="sp",
                                      causal=causal, mesh=mesh),
                    out_placements=where, in_placements=(where,) * 3,
                    device_mesh=mesh)(*(distribute_tensor(x, mesh, where)
                                        for x in (q, k, v))).full_tensor()
                key = f"{str(dtype)[6:]}_{'causal' if causal else 'full'}"
                checks[f"ring_{key}"] = compare(ring, want, tol)
                checks[f"ulysses_{key}"] = compare(ulysses, want, tol)
                del want, ring, ulysses
            del q, k, v
        del qkv32
        torch.cuda.empty_cache()

        config = dataclasses.replace(bench_config(llama), dtype=torch.float32)
        params = llama.init_params(config,
                                   torch.Generator("cuda").manual_seed(0))
        tokens = _bench_batch(config, 8, 2048)["tokens"]
        with torch.no_grad():
            plain = llama.forward(params, tokens, dataclasses.replace(
                config, attention="plain"))
            ring = llama.forward(
                shard_params(params, mesh, llama.param_logical_axes(config)),
                tokens, dataclasses.replace(config, attention="ring"))
            ring = ring.full_tensor()
        checks["model_ring_logits_f32"] = compare(ring, plain,
                                                  RING_LOGITS_TOL)
        del params, plain, ring
        torch.cuda.empty_cache()
        emit("ring_check", shape=[b, l, h, d], world_size=1,
             mesh=list(mesh.mesh_dim_names), checks=checks)
        bad = [name for name, c in checks.items() if not c["ok"]]
        require(not bad, f"ring/Ulysses checks failed: {bad}")
        return checks
    finally:
        dist.destroy_process_group()


# bench.py's model as a top-1 MoE of 8 experts (Switch Transformer's
# capacity factor 1.25 and aux coefficient 0.01, the reference's
# defaults): the mesh path's first 2 steps against the same steps on
# plain tensors. Top-1 routing is discrete, so a token whose two best
# experts are near a tie may go the other way on the other path:
# __graft_entry__.py:289 and :333's MoE bound.
MOE_EXPERTS = 8
MOE_TRAIN_RTOL = 2e-2


def moe_config(llama):
    return dataclasses.replace(bench_config(llama), num_experts=MOE_EXPERTS)


@torch.no_grad()
def _layer0_overflow(llama, params, tokens, config) -> dict:
    """Layer 0's routing of the batch on the initial weights, from its
    own router (no hook in the model): tokens per expert and the share
    of tokens past each row's capacity, which the layer drops."""
    layer = {name: w[0] for name, w in params["layers"].items()}
    b, l = tokens.shape
    x = torch.nn.functional.embedding(
        tokens, params["embed"]["tokens"].to(config.dtype))
    positions = torch.arange(l, device=tokens.device).expand(b, l)
    x = llama._attention_block(layer, x, positions, config)
    normed = llama.rms_norm(x, layer["mlp_norm"], config.rms_norm_eps)
    expert = torch.argmax(normed.float() @ layer["w_router"].float(), dim=-1)
    counts = torch.nn.functional.one_hot(expert, config.num_experts).sum(1)
    capacity = max(1, int(config.expert_capacity_factor * l
                          / config.num_experts))
    over = (counts - capacity).clamp(min=0).sum().item()
    return {"capacity": capacity, "tokens_per_expert": counts.sum(0).tolist(),
            "over_capacity_share": over / (b * l)}


def phase_moe_train(llama, train_step, fa, device: dict, power: str,
                    train: dict) -> dict:
    """bench.py's model as a top-1 MoE of 8 experts through bench.py's
    mesh path (``build_mesh(MeshConfig(dp=1, ep=1))`` on NCCL, the params
    placed per the MoE branch of ``param_logical_axes``, ``shard_batch``),
    2 warm-up and 5 timed steps on the train phase's seeds, optimizer
    and batch; its first 2 steps against 2 steps of the same model on
    plain tensors. Returns the phase's result."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    batch_size, seq_len, warmup, timed = 8, 2048, 2, 5
    config, params, optimizer, step = _bench_training(llama, train_step,
                                                      moe_config(llama))
    host_batch = _bench_batch(config, batch_size, seq_len)
    overflow = _layer0_overflow(llama, params, host_batch["tokens"], config)
    state = train_step.create_train_state(params, optimizer)
    del params
    plain, state = _run_steps(llama, fa, config, step, state,
                              train_step.place_batch(host_batch), 0, 2,
                              batch_size, seq_len, device, power)
    del state
    torch.cuda.empty_cache()

    require(not dist.is_initialized(), "a process group exists already")
    mesh = build_mesh(MeshConfig(dp=1, ep=1))
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"mesh on {dist.get_backend()} over {dist.get_world_size()} "
                f"ranks, expected NCCL over 1")
        state = train_step.create_train_state(
            _bench_training(llama, train_step, config)[1], optimizer, mesh,
            llama.param_logical_axes(config))

        def placed(state) -> bool:
            # Equal, not the same object: DTensor's sharding propagation
            # caches an op's output spec by the mesh's value, so the AdamW
            # moments (zeros_like) may carry an earlier phase's equal mesh.
            return all(isinstance(p, DTensor) and p.device_mesh == mesh
                       for p in tree_leaves(state.params)
                       + tree_leaves(state.opt_state["mu"]))

        require(placed(state), "params are not DTensors on the mesh")
        batch = train_step.shard_batch(host_batch, mesh)
        with torch.no_grad():
            _, aux = llama.forward(state.params, batch["tokens"], config,
                                   with_aux=True)
        aux_per_layer = aux.full_tensor().item() / config.num_layers
        torch.cuda.empty_cache()
        result, state = _run_steps(llama, fa, config, step, state, batch,
                                   warmup, timed, batch_size, seq_len,
                                   device, power)
        require(placed(state), "params left the mesh during the steps")
        got = np.array([result["loss"][:2], result["grad_norm"][:2]])
        want = np.array([plain["loss"], plain["grad_norm"]])
        diff = np.abs(got - want)
        ok = bool(np.all(diff <= MOE_TRAIN_RTOL * np.abs(want)))
        result.update(
            config="bench.py:50-54 with num_experts=8 (capacity factor "
                   "1.25, aux coefficient 0.01: ray_tpu/models/llama.py:"
                   "70-72)",
            active_params=config.num_active_params,
            mesh={"dim_names": list(mesh.mesh_dim_names),
                  "shape": list(mesh.shape), "backend": "nccl",
                  "world_size": 1},
            aux_first_forward_per_layer=aux_per_layer,
            aux_range=[0.9, MOE_EXPERTS + 0.1], layer0_routing=overflow,
            against_plain={
                "plain_loss": plain["loss"],
                "plain_grad_norm": plain["grad_norm"],
                "plain_step_s": plain["step_s"],
                "max_abs_loss_diff": float(diff[0].max()),
                "max_abs_grad_norm_diff": float(diff[1].max()),
                "bitwise": bool(np.array_equal(got, want)),
                "rtol": MOE_TRAIN_RTOL, "ok": ok},
            against_train={
                "train_step_s_median": train["step_s_median"],
                "train_tokens_per_s": train["tokens_per_s"],
                "train_mfu": train["mfu"],
                "train_peak_memory_bytes": train["peak_memory_bytes"]})
        emit("moe_train", **result)
        losses, norms = result["loss"], result["grad_norm"]
        require(all(math.isfinite(x) for x in losses + norms),
                "non-finite MoE loss or grad norm")
        ln_vocab = math.log(config.vocab_size)
        require(0.5 * ln_vocab < losses[0] < 2.5 * ln_vocab,
                f"initial MoE loss {losses[0]} is far from ln(vocab) = "
                f"{ln_vocab}")
        require(0.9 <= aux_per_layer <= MOE_EXPERTS + 0.1,
                f"aux per layer {aux_per_layer} outside [0.9, E + 0.1]")
        require(ok, f"MoE mesh path's first losses/grad norms "
                    f"{got.tolist()} disagree with plain tensors' "
                    f"{want.tolist()}")
        _check_train_launches("moe_train", result["launches"],
                              config.num_layers, warmup + timed)
        emit("moe_profile", **_profile_step(lambda: step(state, batch),
                                            result["step_s_median"]))
        del state, batch
        return result
    finally:
        dist.destroy_process_group()


# The pipeline against the train phase, on the same seed and batch. One
# microbatch computes train's step exactly (the same products on the same
# rows): bitwise equal, required. Two microbatches split each weight
# gradient's sum over the batch into two bf16 products summed in f32: the
# first gradient differs from train's by that rounding (grad norm 4.3e-6
# relative on the H100), and Adam's first updates, near +-lr for every
# element whatever its size, turn it into a drift that grows while the
# grad norm climbs (1.99 to 9.74 over the 7 steps). The plain model
# stepping on the same two microbatches drifts as far
# (``microbatched_plain``, printed beside). So the losses and the grad
# norms before the first update are held to __graft_entry__.py:42-44's
# bound of the dense pp pass, and the grad norms after it to 1e-2, twice
# the plain model's microbatched drift (5.1e-3 at step 6, measured on the
# H100 before this bound was set).
PIPELINE_STAGES, PIPELINE_MICROBATCHES = 1, 2
PIPELINE_RTOL, PIPELINE_ATOL = 2e-3, 1e-4
PIPELINE_DRIFT_RTOL = 1e-2
PIPELINE_EXACT_STEPS = 2  # lr 0 at step 0: step 1 has step 0's params


def _pipeline_bounds(got: np.ndarray, want: np.ndarray) -> dict:
    """[losses, grad norms] against train's: the differences and whether
    they are within the bounds above."""
    diff = np.abs(got - want)
    rtol = np.full_like(want, PIPELINE_RTOL)
    rtol[1, PIPELINE_EXACT_STEPS:] = PIPELINE_DRIFT_RTOL
    rel = diff / np.abs(want)
    return {"max_rel_loss_diff": float(rel[0].max()),
            "max_rel_grad_norm_diff": float(rel[1].max()),
            "rel_grad_norm_diff_by_step": rel[1].tolist(),
            "bitwise": bool(np.array_equal(got, want)),
            "ok": bool(np.all(diff <= PIPELINE_ATOL + rtol * np.abs(want)))}


def _trajectory(step, state, batch, steps: int) -> np.ndarray:
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return np.array([losses, norms])


def phase_pipeline_train(llama, train_step, fa, device: dict, power: str,
                         train: dict) -> dict:
    """bench.py's dense model through ``llama_pipeline_forward`` (1
    stage, 2 microbatches) on ``build_mesh(MeshConfig(pp=1))``, a world of
    one on NCCL, the params placed per ``param_logical_axes``; the loss is
    ``cross_entropy`` of the pipeline's logits (__graft_entry__.py:
    235-248). 2 warm-up and 5 timed steps on the train phase's seed,
    batch and optimizer, held against its losses and grad norms; then
    the same 7 steps through one microbatch (bitwise train's) and by the
    plain model on the same two microbatches (its drift from train)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.pipeline import llama_pipeline_forward

    require(not dist.is_initialized(), "a process group exists already")
    mesh = build_mesh(MeshConfig(pp=1))
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"mesh on {dist.get_backend()} over {dist.get_world_size()} "
                f"ranks, expected NCCL over 1")
        batch_size, seq_len, warmup, timed = 8, 2048, 2, 5
        steps = warmup + timed
        config, params, optimizer, _ = _bench_training(llama, train_step)
        host_batch = _bench_batch(config, batch_size, seq_len)

        def pipelined(microbatches: int):
            def loss(params, batch):
                logits = llama_pipeline_forward(
                    params, batch["tokens"], config, PIPELINE_STAGES,
                    microbatches)
                return llama.cross_entropy(logits, batch["targets"])

            return train_step.build_train_step(loss, optimizer)

        def placed_state():
            return train_step.create_train_state(
                _bench_training(llama, train_step)[1], optimizer, mesh,
                llama.param_logical_axes(config))

        state = train_step.create_train_state(
            params, optimizer, mesh, llama.param_logical_axes(config))
        del params
        require(all(isinstance(p, DTensor) for p in
                    tree_leaves(state.params)),
                "params are not DTensors on the mesh")
        batch = train_step.shard_batch(host_batch, mesh)
        step = pipelined(PIPELINE_MICROBATCHES)
        result, state = _run_steps(llama, fa, config, step, state, batch,
                                   warmup, timed, batch_size, seq_len,
                                   device, power)
        del state
        torch.cuda.empty_cache()
        want = np.array([train["loss"], train["grad_norm"]])
        against = _pipeline_bounds(
            np.array([result["loss"], result["grad_norm"]]), want)

        one = _trajectory(pipelined(1), placed_state(), batch, steps)
        torch.cuda.empty_cache()

        def microbatched(params, batch):
            # The plain model on the pipeline's two microbatches: the
            # same split of every product over the batch.
            features = [llama.forward(params, tokens, config,
                                      return_features=True)
                        for tokens in batch["tokens"].chunk(
                            PIPELINE_MICROBATCHES)]
            logits = llama._lm_head(torch.cat(features),
                                    params["lm_head"].to(config.dtype))
            return llama.cross_entropy(logits, batch["targets"])

        plain = _trajectory(
            train_step.build_train_step(microbatched, optimizer),
            train_step.create_train_state(
                _bench_training(llama, train_step)[1], optimizer),
            train_step.place_batch(host_batch), steps)
        torch.cuda.empty_cache()
        result.update(
            stages=PIPELINE_STAGES, microbatches=PIPELINE_MICROBATCHES,
            mesh={"dim_names": list(mesh.mesh_dim_names),
                  "shape": list(mesh.shape), "backend": "nccl",
                  "world_size": 1},
            against_train={
                **against, "rtol": PIPELINE_RTOL, "atol": PIPELINE_ATOL,
                "grad_norm_rtol_after_step": [PIPELINE_EXACT_STEPS,
                                              PIPELINE_DRIFT_RTOL],
                "train_step_s_median": train["step_s_median"],
                "train_tokens_per_s": train["tokens_per_s"],
                "train_mfu": train["mfu"],
                "train_peak_memory_bytes": train["peak_memory_bytes"]},
            one_microbatch={"loss": one[0].tolist(),
                            "grad_norm": one[1].tolist(),
                            "bitwise_train": bool(np.array_equal(one, want))},
            microbatched_plain={"loss": plain[0].tolist(),
                                "grad_norm": plain[1].tolist(),
                                **_pipeline_bounds(plain, want)})
        emit("pipeline_train", **result)
        require(result["one_microbatch"]["bitwise_train"],
                "the pipeline at one microbatch is not bitwise train's step")
        require(result["microbatched_plain"]["ok"],
                "the plain model's microbatched drift exceeds the bound")
        require(against["ok"], f"pipeline losses/grad norms "
                               f"{[result['loss'], result['grad_norm']]} "
                               f"disagree with the train phase's "
                               f"{want.tolist()}")
        # Each stage is checkpointed whole: each microbatch reruns its
        # forward in the backward.
        _check_train_launches("pipeline_train", result["launches"],
                              config.num_layers, steps,
                              PIPELINE_MICROBATCHES)
        del batch
        return result
    finally:
        dist.destroy_process_group()


# The chunked loss against the full-logits loss, one forward and backward
# of the train phase's model on the same weights and batch: both compute
# the same f32 logits from the same bf16 operands, chunk by chunk or at
# once, and sum the CE and the lm head's gradient in other orders.
CE_CHUNK = 256
CE_LOSS_RTOL, CE_GRAD_NORM_RTOL = 1e-3, 2e-3


def phase_ce_chunk_check(llama, train_step) -> dict:
    """``loss_fn`` with ``ce_chunk=256`` against ``ce_chunk=0`` at
    bench.py's width and batch: losses, the gradients' global norms and
    each run's peak memory."""
    from ray_tpu_torch._private.tree import tree_leaves

    config, params, _, _ = _bench_training(llama, train_step)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = _bench_batch(config, 8, 2048)
    runs = {}
    for chunk in (0, CE_CHUNK):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = llama.loss_fn(params, batch["tokens"], batch["targets"],
                             dataclasses.replace(config, ce_chunk=chunk))
        grads = torch.autograd.grad(loss, leaves)
        norm = train_step.global_norm(grads).item()
        torch.cuda.synchronize()
        runs[chunk] = {"loss": loss.item(), "grad_norm": norm,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del loss, grads
        torch.cuda.empty_cache()
    full, chunked = runs[0], runs[CE_CHUNK]
    loss_rel = abs(chunked["loss"] - full["loss"]) / abs(full["loss"])
    norm_rel = (abs(chunked["grad_norm"] - full["grad_norm"])
                / abs(full["grad_norm"]))
    result = {"ce_chunk": CE_CHUNK, "batch": [8, 2048], "full": full,
              "chunked": chunked, "loss_rel_diff": loss_rel,
              "grad_norm_rel_diff": norm_rel, "loss_rtol": CE_LOSS_RTOL,
              "grad_norm_rtol": CE_GRAD_NORM_RTOL,
              "f32_logits_bytes": 8 * 2048 * config.vocab_size * 4}
    emit("ce_chunk_check", **result)
    require(loss_rel <= CE_LOSS_RTOL,
            f"chunked loss {chunked['loss']} vs full {full['loss']}")
    require(norm_rel <= CE_GRAD_NORM_RTOL,
            f"chunked grad norm {chunked['grad_norm']} vs full "
            f"{full['grad_norm']}")
    return result


# collective_check (a): four thread actors on a quarter of the card each
# run every op of util/collective on integer-valued [4096, 4096] tensors,
# on the card and then on the CPU: the store adds, multiplies and
# compares in arrival order, and on these values every order gives the
# same bits, so each card result must equal its CPU twin bit for bit.
COLLECTIVE_WORLD = 4
COLLECTIVE_SHAPE = (4096, 4096)
COLLECTIVE_TIMED = 5  # allreduces timed on rank 0, after one warm-up
# collective_check (c): two TorchTrainer workers on half the card each;
# their hooks wait for each other, so run on the card's one shared
# autograd thread they would hang until the store's timeout.
DDP_STEPS, DDP_DEADLINE_S = 5, 120.0


class CollectiveRank:
    """One rank of collective_check's store group."""

    def __init__(self, rank: int, world: int, group: str):
        from ray_tpu_torch.util import collective

        self.rank, self.world, self.group = rank, world, group
        collective.init_collective_group(world, rank, group_name=group)

    def _ops(self, device: str, dtype: torch.dtype) -> dict:
        from ray_tpu_torch.util import collective as col

        gen = torch.Generator().manual_seed(self.rank)

        def ints(low, high):
            return torch.randint(low, high, COLLECTIVE_SHAPE,
                                 generator=gen).to(device, dtype)

        x = ints(-8, 9)
        # Factors of +-1 and +-2: every product of 4 is a power of two.
        factors = ints(1, 3) * (ints(0, 2) * 2 - 1)
        g, nxt = self.group, (self.rank + 1) % self.world
        out = {"allreduce_sum": col.allreduce(x, g),
               "allreduce_product": col.allreduce(factors, g,
                                                  col.ReduceOp.PRODUCT),
               "allreduce_min": col.allreduce(x, g, col.ReduceOp.MIN),
               "allreduce_max": col.allreduce(x, g, col.ReduceOp.MAX),
               "broadcast": col.broadcast(x, src_rank=2, group_name=g),
               "reducescatter": col.reducescatter(x, g)}
        for r, t in enumerate(col.allgather(x, g)):
            out[f"allgather_{r}"] = t
        col.send(x, nxt, g)
        out["recv"] = col.recv((self.rank - 1) % self.world, g)
        col.barrier(g)
        require((col.get_rank(g), col.get_world_size(g))
                == (self.rank, self.world), "rank or world size wrong")
        return out

    def check(self, dtype: torch.dtype) -> dict:
        """Every op on the card, then on the CPU: per op, whether the
        card's result is bitwise the CPU's, on the card, in ``dtype``."""
        on_card = self._ops(DEVICE, dtype)
        torch.cuda.synchronize()
        on_cpu = self._ops("cpu", dtype)
        return {name: {"bitwise": torch.equal(t.cpu(), on_cpu[name]),
                       "device": str(t.device), "dtype": str(t.dtype)[6:]}
                for name, t in on_card.items()}

    def time_allreduce(self, dtype: torch.dtype) -> list:
        """Host ms of each of COLLECTIVE_TIMED allreduces of one
        [4096, 4096] tensor on the card, its kernels synchronised."""
        from ray_tpu_torch.util import collective as col

        x = torch.ones(COLLECTIVE_SHAPE, device=DEVICE, dtype=dtype)
        col.allreduce(x, self.group)
        times = []
        for _ in range(COLLECTIVE_TIMED):
            torch.cuda.synchronize()
            start = time.perf_counter()
            col.allreduce(x, self.group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        return times


def _nccl_world_of_one() -> dict:
    """util/collective/nccl.py on NCCL at a world of one: each host
    helper and in-SPMD primitive against what a world of one gives (the
    input itself), on the card; psum's gradient."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import set_mesh
    from ray_tpu_torch.util.collective import nccl

    require(not dist.is_initialized(), "a process group exists already")
    mesh = nccl.default_mesh(device=DEVICE)
    try:
        backend = "nccl" if DEVICE == "cuda" else "gloo"
        require(dist.get_backend() == backend and dist.get_world_size() == 1,
                f"nccl.default_mesh on {dist.get_backend()}")
        x = np.random.default_rng(7).integers(-8, 9, (1, 64, 32)) \
            .astype(np.float32)
        checks = {name: bool(np.array_equal(getattr(nccl, name)(x, mesh), want))
                  for name, want in (("device_allreduce", x[0]),
                                     ("device_allgather", x),
                                     ("device_reducescatter", x),
                                     ("device_ring_shift", x))}
        t = torch.tensor(x[0], device=DEVICE)
        with set_mesh(mesh):
            results = {
                "psum": (nccl.psum(t, "x"), t),
                "pmean": (nccl.pmean(t, "x"), t),
                "pmax": (nccl.pmax(t, "x"), t),
                "pmin": (nccl.pmin(t, "x"), t),
                "all_gather": (nccl.all_gather(t, "x"), t[None]),
                "all_gather_tiled": (nccl.all_gather(t, "x", axis=1,
                                                     tiled=True), t),
                "ppermute": (nccl.ppermute(t, "x", [(0, 0)]), t),
                "all_to_all_tiled": (nccl.all_to_all(t, "x", 1, 0,
                                                     tiled=True), t)}
            checks.update({name: bool(torch.equal(got, want)
                                      and got.device.type == DEVICE)
                           for name, (got, want) in results.items()})
            checks["axis_index"] = nccl.axis_index("x") == 0
            leaf = t.clone().requires_grad_(True)
            nccl.psum(leaf, "x").sum().backward()
            checks["psum_grad"] = bool(torch.equal(leaf.grad,
                                                   torch.ones_like(t)))
        return checks
    finally:
        dist.destroy_process_group()


def _ddp_loop(config):
    """collective_check (c): per dtype, a small MLP on the card, its
    init and data different per rank, through prepare_model; 5 Adam
    steps with the gradients clipped to norm 1 between backward and the
    step, the ranks' flattened gradients gathered once clipped and their
    weights after each step (the step's time includes the first
    gather)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import _group_name, prepare_model
    from ray_tpu_torch.util import collective

    rank = train.get_context().get_world_rank()
    gen = torch.Generator(DEVICE).manual_seed(100 + rank)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = torch.nn.Sequential(
            torch.nn.Linear(256, 1024), torch.nn.GELU(),
            torch.nn.Linear(1024, 1024), torch.nn.GELU(),
            torch.nn.Linear(1024, 1)).to(DEVICE, dtype)
        with torch.no_grad():
            for p in model.parameters():
                # Weights normal with std fan_in^-1/2, biases 0.
                p.copy_(torch.randn(p.shape, generator=gen, device=DEVICE)
                        * p.shape[-1] ** -0.5 if p.ndim == 2 else 0)
        model = prepare_model(model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        x = torch.randn((512, 256), generator=gen, device=DEVICE).to(dtype)
        y = x.float().sum(1, keepdim=True).div(16).tanh().to(dtype)
        equal, grads_equal, on_card, losses, step_ms = [], [], [], [], []
        for _ in range(DDP_STEPS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            opt.zero_grad()
            loss = (model(x) - y).float().pow(2).mean()
            loss.backward()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
            # The clipped gradients, before the step: equal across ranks
            # only if clipping acted on the average in .grad.
            grads = collective.allgather(
                torch.cat([p.grad.flatten() for p in model.parameters()]),
                group_name=_group_name())
            opt.step()
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - start) * 1e3)
            grads_equal.append(all(torch.equal(g, grads[0]) for g in grads))
            flat = torch.cat([p.detach().flatten()
                              for p in model.parameters()])
            gathered = collective.allgather(flat, group_name=_group_name())
            equal.append(all(torch.equal(g, gathered[0]) for g in gathered))
            on_card.append(all(g.device.type == DEVICE and g.dtype == dtype
                               for g in gathered))
        out[str(dtype)[6:]] = {"replicas_bitwise_equal": equal,
                               "grads_bitwise_equal": grads_equal,
                               "on_card": on_card, "loss": losses,
                               "step_ms": step_ms}
    train.report(out)


def phase_collective_check(device: dict, power: str) -> dict:
    """(a) util/collective's store on cuda tensors, f32 and bf16, bitwise
    against the CPU; (b) util/collective/nccl.py on NCCL at a world of
    one; (c) TorchTrainer's DDP on the card with two thread workers."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    start = time.perf_counter()
    allocated_before = torch.cuda.memory_allocated()
    rt.init(num_cpus=8)
    try:
        ranks = [rt.remote(CollectiveRank).options(num_gpus=0.25).remote(
            r, COLLECTIVE_WORLD, "collective_check")
            for r in range(COLLECTIVE_WORLD)]
        gpu_while_ranks = rt.available_resources().get("GPU")
        store = {}
        for dtype in (torch.float32, torch.bfloat16):
            per_rank = rt.get([a.check.remote(dtype) for a in ranks],
                              timeout=300)
            store[str(dtype)[6:]] = per_rank
        allreduce_ms = {
            str(dtype)[6:]: rt.get([a.time_allreduce.remote(dtype)
                                    for a in ranks], timeout=300)[0]
            for dtype in (torch.float32, torch.bfloat16)}
        for a in ranks:
            rt.kill(a)
        gpu_after_ranks = _until(
            lambda: rt.available_resources().get("GPU") == 1.0)
        nccl_checks = _nccl_world_of_one()
        ddp_start = time.perf_counter()
        ddp = train.TorchTrainer(
            _ddp_loop, scaling_config=train.ScalingConfig(
                num_workers=2, use_gpu=True, gpus_per_worker=0.5),
            run_config=train.RunConfig(report_timeout_s=DDP_DEADLINE_S)
        ).fit()
        ddp_s = time.perf_counter() - ddp_start
        gpu_after_ddp = _until(
            lambda: rt.available_resources().get("GPU") == 1.0)
    finally:
        rt.shutdown()
    torch.cuda.empty_cache()
    bad_store = sorted({f"{dtype}:{op}" for dtype, per_rank in store.items()
                        for checks in per_rank for op, c in checks.items()
                        if not (c["bitwise"] and c["device"].startswith(
                            DEVICE) and c["dtype"] == dtype)})
    result = {
        "store": {"world": COLLECTIVE_WORLD, "shape": list(COLLECTIVE_SHAPE),
                  "actor_gpus": 0.25, "gpu_available_while_ranks_live":
                  gpu_while_ranks, "ops": sorted(store["float32"][0]),
                  "not_bitwise_or_off_card": bad_store,
                  "allreduce_ms_rank0": allreduce_ms,
                  "allreduce_ms_median": {
                      k: statistics.median(v)
                      for k, v in allreduce_ms.items()}},
        "nccl_world_of_one": nccl_checks,
        "ddp": {"workers": 2, "gpus_per_worker": 0.5, "error": repr(
            ddp.error) if ddp.error else None, "seconds": ddp_s,
                "deadline_s": DDP_DEADLINE_S, "per_dtype": ddp.metrics},
        "gpu_back": [gpu_after_ranks, gpu_after_ddp],
        "memory_allocated_before_after": [allocated_before,
                                          torch.cuda.memory_allocated()],
        "elapsed_s": time.perf_counter() - start,
        "card": device["kind"], "nvidia_smi": power,
    }
    emit("collective_check", **result)
    require(gpu_while_ranks == 0.0, f"GPU left while 4 x 0.25 held: "
                                    f"{gpu_while_ranks}")
    require(not bad_store, f"store ops not bitwise on the card: {bad_store}")
    require(all(nccl_checks.values()), f"nccl at a world of one: "
                                       f"{nccl_checks}")
    require(ddp.error is None and ddp_s < DDP_DEADLINE_S,
            f"TorchTrainer on the card: {ddp.error!r} after {ddp_s:.1f} s")
    for dtype, run in ddp.metrics.items():
        require(run["replicas_bitwise_equal"] == [True] * DDP_STEPS
                and run["grads_bitwise_equal"] == [True] * DDP_STEPS
                and run["on_card"] == [True] * DDP_STEPS,
                f"{dtype} replicas not bitwise equal on the card: {run}")
        require(run["loss"][-1] < run["loss"][0],
                f"{dtype} loss did not fall: {run['loss']}")
    require(gpu_after_ranks and gpu_after_ddp, "GPU not back")
    return result


# The trainer phase: bench.py's mesh path as MeshTrainer's loop, 7 steps
# with the whole TrainState checkpointed at steps 1, 3 and 5 (two kept),
# failing once after step 3's report and resuming from step 3's
# checkpoint.
TRAINER_STEPS = 7
TRAINER_CKPT_STEPS = (1, 3, 5)
TRAINER_CRASH_AFTER = 3


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def _raise_once(done: threading.Event):
    """The trainer phase's injected failure: a RuntimeError, the first
    time only."""
    def crash():
        if not done.is_set():
            done.set()
            raise RuntimeError("injected failure after step 3's report")
    return crash


def _exit_once(marker: str):
    """The process gang's injected failure: its process exits, the first
    time only (a marker file, as the next attempt is another process)."""
    def crash():
        import os

        if not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
    return crash


def _trainer_loop(config):
    """bench.py's model, seeds and batch on ``train.get_mesh()`` (a world
    of one on NCCL), resumed from ``train.get_checkpoint()`` when there is
    one; reports floats only, and ``config["extra"]()``'s fields when
    given. ``config["crash"]`` (or None) is called after step 3's
    report."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train
    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step

    def leaves(state):
        return tree_leaves(state.params) + tree_leaves(
            state.opt_state["mu"]) + tree_leaves(state.opt_state["nu"])

    mesh = train.get_mesh(device=DEVICE)
    model, params, optimizer, step = _bench_training(llama, train_step)
    state = train_step.create_train_state(
        params, optimizer, mesh, llama.param_logical_axes(model))
    del params
    resumed = {}
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = time.perf_counter()
        template = state
        state = ckpt.to_state(template)
        torch.cuda.synchronize()
        resumed["restore_s"] = time.perf_counter() - start
        resumed["restored_dtensors_placed"] = all(
            isinstance(got, DTensor) and got.placements == like.placements
            and got.device_mesh == like.device_mesh
            for got, like in zip(leaves(state), leaves(template)))
        resumed["resumed_at"] = state.step
        del template
    batch = train_step.shard_batch(_bench_batch(model, 8, 2048), mesh)
    crash, extra = config["crash"], config.get("extra", dict)
    for i in range(state.step, TRAINER_STEPS):
        start = time.perf_counter()
        state, metrics = step(state, batch)
        report = {"step": i, "loss": metrics["loss"].item(),
                  "grad_norm": metrics["grad_norm"].item()}
        torch.cuda.synchronize()
        report["step_s"] = time.perf_counter() - start
        report.update(resumed)
        resumed = {}
        checkpoint = None
        if i in TRAINER_CKPT_STEPS:
            start = time.perf_counter()
            checkpoint = train.Checkpoint.from_state(state)
            report["save_s"] = time.perf_counter() - start
            report["checkpoint_bytes"] = _dir_bytes(checkpoint.path)
        report.update(extra())
        train.report(report, checkpoint=checkpoint)
        if crash is not None and i == TRAINER_CRASH_AFTER:
            crash()


def phase_trainer(llama, fa, device: dict, power: str,
                  mesh: dict) -> tuple[dict, dict]:
    """bench.py's Llama through ``MeshTrainer`` (one worker on the
    card's ``GPU``): 7 steps checkpointed at 1, 3 and 5, failing after
    step 3 and resuming from its checkpoint, held against mesh_train's
    losses and grad norms, and its steps 4-6 (after the restore) bitwise
    mesh_train's, an uninterrupted run of the same step. Cut for the
    script's length: the straight run of 7 steps that earlier runs took
    first, to which the resumed steps were held, is left out (it was
    bitwise mesh_train). Returns the kernels' launches through the run,
    and the phase's result."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    require(not dist.is_initialized(), "a process group exists already")
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    runs = {}
    rt.init(num_cpus=8)
    try:
        for name, crash in (("resumed", _raise_once(threading.Event())),):
            # Checkpoints are written under the temporary directory and
            # moved into storage there: a rename, not a copy.
            storage = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            try:
                with _LaunchCount(fa) as count:
                    result = train.MeshTrainer(
                        _trainer_loop, train_loop_config={"crash": crash},
                        scaling_config=train.ScalingConfig(num_workers=1,
                                                           use_gpu=True),
                        run_config=train.RunConfig(
                            name=name, storage_path=storage,
                            checkpoint_config=train.CheckpointConfig(
                                num_to_keep=2),
                            failure_config=train.FailureConfig(
                                max_failures=1 if crash else 0))).fit()
                    torch.cuda.synchronize()
                kept = sorted(os.listdir(os.path.join(storage, name)))
            finally:
                shutil.rmtree(storage, ignore_errors=True)
            elapsed = time.perf_counter() - start
            torch.cuda.empty_cache()
            runs[name] = {
                "error": repr(result.error) if result.error else None,
                "history": result.metrics_history,
                "checkpoints_kept": len(kept),
                "launches": count.counts, "elapsed_s": elapsed,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "gpu_back": _until(
                    lambda: rt.available_resources().get("GPU") == 1.0),
                "memory_allocated_after": torch.cuda.memory_allocated()}
            require(result.error is None, f"trainer run {name}: "
                                          f"{result.error!r}")
    finally:
        rt.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()
    resumed = runs["resumed"]["history"]
    got = np.array([[m["loss"] for m in resumed],
                    [m["grad_norm"] for m in resumed]])
    want = np.array([mesh["loss"], mesh["grad_norm"]])
    diff = np.abs(got - want)
    ok = bool(got.shape == want.shape and np.all(
        diff <= MESH_TRAIN_ATOL + MESH_TRAIN_RTOL * np.abs(want)))

    after_restore = slice(TRAINER_CRASH_AFTER + 1, TRAINER_STEPS)
    restored = [m for m in resumed if "restore_s" in m]
    saves = [m["save_s"] for m in resumed if "save_s" in m]
    result = {
        "config": "bench.py:50-54", "batch": [8, 2048],
        "steps": TRAINER_STEPS, "checkpoint_steps": list(TRAINER_CKPT_STEPS),
        "crash_after_step": TRAINER_CRASH_AFTER,
        "loss": got[0].tolist(), "grad_norm": got[1].tolist(),
        "against_mesh_train": {
            "max_abs_loss_diff": float(diff[0].max()),
            "max_abs_grad_norm_diff": float(diff[1].max()),
            "bitwise": bool(np.array_equal(got, want)),
            "rtol": MESH_TRAIN_RTOL, "atol": MESH_TRAIN_ATOL, "ok": ok},
        "cut": "the straight 7-step run left out (the script's length)",
        "resumed_steps": [m["step"] for m in resumed],
        "resumed_bitwise_steps_4_6": bool(np.array_equal(
            got[:, after_restore], want[:, after_restore])),
        "restored": restored,
        "step_s": [m["step_s"] for m in resumed],
        "step_s_median": statistics.median(m["step_s"]
                                           for m in resumed[2:]),
        "mesh_train_step_s_median": mesh["step_s_median"],
        "save_s": saves, "checkpoint_bytes": [m["checkpoint_bytes"]
                                              for m in resumed
                                              if "checkpoint_bytes" in m],
        "runs": {name: {k: v for k, v in run.items() if k != "history"}
                 for name, run in runs.items()},
        "memory_allocated_before": allocated_before,
        "card": device["kind"], "nvidia_smi": power,
    }
    emit("trainer", **result)
    require(ok, f"trainer losses/grad norms {got.tolist()} disagree with "
                f"mesh_train's {want.tolist()}")
    require(result["resumed_steps"] == list(range(TRAINER_STEPS)),
            f"resumed run's steps {result['resumed_steps']}")
    require(result["resumed_bitwise_steps_4_6"],
            "the resumed steps 4-6 are not bitwise mesh_train's")
    require(len(restored) == 1 and restored[0]["resumed_at"]
            == TRAINER_CRASH_AFTER + 1
            and restored[0]["restored_dtensors_placed"],
            f"restore: {restored}")
    for name, run in runs.items():
        require(run["checkpoints_kept"] == 2, f"{name}: kept "
                                              f"{run['checkpoints_kept']}")
        require(run["gpu_back"], f"{name}: GPU not back after fit()")
        left = run["memory_allocated_after"] - allocated_before
        require(abs(left) <= 0.01 * allocated_before,
                f"{name}: {left} bytes more allocated after fit() than "
                f"before ({allocated_before})")
        _check_train_launches(f"trainer ({name})", run["launches"],
                              bench_config(llama).num_layers, TRAINER_STEPS)
    return runs["resumed"]["launches"], result


# The data_feed phase: bench.py's batches from a Dataset through the
# device feed. 56 rows of 2049 tokens are 7 batches of 8 x 2048.
FEED_ROWS, FEED_BATCH, FEED_SEQ, FEED_SEED = 56, 8, 2048, 5
FEED_DTYPES = {"tokens": np.int64, "targets": np.int64}
FEED_TRAINER_STEPS = 3


def _feed_dataset(vocab: int):
    """The token array (from a numpy seed) and its Dataset: 4 blocks,
    each row split into tokens and next-token targets."""
    from ray_tpu_torch import data

    arr = np.random.default_rng(FEED_SEED).integers(
        0, vocab, (FEED_ROWS, FEED_SEQ + 1), dtype=np.int32)

    def split(batch):
        return {"tokens": batch["tokens"][:, :-1],
                "targets": batch["tokens"][:, 1:]}

    ds = data.from_numpy({"tokens": arr}).repartition(4).map_batches(split)
    return arr, ds


def _host_rows(arr, i: int) -> dict:
    rows = arr[FEED_BATCH * i:FEED_BATCH * (i + 1)]
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


def _copy_overlap(run) -> dict:
    """``run()`` under torch.profiler: each host-to-device copy on a
    stream that runs no kernel (the feed's side stream) against the
    kernels, from the Chrome trace (its events carry their stream)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not copies or not kernels:
        return {"overlap": "not measured (no copy or kernel traced)"}

    def stream(e):
        return e.get("args", {}).get("stream")

    kernel_streams = {stream(k) for k in kernels}
    rows, own = [], []
    for copy in copies:
        if stream(copy) in kernel_streams:
            own.append(copy)  # the step's own copies, on its stream
            continue
        begin, end = copy["ts"], copy["ts"] + copy["dur"]
        spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
        covered, reach = 0.0, begin
        for k_begin, k_end in spans:
            lo, hi = max(k_begin, reach), min(k_end, end)
            if hi > lo:
                covered += hi - lo
                reach = hi
        rows.append({"stream": stream(copy), "us": copy["dur"],
                     "bytes": copy.get("args", {}).get("bytes"),
                     "overlapped_us": covered})
    if not rows:
        return {"overlap": "not measured (no side-stream copy traced)",
                "kernel_streams": sorted(kernel_streams, key=str),
                "htod_copies": len(copies)}
    return {"side_stream_copies": rows,
            "kernel_streams": sorted(kernel_streams, key=str),
            "copy_us": sum(r["us"] for r in rows),
            "overlapped_us": sum(r["overlapped_us"] for r in rows),
            "overlaps": any(r["overlapped_us"] > 0 for r in rows),
            "step_htod_copies": {
                "count": len(own), "us": sum(c["dur"] for c in own),
                "bytes": sum(c.get("args", {}).get("bytes") or 0
                             for c in own)}}


def _allocated() -> int:
    """Bytes allocated on the card, without the cuBLAS workspaces that
    PyTorch keeps for each thread that ran a product (32 MiB each)."""
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _feed_loop(config):
    """MeshTrainer's loop: bench.py's model on ``train.get_mesh()``, fed
    by the worker's shard of the Dataset through ``iter_device_batches
    (mesh=...)``; reports each step's loss, grad norm and the batch's
    placements."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step

    mesh = train.get_mesh(device=DEVICE)
    model, params, optimizer, step = _bench_training(llama, train_step)
    state = train_step.create_train_state(
        params, optimizer, mesh, llama.param_logical_axes(model))
    del params
    feed = config["datasets"]["train"].iter_device_batches(
        batch_size=FEED_BATCH, mesh=mesh, dtypes=FEED_DTYPES)
    for i, batch in zip(range(FEED_TRAINER_STEPS), feed):
        placements = {k: str(list(t.placements)) if isinstance(t, DTensor)
                      else None for k, t in batch.items()}
        state, metrics = step(state, batch)
        train.report({"step": i, "loss": metrics["loss"].item(),
                      "grad_norm": metrics["grad_norm"].item(),
                      "placements": placements})


def phase_data_feed(llama, train_step, fa, device: dict, power: str) -> dict:
    """bench.py's Llama fed from a ``ray_tpu_torch.data`` Dataset: (a)
    7 steps through ``iter_device_batches`` against the same 7 batches
    placed in memory by ``place_batch`` (both from seed 0, bitwise), the
    wait in ``next()``, the peak memory and whether the side stream's
    copies overlap the kernels of two profiled steps; (b)
    ``MeshTrainer`` at a world of one on NCCL with ``datasets=``, its
    loop fed through the mesh, against the mesh step on the same 3
    batches placed by ``shard_batch``. Returns the kernels' launches
    through both feeds."""
    import torch.distributed as dist

    import ray_tpu_torch as rt

    phase_start = time.perf_counter()
    require(not dist.is_initialized(), "a process group exists already")
    rt.init(num_cpus=8)
    try:
        return _data_feed(llama, train_step, fa, device, power, phase_start)
    finally:
        rt.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()


def _data_feed(llama, train_step, fa, device: dict, power: str,
               phase_start: float) -> dict:
    import torch.distributed as dist

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    config = bench_config(llama)
    arr, ds = _feed_dataset(config.vocab_size)
    warmup, timed = 2, 5
    steps = warmup + timed

    def run(batches) -> dict:
        """``steps`` steps from a fresh state, each batch taken from
        ``batches`` (timed in ``next()``) inside the step's clock."""
        _, params, optimizer, step = _bench_training(llama, train_step)
        state = train_step.create_train_state(params, optimizer)
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"loss": [], "grad_norm": [], "step_s": [], "next_ms": [],
               "batches": []}
        with _LaunchCount(fa) as count:
            for _ in range(steps):
                start = time.perf_counter()
                batch = next(batches)
                out["next_ms"].append((time.perf_counter() - start) * 1e3)
                state, metrics = step(state, batch)
                out["loss"].append(metrics["loss"].item())
                out["grad_norm"].append(metrics["grad_norm"].item())
                torch.cuda.synchronize()
                out["step_s"].append(time.perf_counter() - start)
                out["batches"].append(batch)
        out["launches"] = count.counts
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["state"], out["step"] = state, step
        return out

    feed = ds.iter_device_batches(batch_size=FEED_BATCH, drop_last=True,
                                  device=DEVICE, dtypes=FEED_DTYPES)
    fed = run(feed)
    require(next(feed, None) is None, "the feed gave more than 7 batches")
    rows_equal = [all(torch.equal(batch[k].cpu(), torch.from_numpy(
        want[k].astype(np.int64))) for k in want)
        for batch, want in zip(fed["batches"],
                               (_host_rows(arr, i) for i in range(steps)))]
    # Two more steps through a new feed, profiled from their ``next()``:
    # each queues the copy of the batch after its own.
    state, step = fed.pop("state"), fed.pop("step")
    fed["batches"] = None
    overlap_feed = ds.iter_device_batches(batch_size=FEED_BATCH,
                                          device=DEVICE, dtypes=FEED_DTYPES)
    next(overlap_feed)

    def two_steps():
        nonlocal state
        for _ in range(2):
            state, _ = step(state, next(overlap_feed))

    overlap = _copy_overlap(two_steps)
    del state, step, overlap_feed
    torch.cuda.empty_cache()
    memory = run(iter([train_step.place_batch(_host_rows(arr, i), DEVICE)
                       for i in range(steps)]))
    del memory["state"], memory["step"], memory["batches"]
    torch.cuda.empty_cache()
    bitwise = fed["loss"] == memory["loss"] \
        and fed["grad_norm"] == memory["grad_norm"]
    peak_ratio = fed["peak_memory_bytes"] / memory["peak_memory_bytes"]

    # (b) Train ingestion through the mesh path.
    allocated_before = _allocated()
    with _LaunchCount(fa) as trainer_count:
        result = train.MeshTrainer(
            _feed_loop,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            datasets={"train": ds}).fit()
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.destroy_process_group()
    gpu_back = _until(lambda: rt.available_resources().get("GPU") == 1.0)
    allocated_after = _allocated()
    require(result.error is None, f"feed trainer: {result.error!r}")
    history = result.metrics_history
    require(not dist.is_initialized(), "a process group exists already")
    mesh = build_mesh(MeshConfig(dp=1))
    try:
        _, params, optimizer, step = _bench_training(llama, train_step)
        state = train_step.create_train_state(
            params, optimizer, mesh, llama.param_logical_axes(config))
        del params
        want, placements = [], None
        for i in range(FEED_TRAINER_STEPS):
            batch = train_step.shard_batch(_host_rows(arr, i), mesh)
            placements = {k: str(list(t.placements))
                          for k, t in batch.items()}
            state, metrics = step(state, batch)
            want.append((metrics["loss"].item(),
                         metrics["grad_norm"].item()))
        del state, batch
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    got = [(m["loss"], m["grad_norm"]) for m in history]

    def median(xs):
        return statistics.median(xs[warmup:])

    result = {
        "config": "bench.py:50-54", "params": config.num_params,
        "batch": [FEED_BATCH, FEED_SEQ], "rows": FEED_ROWS, "blocks": 4,
        "data": f"int32 [{FEED_ROWS}, {FEED_SEQ + 1}] in "
                f"[0, {config.vocab_size}) from numpy seed {FEED_SEED}",
        "feed": {k: fed[k] for k in ("loss", "grad_norm", "step_s",
                                     "next_ms", "launches",
                                     "peak_memory_bytes")},
        "in_memory": {k: memory[k] for k in ("loss", "grad_norm", "step_s",
                                             "peak_memory_bytes")},
        "step_s_median_feed": median(fed["step_s"]),
        "step_s_median_in_memory": median(memory["step_s"]),
        "next_ms_median": statistics.median(fed["next_ms"]),
        "next_ms_max": max(fed["next_ms"]),
        "next_ms_timed_median": median(fed["next_ms"]),
        "bitwise_against_in_memory": bitwise,
        "fed_rows_bitwise": rows_equal,
        "peak_memory_ratio": peak_ratio,
        "copy_overlap": overlap,
        "trainer": {
            "steps": [m["step"] for m in history], "loss_grad_norm": got,
            "mesh_step": want, "bitwise": got == want,
            "placements": [m["placements"] for m in history],
            "shard_batch_placements": placements,
            "launches": trainer_count.counts, "gpu_back": gpu_back,
            "memory_allocated_before": allocated_before,
            "memory_allocated_after": allocated_after},
        "wall_s": time.perf_counter() - phase_start,
        "card": device["kind"], "nvidia_smi": power,
    }
    emit("data_feed", **result)
    require(all(rows_equal), f"fed batches not bitwise their rows: "
                             f"{rows_equal}")
    require(bitwise, "the feed's losses/grad norms are not bitwise the "
                     "in-memory run's")
    require(abs(peak_ratio - 1) <= 0.01,
            f"peak memory through the feed {peak_ratio:.4f}x in-memory")
    _check_train_launches("data_feed", fed["launches"], config.num_layers,
                          steps)
    require(got == want, f"feed trainer {got} is not bitwise the mesh "
                         f"step's {want}")
    require(all(m == placements for m in result["trainer"]["placements"]),
            "fed batches are not DTensors placed as shard_batch places")
    require(gpu_back, "GPU not back after the feed trainer's fit()")
    require(abs(allocated_after - allocated_before)
            <= 0.01 * max(allocated_before, 1),
            f"{allocated_after - allocated_before} bytes more allocated "
            f"after the feed trainer's fit()")
    _check_train_launches("data_feed (trainer)", trainer_count.counts,
                          config.num_layers, FEED_TRAINER_STEPS)
    return {k: fed["launches"].get(k, 0) + trainer_count.counts.get(k, 0)
            for k in fed["launches"]}


def _kernel_class(name: str) -> str:
    if re.search(r"(fwd|bwd_dq|bwd_dkv|bwd_delta)_kernel", name):
        return "flash_attention"
    if re.search(r"rmsnorm_kernel", name):
        return "rmsnorm"
    lowered = name.lower()
    for cls, marks in (("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                       ("reduction", ("reduce",)),
                       ("index_scatter_gather", ("index", "scatter",
                                                 "gather")),
                       ("elementwise", ("elementwise",))):
        if any(mark in lowered for mark in marks):
            return cls
    return "other"


def _profile_step(run_step, step_s: float) -> dict:
    """One more step (``run_step()``) under torch.profiler: device busy
    time (the union of kernel intervals), its share of the unprofiled
    median step, and device time by kernel class and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run_step()
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


# ------------------------------------------------------------------ serving


def _rms_inputs(rows, d, dtype, scale_dtype, stride, seed):
    """x [rows, D] (a view with row stride ``stride`` where given) and
    scale [D], drawn on the card from ``seed``."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    base = torch.randn((rows, stride or d), generator=gen, device=DEVICE)
    x = (3 * base).to(dtype)[:, :d]
    if stride is None:
        x = x.contiguous()
    scale = (torch.randn(d, generator=gen, device=DEVICE) + 1).to(scale_dtype)
    return x, scale


def _rms_wrong_stats(x, scale, stats_of):
    """RMSNorm of x with each row's statistics taken by ``stats_of`` (for
    the bound's teeth: a plain version that is wrong on purpose)."""
    x32 = x.float()
    var = stats_of(x32 * x32)
    return (x32 * torch.rsqrt(var + RMS_EPS) * scale.float()).to(x.dtype)


def _rms_bound(rows, d, dtype) -> tuple[float, str]:
    """x read once, out written once, scale read once at the memory rate,
    or ~4 f32 operations per element at the f32 rate, whichever is
    larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (2 * rows * d * size + d * size) / PEAK_BYTES_PER_S
    t_ops = 4 * rows * d / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_rmsnorm(fused) -> dict:
    """The RMSNorm kernel against its plain version at every case of
    RMSNORM_CASES, the bound's teeth, and times at the decode shape and at
    a bandwidth-sized [16384, 4096]."""
    results = {}
    for seed, (name, (rows, d, dtype, scale_dtype, stride)) in enumerate(
            RMSNORM_CASES.items()):
        x, scale = _rms_inputs(rows, d, dtype, scale_dtype, stride, seed)
        got = fused.rms_norm_kernel(x, scale, RMS_EPS)
        want = fused.rms_norm_plain(x, scale, RMS_EPS)
        torch.cuda.synchronize()
        tol = RMS_F32_TOL if dtype == torch.float32 else RMS_BF16_TOL
        results[name] = {"shape": [rows, d], "dtype": str(dtype),
                         "scale_dtype": str(scale_dtype),
                         "row_stride": x.stride(0), **compare(got, want, tol)}
    # Teeth: two plain versions that are wrong on purpose must fail the
    # bf16 bound at the prefill shape.
    x, scale = _rms_inputs(256, 4096, torch.bfloat16, torch.bfloat16, None,
                           seed=100)
    want = fused.rms_norm_plain(x, scale, RMS_EPS)
    half = x.shape[-1] // 2
    teeth = {
        "mean_over_first_half": compare(_rms_wrong_stats(
            x, scale, lambda sq: sq[:, :half].mean(-1, keepdim=True)),
            want, RMS_BF16_TOL),
        "next_rows_statistics": compare(_rms_wrong_stats(
            x, scale, lambda sq: sq.mean(-1, keepdim=True).roll(-1, 0)),
            want, RMS_BF16_TOL),
    }
    times = {}
    for rows, iters in ((8, 500), (16384, 50)):
        d = 4096
        x, scale = _rms_inputs(rows, d, torch.bfloat16, torch.bfloat16, None,
                               seed=200)
        bound_ms, bound_by = _rms_bound(rows, d, torch.bfloat16)

        def no_grad_call():
            # The serving engine's call: the entry point under no_grad.
            with torch.no_grad():
                return fused.rms_norm(x, scale, RMS_EPS)

        calls = {
            "kernel_ms": lambda: fused.rms_norm_kernel(x, scale, RMS_EPS),
            "plain_ms": lambda: fused.rms_norm_plain(x, scale, RMS_EPS),
            "library_ms": lambda: torch.nn.functional.rms_norm(
                x, (d,), scale, RMS_EPS),
            "rms_norm_no_grad_ms": no_grad_call,
        }
        # Each call timed once, in turn, as earlier PRs timed the first
        # three; then three more rounds in turn, whose medians let the
        # host's drift fall on all the calls alike.
        single = {key: cuda_ms(fn, iters, warmup=5)
                  for key, fn in calls.items()}
        rounds = {key: [] for key in calls}
        for _ in range(3):
            for key, fn in calls.items():
                rounds[key].append(cuda_ms(fn, iters, warmup=5))
        times[f"{rows}x{d}"] = {
            **single, "rounds_ms": rounds,
            "rounds_median_ms": {key: statistics.median(ms)
                                 for key, ms in rounds.items()},
            "library_call": "torch.nn.functional.rms_norm",
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit("rmsnorm_kernels", cases=results, teeth=teeth, times_ms=times,
         tolerance={"bf16": RMS_BF16_TOL, "f32": RMS_F32_TOL},
         decode_shape_note="[8, 4096] moves 131 KB: launch-bound, not "
                           "bandwidth-bound")
    bad = [name for name, r in results.items() if not r["ok"]]
    require(not bad, f"the rmsnorm kernel disagrees with its plain version "
                     f"in {bad}")
    passed = [name for name, c in teeth.items() if c["ok"]]
    require(not passed, f"the rmsnorm tolerance passes wrong versions: "
                        f"{passed}")
    decode = times["8x4096"]
    tpu_kernel, replaces = KERNELS["rmsnorm"]
    return {
        "name": "rmsnorm", "route": "cuda",
        "source": SOURCES[KERNEL_LIBRARY["rmsnorm"]],
        "replaces": f"{replaces} ({tpu_kernel})",
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "max_err_over_bound": max(r["max_err_over_bound"]
                                  for r in results.values()),
        "rel_rms": max(r["rel_rms"] for r in results.values()),
        "tolerance": {"bf16": RMS_BF16_TOL, "f32": RMS_F32_TOL},
        "shape": [8, 4096], "ms": decode["kernel_ms"],
        **{key: decode[key] for key in ("plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library_call",
                                         "rms_norm_no_grad_ms",
                                         "rounds_median_ms")},
        "ms_16384x4096": times["16384x4096"]["kernel_ms"],
    }


def _prompts(lengths, vocab, seed) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def _generate(engine, prompts, max_new_tokens, temperatures=None) -> list:
    """Submit every prompt at once, each from its own thread; per request
    its tokens, its error, its submit time and the arrival time of each
    token (host clock)."""
    temperatures = temperatures or [0.0] * len(prompts)
    records = [None] * len(prompts)
    barrier = threading.Barrier(len(prompts))

    def run(i):
        barrier.wait()
        submitted = time.perf_counter()
        arrivals, tokens, error = [], [], None
        try:
            req = engine.submit(prompts[i], max_new_tokens=max_new_tokens,
                                temperature=temperatures[i], stream=True)
            for token in engine.stream_tokens(req):
                arrivals.append(time.perf_counter())
                tokens.append(token)
        except Exception as exc:  # noqa: BLE001 — reported and required
            error = repr(exc)
        records[i] = {"tokens": tokens, "error": error,
                      "submitted": submitted, "arrivals": arrivals}

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    require(not any(t.is_alive() for t in threads), "a request hung")
    return records


@torch.no_grad()
def _greedy_full_forward(llama, params, prompt, config, steps) -> list[int]:
    """Greedy decoding with the full-context forward of the plain model."""
    tokens, out = list(prompt), []
    for _ in range(steps):
        logits = llama.forward(
            params, torch.tensor([tokens], device=DEVICE), config)
        out.append(int(torch.argmax(logits[0, -1])))
        tokens.append(out[-1])
    return out


@torch.no_grad()
def _prefill_last_logits(paged_model, cache_mod, params, prompt, config,
                         block_size, chunk):
    """The last-position logits of ``prompt`` through the engine's
    prefill step, chunk by chunk, into a fresh pool."""
    blocks = -(-len(prompt) // block_size)
    pool = cache_mod.PagedKVCache.init_pool(config, 1 + blocks, block_size,
                                            device=DEVICE)
    table = torch.arange(1, 1 + blocks, device=DEVICE)[None, :]
    step = paged_model.make_prefill_chunk(config, block_size)
    for start in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - start)
        tokens = torch.zeros((1, chunk), dtype=torch.int64, device=DEVICE)
        tokens[0, :n] = torch.tensor(prompt[start:start + n], device=DEVICE)
        positions = torch.zeros((1, chunk), dtype=torch.int64, device=DEVICE)
        positions[0, :n] = torch.arange(start, start + n, device=DEVICE)
        last, pool = step(params, pool, tokens, positions, table, n, n - 1)
    return last


def serve_check_config(llama):
    """Llama-3-8B widths at 2 layers, f32, for the exactness check."""
    return dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2,
                               dtype=torch.float32, remat=False)


def phase_serve_check(llama) -> None:
    """The engine's exactness on the card: greedy output of 4 ragged
    prompts equals full-context greedy decoding (token for token), the
    prefill's last logits are within SERVE_CHECK_LOGITS_TOL of the full
    forward's, and a pool small enough to preempt gives the same
    outputs."""
    from ray_tpu_torch.serve.llm_engine import LLMEngine, kv_cache
    from ray_tpu_torch.serve.llm_engine import model as paged_model

    config = serve_check_config(llama)
    params = llama.init_params(
        config, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    prompts = _prompts(SERVE_CHECK_PROMPT_LENGTHS, config.vocab_size, 1)
    new_tokens, block, chunk = 16, 16, 32
    engine_args = dict(max_batch_size=4, max_seq_len=256, block_size=block,
                       prefill_chunk=chunk, device=DEVICE)
    expected = [_greedy_full_forward(llama, params, p, config, new_tokens)
                for p in prompts]
    with torch.no_grad():
        full = llama.forward(params, torch.tensor([prompts[-1]],
                                                  device=DEVICE), config)
    logits = compare(_prefill_last_logits(
        paged_model, kv_cache, params, prompts[-1], config, block, chunk),
        full[0, -1], SERVE_CHECK_LOGITS_TOL)
    runs = {}
    # Every request needs 2 to 11 blocks of 16 (25 together); 12 usable
    # blocks force preemption.
    for name, num_blocks in (("pressure_free", None), ("pressure", 13)):
        engine = LLMEngine(config, params, num_blocks=num_blocks,
                           **engine_args)
        try:
            records = _generate(engine, prompts, new_tokens)
            runs[name] = {"outputs": [r["tokens"] for r in records],
                          "errors": [r["error"] for r in records],
                          "stats": engine.engine_stats()}
        finally:
            engine.shutdown()
    identical = {name: run["outputs"] == expected
                 for name, run in runs.items()}
    emit("serve_check", config="llama3_8b widths, 2 layers, float32",
         prompt_lengths=list(SERVE_CHECK_PROMPT_LENGTHS),
         max_new_tokens=new_tokens, block_size=block, prefill_chunk=chunk,
         token_identical=identical, prefill_last_logits=logits,
         pressure_stats=runs["pressure"]["stats"],
         pressure_free_stats=runs["pressure_free"]["stats"],
         mismatches={name: [[i, run["outputs"][i], expected[i]]
                            for i in range(len(prompts))
                            if run["outputs"][i] != expected[i]]
                     for name, run in runs.items()})
    for name, run in runs.items():
        require(not any(run["errors"]), f"serve_check {name}: "
                                        f"{run['errors']}")
        require(identical[name], f"serve_check {name}: the engine's greedy "
                                 f"output differs from full-context decoding")
    require(logits["ok"], "prefill logits disagree with the full forward")
    stats = runs["pressure"]["stats"]
    require(stats["preemptions"] > 0 and stats["resumes"] > 0,
            f"the pressure run did not preempt: {stats}")
    require(stats["finished"] == len(prompts),
            f"pressure run finished {stats['finished']} requests")
    del params, full
    torch.cuda.empty_cache()


def serve_config(llama):
    """The served model: ``LlamaConfig.llama3_8b()`` at full width and
    depth, bf16."""
    return llama.LlamaConfig.llama3_8b()


def _timed(fn, sink: list):
    """``fn`` with the host time of each call, ending in a synchronize
    (the engine copies the sampled tokens to the host right after),
    appended to ``sink``."""
    def call(*args):
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - start)
        return out
    return call


# The serving engine's settings and traffic in the serve and runtime
# phases: 16 requests at once, prompt lengths uniform in 32-1024 (seed 2),
# 64 new tokens each, 12 greedy and 4 at temperature 0.7.
SERVE_ENGINE = {"max_batch_size": 8, "max_seq_len": 2048, "block_size": 16,
                "prefill_chunk": 256}
SERVE_NEW_TOKENS = 64


def serve_requests(config) -> tuple[list, list, list]:
    """Prompt lengths, prompts and temperatures of the 16 requests."""
    lengths = np.random.default_rng(2).integers(32, 1025, 16).tolist()
    return (lengths, _prompts(lengths, config.vocab_size, 3),
            [0.0] * 12 + [0.7] * 4)


def phase_serve(llama, fused, device: dict, power: str) -> dict:
    """The slice: 16 concurrent ragged requests through ``LLMEngine`` on
    the full Llama-3-8B in bf16. Returns the RMSNorm kernel's launches in
    the run, the phase's numbers and the bf16 parameter tree (which the
    runtime phase serves again)."""
    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    config = serve_config(llama)
    # Random weights from a seed, cast once to bf16 as a bf16 checkpoint
    # would be loaded; the f32 tree is freed.
    params32 = llama.init_params(
        config, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    params = tree_map(lambda t: t.to(torch.bfloat16), params32)
    del params32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_requests, new_tokens = 16, SERVE_NEW_TOKENS
    max_seq_len = SERVE_ENGINE["max_seq_len"]
    lengths, prompts, temperatures = serve_requests(config)
    engine = LLMEngine(config, params, **SERVE_ENGINE, device=DEVICE)
    decode_raw = engine._decode_step
    decode_s, prefill_s = [], []
    try:
        # Warm-up: one short request (allocator, cuBLAS handles).
        warm = engine.result(engine.submit(prompts[0][:32], max_new_tokens=2),
                             timeout_s=600)
        require(len(warm) == 2, "warm-up request failed")
        engine._decode_step = _timed(decode_raw, decode_s)
        engine._prefill_step = _timed(engine._prefill_step, prefill_s)
        before = engine.engine_stats()
        fused.launches["rmsnorm"] = 0
        start = time.perf_counter()
        records = _generate(engine, prompts, new_tokens, temperatures)
        wall = time.perf_counter() - start
        launches = fused.launches["rmsnorm"]
        after = engine.engine_stats()
        peak = torch.cuda.max_memory_allocated()
        stats = {k: after[k] - before[k] for k in after}
        forwards = stats["decode_steps"] + stats["prefill_chunks"]
        ttft = [r["arrivals"][0] - r["submitted"] if r["arrivals"] else None
                for r in records]
        decode_ms = 1e3 * statistics.median(decode_s) if decode_s else None
        result = {
            "config": "LlamaConfig.llama3_8b() (ray_tpu/models/llama.py:79-83)",
            "params": sum(t.numel() for t in tree_leaves(params)),
            "layers": config.num_layers, "dtype": "bfloat16",
            "engine": {**SERVE_ENGINE,
                       "num_blocks": engine._sched.cache.num_blocks},
            "requests": n_requests, "prompt_lengths": lengths,
            "max_new_tokens": new_tokens, "temperatures": temperatures,
            "ttft_s": ttft,
            "ttft_s_median": statistics.median(
                [t for t in ttft if t is not None] or [math.nan]),
            "ttft_s_max": max([t for t in ttft if t is not None]
                              or [math.nan]),
            "decode_step_ms_median": decode_ms,
            "decode_steps_timed": len(decode_s),
            "prefill_chunk_ms_median": 1e3 * statistics.median(prefill_s)
            if prefill_s else None,
            "prefill_chunks_timed": len(prefill_s),
            "wall_s": wall,
            "output_tokens_per_s": sum(len(r["tokens"]) for r in records)
            / wall,
            "engine_stats": stats,
            "rmsnorm_launches": launches,
            "rmsnorm_launches_per_forward": launches / forwards
            if forwards else None,
            "peak_memory_bytes": peak,
            "card": device["kind"], "nvidia_smi": power,
        }
        emit("serve", **result)
        errors = [r["error"] for r in records if r["error"]]
        require(not errors, f"requests failed: {errors}")
        short = [len(r["tokens"]) for r in records
                 if len(r["tokens"]) != new_tokens]
        require(not short, f"requests sealed with {short} tokens, not "
                           f"{new_tokens}")
        require(all(0 <= t < config.vocab_size for r in records
                    for t in r["tokens"]), "a token outside [0, vocab)")
        require(stats["batched_decode_steps"] > 0, "no batched decode step")
        per_forward = 2 * config.num_layers + 1
        require(launches > 0 and launches == per_forward * forwards,
                f"rmsnorm launched {launches} times over {forwards} "
                f"forwards, not {per_forward} per forward")
        emit("serve_profile", **_profile_decode(engine, decode_raw,
                                                decode_ms))
    finally:
        engine.shutdown()
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "params": params, "result": result,
            "tokens": [r["tokens"] for r in records]}


def _profile_decode(engine, decode_raw, decode_ms: float) -> dict:
    """One decode step of a full batch (8 rows at position 1000 with
    disjoint tables) under torch.profiler."""
    rows, width = engine.max_batch, engine.blocks_per_seq
    gen = torch.Generator(DEVICE).manual_seed(4)
    tokens = torch.randint(0, engine.config.vocab_size, (rows, 1),
                           generator=gen, device=DEVICE)
    positions = torch.full((rows,), 1000, dtype=torch.int64, device=DEVICE)
    tables = 1 + torch.arange(rows * width, device=DEVICE).reshape(
        rows, width) % (engine._sched.cache.num_blocks - 1)
    temps = torch.zeros(rows, device=DEVICE)

    def step():
        decode_raw(engine.params, engine._pool, tokens, positions, tables,
                   gen, temps)[0].cpu()

    step()
    return {"batch": rows, "position": 1000,
            **_profile_step(step, decode_ms / 1e3)}


# ------------------------------------------------------------------ runtime


class EngineActor:
    """The serving engine inside an actor of the port's runtime: the
    class a user wraps ``LLMEngineServer`` in, since an actor handle
    refuses ``__call__``. ``params`` may be an ObjectRef (actor
    constructor arguments are passed as given, as in the reference)."""

    def __init__(self, config, params, **engine_args):
        import ray_tpu_torch
        from ray_tpu_torch.serve.llm_engine import LLMEngineServer

        if isinstance(params, ray_tpu_torch.ObjectRef):
            params = ray_tpu_torch.get(params)
        self.server = LLMEngineServer(config, params, **engine_args)
        self.decode_s, self.prefill_s = [], []

    def generate(self, request: dict) -> dict:
        return self.server(request)

    def stream(self, request: dict) -> dict:
        """The tokens, and the host clock at each token's arrival."""
        tokens, arrivals = [], []
        for token in self.server.generate(request):
            arrivals.append(time.perf_counter())
            tokens.append(token)
        return {"tokens": tokens, "arrivals": arrivals}

    def data_ptrs(self) -> list[int]:
        from ray_tpu_torch._private.tree import tree_leaves

        return [t.data_ptr() for t in tree_leaves(self.server._engine.params)]

    def time_steps(self) -> None:
        """Time each decode and prefill call as the serve phase does."""
        engine = self.server._engine
        engine._decode_step = _timed(engine._decode_step, self.decode_s)
        engine._prefill_step = _timed(engine._prefill_step, self.prefill_s)

    def step_times(self) -> dict:
        return {"decode_s": list(self.decode_s),
                "prefill_s": list(self.prefill_s)}

    def stats(self) -> dict:
        return self.server.engine_stats()

    def noop(self) -> None:
        return None

    def stall(self, gate: threading.Event) -> None:
        """Wedge the engine loop at its next iteration until ``gate``."""
        self.server._engine._prefill_tick = lambda: gate.wait(60) and False

    def unstall(self) -> None:
        del self.server._engine._prefill_tick

    def shutdown(self) -> None:
        """Stop the engine and drop it, so its KV pool is freed before
        the next engine allocates one (killing the actor does neither)."""
        self.server.shutdown()
        del self.server


def _two_train_steps(llama, train_step) -> list[float]:
    """2 train steps of the bench model at bench width, 2 layers, 8 x 2048,
    from seeds (their own generators: nothing shares a global RNG)."""
    config = dataclasses.replace(bench_config(llama), num_layers=2)
    params = llama.init_params(config,
                               torch.Generator(DEVICE).manual_seed(0), DEVICE)
    optimizer = train_step.default_optimizer(
        learning_rate=3e-4, warmup_steps=10, total_steps=1000)
    state = train_step.create_train_state(params, optimizer, device=DEVICE)
    del params

    def loss(params, batch):
        return llama.loss_fn(params, batch["tokens"], batch["targets"],
                             config)

    step = train_step.build_train_step(loss, optimizer)
    tokens = torch.randint(0, config.vocab_size, (8, 2049),
                           generator=torch.Generator(DEVICE).manual_seed(1),
                           device=DEVICE)
    batch = train_step.place_batch(
        {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}, device=DEVICE)
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    return losses


def phase_runtime_check(llama, train_step, fa, fused,
                        train_launches: dict) -> dict:
    """The core runtime on the card: the GPU resource, a ``num_gpus=1``
    actor serving ``serve_check``'s configuration token for token, a
    ``num_gpus=1`` train task held back while the actor holds the GPU,
    and a deadline sealed typed. Returns the kernels' launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import ActorError, TaskTimeoutError

    start = time.perf_counter()
    allocated_before = torch.cuda.memory_allocated()
    # The same two steps in the main thread, for the losses.
    direct = _two_train_steps(llama, train_step)
    torch.cuda.empty_cache()
    config = serve_check_config(llama)
    params = llama.init_params(
        config, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    prompts = _prompts(SERVE_CHECK_PROMPT_LENGTHS, config.vocab_size, 1)
    new_tokens = 16
    expected = [_greedy_full_forward(llama, params, p, config, new_tokens)
                for p in prompts]
    rt.init(num_cpus=8)
    try:
        resources = rt.cluster_resources()
        require(resources.get("GPU") == torch.cuda.device_count(),
                f"cluster_resources() {resources}, cards "
                f"{torch.cuda.device_count()}")
        with _LaunchCount(fa, fused) as count:
            actor = rt.remote(num_gpus=1, max_concurrency=4)(
                EngineActor).remote(
                config, params, max_batch_size=4, max_seq_len=256,
                block_size=16, prefill_chunk=32, device=DEVICE)
            rt.get(actor.stats.remote(), timeout=600)
            gpu_held = rt.available_resources().get("GPU")
            task = rt.remote(num_gpus=1)(_two_train_steps).remote(
                llama, train_step)
            held_back = rt.wait([task], timeout=2)[0] == []
            outputs = [r["tokens"] for r in rt.get(
                [actor.generate.remote({"tokens": p,
                                        "max_new_tokens": new_tokens})
                 for p in prompts], timeout=600)]
            gate = threading.Event()
            rt.get(actor.stall.remote(gate), timeout=60)
            try:
                rt.get(actor.generate.options(_deadline_s=1.0).remote(
                    {"tokens": prompts[0], "max_new_tokens": 4}),
                    timeout=60)
                deadline_error = None
            except ActorError as exc:
                deadline_error = exc.cause
            finally:
                gate.set()
            rt.get(actor.unstall.remote(), timeout=60)
            rt.get(actor.shutdown.remote(), timeout=60)
            rt.kill(actor)
            del actor
            losses = rt.get(task, timeout=600)
            torch.cuda.synchronize()
        gpu_after = rt.available_resources().get("GPU")
    finally:
        rt.shutdown()
    del params
    torch.cuda.empty_cache()
    allocated_after = torch.cuda.memory_allocated()
    layers = 2
    per_step = {k: train_launches[k] / train_launches["flash_bwd"] * layers
                for k in ("fwd", "bwd_dq", "bwd_dkv", "bwd_delta",
                          "flash_bwd")}
    task_per_step = {k: count.counts[k] / 2 for k in per_step}
    stage = getattr(deadline_error, "stage", None)
    result = {
        "config": "llama3_8b widths, 2 layers, float32 (serve_check's)",
        "cluster_resources": resources, "gpu_available_while_held": gpu_held,
        "task_held_back": held_back, "token_identical": outputs == expected,
        "mismatches": [[i, outputs[i], expected[i]]
                       for i in range(len(prompts))
                       if outputs[i] != expected[i]],
        "deadline_error": type(deadline_error).__name__,
        "deadline_stage": stage,
        "task_losses": losses, "direct_losses": direct,
        "losses_bitwise_equal": losses == direct,
        "loss_rel_err": [abs(a - b) / abs(b) for a, b in zip(losses, direct)],
        "task_flash_launches_per_step": task_per_step,
        "train_phase_launches_per_step_at_2_layers": per_step,
        "launches": count.counts, "gpu_available_after_kill": gpu_after,
        "memory_allocated_before_after": [allocated_before, allocated_after],
        "elapsed_s": time.perf_counter() - start,
    }
    emit("runtime_check", **result)
    require(gpu_held == 0, f"GPU available while the actor holds it: "
                           f"{gpu_held}")
    require(held_back, "the num_gpus=1 task ran while the actor held the "
                       "GPU")
    require(outputs == expected, "the actor's greedy output differs from "
                                 "full-context decoding")
    require(isinstance(deadline_error, TaskTimeoutError)
            and stage == "llm_queue",
            f"the stalled call sealed {deadline_error!r}, not a "
            f"TaskTimeoutError at stage llm_queue")
    require(all(math.isclose(a, b, rel_tol=1e-3)
                for a, b in zip(losses, direct)),
            f"task losses {losses} vs main-thread losses {direct}")
    require(task_per_step == per_step,
            f"the task's flash launches per step {task_per_step}, the train "
            f"phase's at 2 layers {per_step}")
    require(gpu_after == 1.0, f"GPU not released after the kill: "
                              f"{gpu_after}")
    require(allocated_after - allocated_before < MEMORY_LEFT_BYTES,
            f"the phase left {allocated_after - allocated_before} bytes "
            f"allocated on the card")
    return count.counts


def _round_trips_us(rt, call, n: int = 200) -> dict:
    """Host us of ``rt.get(call())`` (an empty actor method or task: the
    runtime's own cost per call), one at a time, after 20 unmeasured."""
    times = []
    for i in range(20 + n):
        start = time.perf_counter()
        rt.get(call(), timeout=60)
        if i >= 20:
            times.append(1e6 * (time.perf_counter() - start))
    times.sort()
    return {"median": statistics.median(times), "p90": times[int(0.9 * n)],
            "calls": n}


def phase_runtime(llama, fa, fused, served: dict, device: dict,
                  power: str) -> dict:
    """The serve phase's 16 requests again, now as 16 concurrent calls of
    a ``num_gpus=1`` actor holding the full Llama-3-8B in bf16, its
    weights the serve phase's tree ``put`` into the store. Returns the
    kernels' launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private.tree import tree_leaves

    start = time.perf_counter()
    allocated_before = torch.cuda.memory_allocated()
    config = serve_config(llama)
    params = served["params"]
    lengths, prompts, temperatures = serve_requests(config)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    n_params = sum(t.numel() for t in tree_leaves(params))
    # The store's default budget (2 GiB): weights on the card are charged
    # past it but never spilled.
    rt.init(num_cpus=8)
    try:
        store = worker.global_runtime().store
        before = store.stats()
        ref = rt.put(params)
        after = store.stats()
        charged = after["memory_used_bytes"] - before["memory_used_bytes"]
        spilled = after["spilled_bytes_total"] \
            - before["spilled_bytes_total"]
        budget = after["memory_limit_bytes"]
        actor = rt.remote(num_gpus=1, max_concurrency=16)(
            EngineActor).remote(config, ref, **SERVE_ENGINE, device=DEVICE)
        same_ptrs = rt.get(actor.data_ptrs.remote(), timeout=600) == [
            t.data_ptr() for t in tree_leaves(params)]
        # Warm-up: one short request (allocator, cuBLAS handles).
        warm = rt.get(actor.generate.remote(
            {"tokens": prompts[0][:32], "max_new_tokens": 2}), timeout=600)
        require(len(warm["tokens"]) == 2, "warm-up request failed")
        rt.get(actor.time_steps.remote(), timeout=60)
        stats_before = rt.get(actor.stats.remote(), timeout=60)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _LaunchCount(fa, fused) as count:
            refs, submitted = [], []
            wall_start = time.perf_counter()
            for prompt, temperature in zip(prompts, temperatures):
                submitted.append(time.perf_counter())
                refs.append(actor.stream.remote(
                    {"tokens": prompt, "max_new_tokens": SERVE_NEW_TOKENS,
                     "temperature": temperature}))
            records, errors = [], []
            for r in refs:
                try:
                    records.append(rt.get(r, timeout=600))
                except Exception as exc:  # noqa: BLE001 — reported and required
                    records.append({"tokens": [], "arrivals": []})
                    errors.append(repr(exc))
            wall = time.perf_counter() - wall_start
        peak = torch.cuda.max_memory_allocated()
        stats_after = rt.get(actor.stats.remote(), timeout=60)
        steps = rt.get(actor.step_times.remote(), timeout=60)
        call_us = _round_trips_us(rt, actor.noop.remote)
        task_us = _round_trips_us(rt, rt.remote(lambda: None).remote)
        rt.get(actor.shutdown.remote(), timeout=60)
        rt.kill(actor)
        gpu_after = rt.available_resources().get("GPU")
    finally:
        rt.shutdown()
    torch.cuda.empty_cache()
    allocated_after = torch.cuda.memory_allocated()
    stats = {k: stats_after[k] - stats_before[k] for k in stats_after}
    forwards = stats["decode_steps"] + stats["prefill_chunks"]
    ttft = [r["arrivals"][0] - t if r["arrivals"] else None
            for r, t in zip(records, submitted)]
    measured = [t for t in ttft if t is not None] or [math.nan]
    launches = count.counts["rmsnorm"]
    serve = served["result"]
    result = {
        "config": "LlamaConfig.llama3_8b() (ray_tpu/models/llama.py:79-83)",
        "params": n_params, "dtype": "bfloat16",
        "put_bytes_charged": charged, "params_nbytes": nbytes,
        "store_budget_bytes": budget, "put_bytes_spilled": spilled,
        "put_zero_copy": same_ptrs, "engine": SERVE_ENGINE,
        "requests": len(prompts), "prompt_lengths": lengths,
        "max_new_tokens": SERVE_NEW_TOKENS, "temperatures": temperatures,
        "ttft_s": ttft, "ttft_s_median": statistics.median(measured),
        "ttft_s_max": max(measured),
        "decode_step_ms_median": 1e3 * statistics.median(steps["decode_s"])
        if steps["decode_s"] else None,
        "decode_steps_timed": len(steps["decode_s"]),
        "prefill_chunk_ms_median": 1e3 * statistics.median(
            steps["prefill_s"]) if steps["prefill_s"] else None,
        "wall_s": wall,
        "output_tokens_per_s": sum(len(r["tokens"]) for r in records) / wall,
        "engine_stats": stats, "rmsnorm_launches": launches,
        "rmsnorm_launches_per_forward": launches / forwards
        if forwards else None,
        "peak_memory_bytes": peak, "gpu_available_after_kill": gpu_after,
        "actor_call_round_trip_us": call_us, "task_round_trip_us": task_us,
        "memory_allocated_before_after": [allocated_before, allocated_after],
        "serve_phase": {k: serve[k] for k in (
            "ttft_s_median", "ttft_s_max", "decode_step_ms_median",
            "output_tokens_per_s", "peak_memory_bytes", "rmsnorm_launches",
            "wall_s")},
        "launches": count.counts, "card": device["kind"],
        "nvidia_smi": power, "elapsed_s": time.perf_counter() - start,
    }
    emit("runtime", **result)
    require(charged == nbytes == 2 * config.num_params,
            f"put of the tree charged {charged} bytes; its tensors hold "
            f"{nbytes}, 2 x {config.num_params} parameters")
    require(same_ptrs, "the actor's weights are not the caller's tensors")
    require(spilled == 0 and budget < nbytes,
            f"put of {nbytes} bytes on the card under a {budget}-byte budget "
            f"spilled {spilled} bytes")
    require(not errors, f"requests failed: {errors}")
    short = [len(r["tokens"]) for r in records
             if len(r["tokens"]) != SERVE_NEW_TOKENS]
    require(not short, f"requests sealed with {short} tokens, not "
                       f"{SERVE_NEW_TOKENS}")
    require(all(0 <= t < config.vocab_size for r in records
                for t in r["tokens"]), "a token outside [0, vocab)")
    per_forward = 2 * config.num_layers + 1
    require(launches > 0 and launches == per_forward * forwards,
            f"rmsnorm launched {launches} times over {forwards} forwards, "
            f"not {per_forward} per forward")
    require(gpu_after == 1.0, f"GPU not released after the kill: "
                              f"{gpu_after}")
    require(allocated_after - allocated_before < MEMORY_LEFT_BYTES,
            f"the phase left {allocated_after - allocated_before} bytes "
            f"allocated on the card")
    return count.counts, result


# ---------------------------------------------------- placement and serve


def _assigned() -> dict:
    import ray_tpu_torch as rt

    return rt.get_runtime_context().get_assigned_resources()


def _until(predicate, wait_s: float = 60.0) -> bool:
    deadline = time.monotonic() + wait_s
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def phase_placement_check(llama, train_step, fa) -> dict:
    """A ``GPU`` placement group on the card: it takes the ``GPU`` from
    the node, a ``num_gpus=1`` task in its bundle takes the 2 train steps
    of runtime_check bitwise as the driver thread does, a plain
    ``num_gpus=1`` task waits until the group is removed, and a
    deadline-armed submit past ``admission_max_queue_depth`` is shed.
    Returns the kernels' launches through the group."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.exceptions import SystemOverloadedError
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        placement_group_table,
        remove_placement_group,
    )
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    start = time.perf_counter()
    allocated_before = torch.cuda.memory_allocated()
    direct = _two_train_steps(llama, train_step)
    torch.cuda.empty_cache()
    rt.init(num_cpus=8)
    try:
        group = placement_group([{"GPU": 1, "CPU": 1}],
                                strategy="STRICT_PACK")
        ready = group.wait(60)
        gpu_held = rt.available_resources().get("GPU")
        waiting = rt.remote(num_gpus=1)(_assigned).remote()
        held_back = rt.wait([waiting], timeout=2)[0] == []
        bundled = rt.remote(num_gpus=1)(_two_train_steps).options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=group, placement_group_bundle_index=0))
        with _LaunchCount(fa) as count:
            losses = rt.get(bundled.remote(llama, train_step), timeout=600)
            torch.cuda.synchronize()
        states = [g["state"] for g in placement_group_table().values()]
        remove_placement_group(group)
        waited = rt.get(waiting, timeout=60)
        gpu_back = _until(lambda: rt.available_resources().get("GPU") == 1.0)
        # Admission: a blocker holds the 8 CPUs, 3 tasks queue behind it
        # (depth 4, over a cap of 2): a deadline-armed submit is shed,
        # the deadline-free ones complete. The cap is set once the
        # submit ring has handed the backlog to the dispatcher: over the
        # cap the ring holds deadline-free submits back (backpressure),
        # and sheds a deadline-armed one at its flush, its error sealed
        # on its ref.
        release = threading.Event()
        blocker = rt.remote(num_cpus=8)(release.wait).remote(60)
        backlog = [rt.remote(num_cpus=8)(_assigned).remote()
                   for _ in range(3)]
        runtime = worker.global_runtime()
        _until(lambda: not any(runtime._submit_ring.holds(r.id())
                               for r in (blocker, *backlog)))
        GLOBAL_CONFIG.update({"admission_max_queue_depth": 2})
        depth = runtime.dispatcher.pending_count()
        try:
            rt.get(rt.remote(_assigned).options(_deadline_s=30).remote(),
                   timeout=30)
            shed = None
        except SystemOverloadedError as exc:
            shed = type(exc).__name__
        release.set()
        rt.get([blocker, *backlog], timeout=60)
        stats = runtime.stats()
    finally:
        GLOBAL_CONFIG.reset()
        rt.shutdown()
    torch.cuda.empty_cache()
    allocated_after = torch.cuda.memory_allocated()
    result = {
        "group": "[{GPU: 1, CPU: 1}], STRICT_PACK", "ready": ready,
        "states_while_used": states, "gpu_available_while_reserved": gpu_held,
        "plain_task_held_back": held_back, "plain_task_assigned": waited,
        "gpu_back_after_remove": gpu_back,
        "task_losses": losses, "direct_losses": direct,
        "losses_bitwise_equal": losses == direct,
        "flash_launches_through_the_group": count.counts,
        "admission_depth": depth, "admission_shed": shed,
        "runtime_stats": stats,
        "memory_allocated_before_after": [allocated_before, allocated_after],
        "elapsed_s": time.perf_counter() - start,
    }
    emit("placement_check", **result)
    require(ready and states == ["CREATED"], f"group not created: {states}")
    require(gpu_held == 0.0, f"GPU available while reserved: {gpu_held}")
    require(held_back, "a plain num_gpus=1 task ran while the group held "
                       "the GPU")
    require(losses == direct, f"bundled task losses {losses}, driver "
                              f"thread's {direct}: not bitwise equal")
    # 2 steps of 2 layers; remat "dots" runs each forward twice.
    layers_steps = 2 * 2
    expected = {"fwd": 2 * layers_steps, "bwd_dq": layers_steps,
                "bwd_dkv": layers_steps, "bwd_delta": layers_steps,
                "flash_bwd": layers_steps}
    require(count.counts == expected, f"flash launches through the group "
                                      f"{count.counts}, not {expected}")
    require(waited == {"CPU": 1.0, "GPU": 1.0} and gpu_back,
            f"after removal: task {waited}, GPU back {gpu_back}")
    require(depth > 2 and shed == "SystemOverloadedError"
            and stats["admission_shed"] == 1,
            f"admission: depth {depth}, shed {shed}, stats {stats}")
    require(allocated_after - allocated_before < MEMORY_LEFT_BYTES,
            f"the phase left {allocated_after - allocated_before} bytes "
            f"allocated on the card")
    return count.counts


def _served_engine():
    """``LLMEngineServer`` as the deployments serve it, with what the
    phases read from inside a replica: the leaves' ``data_ptr()``, the
    requests each replica took, the step times, and a hook that wedges
    the engine loop. ``live`` holds the replicas' instances weakly."""
    import weakref

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.serve.llm_engine import LLMEngineServer

    class ServedEngine(LLMEngineServer):
        live: "weakref.WeakSet" = weakref.WeakSet()

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._count_lock = threading.Lock()
            self.requests = 0
            self.decode_s, self.prefill_s = [], []
            ServedEngine.live.add(self)

        def _counted(self):
            with self._count_lock:
                self.requests += 1

        def __call__(self, request: dict) -> dict:
            self._counted()
            return super().__call__(request)

        def generate(self, request: dict):
            self._counted()
            yield from super().generate(request)

        def data_ptrs(self) -> list[int]:
            return [t.data_ptr() for t in tree_leaves(self._engine.params)]

        def time_steps(self) -> None:
            engine = self._engine
            engine._decode_step = _timed(engine._decode_step, self.decode_s)
            engine._prefill_step = _timed(engine._prefill_step,
                                          self.prefill_s)

        def step_times(self) -> dict:
            return {"decode_s": list(self.decode_s),
                    "prefill_s": list(self.prefill_s)}

        def stall(self, gate: threading.Event) -> None:
            self._engine._prefill_tick = lambda: gate.wait(60) and False

        def unstall(self) -> None:
            del self._engine._prefill_tick

    return ServedEngine


def _http_generate(port: int, request: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps(request).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _queue_round_trips_us(n: int = 200) -> dict:
    """Host us of one chunk through a stream's ``Queue`` actor: a ``put``
    and a ``get``, each an actor call, one at a time, after 20
    unmeasured."""
    from ray_tpu_torch.util.queue import Queue

    queue = Queue(maxsize=256)
    times = []
    try:
        for i in range(20 + n):
            start = time.perf_counter()
            queue.put(("chunk", i))
            queue.get(timeout=60)
            if i >= 20:
                times.append(1e6 * (time.perf_counter() - start))
    finally:
        queue.shutdown()
    times.sort()
    return {"median": statistics.median(times), "p90": times[int(0.9 * n)],
            "chunks": n}


def phase_serve_deployment_check(llama, fa, fused) -> dict:
    """serve_check's configuration as a deployment of 2 replicas
    (``num_gpus=0.5`` each) behind the handle, the router and the HTTP
    proxy: every output token-identical to full-context decoding, both
    replicas used, a dead deadline sealed at ``llm_queue``, the ``GPU``
    and the card's allocation back after ``serve.shutdown()``. Returns
    the kernels' launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    start = time.perf_counter()
    allocated_before = torch.cuda.memory_allocated()
    config = serve_check_config(llama)
    params = llama.init_params(
        config, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    prompts = _prompts(SERVE_CHECK_PROMPT_LENGTHS, config.vocab_size, 1)
    new_tokens = 16
    expected = [_greedy_full_forward(llama, params, p, config, new_tokens)
                for p in prompts]
    requests = [{"tokens": p, "max_new_tokens": new_tokens} for p in prompts]
    served_engine = _served_engine()
    rt.init(num_cpus=8)
    try:
        serve.start(http_options={"host": "127.0.0.1", "port": 0})
        port = serve.api._proxy.port
        app = serve.deployment(served_engine).options(
            num_replicas=2, ray_actor_options={"num_gpus": 0.5}).bind(
            config, params, max_batch_size=4, max_seq_len=256,
            block_size=16, prefill_chunk=32, device=DEVICE)
        handle = serve.run(app, name="llm_check", _wait_s=600)
        gpu_held = rt.available_resources().get("GPU")
        with _LaunchCount(fa, fused) as count:
            responses = [handle.remote(r) for r in requests]
            unary = [r.result(timeout_s=600)["tokens"] for r in responses]
            streams = [handle.options(stream=True).generate.remote(r)
                       for r in requests[:2]]
            streamed = [list(s) for s in streams]
            http = _http_generate(port, requests[2])["tokens"]
            torch.cuda.synchronize()
        per_replica = sorted(s.requests for s in served_engine.live)
        gate = threading.Event()
        for server in list(served_engine.live):
            server.stall(gate)
        try:
            handle.options(deadline_s=1.0).remote(requests[0]).result(
                timeout_s=60)
            deadline_error = None
        except Exception as exc:  # noqa: BLE001 — reported and required
            deadline_error = exc
        finally:
            gate.set()
        for server in list(served_engine.live):
            server.unstall()
        queue_us = _queue_round_trips_us()
        serve.shutdown()
        gpu_after = rt.available_resources().get("GPU")
    finally:
        serve.shutdown()
        rt.shutdown()
    del params, app, handle
    torch.cuda.empty_cache()
    allocated_after = torch.cuda.memory_allocated()
    stage = getattr(deadline_error, "stage", None)
    identical = {"handle": unary == expected,
                 "stream": streamed == expected[:2],
                 "http": http == expected[2]}
    result = {
        "config": "llama3_8b widths, 2 layers, float32 (serve_check's)",
        "replicas": 2, "num_gpus_per_replica": 0.5,
        "gpu_available_while_served": gpu_held,
        "requests": {"handle": len(unary), "stream": len(streamed),
                     "http": 1},
        "token_identical": identical,
        "requests_per_replica": per_replica,
        "deadline_error": type(deadline_error).__name__,
        "deadline_stage": stage,
        "queue_chunk_round_trip_us": queue_us,
        "launches": count.counts, "gpu_available_after_shutdown": gpu_after,
        "memory_allocated_before_after": [allocated_before, allocated_after],
        "elapsed_s": time.perf_counter() - start,
    }
    emit("serve_deployment_check", **result)
    require(all(identical.values()),
            f"deployment output differs from full-context decoding: "
            f"{identical}")
    require(gpu_held == 0.0, f"GPU available while 2 x 0.5 replicas hold "
                             f"it: {gpu_held}")
    require(len(per_replica) == 2 and min(per_replica) >= 1,
            f"requests per replica {per_replica}: not both used")
    require(type(deadline_error).__name__ == "TaskTimeoutError"
            and stage == "llm_queue",
            f"the stalled request sealed {deadline_error!r}, not a "
            f"TaskTimeoutError at stage llm_queue")
    require(count.counts["rmsnorm"] > 0, "no RMSNorm launch in the "
                                         "deployment")
    require(gpu_after == 1.0, f"GPU after serve.shutdown(): {gpu_after}")
    require(allocated_after - allocated_before < MEMORY_LEFT_BYTES,
            f"the phase left {allocated_after - allocated_before} bytes "
            f"allocated on the card")
    return count.counts


def phase_serve_deployment(llama, fa, fused, served: dict, runtime: dict,
                           device: dict, power: str) -> dict:
    """The serve phase's configuration and traffic as a deployment: one
    ``num_gpus=1`` replica (``max_ongoing_requests=16``) holding the serve
    phase's bf16 weights, 16 concurrent streamed requests through the
    handle from 16 threads; then the same 16 unary, to separate what the
    streams' chunks cost. Returns the kernels' launches of the streamed
    requests."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.tree import tree_leaves

    start = time.perf_counter()
    allocated_before = torch.cuda.memory_allocated()
    config = serve_config(llama)
    params = served["params"]
    lengths, prompts, temperatures = serve_requests(config)
    served_engine = _served_engine()
    rt.init(num_cpus=8)
    try:
        app = serve.deployment(served_engine).options(
            num_replicas=1, max_ongoing_requests=16,
            ray_actor_options={"num_gpus": 1}).bind(
            config, params, **SERVE_ENGINE, device=DEVICE)
        handle = serve.run(app, name="llm", _wait_s=600)
        same_ptrs = handle.data_ptrs.remote().result(timeout_s=600) == [
            t.data_ptr() for t in tree_leaves(params)]
        warm = handle.remote({"tokens": prompts[0][:32],
                              "max_new_tokens": 2}).result(timeout_s=600)
        require(len(warm["tokens"]) == 2, "warm-up request failed")
        handle.time_steps.remote().result(timeout_s=60)
        stats_before = handle.engine_stats.remote().result(timeout_s=60)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        records = [None] * len(prompts)
        barrier = threading.Barrier(len(prompts))

        def stream(i):
            barrier.wait()
            request = {"tokens": prompts[i],
                       "max_new_tokens": SERVE_NEW_TOKENS,
                       "temperature": temperatures[i]}
            submitted = time.perf_counter()
            tokens, arrivals, error = [], [], None
            try:
                for token in handle.options(stream=True).generate.remote(
                        request):
                    arrivals.append(time.perf_counter())
                    tokens.append(token)
            except Exception as exc:  # noqa: BLE001 — reported and required
                error = repr(exc)
            records[i] = {"tokens": tokens, "arrivals": arrivals,
                          "submitted": submitted, "error": error}

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(len(prompts))]
        with _LaunchCount(fa, fused) as count:
            wall_start = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - wall_start
            torch.cuda.synchronize()
        require(not any(t.is_alive() for t in threads), "a request hung")
        peak = torch.cuda.max_memory_allocated()
        stats_after = handle.engine_stats.remote().result(timeout_s=60)
        steps = handle.step_times.remote().result(timeout_s=60)
        # The same 16 requests unary (no stream, no Queue actor): what
        # the streams' chunks cost beside the router and the replica.
        unary_start = time.perf_counter()
        responses = [handle.remote({"tokens": p,
                                    "max_new_tokens": SERVE_NEW_TOKENS,
                                    "temperature": t})
                     for p, t in zip(prompts, temperatures)]
        unary = [r.result(timeout_s=600)["tokens"] for r in responses]
        unary_wall = time.perf_counter() - unary_start
        unary_decode_s = handle.step_times.remote().result(
            timeout_s=60)["decode_s"][len(steps["decode_s"]):]
        serve.shutdown()
        gpu_after = rt.available_resources().get("GPU")
    finally:
        serve.shutdown()
        rt.shutdown()
    del app, handle
    torch.cuda.empty_cache()
    allocated_after = torch.cuda.memory_allocated()
    stats = {k: stats_after[k] - stats_before[k] for k in stats_after
             if isinstance(stats_after[k], (int, float))
             and not isinstance(stats_after[k], bool)}
    forwards = stats["decode_steps"] + stats["prefill_chunks"]
    ttft = [r["arrivals"][0] - r["submitted"] if r["arrivals"] else None
            for r in records]
    measured = [t for t in ttft if t is not None] or [math.nan]
    gaps = [b - a for r in records
            for a, b in zip(r["arrivals"], r["arrivals"][1:])]
    launches = count.counts["rmsnorm"]
    serve_phase = served["result"]
    keys = ("ttft_s_median", "ttft_s_max", "decode_step_ms_median",
            "output_tokens_per_s", "peak_memory_bytes", "rmsnorm_launches",
            "wall_s")
    errors = [r["error"] for r in records if r["error"]]
    result = {
        "config": "LlamaConfig.llama3_8b() (ray_tpu/models/llama.py:79-83)",
        "dtype": "bfloat16", "replicas": 1, "max_ongoing_requests": 16,
        "engine": SERVE_ENGINE, "requests": len(prompts),
        "prompt_lengths": lengths, "max_new_tokens": SERVE_NEW_TOKENS,
        "temperatures": temperatures, "weights_zero_copy": same_ptrs,
        "ttft_s": ttft, "ttft_s_median": statistics.median(measured),
        "ttft_s_max": max(measured),
        "decode_step_ms_median": 1e3 * statistics.median(steps["decode_s"])
        if steps["decode_s"] else None,
        "decode_steps_timed": len(steps["decode_s"]),
        "prefill_chunk_ms_median": 1e3 * statistics.median(
            steps["prefill_s"]) if steps["prefill_s"] else None,
        "token_gap_ms_median": 1e3 * statistics.median(gaps) if gaps
        else None,
        "unary_pass": {
            "decode_step_ms_median": 1e3 * statistics.median(unary_decode_s)
            if unary_decode_s else None,
            "wall_s": unary_wall,
            "output_tokens_per_s": sum(len(t) for t in unary) / unary_wall},
        "wall_s": wall,
        "output_tokens_per_s": sum(len(r["tokens"]) for r in records) / wall,
        "engine_stats": stats, "rmsnorm_launches": launches,
        "rmsnorm_launches_per_forward": launches / forwards
        if forwards else None,
        "peak_memory_bytes": peak,
        "peak_over_serve_phase": peak / serve_phase["peak_memory_bytes"] - 1,
        "gpu_available_after_shutdown": gpu_after,
        "memory_allocated_before_after": [allocated_before, allocated_after],
        "serve_phase": {k: serve_phase[k] for k in keys},
        "runtime_phase": {k: runtime[k] for k in keys},
        "launches": count.counts, "card": device["kind"],
        "nvidia_smi": power, "elapsed_s": time.perf_counter() - start,
    }
    emit("serve_deployment", **result)
    require(same_ptrs, "the replica's weights are not the caller's tensors")
    require(not errors, f"requests failed: {errors}")
    outputs = [r["tokens"] for r in records] + unary
    short = [len(t) for t in outputs if len(t) != SERVE_NEW_TOKENS]
    require(not short, f"requests sealed with {short} tokens, not "
                       f"{SERVE_NEW_TOKENS}")
    require(all(0 <= t < config.vocab_size for tokens in outputs
                for t in tokens), "a token outside [0, vocab)")
    per_forward = 2 * config.num_layers + 1
    require(launches > 0 and launches == per_forward * forwards,
            f"rmsnorm launched {launches} times over {forwards} forwards, "
            f"not {per_forward} per forward")
    require(abs(result["peak_over_serve_phase"]) <= 0.01,
            f"peak memory {peak}, the serve phase's "
            f"{serve_phase['peak_memory_bytes']}: not within 1%")
    require(gpu_after == 1.0, f"GPU after serve.shutdown(): {gpu_after}")
    require(allocated_after - allocated_before < MEMORY_LEFT_BYTES,
            f"the phase left {allocated_after - allocated_before} bytes "
            f"allocated on the card")
    return count.counts

# ------------------------------------------------------ worker processes

# The card's free memory after a process on it ends: back within this of
# its value before the process started (process_check, process_serve).
PROCESS_FREE_TOL_BYTES = 64 << 20
SPMD_MEAN = float(np.mean(np.arange(8, dtype=np.float32)[:, None] ** 2
                          * np.ones((1, 4))))


def _free_bytes() -> int:
    """The card's free bytes, device-wide (every process's use)."""
    return torch.cuda.mem_get_info()[0]


def _settled_free_bytes() -> int:
    """A phase's baseline of the card's free bytes: taken after this
    process's garbage is collected and its cached blocks released, so
    tensors an earlier phase left in reference cycles (freed whenever
    the collector next runs) cannot move it during the phase."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return _free_bytes()


def _free_back(before: int, tol: float, wait_s: float = 60.0) -> int:
    """The card's free bytes once they are back within ``tol`` of
    ``before`` (the OS frees a dead process's context a moment after it
    exits), or the last reading after ``wait_s``."""
    deadline = time.monotonic() + wait_s
    while True:
        free = _free_bytes()
        if free >= before - tol or time.monotonic() > deadline:
            return free
        time.sleep(0.1)


def _pool_probe(t):
    """A pool task: its pid, the cards it sees, and the tensor it got."""
    import os

    return (os.getpid(), torch.cuda.device_count(),
            os.environ.get("CUDA_VISIBLE_DEVICES"), t.device.type, t)


def _noop():
    return None


class ProcessKernelActor:
    """A ``num_gpus=1`` process actor: what it sees, the ``fwd`` kernel
    on inputs the driver sends, and a crash."""

    def __init__(self):
        import importlib

        torch.zeros(1, device="cuda")  # its own CUDA context, now
        self.fa = importlib.import_module(
            "ray_tpu_torch.ops.flash_attention")

    def info(self, t):
        import os

        return (os.getpid(), torch.cuda.device_count(),
                os.environ.get("CUDA_VISIBLE_DEVICES"), t.device.type, t)

    def fwd(self, q, k, v):
        self.fa.launches["fwd"] = 0
        o, lse = self.fa.flash_fwd_kernel(q, k, v, causal=True)
        torch.cuda.synchronize()
        return o, lse, self.fa.launches["fwd"]

    def norm(self, x, scale):
        """RMSNorm over ``x`` with the kernel: the result, the launches it
        made and the device ``x`` arrived on."""
        import importlib

        fused = importlib.import_module("ray_tpu_torch.ops.fused")
        fused.launches["rmsnorm"] = 0
        with torch.no_grad():
            out = fused.rms_norm(x, scale, RMS_EPS)
        torch.cuda.synchronize()
        return out, fused.launches["rmsnorm"], x.device.type

    def noop(self):
        return None

    def crash(self):
        import os

        os._exit(1)


# An RMSNorm input of 512 KiB: over the 64 KiB inline limit and under the
# 1 MiB arena cap, so it and its result ride the driver's arena; and one
# of 2 MiB, over the cap, for contrast (process_check, node_cluster).
ARENA_NORM_ROWS, ARENA_NORM_COLS, SEGMENT_NORM_ROWS = 32, 4096, 128


def _norm_inputs(rows: int, seed: int):
    gen = torch.Generator(DEVICE).manual_seed(seed)
    x = torch.randn(rows, ARENA_NORM_COLS, generator=gen, device=DEVICE)
    scale = torch.randn(ARENA_NORM_COLS, generator=gen, device=DEVICE)
    return x, scale


# Timed round trips of each size in process_check (the first one's arena
# entries counted).
ARENA_TRIPS = 3


def _arena_norm_round_trip(rt, runtime, fused, actor) -> dict:
    """The driver puts an RMSNorm input and the ``num_gpus=1`` process
    actor norms it with the kernel: at 512 KiB the argument and the
    result each take one arena entry; at 2 MiB neither does (each
    crosses a segment). Each result
    bitwise the driver's own launch; each round trip (put, call, get) in
    ms, after one warm-up call that loads the kernel in the actor."""
    out = {"arena": type(runtime.arena).__name__,
           "arena_module": type(runtime.arena).__module__,
           "arena_name": runtime.arena.name,
           "expected_name": f"/ray_tpu_torch_arena_{os.getpid()}"}
    small, scale = _norm_inputs(2, NODE_SEED)  # 32 KiB: inline
    rt.get(actor.norm.remote(small, scale), timeout=300)
    # The 2 MiB trips first: their frees touch no arena entry, so the
    # count around the first 512 KiB trip is that trip's alone.
    for label, rows in (("2MiB", SEGMENT_NORM_ROWS),
                        ("512KiB", ARENA_NORM_ROWS)):
        x, scale = _norm_inputs(rows, NODE_SEED + rows)
        with torch.no_grad():
            want = fused.rms_norm(x, scale, RMS_EPS)
        torch.cuda.synchronize()
        trips = []
        for trip in range(ARENA_TRIPS):
            before = runtime.arena.stats()
            t0 = time.perf_counter()
            x_ref = rt.put(x)
            result_ref = actor.norm.remote(x_ref, scale)
            got, launched, arrived_on = rt.get(result_ref, timeout=300)
            trips.append(1e3 * (time.perf_counter() - t0))
            after = runtime.arena.stats()
            if trip == 0:
                out[label] = {
                    "input_bytes": x.numel() * x.element_size(),
                    "arena_objects_added": after["num_objects"]
                    - before["num_objects"],
                    "arena_used_bytes_added": after["used_bytes"]
                    - before["used_bytes"],
                    "bitwise": torch.equal(got, want),
                    "on": got.device.type, "arrived_on": arrived_on,
                    "launches": launched}
            else:
                out[label]["bitwise"] &= torch.equal(got, want)
                out[label]["launches"] += launched
            del x_ref, result_ref, got
        out[label]["round_trip_ms"] = trips
        out[label]["round_trip_ms_median"] = statistics.median(trips)
    out["arena_stats"] = runtime.arena.stats()
    return out


def _spmd_mean_loop(config):
    """tests/test_train_spmd.py's global mean on a gloo gang of two
    processes: each rank holds 4 of the 8 rows of arange(8)**2."""
    import torch.distributed as dist

    from ray_tpu_torch import train

    rank = train.get_context().get_world_rank()
    rows = torch.arange(4 * rank, 4 * rank + 4, dtype=torch.float32)
    batch = rows[:, None] * torch.ones(1, 4)
    total = (batch * batch).sum()
    dist.all_reduce(total)
    train.report({"mean": float(total) / 32, "world": dist.get_world_size(),
                  "backend": dist.get_backend()})


def phase_process_check(fa, fused, device: dict, power: str,
                        runtime: dict) -> dict:
    """Real processes on the card's machine, at small shapes:
    ``init(process_workers=2)`` with the driver's native arena; a pool
    task in another pid that sees no card and gets a CUDA bf16 tensor as
    a bitwise CPU copy; a ``num_gpus=1`` process actor that sees its one
    card, gets CUDA tensors on it, runs the ``fwd`` kernel on the
    driver's inputs bitwise as the driver does and the RMSNorm kernel on
    an input the driver put, argument and result through the arena,
    then dies in a call (``ActorDiedError``) and gives the card's memory
    back; a 2-process gloo gang's global mean; the host cost of starting
    a worker of each kind and of an empty call."""
    import os
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch._private.worker_pool import PoolWorker
    from ray_tpu_torch.exceptions import ActorDiedError

    start = time.perf_counter()
    x = torch.randn(256, 512, generator=torch.Generator(DEVICE).manual_seed(5),
                    device=DEVICE).to(torch.bfloat16)
    q, k, v, _ = _inputs(8, 2048, 16, 8, 64, seed=11)
    o_ref, lse_ref = fa.flash_fwd_kernel(q, k, v, causal=True)
    torch.cuda.synchronize()
    rt_runtime = rt.init(num_cpus=8, process_workers=2)
    try:
        pid, cards, visible, kind, back = rt.get(
            rt.remote(_pool_probe).remote(x), timeout=300)
        pool = {"other_pid": pid != os.getpid(), "cards": cards,
                "cuda_visible_devices": visible, "arrived_on": kind,
                "bitwise": torch.equal(back, x.cpu())}
        fork_ms = []
        for i in range(5):
            t0 = time.perf_counter()
            worker = PoolWorker(1000 + i)
            worker.request(("ping",))
            fork_ms.append(1e3 * (time.perf_counter() - t0))
            worker.stop()
        actor_cls = rt.remote(process=True, num_gpus=1)(ProcessKernelActor)
        free_before = _settled_free_bytes()
        # One start timed, this actor's (the script's length).
        t0 = time.perf_counter()
        actor = actor_cls.remote()
        rt.get(actor.noop.remote(), timeout=300)
        boot_ms = [1e3 * (time.perf_counter() - t0)]
        a_pid, a_cards, a_visible, a_kind, a_back = rt.get(
            actor.info.remote(x), timeout=300)
        o, lse, a_launches = rt.get(actor.fwd.remote(q, k, v), timeout=300)
        arena = _arena_norm_round_trip(rt, rt_runtime, fused, actor)
        gpu_actor = {
            "other_pid": a_pid not in (os.getpid(), pid), "cards": a_cards,
            "cuda_visible_devices": a_visible, "arrived_on": a_kind,
            "tensor_back_on": a_back.device.type,
            "bitwise": torch.equal(a_back, x),
            "fwd_output_on": o.device.type, "fwd_launches": a_launches,
            "fwd_bitwise": torch.equal(o, o_ref) and torch.equal(lse, lse_ref)}
        task_us = _round_trips_us(rt, rt.remote(_noop).remote)
        call_us = _round_trips_us(rt, actor.noop.remote)
        try:
            rt.get(actor.crash.remote(), timeout=120)
            crash_error = None
        except Exception as exc:  # noqa: BLE001 — reported and required
            crash_error = exc
        del o, lse, a_back, back
        torch.cuda.empty_cache()
        free_after = _free_back(free_before, PROCESS_FREE_TOL_BYTES)
        # The failed call comes back first; the lease once the runtime
        # has seen the process end.
        _until(lambda: rt.available_resources().get("GPU") == 1.0)
        gpu_after = rt.available_resources().get("GPU")
        with tempfile.TemporaryDirectory() as storage:
            gang = train.MeshTrainer(
                _spmd_mean_loop, dist_config="auto",
                scaling_config=train.ScalingConfig(num_workers=2,
                                                   use_process_workers=True),
                run_config=train.RunConfig(storage_path=storage,
                                           report_timeout_s=120.0)).fit()
    finally:
        rt.shutdown()
    result = {
        "pool_task": pool, "gpu_process_actor": gpu_actor,
        "fwd_shape": [8, 2048, 16, 8, 64], "arena": arena,
        "crash_error": type(crash_error).__name__,
        "free_bytes_before_after": [free_before, free_after],
        "gpu_available_after_crash": gpu_after,
        "gloo_gang": {"error": repr(gang.error) if gang.error else None,
                      **gang.metrics, "expected_mean": SPMD_MEAN},
        "cpu_worker_start_ms": fork_ms,
        "cpu_worker_start_ms_median": statistics.median(fork_ms),
        "gpu_actor_start_ms": boot_ms,
        "gpu_actor_start_ms_median": statistics.median(boot_ms),
        "pool_task_round_trip_us": task_us,
        "process_actor_call_round_trip_us": call_us,
        "thread_runtime_phase": {
            "task_round_trip_us": runtime["task_round_trip_us"],
            "actor_call_round_trip_us": runtime["actor_call_round_trip_us"]},
        "card": device["kind"], "nvidia_smi": power,
        "elapsed_s": time.perf_counter() - start,
    }
    emit("process_check", **result)
    require(pool == {"other_pid": True, "cards": 0,
                     "cuda_visible_devices": "", "arrived_on": "cpu",
                     "bitwise": True}, f"pool task: {pool}")
    # The actor's CUDA_VISIBLE_DEVICES names the leased card (index 0 of
    # the cards this process sees).
    leased = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    require(gpu_actor["other_pid"] and a_cards == 1 and a_visible == leased
            and a_kind == "cuda" and gpu_actor["tensor_back_on"] == "cuda"
            and gpu_actor["bitwise"], f"GPU process actor: {gpu_actor}")
    require(gpu_actor["fwd_output_on"] == "cuda" and a_launches == 1
            and gpu_actor["fwd_bitwise"],
            f"the actor's fwd launch differs from the driver's: {gpu_actor}")
    require(arena["arena"] == "ArenaStore" and arena["arena_module"]
            == "ray_tpu_torch._private.arena_store"
            and arena["arena_name"] == arena["expected_name"],
            f"the driver's arena: {arena}")
    require(arena["512KiB"]["bitwise"] and arena["512KiB"]["on"] == "cuda"
            and arena["512KiB"]["arrived_on"] == "cuda"
            and arena["512KiB"]["launches"] == ARENA_TRIPS
            and arena["512KiB"]["arena_objects_added"] == 2,
            f"RMSNorm's input and result through the arena: {arena}")
    require(arena["2MiB"]["bitwise"]
            and arena["2MiB"]["launches"] == ARENA_TRIPS
            and arena["2MiB"]["arena_objects_added"] == 0,
            f"RMSNorm at 2 MiB (no arena): {arena}")
    require(isinstance(crash_error, ActorDiedError),
            f"the crashed call raised {crash_error!r}, not ActorDiedError")
    require(abs(free_after - free_before) <= PROCESS_FREE_TOL_BYTES,
            f"free memory {free_after} after the actor died, "
            f"{free_before} before it started")
    require(gpu_after == 1.0, f"GPU after the crash: {gpu_after}")
    require(gang.error is None and gang.metrics.get("world") == 2
            and abs(gang.metrics.get("mean", math.nan) - SPMD_MEAN) <= 1e-5,
            f"gloo gang: {result['gloo_gang']}")
    return result


def _process_trainer_loop(config):
    """``_trainer_loop`` in a gang process: every report also carries the
    kernels' launches counted in this process, its peak memory and its
    pid."""
    import importlib
    import os

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    count = _LaunchCount(fa).__enter__()

    def extra():
        return {"launches": {**fa.launches, "flash_bwd": count.bwd_calls[0]},
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "pid": os.getpid()}

    return _trainer_loop({**config, "extra": extra})


def phase_process_trainer(llama, fa, device: dict, power: str,
                          trainer: dict) -> dict:
    """The trainer phase's resumed run again through a process gang: one
    gang process (``use_process_workers=True``, ``dist_config="auto"``, a
    world of one on NCCL) trains bench.py's Llama with DCP saves at 1, 3
    and 5, exits after step 3's report on its first attempt, and the
    next gang resumes from that checkpoint to step 6. Its 7 steps (4 in
    the first process, 3 in the second) are held to the trainer phase's
    losses and grad norms. Cut for the script's length: the straight run
    of 7 steps in one process that earlier runs took first is left out.
    Returns the flash kernels' launches counted in the two processes."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    require(not dist.is_initialized(), "a process group exists already")
    rt.init(num_cpus=8)
    try:
        storage = tempfile.mkdtemp(prefix="chip_smoke_ptrainer_")
        crash = _exit_once(os.path.join(storage, "crashed"))
        free_before = _settled_free_bytes()
        start = time.perf_counter()
        try:
            result = train.MeshTrainer(
                _process_trainer_loop, dist_config="auto",
                train_loop_config={"crash": crash},
                scaling_config=train.ScalingConfig(
                    num_workers=1, use_gpu=True, use_process_workers=True),
                run_config=train.RunConfig(
                    name="resumed", storage_path=storage,
                    checkpoint_config=train.CheckpointConfig(num_to_keep=2),
                    failure_config=train.FailureConfig(
                        max_failures=1))).fit()
            kept = sorted(os.listdir(os.path.join(storage, "resumed")))
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        elapsed = time.perf_counter() - start
        free_after = _free_back(free_before, 0.01 * free_before)
        run = {"error": repr(result.error) if result.error else None,
               "checkpoints_kept": len(kept), "elapsed_s": elapsed,
               "gpu_back": _until(
                   lambda: rt.available_resources().get("GPU") == 1.0),
               "free_bytes_before_after": [free_before, free_after]}
        require(result.error is None,
                f"process trainer: {result.error!r}")
    finally:
        rt.shutdown()
    history = result.metrics_history
    got = np.array([[m["loss"] for m in history],
                    [m["grad_norm"] for m in history]])
    want = np.array([trainer["loss"], trainer["grad_norm"]])
    same_shape = got.shape == want.shape
    diff = np.abs(got - want) if same_shape else None
    ok = bool(same_shape and np.all(
        diff <= MESH_TRAIN_ATOL + MESH_TRAIN_RTOL * np.abs(want)))
    # Each process counts from its loop's start: its last report holds
    # all of its launches.
    last = {}
    for m in history:
        last[m["pid"]] = m["launches"]
    launches: dict = {}
    for counts in last.values():
        for kind, n in counts.items():
            launches[kind] = launches.get(kind, 0) + n
    restored = [{k: m[k] for k in ("step", "restore_s", "resumed_at",
                                   "restored_dtensors_placed", "pid")}
                for m in history if "restore_s" in m]
    # The first step of each process compiles and warms up.
    warm = [m["step_s"] for m in history
            if m["step"] not in (0, 1, TRAINER_CRASH_AFTER + 1)]
    result = {
        "config": "bench.py:50-54", "batch": [8, 2048],
        "scaling": "1 process worker, use_gpu, dist_config='auto' (NCCL, "
                   "world 1)",
        "steps": TRAINER_STEPS, "checkpoint_steps": list(TRAINER_CKPT_STEPS),
        "crash_after_step": TRAINER_CRASH_AFTER,
        "cut": "the straight 7-step run left out (the script's length)",
        "loss": got[0].tolist(), "grad_norm": got[1].tolist(),
        "against_trainer": {
            "max_abs_loss_diff": float(diff[0].max()) if same_shape
            else None,
            "max_abs_grad_norm_diff": float(diff[1].max()) if same_shape
            else None,
            "bitwise": bool(np.array_equal(got, want)),
            "rtol": MESH_TRAIN_RTOL, "atol": MESH_TRAIN_ATOL, "ok": ok},
        "steps_run": [m["step"] for m in history],
        "pids": [m["pid"] for m in history],
        "restored": restored, "launches_in_the_processes": launches,
        "step_s": [m["step_s"] for m in history],
        "step_s_median": statistics.median(warm) if warm else None,
        "trainer_step_s_median": trainer["step_s_median"],
        "save_s": [m["save_s"] for m in history if "save_s" in m],
        "trainer_save_s": trainer["save_s"],
        "process_max_memory_allocated": max(
            m["max_memory_allocated"] for m in history),
        "run": run, "card": device["kind"], "nvidia_smi": power,
    }
    emit("process_trainer", **result)
    require(ok, f"process trainer losses/grad norms {got.tolist()} disagree "
                f"with the trainer phase's {want.tolist()}")
    require(result["steps_run"] == list(range(TRAINER_STEPS)),
            f"the run's steps {result['steps_run']}")
    require(len(restored) == 1 and restored[0]["resumed_at"]
            == TRAINER_CRASH_AFTER + 1
            and restored[0]["restored_dtensors_placed"],
            f"restore: {restored}")
    require(len(set(result["pids"])) == 2,
            f"the run's steps ran in {result['pids']}")
    require(run["checkpoints_kept"] == 2, f"kept {run['checkpoints_kept']}")
    require(run["gpu_back"], "GPU not back after fit()")
    before, after = run["free_bytes_before_after"]
    require(abs(after - before) <= 0.01 * before,
            f"free memory {after} after fit(), {before} before")
    _check_train_launches("process_trainer", launches,
                          bench_config(llama).num_layers, TRAINER_STEPS)
    require(launches == trainer["launches"],
            f"launches in the gang processes {launches}, the trainer "
            f"phase's {trainer['launches']}")
    return launches


class ProcessServeActor(EngineActor):
    """``EngineActor`` in a process of its own: it makes the serve phase's
    weights itself, on its card (never pickled), and counts what the
    phase reads there."""

    def __init__(self, **engine_args):
        from ray_tpu_torch._private.tree import tree_map
        from ray_tpu_torch.models import llama

        config = serve_config(llama)
        params32 = llama.init_params(
            config, torch.Generator(DEVICE).manual_seed(0), DEVICE)
        params = tree_map(lambda t: t.to(torch.bfloat16), params32)
        del params32
        torch.cuda.empty_cache()
        super().__init__(config, params, **engine_args)

    def reset_counters(self) -> None:
        import importlib

        importlib.import_module("ray_tpu_torch.ops.fused").launches[
            "rmsnorm"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def counters(self) -> dict:
        import importlib
        import os

        torch.cuda.synchronize()
        return {"rmsnorm": importlib.import_module(
                    "ray_tpu_torch.ops.fused").launches["rmsnorm"],
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "pid": os.getpid()}


def _stream_requests(rt, actor, prompts, temperatures) -> dict:
    """The requests streamed from ``actor`` at once (after a warm-up
    request and ``time_steps``, counters reset): their records, submit
    times, errors and the wall seconds, the engine's stats over them, the
    actor's counters and its step times."""
    rt.get(actor.time_steps.remote(), timeout=60)
    stats_before = rt.get(actor.stats.remote(), timeout=60)
    rt.get(actor.reset_counters.remote(), timeout=60)
    refs, submitted = [], []
    wall_start = time.perf_counter()
    for prompt, temperature in zip(prompts, temperatures):
        submitted.append(time.perf_counter())
        refs.append(actor.stream.remote(
            {"tokens": prompt, "max_new_tokens": SERVE_NEW_TOKENS,
             "temperature": temperature}))
    records, errors = [], []
    for r in refs:
        try:
            records.append(rt.get(r, timeout=600))
        except Exception as exc:  # noqa: BLE001 — reported and required
            records.append({"tokens": [], "arrivals": []})
            errors.append(repr(exc))
    wall = time.perf_counter() - wall_start
    counters = rt.get(actor.counters.remote(), timeout=60)
    stats_after = rt.get(actor.stats.remote(), timeout=60)
    return {"records": records, "submitted": submitted, "errors": errors,
            "wall": wall, "counters": counters,
            "stats": {k: stats_after[k] - stats_before[k]
                      for k in stats_after},
            "steps": rt.get(actor.step_times.remote(), timeout=60)}


def _serving_summary(streamed: dict, temperatures: list,
                     served_tokens: list) -> dict:
    """The serve metrics of ``_stream_requests``' run: TTFT (both
    processes read the host's monotonic clock), the decode step, output
    tokens/s, peak memory, RMSNorm launches, and token identity with the
    serve phase."""
    records, stats = streamed["records"], streamed["stats"]
    ttft = [r["arrivals"][0] - t if r["arrivals"] else None
            for r, t in zip(records, streamed["submitted"])]
    measured = [t for t in ttft if t is not None] or [math.nan]
    outputs = [r["tokens"] for r in records]
    greedy = [i for i, t in enumerate(temperatures) if t == 0.0]
    steps = streamed["steps"]
    forwards = stats["decode_steps"] + stats["prefill_chunks"]
    launches = streamed["counters"]["rmsnorm"]
    return {
        "greedy_token_identical": all(outputs[i] == served_tokens[i]
                                      for i in greedy),
        "sampled_token_identical": [outputs[i] == served_tokens[i]
                                    for i in range(len(outputs))
                                    if i not in greedy],
        "short_outputs": [len(t) for t in outputs
                          if len(t) != SERVE_NEW_TOKENS],
        "ttft_s": ttft, "ttft_s_median": statistics.median(measured),
        "ttft_s_max": max(measured),
        "decode_step_ms_median": 1e3 * statistics.median(steps["decode_s"])
        if steps["decode_s"] else None,
        "prefill_chunk_ms_median": 1e3 * statistics.median(
            steps["prefill_s"]) if steps["prefill_s"] else None,
        "wall_s": streamed["wall"],
        "output_tokens_per_s": sum(len(t) for t in outputs)
        / streamed["wall"],
        "engine_stats": stats, "forwards": forwards,
        "rmsnorm_launches": launches,
        "rmsnorm_launches_per_forward": launches / forwards
        if forwards else None,
        "peak_memory_bytes": streamed["counters"]["peak_memory_bytes"]}


SERVE_SUMMARY_KEYS = ("ttft_s_median", "ttft_s_max", "decode_step_ms_median",
                      "output_tokens_per_s", "peak_memory_bytes",
                      "rmsnorm_launches", "wall_s")


def phase_process_serve(llama, served: dict, served_tokens: list,
                        runtime: dict, device: dict, power: str) -> dict:
    """The runtime phase's serving actor as a ``num_gpus=1`` process actor
    (its class from ``__main__``, sent by value), Llama-3-8B in bf16 made
    in the actor's process from the serve phase's seed, serving the serve
    phase's 16 requests. Returns the RMSNorm launches counted there and
    the serve metrics the node_cluster phase reports beside its own."""
    import os

    import ray_tpu_torch as rt

    start = time.perf_counter()
    config = serve_config(llama)
    lengths, prompts, temperatures = serve_requests(config)
    free_before = _settled_free_bytes()
    rt.init(num_cpus=8)
    try:
        boot = time.perf_counter()
        actor = rt.remote(process=True, num_gpus=1, max_concurrency=16)(
            ProcessServeActor).remote(**SERVE_ENGINE, device=DEVICE)
        warm = rt.get(actor.generate.remote(
            {"tokens": prompts[0][:32], "max_new_tokens": 2}), timeout=900)
        boot_s = time.perf_counter() - boot
        require(len(warm["tokens"]) == 2, "warm-up request failed")
        streamed = _stream_requests(rt, actor, prompts, temperatures)
        rt.get(actor.shutdown.remote(), timeout=60)
        rt.kill(actor)
        gpu_after = rt.available_resources().get("GPU")
    finally:
        rt.shutdown()
    free_after = _free_back(free_before, PROCESS_FREE_TOL_BYTES)
    counters = streamed["counters"]
    summary = _serving_summary(streamed, temperatures, served_tokens)
    forwards, launches = summary["forwards"], summary["rmsnorm_launches"]
    result = {
        "config": "LlamaConfig.llama3_8b() (ray_tpu/models/llama.py:79-83)",
        "dtype": "bfloat16", "actor": "process=True, num_gpus=1, "
                                      "max_concurrency=16",
        "engine": SERVE_ENGINE, "requests": len(prompts),
        "prompt_lengths": lengths, "max_new_tokens": SERVE_NEW_TOKENS,
        "temperatures": temperatures,
        "actor_pid_not_driver": counters["pid"] != os.getpid(),
        "actor_start_and_warm_up_s": boot_s, **summary,
        "peak_over_serve_phase": counters["peak_memory_bytes"]
        / served["peak_memory_bytes"] - 1,
        "gpu_available_after_kill": gpu_after,
        "free_bytes_before_after": [free_before, free_after],
        "serve_phase": {k: served[k] for k in SERVE_SUMMARY_KEYS},
        "runtime_phase": {k: runtime[k] for k in SERVE_SUMMARY_KEYS},
        "card": device["kind"], "nvidia_smi": power,
        "elapsed_s": time.perf_counter() - start,
    }
    emit("process_serve", **result)
    require(result["actor_pid_not_driver"], "the actor ran in the driver")
    require(not streamed["errors"],
            f"requests failed: {streamed['errors']}")
    short = summary["short_outputs"]
    require(not short, f"requests sealed with {short} tokens, not "
                       f"{SERVE_NEW_TOKENS}")
    require(result["greedy_token_identical"],
            "the process actor's greedy outputs differ from the serve "
            "phase's")
    per_forward = 2 * config.num_layers + 1
    require(launches > 0 and launches == per_forward * forwards,
            f"rmsnorm launched {launches} times in the actor's process over "
            f"{forwards} forwards, not {per_forward} per forward")
    require(abs(result["peak_over_serve_phase"]) <= 0.01,
            f"peak memory {counters['peak_memory_bytes']}, the serve "
            f"phase's {served['peak_memory_bytes']}: not within 1%")
    require(gpu_after == 1.0, f"GPU after the kill: {gpu_after}")
    require(abs(free_after - free_before) <= PROCESS_FREE_TOL_BYTES,
            f"free memory {free_after} after the kill, {free_before} "
            f"before the actor started")
    return {"rmsnorm": launches,
            "summary": {**{k: result[k] for k in SERVE_SUMMARY_KEYS},
                        "actor_start_and_warm_up_s": boot_s}}


# The store_recovery phase: the managed spill tier, lineage recovery and
# the memory monitor.
STORE_BUDGET_BYTES = 2 << 30
STORE_STEPS = 3
# tests/test_recovery.py:15-16's fast health checks.
STORE_HEALTH = {"health_check_period_ms": 50,
                "health_check_failure_threshold": 3}
LOST_SHAPE = (8, 2048, 16, 8, 64)  # B, L, H, KV heads, D
LOST_SEED = 12
TORN_BUDGET_BYTES = 48 << 20  # under the fwd output as f32 (67 MB)
KICK_BUDGET_BYTES = 256 << 20
KICK_OBJECT_FLOATS = 50 << 20  # 200 MiB: under the high watermark
STORE_WAIT_S = 120.0


def _lost_inputs(seed: int):
    """q, k, v at LOST_SHAPE (bf16) and an RMSNorm scale [H * D] (f32),
    made on the card from a CUDA generator seed."""
    b, l, h, kvh, d = LOST_SHAPE
    gen = torch.Generator(DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(
            torch.bfloat16)

    q, k, v = randn(b, l, h, d), randn(b, l, kvh, d), randn(b, l, kvh, d)
    scale = 1.0 + 0.1 * torch.randn(h * d, generator=gen, device=DEVICE)
    return q, k, v, scale


def _lost_attention(seed: int):
    """A task: the ``fwd`` kernel's output and LSE on inputs it makes on
    its card from ``seed``."""
    import importlib

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    q, k, v, _ = _lost_inputs(seed)
    return fa.flash_fwd_kernel(q, k, v, causal=True)


def _lost_norm(o, seed: int):
    """A task: the RMSNorm kernel over the ``fwd`` output viewed as
    [B * L, H * D]."""
    import importlib

    fused = importlib.import_module("ray_tpu_torch.ops.fused")
    scale = _lost_inputs(seed)[3]
    b, l, h, _, d = LOST_SHAPE
    return fused.rms_norm_kernel(o.view(b * l, h * d), scale, RMS_EPS)


def _host_attention(seed: int):
    """A task: the ``fwd`` output as f32 in host memory (67 MB)."""
    return _lost_attention(seed)[0].float().cpu()


def _oom_target(path: str):
    """A pool task: its first attempt holds 64 MiB, which makes its worker
    the largest (the one the monitor kills: without it the two workers'
    RSS can tie to the page), and sleeps to be killed; the retry
    returns."""
    import os

    if not os.path.exists(path):
        ballast = b"\1" * (64 << 20)  # written: in the worker's RSS
        with open(path, "w") as f:
            f.write("1")
        time.sleep(60)
        return "slow-path" if ballast else None
    return "retried-ok"


def _tree_bytes(tree) -> int:
    from ray_tpu_torch._private.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _settle_spiller(runtime, mgr, quiet_s: float = 1.0) -> None:
    """Wait until the store's host bytes are under the high watermark and
    no spill has landed for ``quiet_s``."""
    last, since = None, time.monotonic()
    deadline = since + STORE_WAIT_S
    while time.monotonic() < deadline:
        now = (runtime.spill_stats()["spills"], runtime.store._host_used())
        if now != last:
            last, since = now, time.monotonic()
        elif now[1] <= mgr.high_bytes() \
                and time.monotonic() - since >= quiet_s:
            return
        time.sleep(0.05)
    raise RuntimeError(f"the spiller did not settle: {last}")


def _gbps(rows) -> list[float]:
    return [size / seconds / 1e9 for size, seconds in rows if seconds > 0]


def _store_spill(llama, train_step, fa, device: dict, power: str) -> dict:
    """(a) bench.py's TrainState (params and AdamW's moments, f32, from
    seed 0) copied to host memory, its three trees ``put`` into a store
    of 2 GiB; the spiller takes them past the high watermark, ``get``
    restores each after checking its file, and 3 steps from the state
    put back on the card are held bitwise to 3 steps from the state that
    never left it, on the same batch. The state on the card, ``put``
    into the same store, is charged as device bytes and never spilled.
    Returns the record and the restored run's launches."""
    import resource

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.parallel.train_step import TrainState

    config, params, optimizer, step = _bench_training(llama, train_step)
    state = train_step.create_train_state(params, optimizer)
    del params
    batch = train_step.place_batch(_bench_batch(config, 8, 2048))
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    count, step_no = state.opt_state["count"], state.step
    tree_bytes = {name: _tree_bytes(tree) for name, tree in trees.items()}
    torch.cuda.synchronize()
    start = time.perf_counter()
    host = {name: tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
            for name, tree in trees.items()}
    d2h_s = time.perf_counter() - start
    del trees
    torch.cuda.reset_peak_memory_stats()
    straight = [], []
    for _ in range(STORE_STEPS):
        state, metrics = step(state, batch)
        straight[0].append(metrics["loss"].item())
        straight[1].append(metrics["grad_norm"].item())
    del state
    torch.cuda.empty_cache()

    rt.init(num_cpus=8, object_store_memory=STORE_BUDGET_BYTES)
    try:
        runtime = rt._private.worker.global_runtime()
        mgr = runtime.store._spill
        require(mgr is not None, "the managed spill tier is not armed")
        refs = {}
        start = time.perf_counter()
        for name in ("params", "mu", "nu"):
            refs[name] = rt.put(host.pop(name))
        put_s = time.perf_counter() - start
        # The spiller runs off the put: wait until it has settled under
        # the high watermark (no spill for a second).
        _settle_spiller(runtime, mgr)
        spilled_after_put = runtime.spill_stats()
        files = [p for p in os.listdir(mgr.spill_dir)
                 if p.endswith(".spill")]
        headers = []
        for name in files:
            with open(os.path.join(mgr.spill_dir, name), "rb") as f:
                headers.append(f.read(4))
        on_disk = sorted(name for name, ref in refs.items()
                         if runtime.store._entries[ref.id()].spilled_path)
        restored, get_s = {}, {}
        for name in ("params", "mu", "nu"):
            ref = refs.pop(name)
            start = time.perf_counter()
            value = rt.get(ref)
            get_s[name] = time.perf_counter() - start
            restored[name] = tree_map(lambda t: t.to(DEVICE), value)
            # Freed at once, so the next restore does not push it out.
            runtime.free([ref])
            del value, ref
        torch.cuda.synchronize()
        state = TrainState(
            params=tree_map(lambda t: t.requires_grad_(),
                            restored.pop("params")),
            opt_state={"count": count, "mu": restored.pop("mu"),
                       "nu": restored.pop("nu")}, step=step_no)
        again = [], []
        with _LaunchCount(fa) as launched:
            for _ in range(STORE_STEPS):
                state, metrics = step(state, batch)
                again[0].append(metrics["loss"].item())
                again[1].append(metrics["grad_norm"].item())
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # The state on the card through the same store: device bytes,
        # never a victim, even of a forced pass.
        device_before = runtime.store.stats()["device_bytes"]
        spills_before = runtime.spill_stats()["spills"]
        on_card = rt.put(state)
        mgr.spill_pass(force=True)
        entry = runtime.store._entries[on_card.id()]
        a_victim = on_card.id() in runtime.store._spill_victims(1 << 62)
        device_charged = runtime.store.stats()["device_bytes"] \
            - device_before
        state_bytes = _tree_bytes(state.params) \
            + _tree_bytes(state.opt_state["mu"]) \
            + _tree_bytes(state.opt_state["nu"])
        device_row = {
            "charged": device_charged, "state_bytes": state_bytes,
            "on_device": entry.on_device,
            "spilled": entry.spilled_path is not None,
            "spills_during": runtime.spill_stats()["spills"] - spills_before,
            "a_victim": a_victim,
            "same_object": rt.get(on_card) is state}
        del on_card, entry
        stats = runtime.spill_stats()
        timings = mgr.timings()
    finally:
        rt.shutdown()
    result = {
        "tree_bytes": tree_bytes, "store_budget_bytes": STORE_BUDGET_BYTES,
        "high_watermark_bytes": int(STORE_BUDGET_BYTES * 0.85),
        "d2h_s": d2h_s, "put_s": put_s,
        "spilled_after_put": spilled_after_put["spills"],
        "on_disk_after_put": on_disk, "spill_headers": sorted(
            h.decode("ascii", "replace") for h in headers),
        "spills": stats["spills"], "restores": stats["restores"],
        "spilled_bytes": stats["spilled_bytes"],
        "restored_bytes": stats["restored_bytes"],
        "disk_full": stats["disk_full"],
        "torn_restores": stats["torn_restores"],
        "restore_p50_ms": stats["restore_p50_ms"],
        "spill_gb_per_s": _gbps(timings["spill"]),
        "restore_read_gb_per_s": _gbps(timings["restore"]),
        "get_s": get_s,
        "get_gb_per_s": {name: tree_bytes[name] / s / 1e9
                         for name, s in get_s.items()},
        "loss": again[0], "grad_norm": again[1],
        "loss_straight": straight[0], "grad_norm_straight": straight[1],
        "bitwise": again == straight, "device_state": device_row,
        "peak_memory_bytes": peak,
        "process_peak_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "launches": launched.counts, "card": device["kind"],
        "nvidia_smi": power}
    require(stats["disk_full"] == 0,
            f"the spill disk was full {stats['disk_full']} times (backoff)")
    require(spilled_after_put["spills"] >= 2 and len(on_disk) >= 2,
            f"{spilled_after_put['spills']} spills after the puts, "
            f"{on_disk} on disk: expected at least 2 of 3")
    require(headers and all(h == b"RTS1" for h in headers),
            f"spill files without the RTS1 header: {headers}")
    require(stats["restores"] >= len(on_disk) and stats["torn_restores"] == 0,
            f"restores {stats['restores']}, torn {stats['torn_restores']}")
    require(result["bitwise"], f"steps from the restored state differ: "
                               f"{again} against {straight}")
    require(device_row["charged"] == state_bytes + 128
            and device_row["on_device"] and not device_row["spilled"]
            and device_row["spills_during"] == 0
            and not device_row["a_victim"] and device_row["same_object"],
            f"the state on the card was not kept as device bytes: "
            f"{device_row}")
    _check_train_launches("store_recovery (a)", launched.counts,
                          config.num_layers, STORE_STEPS)
    return result


def _task_event(runtime, name: str):
    events = [e for e in runtime.gcs.list_task_events() if e.name == name]
    require(len(events) == 1, f"{len(events)} events for task {name}")
    return events[0]


def _store_lineage(fa, fused) -> dict:
    """(b) The ``fwd`` kernel's output and LSE, and RMSNorm over the
    output, made by two ``num_gpus=1`` tasks pinned softly to a node with
    a card; the node is killed, its death detected, and both results are
    rebuilt from lineage on the head's card, bitwise. A ``put`` object
    recorded on the node has no lineage: ObjectLostError."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import ObjectLostError
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    torch.cuda.synchronize()
    alloc_before = _allocated()
    rt.init(num_cpus=8, system_config=dict(STORE_HEALTH))
    try:
        runtime = rt._private.worker.global_runtime()
        gpu_head = rt.cluster_resources().get("GPU")
        node_b = runtime.add_node({"CPU": 2.0, "GPU": 1.0})
        gpu_two = rt.available_resources().get("GPU")
        affinity = NodeAffinitySchedulingStrategy(node_b.hex(), soft=True)
        attention = rt.remote(num_gpus=1, num_returns=2,
                              scheduling_strategy=affinity)(_lost_attention)
        norm = rt.remote(num_gpus=1,
                         scheduling_strategy=affinity)(_lost_norm)
        with _LaunchCount(fa, fused) as first:
            o_ref, lse_ref = attention.remote(LOST_SEED)
            n_ref = norm.remote(o_ref, LOST_SEED)
            o, lse, n = rt.get([o_ref, lse_ref, n_ref], timeout=STORE_WAIT_S)
            torch.cuda.synchronize()
        placed = [_task_event(runtime, "_lost_attention").node_id,
                  _task_event(runtime, "_lost_norm").node_id]
        clones = [t.clone() for t in (o, lse, n)]
        devices = [t.device.type for t in (o, lse, n)]
        del o, lse, n
        orphan = rt.put(torch.zeros(4))
        runtime._record_location(orphan.id(), node_b)
        with _LaunchCount(fa, fused) as rebuild:
            wall_kill = time.time()
            runtime.kill_node(node_b)
            # Read every millisecond: the rebuild takes about as long.
            deadline = time.monotonic() + STORE_WAIT_S
            while [n for n in runtime.gcs.list_nodes()
                   if n.node_id == node_b][0].alive:
                require(time.monotonic() < deadline,
                        "the node's death was not detected")
                time.sleep(0.001)
            wall_dead = time.time()
            o2, lse2 = rt.get([o_ref, lse_ref], timeout=STORE_WAIT_S)
            n2 = rt.get(n_ref, timeout=STORE_WAIT_S)
            torch.cuda.synchronize()
        events = [_task_event(runtime, "_lost_attention"),
                  _task_event(runtime, "_lost_norm")]
        bitwise = [torch.equal(a, b) for a, b in zip((o2, lse2, n2), clones)]
        lost = None
        try:
            rt.get(orphan, timeout=STORE_WAIT_S)
        except ObjectLostError as exc:
            lost = type(exc).__name__
        rebuilds = runtime.stats()["lineage_rebuilds"]
        del o2, lse2, n2, o_ref, lse_ref, n_ref, orphan, clones
        gpu_back = _until(lambda: rt.available_resources().get("GPU")
                          == rt.cluster_resources().get("GPU") == gpu_head)
        head_cards = dict(runtime.cluster.get_node(
            runtime.head_node_id).cards.free)
    finally:
        rt.shutdown()
    alloc_after = _allocated()
    head = runtime.head_node_id.hex()
    result = {
        "shape": list(LOST_SHAPE), "placed_first": placed,
        "node_b": node_b.hex(), "head": head, "devices": devices,
        "gpu_before_after_node": [gpu_head, gpu_two],
        # Each result's time from its rebuilt task's FINISHED event.
        "kill_to_detect_s": wall_dead - wall_kill,
        "detect_to_fwd_result_s": events[0].end_time - wall_dead,
        "detect_to_norm_result_s": events[1].end_time - wall_dead,
        "rebuilt_on": [e.node_id for e in events],
        "rebuild_order_ok": events[0].end_time <= events[1].start_time
        and events[0].start_time >= wall_kill,
        "bitwise": bitwise, "lineage_rebuilds": rebuilds,
        "put_without_lineage": lost,
        "launches_first": first.counts, "launches_rebuild": rebuild.counts,
        "gpu_back": gpu_back, "head_cards_free": head_cards,
        "allocated_before_after": [alloc_before, alloc_after]}
    require(placed == [node_b.hex()] * 2
            and devices == [torch.device(DEVICE).type] * 3,
            f"the tasks did not run on the node's card: {placed}, "
            f"{devices}")
    require(result["rebuilt_on"] == [head, head]
            and result["rebuild_order_ok"],
            f"the rebuild did not run on the head, fwd before RMSNorm: "
            f"{events}")
    require(all(bitwise), f"rebuilt results differ: {bitwise}")
    require(rebuilds == 2, f"lineage_rebuilds {rebuilds}, expected 2")
    require(first.counts["fwd"] == 1 and first.counts["rmsnorm"] == 1
            and rebuild.counts["fwd"] == 1
            and rebuild.counts["rmsnorm"] == 1,
            f"launches {first.counts} then {rebuild.counts}: expected one "
            f"fwd and one RMSNorm each")
    require(lost == "ObjectLostError",
            f"a put object on the dead node gave {lost}")
    require(gpu_back and head_cards == {0: 1.0},
            f"GPU not back on the head: {head_cards}")
    require(abs(alloc_after - alloc_before) <= 0.01 * alloc_before,
            f"allocation {alloc_before} -> {alloc_after}")
    return result


def _store_torn(fa) -> dict:
    """(c) A ``num_gpus=1`` task's result (the ``fwd`` output as f32 on
    the host, 67 MB) in a store of 48 MiB is spilled; its file is torn
    (truncated) and the ``get`` rebuilds it by re-running the task on the
    card, bitwise the driver's own launch on the same inputs."""
    import ray_tpu_torch as rt

    q, k, v, _ = _lost_inputs(LOST_SEED)
    want = fa.flash_fwd_kernel(q, k, v, causal=True)[0].float().cpu()
    del q, k, v
    rt.init(num_cpus=8, object_store_memory=TORN_BUDGET_BYTES)
    try:
        runtime = rt._private.worker.global_runtime()
        task = rt.remote(num_gpus=1)(_host_attention)
        with _LaunchCount(fa) as launched:
            ref = task.remote(LOST_SEED)
            # The entry appears at the submit ring's flush.
            require(_until(lambda: getattr(runtime.store._entries.get(
                ref.id()), "spilled_path", None) is not None, STORE_WAIT_S),
                    "the host result was not spilled")
            path = runtime.store._entries[ref.id()].spilled_path
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size // 2)
            start = time.perf_counter()
            got = rt.get(ref, timeout=STORE_WAIT_S)
            rebuild_s = time.perf_counter() - start
        stats = runtime.spill_stats()
        result = {
            "result_bytes": want.numel() * 4,
            "store_budget_bytes": TORN_BUDGET_BYTES, "file_bytes": size,
            "bitwise": torch.equal(got, want),
            "num_torn_recoveries": runtime.recovery.num_torn_recoveries,
            "torn_restores": stats["torn_restores"],
            "torn_file_gone": not os.path.exists(path),
            "torn_get_to_result_s": rebuild_s,
            "launches": launched.counts}
        del got, ref
    finally:
        rt.shutdown()
    require(result["bitwise"], "the rebuilt result differs")
    require(result["num_torn_recoveries"] == 1
            and result["torn_restores"] == 1,
            f"torn recoveries {result['num_torn_recoveries']}, torn "
            f"restores {result['torn_restores']}: expected 1")
    require(result["torn_file_gone"], f"the torn file {path} is left")
    require(launched.counts["fwd"] == 2,
            f"fwd launches {launched.counts['fwd']}: expected the task's "
            f"and its rebuild's")
    return result


def _store_memory(fa) -> dict:
    """(d) A memory monitor at threshold 0 kills the largest of 2 pool
    workers under a task with ``max_retries=0``, which is retried on the
    OOM budget and returns. Under ``admission_memory_watermark=0.9``: a
    usage of 0.95 sheds a deadline-armed ``num_gpus=1`` task with
    SystemOverloadedError; the store's share of it admits the task and
    kicks the spiller (a 200 MiB object in a 256 MiB store goes to disk);
    without either the task runs the ``fwd`` kernel, bitwise the
    driver's launch. The card's free bytes end where they began."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import memory_monitor
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.exceptions import SystemOverloadedError

    q, k, v, _ = _lost_inputs(LOST_SEED)
    want = fa.flash_fwd_kernel(q, k, v, causal=True)[0]
    del q, k, v
    free_before = _settled_free_bytes()
    marker = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_oom_"),
                          "attempted")
    rt.init(num_cpus=8, process_workers=2,
            object_store_memory=KICK_BUDGET_BYTES,
            system_config={"memory_monitor_refresh_ms": 0})
    try:
        runtime = rt._private.worker.global_runtime()
        workers = [w.proc.pid for w in runtime.worker_pool.live_workers()]
        killer = memory_monitor.MemoryMonitor(runtime, threshold=0.0)
        runtime.memory_monitor = killer
        ref = rt.remote(max_retries=0)(_oom_target).remote(marker)

        rss_at_kill: dict = {}

        def shoot():
            _until(lambda: os.path.exists(marker), STORE_WAIT_S)
            time.sleep(0.5)  # the first attempt is in its sleep
            rss_at_kill.update({pid: memory_monitor.process_rss_bytes(pid)
                                for pid in workers})
            killer.check_once()

        shooter = threading.Thread(target=shoot)
        shooter.start()
        retried = rt.get(ref, timeout=STORE_WAIT_S)
        shooter.join(timeout=STORE_WAIT_S)
        killed = [pid in workers for pid in killer.killed_pids]

        fwd = rt.remote(num_gpus=1)(_lost_attention)
        GLOBAL_CONFIG.update({"admission_memory_watermark": 0.9})
        shed_before = runtime.stats()["admission_shed"]
        memory_monitor._set_usage_override(0.95)
        try:
            try:
                # Shed at the submit ring's flush: the error is sealed on
                # the ref.
                rt.get(fwd.options(_deadline_s=60).remote(LOST_SEED),
                       timeout=STORE_WAIT_S)
                shed = None
            except SystemOverloadedError as exc:
                shed = type(exc).__name__
            kick = rt.put(torch.ones(KICK_OBJECT_FLOATS))
            spills_before = runtime.spill_stats()["spills"]
            memory_monitor._set_store_fraction_override(0.5)
            kind = memory_monitor.memory_pressure_kind(0.9)
            with _LaunchCount(fa) as admitted:
                o_store = rt.get(fwd.options(_deadline_s=60).remote(
                    LOST_SEED), timeout=STORE_WAIT_S)[0]
            kicked = _until(lambda: runtime.spill_stats()["spills"]
                            > spills_before, STORE_WAIT_S)
        finally:
            memory_monitor._set_usage_override(None)
            memory_monitor._set_store_fraction_override(None)
        with _LaunchCount(fa) as plain:
            o_plain = rt.get(fwd.options(_deadline_s=60).remote(
                LOST_SEED), timeout=STORE_WAIT_S)[0]
        result = {
            "workers": len(workers), "kills": killer.num_kills,
            # The statm RSS of the worker killed and of the other one,
            # read just before the monitor's check.
            "worker_rss_bytes_at_kill": {
                "killed": [rss_at_kill.get(pid) for pid in workers
                           if pid in killer.killed_pids],
                "other": [rss_at_kill.get(pid) for pid in workers
                          if pid not in killer.killed_pids]},
            "killed_a_pool_worker": killed, "oom_retried": retried,
            "shed": shed, "shed_counted": runtime.stats()["admission_shed"]
            - shed_before, "store_kind": kind,
            "store_admitted_bitwise": torch.equal(o_store, want),
            "spiller_kicked": kicked,
            "no_override_bitwise": torch.equal(o_plain, want),
            "launches": {"fwd": admitted.counts["fwd"]
                         + plain.counts["fwd"]}}
        del o_store, o_plain, kick, ref
    finally:
        rt.shutdown()
        GLOBAL_CONFIG.reset()
    del want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_after = _free_back(free_before, PROCESS_FREE_TOL_BYTES)
    result["free_bytes_before_after"] = [free_before, free_after]
    require(retried == "retried-ok" and killer.num_kills == 1
            and killed == [True],
            f"the OOM-killed task: {retried!r}, kills {killer.num_kills}")
    require(shed == "SystemOverloadedError" and result["shed_counted"] == 1,
            f"usage 0.95 over the watermark did not shed: {shed}")
    require(kind == "store" and result["store_admitted_bitwise"] and kicked,
            f"store pressure: kind {kind}, kicked {kicked}")
    require(result["no_override_bitwise"], "the admitted fwd task differs")
    require(free_after >= free_before - PROCESS_FREE_TOL_BYTES,
            f"free card bytes {free_before} -> {free_after}")
    return result


def phase_store_recovery(llama, train_step, fa, fused, device: dict,
                         power: str) -> dict:
    """The managed spill tier, lineage recovery and the memory monitor on
    the card: (a) bench.py's TrainState spilled through the store and
    restored bitwise, (b) a lost ``fwd`` result and the RMSNorm over it
    rebuilt from lineage after their node's death, (c) a torn spill file
    rebuilt by re-running its task, (d) an OOM kill retried and the
    memory watermark's shed and store pressure. Returns the kernels'
    launches over the four parts."""
    phase_start = time.perf_counter()
    spill = _store_spill(llama, train_step, fa, device, power)
    torch.cuda.empty_cache()
    lineage = _store_lineage(fa, fused)
    torn = _store_torn(fa)
    memory = _store_memory(fa)
    launches = dict(spill["launches"])
    launches["fwd"] += lineage["launches_first"]["fwd"] \
        + lineage["launches_rebuild"]["fwd"] + torn["launches"]["fwd"] \
        + memory["launches"]["fwd"]
    launches["rmsnorm"] = lineage["launches_first"]["rmsnorm"] \
        + lineage["launches_rebuild"]["rmsnorm"]
    emit("store_recovery", spill=spill, lineage=lineage, torn=torn,
         memory=memory, launches=launches,
         phase_s=time.perf_counter() - phase_start, card=device["kind"],
         nvidia_smi=power)
    return launches


# The node_cluster phase: worker-node daemons, the head and remote actors.
NODE_SEED = 31
NODE_HEARTBEAT_TIMEOUT_S = 5.0  # tests/test_remote_actors.py's fixture
NODE_WAIT_S = 300.0
NODE_FREE_TOL_BYTES = 64 << 20
# The serve phase's first 8 requests (all greedy): one batch of the
# engine, cut from 16 to keep the script near half its time limit.
NODE_REQUESTS = 8


def _node_attention(seed: int):
    """A node task: the flash forward and backward at LOST_SHAPE (the
    training shape, bf16) on inputs made on its card from ``seed``: o,
    dq, dk, dv, and the launches it made."""
    import importlib

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    q, k, v, _ = _lost_inputs(seed)
    do = torch.randn(q.shape, generator=torch.Generator(DEVICE).manual_seed(
        seed + 1), device=DEVICE).to(torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    with _LaunchCount(fa) as launched:
        o = fa.flash_attention(q, k, v, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
    return o.detach(), q.grad, k.grad, v.grad, launched.counts


def _node_norm(o, seed: int):
    """A node task: RMSNorm over the flash output as [B * L, H * D] in
    f32, and the launches it made."""
    import importlib

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    fused = importlib.import_module("ray_tpu_torch.ops.fused")
    b, l, h, _, d = LOST_SHAPE
    scale = _lost_inputs(seed)[3]
    with _LaunchCount(fa, fused) as launched, torch.no_grad():
        out = fused.rms_norm(o.float().reshape(b * l, h * d), scale, RMS_EPS)
        torch.cuda.synchronize()
    return out, launched.counts


def _pid_gone(pid: int) -> bool:
    """No such process, or only its zombie (its parent died first)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _parent(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def _plane_on() -> bool:
    """Whether the same-host plane is armed in this process (the
    reference's ``same_host_plane`` knob; ``RAY_TPU_TORCH_SAME_HOST_PLANE=0``
    turns it off, in the daemons too)."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return bool(GLOBAL_CONFIG.same_host_plane)


def _rate_gbps(nbytes: float, seconds: float) -> float | None:
    return nbytes / seconds / 1e9 if seconds > 0 else None


def _get_paths(before: dict, after: dict) -> dict:
    """The driver's reads of nodes' results between two
    ``remote_get_stats()``: per path, reads, bytes, seconds and GB/s."""
    out = {}
    for path in ("mapped", "chunked"):
        d = {k: after[path][k] - before[path][k]
             for k in ("gets", "bytes", "seconds")}
        d["gb_per_s"] = _rate_gbps(d["bytes"], d["seconds"])
        out[path] = d
    out["spilled_plans"] = after["spilled_plans"] - before["spilled_plans"]
    return out


def _node_kernels(rt, runtime, handles: dict, ids: dict) -> tuple:
    """(a) The flash forward and backward in a ``num_gpus=1`` task pinned
    to node A, RMSNorm over its output in one pinned to B, never through
    the driver, and everything bitwise the driver's own launches on the
    same seeds. With the same-host plane armed (the default) the output
    moves A to B by one copy out of A's segment under a lease A grants
    and B releases, A serving no chunk, and the driver reads the results
    the same way; with it off, by the chunked pull."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    def pinned(node: str):
        return NodeAffinitySchedulingStrategy(ids[node].hex(), soft=False)

    plane = _plane_on()
    want_o, want_dq, want_dk, want_dv, _ = _node_attention(NODE_SEED)
    want_n, _ = _node_norm(want_o, NODE_SEED)
    exports_before = runtime._export_store.stats()["num_blobs"]
    before_a = handles["A"].pool.call("executor_stats")
    before_b = handles["B"].pool.call("executor_stats")
    start = time.perf_counter()
    o_ref, dq_ref, dk_ref, dv_ref, counts_a_ref = rt.remote(
        num_gpus=1, num_returns=5, scheduling_strategy=pinned("A"))(
        _node_attention).remote(NODE_SEED)
    n_ref, counts_b_ref = rt.remote(
        num_gpus=1, num_returns=2, scheduling_strategy=pinned("B"))(
        _node_norm).remote(o_ref, NODE_SEED)
    counts_a, counts_b = rt.get([counts_a_ref, counts_b_ref],
                                timeout=NODE_WAIT_S)
    tasks_s = time.perf_counter() - start
    refs = {"o": o_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref,
            "n": n_ref}
    # Before any read here: the driver holds placeholders only.
    held = {name: type(runtime.store._entries[r.id()].value).__name__
            for name, r in refs.items()}
    driver_bytes = runtime.store.stats()["memory_used_bytes"]
    stats_a = handles["A"].pool.call("executor_stats")
    stats_b = handles["B"].pool.call("executor_stats")
    # B released its lease as soon as it had copied.
    released = _until(lambda: handles["A"].pool.call("executor_stats")[
        "data_plane"]["leases"]["active"] == 0, 30)
    gets_before = runtime.remote_get_stats()
    start = time.perf_counter()
    got = dict(zip(refs, rt.get(list(refs.values()), timeout=NODE_WAIT_S)))
    driver_pull_s = time.perf_counter() - start
    driver_paths = _get_paths(gets_before, runtime.remote_get_stats())
    want = {"o": want_o, "dq": want_dq, "dk": want_dk, "dv": want_dv,
            "n": want_n}
    plane_a = {k: stats_a["data_plane"]["leases"][k]
               - before_a["data_plane"]["leases"][k]
               for k in ("granted", "released")}
    plane_b = {k: stats_b["data_plane"][k] - before_b["data_plane"][k]
               for k in ("same_host_map_hits", "same_host_copy_hits",
                         "chunked_pulls")}
    b_same_host_bytes = stats_b["same_host_bytes"] \
        - before_b["same_host_bytes"]
    b_same_host_s = stats_b["same_host_seconds"] \
        - before_b["same_host_seconds"]
    b_pulled = stats_b["pulled_bytes"] - before_b["pulled_bytes"]
    b_pull_s = stats_b["pull_seconds"] - before_b["pull_seconds"]
    a_chunks = stats_a["store"]["fetches_served"] \
        - before_a["store"]["fetches_served"]
    result = {
        "shape": list(LOST_SHAPE), "norm_rows_cols": [
            LOST_SHAPE[0] * LOST_SHAPE[1], LOST_SHAPE[2] * LOST_SHAPE[4]],
        "same_host_plane": plane,
        "bitwise": {k: torch.equal(got[k], want[k]) for k in want},
        "devices": {k: got[k].device.type for k in got},
        "output_bytes": want_o.numel() * want_o.element_size(),
        "driver_held_before_get": held,
        "driver_store_bytes_before_get": driver_bytes,
        "driver_exports": runtime._export_store.stats()["num_blobs"]
        - exports_before,
        "b_data_plane": plane_b, "a_leases": plane_a,
        "a_leases_released": released,
        "b_same_host_bytes": b_same_host_bytes,
        "b_same_host_s": b_same_host_s,
        "b_mapped_gb_per_s": _rate_gbps(b_same_host_bytes, b_same_host_s),
        "b_pulled_bytes": b_pulled, "b_pull_s": b_pull_s,
        "pull_gb_per_s": _rate_gbps(b_pulled, b_pull_s),
        "a_chunks_served": a_chunks,
        "driver_get_paths": driver_paths,
        "tasks_s": tasks_s, "driver_get_s": driver_pull_s,
        "launches_a": counts_a, "launches_b": counts_b}
    kept = {"o": o_ref, "n": got["n"]}
    del got, want, want_o, want_dq, want_dk, want_dv, want_n, refs
    del o_ref, dq_ref, dk_ref, dv_ref, n_ref
    require(all(result["bitwise"].values()),
            f"node results differ from the driver's: {result['bitwise']}")
    require(set(result["devices"].values()) == {torch.device(DEVICE).type},
            f"results not back on the card: {result['devices']}")
    require(set(held.values()) == {"RemoteBlob"}
            and result["driver_exports"] == 0,
            f"the driver held a result before reading it: {held}, "
            f"{result['driver_exports']} exports")
    require(driver_bytes < result["output_bytes"],
            f"the driver's store holds {driver_bytes} bytes")
    if plane:
        # The map path, and nothing quietly carried on by chunks.
        require(plane_b["same_host_map_hits"]
                + plane_b["same_host_copy_hits"] >= 1
                and plane_b["chunked_pulls"] == 0 and a_chunks == 0
                and b_same_host_bytes >= result["output_bytes"],
                f"o did not move A to B by the map path: B {plane_b}, "
                f"{b_same_host_bytes} bytes copied, A served {a_chunks} "
                f"chunks")
        require(plane_a["granted"] == 1 and released,
                f"A's leases: {plane_a}, released {released}")
        require(driver_paths["mapped"]["gets"] == len(result["bitwise"])
                and driver_paths["chunked"]["gets"] == 0,
                f"the driver's reads: {driver_paths}")
    else:
        require(b_pulled >= result["output_bytes"] and a_chunks > 0
                and plane_b["same_host_copy_hits"] == 0
                and plane_a["granted"] == 0,
                f"B pulled {b_pulled} bytes, A served {a_chunks} chunks, "
                f"B {plane_b}, A {plane_a}")
        require(driver_paths["chunked"]["gets"] == len(result["bitwise"]),
                f"the driver's reads: {driver_paths}")
    require(all(counts_a[k] == 1 for k in (*HOPPER_KERNELS, "flash_bwd"))
            and counts_b["rmsnorm"] == 1,
            f"node launches {counts_a}, {counts_b}: one of each expected")
    return result, kept


def _arena_node_norm(x, scale):
    """A ``num_gpus=1`` task on a daemon: RMSNorm over ``x`` with the
    kernel, and the launches it made."""
    import importlib

    fused = importlib.import_module("ray_tpu_torch.ops.fused")
    fused.launches["rmsnorm"] = 0
    with torch.no_grad():
        out = fused.rms_norm(x, scale, RMS_EPS)
    torch.cuda.synchronize()
    return out, fused.launches["rmsnorm"]


def _node_arena_read(rt, runtime, fused, handles: dict, ids: dict,
                     seed: int) -> dict:
    """One 512 KiB RMSNorm input put by the driver and normed by a
    ``num_gpus=1`` task pinned to B: how B read it, and the result
    against the driver's own launch."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    x, scale = _norm_inputs(ARENA_NORM_ROWS, seed)
    with torch.no_grad():
        want = fused.rms_norm(x, scale, RMS_EPS)
    torch.cuda.synchronize()
    before = handles["B"].pool.call("executor_stats")
    x_ref = rt.put(x)
    start = time.perf_counter()
    out_ref, count_ref = rt.remote(
        num_gpus=1, num_returns=2, scheduling_strategy=(
            NodeAffinitySchedulingStrategy(ids["B"].hex(), soft=False)))(
        _arena_node_norm).remote(x_ref, scale)
    got, launched = rt.get([out_ref, count_ref], timeout=NODE_WAIT_S)
    task_s = time.perf_counter() - start
    after = handles["B"].pool.call("executor_stats")
    source = runtime._export_sources.get(x_ref.id().binary())
    read_bytes = after["same_host_bytes"] - before["same_host_bytes"]
    read_s = after["same_host_seconds"] - before["same_host_seconds"]
    result = {
        "input_bytes": x.numel() * x.element_size(),
        "export_source_kind": source[0] if source else None,
        # The export's twin, under the object's id.
        "in_driver_arena": runtime.arena.contains(x_ref.id().binary()),
        "b_data_plane": {k: after["data_plane"][k] - before["data_plane"][k]
                         for k in ("same_host_map_hits",
                                   "same_host_copy_hits", "chunked_pulls")},
        "b_read_bytes": read_bytes, "b_read_s": read_s,
        "b_read_gb_per_s": _rate_gbps(read_bytes, read_s),
        "b_pulled_bytes": after["pulled_bytes"] - before["pulled_bytes"],
        "task_s": task_s, "bitwise": torch.equal(got, want),
        "on": got.device.type, "launches": launched}
    del x_ref, out_ref, count_ref, got
    return result


def _node_arena(rt, runtime, cluster, fused, handles: dict,
                ids: dict) -> dict:
    """node_cluster's arena check: the driver puts a 512 KiB RMSNorm
    input; a ``num_gpus=1`` task pinned to B reads it out of the driver's
    arena (the export's map source is of the ``"arena"`` kind), one copy
    in B's own process under the driver's lease, no chunk pulled, and
    norms it bitwise as the driver does. Twice: B's first read also
    connects to the driver's export server and attaches its arena. The
    head in this process (a ``GcsServer``, as the reference's
    ``Cluster`` makes it) keeps its KV in the native engine, the
    driver's own tables in the Python store."""
    reads = [_node_arena_read(rt, runtime, fused, handles, ids, seed)
             for seed in (NODE_SEED, NODE_SEED + 1)]
    result = {"first": reads[0], "second": reads[1],
              "launches": sum(r["launches"] for r in reads),
              "head_kv": type(cluster.gcs.gcs.kv).__name__,
              "driver_kv": type(runtime.gcs.kv).__name__}
    for read in reads:
        require(read["export_source_kind"] == "arena"
                and read["in_driver_arena"],
                f"the input was not exported through the driver's arena: "
                f"{read}")
        # A GPU task runs in B's own process: it copies the input out of
        # the driver's arena once (a copy hit; a pool task's argument
        # would be handed over, a map hit).
        require(read["b_data_plane"] == {"same_host_map_hits": 0,
                                         "same_host_copy_hits": 1,
                                         "chunked_pulls": 0}
                and read["b_pulled_bytes"] == 0
                and read["b_read_bytes"] >= read["input_bytes"],
                f"B did not read the input out of the driver's arena: "
                f"{read}")
        require(read["bitwise"] and read["on"] == "cuda"
                and read["launches"] == 1, f"B's RMSNorm differs: {read}")
    require(result["head_kv"] == "NativeKVStore"
            and result["driver_kv"] == "KVStore",
            f"KV engines: head {result['head_kv']}, driver "
            f"{result['driver_kv']}")
    return result


# The daemon gangs of node_cluster: bench.py's Llama for this many steps,
# held bitwise to the train phase's first ones.
DAEMON_GANG_STEPS = 3


def _daemon_gang_loop(config):
    """bench.py's model, seeds and batch (the train phase's plain step)
    in a gang process on a daemon: each step's loss and grad norm, the
    flash kernels' launches counted in this process, its pid and its
    parent's."""
    import importlib
    import os

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    model, params, optimizer, step = _bench_training(llama, train_step)
    state = train_step.create_train_state(params, optimizer)
    del params
    batch = train_step.place_batch(_bench_batch(model, 8, 2048))
    losses, norms, times = [], [], []
    with _LaunchCount(fa) as count:
        for _ in range(DAEMON_GANG_STEPS):
            start = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
    train.report({"loss": losses, "grad_norm": norms, "step_s": times,
                  "launches": count.counts, "pid": os.getpid(),
                  "ppid": _parent(os.getpid()),
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})


def _daemon_spread_loop(config):
    """A gloo gang member's pid and parent pid, all-gathered."""
    import os

    import torch.distributed as dist

    from ray_tpu_torch import train

    mine = torch.tensor([os.getpid(), _parent(os.getpid())],
                        dtype=torch.int64)
    gathered = [torch.zeros(2, dtype=torch.int64)
                for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    train.report({"world": dist.get_world_size(),
                  "backend": dist.get_backend(),
                  "pids": [int(t[0]) for t in gathered],
                  "ppids": [int(t[1]) for t in gathered]})


def _daemon_of(pid: int, daemons: dict) -> str | None:
    """The daemon (by name) a gang process descends from: daemon ->
    (fork server ->) worker."""
    by_pid = {p: name for name, p in daemons.items()}
    for _ in range(3):
        if pid in by_pid:
            return by_pid[pid]
        try:
            pid = _parent(pid)
        except (OSError, ValueError, IndexError):
            return None
    return by_pid.get(pid)


def _daemon_gangs(nodes: dict, train_phase: dict, layers: int) -> dict:
    """Train gangs placed by their placement groups onto the daemons: a
    ``STRICT_SPREAD`` gloo gang of two CPU processes over A and B (one
    world of two, one member under each daemon), then a one-process
    ``num_gpus=1`` gang on A (``node_a`` holds it there) training bench.py's
    Llama ``DAEMON_GANG_STEPS`` steps, bitwise the train phase's first
    ones. One card gives NCCL one rank, so the GPU gang is one process."""
    from ray_tpu_torch import train

    daemons = {name: node.pid for name, node in nodes.items()}
    start = time.perf_counter()
    spread = train.MeshTrainer(
        _daemon_spread_loop, dist_config="auto",
        scaling_config=train.ScalingConfig(
            num_workers=2, use_process_workers=True,
            placement_strategy="STRICT_SPREAD"),
        run_config=train.RunConfig(report_timeout_s=NODE_WAIT_S)).fit()
    spread_s = time.perf_counter() - start
    require(spread.error is None, f"the spread gang: {spread.error!r}")
    under = sorted(str(_daemon_of(p, daemons))
                   for p in spread.metrics["ppids"])
    start = time.perf_counter()
    gang = train.MeshTrainer(
        _daemon_gang_loop, dist_config="auto",
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=True, use_process_workers=True,
            resources_per_worker={"CPU": 1, "node_a": 1}),
        run_config=train.RunConfig(report_timeout_s=NODE_WAIT_S)).fit()
    gang_s = time.perf_counter() - start
    require(gang.error is None, f"the GPU gang: {gang.error!r}")
    m = gang.metrics
    want_loss = train_phase["loss"][:DAEMON_GANG_STEPS]
    want_norm = train_phase["grad_norm"][:DAEMON_GANG_STEPS]
    result = {
        "spread": {"world": spread.metrics["world"],
                   "backend": spread.metrics["backend"],
                   "members_under": under, "fit_s": spread_s},
        "gpu_gang": {"config": "bench.py:50-54", "batch": [8, 2048],
                     "steps": DAEMON_GANG_STEPS,
                     "under": _daemon_of(m["ppid"], daemons),
                     "loss": m["loss"], "grad_norm": m["grad_norm"],
                     "train_loss": want_loss, "train_grad_norm": want_norm,
                     "bitwise": m["loss"] == want_loss
                     and m["grad_norm"] == want_norm,
                     "step_s": m["step_s"],
                     "train_step_s": train_phase["step_s"],
                     "max_memory_allocated": m["max_memory_allocated"],
                     "launches": m["launches"], "fit_s": gang_s}}
    require(result["spread"]["world"] == 2 and under == ["A", "B"],
            f"the spread gang: {result['spread']}")
    require(result["gpu_gang"]["under"] == "A",
            f"the GPU gang ran under {result['gpu_gang']['under']}")
    require(result["gpu_gang"]["bitwise"],
            f"the daemon gang's steps {m['loss']}, {m['grad_norm']} are "
            f"not the train phase's {want_loss}, {want_norm}")
    _check_train_launches("daemon gang", m["launches"], layers,
                          DAEMON_GANG_STEPS)
    return result


# node_cluster's head: durable (its persist path under the phase's
# session directory) and sharded.
NODE_GCS_SHARDS = 4
# The daemons' flight-ring flush period (flight_recorder_flush_s's
# default).
NODE_FLUSH_S = 2.0


PIPE_BURST = 2000
PIPE_NORMS = 16
PIPE_NORM_SHAPE = (8, 4096)
PIPE_SEED = 43


def _pipe_tick(i: int) -> int:
    """A plain CPU task of (a'')'s burst: it fuses on C, and rides
    pipelined worker leases on A and B (which hold a card)."""
    return i * 3


def _pipe_norm(x, scale):
    """A ``num_gpus=1`` task of (a''): RMSNorm over the driver's input
    with the kernel, and the launches it made."""
    import importlib

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    fused = importlib.import_module("ray_tpu_torch.ops.fused")
    with _LaunchCount(fa, fused) as launched, torch.no_grad():
        out = fused.rms_norm(x, scale, RMS_EPS)
        torch.cuda.synchronize()
    return out, launched.counts["rmsnorm"]


def _pipe_checksum(x) -> float:
    """A CPU task of (a'') over an RMSNorm result (a ref argument): the
    f64 sum of its host copy."""
    return float(torch.as_tensor(x).cpu().double().sum())


def _node_pipeline(rt, runtime, cluster, handles: dict, ids: dict, fused,
                   task_us: dict) -> dict:
    """(a'') The pipelined task path on the daemons: a burst of
    PIPE_BURST plain CPU tasks through the submit ring, every result
    right and sealed once. They go in batch RPCs to A and B, which hold
    a card and so run them on pipelined worker leases (pool workers see
    no card), and to C, a daemon with no card started for the burst and
    removed after it, where they fuse. Then PIPE_NORMS ``num_gpus=1``
    RMSNorm tasks pinned to B over inputs the driver put, submitted at
    once through the ring, each bitwise the driver's own launch, and
    PIPE_NORMS CPU tasks pinned to B taking those results as ref
    arguments (the batch RPC's classic branch), their checksums the
    driver's."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    start = time.perf_counter()
    node_c = cluster.add_node(num_cpus=2)
    require(cluster.wait_for_nodes(3, timeout=NODE_WAIT_S)
            and _until(lambda: rt.cluster_resources().get("CPU") == 6.0,
                       NODE_WAIT_S), "daemon C did not join")
    c_join_s = time.perf_counter() - start
    with runtime._remote_nodes_lock:
        by_pid = {h.pool.call("exec_ping"): h
                  for h in runtime._remote_nodes.values()}
    burst_handles = {**handles, "C": by_pid[node_c.pid]}

    def pipelines(names) -> dict:
        return {name: burst_handles[name].pool.call(
            "executor_stats")["pipeline"] for name in names}

    def delta(after: dict, before: dict) -> dict:
        return {name: {k: v - before[name][k] for k, v in row.items()}
                for name, row in after.items()}

    on_b = NodeAffinitySchedulingStrategy(ids["B"].hex(), soft=False)
    stats0, pipe0 = runtime.execution_pipeline_stats(), pipelines("ABC")
    tick = rt.remote(num_cpus=1)(_pipe_tick)
    start = time.perf_counter()
    refs = [tick.remote(i) for i in range(PIPE_BURST)]
    out = rt.get(refs, timeout=NODE_WAIT_S)
    burst_s = time.perf_counter() - start
    sealed_once = len({r.id() for r in refs}) == PIPE_BURST and all(
        runtime.store._entries[r.id()].sealed for r in refs)
    del refs
    stats1, pipe1 = runtime.execution_pipeline_stats(), pipelines("ABC")
    burst_pipe = delta(pipe1, pipe0)
    burst_driver = {group: {k: v - stats0[group][k]
                            for k, v in stats1[group].items()}
                    for group in ("submit", "dispatch", "seal", "fused")}
    batch_rpcs = sum(row["batch_rpcs"] for row in burst_pipe.values())
    cluster.remove_node(node_c)
    require(_until(lambda: rt.cluster_resources().get("CPU") == 4.0,
                   NODE_WAIT_S), "daemon C did not leave")

    # The kernel on the new path.
    gen = torch.Generator(DEVICE).manual_seed(PIPE_SEED)
    xs = [torch.randn(PIPE_NORM_SHAPE, generator=gen, device=DEVICE)
          for _ in range(PIPE_NORMS)]
    scale = torch.randn(PIPE_NORM_SHAPE[1], generator=gen, device=DEVICE)
    with torch.no_grad():
        want = [fused.rms_norm(x, scale, RMS_EPS) for x in xs]
    torch.cuda.synchronize()
    want_sums = [float(w.cpu().double().sum()) for w in want]
    x_refs = [rt.put(x) for x in xs]
    scale_ref = rt.put(scale)
    norm = rt.remote(num_gpus=1, num_returns=2, scheduling_strategy=on_b)(
        _pipe_norm)
    checksum = rt.remote(num_cpus=1, scheduling_strategy=on_b)(
        _pipe_checksum)
    ring0 = runtime.execution_pipeline_stats()["submit"]["ring_submits"]
    b0 = pipelines("B")["B"]
    start = time.perf_counter()
    pairs = [norm.remote(x_ref, scale_ref) for x_ref in x_refs]
    got = rt.get([p[0] for p in pairs], timeout=NODE_WAIT_S)
    launches = rt.get([p[1] for p in pairs], timeout=NODE_WAIT_S)
    norms_s = time.perf_counter() - start
    start = time.perf_counter()
    sums = rt.get([checksum.remote(p[0]) for p in pairs],
                  timeout=NODE_WAIT_S)
    sums_s = time.perf_counter() - start
    b1 = pipelines("B")["B"]
    ring1 = runtime.execution_pipeline_stats()["submit"]["ring_submits"]
    result = {
        "burst_tasks": PIPE_BURST, "burst_wall_s": burst_s,
        "burst_tasks_per_s": PIPE_BURST / burst_s,
        "burst_right": out == [3 * i for i in range(PIPE_BURST)],
        "burst_sealed_once": sealed_once,
        "burst_driver": burst_driver,
        "burst_tasks_per_batch_rpc": (
            sum(row["batch_tasks"] for row in burst_pipe.values())
            / max(1, batch_rpcs)),
        "burst_daemons": burst_pipe, "c_join_s": c_join_s,
        "remote_task_round_trip_us": task_us,
        "norm_shape": list(PIPE_NORM_SHAPE), "norms": PIPE_NORMS,
        "norm_bitwise": [torch.equal(g, w) for g, w in zip(got, want)],
        "norm_devices": sorted({g.device.type for g in got}),
        "norm_ring_submits": ring1 - ring0,
        "norms_s": norms_s, "checksums_s": sums_s,
        "checksums_equal": sums == want_sums,
        "b_batch_rpcs_grew": b1["batch_rpcs"] - b0["batch_rpcs"],
        "launches": {"rmsnorm": int(sum(launches))}}
    emit("node_cluster_pipeline", **result)
    require(result["burst_right"] and sealed_once,
            "the burst's results are wrong or not sealed once")
    fused_ab = sum(burst_pipe[name]["fused_tasks"] for name in "AB")
    require(0 < batch_rpcs < PIPE_BURST
            and burst_pipe["C"]["fused_tasks"] > 0 and fused_ab == 0,
            f"the burst rode {batch_rpcs} batch RPCs, with "
            f"{burst_pipe['C']['fused_tasks']} fused tasks on C and "
            f"{fused_ab} on A and B (which hold a card)")
    require(all(result["norm_bitwise"]) and result["norm_devices"]
            == [torch.device(DEVICE).type],
            f"RMSNorm on B differs from the driver's: "
            f"{result['norm_bitwise']}, {result['norm_devices']}")
    require(result["norm_ring_submits"] >= 2 * PIPE_NORMS,
            f"{result['norm_ring_submits']} ring submits for "
            f"{2 * PIPE_NORMS} tasks")
    require(result["checksums_equal"],
            "the checksums over B's results differ from the driver's")
    require(result["b_batch_rpcs_grew"] > 0,
            "the ref-bearing tasks rode no batch RPC on B")
    require(result["launches"]["rmsnorm"] == PIPE_NORMS,
            f"RMSNorm launched {result['launches']['rmsnorm']} times on B, "
            f"{PIPE_NORMS} expected")
    return result


def _directory_by_shard(head) -> dict:
    """{shard index: the object ids its directory holds}."""
    return {shard.index: set(shard.directory.locations())
            for shard in head._shards}


def _node_shard_kill(rt, runtime, cluster, kept: dict, ids: dict) -> dict:
    """(a') On the sharded head, after (a): 4 shard rows; every published
    id in the shard ``shard_of`` names; ``gcs_kill_shard`` of the shard
    that owns o's id replays its records and moves that shard's epoch
    and restores only; then a new RMSNorm task on B over o is bitwise
    (a)'s. The driver and the daemons re-sync under the new epoch (their
    writes stamped with the old one are refused and counted) and the
    driver's live results are back in the directory: none lost."""
    from ray_tpu_torch._private import gcs_shard
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    head = cluster.gcs
    client = runtime.gcs_client
    o_hex = kept["o"].hex()
    require(_until(lambda: o_hex in head._list_object_locations(), 30),
            "o's location never reached the head's directory")
    rows_before = client.call("gcs_shard_stats")
    by_shard = _directory_by_shard(head)
    misrouted = sorted(key for index, keys in by_shard.items()
                       for key in keys
                       if gcs_shard.shard_of(key, NODE_GCS_SHARDS) != index)
    victim = gcs_shard.shard_of(o_hex, NODE_GCS_SHARDS)
    published = sorted(set().union(*by_shard.values()))
    epoch_before = client.call("gcs_epoch")
    fenced_before = head.persist_stats()["fenced_writes"]
    start = time.perf_counter()
    replayed = client.call("gcs_kill_shard", victim)
    kill_ms = (time.perf_counter() - start) * 1000.0
    killed_at = time.perf_counter()
    rows_after = client.call("gcs_shard_stats")
    epoch_after = client.call("gcs_epoch")
    n_ref, counts_ref = rt.remote(
        num_gpus=1, num_returns=2, scheduling_strategy=(
            NodeAffinitySchedulingStrategy(ids["B"].hex(), soft=False)))(
        _node_norm).remote(kept["o"], NODE_SEED)
    counts_b = rt.get(counts_ref, timeout=NODE_WAIT_S)
    n_again = rt.get(n_ref, timeout=NODE_WAIT_S)
    # The re-sync: the driver republishes everything it owns under the
    # new epoch (o's holder back in the killed shard, the new result in
    # its own), and both daemons re-register.
    n_hex = n_ref.hex()
    resynced = _until(lambda: o_hex in _directory_by_shard(head)[victim]
                      and n_hex in head._list_object_locations()
                      and runtime._gcs_epoch == head.epoch, NODE_WAIT_S)
    resync_s = time.perf_counter() - killed_at
    # The driver's live results (o, kept since (a), and the new one):
    # their holders are all in the directory again.
    lost = [h for h in (o_hex, n_hex)
            if h not in head._list_object_locations()]
    result = {
        "gcs_shards": NODE_GCS_SHARDS, "rows": len(rows_before),
        "published_ids": len(published), "misrouted": misrouted,
        "victim": victim, "replayed": replayed, "kill_ms": kill_ms,
        "epoch": [epoch_before, epoch_after],
        "restores": [r["restores"] for r in rows_after],
        "shard_epochs": [[b["epoch"], a["epoch"]]
                         for b, a in zip(rows_before, rows_after)],
        "resynced": resynced, "resync_s": resync_s,
        "stale_epoch_writes": head.persist_stats()["fenced_writes"]
        - fenced_before,
        "locations_lost": lost,
        "bitwise_after_kill": torch.equal(n_again, kept["n"]),
        "launches_b": counts_b}
    del n_ref, n_again
    require(len(rows_before) == NODE_GCS_SHARDS and not misrouted,
            f"shard rows {len(rows_before)}, misrouted ids {misrouted}")
    require(replayed >= 1 and epoch_after == epoch_before + 1
            and result["restores"] == [int(i == victim)
                                       for i in range(NODE_GCS_SHARDS)]
            and all(a - b == int(i == victim) for i, (b, a)
                    in enumerate(result["shard_epochs"])),
            f"the shard kill: {result}")
    require(resynced and not lost, f"the re-sync: {result}")
    require(result["bitwise_after_kill"] and counts_b["rmsnorm"] == 1,
            f"B's RMSNorm over o after the kill: {result}")
    return result


def _scrape_metrics(runtime) -> tuple:
    """One scrape of the driver's /metrics: the text, its bytes and
    milliseconds."""
    import urllib.request

    start = time.perf_counter()
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{runtime.metrics_agent.port}/metrics",
        timeout=30).read()
    return body.decode(), len(body), (time.perf_counter() - start) * 1000.0


def _series(body: str, family: str, **labels) -> "float | None":
    """The value of the one sample of ``family`` with ``labels``."""
    import re

    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    m = re.search(r"^%s\{%s\} (\S+)$" % (re.escape(family),
                                          re.escape(inner)), body, re.M)
    return float(m.group(1)) if m else None


def _node_scrape(runtime, ids: dict, streamed: dict) -> dict:
    """(b') After the requests on A: one scrape of the driver's /metrics
    serves A's and B's ``exec`` and ``admit_worker`` histograms, each
    counting at least the tasks the node ran; A's engine counters, off
    its heartbeat, counting at least the requests' tokens; the four
    shards' rows. The head's history has samples of A and B, and its
    watchdog no verdict."""
    import re

    p = "ray_tpu_torch"
    hexes = {name: node_id.hex() for name, node_id in ids.items()}
    want_tokens = sum(len(r["tokens"]) for r in streamed["records"])

    def ready(body: str) -> bool:
        generated = (_series(body, f"{p}_node_engine",
                             node=hexes["A"][:16], key="decode_tokens")
                     or 0) + (_series(body, f"{p}_node_engine",
                                      node=hexes["A"][:16], key="finished")
                              or 0)
        return generated >= want_tokens

    scrape = _scrape_metrics(runtime)
    # The engine's counters ride A's next heartbeat (1 s).
    deadline = time.monotonic() + 30
    while not ready(scrape[0]) and time.monotonic() < deadline:
        time.sleep(0.5)
        scrape = _scrape_metrics(runtime)
    body, nbytes, ms = scrape
    stages = {}
    for name, h in hexes.items():
        row = {"tasks_executed": _series(body, f"{p}_node_tasks_executed",
                                         node=h[:16])}
        for stage in ("exec", "admit_worker"):
            row[stage] = _series(body, f"{p}_stage_latency_count",
                                 stage=stage, node=h[:16])
        # A fused task (a batch RPC's plain entry, run on the daemon's
        # RPC thread) passes no admission: it has an exec sample only.
        row["fused_tasks"] = _series(body, f"{p}_node_pipeline",
                                     node=h[:16], key="fused_tasks") or 0.0
        stages[name] = row
    engine = {key: _series(body, f"{p}_node_engine", node=hexes["A"][:16],
                           key=key)
              for key in ("admitted", "finished", "prefill_tokens",
                          "decode_tokens")}
    shard_rows = sorted({int(s) for s in re.findall(
        r'^%s_gcs_shard\{shard="(\d+)",key="epoch"\}' % p, body, re.M)})
    history = runtime.metrics_history(window_s=600.0) or {}
    health = runtime.cluster_health() or {}
    result = {
        "scrape_bytes": nbytes, "scrape_ms": ms, "stages": stages,
        "engine_a": engine, "requests_tokens": want_tokens,
        "shard_rows": shard_rows,
        "history_nodes": sorted(name for name, h in hexes.items()
                                if h in (history.get("nodes") or {})),
        "history_samples": {name: len(history["nodes"][h]["samples"])
                            for name, h in hexes.items()
                            if h in (history.get("nodes") or {})},
        "verdicts": health.get("verdicts"),
        "fired": health.get("fired")}
    for name, row in stages.items():
        require(row["tasks_executed"] and row["exec"] and row["admit_worker"]
                and row["exec"] >= row["tasks_executed"]
                and row["admit_worker"] + row["fused_tasks"]
                >= row["tasks_executed"],
                f"{name}'s stage histograms in the scrape: {row}")
    require(ready(body), f"A's engine counters in the scrape: {engine}, "
                         f"{want_tokens} tokens streamed")
    require(shard_rows == list(range(NODE_GCS_SHARDS)),
            f"the shards' rows in the scrape: {shard_rows}")
    require(result["history_nodes"] == ["A", "B"]
            and health.get("armed") and health.get("verdicts") == [],
            f"the history and the watchdog: {result}")
    return result


def _node_flight_ring(node_a_pid: int) -> dict:
    """(c') After A's SIGKILL: within one flush period and a second, A's
    ring file is in the session's ``flight/`` folder,
    ``collect_session_dumps`` returns it, and its ring holds the re-sync
    of (a')."""
    from ray_tpu_torch._private import flight_recorder

    killed = time.time()

    def dump():
        return next((d for d in flight_recorder.collect_session_dumps()
                     if d.get("pid") == node_a_pid), None)

    found = _until(lambda: dump() is not None, NODE_FLUSH_S + 1.0)
    doc = dump() or {}
    kinds = [e["kind"] for e in doc.get("events", [])]
    result = {"found_within_s": time.time() - killed if found else None,
              "file": doc.get("file"), "role": doc.get("role"),
              "age_at_collection_s": killed - doc["dumped_at"]
              if doc else None,
              "events": len(kinds),
              "epoch_bump": kinds.count("epoch.bump"),
              "heartbeat_stale_epoch": kinds.count("heartbeat.stale_epoch"),
              "post_mortem_keys": sorted(k for k in ("fault_stats", "breaker",
                                                     "spill", "stage_hist")
                                         if k in doc)}
    require(found and (result["epoch_bump"]
                       or result["heartbeat_stale_epoch"]),
            f"A's flight ring: {result}")
    return result


def phase_node_cluster(llama, fa, fused, served: dict, served_tokens: list,
                       process_served: dict, runtime_phase: dict,
                       train_phase: dict, device: dict,
                       power: str) -> tuple[dict, dict]:
    """Worker-node daemons on the card: a ``Cluster`` with its head in
    this process and two daemons, A and B, each ``{"CPU": 2, "GPU": 1}``
    on card 0 (A also ``node_a``), and a driver connected with no CPU and
    no GPU of its own. (a) the flash kernels on A and RMSNorm on B,
    bitwise, the output moved A to B by the same-host plane (one copy
    out of A's segment; the chunked pull with the plane off); then the
    daemon gangs: a gloo gang spread over A and B, and a one-process
    ``num_gpus=1`` gang on A training bench.py's Llama bitwise the train
    phase; (b) Llama-3-8B served from a remote actor on A, the serve
    phase's first 8 requests, greedy outputs token-identical to the
    serve phase's;
    (c) A killed, the actor restarted on B from the same seed and
    token-identical again; (d) after shutdown no daemon or actor process
    is left, the card's free bytes are back and so is every ``GPU``.
    (a) also: a 512 KiB RMSNorm input the driver put, read on B out of
    the driver's arena. The head is durable and sharded
    (``gcs_shards=4``) and the driver serves ``/metrics``: (a') a shard
    kill after (a), (b') a scrape after (b), (c') A's flight ring after
    (c). (a'') after (a'): the pipelined task path, a burst through the
    submit ring to A, B and C (a daemon with no card, there for the
    burst alone), then RMSNorm tasks on B through the ring and CPU tasks
    over their results. Returns the kernels' launches on the nodes, in
    the GPU gang, on the arena's input and on the pipelined path."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import gcs_shard
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.node import SESSION_DIR_ENV
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    phase_start = time.perf_counter()
    config = serve_config(llama)
    _, prompts, temperatures = serve_requests(config)
    greedy = [i for i, t in enumerate(temperatures) if t == 0.0]
    free_before = _settled_free_bytes()
    # The phase's session directory: the head's persisted files, the
    # daemons' flight rings and spill files.
    session = tempfile.mkdtemp(prefix="ray_tpu_torch_node_cluster_")
    prior_session = os.environ.get(SESSION_DIR_ENV)
    os.environ[SESSION_DIR_ENV] = session
    # The shards snapshot at the head's first tick and then every
    # gcs_snapshot_interval_s: at an hour, (a)'s records are still in the
    # victim's WAL when (a') kills it, so the kill replays them.
    head_config = {"gcs_shards": NODE_GCS_SHARDS,
                   "gcs_snapshot_interval_s": 3600.0}
    prior_config = {key: GLOBAL_CONFIG.get(key) for key in head_config}
    GLOBAL_CONFIG.update(head_config)
    cluster = Cluster(heartbeat_timeout_s=NODE_HEARTBEAT_TIMEOUT_S,
                      persist_path=os.path.join(session,
                                                "gcs_snapshot.pkl"))
    pids = []
    try:
        start = time.perf_counter()
        nodes = {"A": cluster.add_node(num_cpus=2, resources={
                     "GPU": 1, "node_a": 1}),
                 "B": cluster.add_node(num_cpus=2, resources={"GPU": 1})}
        require(cluster.wait_for_nodes(2, timeout=NODE_WAIT_S),
                "the daemons did not register")
        daemons_s = time.perf_counter() - start
        pids += [node.pid for node in nodes.values()]
        runtime = rt.init(num_cpus=0, num_gpus=0, address=cluster.address,
                          metrics_port=0)
        require(_until(lambda: rt.cluster_resources().get("GPU") == 2.0,
                       NODE_WAIT_S), "the nodes did not join the driver")
        joined_s = time.perf_counter() - start
        with runtime._remote_nodes_lock:
            by_pid = {h.pool.call("exec_ping"): (nid, h)
                      for nid, h in runtime._remote_nodes.items()}
        ids = {k: by_pid[n.pid][0] for k, n in nodes.items()}
        handles = {k: by_pid[n.pid][1] for k, n in nodes.items()}
        kernels, kept = _node_kernels(rt, runtime, handles, ids)
        shard_kill = _node_shard_kill(rt, runtime, cluster, kept, ids)
        del kept
        arena = _node_arena(rt, runtime, cluster, fused, handles, ids)
        task_us = _round_trips_us(rt, rt.remote(_noop).remote)
        # (a'') The pipelined task path (the submit ring, batch RPCs,
        # fused runs), with RMSNorm's tasks riding the ring.
        pipeline = _node_pipeline(rt, runtime, cluster, handles, ids,
                                  fused, task_us)
        torch.cuda.empty_cache()
        gangs = _daemon_gangs(nodes, train_phase,
                              bench_config(llama).num_layers)
        require(_until(lambda: rt.available_resources().get("GPU") == 2.0,
                       60), "GPU not back after the daemon gang")

        # (b) Serving from a remote actor on A.
        boot = time.perf_counter()
        actor = rt.remote(
            num_gpus=1, max_restarts=1, max_concurrency=16,
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                ids["A"].hex(), soft=False))(ProcessServeActor).remote(
            **SERVE_ENGINE, device=DEVICE)
        warm = rt.get(actor.generate.remote(
            {"tokens": prompts[0][:32], "max_new_tokens": 2}), timeout=900)
        boot_s = time.perf_counter() - boot
        require(len(warm["tokens"]) == 2, "warm-up request failed")
        streamed = _stream_requests(rt, actor, prompts[:NODE_REQUESTS],
                                    temperatures[:NODE_REQUESTS])
        served_here = _serving_summary(
            streamed, temperatures[:NODE_REQUESTS], served_tokens)
        actor_a = streamed["counters"]["pid"]
        pids.append(actor_a)
        actor_on_a = _parent(actor_a) == nodes["A"].pid
        scrape = _node_scrape(runtime, ids, streamed)

        # (c) A dies: the actor restarts on B.
        wall_kill = time.perf_counter()
        cluster.remove_node(nodes["A"], allow_graceful=False)
        flight_ring = _node_flight_ring(nodes["A"].pid)
        deadline = time.monotonic() + NODE_WAIT_S
        while True:
            with runtime._remote_nodes_lock:
                if ids["A"] not in runtime._remote_nodes:
                    break
            require(time.monotonic() < deadline,
                    "the driver never dropped node A")
            time.sleep(0.001)
        wall_detect = time.perf_counter()
        i = greedy[0]
        died_calls = 0
        while True:
            try:
                again = rt.get(actor.stream.remote(
                    {"tokens": prompts[i], "max_new_tokens": SERVE_NEW_TOKENS,
                     "temperature": 0.0}), timeout=900)
                break
            except ActorDiedError as exc:
                died_calls += 1
                require(time.monotonic() < deadline,
                        f"the actor never came back: {exc}")
                time.sleep(0.05)
        counters_b = rt.get(actor.counters.remote(), timeout=60)
        actor_b = counters_b["pid"]
        pids.append(actor_b)
        actor_on_b = _parent(actor_b) == nodes["B"].pid
        rt.get(actor.shutdown.remote(), timeout=60)
        rt.kill(actor)
        gpu_driver = [rt.available_resources().get("GPU"),
                      rt.cluster_resources().get("GPU")]
        stats_b = handles["B"].pool.call("executor_stats")
    finally:
        rt.shutdown()
        cluster.shutdown()
        # head_restart keeps the unsharded head.
        GLOBAL_CONFIG.update(prior_config)
        gcs_shard.init_from_config()
        if prior_session is None:
            os.environ.pop(SESSION_DIR_ENV, None)
        else:
            os.environ[SESSION_DIR_ENV] = prior_session
        shutil.rmtree(session, ignore_errors=True)
    # (d) Teardown.
    left = [pid for pid in pids if not _until(lambda: _pid_gone(pid), 30)]
    free_after = _free_back(free_before, NODE_FREE_TOL_BYTES)
    launches = {k: kernels["launches_a"][k]
                for k in (*HOPPER_KERNELS, "flash_bwd")}
    launches["rmsnorm"] = kernels["launches_b"]["rmsnorm"] \
        + shard_kill["launches_b"]["rmsnorm"] + arena["launches"] \
        + served_here["rmsnorm_launches"] + counters_b["rmsnorm"]
    result = {
        "daemons": {"resources": {"CPU": 2, "GPU": 1}, "card": 0,
                    "heartbeat_timeout_s": NODE_HEARTBEAT_TIMEOUT_S},
        "daemons_registered_s": daemons_s, "nodes_joined_s": joined_s,
        "kernels": kernels, "shard_kill": shard_kill,
        "arena_input_on_b": arena,
        "pipeline": {k: pipeline[k] for k in (
            "burst_wall_s", "burst_tasks_per_s", "norms_s", "launches")},
        "daemon_gangs": gangs,
        "remote_task_round_trip_us": task_us,
        "thread_task_round_trip_us": runtime_phase["task_round_trip_us"],
        "actor": "num_gpus=1, max_restarts=1, max_concurrency=16, "
                 "NODE_AFFINITY to A",
        "actor_on_a": actor_on_a, "actor_start_and_warm_up_s": boot_s,
        **served_here,
        "serve_phase": {k: served[k] for k in SERVE_SUMMARY_KEYS},
        "process_serve_phase": process_served,
        "scrape": scrape, "flight_ring": flight_ring,
        "kill_to_detect_s": wall_detect - wall_kill,
        "detect_to_first_token_s": again["arrivals"][0] - wall_detect
        if again["arrivals"] else None,
        "calls_failed_while_dead": died_calls,
        "actor_on_b": actor_on_b,
        "restart_token_identical": again["tokens"] == served_tokens[i],
        "gpu_driver_available_total": gpu_driver,
        "gpu_b_available": stats_b["available"].get("GPU"),
        "b_actors_after_kill": stats_b["num_actors"],
        "pids_left": left, "free_bytes_before_after": [free_before,
                                                       free_after],
        "launches": launches, "card": device["kind"], "nvidia_smi": power,
        "phase_s": time.perf_counter() - phase_start,
        # This phase's wall on the H100 before its head was sharded and
        # its driver scraped (the previous version of this script).
        "phase_s_before": 116.1}
    emit("node_cluster", **result)
    require(actor_on_a and actor_on_b, "the actor did not run in A's tree, "
                                       "then B's")
    require(not streamed["errors"], f"requests failed: {streamed['errors']}")
    require(not served_here["short_outputs"],
            f"requests sealed with {served_here['short_outputs']} tokens")
    require(served_here["greedy_token_identical"],
            "the remote actor's greedy outputs differ from the serve "
            "phase's")
    require(result["restart_token_identical"],
            "the restarted actor's greedy output differs")
    require(gpu_driver == [1.0, 1.0] and result["gpu_b_available"] == 1.0
            and result["b_actors_after_kill"] == 0,
            f"GPU not back: driver {gpu_driver}, node B "
            f"{result['gpu_b_available']}")
    require(not left, f"processes left: {left}")
    require(abs(free_after - free_before) <= NODE_FREE_TOL_BYTES,
            f"free card bytes {free_before} -> {free_after}")
    per_forward = 2 * config.num_layers + 1
    require(served_here["rmsnorm_launches"]
            == per_forward * served_here["forwards"] > 0,
            f"rmsnorm launched {served_here['rmsnorm_launches']} times in "
            f"the remote actor over {served_here['forwards']} forwards")
    return (launches, gangs["gpu_gang"]["launches"], arena["launches"],
            pipeline["launches"])


HEAD_SEED = 37
HEAD_STORE_LIMIT_MB = 48  # under the four flash results' 100.7 MB
HEAD_WAIT_S = 300.0
HEAD_GREEDY = 4  # the serve phase's first greedy prompts sent before
# The prompts the second driver sends at once through the foreign handle
# (its proxy sends one call at a time): the first 2 of those, cut from 4
# to keep the script inside its time limit.
HEAD_FOREIGN = 2


def _spawn_node(role: str, kwargs: dict, session: str, extra_env: dict,
                log_name: str) -> subprocess.Popen:
    """``python -m ray_tpu_torch._private.node <role>`` in a process
    group of its own, its output to ``<session>/<log_name>``."""
    from ray_tpu_torch._private.node import SESSION_DIR_ENV, daemon_child_env

    env = daemon_child_env({SESSION_DIR_ENV: session, **extra_env})
    with open(os.path.join(session, log_name), "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node", role,
             json.dumps(kwargs)], env=env, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)


def _head_call(addr: str, method: str, *args, timeout_s: float = 5.0):
    """One call to the head on a fresh connection; None while it is
    down."""
    from ray_tpu_torch._private.rpc import RpcClient, RpcError

    client = RpcClient(addr, timeout_s=timeout_s, connect_timeout_s=1.0)
    try:
        return client.call(method, *args)
    except (RpcError, OSError):
        return None
    finally:
        client.close()


def _start_head(session: str, port: int) -> tuple:
    """The head process on ``port`` (0: any) with the session dir, and
    its address once it answers. It runs no GPU work (``CPU`` 1)."""
    proc = _spawn_node("head", {"port": port, "resources": {"CPU": 1.0}},
                       session, {"CUDA_VISIBLE_DEVICES": ""}, "head.log")
    addr_file = os.path.join(session, "head_address")
    deadline = time.monotonic() + HEAD_WAIT_S
    while True:
        require(proc.poll() is None, "the head died while starting")
        require(time.monotonic() < deadline, "the head never answered")
        try:
            with open(addr_file) as f:
                addr = f.read().strip()
        except OSError:
            addr = ""
        if addr and (port == 0 or addr.endswith(f":{port}")) \
                and _head_call(addr, "ping") == "pong":
            return proc, addr
        time.sleep(0.02)


def _kill_group(proc: subprocess.Popen, sig=None) -> None:
    import signal

    try:
        os.killpg(proc.pid, sig if sig is not None else signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass  # the group has ended
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass  # reported as a pid left


def _rts1_files(session: str, pid: int) -> list[str]:
    """The managed spill files in daemon ``pid``'s directory."""
    root = os.path.join(session, "spill", str(pid))
    out = []
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else ():
        if name.endswith(".spill"):
            with open(os.path.join(root, name), "rb") as f:
                if f.read(4) == b"RTS1":
                    out.append(name)
    return out


class BorrowHolder:
    """A ``num_gpus=1`` actor on daemon A that borrows the driver's
    ``fwd`` output: handed the ref inside a list, it holds it, reads the
    object through the driver and runs RMSNorm over it on its card."""

    def __init__(self):
        self.ref = None

    def hold(self, boxed: list) -> str:
        self.ref = boxed[0]
        return "held"

    def read(self) -> tuple:
        import ray_tpu_torch

        o = ray_tpu_torch.get(self.ref)
        out, counts = _node_norm(o, HEAD_SEED)
        return o.device.type, out, counts

    def drop(self) -> str:
        self.ref = None
        return "dropped"


# A second driver, with no card, on the cluster's head (argv[1]): it
# resolves the named actor through the head's directory and calls it
# through the foreign handle. Its work comes as JSON lines on stdin and
# its answers go to stdout; it times the withdrawal of the name from the
# first driver's kill (both read the host's monotonic clock).
SECOND_DRIVER = """
import json, pickle, sys, time
start = time.perf_counter()
import ray_tpu_torch as rt

rt.init(address=sys.argv[1], num_cpus=0, num_gpus=0)
out = {"init_s": time.perf_counter() - start}
job = json.loads(sys.stdin.readline())
t0 = time.perf_counter()
handle = rt.get_actor(job["name"])
out["resolve_s"] = time.perf_counter() - t0
out["handle"] = type(handle).__name__
out["owner_addr"] = getattr(handle, "_owner_addr", None)
copy = pickle.loads(pickle.dumps(handle))
out["copy_equal"] = copy == handle


def request(tokens):
    return {"tokens": tokens, "max_new_tokens": job["max_new_tokens"],
            "temperature": 0.0}


t0 = time.perf_counter()
refs = [handle.stream.remote(request(p)) for p in job["together"]]
out["tokens"], out["walls_s"] = [], []
for ref in refs:
    out["tokens"].append(rt.get(ref, timeout=600)["tokens"])
    out["walls_s"].append(time.perf_counter() - t0)
t0 = time.perf_counter()
out["pickled_tokens"] = rt.get(copy.stream.remote(request(job["pickled"])),
                               timeout=600)["tokens"]
out["pickled_wall_s"] = time.perf_counter() - t0
print(json.dumps(out), flush=True)
killed_at = float(sys.stdin.readline())
gone = None
while time.perf_counter() - killed_at < 60:
    try:
        rt.get_actor(job["name"])
    except ValueError:
        gone = time.perf_counter() - killed_at
        break
    time.sleep(0.01)
print(json.dumps({"unpublished_s": gone}), flush=True)
rt.shutdown()
"""


class _SecondDriver:
    """The second driver's process (a group of its own), its stdout read
    line by line on a thread so each answer is waited for with a limit."""

    def __init__(self, addr: str, session: str):
        import queue

        from ray_tpu_torch._private.node import daemon_child_env

        with open(os.path.join(session, "second_driver.log"), "ab") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", SECOND_DRIVER, addr],
                env=daemon_child_env({"CUDA_VISIBLE_DEVICES": ""}),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
                text=True, start_new_session=True)
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True,
                         name="chip-smoke-second-driver").start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def answer(self, key: str, wait_s: float) -> dict:
        """Its next JSON line that holds ``key``."""
        import queue

        deadline = time.monotonic() + wait_s
        while True:
            try:
                line = self._lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            require(line is not None, f"the second driver gave no {key} "
                                      f"(exit {self.proc.poll()})")
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if isinstance(record, dict) and key in record:
                return record


def phase_head_restart(llama, fa, fused, served_tokens: list, device: dict,
                       power: str) -> dict:
    """The durable head and the node store's spill tier: a head process
    (``python -m ray_tpu_torch._private.node head``, its own session
    dir) and one daemon A ``{"CPU": 2, "GPU": 1, "worker": 4}`` on card 0
    with a 48 MiB node store, a driver connected by address. (a) the
    flash forward and backward in a task on A: its four results (100.7
    MB) spill to A's disk as RTS1 files, and the head's directory marks
    them; (b) a KV key, a job, and Llama-3-8B served from a named,
    detached ``num_gpus=1`` actor on A, the serve phase's first 4 greedy
    prompts (sent together) token-identical, a last KV write, a 5th
    prompt in flight when the head is SIGKILLed;
    (c) the head started again on the port and session dir: the epoch
    one higher, the WAL replayed, A back under its NodeID, the request
    completed token-identical, the actor not restarted, its name
    resolving, the KV and the job back; (d) the four results read back
    from A's disk bitwise the driver's launches, RMSNorm over o on A
    bitwise once the actor is shut down (it holds A's GPU); (e) no pid
    left, the card's free bytes and the GPU back. Between (c) and the
    actor's shutdown, (f): a second driver (a process with no card,
    connected to the restarted head) resolves the name through the
    head's directory to a ``ForeignActorHandle`` of this driver and
    sends the first HEAD_FOREIGN greedy prompts together through it and
    one through a pickled copy, token-identical; the name is withdrawn within 10 s
    of the actor's kill. After (d), (g): the driver's own ``fwd`` output
    ``put`` and handed to a ``num_gpus=1`` actor on A inside a list is
    borrowed there past every handle of the driver, normed on A bitwise
    the driver's launch, and freed by the driver within 20 s of the
    actor dropping it. The (f) and (g) results go on a ``cross_driver``
    line. Returns the kernels' launches in the phase."""
    import gc
    import signal
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental import internal_kv

    phase_start = time.perf_counter()
    config = serve_config(llama)
    _, prompts, temperatures = serve_requests(config)
    greedy = [i for i, t in enumerate(temperatures) if t == 0.0]
    free_before = _settled_free_bytes()
    want_o, want_dq, want_dk, want_dv, _ = _node_attention(HEAD_SEED)
    want_n, _ = _node_norm(want_o, HEAD_SEED)
    want = {"o": want_o, "dq": want_dq, "dk": want_dk, "dv": want_dv}
    sizes = {k: t.numel() * t.element_size() for k, t in want.items()}
    session = tempfile.mkdtemp(prefix="chip_smoke_head_")
    pids, procs = [], []
    head = daemon = second = None
    try:
        # Setup.
        start = time.perf_counter()
        head, addr = _start_head(session, 0)
        port = int(addr.rsplit(":", 1)[1])
        head_up_s = time.perf_counter() - start
        pids.append(head.pid)
        daemon = _spawn_node(
            "worker", {"gcs_address": addr,
                       "resources": {"CPU": 2.0, "GPU": 1.0, "worker": 4.0},
                       "pool_size": 2, "heartbeat_period_s": 0.5,
                       "parent_pid": os.getpid()}, session,
            {"CUDA_VISIBLE_DEVICES": "0",
             "RAY_TPU_TORCH_NODE_STORE_PRIMARY_LIMIT_MB":
                 str(HEAD_STORE_LIMIT_MB)}, "daemon_a.log")
        procs += [head, daemon]
        pids.append(daemon.pid)
        runtime = rt.init(num_cpus=0, num_gpus=0, address=addr)
        require(_until(lambda: rt.cluster_resources().get("GPU") == 1.0,
                       HEAD_WAIT_S), "daemon A did not join")
        with runtime._remote_nodes_lock:
            by_pid = {h.pool.call("exec_ping"): (nid, h)
                      for nid, h in runtime._remote_nodes.items()}
        node_a, handle_a = by_pid[daemon.pid]
        joined_s = time.perf_counter() - start

        # (a) Spill on the daemon.
        with_a = {"num_gpus": 1, "resources": {"worker": 1}}
        t0 = time.perf_counter()
        o_ref, dq_ref, dk_ref, dv_ref, counts_a_ref = rt.remote(
            num_returns=5, **with_a)(_node_attention).remote(HEAD_SEED)
        counts_a = rt.get(counts_a_ref, timeout=HEAD_WAIT_S)
        task_s = time.perf_counter() - t0
        refs = {"o": o_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref}
        hexes = {k: r.hex() for k, r in refs.items()}

        def spilled_on_a() -> dict:
            return handle_a.pool.call("executor_stats")

        require(_until(lambda: spilled_on_a()["store"]["spilled_blobs"]
                       >= 3, 60), "fewer than 3 results spilled on A")
        stats_a = spilled_on_a()
        files = _rts1_files(session, daemon.pid)

        def marks() -> dict:
            reply = _head_call(addr, "list_object_locations", None, True)
            return {} if reply is None else reply[1]

        require(_until(lambda: sum(marks().get(h) == node_a.hex()
                                   for h in hexes.values()) >= 3, 60),
                f"the head's directory marks {marks()}")
        marked = sorted(k for k, h in hexes.items()
                        if marks().get(h) == node_a.hex())

        # (b) State that must survive.
        internal_kv.internal_kv_put(b"head-restart", b"durable")
        sub_id = _head_call(addr, "submit_job",
                            f"{sys.executable} -c 'print(42)'")
        require(_until(lambda: (_head_call(addr, "job_status", sub_id)
                                or {}).get("status") == "SUCCEEDED", 60),
                "the job did not succeed")
        boot = time.perf_counter()
        actor = rt.remote(max_concurrency=16, **with_a)(
            ProcessServeActor).options(
            name="llama3-8b", lifetime="detached").remote(
            **SERVE_ENGINE, device=DEVICE)
        warm = rt.get(actor.generate.remote(
            {"tokens": prompts[0][:32], "max_new_tokens": 2}), timeout=900)
        boot_s = time.perf_counter() - boot
        require(len(warm["tokens"]) == 2, "warm-up request failed")
        serving_s = time.perf_counter() - start
        rt.get(actor.reset_counters.remote(), timeout=60)

        def request(i: int):
            return actor.stream.remote(
                {"tokens": prompts[i], "max_new_tokens": SERVE_NEW_TOKENS,
                 "temperature": 0.0})

        # Sent together; a request's wall is its submit to its last
        # token's arrival (both processes read the host's monotonic
        # clock).
        t0 = time.perf_counter()
        streams = rt.get([request(i) for i in greedy[:HEAD_GREEDY]],
                         timeout=600)
        first = [r["tokens"] for r in streams]
        walls = [r["arrivals"][-1] - t0 for r in streams]
        pid_before = rt.get(actor.counters.remote(), timeout=60)["pid"]
        pids.append(pid_before)
        steps_before = rt.get(actor.stats.remote(), timeout=60)[
            "decode_steps"]
        epoch_before = _head_call(addr, "gcs_epoch")
        inflight_i = greedy[HEAD_GREEDY]
        t_inflight = time.perf_counter()
        inflight = request(inflight_i)
        require(_until(lambda: rt.get(actor.stats.remote(), timeout=60)[
            "decode_steps"] > steps_before, 120),
            "the 5th request never decoded")
        # The last write the head acknowledges before it dies: it is in
        # the WAL only (unless a snapshot lands in between).
        internal_kv.internal_kv_put(b"last-write", b"acked")
        snapshot_before = os.path.exists(
            os.path.join(session, "gcs_snapshot.pkl"))
        wall_kill = time.perf_counter()
        _kill_group(head, signal.SIGKILL)
        in_flight_at_kill = not rt.wait([inflight], timeout=0)[0]

        # (c) Restart on the same port and session dir.
        head, _ = _start_head(session, port)
        procs.append(head)
        pids.append(head.pid)
        answered_s = time.perf_counter() - wall_kill
        epoch_after = _head_call(addr, "gcs_epoch")
        persist = _head_call(addr, "gcs_persist_stats")
        # (f)'s second driver starts now, on the restarted head: its
        # interpreter and torch load while A registers again.
        second = _SecondDriver(addr, session)
        procs.append(second.proc)
        pids.append(second.proc.pid)

        def a_back() -> bool:
            nodes = _head_call(addr, "list_nodes") or []
            stats = _head_call(addr, "node_stats") or {}
            return any(n["node_id"] == node_a.hex() and n["alive"]
                       for n in nodes) and node_a.hex() in stats

        def name_back() -> bool:
            actors = _head_call(addr, "list_cluster_actors") or []
            return any(a["name"] == "llama3-8b" and a["state"] == "ALIVE"
                       for a in actors)

        # Each from the kill to the first poll that finds it.
        since_kill: dict = {}

        def both_back() -> bool:
            for key, check in (("a", a_back), ("name", name_back)):
                if key not in since_kill and check():
                    since_kill[key] = time.perf_counter() - wall_kill
            return len(since_kill) == 2

        require(_until(both_back, HEAD_WAIT_S),
                f"back after the restart: {sorted(since_kill)} of A's "
                f"registration under its NodeID and the actor's name")
        reregistered_s, name_s = since_kill["a"], since_kill["name"]
        resolved = rt.get_actor("llama3-8b")
        done = rt.get(inflight, timeout=600)
        inflight_wall = done["arrivals"][-1] - t_inflight
        record = runtime.gcs.get_actor(actor._actor_id)
        head_record = next(a for a in _head_call(addr, "list_cluster_actors")
                           if a["name"] == "llama3-8b")
        after = rt.get(resolved.stream.remote(
            {"tokens": prompts[greedy[HEAD_GREEDY + 1]],
             "max_new_tokens": SERVE_NEW_TOKENS, "temperature": 0.0}),
            timeout=600)["tokens"]
        kv_back = [internal_kv.internal_kv_get(b"head-restart"),
                   internal_kv.internal_kv_get(b"last-write")]
        job_back = (_head_call(addr, "job_status", sub_id) or {}).get(
            "status")

        # (f) The second driver, through the directory the WAL restored.
        f_start = time.perf_counter()
        entry_back = _head_call(addr, "kv_get", b"default/llama3-8b",
                                "named_actors") is not None
        pickled_i = greedy[HEAD_GREEDY + 2]
        second.send(json.dumps({
            "name": "llama3-8b", "max_new_tokens": SERVE_NEW_TOKENS,
            "together": [prompts[i] for i in greedy[:HEAD_FOREIGN]],
            "pickled": prompts[pickled_i]}))
        foreign = second.answer("tokens", 900)
        second_up_s = foreign["init_s"]
        owner_addr = runtime._client_server_addr()
        counters = rt.get(resolved.counters.remote(), timeout=60)
        # The actor holds A's one GPU: it goes before the RMSNorm task.
        rt.get(resolved.shutdown.remote(), timeout=60)
        rt.kill(resolved)
        second.send(repr(time.perf_counter()))
        withdrawn = second.answer("unpublished_s", 90)["unpublished_s"]
        f_s = time.perf_counter() - f_start
        require(_until(lambda: second.proc.poll() is not None, 60),
                "the second driver did not end")
        require(_until(lambda: rt.available_resources().get("GPU") == 1.0,
                       60), "GPU not back after the actor")

        # (d) After the restart: the results from A's disk, through the
        # restored directory.
        locations, restored_marks = _head_call(
            addr, "list_object_locations", None, True)
        listed = sorted(k for k, h in hexes.items()
                        if node_a.hex() in locations.get(h, ()))
        stats_before_get = handle_a.pool.call("executor_stats")
        before = stats_before_get["spill"]
        spilled_before_get = stats_before_get["store"]["spilled_blobs"]
        restores_before = before["restores"]
        restore_bytes_before = before["restore_timed_bytes"]
        restore_s_before = before["restore_seconds"]
        gets_before = runtime.remote_get_stats()
        t0 = time.perf_counter()
        got = dict(zip(refs, rt.get(list(refs.values()),
                                    timeout=HEAD_WAIT_S)))
        get_s = time.perf_counter() - t0
        get_paths = _get_paths(gets_before, runtime.remote_get_stats())
        spill_stats = handle_a.pool.call("executor_stats")["spill"]
        n_ref, counts_n_ref = rt.remote(num_returns=2, **with_a)(
            _node_norm).remote(o_ref, HEAD_SEED)
        got_n, counts_n = rt.get([n_ref, counts_n_ref], timeout=HEAD_WAIT_S)
        bitwise = {k: torch.equal(got[k], want[k]) for k in want}
        bitwise["rmsnorm"] = torch.equal(got_n, want_n)
        devices = {k: t.device.type for k, t in got.items()}
        del got, got_n, n_ref, refs, o_ref, dq_ref, dk_ref, dv_ref
        require(_until(lambda: rt.available_resources().get("GPU") == 1.0,
                       60), "GPU not back after the RMSNorm task")

        # (g) A borrower on A: the driver's own fwd output (want_o, the
        # kernel's launch in this process), put and handed over inside a
        # list, so A's actor unpickles the ref and borrows it.
        g_start = time.perf_counter()
        holder = rt.remote(**with_a)(BorrowHolder).remote()
        o_put = rt.put(want_o)
        oid = o_put.id()
        held = rt.get(holder.hold.remote([o_put]), timeout=HEAD_WAIT_S)
        del o_put
        gc.collect()
        server = runtime.worker_client_server

        def borrowers() -> set:
            with server._lock:
                return set(server._borrowers.get(oid.hex(), ())) \
                    - {"__direct__"}

        t0 = time.perf_counter()
        borrowed = _until(lambda: bool(borrowers()), 30)
        borrow_wait_s = time.perf_counter() - t0
        kept = runtime.store.contains(oid)
        t0 = time.perf_counter()
        read_device, got_b, counts_b = rt.get(holder.read.remote(),
                                              timeout=HEAD_WAIT_S)
        read_s = time.perf_counter() - t0
        borrowed_bitwise = torch.equal(got_b, want_n)
        read_on = got_b.device.type
        del got_b
        dropped = rt.get(holder.drop.remote(), timeout=60)
        t0 = time.perf_counter()
        freed = _until(lambda: not runtime.store.contains(oid), 20)
        free_s = time.perf_counter() - t0
        rt.kill(holder)
        g_s = time.perf_counter() - g_start

        # (e) Teardown.
        require(_until(lambda: rt.available_resources().get("GPU") == 1.0,
                       60), "GPU not back after the borrower")
        gpu_back = [rt.available_resources().get("GPU"),
                    handle_a.pool.call("executor_stats")["available"].get(
                        "GPU")]
    finally:
        rt.shutdown()
        for proc in procs:
            if proc is not None and proc.poll() is None:
                _kill_group(proc, signal.SIGTERM)
            if proc is not None:
                _kill_group(proc)
        import shutil

        shutil.rmtree(session, ignore_errors=True)
    left = [pid for pid in pids if not _until(lambda: _pid_gone(pid), 30)]
    del want, want_o, want_dq, want_dk, want_dv, want_n
    torch.cuda.empty_cache()
    free_after = _free_back(free_before, NODE_FREE_TOL_BYTES)
    launches = {k: counts_a[k] for k in (*HOPPER_KERNELS, "flash_bwd")}
    # The actor's count covers (b), (c) and (f)'s requests.
    launches["rmsnorm"] = counts_n["rmsnorm"] + counters["rmsnorm"] \
        + counts_b["rmsnorm"]
    spill_timings = stats_a["spill"]
    result = {
        "daemon": {"resources": {"CPU": 2, "GPU": 1, "worker": 4},
                   "card": 0, "node_store_primary_limit_mb":
                       HEAD_STORE_LIMIT_MB},
        "head_up_s": head_up_s, "daemon_joined_s": joined_s,
        "head_start_to_serving_s": serving_s,
        "actor_start_and_warm_up_s": boot_s,
        "result_bytes": sizes, "task_s": task_s,
        "spilled_blobs": stats_a["store"]["spilled_blobs"],
        "rts1_files": len(files), "marked_spilled": marked,
        "spill_gb_per_s": spill_timings["spill_timed_bytes"] / 1e9
        / max(spill_timings["spill_seconds"], 1e-9),
        "restore_gb_per_s": (spill_stats["restore_timed_bytes"]
                             - restore_bytes_before) / 1e9
        / max(spill_stats["restore_seconds"] - restore_s_before, 1e-9),
        "epoch_before_after": [epoch_before, epoch_after],
        "persist_stats": persist, "snapshot_before_kill": snapshot_before,
        "in_flight_at_kill": in_flight_at_kill,
        "kill_to_head_answering_s": answered_s,
        "kill_to_reregistered_s": reregistered_s,
        "kill_to_name_resolving_s": name_s,
        "snapshot_restore_ms": (persist or {}).get("snapshot_restore_ms"),
        "first_token_identical": [t == served_tokens[i] for t, i
                                  in zip(first, greedy[:HEAD_GREEDY])],
        "request_wall_s_median": statistics.median(walls),
        "inflight_wall_s": inflight_wall,
        "inflight_token_identical": done["tokens"]
        == served_tokens[inflight_i],
        "after_token_identical": after
        == served_tokens[greedy[HEAD_GREEDY + 1]],
        "actor_pid_same": counters["pid"] == pid_before,
        "actor_num_restarts": [record.num_restarts if record else None,
                               head_record["num_restarts"]],
        "kv_back": kv_back == [b"durable", b"acked"],
        "job_back": job_back,
        "directory_lists": listed,
        "directory_marks_restored": sorted(
            k for k, h in hexes.items()
            if restored_marks.get(h) == node_a.hex()),
        "driver_get_s": get_s,
        "restores": spill_stats["restores"] - restores_before,
        "driver_get_gb_per_s": sum(sizes.values()) / 1e9
        / max(get_s, 1e-9),
        "same_host_plane": _plane_on(),
        "spilled_before_get": spilled_before_get,
        "driver_get_paths": get_paths,
        "driver_get_gb_per_s_by_path": {
            path: get_paths[path]["gb_per_s"]
            for path in ("mapped", "chunked")},
        "spill_counters": spill_stats, "bitwise": bitwise,
        "devices": devices, "gpu_driver_node": gpu_back,
        "pids_left": left, "free_bytes_before_after": [free_before,
                                                       free_after],
        "launches": launches, "card": device["kind"], "nvidia_smi": power,
        "phase_s": time.perf_counter() - phase_start}
    emit("head_restart", **result)
    require(len(files) >= 3 and result["spilled_blobs"] >= 3,
            f"{len(files)} RTS1 files on A")
    require(epoch_after == epoch_before + 1,
            f"epoch {epoch_before} -> {epoch_after}")
    require(persist is not None and persist["torn_wal_tails"] == 0
            and persist["torn_snapshots"] == 0
            and (persist["wal_records_replayed"] > 0 or snapshot_before),
            f"the restart restored nothing: {persist}")
    require(in_flight_at_kill, "the 5th request ended before the kill")
    require(all(result["first_token_identical"])
            and result["inflight_token_identical"]
            and result["after_token_identical"],
            "greedy outputs differ from the serve phase's")
    require(result["actor_pid_same"]
            and result["actor_num_restarts"] == [0, 0],
            f"the actor restarted: {result['actor_num_restarts']}")
    require(result["kv_back"] and job_back == "SUCCEEDED",
            f"KV {kv_back!r}, job {job_back}")
    require(len(listed) == 4 and len(result["directory_marks_restored"])
            >= 3 and result["restores"] >= 3,
            f"the directory lists {listed}, "
            f"{result['directory_marks_restored']} marked; "
            f"{result['restores']} restores")
    require(all(bitwise.values())
            and set(devices.values()) == {torch.device(DEVICE).type},
            f"results differ from the driver's: {bitwise} {devices}")
    # A spilled result has no segment: it comes back by the chunked pull,
    # its plan saying so; one left in memory maps (plane armed).
    n_spilled = result["spilled_before_get"]
    if result["same_host_plane"]:
        want_paths = (len(hexes) - n_spilled, n_spilled, n_spilled)
    else:
        want_paths = (0, len(hexes), 0)
    require((get_paths["mapped"]["gets"], get_paths["chunked"]["gets"],
             get_paths["spilled_plans"]) == want_paths,
            f"the driver's reads {get_paths}, expected (mapped, chunked, "
            f"spilled plans) {want_paths}")
    require(gpu_back == [1.0, 1.0], f"GPU not back: {gpu_back}")
    require(not left, f"processes left: {left}")
    require(abs(free_after - free_before) <= NODE_FREE_TOL_BYTES,
            f"free card bytes {free_before} -> {free_after}")
    require(all(counts_a[k] == 1 for k in (*HOPPER_KERNELS, "flash_bwd"))
            and counts_n["rmsnorm"] == 1 and counters["rmsnorm"] > 0,
            f"launches {counts_a}, {counts_n}, {counters['rmsnorm']}")
    cross = {
        "directory_entry_after_restart": entry_back,
        "second_driver_init_s": second_up_s,
        "handle": foreign["handle"],
        "owner_is_this_driver": foreign["owner_addr"] == owner_addr,
        "resolve_s": foreign["resolve_s"],
        "pickled_copy_equal": foreign["copy_equal"],
        "token_identical": [t == served_tokens[i] for t, i
                            in zip(foreign["tokens"], greedy[:HEAD_FOREIGN])]
        + [foreign["pickled_tokens"] == served_tokens[pickled_i]],
        # The prompts sent at once: through the proxy one after the
        # other; through the direct handle in (b) (4 of them), batched by
        # the engine.
        "foreign_walls_s": foreign["walls_s"], "direct_walls_s": walls,
        "foreign_over_direct_wall": max(foreign["walls_s"])
        / max(max(walls), 1e-9),
        "pickled_wall_s": foreign["pickled_wall_s"],
        "kill_to_unpublished_s": withdrawn,
        "f_s": f_s, "borrow_held": held, "borrowed": borrowed,
        "borrow_wait_s": borrow_wait_s, "kept_past_handles": kept,
        "read_device": [read_device, read_on], "read_s": read_s,
        "rmsnorm_bitwise": borrowed_bitwise, "dropped": dropped,
        "freed": freed, "drop_to_free_s": free_s, "g_s": g_s,
        "launches": {"rmsnorm_actor_b_c_f": counters["rmsnorm"],
                     "rmsnorm_borrower": counts_b["rmsnorm"]},
        "card": device["kind"], "nvidia_smi": power}
    emit("cross_driver", **cross)
    require(entry_back and cross["handle"] == "ForeignActorHandle"
            and cross["owner_is_this_driver"]
            and cross["pickled_copy_equal"],
            f"the second driver resolved {cross['handle']} at "
            f"{foreign['owner_addr']}, not this driver's {owner_addr}")
    require(len(cross["token_identical"]) == HEAD_FOREIGN + 1
            and all(cross["token_identical"]),
            f"foreign outputs differ: {cross['token_identical']}")
    require(withdrawn is not None and withdrawn <= 10.0,
            f"the name was withdrawn {withdrawn} s after the kill")
    require(held == "held" and borrowed and kept and dropped == "dropped",
            f"the borrow: held {held}, listed {borrowed}, kept {kept}")
    require(read_device == read_on == torch.device(DEVICE).type
            and borrowed_bitwise, f"the borrower's RMSNorm on "
                                  f"{read_device}/{read_on} differs")
    require(freed, f"the borrowed object not freed {free_s} s after drop")
    require(counts_b["rmsnorm"] == 1, f"borrower launches {counts_b}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import importlib

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import train_step

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    fused = importlib.import_module("ray_tpu_torch.ops.fused")
    device, power = timed(phase_device)
    timed(phase_build, _build, fa)
    rows = timed(phase_kernels, fa)
    timed(phase_model, llama)
    train = timed(phase_train, llama, train_step, fa, device, power)
    launches = train["launches"]
    torch.cuda.empty_cache()
    mesh = timed(phase_mesh_train, llama, train_step, fa, device, power,
                 train)
    mesh_launches = mesh["launches"]
    torch.cuda.empty_cache()
    timed(phase_ring_check, llama, fa)
    torch.cuda.empty_cache()
    moe_launches = timed(phase_moe_train, llama, train_step, fa, device,
                         power, train)["launches"]
    torch.cuda.empty_cache()
    pipeline_launches = timed(phase_pipeline_train, llama, train_step, fa,
                              device, power, train)["launches"]
    torch.cuda.empty_cache()
    timed(phase_collective_check, device, power)
    torch.cuda.empty_cache()
    trainer_launches, trainer = timed(phase_trainer, llama, fa, device,
                                      power, mesh)
    del mesh
    torch.cuda.empty_cache()
    data_launches = timed(phase_data_feed, llama, train_step, fa, device,
                          power)
    torch.cuda.empty_cache()
    timed(phase_ce_chunk_check, llama, train_step)
    torch.cuda.empty_cache()
    rows["rmsnorm"] = timed(phase_rmsnorm, fused)
    timed(phase_serve_check, llama)
    served = timed(phase_serve, llama, fused, device, power)
    launches["rmsnorm"] = served["launches"]
    check = timed(phase_runtime_check, llama, train_step, fa, fused,
                  launches)
    runtime, runtime_result = timed(phase_runtime, llama, fa, fused, served,
                                    device, power)
    torch.cuda.empty_cache()
    timed(phase_placement_check, llama, train_step, fa)
    torch.cuda.empty_cache()
    deployment_check = timed(phase_serve_deployment_check, llama, fa, fused)
    torch.cuda.empty_cache()
    deployment = timed(phase_serve_deployment, llama, fa, fused, served,
                       runtime_result, device, power)
    served_result, served_tokens = served["result"], served["tokens"]
    del served
    torch.cuda.empty_cache()
    process_check = timed(phase_process_check, fa, fused, device, power,
                          runtime_result)
    # RMSNorm's launches on inputs that rode the driver's arena: in the
    # process actor (process_check), then on daemon B (node_cluster).
    arena_launches = {"rmsnorm": process_check["arena"]["512KiB"][
        "launches"]}
    torch.cuda.empty_cache()
    process_launches = timed(
        phase_process_trainer, llama, fa, device, power,
        {**trainer, "launches": trainer_launches})
    process_served = timed(
        phase_process_serve, llama, served_result, served_tokens,
        runtime_result, device, power)
    process_launches["rmsnorm"] = process_served["rmsnorm"]
    torch.cuda.empty_cache()
    store_launches = timed(phase_store_recovery, llama, train_step, fa,
                           fused, device, power)
    torch.cuda.empty_cache()
    node_launches, gang_launches, node_arena_launches, \
        task_pipeline_launches = timed(
            phase_node_cluster, llama, fa, fused, served_result,
            served_tokens, process_served["summary"], runtime_result, train,
            device, power)
    arena_launches["rmsnorm"] += node_arena_launches
    torch.cuda.empty_cache()
    restart_launches = timed(phase_head_restart, llama, fa, fused,
                             served_tokens, device, power)
    emit("phase_walls", walls_s=PHASE_WALLS,
         total_s=sum(PHASE_WALLS.values()), card=device["kind"],
         nvidia_smi=power)
    for kind, row in rows.items():
        row["launches"] = launches[kind]
        # bench.py's mesh path (mesh_train); training's norms are
        # llama.rms_norm, as in the reference, so RMSNorm has none.
        row["mesh_launches"] = mesh_launches.get(kind, 0)
        # bench.py's model as a MoE through the mesh path (moe_train) and
        # the dense model through the pipeline (pipeline_train).
        row["moe_launches"] = moe_launches.get(kind, 0)
        row["pipeline_launches"] = pipeline_launches.get(kind, 0)
        # bench.py's mesh path as MeshTrainer's train loop (trainer); as
        # in every training path, RMSNorm has none.
        row["trainer_launches"] = trainer_launches.get(kind, 0)
        # bench.py's batches from a Dataset through the device feed
        # (data_feed: the plain step and MeshTrainer's datasets= path).
        row["data_launches"] = data_launches.get(kind, 0)
        # The same kernels driven through the runtime: the flash kernels
        # by runtime_check's train task, RMSNorm by both phases' actors.
        row["runtime_launches"] = check[kind] + runtime[kind]
        # And through serve deployments (the serving path runs no flash
        # kernel).
        row["deployment_launches"] = deployment_check[kind] \
            + deployment[kind]
        # And in worker processes: the flash kernels in process_trainer's
        # gang process, RMSNorm in process_serve's actor process.
        row["process_launches"] = process_launches.get(kind, 0)
        # And through the store_recovery phase: the flash kernels in the
        # steps from the restored TrainState and in the tasks lineage
        # rebuilds, RMSNorm in the rebuilt chain task.
        row["store_launches"] = store_launches.get(kind, 0)
        # And on the node daemons (node_cluster): the flash kernels in the
        # task on node A, RMSNorm in the task on B and in the remote
        # serving actor, before and after its restart.
        row["node_launches"] = node_launches.get(kind, 0)
        # And in node_cluster's one-process GPU gang on daemon A: the
        # flash kernels of its bench.py steps (training: no RMSNorm).
        row["daemon_gang_launches"] = gang_launches.get(kind, 0)
        # And across a head restart (head_restart): the flash kernels in
        # the task on A whose results spilled, RMSNorm in the named
        # serving actor and in the task over the restored output.
        row["restart_launches"] = restart_launches.get(kind, 0)
        # And on inputs that rode the driver's native arena: RMSNorm in
        # process_check's actor and in node_cluster's task on B (the
        # flash kernels' inputs are larger than the arena's cap).
        row["arena_launches"] = arena_launches.get(kind, 0)
        # And through the pipelined task path (node_cluster's (a'')):
        # RMSNorm in the num_gpus=1 tasks the submit ring carried to B
        # (the flash kernels' task on A rides it too, counted in
        # node_launches).
        row["task_pipeline_launches"] = task_pipeline_launches.get(kind, 0)
    missing = [k for k in HOPPER_KERNELS if not rows[k]["trainer_launches"]]
    require(not missing, f"kernels not launched through the trainer: "
                         f"{missing}")
    missing = [k for k in (*HOPPER_KERNELS, "flash_bwd")
               if not rows[k]["data_launches"]]
    require(not missing, f"kernels not launched through the data feed: "
                         f"{missing}")
    missing = [k for k, row in rows.items() if not row["runtime_launches"]]
    require(not missing, f"kernels not launched through the runtime: "
                         f"{missing}")
    require(rows["rmsnorm"]["deployment_launches"] > 0,
            "RMSNorm not launched through the serve deployments")
    missing = [k for k, row in rows.items() if not row["process_launches"]]
    require(not missing, f"kernels not launched in a worker process: "
                         f"{missing}")
    missing = [k for k, row in rows.items() if not row["store_launches"]]
    require(not missing, f"kernels not launched in the store_recovery "
                         f"phase: {missing}")
    missing = [k for k, row in rows.items() if not row["node_launches"]]
    require(not missing, f"kernels not launched on the node daemons: "
                         f"{missing}")
    missing = [k for k in (*HOPPER_KERNELS, "flash_bwd")
               if not rows[k]["daemon_gang_launches"]]
    require(not missing, f"kernels not launched in the daemon gang: "
                         f"{missing}")
    require(rows["rmsnorm"]["arena_launches"] == ARENA_TRIPS + 2,
            f"RMSNorm on the arena's inputs: "
            f"{rows['rmsnorm']['arena_launches']} launches, "
            f"{ARENA_TRIPS + 2} expected (process_check's 512 KiB trips, "
            f"node_cluster's two reads on B)")
    require(rows["rmsnorm"]["task_pipeline_launches"] == PIPE_NORMS,
            f"RMSNorm through the submit ring on B: "
            f"{rows['rmsnorm']['task_pipeline_launches']} launches, "
            f"{PIPE_NORMS} expected")
    missing = [k for k, row in rows.items() if not row["restart_launches"]]
    require(not missing, f"kernels not launched across the head restart: "
                         f"{missing}")
    order = (*KERNELS, "flash_bwd")
    print(json.dumps({"kernels": [rows[k] for k in order]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
