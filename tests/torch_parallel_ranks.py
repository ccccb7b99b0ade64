"""The ranks of ``tests/test_torch_parallel.py``: 8 gloo processes on the
CPU, each running every case of the port's sharded path on the same
inputs, each case on the mesh it needs. This module imports torch and the
port only (never JAX): the test spawns its functions, and keeps the JAX
oracle in its own process.

``start_ranks`` starts the world, ``join_ranks`` waits for it and
``rank_main`` is one rank, running the ``CASES`` of a module (this one by
default; ``tests/torch_pipeline_ranks.py`` passes its own). Every rank
writes ``rank<r>.pkl`` into the output directory after each case: each
finished case's results (numpy arrays and plain values) and the
traceback of each case that raised, so a case that hangs costs only
itself and the cases after it.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import importlib
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8
# A collective of the default group that never completes fails after
# this (the mesh's groups take _private/dist.py's DEFAULT_TIMEOUT).
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _mesh(**sizes):
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    return build_mesh(MeshConfig(**sizes), device="cpu")


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def case_ring(inputs) -> dict:
    """ring_attention_sharded at sp=4 x dp=2, causal and full, and the
    gradient of a causal ring through its shifts."""
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded

    mesh = _mesh(sp=4, dp=2)
    q, k, v = (_t(a) for a in inputs["ring_qkv"])
    out = {f"ring_{c}": _np(ring_attention_sharded(q, k, v, mesh, causal=c))
           for c in (True, False)}
    g = _t(inputs["ring_grad_q"]).requires_grad_(True)
    ring_attention_sharded(g, g, g, mesh, causal=True).sum().backward()
    out["ring_grad"] = _np(g.grad)
    return out


def case_ulysses(inputs) -> dict:
    """ulysses_attention inside local_map at sp=4 x dp=2, batch over dp,
    sequence over sp."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.ring_attention import ulysses_attention
    from ray_tpu_torch.parallel.sharding import placements

    mesh = _mesh(sp=4, dp=2)
    where = placements(mesh, (("dp",), "sp", None, None))
    q, k, v = (distribute_tensor(_t(a), mesh, where)
               for a in inputs["ulysses_qkv"])
    out = {}
    for causal in (True, False):
        fn = local_map(functools.partial(ulysses_attention, axis_name="sp",
                                         causal=causal, mesh=mesh),
                       out_placements=where, in_placements=(where,) * 3,
                       device_mesh=mesh)
        out[f"ulysses_{causal}"] = _np(fn(q, k, v).full_tensor())
    return out


def case_flash(inputs) -> dict:
    """flash_attention_gspmd at dp=2 x tp=2 (sp=2, over which the flash
    spec gathers the sequence): output and the gradients of
    sum(out * dout), GQA 4/2 heads."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.ops.flash_attention import flash_attention_gspmd
    from ray_tpu_torch.parallel.sharding import logical_to_spec, placements

    mesh = _mesh(dp=2, sp=2, tp=2)
    where = placements(mesh, logical_to_spec(
        ("batch", "sequence", "heads", None)))
    q, k, v = (distribute_tensor(_t(a), mesh, where).requires_grad_(True)
               for a in inputs["flash_qkv"])
    o = flash_attention_gspmd(q, k, v, causal=True)
    placed = [str(p) for p in o.placements]
    o = o.full_tensor()
    (o * _t(inputs["flash_dout"])).sum().backward()
    return {"flash_o": _np(o), "flash_o_placements": placed,
            **{f"flash_d{n}": _np(t.grad.full_tensor())
               for n, t in zip("qkv", (q, k, v))}}


def _tiny_f32():
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)


def case_ring_logits(inputs) -> dict:
    """The tiny Llama (f32) with attention="ring" at sp=4 x dp=2, its
    params placed per param_logical_axes: global logits."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.sharding import shard_params

    mesh = _mesh(sp=4, dp=2)
    cfg = dataclasses.replace(_tiny_f32(), attention="ring")
    params = shard_params(params_from_numpy(inputs["llama_params"], "cpu"),
                          mesh, llama.param_logical_axes(cfg))
    with torch.no_grad():
        logits = llama.forward(params, _t(inputs["ring_tokens"]).long(),
                               cfg)
    return {"ring_logits": _np(logits.full_tensor())}


def case_ring_local_logits(inputs) -> dict:
    """The same model and tokens with attention="ring_local": the forward
    runs on each rank's (batch, sequence) shard of the tokens and the
    global positions inside local_map, under set_mesh (the ring finds
    its sp group on the ambient mesh), with the params as plain tensors
    on every rank."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.mesh import set_mesh
    from ray_tpu_torch.parallel.sharding import placements

    mesh = _mesh(sp=4, dp=2)
    cfg = dataclasses.replace(_tiny_f32(), attention="ring_local")
    params = params_from_numpy(inputs["llama_params"], "cpu")
    tokens = _t(inputs["ring_tokens"]).long()
    b, l = tokens.shape
    positions = torch.arange(l).expand(b, l).contiguous()
    where = placements(mesh, (("dp", "fsdp"), "sp"))

    def body(tokens, positions):
        return llama.forward(params, tokens, cfg, positions)

    forward = local_map(body, out_placements=placements(
        mesh, (("dp", "fsdp"), "sp", None)), in_placements=(where, where),
        device_mesh=mesh)
    with set_mesh(mesh), torch.no_grad():
        logits = forward(distribute_tensor(tokens, mesh, where),
                         distribute_tensor(positions, mesh, where))
    return {"ring_local_logits": _np(logits.full_tensor())}


def case_train(inputs) -> dict:
    """8 steps of the sharded train step at dp=2 x fsdp=2 x tp=2: loss
    and grad norm per step, and each param's placements after."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.sharding import (
        logical_to_spec,
        placements,
    )
    from ray_tpu_torch.parallel.train_step import (
        build_train_step,
        create_train_state,
        default_optimizer,
        shard_batch,
    )

    mesh = _mesh(dp=2, fsdp=2, tp=2)
    cfg = _tiny_f32()
    optimizer = default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                  total_steps=50)
    axes = llama.param_logical_axes(cfg)
    state = create_train_state(
        params_from_numpy(inputs["llama_params"], "cpu"), optimizer, mesh,
        axes)
    tokens = _t(inputs["train_tokens"])
    batch = shard_batch({"tokens": tokens[:, :-1], "targets": tokens[:, 1:]},
                        mesh)

    def loss(params, batch):
        return llama.loss_fn(params, batch["tokens"], batch["targets"], cfg)

    step = build_train_step(loss, optimizer)
    trajectory = []
    for _ in range(inputs["train_steps"]):
        state, metrics = step(state, batch)
        trajectory.append((metrics["loss"].item(),
                           metrics["grad_norm"].item()))
    leaves = tree_leaves(state.params)
    expected = [str(placements(mesh, logical_to_spec(a)))
                for a in tree_leaves(axes)]
    return {
        "train_trajectory": trajectory,
        "train_all_dtensor": all(isinstance(p, DTensor) for p in leaves),
        "train_placements": [str(list(p.placements)) for p in leaves],
        "train_expected_placements": expected,
        "train_moments_placed": all(
            isinstance(m, DTensor) and m.placements == p.placements
            for p, m in zip(leaves, tree_leaves(state.opt_state["mu"]))),
    }


def case_shard_batch(inputs) -> dict:
    """shard_batch's placements and local shapes on two meshes."""
    from ray_tpu_torch.parallel.train_step import shard_batch

    out = {}
    for name, sizes in (("dp_fsdp_tp", {"dp": 2, "fsdp": 2, "tp": 2}),
                        ("sp_dp", {"sp": 4, "dp": 2})):
        mesh = _mesh(**sizes)
        batch = shard_batch({"tokens": np.zeros((4, 32), np.int32),
                             "mask": np.ones((4,), np.float32),
                             "scale": np.float32(2.0)}, mesh)
        out[f"shard_batch_{name}"] = {
            key: (str(list(t.placements)), tuple(t.to_local().shape),
                  str(t.dtype))
            for key, t in batch.items()}
    return out


class _F32Product(torch.autograd.Function):
    """The lm head's ``_F32Logits`` with an f32 product in place of
    ``mm(out_dtype=)``, which has no CPU kernel; the same backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.t(), x.t() @ g


def case_lm_head(inputs) -> dict:
    """The card's lm head on local shards (``_lm_head_local``), its
    product stood in by ``_F32Product``: logits and the gradients of
    sum(logits * dlogits) on three meshes, x in the residual stream's
    layout and w per ("embed", "vocab")."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.sharding import constrain

    x, w, dout = (_t(a) for a in inputs["lm_head"])
    out = {}
    real, llama._F32Logits = llama._F32Logits, _F32Product
    try:
        for name, sizes in (("dp_fsdp_tp", {"dp": 2, "fsdp": 2, "tp": 2}),
                            ("sp_dp", {"sp": 4, "dp": 2}),
                            ("tp", {"tp": 8})):
            mesh = _mesh(**sizes)
            xd = constrain(x, mesh, *llama.RESIDUAL).requires_grad_(True)
            wd = constrain(w, mesh, "embed", "vocab").requires_grad_(True)
            logits = llama._lm_head_local(xd, wd).full_tensor()
            (logits * dout).sum().backward()
            out[f"lm_head_{name}"] = (_np(logits), _np(xd.grad.full_tensor()),
                                      _np(wd.grad.full_tensor()))
    finally:
        llama._F32Logits = real
    return out


CASES = (case_ring, case_ulysses, case_flash, case_ring_logits,
         case_ring_local_logits, case_train, case_shard_batch, case_lm_head)


def _write(out_dir: str, rank: int, record: dict) -> None:
    path = Path(out_dir) / f"rank{rank}.pkl"
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(record))
    tmp.replace(path)


def rank_main(rank: int, store: str, out_dir: str, inputs: dict,
              module: str = __name__) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    # Eight busy ranks beside the suite's other workers: yield the CPU to
    # them, whose tests may time threads and processes.
    os.nice(10)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=COLLECTIVE_TIMEOUT)
    record = {"results": {}, "errors": {}, "seconds": {}}
    try:
        for case in importlib.import_module(module).CASES:
            start = time.perf_counter()
            try:
                record["results"].update(case(inputs))
            except Exception:  # noqa: BLE001 - reported by the test
                record["errors"][case.__name__] = traceback.format_exc()
            record["seconds"][case.__name__] = time.perf_counter() - start
            _write(out_dir, rank, record)
    finally:
        _write(out_dir, rank, record)
        dist.destroy_process_group()


def start_ranks(out_dir: Path, inputs: dict, module: str = __name__) -> list:
    """Spawn the WORLD ranks (``spawn`` context, a ``file://`` store in
    ``out_dir``, so that concurrent runs never share a port), each
    running ``module``'s ``CASES``."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(rank, str(out_dir / "store"), str(out_dir),
                               inputs, module), daemon=True)
             for rank in range(WORLD)]
    for proc in procs:
        proc.start()
    return procs


def join_ranks(procs: list, out_dir: Path, timeout_s: float) -> list:
    """Wait for every rank up to ``timeout_s`` in all, kill what is left,
    and return each rank's record (None for a rank that wrote none)."""
    deadline = time.monotonic() + timeout_s
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    records = []
    for rank in range(len(procs)):
        path = out_dir / f"rank{rank}.pkl"
        records.append(pickle.loads(path.read_bytes()) if path.exists()
                       else None)
    return records
