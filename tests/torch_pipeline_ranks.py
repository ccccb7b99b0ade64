"""The ranks of ``tests/test_torch_pipeline.py``: 8 gloo processes on the
CPU, each running every case of the port's pipeline and MoE paths on the
same inputs, each case on the mesh it needs. This module imports torch
and the port only (never JAX): the test spawns its cases through
``torch_parallel_ranks.start_ranks`` and keeps the JAX oracle in its own
process.
"""

from __future__ import annotations

import dataclasses

import torch

from torch_parallel_ranks import _mesh, _np, _t


def _tiny(num_experts: int = 0, **changes):
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                               num_experts=num_experts, **changes)


def _params(inputs, key: str) -> dict:
    from ray_tpu_torch.models.convert import params_from_numpy

    return params_from_numpy(inputs[key], "cpu")


def _toy_stage(stage_w, h):
    for w in stage_w:
        h = torch.tanh(h @ w)
    return h


def case_pipeline_apply(inputs) -> dict:
    """The toy pipeline (8 "layers" of tanh(h @ w)) at pp=4 x dp=2, 2
    microbatches, on plain tensors under set_mesh; then 4 stages on a
    pp=2 x dp=4 mesh, which must be refused."""
    from ray_tpu_torch.parallel.mesh import set_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, split_stages

    w, x = _t(inputs["toy_w"]), _t(inputs["toy_x"])
    with set_mesh(_mesh(pp=4, dp=2)):
        out = pipeline_apply(_toy_stage, split_stages(w, 4), x,
                             num_microbatches=2)
    with set_mesh(_mesh(pp=2, dp=4)):
        try:
            pipeline_apply(_toy_stage, split_stages(w, 4), x,
                           num_microbatches=2)
            refused = None
        except ValueError as e:
            refused = str(e)
    return {"toy_out": _np(out), "toy_refused": refused}


def case_pipeline_llama(inputs) -> dict:
    """llama_pipeline_forward at pp=2 x dp=2 x tp=2, 2 stages, 2
    microbatches: logits without tp_axis (tp replicated), with
    tp_axis="tp" (MHA and GQA), and every param's gradient of the
    pipelined tp loss."""
    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import set_mesh
    from ray_tpu_torch.parallel.pipeline import llama_pipeline_forward

    mesh = _mesh(pp=2, dp=2, tp=2)
    tokens = _t(inputs["pp_tokens"]).long()
    out = {}
    with set_mesh(mesh), torch.no_grad():
        for name, kv_heads, key, tp_axis in (
                ("pp_logits", 4, "pp_params", None),
                ("pp_tp_logits", 4, "pp_params", "tp"),
                ("pp_tp_gqa_logits", 2, "pp_gqa_params", "tp")):
            out[name] = _np(llama_pipeline_forward(
                _params(inputs, key), tokens, _tiny(num_kv_heads=kv_heads),
                num_stages=2, num_microbatches=2, tp_axis=tp_axis))
    params = _params(inputs, "pp_params")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = _t(inputs["pp_grad_tokens"]).long()
    with set_mesh(mesh):
        logits = llama_pipeline_forward(params, toks[:, :-1], _tiny(),
                                        num_stages=2, num_microbatches=2,
                                        tp_axis="tp")
        loss = llama.cross_entropy(logits, toks[:, 1:])
        grads = torch.autograd.grad(loss, leaves)
    out["pp_tp_loss"] = loss.item()
    out["pp_tp_grads"] = [_np(g) for g in grads]
    return out


def case_pipeline_moe(inputs) -> dict:
    """The MoE config (4 experts) through the pipeline at pp=2 x dp=4:
    logits and the aux carried through the stages."""
    from ray_tpu_torch.parallel.mesh import set_mesh
    from ray_tpu_torch.parallel.pipeline import llama_pipeline_forward

    with set_mesh(_mesh(pp=2, dp=4)), torch.no_grad():
        logits, aux = llama_pipeline_forward(
            _params(inputs, "moe_params"), _t(inputs["moe_tokens"]).long(),
            _tiny(4), num_stages=2, num_microbatches=2, with_aux=True)
    return {"pp_moe_logits": _np(logits), "pp_moe_aux": aux.item()}


def case_moe_ep(inputs) -> dict:
    """The MoE config's forward at dp=2 x ep=4, its params placed per
    param_logical_axes (experts over ep): logits and aux."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.sharding import shard_params

    cfg = _tiny(4)
    mesh = _mesh(dp=2, ep=4)
    params = shard_params(_params(inputs, "moe_params"), mesh,
                          llama.param_logical_axes(cfg))
    with torch.no_grad():
        logits, aux = llama.forward(params, _t(inputs["ep_tokens"]).long(),
                                    cfg, with_aux=True)
    return {"ep_logits": _np(logits.full_tensor()),
            "ep_aux": aux.full_tensor().item(),
            "ep_w_gate_placements": str(list(
                params["layers"]["w_gate"].placements))}


def case_moe_train(inputs) -> dict:
    """The MoE train step (2 experts) at dp=2 x ep=2 x tp=2: loss and
    grad norm per step, and whether every param and moment is still a
    DTensor in its placements after the steps."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.sharding import logical_to_spec, placements
    from ray_tpu_torch.parallel.train_step import (
        build_train_step,
        create_train_state,
        default_optimizer,
        shard_batch,
    )

    cfg = _tiny(2)
    mesh = _mesh(dp=2, ep=2, tp=2)
    optimizer = default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                  total_steps=50)
    axes = llama.param_logical_axes(cfg)
    state = create_train_state(_params(inputs, "train_params"), optimizer,
                               mesh, axes)
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
    want = [placements(mesh, logical_to_spec(a)) for a in tree_leaves(axes)]
    return {
        "moe_train_trajectory": trajectory,
        "moe_train_placed": all(
            isinstance(p, DTensor) and list(p.placements) == w
            and isinstance(m, DTensor) and m.placements == p.placements
            for p, w, m in zip(leaves, want,
                               tree_leaves(state.opt_state["mu"]))),
    }


CASES = (case_pipeline_apply, case_pipeline_llama, case_pipeline_moe,
         case_moe_ep, case_moe_train)
