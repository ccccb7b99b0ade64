"""Pipeline parallelism: GPipe-style microbatched stage schedule.

The port of ``ray_tpu/parallel/pipeline.py``:

- Stage parameters carry a leading ``[num_stages, ...]`` dim split over
  the mesh's ``pp`` axis (logical axis "stage" in the rule table).
- ``pipeline_apply`` drops into ``local_map`` over ``pp`` and the batch
  axes, where the reference drops into ``shard_map``. Each rank runs ONE
  stage; its batch shard splits into microbatches; at every tick each
  stage processes one microbatch and hands its activation to the next
  stage, the classic GPipe fill/steady/drain schedule of
  ``num_microbatches + num_stages - 1`` ticks.
- The tick loop is a Python loop (the reference's ``lax.scan``), and each
  stage application runs under ``torch.utils.checkpoint`` (its
  ``jax.checkpoint``), so activation memory stays O(microbatch).

The reference's ``ppermute`` (stage i -> i+1) is ``_StageShift``, a
differentiable exchange over the ``pp`` group whose backward shifts the
gradients i+1 -> i; what stage 0 receives round the ring is zeroed. As in
the reference, every stage runs at every tick and the fill and drain
ticks compute on zeros, and the stage input, the collected outputs and
the aux are selected by masks (``torch.where``), never by branching: the
autograd graph then has the same nodes on every rank, so each rank takes
part in every exchange of the backward. The sum over ``pp`` of the
outputs (only the last stage's are not zero) and of the aux are DTensor
``Partial`` placements reduced on the way out.

Composability: pp composes with dp/fsdp (batch axes in the specs), and
``llama_pipeline_forward``'s ``tp_axis`` runs Megatron tensor parallelism
inside a stage (``models/llama.py``'s manual path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models import llama as llama_mod
from ray_tpu_torch.parallel.mesh import ambient_mesh, mesh_axis_size, set_mesh
from ray_tpu_torch.parallel.ring_attention import _exchange, axis_group
from ray_tpu_torch.parallel.sharding import partial_over, placements


def split_stages(stacked: Any, num_stages: int) -> Any:
    """[L, ...] layer-stacked params -> [S, L/S, ...] stage-stacked."""

    def reshape(x):
        n = x.shape[0]
        if n % num_stages:
            raise ValueError(
                f"{n} layers not divisible into {num_stages} stages")
        return x.reshape(num_stages, n // num_stages, *x.shape[1:])

    return tree_map(reshape, stacked)


def merge_stages(staged: Any) -> Any:
    """Inverse of split_stages."""
    return tree_map(
        lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), staged)


class _StageShift(torch.autograd.Function):
    """``lax.ppermute`` with perm ``i -> i+1`` over the ``pp`` group:
    stage i receives stage i-1's activation (stage 0 receives zeros). The
    backward hands stage i's gradient back to stage i-1."""

    @staticmethod
    def forward(ctx, group, n, idx, y):
        ctx.group, ctx.n, ctx.idx = group, n, idx
        if n == 1:
            return torch.zeros_like(y)
        (got,) = _exchange((y,), group, (idx + 1) % n, (idx - 1) % n)
        return got.zero_() if idx == 0 else got

    @staticmethod
    def backward(ctx, g):
        n, idx = ctx.n, ctx.idx
        if n == 1:
            return None, None, None, torch.zeros_like(g)
        (got,) = _exchange((g,), ctx.group, (idx - 1) % n, (idx + 1) % n)
        return None, None, None, got.zero_() if idx == n - 1 else got


def _select(flag: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.where`` on a flag known on the host: both branches stay in
    the autograd graph (the other one's gradient is zeros)."""
    return torch.where(torch.tensor(flag, device=a.device), a, b)


def _rebuild(tree: Any, leaves) -> Any:
    """``tree`` with its leaves taken from the iterator ``leaves`` in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    return next(leaves)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor, *,
                   num_microbatches: int, axis_name: str = "pp",
                   batch_axes: tuple = ("dp", "fsdp"),
                   param_specs: Any = None, with_aux: bool = False):
    """Run ``x`` through all pipeline stages over the mesh of the DTensor
    inputs, or the ambient mesh (``set_mesh``) for plain ones.

    stage_params: tree (nested dicts) with leading [S, ...] dim (one slice
    per stage). x: [B, ...] activations; B must divide by
    num_microbatches on each data shard. Returns activations after the
    last stage, replicated over pp. Plain tensors are taken as global
    tensors, the same on every rank, and the result is then the global
    tensor; DTensors give a DTensor.

    param_specs: optional tree of per-leaf specs (``parallel.sharding``
    tuples) for stage_params when non-stage dims are split too (tp inside
    a stage); defaults to splitting only the leading stage dim over
    ``axis_name``.
    with_aux: ``stage_fn`` returns ``(y, aux_scalar)``; the pipeline
    accumulates aux only over VALID ticks (fill/drain ticks process
    zeros), sums stages (each holds different layers), means over the
    data axes, and normalizes by microbatch count so the value matches
    the unpipelined forward.
    """
    leaves = tree_leaves(stage_params)
    dtensor = next((t for t in (x, *leaves) if isinstance(t, DTensor)), None)
    mesh = dtensor.device_mesh if dtensor is not None else ambient_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass DTensors, or call inside set_mesh")
    plain = not isinstance(x, DTensor)
    replicate = [Replicate()] * mesh.ndim

    def placed(t):
        if isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, mesh, replicate, run_check=False)

    if param_specs is None:
        param_specs = tree_map(lambda _: (axis_name,), stage_params)
    x_at = placements(mesh, (tuple(batch_axes),))
    # Specs are tuples, leaves of the tree.
    param_at = [placements(mesh, spec) for spec in tree_leaves(param_specs)]
    # Grads: stage params are replicated over the batch axes, so each
    # data shard's gradient is a partial sum; the input feeds stage 0
    # only, so its gradient is a partial sum over pp, as is the output,
    # which only the last stage's is not zero.
    dparam_at = [partial_over(mesh, at, batch_axes) for at in param_at]
    dx_at = out_at = partial_over(mesh, x_at, (axis_name,))
    aux_at = partial_over(mesh, replicate, (axis_name, *batch_axes))
    data_shards = math.prod(mesh_axis_size(mesh, a) for a in batch_axes)

    def run(*local_args):
        *local_leaves, x_local = local_args
        # Each rank must hold exactly ONE stage; if num_stages exceeds
        # the pp axis size, every rank would get several stage slices and
        # the squeeze below would silently drop layers.
        leading = {p.shape[0] for p in local_leaves}
        if leading != {1}:
            raise ValueError(
                f"stage count must equal the {axis_name!r} mesh axis size "
                f"(got local stage dims {sorted(leading)})")
        local_params = _rebuild(stage_params, iter(p[0] for p in local_leaves))
        group, num_stages, stage_idx = axis_group(mesh, axis_name)
        batch = x_local.shape[0]
        if batch % num_microbatches:
            raise ValueError(
                f"local batch {batch} not divisible by "
                f"{num_microbatches} microbatches")
        mb = batch // num_microbatches
        xm = x_local.reshape(num_microbatches, mb, *x_local.shape[1:])
        ticks = num_microbatches + num_stages - 1

        def stage_with_aux(params, inp):
            # Under the mesh here, not around the loop: the checkpoint
            # reruns this in the backward, where a stage's manual tp finds
            # its group on the ambient mesh.
            with set_mesh(mesh):
                out = stage_fn(params, inp)
            if with_aux:
                return out
            return out, torch.zeros((), dtype=torch.float32,
                                    device=inp.device)

        zero = torch.zeros((), dtype=torch.float32, device=x_local.device)
        state = torch.zeros_like(xm[0])
        slots = [torch.zeros_like(xm[0])] * num_microbatches
        aux_acc = zero
        first, last = stage_idx == 0, stage_idx == num_stages - 1
        for t in range(ticks):
            # Stage 0 ingests microbatch t during the fill/steady phase;
            # later stages consume what the previous stage shifted in.
            inp = _select(first, xm[min(t, num_microbatches - 1)], state)
            y, aux = torch.utils.checkpoint.checkpoint(
                stage_with_aux, local_params, inp, use_reentrant=False)
            # Stage s holds real data only at ticks [s, s + M): mask the
            # aux contributions of the fill/drain ticks.
            valid = stage_idx <= t < stage_idx + num_microbatches
            aux_acc = aux_acc + _select(valid, aux, zero)
            # The last stage completes microbatch j = t - (S - 1).
            j = t - (num_stages - 1)
            slots[max(j, 0)] = _select(last and j >= 0, y, slots[max(j, 0)])
            # Hand activations down the ring (stage i -> i+1). The
            # reference shifts after the last tick too and drops the
            # result; this skips that dead shift.
            if t + 1 < ticks:
                state = _StageShift.apply(group, num_stages, stage_idx, y)
        out = torch.cat(slots, dim=0)
        # Only the last stage holds real outputs: a partial sum over pp.
        # The aux: a sum over stages, a mean over the data shards and over
        # the microbatches.
        return out, aux_acc / (num_microbatches * data_shards)

    out, aux = local_map(
        run, out_placements=(out_at, aux_at),
        in_placements=(*param_at, x_at),
        in_grad_placements=(*dparam_at, dx_at), device_mesh=mesh,
        redistribute_inputs=True)(*(placed(t) for t in (*leaves, x)))
    out = out.redistribute(mesh, x_at)
    aux = aux.redistribute(mesh, replicate)
    if plain:
        out, aux = out.full_tensor(), aux.full_tensor()
    return (out, aux) if with_aux else out


def _staged_param_specs(staged: dict, tp_axis: str | None,
                        pp_axis: str) -> dict:
    """Per-leaf specs: leading stage dim over pp; with tp, the head/mlp
    dims follow the Megatron sharding (column-parallel qkv/gate/up,
    row-parallel o/down). Stacked leaf layout is
    [S, layers_per_stage, *param_dims]."""
    if tp_axis is None:
        return {key: (pp_axis,) for key in staged}
    tp_dim = {  # param-dim index (after the [S, Ls] prefix) to split
        "wq": 1, "wk": 1, "wv": 1,     # [E, heads, D] -> heads
        "wo": 0,                        # [heads, D, E] -> heads
        "w_gate": 1, "w_up": 1,        # [E, M] -> M
        "w_down": 0,                    # [M, E] -> M
        "w_router": None, "attn_norm": None, "mlp_norm": None,
    }
    out = {}
    for key, leaf in staged.items():
        dim = tp_dim.get(key)
        if dim is None:
            out[key] = (pp_axis,)
        else:
            spec = [pp_axis] + [None] * (leaf.ndim - 1)
            spec[2 + dim] = tp_axis
            out[key] = tuple(spec)
    return out


def llama_pipeline_forward(params: dict, tokens: torch.Tensor, config,
                           num_stages: int, num_microbatches: int,
                           positions: torch.Tensor | None = None,
                           tp_axis: str | None = None,
                           with_aux: bool = False):
    """Llama forward with the layer stack pipelined over ``pp``.

    Embedding and the LM head run outside the pipeline (replicated over
    pp, placed per the usual rules); the transformer stack is split into
    ``num_stages`` stages of consecutive layers.

    ``tp_axis`` runs Megatron-style tensor parallelism INSIDE each stage
    (qkv/gate/up column-parallel, o/down row-parallel, explicit sums
    over the axis's group, on local shards inside ``local_map``); MoE
    configs route each token through the expert MLP and carry the
    load-balancing aux loss through the pipeline (``with_aux=True`` to
    receive it).
    """
    if positions is not None:
        raise NotImplementedError(
            "pipelined forward assumes contiguous positions (computed "
            "inside each stage)")
    moe = config.num_experts > 0
    if moe and tp_axis is not None:
        raise NotImplementedError(
            "MoE inside the pipeline shards experts, not mlp columns; "
            "combine pp x ep instead of pp x tp for MoE configs")
    cfg = dataclasses.replace(config, remat=False)  # remat per stage here
    llama_mod._check_config(cfg)
    x, _ = llama_mod._embed(params, tokens, None, cfg)
    staged = split_stages(params["layers"], num_stages)
    param_specs = _staged_param_specs(staged, tp_axis, "pp")

    def stage_fn(stage_layers, h):
        mb, l = h.shape[0], h.shape[1]
        pos = torch.arange(l, device=h.device).expand(mb, l)
        aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        names = sorted(stage_layers)
        stacked = [stage_layers[name].unbind(0) for name in names]
        for weights in zip(*stacked):
            out = llama_mod._layer(dict(zip(names, weights)), h, pos, cfg,
                                   tp_axis)
            if moe:
                h, aux = out
                aux_sum = aux_sum + aux
            else:
                h = out
        return (h, aux_sum) if moe else h

    result = pipeline_apply(stage_fn, staged, x,
                            num_microbatches=num_microbatches,
                            param_specs=param_specs, with_aux=moe)
    if moe:
        x, aux = result
    else:
        x, aux = result, torch.zeros((), dtype=torch.float32,
                                     device=tokens.device)
    x = llama_mod.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = llama_mod._lm_head(x, params["lm_head"].to(cfg.dtype))
    if with_aux:
        return logits, aux
    return logits
