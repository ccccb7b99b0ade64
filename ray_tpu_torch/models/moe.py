"""Mixture-of-Experts SwiGLU layer with expert parallelism.

The port of ``ray_tpu/models/moe.py``, step by step (Mesh-TensorFlow-style
einsum dispatch):

- top-1 router with capacity ``C = capacity_factor * T / E``; tokens
  over capacity are dropped (the residual connection carries them);
- dispatch/combine tensors [B, T, E, C] turn routing into einsums, so
  with experts placed over ``ep`` (logical axis "expert") and the batch
  over dp, each rank computes its own experts' slice;
- load-balancing auxiliary loss (mean fraction x mean router prob per
  expert, scaled by E) keeps the router from collapsing.

On DTensors both halves run on local shards inside ``local_map``, where
the reference leaves them to GSPMD. The routing (router product through
combine tensor) runs on each rank's batch shard: it is per batch row, so
it needs nothing of another rank, and DTensor's rules for ``argmax``,
``cumsum`` and the one-hot comparisons differ by release. The aux is
returned per batch row and averaged over the (sharded) batch after, so
it is the global batch's mean. The four einsums run on each rank's
experts (over ``ep``) and expert columns (over ``tp``), their output a
partial sum that DTensor reduces over both axes.

Params per MoE layer (leading E = expert dim, logical "expert" -> ep):
  w_router [H, E]; w_gate/w_up [E, H, M]; w_down [E, M, H].
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.sharding import (
    logical_to_spec,
    partial_over,
    placements,
)


def init_moe_params(generator: torch.Generator, hidden: int, mlp: int,
                    num_experts: int, num_layers: int, device=None) -> dict:
    """Dense weights normal with std ``fan_in ** -0.5``, float32, drawn
    from ``generator`` (which must live on ``device``) in key order."""
    device = resolve_device(device)

    def dense(fan_in, *shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(fan_in ** -0.5)

    return {
        "w_router": dense(hidden, num_layers, hidden, num_experts),
        "w_gate": dense(hidden, num_layers, num_experts, hidden, mlp),
        "w_up": dense(hidden, num_layers, num_experts, hidden, mlp),
        "w_down": dense(mlp, num_layers, num_experts, mlp, hidden),
    }


def moe_logical_axes() -> dict:
    """Leading scan (layer) dim = None; expert dim -> ep via rules."""
    return {
        "w_router": (None, "embed", None),
        "w_gate": (None, "expert", "embed", "mlp"),
        "w_up": (None, "expert", "embed", "mlp"),
        "w_down": (None, "expert", "mlp", "embed"),
    }


def _route(x: torch.Tensor, w_router: torch.Tensor, capacity: int):
    """(dispatch [B, T, E, C] f32, combine [B, T, E, C] f32, aux [B] f32)
    for x [B, T, H]: the top-1 router in f32 and each token's slot in
    its expert. ``aux`` is each batch row's Switch loss."""
    num_experts = w_router.shape[-1]
    logits = x.float() @ w_router.float()              # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    gate = torch.amax(probs, dim=-1)                    # [B, T]
    expert_idx = torch.argmax(probs, dim=-1)            # [B, T]
    experts = torch.arange(num_experts, device=x.device)
    onehot = (expert_idx[..., None] == experts).float()

    # Load-balancing aux loss (Switch Transformer eq. 4), per batch row.
    fraction = torch.mean(onehot, dim=1)                # [B, E]
    mean_prob = torch.mean(probs, dim=1)                # [B, E]
    aux = num_experts * torch.sum(fraction * mean_prob, dim=-1)

    # Position of each token within its expert (per batch row); tokens
    # past the capacity are dropped (the residual stream carries them).
    position = torch.cumsum(onehot, dim=1) * onehot     # 1-based
    keep = (position > 0) & (position <= capacity)
    # jax.nn.one_hot gives a row of zeros for an index out of [0, C):
    # a comparison with arange(C) does the same (F.one_hot raises).
    slots = torch.arange(capacity, device=x.device, dtype=position.dtype)
    pos_onehot = ((position - 1)[..., None] == slots).float()
    dispatch = pos_onehot * keep.float()[..., None]
    combine = dispatch * gate[..., None, None]
    return dispatch, combine, aux


def _route_local(x: DTensor, w_router: DTensor, capacity: int):
    """``_route`` on each rank's batch shard: x split as the batch and
    whole otherwise, the router whole. The router's gradient is then a
    partial sum over the batch axes."""
    mesh = x.device_mesh
    x_at = placements(mesh, logical_to_spec(("batch", None, None)))
    w_at = placements(mesh, (None, None))
    route_at = placements(mesh, logical_to_spec(("batch", None, None, None)))
    aux_at = placements(mesh, logical_to_spec(("batch",)))
    dw_at = partial_over(mesh, w_at, ("dp", "fsdp"))
    return local_map(
        lambda x, w: _route(x, w, capacity),
        out_placements=(route_at, route_at, aux_at),
        in_placements=(x_at, w_at), in_grad_placements=(x_at, dw_at),
        device_mesh=mesh, redistribute_inputs=True)(x, w_router)


def _experts(dispatch: torch.Tensor, combine: torch.Tensor, x: torch.Tensor,
             w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The four einsums in ``dtype``: dispatch, the experts' SwiGLU and
    the weighted combine. The expert products carry a batch dim (e or
    b), so they are batched products (bmm), which the "dots" remat
    policy recomputes, as the reference's does."""
    # Dispatch: [B,T,E,C] x [B,T,H] -> [E, B, C, H].
    expert_in = torch.einsum("btec,bth->ebch", dispatch.to(dtype),
                             x.to(dtype))
    gate_h = torch.einsum("ebch,ehm->ebcm", expert_in, w_gate.to(dtype))
    up_h = torch.einsum("ebch,ehm->ebcm", expert_in, w_up.to(dtype))
    hidden = torch.nn.functional.silu(gate_h) * up_h
    expert_out = torch.einsum("ebcm,emh->ebch", hidden, w_down.to(dtype))
    # Combine back: weighted un-dispatch.
    return torch.einsum("btec,ebch->bth", combine.to(dtype), expert_out)


def _experts_local(dispatch: DTensor, combine: DTensor, x: DTensor,
                   w_gate: DTensor, w_up: DTensor, w_down: DTensor,
                   dtype: torch.dtype) -> DTensor:
    """``_experts`` on local shards: the tokens split as the batch, the
    experts over ep (the dispatch and combine tensors by their expert
    dim, the weights by theirs) and the expert MLP's columns over tp.
    Each rank's output is then a partial sum over ep (its experts) and
    tp (its columns), and so is x's gradient; the weights' gradients
    are partial sums over the batch axes. DTensor's strategy search for
    these 4-D products on a mesh of several dims ran for minutes per op
    (torch 2.13, dp x ep x tp)."""
    mesh = x.device_mesh
    batch = ("dp", "fsdp")
    route_at = placements(mesh, (batch, None, "ep", None))
    x_at = placements(mesh, (batch, None, None))
    up_at = placements(mesh, ("ep", None, "tp"))      # w_gate, w_up
    down_at = placements(mesh, ("ep", "tp", None))    # w_down
    out_at = partial_over(mesh, x_at, ("ep", "tp"))
    dup_at = partial_over(mesh, up_at, batch)
    return local_map(
        lambda *args: _experts(*args, dtype),
        out_placements=out_at,
        in_placements=(route_at, route_at, x_at, up_at, up_at, down_at),
        in_grad_placements=(route_at, partial_over(mesh, route_at, ("tp",)),
                            out_at, dup_at, dup_at,
                            partial_over(mesh, down_at, batch)),
        device_mesh=mesh, redistribute_inputs=True)(
            dispatch, combine, x, w_gate, w_up, w_down)


def moe_mlp(layer: dict, x: torch.Tensor, *, capacity_factor: float = 1.25,
            dtype: torch.dtype = torch.bfloat16
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE SwiGLU: x [B, T, H] -> (out [B, T, H], aux_loss scalar).

    ``layer`` holds one layer's slice: w_router [H, E],
    w_gate/w_up [E, H, M], w_down [E, M, H].
    """
    b, t, h = x.shape
    num_experts = layer["w_router"].shape[-1]
    capacity = max(1, int(capacity_factor * t / num_experts))
    weights = (layer["w_gate"], layer["w_up"], layer["w_down"])
    if isinstance(x, DTensor):
        dispatch, combine, aux = _route_local(x, layer["w_router"], capacity)
        out = _experts_local(dispatch, combine, x, *weights, dtype)
    else:
        dispatch, combine, aux = _route(x, layer["w_router"], capacity)
        out = _experts(dispatch, combine, x, *weights, dtype)
    return out.to(x.dtype), torch.mean(aux)
