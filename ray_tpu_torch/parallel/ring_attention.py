"""Ring attention: sequence/context parallelism over the ``sp`` axis.

The port of ``ray_tpu/parallel/ring_attention.py``. Each of the N ranks
on the ``sp`` axis holds a sequence shard ``[B, L/N, H, D]`` of Q, K, V.
K/V shards rotate around the ring while each rank accumulates its
queries' attention over every K/V block with numerically stable
log-sum-exp rescaling, block by block in f32 (``_block_attention``, plain
PyTorch, as the reference's plain einsums are).

Where the reference's ``lax.ppermute`` runs inside ``shard_map``, the
shift here is ``batch_isend_irecv`` in the ``sp`` group of the mesh, a
differentiable ``autograd.Function`` whose backward shifts the other way;
``shard_map`` is ``local_map``. Ulysses-style sequence parallelism
(all-to-all seq → heads, local full attention, all-to-all back) uses the
differentiable ``all_to_all_single`` of ``torch.distributed.nn``.

A mesh axis of size 1 is not a dim of the port's ``DeviceMesh``
(``parallel/mesh.py``): its group is a world of one, where the shift and
the all-to-all are the identity.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel.mesh import ambient_mesh
from ray_tpu_torch.parallel.sharding import placements

# Batch over (dp, fsdp), sequence over sp, heads over tp.
RING_SPEC = (("dp", "fsdp"), "sp", "tp", None)


def axis_group(mesh: DeviceMesh | None, axis_name: str):
    """(group, size, this rank's index on the axis); (None, 1, 0) where
    the axis is not a dim of the mesh (size 1) or there is no mesh."""
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if axis_name not in names:
        return None, 1, 0
    return (mesh.get_group(axis_name), mesh.size(names.index(axis_name)),
            mesh.get_local_rank(axis_name))


def _exchange(tensors, group, send_to: int, recv_from: int) -> list:
    """Send each tensor to group rank ``send_to`` and receive one of the
    same shape from ``recv_from``, in one batch."""
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, out)):
        ops.append(dist.P2POp(dist.isend, t,
                              dist.get_global_rank(group, send_to),
                              group, tag))
        ops.append(dist.P2POp(dist.irecv, o,
                              dist.get_global_rank(group, recv_from),
                              group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    """``lax.ppermute`` with perm ``j → j-1``: rank j sends (k, v) to
    rank j-1 and receives rank j+1's. The backward sends the gradients
    the other way."""

    @staticmethod
    def forward(ctx, group, n, idx, k, v):
        ctx.group, ctx.n, ctx.idx = group, n, idx
        return tuple(_exchange((k, v), group, (idx - 1) % n, (idx + 1) % n))

    @staticmethod
    def backward(ctx, dk, dv):
        # Autograd materialises an unused output's gradient as zeros.
        n, idx = ctx.n, ctx.idx
        dk, dv = _exchange((dk, dv), ctx.group, (idx + 1) % n, (idx - 1) % n)
        return None, None, None, dk, dv


def _block_attention(q, k, v, bias, scale):
    """One (q-block, kv-block) flash step: returns (unnormalized o, lse-max
    pieces). Shapes: q [B,Lq,H,D], k/v [B,Lk,H,D], bias broadcastable to
    [B,H,Lq,Lk]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias
    block_max = torch.amax(scores, dim=-1)  # [B,H,Lq]
    # Fully-masked rows have block_max = -inf; subtracting it from -inf
    # scores would produce NaN, so use 0 there (exp(-inf - 0) = 0).
    safe_max = torch.where(torch.isfinite(block_max), block_max, 0.0)
    probs = torch.exp(scores - safe_max[..., None])
    block_sum = torch.sum(probs, dim=-1)  # [B,H,Lq]
    block_out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return block_out, block_max, block_sum


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = True,
                   scale: float | None = None,
                   mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Ring attention over ``axis_name`` of ``mesh`` (the ambient mesh
    when None); call on local shards, inside ``local_map``.

    Args are local shards [B, L_local, H, D]; sequence order along the
    ring follows the axis index (rank i holds tokens [i*L_local,
    (i+1)*L_local))."""
    group, num_shards, my_idx = axis_group(
        mesh if mesh is not None else ambient_mesh(), axis_name)
    b, l_local, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5

    o_acc = torch.zeros((b, l_local, h, d), dtype=torch.float32,
                        device=q.device)
    l_acc = torch.zeros((b, h, l_local), dtype=torch.float32, device=q.device)
    m_acc = torch.full((b, h, l_local), float("-inf"), dtype=torch.float32,
                       device=q.device)
    q_pos = my_idx * l_local + torch.arange(l_local, device=q.device)

    k_cur, v_cur = k, v
    for i in range(num_shards):
        # Block i came from rank (my_idx + i) mod N (the shift moves
        # shards "down" the ring: after s shifts we hold the shard that
        # started s positions up).
        src = (my_idx + i) % num_shards
        if causal:
            kv_pos = src * l_local + torch.arange(l_local, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]  # [Lq, Lk]
            # In q's dtype, as JAX's weakly typed bias keeps the scores.
            bias = torch.where(mask, 0.0, float("-inf")).to(q.dtype)
            bias = bias[None, None]
        else:
            bias = None
        blk_o, blk_m, blk_s = _block_attention(q, k_cur, v_cur, bias, scale)
        new_m = torch.maximum(m_acc, blk_m)
        # Guard fully-masked blocks (all -inf) against NaN rescaling.
        safe = torch.isfinite(new_m)
        safe_m = torch.where(safe, new_m, 0.0)
        alpha = torch.where(safe, torch.exp(m_acc - safe_m), 0.0)
        beta = torch.where(safe, torch.exp(blk_m - safe_m), 0.0)
        l_acc = l_acc * alpha + blk_s * beta
        o_acc = (o_acc * alpha.transpose(1, 2)[..., None]
                 + blk_o.float() * beta.transpose(1, 2)[..., None])
        m_acc = new_m
        # The reference shifts after the last block too, and drops the
        # result; this skips that dead shift.
        if i + 1 < num_shards:
            k_cur, v_cur = _RingShift.apply(group, num_shards, my_idx,
                                            k_cur, v_cur)
    denom = torch.where(l_acc > 0, l_acc, 1.0).transpose(1, 2)[..., None]
    return (o_acc / denom).to(q.dtype)


def shard_attention(fn: Callable, q, k, v, mesh: DeviceMesh | None,
                    spec: tuple):
    """``shard_map`` of ``fn(q, k, v, mesh)`` over ``mesh`` with ``spec``
    for every input and the output. DTensors are redistributed to the
    spec and the result is a DTensor; plain tensors are taken as global
    tensors, the same on every rank, and the result is the global
    tensor."""
    plain = not isinstance(q, DTensor)
    if not plain:
        mesh = q.device_mesh
    if mesh is None:
        raise ValueError("no mesh: pass DTensors, or call inside set_mesh")
    if plain:
        replicate = [Replicate()] * mesh.ndim
        q, k, v = (DTensor.from_local(t, mesh, replicate, run_check=False)
                   for t in (q, k, v))
    where = placements(mesh, spec)
    out = local_map(functools.partial(fn, mesh=mesh), out_placements=where,
                    in_placements=(where, where, where), device_mesh=mesh,
                    redistribute_inputs=True)(q, k, v)
    return out.full_tensor() if plain else out


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: DeviceMesh, causal: bool = True
                           ) -> torch.Tensor:
    """``local_map`` wrapper: [B, L, H, D] global tensors (DTensors, or
    plain tensors the same on every rank), B over dp/fsdp, L over sp, H
    over tp."""
    ring = functools.partial(ring_attention, axis_name="sp", causal=causal)
    return shard_attention(ring, q, k, v, mesh, RING_SPEC)


def ring_attention_gspmd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Ring attention callable from inside a model whose tensors are
    DTensors (on their mesh), or on plain tensors under ``set_mesh``
    (on the ambient mesh). Batch stays over (dp, fsdp), heads over tp."""
    ring = functools.partial(ring_attention, axis_name="sp", causal=causal)
    return shard_attention(ring, q, k, v, ambient_mesh(), RING_SPEC)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to group rank j; chunk j of the result came
    from group rank j. Differentiable."""
    x = x.contiguous()
    return dist_fn.all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp", causal: bool = True,
                      attn_fn: Callable | None = None,
                      mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Ulysses-style SP: all-to-all seq->heads, local full attention,
    all-to-all back. Requires H % axis_size == 0. Call on local shards,
    inside ``local_map``, with ``mesh`` (the ambient mesh when None)."""
    group, n, _ = axis_group(mesh if mesh is not None else ambient_mesh(),
                             axis_name)
    b, l_local, h, d = q.shape
    if h % n != 0:
        raise ValueError(f"num heads {h} not divisible by sp axis size {n}")

    def seq_to_heads(x):
        # [B, L/n, H, D] -> [B, L, H/n, D]: head group j goes to rank j,
        # and the sequence is concatenated in rank order.
        if n == 1:
            return x
        x = x.reshape(b, l_local, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = _all_to_all(x, group)  # [n (source rank), B, L/n, H/n, D]
        return x.permute(1, 0, 2, 3, 4).reshape(b, l_local * n, h // n, d)

    def heads_to_seq(x):
        # Inverse of seq_to_heads: [B, L, H/n, D] -> [B, L/n, H, D].
        if n == 1:
            return x
        x = x.reshape(b, n, l_local, h // n, d).permute(1, 0, 2, 3, 4)
        x = _all_to_all(x, group)  # [n (source rank), B, L/n, H/n, D]
        return x.permute(1, 2, 0, 3, 4).reshape(b, l_local, h, d)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if attn_fn is None:
        attn_fn = functools.partial(plain_attention, causal=causal)
    og = attn_fn(qg, kg, vg)
    return heads_to_seq(og)


def plain_attention(q, k, v, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Reference full attention over [B, L, H, D] (the correctness oracle)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
