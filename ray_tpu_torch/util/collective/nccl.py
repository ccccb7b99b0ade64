"""Device-plane collectives: ``torch.distributed`` over the mesh's groups.

The port of ``ray_tpu/util/collective/xla.py``, exported as
``collective.nccl`` where the reference exports ``collective.xla``. The
collectives run on the default process group's backend: NCCL for
``cuda`` tensors, gloo for ``cpu`` ones (``_private/dist.py``; there is
no fallback from one to the other). Two layers:

1. In-SPMD primitives, for code that runs on each rank's local shard
   (inside ``local_map``, or on plain tensors): ``psum``, ``pmean``,
   ``pmax``, ``pmin``, ``all_gather``, ``ppermute``, ``all_to_all``,
   ``axis_index``. Each takes the reference's ``axis_name`` and resolves
   it to that dimension's group of the ambient ``DeviceMesh``
   (``parallel.mesh.set_mesh``); an axis the mesh does not have is of
   size 1, and its collectives are the identity (an axis of size 1 that
   the mesh has runs its collective on its group of one). They are differentiable where the reference's ``lax`` ops
   are (``pmax`` and ``pmin`` are not): each rank's backward takes its
   own output's gradient, so the transposes are those of a shard_map
   whose outputs are sharded over the axis (psum's is psum, all_gather's
   a reduce-scatter, ppermute's the inverse permutation).
2. Host helpers, ``device_allreduce``, ``device_allgather``,
   ``device_reducescatter`` and ``device_ring_shift``: each takes the
   reference's ``[n, ...]`` host array, ``n = mesh.size(axis)``. Every
   rank passes the same whole array, rank ``r`` puts ``x[r]`` on its
   device, and one collective runs over the axis's group (the ring
   shift and the reduce-scatter then gather the result): JAX's
   multi-process meaning of a host array put onto a ``NamedSharding``.
   The result comes back as numpy, shaped as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.parallel.mesh import ambient_mesh, single_axis_mesh
from ray_tpu_torch.parallel.ring_attention import (
    _all_to_all,
    axis_group,
)


def _axis(axis_name: str, mesh: DeviceMesh | None = None):
    """(group, size, index) of ``axis_name`` on ``mesh`` or the ambient
    mesh; there must be one."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        raise NameError(f"unbound axis name: {axis_name} (no ambient mesh; "
                        f"call inside parallel.mesh.set_mesh)")
    return axis_group(mesh, axis_name)


# ---------------------------------------------------- in-SPMD primitives


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    group, _, _ = _axis(axis_name)
    if group is None:
        return x
    return dist_fn.all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    _, n, _ = _axis(axis_name)
    return psum(x, axis_name) / n


class _NoGradReduce(torch.autograd.Function):
    """An all-reduce by max or min, which the reference cannot
    differentiate either."""

    @staticmethod
    def forward(ctx, x, op, name, group):
        ctx.name = name
        out = x.clone()
        dist.all_reduce(out, op=op, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            f"Differentiation rule for '{ctx.name}' not implemented")


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    group, _, _ = _axis(axis_name)
    return x if group is None else _NoGradReduce.apply(
        x, dist.ReduceOp.MAX, "pmax", group)


def pmin(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    group, _, _ = _axis(axis_name)
    return x if group is None else _NoGradReduce.apply(
        x, dist.ReduceOp.MIN, "pmin", group)


def all_gather(x: torch.Tensor, axis_name: str, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in rank order: stacked on a new ``axis``, or
    with ``tiled`` concatenated along it."""
    group, _, _ = _axis(axis_name)
    parts = (x,) if group is None \
        else dist_fn.all_gather(x.contiguous(), group=group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                dim=axis)


class _PPermute(torch.autograd.Function):
    """``lax.ppermute``: each (src, dst) pair sends src's tensor to dst;
    a rank no pair sends to gets zeros. The backward sends the gradients
    back along the inverse pairs."""

    @staticmethod
    def forward(ctx, x, group, idx, perm):
        ctx.group, ctx.idx = group, idx
        ctx.inverse = [(dst, src) for src, dst in perm]
        return _permute(x, group, idx, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, ctx.idx, ctx.inverse), None, None, None


def _permute(x, group, idx, perm) -> torch.Tensor:
    sends = [dst for src, dst in perm if src == idx]
    recvs = [src for src, dst in perm if dst == idx]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group)
           for dst in sends]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                       group) for src in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def ppermute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    group, n, idx = _axis(axis_name)
    perm = [(int(src), int(dst)) for src, dst in perm]
    if len({s for s, _ in perm}) != len(perm) \
            or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute: perm {perm} sends or receives twice")
    if n == 1:  # no send to oneself: the identity or nothing
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, idx, perm)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, *, tiled: bool = False) -> torch.Tensor:
    """Chunk j of ``split_axis`` goes to rank j; the chunks received are
    concatenated along ``concat_axis`` in rank order (``tiled``), or,
    with ``x.shape[split_axis]`` equal to the axis size, the split axis
    is removed and the received chunks stacked at ``concat_axis``."""
    group, n, _ = _axis(axis_name)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over {n}")
    if not tiled and x.shape[split_axis] != n:
        raise ValueError(f"all_to_all: with tiled=False dim {split_axis} "
                         f"must equal the axis size {n}")
    chunks = torch.stack(torch.tensor_split(x, n, dim=split_axis))
    received = chunks if group is None else _all_to_all(chunks, group)
    parts = received.unbind(0)
    if tiled:
        return torch.cat(parts, dim=concat_axis)
    return torch.stack([p.squeeze(split_axis) for p in parts],
                       dim=concat_axis)


def axis_index(axis_name: str) -> int:
    """This rank's index on ``axis_name``."""
    return _axis(axis_name)[2]


# ------------------------------------------------------------ host helpers


def default_mesh(num_devices: int | None = None, axis_name: str = "x",
                 device=None) -> DeviceMesh:
    """A one-axis mesh over every rank of the default process group (on
    ``cuda`` unless the caller passes ``device="cpu"``). A mesh of fewer
    ranks than the world (``num_devices``) has no port."""
    mesh = single_axis_mesh(axis_name, device)
    if num_devices is not None and num_devices != mesh.size():
        raise ValueError(
            f"num_devices={num_devices}: the mesh spans the whole process "
            f"group ({mesh.size()} ranks)")
    return mesh


def _local(x, mesh: DeviceMesh, axis_name: str):
    """(this rank's shard ``x[index]`` on the mesh's device, group, n)."""
    x = np.asarray(x)
    group, n, idx = axis_group(mesh, axis_name)
    if x.shape[0] != n:
        raise ValueError(
            f"leading axis {x.shape[0]} must equal mesh axis "
            f"{axis_name}={n} (one shard per device)")
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return torch.as_tensor(x[idx]).to(device), group, n


def _gather(t: torch.Tensor, group, n: int) -> np.ndarray:
    if group is None:
        return t[None].cpu().numpy()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts).cpu().numpy()


def device_allreduce(x, mesh: DeviceMesh | None = None,
                     axis_name: str = "x") -> np.ndarray:
    """x: [n, ...] (shard i on rank i) → the sum over shards, reduced on
    the devices and returned on every rank."""
    mesh = mesh or default_mesh(axis_name=axis_name)
    t, group, _ = _local(x, mesh, axis_name)
    if group is not None:
        dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def device_allgather(x, mesh: DeviceMesh | None = None,
                     axis_name: str = "x") -> np.ndarray:
    """x: [n, ...] → [n, ...] gathered on every rank."""
    mesh = mesh or default_mesh(axis_name=axis_name)
    t, group, n = _local(x, mesh, axis_name)
    return _gather(t, group, n)


def device_reducescatter(x, mesh: DeviceMesh | None = None,
                         axis_name: str = "x") -> np.ndarray:
    """x: [n, m, ...] → each rank ends with its [m/n] chunk of the sum;
    returned as [n, m/n, ...] (chunk i from rank i)."""
    mesh = mesh or default_mesh(axis_name=axis_name)
    t, group, n = _local(x, mesh, axis_name)
    if t.shape[0] % n:
        raise ValueError(f"dim 1 of size {t.shape[0]} does not split "
                         f"over {n} ranks")
    if group is None:
        return t[None].cpu().numpy()
    chunk = t.new_empty((t.shape[0] // n, *t.shape[1:]))
    dist.reduce_scatter_tensor(chunk, t.contiguous(), group=group)
    return _gather(chunk, group, n)


def device_ring_shift(x, mesh: DeviceMesh | None = None,
                      axis_name: str = "x", shift: int = 1) -> np.ndarray:
    """Ring ppermute: shard i moves to rank (i + shift) % n, the
    building block of ring attention and pipeline communication."""
    mesh = mesh or default_mesh(axis_name=axis_name)
    t, group, n = _local(x, mesh, axis_name)
    idx = axis_group(mesh, axis_name)[2]
    if n > 1:
        t = _permute(t, group, idx, [(i, (i + shift) % n) for i in range(n)])
    return _gather(t, group, n)
