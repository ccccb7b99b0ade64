"""Device mesh construction and axis conventions.

The port of ``ray_tpu/parallel/mesh.py``. The canonical axes, in order:

- ``pp``   — pipeline parallelism (stage sharding)
- ``dp``   — pure data parallelism (params replicated)
- ``fsdp`` — data parallelism with parameter sharding (ZeRO-3 analogue)
- ``sp``   — sequence/context parallelism (ring or Ulysses attention)
- ``ep``   — expert parallelism (MoE expert sharding)
- ``tp``   — tensor parallelism (Megatron-style column/row sharding)

Where the reference builds a ``jax.sharding.Mesh`` over ``jax.devices()``,
this builds a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group (one card per rank; ``_private/dist.py`` brings the
group up). The reference keeps every axis, even of size 1; the port's
mesh has a dim only for each axis larger than 1 (``("dp",)`` of size 1
when none is), because DTensor's sharding propagation weighs every
placement on every mesh dim, and on six dims (torch 2.13) it ran for
minutes per op. An axis of size 1 shards nothing, so sharding rules may
still name any canonical axis: ``sharding.placements`` skips it and
``mesh_axis_size`` gives 1. The ambient mesh of ``jax.set_mesh`` is
``set_mesh``/``ambient_mesh`` here.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.dist import (
    ensure_process_group,
    set_group_timeouts,
)

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis; -1 on at most one axis means
    "use all remaining devices"."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def resolved(self, num_devices: int) -> "MeshConfig":
        sizes = {axis: getattr(self, axis) for axis in AXIS_ORDER}
        wildcard = [a for a, s in sizes.items() if s == -1]
        if len(wildcard) > 1:
            raise ValueError("At most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes {fixed}")
            sizes[wildcard[0]] = num_devices // fixed
        total = math.prod(sizes.values())
        if total != num_devices:
            raise ValueError(
                f"Mesh axes {sizes} multiply to {total}, but {num_devices} "
                "devices are available")
        return MeshConfig(**{k: sizes[k] for k in ("dp", "fsdp", "tp", "sp", "ep", "pp")})

    @property
    def axis_sizes(self) -> dict[str, int]:
        return {axis: getattr(self, axis) for axis in AXIS_ORDER}


def build_mesh(config: MeshConfig | None = None, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default process group, its
    dims the axes of ``config`` larger than 1 in ``AXIS_ORDER``; on
    ``cuda`` (NCCL) unless the caller passes ``device="cpu"`` (gloo).
    Brings the group up if there is none (``_private/dist.py``)."""
    device = resolve_device(device)
    ensure_process_group(device)
    config = (config or MeshConfig(dp=-1)).resolved(dist.get_world_size())
    names = tuple(a for a in AXIS_ORDER if config.axis_sizes[a] > 1) \
        or ("dp",)
    return _device_mesh(device, tuple(config.axis_sizes[a] for a in names),
                        names)


def single_axis_mesh(axis: str = "dp", device=None) -> DeviceMesh:
    device = resolve_device(device)
    ensure_process_group(device)
    return _device_mesh(device, (dist.get_world_size(),), (axis,))


def _device_mesh(device, shape: tuple, names: tuple) -> DeviceMesh:
    mesh = init_device_mesh(device.type, shape, mesh_dim_names=names)
    set_group_timeouts(mesh)
    return mesh


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes actually sharding the batch dimension (size > 1)."""
    return tuple(a for a in ("dp", "fsdp") if mesh_axis_size(mesh, a) > 1)


_AMBIENT: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "ambient_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh | None):
    """``jax.set_mesh``: make ``mesh`` the ambient mesh inside the block
    (``None`` leaves the ambient mesh as it is)."""
    if mesh is None:
        yield None
        return
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> DeviceMesh | None:
    """The mesh of the innermost ``set_mesh`` block, or None."""
    return _AMBIENT.get()
