"""Host-side collective API over the rendezvous store.

The port of ``ray_tpu/util/collective/collective.py``: the module-level
functions keep a per-actor-thread group table, every op goes through the
group's store actor, and each group numbers its ops so that the ranks'
contributions meet. Payloads are carried as they come (``store.py``): a
numpy array stays numpy, a ``torch.Tensor`` stays a tensor on its
device, so bf16 and ``cuda`` tensors go through without a host copy.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.util.collective.store import CollectiveStore

_GET_TIMEOUT_S = 120.0


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


@dataclass
class Group:
    """One rank's membership of a group: its rank, the world size, the
    store actor and the op counter."""

    name: str
    rank: int
    world_size: int
    store: Any
    seq: int = 0

    def next_key(self, op: str) -> str:
        self.seq += 1
        return f"{op}:{self.seq}"


class _GroupTable(threading.local):
    """Thread-local: each actor (its own thread) has its own ranks."""

    def __init__(self):
        self.groups: dict[str, Group] = {}


_table = _GroupTable()


def _payload(tensor):
    """A tensor as it is (detached), anything else as a numpy array."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach()
    return np.asarray(tensor)


def init_collective_group(world_size: int, rank: int,
                          backend: str = "store",
                          group_name: str = "default") -> None:
    """Join ``group_name`` as ``rank``. Every participating actor or
    driver calls this; the named store actor is the rendezvous point
    (created once, get-if-exists)."""
    if backend not in ("store", "gloo", "cpu"):
        raise ValueError(
            f"backend={backend!r}: host-side groups use the store backend"
            f" (device collectives live in ray_tpu_torch.util.collective."
            f"nccl)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    store = ray_tpu_torch.remote(CollectiveStore).options(
        name=f"collective::{group_name}", get_if_exists=True,
        max_concurrency=max(64, world_size * 4)).remote(world_size)
    actual = ray_tpu_torch.get(store.world_size.remote())
    if actual != world_size:
        raise ValueError(
            f"group {group_name!r} exists with world_size={actual}, "
            f"asked for {world_size}")
    _table.groups[group_name] = Group(
        name=group_name, rank=rank, world_size=world_size, store=store)


def destroy_collective_group(group_name: str = "default") -> None:
    group = _table.groups.pop(group_name, None)
    if group is not None and group.rank == 0:
        try:
            ray_tpu_torch.kill(group.store)
        except Exception:  # noqa: BLE001 — another rank already killed it
            pass


def get_group(group_name: str = "default") -> Group:
    """This thread's membership of ``group_name``."""
    try:
        return _table.groups[group_name]
    except KeyError:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"actor — call init_collective_group() first") from None


def get_rank(group_name: str = "default") -> int:
    return get_group(group_name).rank


def get_world_size(group_name: str = "default") -> int:
    return get_group(group_name).world_size


# ------------------------------------------------------------------ ops


def _exchange(group: Group, op: str, payload) -> dict[int, Any]:
    key = group.next_key(op)
    return ray_tpu_torch.get(
        group.store.exchange.remote(key, group.rank, payload),
        timeout=_GET_TIMEOUT_S)


def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    """Returns the reduced array (or tensor, on ``tensor``'s device).

    The store reduces as contributions arrive, so each rank ships one
    payload and receives one."""
    group = get_group(group_name)
    key = group.next_key("allreduce")
    return ray_tpu_torch.get(
        group.store.reduce_exchange.remote(key, group.rank, _payload(tensor),
                                           op.value),
        timeout=_GET_TIMEOUT_S)


def barrier(group_name: str = "default") -> None:
    _exchange(get_group(group_name), "barrier", None)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Returns src's payload on every rank (a tensor on the receiver's
    own tensor's device).

    Only the source ships a payload; receivers block for the value (no
    receiver-receiver barrier, as NCCL's broadcast)."""
    group = get_group(group_name)
    if not 0 <= src_rank < group.world_size:
        raise ValueError(
            f"broadcast: src_rank {src_rank} outside "
            f"[0, {group.world_size}) — no rank would ever send")
    key = group.next_key("broadcast")
    payload = _payload(tensor) if group.rank == src_rank else None
    value = ray_tpu_torch.get(
        group.store.broadcast_value.remote(
            key, group.rank, payload, src_rank),
        timeout=_GET_TIMEOUT_S)
    if isinstance(value, torch.Tensor) and isinstance(tensor, torch.Tensor):
        return value.to(tensor.device)
    return value


def allgather(tensor, group_name: str = "default") -> list:
    """Returns [rank0_tensor, ...]."""
    group = get_group(group_name)
    contributions = _exchange(group, "allgather", _payload(tensor))
    return [contributions[r] for r in range(group.world_size)]


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    """Each rank gets its 1/world_size chunk (along axis 0) of the
    reduction."""
    group = get_group(group_name)
    payload = _payload(tensor)
    if payload.shape[0] % group.world_size:
        raise ValueError(
            f"reducescatter: leading dim {payload.shape[0]} not divisible "
            f"by world_size {group.world_size}")
    key = group.next_key("reducescatter")
    return ray_tpu_torch.get(
        group.store.reduce_scatter.remote(
            key, group.rank, payload, op.value),
        timeout=_GET_TIMEOUT_S)


def send(tensor, dst_rank: int, group_name: str = "default",
         tag: int = 0) -> None:
    group = get_group(group_name)
    ray_tpu_torch.get(group.store.p2p_put.remote(
        (group.rank, dst_rank, tag), _payload(tensor)))


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    """Blocks for a matching send."""
    group = get_group(group_name)
    return ray_tpu_torch.get(group.store.p2p_take.remote(
        (src_rank, group.rank, tag)), timeout=_GET_TIMEOUT_S)
