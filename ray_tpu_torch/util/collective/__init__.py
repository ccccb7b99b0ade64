"""Explicit collective communication between actors.

The port of ``ray_tpu/util/collective``. Two planes:

- ``backend="store"``: the host-side backend, a named rendezvous actor
  that carries the contributions (numpy arrays, or tensors on their own
  device) between the actors of one process. It is what thread gangs,
  rollout actors and ``train.torch.prepare_model`` use.
- ``ray_tpu_torch.util.collective.nccl``: the device plane,
  ``torch.distributed`` collectives (NCCL on ``cuda``, gloo on ``cpu``)
  over a ``DeviceMesh``'s groups, where the reference exports ``xla``.
"""

from ray_tpu_torch.util.collective.collective import (
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_rank,
    get_world_size,
    init_collective_group,
    recv,
    reducescatter,
    send,
)
from ray_tpu_torch.util.collective import nccl

__all__ = [
    "ReduceOp", "allgather", "allreduce", "barrier", "broadcast",
    "destroy_collective_group", "get_rank", "get_world_size",
    "init_collective_group", "nccl", "recv", "reducescatter", "send",
]
