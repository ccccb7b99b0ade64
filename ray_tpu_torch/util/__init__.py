"""Utilities over the runtime: placement groups, scheduling strategies,
the actor-backed ``Queue`` and ``collective`` (the store backend between
actors, and ``collective.nccl``, the device plane). The reference's
``ActorPool`` and metrics are not ported yet."""

from ray_tpu_torch.util.queue import Empty, Full, Queue

__all__ = ["Empty", "Full", "Queue"]
