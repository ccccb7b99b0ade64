"""Utilities over the runtime: placement groups, scheduling strategies,
the actor-backed ``Queue`` and ``collective`` (the store backend between
actors, and ``collective.nccl``, the device plane) and ``metrics`` (user
counters, gauges and histograms for ``/metrics``) and ``tracing``
(spans, the trace context across processes, the merged chrome trace).
The reference's ``ActorPool`` is not ported yet."""

from ray_tpu_torch.util.queue import Empty, Full, Queue

__all__ = ["Empty", "Full", "Queue"]
