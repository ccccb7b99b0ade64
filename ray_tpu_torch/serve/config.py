"""Serve configuration dataclasses.

A copy of ``ray_tpu/serve/config.py``: ``AutoscalingConfig``,
``DeploymentConfig``, ``ReplicaConfig`` and ``HTTPOptions`` as plain
dataclasses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth-driven replica autoscaling.

    Reference: python/ray/serve/config.py AutoscalingConfig +
    python/ray/serve/autoscaling_policy.py (desired = total ongoing
    requests / target_ongoing_requests, smoothed and clamped).
    """

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    metrics_interval_s: float = 0.5
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 1.0
    initial_replicas: int | None = None
    # Latency-driven closed loop (the LLM-engine autoscaler): > 0
    # switches the policy to llm_engine.autoscale.LatencyPolicy:
    # replicas scale up when the router-reported p99 exceeds this
    # budget (seconds), down when p99 sits under half of it with
    # per-replica depth below target_ongoing_requests, damped by the
    # up/down delay cooldowns (a direction flip waits out BOTH). The
    # feed is the live Router.latency_stats() p50/p99 pushed to the
    # controller every serve_latency_report_s, plus the replicas'
    # engine_depth gauge.
    target_p99_s: float = 0.0

    def desired_replicas(self, total_ongoing: float, current: int) -> int:
        if current == 0:
            return max(self.min_replicas, 1)
        error = total_ongoing / self.target_ongoing_requests
        if error > current:
            desired = current + (error - current) * self.upscale_smoothing_factor
            desired = math.ceil(desired)
        else:
            desired = current - (current - error) * self.downscale_smoothing_factor
            desired = math.floor(desired) if desired >= self.min_replicas else current
        return max(self.min_replicas, min(self.max_replicas, int(desired)))


@dataclasses.dataclass
class DeploymentConfig:
    """Per-deployment behavior knobs (reference: serve/config.py
    DeploymentConfig)."""

    num_replicas: int = 1
    max_ongoing_requests: int = 100
    # Router-level load shedding: with more than this many requests
    # in flight across the deployment's replicas (the router's local
    # queue), new assignments are rejected with a retryable
    # SystemOverloadedError (HTTP tier: 503) instead of queueing
    # unboundedly. -1 = unlimited (reference: serve/config.py
    # max_queued_requests).
    max_queued_requests: int = -1
    autoscaling_config: AutoscalingConfig | None = None
    user_config: Any = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 5.0

    @property
    def target_num_replicas(self) -> int:
        if self.autoscaling_config is not None:
            init = self.autoscaling_config.initial_replicas
            if init is not None:
                return init
            return self.autoscaling_config.min_replicas
        return self.num_replicas


@dataclasses.dataclass
class ReplicaConfig:
    """What to run in each replica: the user class/function + init args +
    per-replica resources (reference: serve/config.py ReplicaConfig)."""

    deployment_def: Any = None
    init_args: tuple = ()
    init_kwargs: dict = dataclasses.field(default_factory=dict)
    ray_actor_options: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class HTTPOptions:
    """Proxy options (reference: serve/config.py HTTPOptions)."""

    host: str = "127.0.0.1"
    port: int = 8000
    # Per-request budget: inherited by the replica call as an
    # end-to-end deadline (the call is refused once the budget dies —
    # never executed late) and enforced on the proxy's result wait.
    # Expiry maps to 504, an admission shed to 503.
    request_timeout_s: float = 60.0
