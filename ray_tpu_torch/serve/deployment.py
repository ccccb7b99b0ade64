"""``@serve.deployment`` and the bound application graph.

A copy of ``ray_tpu/serve/deployment.py``: ``D.bind(args...)`` makes an
``Application`` node; a bound node passed as an init argument becomes a
``DeploymentHandle`` inside the replica that consumes it. Bound
arguments are kept by reference (a tree of weights on the card is
passed to the replicas as it is, not copied).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ray_tpu_torch.serve.config import (
    AutoscalingConfig,
    DeploymentConfig,
    ReplicaConfig,
)


@dataclasses.dataclass
class Application:
    """A bound deployment (+ its bound dependencies)."""

    deployment: "Deployment"
    init_args: tuple
    init_kwargs: dict

    def _ingress_name(self) -> str:
        return self.deployment.name


class Deployment:
    def __init__(self, func_or_class: Any, name: str,
                 deployment_config: DeploymentConfig,
                 ray_actor_options: dict | None = None,
                 route_prefix: str | None = None):
        self._func_or_class = func_or_class
        self.name = name
        self.deployment_config = deployment_config
        self.ray_actor_options = ray_actor_options or {}
        self.route_prefix = route_prefix

    def options(self, *, num_replicas: int | None = None,
                autoscaling_config: AutoscalingConfig | dict | None = None,
                user_config: Any = None,
                max_ongoing_requests: int | None = None,
                max_queued_requests: int | None = None,
                ray_actor_options: dict | None = None,
                name: str | None = None,
                route_prefix: str | None = None,
                health_check_period_s: float | None = None,
                graceful_shutdown_timeout_s: float | None = None,
                ) -> "Deployment":
        cfg = dataclasses.replace(self.deployment_config)
        if num_replicas is not None:
            if num_replicas == "auto":
                autoscaling_config = autoscaling_config or AutoscalingConfig(
                    min_replicas=1, max_replicas=8)
            else:
                cfg.num_replicas = num_replicas
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if user_config is not None:
            cfg.user_config = user_config
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        return Deployment(
            self._func_or_class, name or self.name, cfg,
            ray_actor_options or self.ray_actor_options,
            route_prefix if route_prefix is not None else self.route_prefix)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def build_replica_config(self) -> ReplicaConfig:
        return ReplicaConfig(
            deployment_def=self._func_or_class,
            ray_actor_options=self.ray_actor_options)


def deployment(_func_or_class: Any = None, *, name: str | None = None,
               num_replicas: int | None = None,
               autoscaling_config: AutoscalingConfig | dict | None = None,
               user_config: Any = None,
               max_ongoing_requests: int | None = None,
               max_queued_requests: int | None = None,
               ray_actor_options: dict | None = None,
               route_prefix: str | None = None,
               health_check_period_s: float | None = None,
               graceful_shutdown_timeout_s: float | None = None):
    """Wrap a class or function as a Serve deployment."""

    def wrap(target: Callable) -> Deployment:
        dep = Deployment(
            target, name or target.__name__, DeploymentConfig(),
            ray_actor_options, route_prefix)
        return dep.options(
            num_replicas=num_replicas,
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            ray_actor_options=ray_actor_options,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
