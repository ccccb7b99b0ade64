"""Declarative Serve config: the YAML schema and its builder.

A copy of ``ray_tpu/serve/schema.py`` (the reference's
ServeApplicationSchema and ServeDeploySchema). ``from_yaml`` imports
``yaml`` when it is called; ``from_dict`` needs nothing.

Shape::

    http_options:
      host: 127.0.0.1
      port: 8000
    applications:
      - name: default
        route_prefix: /
        import_path: my_module:app      # module:attr -> Application
        runtime_env: {}                 # reserved (import-time env)
        deployments:                    # per-deployment OVERRIDES
          - name: Echo
            num_replicas: 2
            max_ongoing_requests: 16
            autoscaling_config:
              min_replicas: 1
              max_replicas: 4
              target_ongoing_requests: 2

The import path must evaluate to a BOUND deployment graph
(``Deployment.bind(...)`` result) — same contract as serve.run's
``target``. Overrides are applied with Deployment.options before the
graph deploys, so a config file retunes replica counts without touching
code (the reference's config-over-code production story).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from ray_tpu_torch.serve.config import AutoscalingConfig


@dataclasses.dataclass
class DeploymentOverride:
    name: str
    num_replicas: int | None = None
    max_ongoing_requests: int | None = None
    autoscaling_config: dict | None = None
    user_config: Any = None

    @staticmethod
    def from_dict(d: dict) -> "DeploymentOverride":
        unknown = set(d) - {f.name for f in dataclasses.fields(
            DeploymentOverride)}
        if unknown:
            raise ValueError(
                f"unknown deployment override field(s): {sorted(unknown)}")
        if "name" not in d:
            raise ValueError("deployment override needs a 'name'")
        return DeploymentOverride(**d)


@dataclasses.dataclass
class ApplicationConfig:
    import_path: str
    name: str = "default"
    route_prefix: str | None = None
    runtime_env: dict = dataclasses.field(default_factory=dict)
    deployments: list[DeploymentOverride] = dataclasses.field(
        default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "ApplicationConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(
            ApplicationConfig)}
        if unknown:
            raise ValueError(
                f"unknown application field(s): {sorted(unknown)}")
        if "import_path" not in d or ":" not in d["import_path"]:
            raise ValueError(
                "application needs import_path='module:attribute'")
        d = dict(d)
        d["deployments"] = [DeploymentOverride.from_dict(x)
                            for x in d.get("deployments", [])]
        return ApplicationConfig(**d)


@dataclasses.dataclass
class ServeDeployConfig:
    applications: list[ApplicationConfig]
    http_options: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "ServeDeployConfig":
        unknown = set(d) - {"applications", "http_options"}
        if unknown:
            raise ValueError(f"unknown top-level field(s): "
                             f"{sorted(unknown)}")
        apps = [ApplicationConfig.from_dict(a)
                for a in d.get("applications", [])]
        if not apps:
            raise ValueError("config has no applications")
        names = [a.name for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate application names: {names}")
        return ServeDeployConfig(applications=apps,
                                 http_options=d.get("http_options", {}))

    @staticmethod
    def from_yaml(path: str) -> "ServeDeployConfig":
        import yaml

        with open(path) as f:
            return ServeDeployConfig.from_dict(yaml.safe_load(f) or {})


def _import_attr(import_path: str):
    module_name, _, attr = import_path.partition(":")
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def build_application(app_cfg: ApplicationConfig):
    """import_path -> bound Application with overrides applied."""
    from ray_tpu_torch.serve.deployment import Application

    target = _import_attr(app_cfg.import_path)
    if callable(getattr(target, "build", None)) and not isinstance(
            target, Application):
        target = target.build()  # builder function style
    if not isinstance(target, Application):
        raise TypeError(
            f"{app_cfg.import_path} resolved to {type(target).__name__}; "
            "expected a bound deployment (Deployment.bind(...))")
    overrides = {o.name: o for o in app_cfg.deployments}
    if overrides:
        target = _apply_overrides(target, overrides)
    return target


def _apply_overrides(app, overrides: dict[str, DeploymentOverride]):
    """Rebuild the bound graph with per-deployment option overrides
    (reference: serve applies config-file deployment options on top of
    the code's decorators)."""
    from ray_tpu_torch.serve.deployment import Application

    seen: set[str] = set()

    def rebuild(node):
        if not isinstance(node, Application):
            return node
        dep = node.deployment
        ov = overrides.get(dep.name)
        args = tuple(rebuild(a) for a in node.init_args)
        kwargs = {k: rebuild(v) for k, v in node.init_kwargs.items()}
        if ov is not None:
            seen.add(dep.name)
            opts: dict[str, Any] = {}
            if ov.num_replicas is not None:
                opts["num_replicas"] = ov.num_replicas
            if ov.max_ongoing_requests is not None:
                opts["max_ongoing_requests"] = ov.max_ongoing_requests
            if ov.autoscaling_config is not None:
                opts["autoscaling_config"] = AutoscalingConfig(
                    **ov.autoscaling_config)
            if ov.user_config is not None:
                opts["user_config"] = ov.user_config
            dep = dep.options(**opts)
        return dep.bind(*args, **kwargs)

    rebuilt = rebuild(app)
    missing = set(overrides) - seen
    if missing:
        raise ValueError(
            f"config overrides deployments not in the graph: "
            f"{sorted(missing)}")
    return rebuilt


def deploy_config(config: ServeDeployConfig) -> list[str]:
    """Apply a declarative config: serve.run every application. Returns
    the deployed application names. Apps present in the controller but
    absent from the config are REMOVED (declarative = the file is the
    whole desired state, reference: ServeDeploySchema semantics)."""
    from ray_tpu_torch import serve

    if config.http_options:
        serve.start(http_options=dict(config.http_options))
    deployed = []
    for app_cfg in config.applications:
        app = build_application(app_cfg)
        prefix = app_cfg.route_prefix
        if prefix is None:
            prefix = "/" if app_cfg.name == "default" \
                else f"/{app_cfg.name}"
        serve.run(app, name=app_cfg.name, route_prefix=prefix)
        deployed.append(app_cfg.name)
    existing = {key.split("::", 1)[0] for key in serve.status()}
    for name in existing - set(deployed):
        serve.delete(name)
    return deployed
