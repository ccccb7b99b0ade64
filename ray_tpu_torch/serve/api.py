"""The public Serve API: start, run, handles, status, delete, shutdown.

The port of ``ray_tpu/serve/api.py``. The controller is a named actor of
the port's runtime; ``run`` walks the bound application graph, deploys
the dependencies first (their places in the init arguments become
``DeploymentHandle``s inside the consuming replica) and waits for the
application's replicas to be built.

A replica is an actor thread of this process, or with
``ray_actor_options={"process": True}`` a process actor, as in the
reference. Where the port differs: ``run`` checks each deployment's
actor options before deploying (an unknown one raises ``ValueError``),
and raises the error of a replica whose constructor failed (an engine server without a
card and without ``device="cpu"``, say) instead of handing back a handle
to a deployment that can never serve.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import ray_tpu_torch
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.serve.config import HTTPOptions
from ray_tpu_torch.serve.controller import (
    ServeController,
    replica_actor_class,
)
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.router import DeploymentHandle, clear_routers

CONTROLLER_NAME = "SERVE_CONTROLLER"

_lock = threading.Lock()
_controller = None
_proxy = None
_apps: dict[str, Application] = {}


@dataclasses.dataclass
class _HandleMarker:
    """A bound sub-deployment in init args; the replica swaps it for a
    live DeploymentHandle when it is built."""

    app_name: str
    deployment_name: str


def _alive(handle) -> bool:
    """Whether ``handle`` names a live actor of the current runtime."""
    runtime = worker_mod.global_runtime()
    record = runtime.gcs.get_actor(handle._actor_id) if runtime else None
    return record is not None and record.state != "DEAD"


def _get_controller():
    global _controller
    with _lock:
        if _controller is not None and _alive(_controller):
            return _controller
        ray_tpu_torch.init(ignore_reinit_error=True)
        try:
            _controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except ValueError:  # not running yet
            _controller = ray_tpu_torch.remote(ServeController).options(
                name=CONTROLLER_NAME, max_concurrency=32).remote()
        return _controller


def start(http_options: HTTPOptions | dict | None = None, **kwargs):
    """Start Serve: the controller and, with ``http_options``, the HTTP
    proxy."""
    global _proxy
    controller = _get_controller()
    if http_options is not None:
        if isinstance(http_options, dict):
            http_options = HTTPOptions(**http_options)
        with _lock:
            if _proxy is None:
                from ray_tpu_torch.serve.proxy import HTTPProxy

                _proxy = HTTPProxy(controller, http_options)
                _proxy.start()
    return controller


def _deploy_graph(app: Application, app_name: str, controller) -> None:
    """Depth-first deploy of the bound dependencies, then the node."""

    def convert(value):
        if isinstance(value, Application):
            _deploy_graph(value, app_name, controller)
            return _HandleMarker(app_name, value.deployment.name)
        return value

    dep: Deployment = app.deployment
    # Refused here, not in the controller's reconcile loop: options no
    # replica actor takes (unknown keys) raise ValueError.
    replica_actor_class(dep.ray_actor_options)
    init_args = tuple(convert(a) for a in app.init_args)
    init_kwargs = {k: convert(v) for k, v in app.init_kwargs.items()}
    replica_config = dep.build_replica_config()
    replica_config.init_args = init_args
    replica_config.init_kwargs = init_kwargs
    ray_tpu_torch.get(controller.deploy.remote(
        app_name, dep.name, dep.deployment_config, replica_config))


def run(target: Application, *, name: str = "default",
        route_prefix: str | None = "/", blocking: bool = False,
        _wait_s: float = 30.0) -> DeploymentHandle:
    """Deploy an application and return a handle to its ingress
    deployment, once its replicas are built (or ``_wait_s`` has passed).
    A replica constructor's error is raised here."""
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(f"serve.run expects a bound Application, "
                        f"got {type(target)}")
    controller = _get_controller()
    _deploy_graph(target, name, controller)
    ray_tpu_torch.get(controller.set_ingress.remote(
        name, target._ingress_name()))
    with _lock:
        _apps[name] = target
        target.deployment.route_prefix = (
            target.deployment.route_prefix or route_prefix)
    handle = DeploymentHandle(target._ingress_name(), name, controller)
    deadline = time.monotonic() + _wait_s
    prefix = f"{name}::"
    while time.monotonic() < deadline:
        failure = ray_tpu_torch.get(controller.get_deploy_failure.remote(name))
        if failure is not None:
            raise failure
        status = ray_tpu_torch.get(controller.get_status.remote())
        mine = [info for key, info in status.items()
                if key.startswith(prefix)]
        if mine and all(info["ready_replicas"] >= info["target_replicas"]
                        for info in mine):
            break
        time.sleep(0.05)
    if blocking:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return handle


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_controller()
    with _lock:
        app = _apps.get(name)
    if app is not None:
        return DeploymentHandle(app._ingress_name(), name, controller)
    # The controller records each application's ingress at run().
    ingress = ray_tpu_torch.get(controller.get_ingress.remote(name))
    if ingress is not None:
        return DeploymentHandle(ingress, name, controller)
    raise KeyError(f"no Serve application named {name!r}")


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name, _get_controller())


def status() -> dict:
    return ray_tpu_torch.get(_get_controller().get_status.remote())


def delete(name: str) -> None:
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_app.remote(name))
    with _lock:
        _apps.pop(name, None)


def shutdown() -> None:
    """Tear down the proxy, the routers, the controller and every
    replica; on return the replicas are killed and nothing here holds a
    deployment's arguments."""
    global _controller, _proxy
    with _lock:
        proxy, _proxy = _proxy, None
        controller, _controller = _controller, None
        _apps.clear()
    if proxy is not None:
        proxy.stop()
    clear_routers()
    if controller is not None and _alive(controller):
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=120)
        ray_tpu_torch.kill(controller, no_restart=True)
