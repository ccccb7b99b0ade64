"""The replica actor: hosts one copy of the user's deployment callable.

The port of ``ray_tpu/serve/replica.py``. Each replica counts its ongoing
requests (the router's and the autoscaler's signal) and rejects a request
past ``max_ongoing_requests`` with ``BackPressureError``, which the router
retries on another replica. Its control methods (health, metrics,
reconfigure, shutdown) run in the actor's ``control`` concurrency group,
so requests that fill the replica's threads (16 streams, say) cannot
starve the controller's probes.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
from typing import Any

from ray_tpu_torch.actor import method

logger = logging.getLogger("ray_tpu_torch")

# Threads of the replica actor's control group.
CONTROL_CONCURRENCY = {"control": 2}


class BackPressureError(Exception):
    """The replica is at max_ongoing_requests; the router retries the
    request elsewhere."""


class Replica:
    """Runs as an actor (one per replica, ``max_concurrency`` > 1 so
    requests overlap)."""

    def __init__(self, deployment_name: str, replica_tag: str,
                 deployment_def: Any, init_args: tuple, init_kwargs: dict,
                 user_config: Any = None, max_ongoing_requests: int = 100,
                 handle_args: dict | None = None):
        self._deployment_name = deployment_name
        self._replica_tag = replica_tag
        self._max_ongoing = max_ongoing_requests
        self._lock = threading.Lock()
        self._num_ongoing = 0
        self._num_total = 0

        # Bound sub-deployments arrive as _HandleMarker placeholders and
        # become live DeploymentHandles here, inside the replica.
        def resolve(value):
            from ray_tpu_torch.serve.api import (
                _HandleMarker,
                get_deployment_handle,
            )

            if isinstance(value, _HandleMarker):
                return get_deployment_handle(
                    value.deployment_name, value.app_name)
            return value

        init_args = tuple(resolve(a) for a in init_args)
        init_kwargs = {k: resolve(v) for k, v in init_kwargs.items()}

        if inspect.isclass(deployment_def):
            self._callable = deployment_def(*init_args, **init_kwargs)
        else:
            self._callable = deployment_def
        if user_config is not None:
            self.reconfigure(user_config)

    # ------------------------------------------------------------- data path

    def _admit(self, kwargs: dict):
        """Backpressure admission and the multiplexed model id; returns
        (kwargs, contextvar token)."""
        from ray_tpu_torch.serve.multiplex import (
            MODEL_ID_KWARG,
            _request_model_id,
        )

        # The router passes the model id as a reserved kwarg; the user
        # callable reads it through get_multiplexed_model_id(). A copy is
        # stripped: a backpressure retry resends the caller's dict.
        model_id = kwargs.get(MODEL_ID_KWARG)
        if model_id is not None:
            kwargs = {k: v for k, v in kwargs.items() if k != MODEL_ID_KWARG}
        with self._lock:
            if self._num_ongoing >= self._max_ongoing:
                raise BackPressureError(
                    f"{self._replica_tag} at max_ongoing_requests="
                    f"{self._max_ongoing}")
            self._num_ongoing += 1
            self._num_total += 1
        token = (_request_model_id.set(model_id)
                 if model_id is not None else None)
        return kwargs, token

    def _finish(self, token) -> None:
        from ray_tpu_torch.serve.multiplex import _request_model_id

        if token is not None:
            _request_model_id.reset(token)
        with self._lock:
            self._num_ongoing -= 1

    def _invoke(self, method_name: str, args: tuple, kwargs: dict):
        if method_name == "__call__":
            target = self._callable
            if not callable(target):
                raise TypeError(
                    f"Deployment {self._deployment_name} is not callable;"
                    f" specify a method name")
        else:
            target = getattr(self._callable, method_name)
        return target(*args, **kwargs)

    def handle_request(self, method_name: str, args: tuple, kwargs: dict):
        kwargs, token = self._admit(kwargs)
        try:
            result = self._invoke(method_name, args, kwargs)
            if inspect.isgenerator(result):
                # Unary path: a generator materializes to a list of its
                # chunks; handle.options(stream=True) streams them.
                result = list(result)
            return result
        finally:
            self._finish(token)

    def handle_request_streaming(self, method_name: str, args: tuple,
                                 kwargs: dict, queue) -> int:
        """Chunks go through the caller's queue as the generator yields
        them, so the caller consumes while this replica produces.
        Protocol: ("chunk", value)* then ("end", n) or ("err", exc)."""
        kwargs, token = self._admit(kwargs)
        n = 0
        try:
            result = self._invoke(method_name, args, kwargs)
            if not inspect.isgenerator(result):
                result = iter([result])
            for chunk in result:
                try:
                    queue.put(("chunk", chunk))
                except Exception:  # noqa: BLE001 — the consumer tore the queue down
                    # An early break: stop producing (a cancellation,
                    # not an error).
                    getattr(result, "close", lambda: None)()
                    return n
                n += 1
            queue.put(("end", n))
            return n
        except BaseException as exc:
            try:
                queue.put(("err", exc))
            except Exception:  # noqa: BLE001 — the queue is gone; the call's ref carries exc
                pass
            raise
        finally:
            self._finish(token)

    # ---------------------------------------------------------- control path

    @method(concurrency_group="control")
    def reconfigure(self, user_config: Any) -> None:
        hook = getattr(self._callable, "reconfigure", None)
        if hook is not None:
            hook(user_config)

    @method(concurrency_group="control")
    def check_health(self) -> bool:
        hook = getattr(self._callable, "check_health", None)
        if hook is not None:
            hook()
        return True

    @method(concurrency_group="control")
    def get_metrics(self) -> dict:
        with self._lock:
            metrics = {
                "replica_tag": self._replica_tag,
                "num_ongoing_requests": self._num_ongoing,
                "num_total_requests": self._num_total,
                "timestamp": time.time(),
            }
        # The callable's own load gauges (the LLM engine's engine_depth),
        # for the controller's autoscale pass.
        hook = getattr(self._callable, "serve_metrics", None)
        if hook is not None:
            extra = hook()
            if isinstance(extra, dict):
                metrics.update(extra)
        return metrics

    @method(concurrency_group="control")
    def prepare_for_shutdown(self) -> None:
        """Wait up to 5 s for ongoing requests, stop the callable's
        ``@serve.batch`` batchers, then run its ``__del__`` (an engine
        server stops its engine and lets go of its KV pool and weights
        there)."""
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._lock:
                if self._num_ongoing == 0:
                    break
            time.sleep(0.02)
        from ray_tpu_torch.serve.batching import shutdown_batchers

        shutdown_batchers(self._callable)
        hook = getattr(self._callable, "__del__", None)
        if hook is not None:
            hook()
