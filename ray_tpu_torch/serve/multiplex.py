"""Model multiplexing: many models per replica, with an LRU and affinity.

A copy of ``ray_tpu/serve/multiplex.py``: an LRU of models per replica,
loaded by a user ``@serve.multiplexed`` loader, and
``get_multiplexed_model_id``; the router prefers the replica that
already holds the requested model.

Usage::

    @serve.deployment
    class ModelServer:
        @serve.multiplexed(max_num_models_per_replica=3)
        async-or-sync def get_model(self, model_id: str):
            return load_model(model_id)   # expensive

        def __call__(self, request):
            model_id = serve.get_multiplexed_model_id()
            model = self.get_model(model_id)
            return model(request)

    handle.options(multiplexed_model_id="m1").remote(...)
"""

from __future__ import annotations

import collections
import contextvars
import threading
from typing import Any, Callable

_request_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ray_tpu_torch_serve_multiplexed_model_id", default="")

# Router-injected kwarg carrying the model id to the replica.
MODEL_ID_KWARG = "__ray_tpu_torch_multiplexed_model_id"


def get_multiplexed_model_id() -> str:
    """The model id of the CURRENT request (reference:
    serve.get_multiplexed_model_id)."""
    return _request_model_id.get()


class _ModelMultiplexWrapper:
    """Per-replica LRU of loaded models (reference: multiplex.py)."""

    def __init__(self, loader: Callable, owner: Any, max_models: int):
        self._loader = loader
        self._owner = owner
        self._max_models = max_models
        self._lock = threading.Lock()
        self._models: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()

    def load(self, model_id: str) -> Any:
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        # Load OUTSIDE the lock (slow); racing loads of the same id are
        # benign (last one wins, both usable).
        model = self._loader(self._owner, model_id)
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self._max_models:
                self._models.popitem(last=False)  # evict LRU
        return model

    def model_ids(self) -> list[str]:
        with self._lock:
            return list(self._models)


class _MultiplexedMethod:
    """Descriptor: binds a per-INSTANCE wrapper so each replica keeps
    its own LRU."""

    def __init__(self, loader: Callable, max_models: int):
        self._loader = loader
        self._max_models = max_models
        self._attr = f"__multiplex_{loader.__name__}"

    def __set_name__(self, owner, name):
        self._attr = f"__multiplex_{name}"

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        wrapper = getattr(instance, self._attr, None)
        if wrapper is None:
            wrapper = _ModelMultiplexWrapper(
                self._loader, instance, self._max_models)
            setattr(instance, self._attr, wrapper)

        def bound(model_id: str | None = None):
            mid = model_id if model_id is not None \
                else get_multiplexed_model_id()
            if not mid:
                raise ValueError(
                    "no model id: pass one explicitly or send the "
                    "request with handle.options(multiplexed_model_id=...)")
            return wrapper.load(mid)

        bound.model_ids = wrapper.model_ids  # type: ignore[attr-defined]
        return bound


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator (reference: serve.multiplexed api)."""

    def decorator(loader: Callable) -> _MultiplexedMethod:
        return _MultiplexedMethod(loader, max_num_models_per_replica)

    return decorator
