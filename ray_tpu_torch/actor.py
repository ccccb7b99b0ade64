"""Actors: ``ActorClass``, ``ActorHandle`` and method calls.

The port of ``ray_tpu/actor.py``. An actor runs on a thread of the
calling process, or (``process=True``) in a worker process of its own;
a handle pickles to its actor id, so it can be passed to tasks and other
actors, in this process or in a worker process. A named actor of another
driver is reached through a ``ForeignActorHandle`` (``get_actor``).
"""

from __future__ import annotations

import functools

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.actor_runtime import exit_actor  # noqa: F401 — re-export
from ray_tpu_torch._private.actor_runtime import method_groups
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.remote_function import (
    _VALID_OPTIONS,
    _build_strategy,
    _resources,
)

_ACTOR_OPTIONS = _VALID_OPTIONS | {
    "max_concurrency", "max_restarts", "max_task_retries",
    "max_pending_calls", "lifetime", "namespace", "get_if_exists",
    "process", "concurrency_groups",
}


class ActorMethod:
    """A bound remote method: ``handle.method.remote(...)``."""

    def __init__(self, actor_id: ActorID, method_name: str,
                 num_returns: int = 1, deadline_s: "float | None" = None):
        self._actor_id = actor_id
        self._method_name = method_name
        self._num_returns = num_returns
        # The actor's default budget; .options(_deadline_s=...) overrides.
        self._deadline_s = deadline_s

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(self._actor_id, self._method_name,
                           opts.get("num_returns", self._num_returns),
                           opts.get("_deadline_s", self._deadline_s))

    def remote(self, *args, **kwargs):
        refs = worker_mod.auto_init().submit_actor_task(
            self._actor_id, self._method_name, args, kwargs,
            num_returns=self._num_returns, deadline_s=self._deadline_s)
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            "use '.remote()'.")


class ActorHandle:
    """A handle to a live actor; it pickles to the actor's id."""

    def __init__(self, actor_id: ActorID, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        num_returns, deadline_s = 1, None
        runtime = worker_mod.global_runtime()
        record = runtime.gcs.get_actor(self._actor_id) if runtime else None
        if record is not None:
            num_returns = record.method_meta.get(name, {}).get(
                "num_returns", 1)
            deadline_s = record.default_deadline_s or None
        return ActorMethod(self._actor_id, name, num_returns, deadline_s)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) \
            and other._actor_id == self._actor_id

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


class _ForeignActorMethod:
    """A bound method of an actor another driver owns: its calls go to
    that driver's client server through this driver's ordered proxy."""

    def __init__(self, handle: "ForeignActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, *, num_returns: int = 1) -> "_ForeignActorMethod":
        return _ForeignActorMethod(self._handle, self._method_name,
                                   num_returns)

    def remote(self, *args, **kwargs):
        refs = worker_mod.auto_init().submit_foreign_actor_task(
            self._handle._owner_addr, self._handle._actor_key,
            self._method_name, args, kwargs,
            num_returns=self._num_returns)
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            "use '.remote()'.")


class ForeignActorHandle:
    """A handle to a named actor of another driver, resolved through the
    head's actor directory: the owner's client server address and the
    actor's key there."""

    def __init__(self, owner_addr: str, actor_key: str,
                 class_name: str = "Actor",
                 method_meta: dict | None = None):
        self._owner_addr = owner_addr
        self._actor_key = actor_key
        self._class_name = class_name
        self._method_meta = dict(method_meta or {})

    def __getattr__(self, name: str) -> _ForeignActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _ForeignActorMethod(
            self, name,
            self._method_meta.get(name, {}).get("num_returns", 1))

    def __reduce__(self):
        return (ForeignActorHandle,
                (self._owner_addr, self._actor_key, self._class_name,
                 self._method_meta))

    def __hash__(self):
        return hash((self._owner_addr, self._actor_key))

    def __eq__(self, other):
        return (isinstance(other, ForeignActorHandle)
                and other._owner_addr == self._owner_addr
                and other._actor_key == self._actor_key)

    def __repr__(self):
        return (f"ForeignActorHandle({self._class_name}, "
                f"{self._actor_key[:12]}@{self._owner_addr})")


class ActorClass:
    """A class turned into an actor factory by ``@remote``."""

    def __init__(self, cls: type, default_options: dict | None = None):
        self._cls = cls
        self._default_options = dict(default_options or {})
        bad = set(self._default_options) - _ACTOR_OPTIONS
        if bad:
            raise ValueError(f"Invalid actor options: {sorted(bad)}")

        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            "directly. Use '.remote()' to create an actor, or access the "
            "underlying class via '.cls'.")

    @property
    def cls(self) -> type:
        return self._cls

    def options(self, **options) -> "ActorClass":
        bad = set(options) - _ACTOR_OPTIONS
        if bad:
            raise ValueError(f"Invalid options: {sorted(bad)}")
        return ActorClass(self._cls, {**self._default_options, **options})

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._default_options
        declared = opts.get("concurrency_groups") or {}
        undeclared = set(method_groups(self._cls).values()) - set(declared)
        if undeclared:
            raise ValueError(f"{self._cls.__name__} marks methods with "
                             f"concurrency groups {sorted(undeclared)} that "
                             f"concurrency_groups does not declare")
        actor_id, creation_ref = worker_mod.auto_init().create_actor(
            self._cls, args, kwargs,
            name=opts.get("name"), namespace=opts.get("namespace"),
            # Actors hold 0 CPU unless asked, as in the reference.
            resources=_resources(opts, default_cpus=0.0),
            max_concurrency=opts.get("max_concurrency", 1),
            max_restarts=opts.get("max_restarts", 0),
            max_pending_calls=opts.get("max_pending_calls", -1),
            concurrency_groups=opts.get("concurrency_groups"),
            scheduling_strategy=_build_strategy(opts),
            get_if_exists=opts.get("get_if_exists", False),
            process=bool(opts.get("process", False)),
            runtime_env=opts.get("runtime_env"),
            deadline_s=opts.get("_deadline_s"))
        handle = ActorHandle(actor_id, self._cls.__name__)
        handle._creation_ref = creation_ref  # keeps a constructor's error observable
        return handle

    def __repr__(self):
        return f"ActorClass({self._cls.__name__})"


def method(num_returns: int = 1, concurrency_group: str | None = None):
    """Per-method defaults for an actor method: ``num_returns``, and the
    concurrency group (declared in the actor's ``concurrency_groups``)
    whose threads run its calls."""

    def decorator(fn):
        fn.__ray_tpu_num_returns__ = num_returns
        if concurrency_group is not None:
            fn.__ray_tpu_concurrency_group__ = concurrency_group
        return fn

    return decorator
