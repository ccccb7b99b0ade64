"""Per-call request context: the in-flight call's end-to-end deadline.

The port of ``ray_tpu/_private/request_context.py``. The actor runtime
sets the contextvar around each method call;
``get_runtime_context().get_task_deadline()`` reads it from inside the
method (None = no deadline armed). Contextvars follow coroutines and stay
apart per thread, so concurrent actor calls never see each other's
budgets.
"""

from __future__ import annotations

import contextvars

_DEADLINE: "contextvars.ContextVar[float | None]" = contextvars.ContextVar(
    "ray_tpu_torch_call_deadline", default=None)


def set_deadline(deadline: "float | None"):
    """Install the current call's absolute deadline (time.time());
    returns the token for :func:`reset_deadline`."""
    return _DEADLINE.set(deadline)


def reset_deadline(token) -> None:
    _DEADLINE.reset(token)


def current_deadline() -> "float | None":
    """The in-flight call's absolute deadline, or None."""
    return _DEADLINE.get()
