"""The exceptions the port raises to its callers.

Copies of the classes of ``ray_tpu/exceptions.py`` that the runtime and
the serving engine raise, with the same names, bases and attributes, so a
caller handles the port's errors as it handles the reference's.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; the original is ``.cause``."""

    def __init__(self, cause: BaseException, remote_traceback: str = "",
                 task_name: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_name = task_name
        super().__init__(str(cause))

    def __str__(self):
        base = (f"Task '{self.task_name}' failed: "
                f"{type(self.cause).__name__}: {self.cause}")
        if self.remote_traceback:
            base += "\n\nRemote traceback:\n" + self.remote_traceback
        return base


class ActorError(TaskError):
    """An actor method (or its constructor) raised an exception."""


class ActorDiedError(RayTpuError):
    """The actor was dead when a method call was attempted."""

    def __init__(self, actor_id=None, reason: str = "actor has died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(reason)


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """An object could not be found in any store and had no lineage."""

    def __init__(self, object_ref=None, reason: str = "object lost"):
        self.object_ref = object_ref
        super().__init__(reason)


class ObjectFreedError(ObjectLostError):
    """The object was explicitly freed."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """A wait for a result did not complete within the requested
    timeout."""


class TaskTimeoutError(TaskError):
    """The request's end-to-end deadline expired before it produced a
    result. ``.stage`` names where the budget was found dead (for the
    serving engine: ``llm_queue`` or ``llm_decode``). Not retryable: the
    deadline belongs to the caller."""

    def __init__(self, task_name: str = "", stage: str = "",
                 deadline: float = 0.0):
        self.stage = stage
        self.deadline = deadline
        cause = TimeoutError(
            f"end-to-end deadline expired at stage {stage!r}")
        super().__init__(cause, "", task_name)

    def __reduce__(self):
        return (TaskTimeoutError,
                (self.task_name, self.stage, self.deadline))


class SystemOverloadedError(RayTpuError):
    """Admission control rejected the work instead of queueing it
    unboundedly. Retryable: nothing executed; back off and resubmit."""

    def __init__(self, reason: str = "system overloaded",
                 retry_after_s: float = 0.1):
        self.retry_after_s = retry_after_s
        super().__init__(reason)

    def __reduce__(self):
        return (SystemOverloadedError,
                (self.args[0] if self.args else "system overloaded",
                 self.retry_after_s))


class CacheExhaustedError(SystemOverloadedError):
    """The LLM engine's paged KV cache (or its bounded waiting queue)
    cannot hold this request right now. Retryable: nothing decoded."""

    def __init__(self, reason: str = "KV cache exhausted",
                 retry_after_s: float = 0.5):
        super().__init__(reason, retry_after_s)

    def __reduce__(self):
        return (CacheExhaustedError,
                (self.args[0] if self.args else "KV cache exhausted",
                 self.retry_after_s))


class TaskCancelledError(RayTpuError):
    """The task was cancelled before it ran."""

    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__("task was cancelled")


class PendingCallsLimitExceeded(RayTpuError):
    """The actor's queue of pending calls is at ``max_pending_calls``."""


class WorkerCrashedError(RayTpuError):
    """A worker died while executing a task (a system failure, retried
    while retries remain). ``worker_pid`` is the dead worker's pid, which
    tells a memory monitor's kill from other crashes."""

    worker_pid: int | None = None


class OutOfMemoryError(RayTpuError):
    """The object store or a worker's heap exceeded its memory budget."""


class PlacementGroupError(RayTpuError):
    """Placement group creation or scheduling failed."""
