"""Worker-side training session: report, get_context, get_checkpoint.

The port of ``ray_tpu/train/session.py``. ``get_mesh`` builds the
``DeviceMesh`` of the worker group (``parallel/mesh.py``) on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.train.checkpoint import Checkpoint


class StopTraining(Exception):
    """Raised inside the train loop when the controller stops the trial."""


@dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_name: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank


@dataclass
class _SessionState:
    context: TrainContext
    results_queue: Any  # queue.Queue shared with the driver
    resume_checkpoint: Checkpoint | None = None
    stop_event: threading.Event = field(default_factory=threading.Event)
    iteration: int = 0


class _TrainSession:
    _tls = threading.local()

    @classmethod
    def current(cls) -> _SessionState | None:
        return getattr(cls._tls, "state", None)

    @classmethod
    def set(cls, state: _SessionState | None):
        cls._tls.state = state


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    """Stream metrics (and optionally a checkpoint) back to the driver.
    If the controller has requested a stop, raises StopTraining."""
    state = _TrainSession.current()
    if state is None:
        raise RuntimeError("report() called outside a training session")
    state.iteration += 1
    state.results_queue.put({
        "rank": state.context.world_rank,
        "iteration": state.iteration,
        "metrics": dict(metrics),
        "checkpoint": checkpoint,
        "done": False,
    })
    if state.stop_event.is_set():
        raise StopTraining()


def get_context() -> TrainContext:
    state = _TrainSession.current()
    if state is None:
        return TrainContext()
    return state.context


def get_checkpoint() -> Checkpoint | None:
    """The checkpoint to resume from."""
    state = _TrainSession.current()
    return state.resume_checkpoint if state is not None else None


def run_with_session(fn, config, state: _SessionState, emit) -> Any:
    """Run ``fn(config)`` under a session; emit({...}) reports completion.

    ``config`` is shallow-copied: the in-process runtime passes task args
    by reference, so without the copy every gang member would share (and
    mutate) one dict."""
    _TrainSession.set(state)
    try:
        result = fn(dict(config)) if config is not None else fn()
        emit({"done": True, "result": result, "error": None})
        return result
    except StopTraining:
        emit({"done": True, "result": None, "error": None})
        return None
    except BaseException as exc:  # noqa: BLE001 — surfaced to the driver
        import traceback

        # The driver only sees the exception object; keep the worker's
        # traceback on it as text, and drop the finished frames' locals:
        # the exception outlives the loop (a restart keeps it), and its
        # frames would keep the loop's tensors on the card.
        try:
            exc.__ray_tpu_torch_remote_tb__ = "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__))
        except AttributeError:
            pass  # an exception type without a __dict__
        traceback.clear_frames(exc.__traceback__)
        emit({"done": True, "result": None, "error": exc})
        raise
    finally:
        _TrainSession.set(None)


def get_mesh(config=None, device=None):
    """The device mesh of this worker group: every rank of the default
    process group (a world of one when there is none), on ``cuda``
    unless the caller passes ``device="cpu"``."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    return build_mesh(config or MeshConfig(dp=-1), device)
