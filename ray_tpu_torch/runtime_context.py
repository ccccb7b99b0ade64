"""What a task or actor can learn about where it runs.

The port of ``ray_tpu/runtime_context.py``. Inside a task or an actor,
``get_assigned_resources()`` gives the resources it holds (``GPU``
included); the reference gives ``{}`` for a task on a thread of its
process and no actor id inside an actor.
"""

from __future__ import annotations

from ray_tpu_torch._private import request_context
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.worker import RuntimeContext as _Ctx


class RuntimeContextAPI:
    @property
    def job_id(self):
        return _Ctx.current().get("job_id", worker_mod.auto_init().job_id)

    def get_job_id(self) -> str:
        return self.job_id.hex()

    @property
    def task_id(self):
        return _Ctx.current().get("task_id")

    def get_task_id(self) -> str | None:
        task_id = self.task_id
        return task_id.hex() if task_id is not None else None

    @property
    def actor_id(self):
        return _Ctx.current().get("actor_id")

    def get_actor_id(self) -> str | None:
        actor_id = self.actor_id
        return actor_id.hex() if actor_id is not None else None

    @property
    def node_id(self):
        return _Ctx.current().get("node_id",
                                  worker_mod.auto_init().head_node_id)

    def get_node_id(self) -> str:
        return self.node_id.hex()

    @property
    def namespace(self) -> str:
        return worker_mod.auto_init().namespace

    def get_assigned_resources(self) -> dict:
        return dict(_Ctx.current().get("resources", {}))

    def get_task_deadline(self) -> float | None:
        """The running call's absolute end-to-end deadline
        (``time.time()`` clock) from ``.options(_deadline_s=...)``, or
        None when no budget is armed."""
        return request_context.current_deadline()


def get_runtime_context() -> RuntimeContextAPI:
    return RuntimeContextAPI()
