"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It mirrors ``ray_tpu``'s layout (``ops/``, ``models/``, ``parallel/``,
``serve/``, the runtime) and is held against it by the tests. Where
``ray_tpu`` has a Pallas kernel for the TPU, this package has a CUDA kernel
written by hand for ``sm_90a``, with a plain PyTorch version beside it that
runs for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no ``device="cpu"`` they raise.

The core runtime runs tasks and actors on threads of the calling
process, with ``GPU`` as a resource of its own::

    import ray_tpu_torch

    ray_tpu_torch.init()

    @ray_tpu_torch.remote(num_gpus=1)
    def f(x):
        return x * 2

    ray_tpu_torch.get(f.remote(2))  # -> 4
"""

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.worker import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, exit_actor, method
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context


def remote(*args, **kwargs):
    """Turn a function into a task factory or a class into an actor
    factory: bare ``@remote`` or ``@remote(num_gpus=1, ...)``."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        return ActorClass(target) if isinstance(target, type) \
            else RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_gpus=1)")

    def decorator(target):
        return ActorClass(target, kwargs) if isinstance(target, type) \
            else RemoteFunction(target, kwargs)

    return decorator


__all__ = [
    "ActorClass", "ActorHandle", "ObjectRef", "RemoteFunction",
    "available_resources", "cancel", "cluster_resources", "exceptions",
    "exit_actor", "get", "get_actor", "get_runtime_context", "init",
    "is_initialized", "kill", "method", "nodes", "put", "remote",
    "resolve_device", "shutdown", "timeline", "wait",
]
