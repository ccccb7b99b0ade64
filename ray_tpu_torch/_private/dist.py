"""The process group under the device mesh.

The reference's mesh is built from ``jax.devices()``, which JAX gives
every process for free; a ``torch.distributed`` mesh needs a process
group first. ``ensure_process_group`` brings one up the way a launcher
would have, or takes the one that exists:

- an existing default group is used as it is;
- with ``WORLD_SIZE`` in the environment (``torchrun`` and its kin set
  it, with ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), ``env://``;
- otherwise a world of one on an in-memory store, so that one process
  runs the sharded path on its own card.

A collective that does not complete within ``DEFAULT_TIMEOUT`` fails, in
the default group and (``set_group_timeouts``) in a mesh's groups.

The backend is NCCL for ``cuda`` and gloo for ``cpu``; there is no
fallback from one to the other. Each rank's card is ``LOCAL_RANK``'s.
"""

from __future__ import annotations

import datetime
import os
import threading

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)
# The workers of a thread gang share the process's one default group:
# the first to get here brings it up, the others take it.
_INIT_LOCK = threading.Lock()


def backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def ensure_process_group(device: torch.device,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> None:
    """Make sure a default process group whose backend serves ``device``
    exists; pin this rank's card to ``LOCAL_RANK`` on ``cuda``."""
    backend = backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    with _INIT_LOCK:
        if dist.is_initialized():
            have = dist.get_backend()
            if backend not in have:
                raise RuntimeError(
                    f"the default process group's backend is {have!r}; "
                    f"{device.type} tensors need {backend!r}")
            return
        kwargs = {}
        if device.type == "cuda":
            kwargs["device_id"] = torch.device("cuda",
                                               torch.cuda.current_device())
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout, **kwargs)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout, **kwargs)


def set_group_timeouts(mesh, timeout: datetime.timedelta = DEFAULT_TIMEOUT
                       ) -> None:
    """Give each group of ``mesh`` the collective timeout: a
    ``DeviceMesh`` makes its groups with the backend's default (10
    minutes for NCCL, 30 for gloo)."""
    for dim in range(mesh.ndim):
        dist.distributed_c10d._set_pg_timeout(timeout, mesh.get_group(dim))
