"""TorchTrainer: data-parallel torch training on the worker group.

The port of ``ray_tpu/train/torch.py``. As in the reference, gradient
synchronisation rides the framework's own collective (the
``util.collective`` store), not a ``torch.distributed`` group, so the
same loop runs on any thread gang. ``prepare_model`` gives DDP's
result: rank 0's parameters broadcast at wrap time, and each gradient
averaged across ranks by the time ``backward()`` returns, so whatever
the loop does next (clipping, unscaling, a hand-written update) sees
the average, and the replicas stay bitwise equal after every step.

The gradients travel as tensors on their own device (bf16 included),
never through numpy. Each hook waits until every rank has contributed.
On ``cuda`` autograd would run a parameter's accumulation, and so its
hook, on the process's one autograd thread for that card, which the
workers of a thread gang share: a hook waiting there for the other ranks
would wait for hooks that can then no longer run. So each worker's loop
runs with multithreaded backward disabled (a per-thread setting): its
backward, hooks included, runs on the worker's own thread, as it does on
the CPU.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Callable

import torch

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer

# Which collective group THIS worker thread's trainer run uses; set by
# the backend wrap so prepare_model/prepare_data_loader can find it
# without threading a handle through user code.
_tls = threading.local()


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer whose backend is the framework collective."""

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None,
                 resume_from_checkpoint=None):
        super().__init__(
            self._torch_backend_wrap(train_loop_per_worker),
            train_loop_config=train_loop_config,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )

    @staticmethod
    def _torch_backend_wrap(loop: Callable) -> Callable:
        # Unique per trainer instance so concurrent fits never share a
        # rendezvous store.
        group = f"__torch_trainer__{uuid.uuid4().hex[:8]}"

        def wrapped(config: dict):
            from ray_tpu_torch.train.session import get_context
            from ray_tpu_torch.util import collective

            ctx = get_context()
            world = ctx.get_world_size()
            _tls.group = group
            if world > 1:
                # The collective group is the torch "process group".
                collective.init_collective_group(
                    world, ctx.get_world_rank(), group_name=group)
            try:
                # Backward on this thread, never the card's shared one.
                with torch.autograd.set_multithreading_enabled(False):
                    return loop(config)
            finally:
                _tls.group = None
                if world > 1:
                    collective.destroy_collective_group(group)

        return wrapped


def _group_name() -> str:
    group = getattr(_tls, "group", None)
    if not group:
        raise RuntimeError(
            "prepare_model/prepare_data_loader must run inside a "
            "TorchTrainer training loop")
    return group


def _average_hook(group, owner: int) -> Callable:
    def hook(param):
        if param.grad is None:
            return
        if threading.get_ident() != owner:
            raise RuntimeError(
                "prepare_model's gradient hook ran off the training loop's "
                "thread (was multithreaded backward enabled again?): it "
                "would wait there for the other ranks")
        from ray_tpu_torch.util import collective

        reduced = collective.allreduce(param.grad, group_name=group.name)
        param.grad.copy_(reduced / group.world_size)

    return hook


def prepare_model(model) -> Any:
    """The DDP-equivalent wrap:

    - broadcasts rank 0's parameters and buffers so every rank starts
      identical;
    - registers post-accumulate-grad hooks that allreduce-average each
      parameter's gradient across ranks on ``loss.backward()``, on the
      loop's own thread (see the module's docstring).

    The collective store matches contributions by the group's op
    sequence; autograd fires the hooks in reverse graph order, the same
    on every rank for identical models, so the sequence numbers line up.
    """
    from ray_tpu_torch.train.session import get_context
    from ray_tpu_torch.util import collective

    ctx = get_context()
    if ctx.get_world_size() <= 1:
        return model
    group = collective.collective.get_group(_group_name())
    with torch.no_grad():
        for tensor in list(model.parameters()) + list(model.buffers()):
            tensor.copy_(collective.broadcast(tensor.detach(), src_rank=0,
                                              group_name=group.name))
    hook = _average_hook(group, threading.get_ident())
    for param in model.parameters():
        if param.requires_grad:
            param.register_post_accumulate_grad_hook(hook)
    return model


class _EpochShardedLoader:
    """DataLoader wrapper that advances its DistributedSampler epoch on
    every iteration (hiding the sampler means we must call
    ``set_epoch``, or every epoch replays one permutation)."""

    def __init__(self, loader, sampler):
        self._loader = loader
        self._sampler = sampler
        self._epoch = 0
        self.batch_size = loader.batch_size
        self.dataset = loader.dataset

    def __iter__(self):
        self._sampler.set_epoch(self._epoch)
        self._epoch += 1
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)


def prepare_data_loader(data_loader):
    """Shard a DataLoader across ranks with a DistributedSampler.
    Preserves the caller's shuffle choice and reshuffles per epoch when
    shuffling."""
    from ray_tpu_torch.train.session import get_context

    ctx = get_context()
    world = ctx.get_world_size()
    if world <= 1:
        return data_loader
    # A RandomSampler means the caller asked for shuffle=True; anything
    # else stays ordered.
    shuffle = isinstance(getattr(data_loader, "sampler", None),
                         torch.utils.data.RandomSampler)
    sampler = torch.utils.data.distributed.DistributedSampler(
        data_loader.dataset, num_replicas=world,
        rank=ctx.get_world_rank(), shuffle=shuffle)
    loader = torch.utils.data.DataLoader(
        data_loader.dataset, batch_size=data_loader.batch_size,
        sampler=sampler, num_workers=0,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last)
    if not shuffle:
        return loader
    return _EpochShardedLoader(loader, sampler)


def backward_sync_disabled(model):
    """DDP's ``no_sync`` for gradient accumulation: not supported."""
    raise NotImplementedError(
        "gradient accumulation with deferred sync is not supported; "
        "accumulate in the loss (sum microbatches) instead")
