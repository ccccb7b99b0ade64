"""The training step: AdamW with warmup-cosine and global-norm clipping
(and a plain Adam, ``optax.adam``'s counterpart).

The port of ``ray_tpu/parallel/train_step.py``. With a mesh, the
parameters (and so the AdamW moments, the gradients and every update) are
DTensors placed per the logical-axis rules, and the batch is placed by
``shard_batch``, as the reference's GSPMD step places them; without one,
plain tensors on one device. The optimizer follows
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(
warmup_cosine_decay_schedule(0, peak, warmup, total), b1=0.9, b2=0.95,
weight_decay=wd))`` exactly:

- clipping is ``g if norm < max_norm else g / norm * max_norm``, with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` adds one, so it is not used);
- Adam's bias correction uses ``t = count + 1``, eps = 1e-8 outside the
  square root, and weight decay applies to every leaf;
- the learning rate is the schedule at the 0-based update count, so with
  warmup the first update has lr 0;
- the ``grad_norm`` metric is the norm of the unclipped grads.

Where the JAX step donates its state to ``jit``, this one updates the
parameters and moments in place, so no second copy of them exists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.parallel.sharding import placements, shard_params


def _adam_state(params: Any) -> dict:
    """The update count and zero first and second moments."""
    zeros = lambda p: torch.zeros_like(p, memory_format=torch.preserve_format)
    return {"count": 0, "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params)}


def _adam_updates(b1: float, b2: float, eps: float, grads, state: dict):
    """Advance each moment pair of ``state`` by its gradient in place and
    yield the bias-corrected step ``mu_hat / (sqrt(nu_hat) + eps)``, one
    per parameter; the caller applies it and bumps ``state["count"]``."""
    count = state["count"]
    c1 = 1 - b1 ** (count + 1)
    c2 = 1 - b2 ** (count + 1)
    for g, mu, nu in zip(grads, tree_leaves(state["mu"]),
                         tree_leaves(state["nu"])):
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        yield (mu / c1) / (torch.sqrt(nu / c2) + eps)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clipping then AdamW on a warmup-cosine schedule."""

    learning_rate: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    max_grad_norm: float

    B1, B2, EPS = 0.9, 0.95, 1e-8

    def lr(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, lr, warmup, total)``."""
        if count < self.warmup_steps:
            return self.learning_rate * count / self.warmup_steps
        decay_steps = self.total_steps - self.warmup_steps
        t = min(count - self.warmup_steps, decay_steps)
        return self.learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay_steps))

    def init(self, params: Any) -> dict:
        return _adam_state(params)

    @torch.no_grad()
    def update_(self, params: list, grads: list, state: dict,
                grad_norm: torch.Tensor) -> None:
        """Apply one update to ``params`` and ``state`` in place."""
        count = state["count"]
        lr = self.lr(count)
        clip = grad_norm >= self.max_grad_norm
        grads = (torch.where(clip, g / grad_norm * self.max_grad_norm, g)
                 for g in grads)
        for p, update in zip(params, _adam_updates(
                self.B1, self.B2, self.EPS, grads, state)):
            update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
        state["count"] = count + 1


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, a constant rate, no clipping and no weight decay;
    ``AdamW``'s interface (``update_`` ignores ``grad_norm``)."""

    learning_rate: float
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def init(self, params: Any) -> dict:
        return _adam_state(params)

    @torch.no_grad()
    def update_(self, params: list, grads: list, state: dict,
                grad_norm: torch.Tensor) -> None:
        for p, update in zip(params, _adam_updates(
                self.B1, self.B2, self.EPS, grads, state)):
            p.add_(update, alpha=-self.learning_rate)
        state["count"] += 1


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10000,
                      max_grad_norm: float = 1.0) -> AdamW:
    """AdamW + cosine schedule + global-norm clip — the Llama SFT recipe."""
    return AdamW(learning_rate, weight_decay, warmup_steps,
                 max(total_steps, warmup_steps + 1), max_grad_norm)


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors that require grad), optimizer state and
    the step count. ``step`` updates it in place."""

    params: dict
    opt_state: dict
    step: int = 0


def create_train_state(params: Any, optimizer: AdamW | Adam,
                       mesh: DeviceMesh | None = None,
                       logical_axes: Any | None = None,
                       device=None) -> TrainState:
    """Copy ``params`` to ``device`` as float32 and build the optimizer
    state. The copy is taken even where ``params`` already lies there, so
    the in-place updates never write into the caller's tensors.

    With a mesh, the copies are placed on it per ``logical_axes`` (the
    rules' guess, ``infer_param_logical_axes``, when None) as DTensors,
    on the mesh's device type, and the AdamW moments follow them (they
    are ``zeros_like`` the params)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, got {mesh!r} (pass the "
                        f"device as device=)")
    if device is None and mesh is not None:
        device = mesh.device_type
    device = resolve_device(device)
    params = tree_map(
        lambda p: p.detach().to(device, torch.float32, copy=True), params)
    if mesh is not None:
        params = shard_params(params, mesh, logical_axes)
    params = tree_map(lambda p: p.requires_grad_(True), params)
    return TrainState(params, optimizer.init(params), 0)


def global_norm(tensors: list) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``).
    Over DTensors each sum is a partial sum over the shards, and the
    square root takes the total: the norm is global."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def build_train_step(loss_fn: Callable[..., torch.Tensor],
                     optimizer: AdamW | Adam) -> Callable:
    """Return ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar``. The step updates ``state`` in
    place and returns it; the metrics are 0-d tensors on the device, so
    reading them is the caller's synchronisation point."""

    def step(state: TrainState, batch: Any):
        leaves = tree_leaves(state.params)
        loss = loss_fn(state.params, batch)
        if isinstance(loss, DTensor):
            # The loss of a sharded batch is a partial mean on each rank.
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = global_norm(grads)
        optimizer.update_(leaves, grads, state.opt_state, grad_norm)
        if isinstance(grad_norm, DTensor):
            grad_norm = grad_norm.full_tensor()
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "step": state.step}
        state.step += 1
        return state, metrics

    return step


def place_batch(batch: Any, device=None) -> Any:
    """Put a host batch (arrays or tensors, nested dicts) on ``device``;
    integer arrays become int64 tensors, as indexing wants."""
    device = resolve_device(device)

    def place(x):
        t = torch.as_tensor(x)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        return t.to(device)

    return tree_map(place, batch)


def shard_batch(batch: Any, mesh: DeviceMesh, seq_axes: bool = True) -> Any:
    """Place a host batch (as ``place_batch`` takes it, the same on every
    rank) on the mesh: leading dim over (dp, fsdp), second dim (sequence)
    over sp when present."""

    def place(t):
        if t.ndim >= 2 and seq_axes:
            spec = (("dp", "fsdp"), "sp")
        elif t.ndim >= 1:
            spec = (("dp", "fsdp"),)
        else:
            spec = ()
        return distribute_tensor(t, mesh, placements(mesh, spec))

    return tree_map(place, place_batch(batch, mesh.device_type))
