"""The training step: AdamW with warmup-cosine and global-norm clipping.

The port of ``ray_tpu/parallel/train_step.py`` on one device. The
optimizer follows ``optax.chain(optax.clip_by_global_norm(max_norm),
optax.adamw(warmup_cosine_decay_schedule(0, peak, warmup, total), b1=0.9,
b2=0.95, weight_decay=wd))`` exactly:

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

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map


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
        zeros = lambda p: torch.zeros_like(p, memory_format=torch.preserve_format)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update_(self, params: list, grads: list, state: dict,
                grad_norm: torch.Tensor) -> None:
        """Apply one update to ``params`` and ``state`` in place."""
        count = state["count"]
        lr = self.lr(count)
        c1 = 1 - self.B1 ** (count + 1)
        c2 = 1 - self.B2 ** (count + 1)
        clip = grad_norm >= self.max_grad_norm
        for p, g, mu, nu in zip(params, grads, tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            g = torch.where(clip, g / grad_norm * self.max_grad_norm, g)
            mu.mul_(self.B1).add_(g, alpha=1 - self.B1)
            nu.mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-lr)
        state["count"] = count + 1


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


def create_train_state(params: Any, optimizer: AdamW,
                       device=None) -> TrainState:
    """Copy ``params`` to ``device`` as float32 and build the optimizer
    state. The copy is taken even where ``params`` already lies there, so
    the in-place updates never write into the caller's tensors."""
    device = resolve_device(device)
    params = tree_map(
        lambda p: p.detach().to(device, torch.float32, copy=True)
        .requires_grad_(True), params)
    return TrainState(params, optimizer.init(params), 0)


def global_norm(tensors: list) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def build_train_step(loss_fn: Callable[..., torch.Tensor],
                     optimizer: AdamW) -> Callable:
    """Return ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar``. The step updates ``state`` in
    place and returns it; the metrics are 0-d tensors on the device, so
    reading them is the caller's synchronisation point."""

    def step(state: TrainState, batch: Any):
        leaves = tree_leaves(state.params)
        loss = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = global_norm(grads)
        optimizer.update_(leaves, grads, state.opt_state, grad_norm)
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
