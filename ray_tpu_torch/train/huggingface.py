"""HuggingFace Transformers integration for Train.

The port of ``ray_tpu/train/huggingface.py``: the model is a PyTorch
transformer (``transformers.GPT2LMHeadModel`` and kin) whose parameters
train under ``torch.optim`` inside MeshTrainer's worker loop; the
orchestration (gangs, checkpoints, failure configs) is MeshTrainer's.
``transformers`` is imported inside the functions, as the reference
imports it.

Usage::

    from transformers import GPT2Config, GPT2LMHeadModel

    def make_model():
        return GPT2LMHeadModel(GPT2Config(...))

    trainer = TransformersTrainer(
        make_model,
        train_dataset=token_batches,     # iterable of {"input_ids": [B, T]}
        optimizer=functools.partial(torch.optim.AdamW, lr=3e-4),
        num_epochs=2,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
    )
    result = trainer.fit()

Where the reference passes an optax transformation, ``optimizer`` here
is a factory ``optimizer(parameters) -> torch.optim.Optimizer``; the
default is ``optax.adamw(3e-4)``'s (``AdamW``, weight decay 1e-4).
Dropout draws from torch's default generator, seeded from the loop's
``config["seed"]``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch
import torch.nn.functional as F

from ray_tpu_torch.train.trainer import MeshTrainer


def causal_lm_loss_fn(model) -> Callable:
    """Next-token cross-entropy for causal-LM heads:
    ``loss_fn(batch) -> scalar``, run in the model's current mode (the
    train loop puts it in training mode, so configured dropout
    applies). ``batch["attention_mask"]``, when present, masks the
    targets."""

    def loss_fn(batch: dict) -> torch.Tensor:
        input_ids = batch["input_ids"]
        logits = model(input_ids=input_ids).logits[:, :-1].float()
        targets = input_ids[:, 1:]
        token_losses = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
            reduction="none").reshape(targets.shape)
        mask = batch.get("attention_mask")
        if mask is not None:
            mask = mask[:, 1:].to(token_losses.dtype)
            return (token_losses * mask).sum() / mask.sum().clamp_min(1.0)
        return token_losses.mean()

    return loss_fn


def _default_optimizer(parameters):
    return torch.optim.AdamW(parameters, lr=3e-4, weight_decay=1e-4)


def make_transformers_train_loop(
        model_factory: Callable[[], Any],
        train_dataset: Iterable,
        optimizer: Callable | None = None,
        loss_fn_factory: Callable = causal_lm_loss_fn,
        num_epochs: int = 1,
        report_every: int = 10,
        device=None) -> Callable:
    """Build a MeshTrainer ``train_loop_per_worker``: the model on
    ``device`` (``cuda`` unless asked) in training mode, one optimizer
    step per batch of ``train_dataset`` (an iterable of dicts of arrays,
    or anything with ``iter_batches``), the loss reported through the
    session every ``report_every`` steps and at the end."""

    def train_loop(config: dict | None = None):
        import numpy as np

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.train import session

        where = resolve_device(device)
        torch.manual_seed(int((config or {}).get("seed", 0)))
        model = model_factory().to(where)
        model.train()
        opt = (optimizer or _default_optimizer)(model.parameters())
        loss_fn = loss_fn_factory(model)

        def batches():
            ds = train_dataset
            if hasattr(ds, "iter_batches"):
                yield from ds.iter_batches(batch_format="numpy")
            else:
                yield from ds

        step_idx = 0
        last_loss = None
        for _ in range(num_epochs):
            for batch in batches():
                batch = {k: torch.as_tensor(np.asarray(v)).long().to(where)
                         for k, v in batch.items()}
                opt.zero_grad()
                loss = loss_fn(batch)
                loss.backward()
                opt.step()
                step_idx += 1
                last_loss = loss.item()
                if step_idx % report_every == 0:
                    session.report({"loss": last_loss, "step": step_idx})
        session.report({"loss": last_loss, "step": step_idx, "done": True})

    return train_loop


class TransformersTrainer(MeshTrainer):
    """MeshTrainer wired for 🤗 PyTorch models."""

    def __init__(self, model_factory: Callable[[], Any],
                 *, train_dataset: Iterable,
                 optimizer: Callable | None = None,
                 loss_fn_factory: Callable = causal_lm_loss_fn,
                 num_epochs: int = 1,
                 report_every: int = 10,
                 device=None,
                 **kwargs):
        super().__init__(
            make_transformers_train_loop(
                model_factory, train_dataset, optimizer,
                loss_fn_factory, num_epochs, report_every, device),
            **kwargs)
