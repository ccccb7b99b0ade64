"""MLP classifier: the MNIST end-to-end model.

The port of ``ray_tpu/models/mlp.py``: a list of ``{"w", "b"}`` layers,
plain functions on tensors. ``init_params`` draws from a
``torch.Generator``; the JAX init converts through
``models/convert.params_from_numpy``, which takes the list.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    input_dim: int = 784
    hidden_dims: tuple[int, ...] = (128, 128)
    num_classes: int = 10
    dtype: Any = torch.float32


def init_params(config: MLPConfig, generator: torch.Generator,
                device=None) -> list[dict]:
    """He-normal weights and zero biases, drawn on ``generator``'s
    device and placed on ``device`` (``cuda`` unless asked)."""
    device = resolve_device(device)
    dims = (config.input_dim, *config.hidden_dims, config.num_classes)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=generator,
                        device=generator.device) * (2.0 / d_in) ** 0.5
        params.append({"w": w.to(device, config.dtype),
                       "b": torch.zeros((d_out,), dtype=config.dtype,
                                        device=device)})
    return params


def param_logical_axes(config: MLPConfig | None = None,
                       num_layers: int | None = None) -> list[dict]:
    n = (num_layers if num_layers is not None
         else (len(config.hidden_dims) + 1 if config else 3))
    return [{"w": ("embed", "mlp"), "b": (None,)} for _ in range(n)]


def forward(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = F.relu(x)
    return x


def loss_fn(params: list[dict], batch: dict) -> torch.Tensor:
    logp = F.log_softmax(forward(params, batch["x"]), dim=-1)
    return -logp.gather(-1, batch["y"][:, None].long())[:, 0].mean()


def accuracy(params: list[dict], batch: dict) -> torch.Tensor:
    logits = forward(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).float().mean()
