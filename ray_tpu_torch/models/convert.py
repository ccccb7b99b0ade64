"""Parameter trees between the JAX package's numpy form and the port.

``ray_tpu.models.llama.init_params`` and ``ray_tpu_torch.models.llama.
init_params`` build the same tree (stacked ``[num_layers, ...]`` weights
under the same keys), so conversion is a copy of each leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_map


def params_from_numpy(tree: dict, device=None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """A nested dict of array-likes (e.g. ``jax.tree.map(np.asarray,
    params)``) → the same tree of ``dtype`` tensors on ``device``."""
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device),
        tree)


def params_to_numpy(params: dict) -> dict:
    """The port's parameter tree → the same tree of float32 numpy arrays
    (numpy has no bfloat16, so every leaf is upcast)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                    params)
