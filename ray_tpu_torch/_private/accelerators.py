"""Accelerator detection: the node's ``GPU`` resource.

The port of ``ray_tpu/_private/accelerators.py``, which finds TPUs only.
Here the head node's ``GPU`` count is ``torch.cuda.device_count()``: it
honours ``CUDA_VISIBLE_DEVICES`` and asks NVML, so detection creates no
CUDA context in the process (one that later forks workers must not hold
one). ``RAY_TPU_TORCH_NUM_GPUS`` overrides the count and
``RAY_TPU_TORCH_SKIP_GPU_DETECTION`` skips detection, as
``RAY_TPU_NUM_TPU_CHIPS`` and ``RAY_TPU_SKIP_TPU_DETECTION`` do for the
reference.
"""

from __future__ import annotations

import os

import torch


def detect_resources() -> dict[str, float]:
    """``{"GPU": count}`` where the count is above 0, else ``{}``."""
    override = os.environ.get("RAY_TPU_TORCH_NUM_GPUS")
    if override is not None:
        count = float(override)
    elif os.environ.get("RAY_TPU_TORCH_SKIP_GPU_DETECTION"):
        count = 0.0
    else:
        count = float(torch.cuda.device_count())
    return {"GPU": count} if count > 0 else {}
