"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It mirrors ``ray_tpu``'s layout (``ops/``, ``models/``, ``parallel/``) and
is held against it by the tests. Where ``ray_tpu`` has a Pallas kernel for
the TPU, this package has a CUDA kernel written by hand for ``sm_90a``,
with a plain PyTorch version beside it that runs for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no ``device="cpu"`` they raise.
"""

from ray_tpu_torch._private.device import resolve_device

__all__ = ["resolve_device"]
