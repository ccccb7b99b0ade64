"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (which runs for CPU tensors)."""

from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.fused import rms_norm

__all__ = ["flash_attention", "rms_norm"]
