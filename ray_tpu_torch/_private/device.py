"""Device policy: ``cuda`` unless the caller asks for the CPU.

Importing this module pins float32 matrix products and convolutions to
full float32 (no TF32), so the plain PyTorch versions on the card compute
what they do on the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA device and raises when there is no
    card; anything else is taken as given (``"cpu"`` only when asked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
