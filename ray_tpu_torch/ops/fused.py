"""RMSNorm over the last axis: a CUDA kernel for Hopper, forward only.

The port of ``ray_tpu/ops/fused.py``. ``rmsnorm`` in ``csrc/fused.cu``
replaces its Pallas kernel ``_rmsnorm_kernel``:
``x * rsqrt(mean(x^2) + eps) * scale`` with f32 statistics and one
rounding to x's dtype. The backward is the reference's analytic formula
(``_rms_bwd``) in PyTorch ops, as the reference writes it in plain JAX.

Beside the kernel is its plain PyTorch version, ``rms_norm_plain``, which
computes the same function with the same roundings. A CPU tensor goes to
the plain version; a CUDA tensor goes to the kernel or the call raises.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from ray_tpu_torch.ops import _build

# Launches of the kernel in this process. Only ``rms_norm_kernel`` adds to
# it, one for each launch.
launches = {"rmsnorm": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The launch's scalars (x's dtype code, scale's, rows, D, x's row stride,
# eps) in the layout of csrc/fused.cu's RmsArgs: ctypes converts one
# argument instead of six, 1.2 us less per call on the H100's host
# (rmsnorm_launch_cost.py), which is what puts the call under
# F.rms_norm's at the decode shape.
_RMS_ARGS = struct.Struct("@iiiiqf")
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.library("fused")
    if lib.rtt_rmsnorm.argtypes is None:
        lib.rtt_rmsnorm.argtypes = [_P, _P, _P, ctypes.c_char_p, _P]
        lib.rtt_rmsnorm.restype = ctypes.c_int
    return lib


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel, over the last axis of ``x``:
    f32 statistics, ``(x * rsqrt(var + eps)) * scale`` in f32, one
    rounding to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rms_norm_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on ``x2d`` [rows, D] (bf16 or f32, contiguous last
    dim, any row stride) and ``scale`` [D] (f32 or bf16): out [rows, D],
    contiguous, in x's dtype.

    At the decode shape the kernel runs ~2 us and this function's host
    time is the call's time: each check reads what it needs once and
    builds no device object, and the kernel's scalars cross to C packed
    in one block."""
    if not x2d.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{x2d.device}")
    shape = x2d.shape
    if len(shape) != 2:
        raise ValueError(f"x must be [rows, D], got shape {tuple(shape)}")
    rows, d = shape
    x_code = _DTYPE_CODES.get(x2d.dtype)
    scale_code = _DTYPE_CODES.get(scale.dtype)
    if x_code is None or scale_code is None:
        raise TypeError(f"x is {x2d.dtype} and scale {scale.dtype}; the "
                        f"kernel takes float32 or bfloat16")
    row_stride, col_stride = x2d.stride()
    if col_stride != 1 and d > 1:
        raise ValueError(f"x needs a contiguous last dim (strides "
                         f"{x2d.stride()})")
    device = x2d.get_device()
    if scale.get_device() != device or scale.shape != (d,) \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous [{d}] tensor on "
                         f"{x2d.device}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not 1 <= rows < 2 ** 31 or d < 1:
        raise ValueError(f"need 1 <= rows < 2^31 and D >= 1, got "
                         f"{tuple(shape)}")
    # Contiguous [rows, D] for every x taken here: x2d's own layout where
    # it is dense (a contiguous last dim then means contiguous rows), else
    # the contiguous one.
    out = torch.empty_like(x2d)
    lib = _lib()
    err = _build.launch(lib.rtt_rmsnorm, device, x2d.data_ptr(),
                        scale.data_ptr(), out.data_ptr(),
                        _RMS_ARGS.pack(x_code, scale_code, rows, d,
                                       row_stride, eps))
    _build.check(lib, err, "rmsnorm kernel")
    launches["rmsnorm"] += 1
    return out


def rms_norm_fwd(x2d: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """The plain version for CPU tensors, else the kernel."""
    if x2d.is_cpu:
        return rms_norm_plain(x2d, scale, eps)
    return rms_norm_kernel(x2d, scale, eps)


def rms_norm_bwd(x2d: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale in scale's dtype): ``_rms_bwd``'s formula,
    d/dx of x * inv(x) = inv * g*s - x * (x . g*s) * inv^3 / D."""
    x = x2d.float()
    gf = g.float()
    s = scale.float()
    d = x.shape[-1]
    var = torch.mean(x * x, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    d_scale = torch.sum(gf * (x * inv), dim=0)
    gs = gf * s
    dot = torch.sum(gs * x, dim=-1, keepdim=True)
    dx = inv * gs - x * dot * inv ** 3 / d
    return dx.to(x2d.dtype), d_scale.to(scale.dtype)


class RMSNorm(torch.autograd.Function):
    """RMSNorm of [rows, D] with the analytic backward; saves (x, scale)
    as the reference's custom_vjp does."""

    @staticmethod
    def forward(ctx, x2d, scale, eps):
        ctx.save_for_backward(x2d, scale)
        ctx.eps = eps
        return rms_norm_fwd(x2d, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, scale = ctx.saved_tensors
        dx, d_scale = rms_norm_bwd(x2d, scale, g, ctx.eps)
        return dx, d_scale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis. x: [..., D], scale: [D].

    The signature of ``ray_tpu.ops.rms_norm`` without ``interpret``: a
    CPU tensor takes the plain version, a CUDA tensor the kernel. Where
    no gradient is wanted (grad mode off, or neither input requires one)
    the forward is called without the autograd Function, which would
    save tensors no backward reads."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if x2d.stride(-1) != 1:
        x2d = x2d.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x2d, scale, eps).reshape(shape)
    return rms_norm_fwd(x2d, scale, eps).reshape(shape)
