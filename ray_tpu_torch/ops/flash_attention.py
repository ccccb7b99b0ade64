"""Flash attention over [B, L, H, D]: CUDA kernels for Hopper, fwd + bwd.

The port of ``ray_tpu/ops/flash_attention.py``. Three kernels, in
``csrc/flash_attention.cu``, replace its three Pallas kernels:

- ``fwd``: ``_fwd_kernel`` — output and per-row logsumexp (online softmax);
- ``bwd_dq``: ``_bwd_dq_kernel`` — dq for one q tile, looping over k tiles;
- ``bwd_dkv``: ``_bwd_dkv_kernel`` — dk and dv for one k tile of one kv
  head, looping over the query heads of its group and over q tiles.

Beside each kernel is its plain PyTorch version (``flash_fwd_plain``,
``flash_bwd_plain``), which computes the same function with the same
roundings. A CPU tensor goes to the plain version; a CUDA tensor goes to
the kernel or the call raises. ``launches`` counts each kernel's launches.

GQA is native: query head ``h`` reads kv head ``h // (H // KVH)``, and no
repeated kv tensor is built, in the kernels or in the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

# Launches of each kernel in this process. Only the kernel wrappers below
# add to these, one for each launch.
launches = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

_BWD_KIND = {"bwd_dq": 1, "bwd_dkv": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if lib.rtt_flash_fwd.argtypes is None:
        lib.rtt_flash_fwd.argtypes = ([_P] * 5 + [_I] * 6 + [ctypes.c_float]
                                      + [_LL] * 9 + [_P])
        lib.rtt_flash_fwd.restype = _I
        lib.rtt_flash_bwd.argtypes = ([_I] + [_P] * 9 + [_I] * 6
                                      + [ctypes.c_float] + [_LL] * 15 + [_P])
        lib.rtt_flash_bwd.restype = _I
        lib.rtt_flash_smem_bytes.argtypes = [_I, _I]
        lib.rtt_flash_smem_bytes.restype = _LL
    return lib


# ------------------------------------------------------------ plain versions


def _scores(q, k, causal):
    """f32 scores [B, KVH, R, Lq, Lk] with the scale applied to the f32
    product, masked with NEG_INF; q is read as [B, L, KVH, R, D]."""
    b, l, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, l, kvh, h // kvh, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * d ** -0.5
    if causal:
        pos = torch.arange(l, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool = True):
    """Plain PyTorch version of the ``fwd`` kernel.

    q [B, L, H, D], k/v [B, L, KVH, D] → (o [B, L, H, D] in q's dtype,
    lse [B, H, L] f32). p is rounded to v's dtype before p·V, as the
    kernel does."""
    b, l, h, d = q.shape
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype).float(), v.float())
    o = (o / l_safe).permute(0, 3, 1, 2, 4).reshape(b, l, h, d)
    lse = (m + torch.log(l_safe)).reshape(b, h, l)
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool = True):
    """Plain PyTorch version of the ``bwd_dq`` and ``bwd_dkv`` kernels.

    Returns (dq [B, L, H, D], dk, dv [B, L, KVH, D]); dk and dv sum over
    the query heads of each kv group. p and ds are rounded to the input
    dtype before the products, as the kernels do."""
    b, l, h, d = q.shape
    kvh = k.shape[2]
    r = h // kvh
    scale = d ** -0.5
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.reshape(b, kvh, r, l, 1))
    dog = do.reshape(b, l, kvh, r, d).float()
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    delta = (dog * o.reshape(b, l, kvh, r, d).float()).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p.to(do.dtype).float(), dog)
    qg = q.reshape(b, l, kvh, r, d).float()
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds.to(q.dtype).float(), qg) * scale
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds.to(k.dtype).float(), k.float())
    dq = (dq * scale).reshape(b, l, h, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------- kernel wrappers


def _check_view(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} is {t.dtype}; the CUDA kernels take bfloat16")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    # 16-byte vector loads: contiguous head dim, strides and base aligned.
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a contiguous head dim, strides that are multiples "
            f"of 8 and a 16-byte aligned base (strides {t.stride()})")


def _check_inputs(q, k, v) -> tuple[int, int, int, int, int]:
    if not q.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, L, H, D], got shape {tuple(q.shape)}")
    b, l, h, d = q.shape
    kvh = k.shape[2] if k.dim() == 4 else -1
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the CUDA kernels "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")
    if l < 1 or kvh < 1 or h % kvh:
        raise ValueError(f"need L >= 1 and H % KVH == 0 (q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)})")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the grid's 65535 rows")
    _check_view("q", q, (b, l, h, d), q.device)
    _check_view("k", k, (b, l, kvh, d), q.device)
    _check_view("v", v, (b, l, kvh, d), q.device)
    return b, l, h, kvh, d


def _strides(t: torch.Tensor) -> list[int]:
    return list(t.stride()[:3])


def flash_fwd_kernel(q, k, v, causal: bool = True):
    """Launch the ``fwd`` kernel: (o [B, L, H, D] bf16, lse [B, H, L] f32)."""
    b, l, h, kvh, d = _check_inputs(q, k, v)
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, l, h, kvh, d, int(causal), d ** -0.5,
            *_strides(q), *_strides(k), *_strides(v), stream)
    _build.check(lib, err, "flash fwd kernel")
    launches["fwd"] += 1
    return o, lse


def _bwd_kernel(kind, q, k, v, o, lse, do, causal):
    b, l, h, kvh, d = _check_inputs(q, k, v)
    _check_view("o", o, (b, l, h, d), q.device)
    _check_view("do", do, (b, l, h, d), q.device)
    if lse.device != q.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (b, h, l) or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous [B, H, L] float32 tensor "
                         "on q's device")
    if kind == "bwd_dq":
        outs = (torch.empty((b, l, h, d), dtype=q.dtype, device=q.device),)
        ptrs = (outs[0].data_ptr(), None, None)
    else:
        outs = tuple(torch.empty((b, l, kvh, d), dtype=q.dtype,
                                 device=q.device) for _ in range(2))
        ptrs = (None, outs[0].data_ptr(), outs[1].data_ptr())
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_bwd(
            _BWD_KIND[kind], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), *ptrs,
            b, l, h, kvh, d, int(causal), d ** -0.5,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            *_strides(do), stream)
    _build.check(lib, err, f"flash {kind} kernel")
    launches[kind] += 1
    return outs


def flash_bwd_dq_kernel(q, k, v, o, lse, do, causal: bool = True):
    """Launch the ``bwd_dq`` kernel: dq [B, L, H, D] bf16."""
    return _bwd_kernel("bwd_dq", q, k, v, o, lse, do, causal)[0]


def flash_bwd_dkv_kernel(q, k, v, o, lse, do, causal: bool = True):
    """Launch the ``bwd_dkv`` kernel: (dk, dv) [B, L, KVH, D] bf16."""
    return _bwd_kernel("bwd_dkv", q, k, v, o, lse, do, causal)


def smem_bytes(kind: str, head_dim: int) -> int:
    """Dynamic shared memory one block of a kernel uses (builds the
    library if needed)."""
    return _lib().rtt_flash_smem_bytes(
        {"fwd": 0, **_BWD_KIND}[kind], head_dim)


# ------------------------------------------------------------------ dispatch


def flash_fwd(q, k, v, causal: bool = True):
    """(o, lse): the plain version for CPU tensors, else the kernel."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    return flash_fwd_kernel(q, k, v, causal)


def flash_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv): the plain version for CPU tensors, else the kernels."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal)
    dq = flash_bwd_dq_kernel(q, k, v, o, lse, do, causal)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, o, lse, do, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: saves (q, k, v, o, lse) and
    recomputes p from lse, as the TPU kernels' custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The incoming gradient's layout is autograd's choice; the kernels
        # take a contiguous head dim.
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512):
    """Flash attention over [B, L, H, D] q and [B, L, KVH, D] k/v.

    The signature and layout of ``ray_tpu.ops.flash_attention``.
    ``block_q``/``block_k`` are accepted for that parity and must be
    positive; the CUDA kernels use fixed 64-row tiles and mask the ragged
    tail, and the plain version does not tile."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")
    return FlashAttention.apply(q, k, v, causal)
