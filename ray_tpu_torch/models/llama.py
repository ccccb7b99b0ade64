"""Llama-family decoder-only transformer in PyTorch.

The port of ``ray_tpu/models/llama.py``: the same config presets, the same
parameter tree (per-layer weights stacked on a leading ``num_layers`` dim,
keyed as there), the same bf16 cast sites (weights at use, embedding table
before the gather, f32 rms_norm/rope statistics, f32 logits) and the same
remat policies. The layers run as a Python loop over the stacked weights in
place of ``lax.scan``.

``attention="flash"`` goes through ``flash_attention_gspmd`` (the CUDA
kernels on the card, GQA-native, on each rank's local shards when the
tensors are DTensors); ``"plain"`` through ``plain_attention`` with
repeated kv, as the reference does; ``"ring"`` through
``ring_attention_gspmd`` over the ``sp`` axis, and ``"ring_local"``
through ``ring_attention`` on local shards (inside ``local_map``).

Parameters placed on a mesh (``param_logical_axes`` through
``parallel.sharding.shard_params`` or ``create_train_state``) are
DTensors, and the forward then runs on DTensors. Where the reference
leaves the activations' layout to GSPMD's propagation, the port pins the
residual stream to ``RESIDUAL`` at the embedding and after each block,
and the attention's output before its projection, which keeps DTensor's
op-by-op propagation on layouts it handles. The sequence stays whole
outside the attention: DTensor cannot fold a sequence-split [B, L, E]
into the [B*L, E] operand of a matrix product and back, so ``sp`` splits
the ring's (and Ulysses') work, and every ``sp`` rank computes the
projections and the MLP of the whole sequence. Still to be ported: MoE
(and its logical axes), the manual ``tp_axis`` path of the pipeline, the
chunked-vocab loss and the KV-cache forward.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.flash_attention import (
    GSPMD_SPEC,
    flash_attention_gspmd,
)
from ray_tpu_torch.parallel.ring_attention import (
    plain_attention,
    ring_attention,
    ring_attention_gspmd,
    shard_attention,
)
from ray_tpu_torch.parallel.sharding import (
    constrain,
    logical_to_spec,
    placements,
)

ATTENTION = ("plain", "flash", "ring", "ring_local")
# The layout of the residual stream on a mesh (see the module docstring).
RESIDUAL = ("batch", None, "embed")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "full" recomputes the whole layer in backward; "dots" saves the
    # weight-activation matmul outputs and recomputes the rest, the flash
    # forward included.
    remat_policy: str = "full"
    # "plain" (full attention), "flash" (the flash kernels), "ring" (ring
    # attention over the sp axis) or "ring_local" (inside local_map).
    attention: str = "plain"

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            max_seq_len=8192, rope_theta=500000.0)

    @staticmethod
    def small_1b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """Test-size config."""
        return LlamaConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
            max_seq_len=128, remat=False)

    @property
    def num_params(self) -> int:
        e, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        h, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        per_layer = (e * h * d + 2 * e * kv * d + h * d * e  # attention
                     + 3 * e * m                             # swiglu
                     + 2 * e)                                # norms
        return v * e + self.num_layers * per_layer + e + e * v


# ---------------------------------------------------------------------- init


def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None) -> dict:
    """A parameter tree drawn from ``generator`` (which must live on
    ``device``): norms are ones, dense weights normal with std
    ``fan_in ** -0.5``, all float32, as the reference draws them."""
    device = resolve_device(device)
    e, m, v = config.hidden_size, config.intermediate_size, config.vocab_size
    h, kv, d = config.num_heads, config.num_kv_heads, config.head_dim
    n = config.num_layers

    def norm_init(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def dense_init(fan_in, *shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(fan_in ** -0.5)

    return {
        "embed": {"tokens": dense_init(e, v, e)},
        "layers": {
            "attn_norm": norm_init(n, e),
            "wq": dense_init(e, n, e, h, d),
            "wk": dense_init(e, n, e, kv, d),
            "wv": dense_init(e, n, e, kv, d),
            "wo": dense_init(h * d, n, h, d, e),
            "mlp_norm": norm_init(n, e),
            "w_gate": dense_init(e, n, e, m),
            "w_up": dense_init(e, n, e, m),
            "w_down": dense_init(m, n, m, e),
        },
        "final_norm": norm_init(e),
        "lm_head": dense_init(e, e, v),
    }


def param_logical_axes(config: LlamaConfig | None = None) -> dict:
    """Logical sharding axes per param (leading stacked-layer dim = None).

    tp → heads/mlp/vocab; fsdp → embed; norms replicated. Dense models
    only: the port has no MoE yet."""
    return {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": {
            "attn_norm": (None, "norm"),
            "wq": (None, "embed", "heads", None),
            "wk": (None, "embed", "kv_heads", None),
            "wv": (None, "embed", "kv_heads", None),
            "wo": (None, "heads", None, "embed"),
            "mlp_norm": (None, "norm"),
            "w_gate": (None, "embed", "mlp"),
            "w_up": (None, "embed", "mlp"),
            "w_down": (None, "mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


# ------------------------------------------------------------------- forward


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale).to(x.dtype)


def _replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A constant ``t`` as a replicated DTensor on ``like``'s mesh where
    ``like`` is a DTensor (DTensor ops take no plain tensor), else ``t``."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, L, H, D], positions: [B, L]."""
    d = x.shape[-1]
    exponent = -torch.arange(0, d // 2, dtype=torch.float32,
                             device=x.device) / (d // 2)
    freqs = _replicated(torch.pow(torch.tensor(
        theta, dtype=torch.float32, device=x.device), exponent), positions)
    angles = positions[..., None].float() * freqs  # [B, L, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [..., in] @ w [in, *out] cast to ``dtype`` at use → [..., *out]."""
    fan_in = x.shape[-1]
    out = x @ w.to(dtype).reshape(fan_in, -1)
    return out.view(*x.shape[:-1], *w.shape[1:])


def _attention_block(layer: dict, x: torch.Tensor, positions: torch.Tensor,
                     config: LlamaConfig) -> torch.Tensor:
    dtype = config.dtype
    h, kv, d = config.num_heads, config.num_kv_heads, config.head_dim
    normed = rms_norm(x, layer["attn_norm"], config.rms_norm_eps)
    q = rope(_proj(normed, layer["wq"], dtype), positions, config.rope_theta)
    k = rope(_proj(normed, layer["wk"], dtype), positions, config.rope_theta)
    v = _proj(normed, layer["wv"], dtype)
    if config.attention == "flash":
        # GQA-native: the kernels index the kv head of each query head.
        out = flash_attention_gspmd(q, k, v, causal=True)
    else:
        if kv != h:
            k = k.repeat_interleave(h // kv, dim=2)
            v = v.repeat_interleave(h // kv, dim=2)
        if config.attention == "ring":
            out = ring_attention_gspmd(q, k, v, causal=True)
        elif config.attention == "ring_local":
            # Already on local shards, inside local_map over a mesh with
            # an "sp" axis (the ambient mesh).
            out = ring_attention(q, k, v, axis_name="sp", causal=True)
        elif isinstance(q, DTensor):
            # The causal mask is a plain tensor: run on local shards.
            out = shard_attention(
                lambda q, k, v, mesh: plain_attention(q, k, v, causal=True),
                q, k, v, None, GSPMD_SPEC)
        else:
            out = plain_attention(q, k, v, causal=True)
    b, l = x.shape[:2]
    out = _pin(out, "batch", None, "heads", None)
    proj = out.reshape(b, l, h * d) @ layer["wo"].to(dtype).reshape(h * d, -1)
    return x + proj


def _mlp_block(layer: dict, x: torch.Tensor, config: LlamaConfig,
               norm=rms_norm) -> torch.Tensor:
    """``norm``: the RMSNorm to apply (the serving model passes the
    kernel's entry point, ``ray_tpu_torch.ops.rms_norm``)."""
    dtype = config.dtype
    normed = norm(x, layer["mlp_norm"], config.rms_norm_eps)
    gate = _proj(normed, layer["w_gate"], dtype)
    up = _proj(normed, layer["w_up"], dtype)
    hidden = torch.nn.functional.silu(gate) * up
    return x + _proj(hidden, layer["w_down"], dtype)


def _pin(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` in the layout of ``logical_axes`` (the residual stream's by
    default) on a DTensor's mesh; a plain tensor as it is."""
    if isinstance(x, DTensor):
        return constrain(x, x.device_mesh, *(logical_axes or RESIDUAL))
    return x


def _layer(layer: dict, x: torch.Tensor, positions: torch.Tensor,
           config: LlamaConfig) -> torch.Tensor:
    x = _pin(_attention_block(layer, x, positions, config))
    return _pin(_mlp_block(layer, x, config))


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the weight-activation matmul outputs (2-D
    ``mm``) and recompute everything else, the [L, L] attention products
    (batched ``bmm``) and the flash forward included."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXT = {
    "full": None,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_matmuls),
}


class _F32Logits(torch.autograd.Function):
    """bf16 operands, f32 accumulation and f32 output on CUDA, through
    ``torch.mm(..., out_dtype=torch.float32)``, which has no autograd
    formula of its own. The backward takes the gradient in the operands'
    dtype, as the reference's transposed products do."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.t(), x.t() @ g


def _lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Logits [..., V] in f32 from ``x`` and ``w`` in the compute dtype;
    never rounded through bf16. The CPU has no kernel for
    ``mm(out_dtype=)``, so there (and for f32 operands) both operands are
    upcast to f32 instead."""
    if x.is_cuda and x.dtype != torch.float32:
        if isinstance(x, DTensor):
            return _lm_head_local(x, w)
        out = _F32Logits.apply(x.reshape(-1, x.shape[-1]), w)
        return out.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _lm_head_local(x: DTensor, w: DTensor) -> DTensor:
    """``_F32Logits`` on local shards (DTensor has no rule for
    ``mm(out_dtype=)``): x split as the tokens (batch and sequence), w
    whole over the embedding and split over tp by vocab, the logits split
    as x and by vocab. x's gradient is then a partial sum over tp, w's
    over the axes that split the tokens."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    x_at = placements(mesh, logical_to_spec(("batch", "sequence", "embed")))
    w_at = placements(mesh, (None, "tp"))
    out_at = placements(mesh, logical_to_spec(("batch", "sequence",
                                               "vocab")))
    dx_at = [Partial() if a == "tp" else p for a, p in zip(names, x_at)]
    dw_at = [Partial() if a in ("dp", "fsdp", "sp") else p
             for a, p in zip(names, w_at)]

    def inner(x, w):
        out = _F32Logits.apply(x.reshape(-1, x.shape[-1]), w)
        return out.view(*x.shape[:-1], w.shape[-1])

    return local_map(inner, out_placements=out_at,
                     in_placements=(x_at, w_at),
                     in_grad_placements=(dx_at, dw_at), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def forward(params: dict, tokens: torch.Tensor, config: LlamaConfig,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B, L] → logits [B, L, V] f32, on the params' device.

    ``positions`` are the *global* token positions (RoPE and the causal
    mask under sequence parallelism need them where ``tokens`` is a local
    shard, as in ``"ring_local"``). With DTensor params the tokens and
    positions are placed as ``("batch", None)`` on their mesh (a plain
    tensor is taken as the global one) and the logits are a DTensor."""
    if config.attention not in ATTENTION:
        raise ValueError(f"attention={config.attention!r}: expected one of "
                         f"{ATTENTION}")
    if config.remat and config.remat_policy not in _REMAT_CONTEXT:
        raise ValueError(f"remat_policy={config.remat_policy!r}: expected "
                         f"'full' or 'dots'")
    b, l = tokens.shape
    if positions is None:
        positions = torch.arange(l, device=tokens.device).expand(b, l)
    # The reference's gather table[tokens], as an embedding lookup: on
    # DTensors, from the whole table (DTensor's rules for index_put,
    # indexing's backward, and for a gather from a vocab-split table, a
    # masked partial sum, do not hold in every release; its rules for an
    # embedding from a replicated table do), and the same op without a
    # mesh, so that both paths sum the table's gradient in one order.
    table = params["embed"]["tokens"].to(config.dtype)
    if isinstance(table, DTensor):
        mesh = table.device_mesh
        tokens = constrain(tokens, mesh, "batch", None)
        positions = constrain(positions.contiguous(), mesh, "batch", None)
        table = constrain(table, mesh, None, None)
    x = _pin(torch.nn.functional.embedding(tokens, table))
    # unbind, not indexing: its backward stacks the per-layer grads once
    # instead of adding a full-size zero tensor per layer.
    names = sorted(params["layers"])
    stacked = [params["layers"][name].unbind(0) for name in names]
    for weights in zip(*stacked):
        layer = dict(zip(names, weights))
        if config.remat:
            context = _REMAT_CONTEXT[config.remat_policy]
            kwargs = {"context_fn": context} if context else {}
            x = checkpoint(_layer, layer, x, positions, config,
                           use_reentrant=False, **kwargs)
        else:
            x = _layer(layer, x, positions, config)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return _lm_head(x, params["lm_head"].to(config.dtype))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE as logsumexp(logits) - logits[target].

    DTensor logits are first gathered over the vocab (DTensor's
    vocab-split gather leaves a masked partial sum that its later ops
    mishandle), with the targets placed as the tokens."""
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        logits = constrain(logits, mesh, "batch", "sequence", None)
        targets = constrain(targets, mesh, "batch", "sequence")
        if mask is not None:
            mask = constrain(mask, mesh, "batch", "sequence")
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - picked
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            config: LlamaConfig, positions: torch.Tensor | None = None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy (targets already shifted)."""
    return cross_entropy(forward(params, tokens, config, positions), targets,
                         mask)


def flops_per_token(config: LlamaConfig, seq_len: int | None = None) -> float:
    """6 * params (fwd+bwd) + the attention term: the reference's MFU
    accounting."""
    seq = seq_len if seq_len is not None else config.max_seq_len
    attn_flops = (12 * config.num_layers * config.num_heads
                  * config.head_dim * seq)
    return 6.0 * config.num_params + attn_flops
