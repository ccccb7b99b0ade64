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
projections and the MLP of the whole sequence.

``num_experts > 0`` replaces the dense SwiGLU MLP with the top-1 routed
expert layer of ``models/moe.py`` and adds its load-balancing loss to
``loss_fn``. ``tp_axis`` is the reference's manual Megatron path, for
blocks that run on local shards inside ``local_map`` (the pipeline's
stages): heads and the MLP split over the axis's group, an all-reduce of
the output projections (identity in the backward) and of the replicated
input's gradient (identity in the forward). ``ce_chunk > 0`` computes the
loss over sequence chunks without forming the [B, L, V] logits. Still to
be ported: the KV-cache forward.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.moe import (
    init_moe_params,
    moe_logical_axes,
    moe_mlp,
)
from ray_tpu_torch.ops.flash_attention import (
    GSPMD_SPEC,
    flash_attention,
    flash_attention_gspmd,
)
from ray_tpu_torch.parallel.mesh import ambient_mesh
from ray_tpu_torch.parallel.ring_attention import (
    axis_group,
    plain_attention,
    ring_attention,
    ring_attention_gspmd,
    shard_attention,
)
from ray_tpu_torch.parallel.sharding import (
    constrain,
    logical_to_spec,
    partial_over,
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
    # Chunked-vocab loss: >0 computes the training CE over sequence
    # chunks of this many tokens, so the [B, L, V] f32 logits are never
    # formed (~2.1 GB at [8, 2048, 32000]); each chunk's logits are
    # recomputed in the backward. 0 = the full-logits path.
    ce_chunk: int = 0
    # Mixture-of-Experts: >0 replaces the dense SwiGLU MLP with a top-1
    # routed expert layer (experts placed over the ep mesh axis).
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01

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

    def _param_count(self, experts_counted: int) -> int:
        e, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        h, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        if self.num_experts > 0:
            mlp = e * self.num_experts + 3 * e * m * experts_counted
        else:
            mlp = 3 * e * m  # dense swiglu
        per_layer = (e * h * d + 2 * e * kv * d + h * d * e  # attention
                     + mlp
                     + 2 * e)  # norms
        return v * e + self.num_layers * per_layer + e + e * v

    @property
    def num_params(self) -> int:
        return self._param_count(max(self.num_experts, 1))

    @property
    def num_active_params(self) -> int:
        """Params touched per token: top-1 routing activates one expert,
        so the MFU counts these, not every expert."""
        return self._param_count(1)


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

    embed = dense_init(e, v, e)
    layers = {
        "attn_norm": norm_init(n, e),
        "wq": dense_init(e, n, e, h, d),
        "wk": dense_init(e, n, e, kv, d),
        "wv": dense_init(e, n, e, kv, d),
        "wo": dense_init(h * d, n, h, d, e),
        "mlp_norm": norm_init(n, e),
    }
    if config.num_experts > 0:
        layers.update(init_moe_params(generator, e, m, config.num_experts, n,
                                      device))
    else:
        layers.update({
            "w_gate": dense_init(e, n, e, m),
            "w_up": dense_init(e, n, e, m),
            "w_down": dense_init(m, n, m, e),
        })
    return {
        "embed": {"tokens": embed},
        "layers": layers,
        "final_norm": norm_init(e),
        "lm_head": dense_init(e, e, v),
    }


def param_logical_axes(config: LlamaConfig | None = None) -> dict:
    """Logical sharding axes per param (leading stacked-layer dim = None).

    tp → heads/mlp/vocab; fsdp → embed; ep → experts; norms replicated.
    """
    layers = {
        "attn_norm": (None, "norm"),
        "wq": (None, "embed", "heads", None),
        "wk": (None, "embed", "kv_heads", None),
        "wv": (None, "embed", "kv_heads", None),
        "wo": (None, "heads", None, "embed"),
        "mlp_norm": (None, "norm"),
    }
    if config is not None and config.num_experts > 0:
        layers.update(moe_logical_axes())
    else:
        layers.update({
            "w_gate": (None, "embed", "mlp"),
            "w_up": (None, "embed", "mlp"),
            "w_down": (None, "mlp", "embed"),
        })
    return {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": layers,
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


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient over
    ``group`` in the backward (the replicated input of column-parallel
    products, each rank's gradient a partial sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward over ``group`` (the partial sums
    of row-parallel products), identity backward: every rank's partial
    sum gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_group(tp_axis: str | None):
    """(group, size) of ``tp_axis`` on the ambient mesh: (None, 1) for no
    axis, or one the mesh does not have (size 1)."""
    if tp_axis is None:
        return None, 1
    group, size, _ = axis_group(ambient_mesh(), tp_axis)
    return group, size


def _attention_block(layer: dict, x: torch.Tensor, positions: torch.Tensor,
                     config: LlamaConfig,
                     tp_axis: str | None = None) -> torch.Tensor:
    """``tp_axis``: Megatron-style manual tensor parallelism for use on
    local shards inside ``local_map`` (the pipelined path; elsewhere the
    DTensor placements carry tp): q/k/v/o arrive head-split over the
    axis's group, and the output projection's partial sums are summed
    over it."""
    dtype = config.dtype
    h, kv, d = config.num_heads, config.num_kv_heads, config.head_dim
    group, tp = _tp_group(tp_axis)
    h, kv = h // tp, kv // tp
    normed = rms_norm(x, layer["attn_norm"], config.rms_norm_eps)
    if tp > 1:
        normed = _CopyToGroup.apply(normed, group)
    q = rope(_proj(normed, layer["wq"], dtype), positions, config.rope_theta)
    k = rope(_proj(normed, layer["wk"], dtype), positions, config.rope_theta)
    v = _proj(normed, layer["wv"], dtype)
    if config.attention == "flash":
        # GQA-native: the kernels index the kv head of each query head.
        # With tp_axis the tensors are local shards already: the kernels
        # take them directly.
        if tp_axis is not None:
            out = flash_attention(q, k, v, causal=True)
        else:
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
    if tp > 1:
        proj = _SumOverGroup.apply(proj, group)  # partial sums over heads
    return x + proj


def _mlp_block(layer: dict, x: torch.Tensor, config: LlamaConfig,
               norm=rms_norm, tp_axis: str | None = None) -> torch.Tensor:
    """``norm``: the RMSNorm to apply (the serving model passes the
    kernel's entry point, ``ray_tpu_torch.ops.rms_norm``). ``tp_axis``:
    as in ``_attention_block``, the MLP columns split over its group."""
    dtype = config.dtype
    group, tp = _tp_group(tp_axis)
    normed = norm(x, layer["mlp_norm"], config.rms_norm_eps)
    if tp > 1:
        normed = _CopyToGroup.apply(normed, group)
    gate = _proj(normed, layer["w_gate"], dtype)
    up = _proj(normed, layer["w_up"], dtype)
    hidden = torch.nn.functional.silu(gate) * up
    proj = _proj(hidden, layer["w_down"], dtype)
    if tp > 1:
        proj = _SumOverGroup.apply(proj, group)  # partial sums over mlp
    return x + proj


def _moe_block(layer: dict, x: torch.Tensor,
               config: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    normed = rms_norm(x, layer["mlp_norm"], config.rms_norm_eps)
    out, aux = moe_mlp(
        layer, normed, capacity_factor=config.expert_capacity_factor,
        dtype=config.dtype)
    return x + out, aux


def _pin(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` in the layout of ``logical_axes`` (the residual stream's by
    default) on a DTensor's mesh; a plain tensor as it is."""
    if isinstance(x, DTensor):
        return constrain(x, x.device_mesh, *(logical_axes or RESIDUAL))
    return x


def _layer(layer: dict, x: torch.Tensor, positions: torch.Tensor,
           config: LlamaConfig, tp_axis: str | None = None):
    """One layer: the residual stream out, and with MoE the layer's aux
    loss beside it. ``tp_axis``: the manual tp path (dense blocks)."""
    x = _pin(_attention_block(layer, x, positions, config, tp_axis))
    if config.num_experts > 0:
        x, aux = _moe_block(layer, x, config)
        return _pin(x), aux
    return _pin(_mlp_block(layer, x, config, tp_axis=tp_axis))


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
    x_at = placements(mesh, logical_to_spec(("batch", "sequence", "embed")))
    w_at = placements(mesh, (None, "tp"))
    out_at = placements(mesh, logical_to_spec(("batch", "sequence",
                                               "vocab")))
    dx_at = partial_over(mesh, x_at, ("tp",))
    dw_at = partial_over(mesh, w_at, ("dp", "fsdp", "sp"))

    def inner(x, w):
        out = _F32Logits.apply(x.reshape(-1, x.shape[-1]), w)
        return out.view(*x.shape[:-1], w.shape[-1])

    return local_map(inner, out_placements=out_at,
                     in_placements=(x_at, w_at),
                     in_grad_placements=(dx_at, dw_at), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def _embed(params: dict, tokens: torch.Tensor, positions: torch.Tensor | None,
           config: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual stream's input [B, L, E] in the compute dtype, and
    the positions (contiguous when None); both placed as the tokens on
    the mesh of DTensor params."""
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
    return _pin(torch.nn.functional.embedding(tokens, table)), positions


def _check_config(config: LlamaConfig) -> None:
    if config.attention not in ATTENTION:
        raise ValueError(f"attention={config.attention!r}: expected one of "
                         f"{ATTENTION}")
    if config.remat and config.remat_policy not in _REMAT_CONTEXT:
        raise ValueError(f"remat_policy={config.remat_policy!r}: expected "
                         f"'full' or 'dots'")


def forward(params: dict, tokens: torch.Tensor, config: LlamaConfig,
            positions: torch.Tensor | None = None, with_aux: bool = False,
            return_features: bool = False):
    """tokens [B, L] → logits [B, L, V] f32, on the params' device.

    ``positions`` are the *global* token positions (RoPE and the causal
    mask under sequence parallelism need them where ``tokens`` is a local
    shard, as in ``"ring_local"``). With DTensor params the tokens and
    positions are placed as ``("batch", None)`` on their mesh (a plain
    tensor is taken as the global one) and the logits are a DTensor.
    ``with_aux=True`` also returns the summed MoE load-balancing loss
    (0.0 for dense configs). ``return_features=True`` returns the
    final-norm hidden states instead of the logits (the chunked loss
    applies the lm head itself, chunk by chunk)."""
    _check_config(config)
    x, positions = _embed(params, tokens, positions, config)
    moe = config.num_experts > 0
    aux_sum = _replicated(torch.zeros((), dtype=torch.float32,
                                      device=x.device), x)
    # unbind, not indexing: its backward stacks the per-layer grads once
    # instead of adding a full-size zero tensor per layer.
    names = sorted(params["layers"])
    stacked = [params["layers"][name].unbind(0) for name in names]
    for weights in zip(*stacked):
        layer = dict(zip(names, weights))
        if config.remat:
            context = _REMAT_CONTEXT[config.remat_policy]
            kwargs = {"context_fn": context} if context else {}
            out = checkpoint(_layer, layer, x, positions, config,
                             use_reentrant=False, **kwargs)
        else:
            out = _layer(layer, x, positions, config)
        if moe:
            x, aux = out
            aux_sum = aux_sum + aux
        else:
            x = out
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    if return_features:
        return (x, aux_sum) if with_aux else x
    logits = _lm_head(x, params["lm_head"].to(config.dtype))
    return (logits, aux_sum) if with_aux else logits


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token logsumexp(logits) - logits[target].

    DTensor logits are first gathered over the vocab (DTensor's
    vocab-split gather leaves a masked partial sum that its later ops
    mishandle), with the targets placed as the tokens."""
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        logits = constrain(logits, mesh, "batch", "sequence", None)
        targets = constrain(targets, mesh, "batch", "sequence")
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return lse - picked


def _mean_nll(nll: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.mean(nll)
    if isinstance(nll, DTensor):
        mask = constrain(mask, nll.device_mesh, "batch", "sequence")
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE as logsumexp(logits) - logits[target]."""
    return _mean_nll(_nll(logits, targets), mask)


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            config: LlamaConfig, positions: torch.Tensor | None = None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy (targets already shifted). With
    ``config.ce_chunk > 0`` the logits stay chunk-sized
    (``_chunked_nll``). MoE configs add the router load-balancing loss
    scaled by ``moe_aux_loss_coef``."""
    if config.ce_chunk > 0 and tokens.shape[1] % config.ce_chunk != 0:
        # Falling back would form the very logits that chunking avoids.
        raise ValueError(
            f"ce_chunk={config.ce_chunk} must divide the sequence "
            f"length {tokens.shape[1]}")
    if config.ce_chunk > 0:
        x, aux = forward(params, tokens, config, positions, with_aux=True,
                         return_features=True)
        ce = _mean_nll(_chunked_nll(x, params["lm_head"], targets, config),
                       mask)
    else:
        logits, aux = forward(params, tokens, config, positions,
                              with_aux=True)
        ce = cross_entropy(logits, targets, mask)
    if config.num_experts > 0:
        return ce + config.moe_aux_loss_coef * aux
    return ce


def _chunk_nll(x: torch.Tensor, w: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    return _nll(_lm_head(x, w), targets)


def _chunked_nll(x: torch.Tensor, lm_head: torch.Tensor,
                 targets: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Per-token NLL [B, L] from final-norm features without forming the
    full [B, L, V] logits: one [B, chunk, V] f32 block at a time, each
    under ``checkpoint``, which keeps only its inputs and recomputes the
    block in the backward."""
    chunk = config.ce_chunk
    w = lm_head.to(config.dtype)
    nll = [checkpoint(_chunk_nll, x[:, i:i + chunk], w,
                      targets[:, i:i + chunk], use_reentrant=False)
           for i in range(0, x.shape[1], chunk)]
    return torch.cat(nll, dim=1)


def flops_per_token(config: LlamaConfig, seq_len: int | None = None) -> float:
    """6 * active params (fwd+bwd) + the attention term: the reference's
    MFU accounting. ``num_active_params``, so a top-1 MoE does not count
    the experts a token never touches."""
    seq = seq_len if seq_len is not None else config.max_seq_len
    attn_flops = (12 * config.num_layers * config.num_heads
                  * config.head_dim * seq)
    return 6.0 * config.num_active_params + attn_flops
