"""Paged-attention prefill and decode steps over the paged KV pool.

The port of ``ray_tpu/serve/llm_engine/model.py``; it computes what the
reference computes, in PyTorch ops:

- **scatter**: each new token's k/v lands at
  ``pool[block_table[pos // bs], pos % bs]``, an in-place ``index_put_``
  on the pool tensors of its layer (in place of the reference's donated
  ``.at[blocks, offsets].set``); rows past ``n_valid`` go to scratch
  block 0;
- **gather**: attention keys/values come from ``pool[block_tables]``,
  reshaped to the flat ``[B, S, kv, d]`` view where flat index ``s`` is
  the token's global position (tables are append-ordered), so the causal
  mask ``s <= position`` is the dense path's; kv heads are repeated for
  GQA; scores are f32, masked at -1e30 (finite, so the all-scratch rows of
  inactive batch slots stay finite), and the softmax is cast to the
  compute dtype before p.V;
- **norms**: all three (attention, MLP, final) go through
  ``ray_tpu_torch.ops.rms_norm``, the RMSNorm kernel on the card, which is
  the port of ``ray_tpu.ops.rms_norm`` (the same function as the
  reference engine's ``llama.rms_norm``);
- **fixed shapes**: batch ``B``, table width ``M`` and chunk length ``C``
  do not change from call to call, as in the reference's one decode and
  one prefill program.

Attention itself is plain PyTorch, as the reference's is plain ``jnp``:
the JAX package has no kernel on this path other than the norm.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import rms_norm


def _paged_attention_block(layer: dict, x: torch.Tensor,
                           positions: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, block_tables: torch.Tensor,
                           config, block_size: int,
                           n_valid: "int | None" = None) -> torch.Tensor:
    """One attention block over one layer's pool ``pk``/``pv``
    ``[num_blocks, bs, kv, d]``, which it updates in place.

    x: [B, T, E] new-token activations at global ``positions`` [B, T]
    (T=1 decode, T=chunk prefill). block_tables: [B, M] (append-ordered
    block ids, 0-padded). ``n_valid``: positions at or after it scatter to
    the scratch block instead of the table (prefill chunk padding).
    Returns x plus the block's output."""
    dtype = config.dtype
    h, kv_heads, d = config.num_heads, config.num_kv_heads, config.head_dim
    normed = rms_norm(x, layer["attn_norm"], config.rms_norm_eps)
    q = llama.rope(llama._proj(normed, layer["wq"], dtype), positions,
                   config.rope_theta)
    k = llama.rope(llama._proj(normed, layer["wk"], dtype), positions,
                   config.rope_theta)
    v = llama._proj(normed, layer["wv"], dtype)

    # Scatter: the token at global position p writes block_table[p // bs]
    # at offset p % bs; padding and inactive rows go to scratch block 0.
    blocks = torch.gather(block_tables, 1,
                          (positions // block_size).long())  # [B, T]
    offsets = positions % block_size
    if n_valid is not None:
        in_range = (torch.arange(positions.shape[1], device=x.device)[None, :]
                    < n_valid)
        blocks = torch.where(in_range, blocks, 0)
        offsets = torch.where(in_range, offsets, 0)
    pk.index_put_((blocks, offsets), k.to(pk.dtype))
    pv.index_put_((blocks, offsets), v.to(pv.dtype))

    # Gather: the request's whole context by block table; flat index s is
    # the global position.
    b, m = block_tables.shape
    s_len = m * block_size
    keys = pk[block_tables].reshape(b, s_len, kv_heads, d)
    values = pv[block_tables].reshape(b, s_len, kv_heads, d)
    if kv_heads != h:
        keys = keys.repeat_interleave(h // kv_heads, dim=2)
        values = values.repeat_interleave(h // kv_heads, dim=2)

    scores = torch.einsum("bthd,bshd->bhts", q.float(), keys.float())
    scores = scores * d ** -0.5
    s_pos = torch.arange(s_len, device=x.device)
    mask = s_pos[None, None, None, :] <= positions[:, None, :, None]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, values.to(dtype))
    out = out.reshape(b, -1, h * d) @ layer["wo"].to(dtype).reshape(h * d, -1)
    return x + out


@torch.no_grad()
def _forward_paged(params: dict, pool: dict, tokens: torch.Tensor,
                   positions: torch.Tensor, block_tables: torch.Tensor,
                   config, block_size: int,
                   n_valid: "int | None" = None):
    """Shared prefill/decode forward over the paged pool, which it updates
    in place. Returns (logits [B, T, V] f32, pool)."""
    x = params["embed"]["tokens"].to(config.dtype)[tokens]
    names = sorted(params["layers"])
    stacked = [params["layers"][name].unbind(0) for name in names]
    for i, weights in enumerate(zip(*stacked)):
        layer = dict(zip(names, weights))
        x = _paged_attention_block(layer, x, positions, pool["k"][i],
                                   pool["v"][i], block_tables, config,
                                   block_size, n_valid=n_valid)
        x = llama._mlp_block(layer, x, config, norm=rms_norm)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    logits = llama._lm_head(x, params["lm_head"].to(config.dtype))
    return logits, pool


def sample(logits: torch.Tensor, temps: torch.Tensor,
           generator: torch.Generator) -> torch.Tensor:
    """Next tokens [B] int32 from logits [B, V]: argmax where the
    temperature is 0, else a categorical draw over
    ``logits / max(t, 1e-4)`` (Gumbel-max with noise from ``generator``,
    which lives on the logits' device)."""
    greedy = torch.argmax(logits, dim=-1)
    uniform = torch.rand(logits.shape, generator=generator,
                         device=logits.device).clamp_(min=1e-20)
    gumbel = -torch.log(-torch.log(uniform))
    scaled = logits / torch.clamp(temps, min=1e-4)[:, None]
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def make_decode_step(config, block_size: int):
    """The one batched decode step: every active ragged request advances
    one token through a shared ``[B, 1]`` step. Inactive rows carry
    all-zero tables and positions (scratch writes, discarded samples)."""

    def decode_step(params, pool, tokens, positions, block_tables,
                    generator, temps):
        # tokens [B, 1]; positions [B]; block_tables [B, M]; temps [B].
        logits, pool = _forward_paged(
            params, pool, tokens, positions[:, None], block_tables, config,
            block_size)
        return sample(logits[:, -1, :], temps, generator), pool

    return decode_step


def make_prefill_chunk(config, block_size: int):
    """The one prefill step: a fixed-length chunk of one request's prompt
    scatters into its block table; only the final chunk's ``last_idx``
    logits row is consumed (the first generated token)."""

    def prefill_chunk(params, pool, tokens, positions, block_table, n_valid,
                      last_idx):
        # tokens [1, C]; positions [1, C]; block_table [1, M]; n_valid and
        # last_idx ints (chunk padding past n_valid goes to scratch;
        # last_idx indexes the final real token's logits).
        logits, pool = _forward_paged(
            params, pool, tokens, positions, block_table, config,
            block_size, n_valid=n_valid)
        return logits[0, last_idx, :], pool

    return prefill_chunk
