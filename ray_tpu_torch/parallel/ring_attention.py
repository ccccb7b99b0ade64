"""Attention over the sequence. So far only ``plain_attention``, the
correctness oracle and the ``attention="plain"`` path of the model; ring
and Ulysses attention are still to be ported."""

from __future__ import annotations

import torch


def plain_attention(q, k, v, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Reference full attention over [B, L, H, D] (the correctness oracle)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
