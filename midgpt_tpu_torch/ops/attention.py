"""Attention masks and the dense causal attention of `GPT.apply`
(counterpart of midgpt_tpu/ops/attention.py).

Numerics of `naive_causal_attention` follow the reference: scores in the
compute dtype, -inf below the diagonal, softmax of `scores.f32 / sqrt(C)`
in float32, probabilities cast back for the PV product. The blockwise and
flash training paths arrive with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def visible_mask(
    col: Tensor,
    counts: Tensor,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """The visibility rule every attention path shares (broadcasting bool):
    a row with `counts` visible keys keeps column `col` iff col < counts
    and — under a sliding window — col is within the last `sliding_window`
    of them or inside the `attn_sinks` prefix."""
    keep = col < counts
    if sliding_window:
        w = col >= counts - sliding_window
        if attn_sinks:
            w = w | (col < attn_sinks)
        keep = keep & w
    return keep


def naive_causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Materialized-scores causal attention, f32 softmax, no dropout.
    (B, T, H, C) -> (B, T, H, C) — the sequence-major layout the fused
    projection produces."""
    T, C = q.shape[1], q.shape[-1]
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    mask = visible_mask(cols, rows + 1)
    scores = torch.einsum("bqhc,bkhc->bhqk", q, k)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores.float() / math.sqrt(C), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhc->bqhc", probs, v)
