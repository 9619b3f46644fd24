"""Logit warping and token sampling (counterpart of the sampling functions
of midgpt_tpu/sampling/engine.py; the contiguous-cache `generate` loop is
still to be ported, ROADMAP.md).

torch's generators are not JAX's keys: a seed gives a different stream, so
stochastic sampling matches the JAX package in distribution only. Greedy
(temperature 0) is the first-index argmax in both, token for token.
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor


def warp_logits(
    logits: Tensor,  # (..., V) float32
    temperature: float,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
) -> Tensor:
    """Temperature scaling + top-k / nucleus filtering on f32 logits. The
    warped logits DEFINE the sampling distribution. Requires temperature > 0."""
    logits = logits / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        # nucleus: keep the smallest prefix of descending-prob tokens whose
        # cumulative mass reaches top_p (the first token is always kept —
        # its exclusive prefix mass is 0)
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        exclusive_cum = torch.cumsum(probs, dim=-1) - probs
        keep = exclusive_cum < top_p
        threshold = torch.where(keep, sorted_desc, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, float("-inf"), logits)
    return logits


def sample_logits(
    logits: Tensor,  # (B, V) float
    temperature: float = 1.0,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
    generator: tp.Optional[torch.Generator] = None,
) -> Tensor:
    """Temperature + optional top-k / nucleus sampling; 0 = greedy (the
    first index of the maximum). Returns (B,) int64."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
