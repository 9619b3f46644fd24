"""Normalization ops (counterpart of midgpt_tpu/ops/norms.py).

  * `rms_norm` — weightless unless `weight` is given; eps 1e-6 in the
    blocks, 1e-5 for the final norm (the caller passes it). Reduction in
    the input dtype, like the reference.
  * `head_layer_norm` — QK-LayerNorm over the head dim: mean-centred, with
    a learned scale and no bias, eps 1e-6.
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor


def rms_norm(x: Tensor, weight: tp.Optional[Tensor] = None, eps: float = 1e-6) -> Tensor:
    """RMS-normalize over the trailing axis. Weightless unless `weight` given."""
    out = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight
    return out


def head_layer_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """LayerNorm over the trailing (head) axis with scale, no bias."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    centered = x - mean
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps) * weight
