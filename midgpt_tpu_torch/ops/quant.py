"""Symmetric int8 quantization for the paged KV cache (counterpart of
midgpt_tpu/ops/quant.py).

An int8 pool stores each written K/V vector (one head, one position) as
int8 codes over head_dim plus one f32 absmax scale:

    scale = max(|x|) / 127        (over the last axis)
    q     = clip(round(x / scale), -127, 127)  as int8
    x~    = q * scale             (dequantization)

`round` is half-to-even, as jnp.round, so the codes equal the JAX
package's bit for bit. An all-zero vector stores scale 0 and codes 0, so it
dequantizes to exact zeros. -128 is never produced: |x~ - x| <= scale / 2.
Every reader that dequantizes the same (q, scale) pair — the CUDA kernel,
the gather lowering, a test — computes the same f32 product, so all see
identical values.
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor

# 127, not 128: a symmetric code space, so dequantization never overshoots
# the recorded absmax.
Q8_MAX = 127.0


def quantize_q8(x: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Quantize over the LAST axis: x (..., C) -> (q int8 (..., C), scale
    f32 (...)), rounding to nearest (ties to even)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / Q8_MAX
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))  # all-zero vector -> q = 0
    q = torch.clamp(torch.round(xf / safe[..., None]), -Q8_MAX, Q8_MAX).to(torch.int8)
    return q, scale


def dequantize_q8(q: Tensor, scale: Tensor) -> Tensor:
    """q (..., C) int8, scale (...) f32 -> f32 (..., C)."""
    return q.float() * scale[..., None].float()
