"""Rotary position embeddings (counterpart of midgpt_tpu/ops/rope.py).

GPT-J interleaved style: pairs are interleaved ([a b c d] rotates to
[-b a -d c]), the sin/cos tables use base 10000 over even channel indices,
and are computed in float32 and cast to the activation dtype at the point
of use. `style="split"` expects the C axis pre-permuted by
`split_permutation` (models/gpt.py permutes the q/k projection rows) and
applies the mathematically identical contiguous rotate-half form.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

Tensor = torch.Tensor


def rope_table(
    head_dim: int, length: int, base: float = 10000.0, *, device: torch.device
) -> tp.Tuple[Tensor, Tensor]:
    """(sin, cos) tables of shape (length, head_dim // 2), float32."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (base ** (ar / head_dim))
    angles = (
        torch.arange(length, dtype=torch.float32, device=device)[:, None]
        * inv_freq[None, :]
    )
    return torch.sin(angles), torch.cos(angles)


def rotate_interleaved(x: Tensor) -> Tensor:
    """[a b c d] -> [-b a -d c] over the trailing axis."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def rotate_half(x: Tensor) -> Tensor:
    """[a b | c d] -> [-c -d | a b] over the trailing axis."""
    h1, h2 = torch.chunk(x, 2, dim=-1)
    return torch.cat((-h2, h1), dim=-1)


def _duplicate_pairs(t: Tensor) -> Tensor:
    """(..., C/2) -> (..., C) by repeating each element twice (interleaved)."""
    return torch.stack((t, t), dim=-1).reshape(t.shape[:-1] + (t.shape[-1] * 2,))


def _tile_halves(t: Tensor) -> Tensor:
    """(..., C/2) -> (..., C) by concatenating the table with itself."""
    return torch.cat((t, t), dim=-1)


def _expand(t: Tensor, style: str, dtype: torch.dtype) -> Tensor:
    return (_tile_halves(t) if style == "split" else _duplicate_pairs(t)).to(dtype)


def _rotate(x: Tensor, style: str) -> Tensor:
    return rotate_half(x) if style == "split" else rotate_interleaved(x)


def split_permutation(head_dim: int) -> np.ndarray:
    """Index array p with p[i]=2i, p[i+C/2]=2i+1: gathering a head's C axis
    by p moves interleaved pair (2i, 2i+1) to positions (i, i+C/2), turning
    the interleaved rotation into `rotate_half` with the SAME angles."""
    p = np.empty((head_dim,), np.int64)
    half = head_dim // 2
    p[:half] = np.arange(half) * 2
    p[half:] = np.arange(half) * 2 + 1
    return p


def apply_rope_positions(
    x: Tensor,  # (B, T, H, C)
    sin: Tensor,
    cos: Tensor,
    positions: Tensor,  # (B, T) absolute positions
    style: str = "interleaved",
) -> Tensor:
    """Rotate `x` (B, T, H, C) with PER-TOKEN absolute positions (B, T) —
    the continuous-batching decode step, where every slot sits at its own
    write position."""
    sin = _expand(sin[positions], style, x.dtype)[:, :, None, :]  # (B, T, 1, C)
    cos = _expand(cos[positions], style, x.dtype)[:, :, None, :]
    return x * cos + _rotate(x, style) * sin


def apply_rope_bthc(
    x: Tensor,  # (B, T, H, C)
    sin: Tensor,
    cos: Tensor,
    positions: tp.Optional[Tensor] = None,  # (T,) absolute positions
    style: str = "interleaved",
) -> Tensor:
    """Rotate `x` (B, T, H, C) — sequence at axis 1, heads at axis 2 — with
    one (T,) position vector shared by the batch (the first T rows of the
    tables when `positions` is None)."""
    if positions is not None:
        sin, cos = sin[positions], cos[positions]
    else:
        sin, cos = sin[: x.shape[1]], cos[: x.shape[1]]
    sin = _expand(sin, style, x.dtype)[:, None, :]  # (T, 1, C)
    cos = _expand(cos, style, x.dtype)[:, None, :]
    return x * cos + _rotate(x, style) * sin
