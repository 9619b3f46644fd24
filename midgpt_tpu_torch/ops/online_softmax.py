"""Online-softmax combine primitives (counterpart of
midgpt_tpu/ops/online_softmax.py).

The paged-attention template's plain version (kernels/attention_template.py)
folds one page of scores at a time with `online_block`; the split-K path
merges per-partition RAW (m, l, acc) partials with `merge_partials` and
turns them into outputs with `finalize`. On the card the CUDA merge kernel
(csrc/paged_attention.cu `paged_attention_merge`) does both, and these two
are its plain version.

Masking uses a large-negative FINITE score (`MASK`) with the running max
seeded at `M_INIT > MASK`: `exp(MASK - m)` underflows to exactly 0, so a
fully-masked partition carries exactly (M_INIT, 0, 0) and drops out of
`merge_partials`, and `finalize` turns an all-zero weight row into a 0
output instead of NaN.
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor

MASK = -1.0e30
M_INIT = -0.5e30


def online_block(
    m: Tensor, l: Tensor, s: Tensor
) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fold one raw f32 score block (key axis last) into running (m, l).

    Returns (m_new, alpha, p, l_new); the caller rescales its accumulator
    as `acc * alpha[..., None] + pv`."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)  # underflows to 0 on the first visit (M_INIT)
    p = torch.exp(s - m_new[..., None])  # masked entries underflow to 0
    l_new = l * alpha + p.sum(dim=-1)
    return m_new, alpha, p, l_new


def merge_partials(
    m: Tensor, l: Tensor, acc: Tensor, axis: int = 0
) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """Reduce stacked RAW split-K partials along `axis`:

        m = max_i m_i,   l = sum_i l_i * exp(m_i - m),
        acc = sum_i acc_i * exp(m_i - m).

    An all-masked partition (M_INIT, 0, 0) contributes exactly 0."""
    axis = axis % m.ndim
    m_tot = m.amax(dim=axis)
    w = torch.exp(m - m_tot.unsqueeze(axis))
    l_tot = (l * w).sum(dim=axis)
    acc_tot = (acc * w.unsqueeze(-1)).sum(dim=axis)
    return m_tot, l_tot, acc_tot


def finalize(
    m: Tensor, l: Tensor, acc: Tensor, dtype: tp.Optional[torch.dtype] = None
) -> tp.Tuple[Tensor, Tensor]:
    """(out, lse) from final raw statistics. Rows with l == 0 (nothing
    visible) give a 0 output and lse = MASK rather than NaN; rows with
    l > 0 divide by l exactly."""
    safe_l = torch.clamp_min(l, 1e-30)
    out = acc / safe_l[..., None]
    if dtype is not None:
        out = out.to(dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l), torch.full_like(m, MASK))
    return out, lse
