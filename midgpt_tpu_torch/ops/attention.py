"""Causal multi-head attention: the reference-exact naive path, the O(T)
blockwise path and the flash dispatch (counterpart of
midgpt_tpu/ops/attention.py).

Numerics of `naive_causal_attention` follow the reference: scores in the
compute dtype, -inf below the diagonal, softmax of `scores.f32 / sqrt(C)`
in float32, probabilities cast back (then dropped out) for the PV product.
`blockwise_causal_attention` is the plain PyTorch online softmax with the
JAX path's rounding; `impl='flash'` goes to kernels/flash_attention.py —
the CUDA kernels for CUDA tensors, their plain version for CPU tensors.

All impls take q, k, v of shape (B, H, T, C) ('bhtc') or (B, T, H, C)
('bthc') and return the same layout. `sliding_window` / `attn_sinks`
restrict row t to the keys `visible_mask` keeps (naive and blockwise; the
flash kernels carry no window and refuse one, as in JAX).
"""

from __future__ import annotations

import math
import typing as tp

import torch

from midgpt_tpu_torch.kernels.flash_attention import flash_attention
from midgpt_tpu_torch.ops.dropout import dropout

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


def naive_causal_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    dropout_rate: float = 0.0,
    generator: tp.Optional[torch.Generator] = None,
    inference: bool = True,
    sliding_window: int = 0,
    attn_sinks: int = 0,
    head_shard: tp.Optional[tp.Tuple[int, int]] = None,
) -> Tensor:
    """Materialized-scores causal attention (optionally windowed), f32
    softmax, optional attention-probability dropout. (B, T, H, C) ->
    (B, T, H, C) — the sequence-major layout the fused projection produces.
    `head_shard` (i, n): the heads are shard i of n (tensor parallelism),
    and the dropout mask is that shard's of the whole heads' mask."""
    T, C = q.shape[1], q.shape[-1]
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    mask = visible_mask(cols, rows + 1, sliding_window, attn_sinks)
    scores = torch.einsum("bqhc,bkhc->bhqk", q, k)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores.float() / math.sqrt(C), dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_rate, generator, inference,
                    shard=None if head_shard is None else (1, *head_shard))
    return torch.einsum("bhqk,bkhc->bqhc", probs, v)


def blockwise_causal_attention(
    q: Tensor, k: Tensor, v: Tensor, block_size: int = 512, sliding_window: int = 0, attn_sinks: int = 0
) -> Tensor:
    """Online-softmax causal attention with O(T * block) memory over
    (B, H, T, C), the JAX blockwise path's arithmetic: block scores in the
    compute dtype cast to f32 and scaled, -inf masks (windowed by
    `visible_mask`), running (max, sum, acc) in f32, p cast to the compute
    dtype for each PV product. Key blocks above a query block's diagonal
    are skipped (in JAX they are masked to -inf, which leaves the running
    statistics exactly as they were)."""
    B, H, T, C = q.shape
    blk = min(block_size, T)
    T_orig = T
    if T % blk:
        # Pad to a block multiple; padded keys are masked for real queries
        # and padded query rows are sliced off.
        pad = blk - T % blk
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        T += pad
    n_blk = T // blk
    scale = 1.0 / math.sqrt(C)
    idx = torch.arange(blk, device=q.device)
    outs = []
    for qi in range(n_blk):
        q_i = q[:, :, qi * blk : (qi + 1) * blk]
        acc = torch.zeros((B, H, blk, C), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, blk), float("-inf"), dtype=torch.float32, device=q.device)
        denom = torch.zeros((B, H, blk), dtype=torch.float32, device=q.device)
        for j in range(qi + 1):
            k_j, v_j = k[:, :, j * blk : (j + 1) * blk], v[:, :, j * blk : (j + 1) * blk]
            s = torch.einsum("bhqc,bhkc->bhqk", q_i, k_j).float() * scale
            keep = visible_mask(j * blk + idx[None, :], qi * blk + idx[:, None] + 1, sliding_window, attn_sinks)
            s = s.masked_fill(~keep, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), torch.zeros_like(m))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            denom = denom * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bhkc->bhqc", p.to(q.dtype), v_j).float()
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp_min(denom, 1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :T_orig]


def flash_kernel_usable(T: int, block_size: int) -> bool:
    """True when the flash path can serve this sequence length: its block
    must tile T (arbitrary T takes the blockwise path, as in JAX). Every
    device can: CUDA tensors launch the kernels, CPU tensors take their
    plain version."""
    return T % min(block_size, T) == 0


def flash_block_sizes(T: int, block_size: int) -> tp.Tuple[int, int]:
    """(block_q, block_k) for the flash path — the JAX package's tile
    policy, kept so both packages dispatch the same bodies: KV blocks use
    the largest block the sequence allows; Q tiles prefer 512 but fall back
    to block_k when 512 does not divide T."""
    bk = min(block_size, T)
    bq = min(512, bk)
    if T % bq:
        bq = bk
    return bq, bk


def multihead_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    impl: str = "naive",
    dropout_rate: float = 0.0,
    generator: tp.Optional[torch.Generator] = None,
    inference: bool = False,
    block_size: int = 512,
    layout: str = "bhtc",
    sliding_window: int = 0,
    attn_sinks: int = 0,
    head_shard: tp.Optional[tp.Tuple[int, int]] = None,
) -> Tensor:
    """Dispatch causal attention; the output layout matches the input's.

    impl: 'naive' (materialized T x T), 'blockwise' (O(T) online softmax),
    'flash' (kernels/flash_attention.py); 'ring' and 'ulysses' are
    mesh-bound in JAX and, with no mesh bound, compute the blockwise math
    — as here. Attention-probability dropout needs impl='naive';
    `head_shard` is `naive_causal_attention`'s."""
    if layout not in ("bhtc", "bthc"):
        raise ValueError(f"unknown attention layout {layout!r}")
    if impl not in ("naive", "blockwise", "flash", "ring", "ulysses"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl in ("ring", "ulysses"):
        impl = "blockwise"
    if impl != "naive" and dropout_rate != 0.0 and not inference:
        raise NotImplementedError(f"attention dropout requires impl='naive', got {impl!r}")
    if sliding_window and impl == "flash":
        # the flash kernels carry no window mask (GPTConfig refuses the
        # pair at construction; this guards direct callers)
        raise NotImplementedError("sliding_window requires impl 'naive' or 'blockwise'")

    T = q.shape[2] if layout == "bhtc" else q.shape[1]
    if impl == "flash":
        if flash_kernel_usable(T, block_size):
            bq, bk = flash_block_sizes(T, block_size)
            if layout == "bthc":  # head-major around the kernel, as JAX's _call_flash
                q, k, v = (a.transpose(1, 2) for a in (q, k, v))
                return flash_attention(q, k, v, bq, bk).transpose(1, 2)
            return flash_attention(q, k, v, bq, bk)
        impl = "blockwise"

    if impl == "naive":
        if layout == "bhtc":
            q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        out = naive_causal_attention(
            q, k, v, dropout_rate=dropout_rate, generator=generator, inference=inference,
            sliding_window=sliding_window, attn_sinks=attn_sinks, head_shard=head_shard,
        )
        return out.transpose(1, 2) if layout == "bhtc" else out
    if layout == "bthc":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    out = blockwise_causal_attention(
        q, k, v, block_size=min(block_size, T), sliding_window=sliding_window, attn_sinks=attn_sinks
    )
    return out.transpose(1, 2) if layout == "bthc" else out
