"""Paged decode and verify attention for the continuous-batching engine
(counterpart of midgpt_tpu/kernels/decode_attention.py), in bf16/f32 and
int8 cache modes.

K/V are read through a per-slot PAGE TABLE: physical pages of `page_size`
tokens live in a shared (H_kv, num_pages, page_size, C) pool
(models/gpt.py PagedKVCache), and slot b's logical page j is pool page
`page_table[b, j]`. Each slot (each query row, for verify) masks to its own
count, so one call serves any mix of request lengths. Int8 pools carry f32
scales (num_pages, H_kv, page_size) beside them (ops/quant.py). Under GQA
the query has H_q = G * H_kv heads (query head h reads K/V head h // G);
under a sliding window each row keeps its last `sliding_window` visible
keys and the `attn_sinks` prefix (ops/attention.visible_mask).

Two lowerings of each, as in the JAX package:

  * `paged_attention_kernel` / `paged_verify_attention_kernel` — the
    template's decode (R = 1) and verify (R = k+1) specs
    (kernels/attention_template.py): the CUDA kernel for CUDA tensors, its
    plain per-page version for CPU tensors;
  * `paged_attention_gather` / `paged_verify_attention_gather` — gather each
    slot's pages contiguous (dequantized to q's dtype right after the
    gather for int8 pools, K/V heads repeated to the query heads) and run
    the op-for-op attention of the
    contiguous decode step (the lowering JAX runs off-TPU): -inf mask
    BEFORE the 1/sqrt(C)-scaled f32 softmax for split 1; for split > 1 the
    same fat score product, partitioned statistics, merged with
    ops/online_softmax.merge_partials.

`impl="auto"` picks the kernel for CUDA tensors and the gather for CPU
tensors, just as JAX picks the gather off the TPU. The two lowerings round
at different points in int8 mode (the kernel reads f32 dequantized values,
the gather casts them to q's dtype): each is held to its own JAX
counterpart.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from midgpt_tpu_torch.kernels.attention_template import (
    normalize_split_k,
    paged_attention_template,
)
from midgpt_tpu_torch.ops.attention import visible_mask
from midgpt_tpu_torch.ops.online_softmax import M_INIT, MASK, finalize, merge_partials, online_block
from midgpt_tpu_torch.ops.quant import dequantize_q8

Tensor = torch.Tensor
OptTensor = tp.Optional[Tensor]


def paged_attention_kernel(
    q: Tensor,  # (B, H_q, C) — one query token per slot
    k_pages: Tensor,  # (H_kv, num_pages, page_size, C) — ONE layer's pool
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    lengths: Tensor,  # (B,) int — visible keys per slot
    k_scale: OptTensor = None,  # (num_pages, H_kv, page_size) f32, int8 pools
    v_scale: OptTensor = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Paged decode attention via the template (n_rows == 1: the per-row
    count IS the slot length). Returns (B, H_q, C)."""
    out = paged_attention_template(
        q[:, :, None, :], k_pages, v_pages, page_table, lengths[:, None],
        k_scale, v_scale, split_k=split_k, sliding_window=sliding_window, attn_sinks=attn_sinks,
    )
    return out[:, :, 0, :]


def _repeat_kv_heads(a: Tensor, groups: int) -> Tensor:
    """(B, H_kv, S, C) -> (B, H_q, S, C): query head h reads K/V head
    h // groups (`repeat_interleave`, as jnp.repeat and the template's fold)."""
    return a if groups == 1 else a.repeat_interleave(groups, dim=1)


def _gather_pages(pages: Tensor, scales: OptTensor, page_table: Tensor, out_dtype=None) -> Tensor:
    """Gather every slot's pages contiguous -> (B, H, S, C), dequantizing
    right after the gather to `out_dtype` when the pool is int8."""
    H, _, page_size, C = pages.shape
    B, max_pages = page_table.shape
    flat = page_table.reshape(-1).long()
    g = pages[:, flat]  # (H, B*max_pages, ps, C)
    g = g.reshape(H, B, max_pages * page_size, C).transpose(0, 1)
    if scales is None:
        return g
    sg = scales[flat].reshape(B, max_pages, H, page_size).transpose(1, 2)
    return dequantize_q8(g, sg.reshape(B, H, max_pages * page_size)).to(out_dtype)


def paged_attention_gather(
    q: Tensor,  # (B, H_q, C)
    k_pages: Tensor,  # (H_kv, num_pages, page_size, C)
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    lengths: Tensor,  # (B,) int
    k_scale: OptTensor = None,
    v_scale: OptTensor = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Gather lowering: pages gathered contiguous, then the exact attention
    ops of the contiguous decode step. Returns (B, H_q, C) in q.dtype."""
    B, H, C = q.shape
    groups = H // k_pages.shape[0]
    page_size = k_pages.shape[2]
    max_pages = page_table.shape[1]
    S = max_pages * page_size
    split_k = normalize_split_k(split_k, max_pages)
    kg = _repeat_kv_heads(_gather_pages(k_pages, k_scale, page_table, q.dtype), groups)
    vg = _repeat_kv_heads(_gather_pages(v_pages, v_scale, page_table, q.dtype), groups)
    # jnp.einsum promotes mixed operand dtypes (e.g. f32 q over a bf16 pool)
    dt = torch.promote_types(q.dtype, kg.dtype)
    col = torch.arange(S, device=q.device)
    if split_k == 1:
        scores = torch.einsum("bhqc,bhkc->bhqk", q[:, :, None].to(dt), kg.to(dt))  # (B, H, 1, S)
        valid = visible_mask(col[None, None, None, :], lengths[:, None, None, None], sliding_window, attn_sinks)
        scores = scores.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(scores.float() / math.sqrt(C), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bhkc->bhqc", probs.to(dt), vg.to(dt))[:, :, 0]

    # Fat score product above, partitioned statistics below: the masked f32
    # scores reshape into split_k partitions, one online block sweeps each,
    # and the partials merge with the kernel path's merge math.
    part_len = (max_pages // split_k) * page_size
    scale = 1.0 / math.sqrt(C)
    s = torch.einsum("bhc,bhkc->bhk", q.to(dt), kg.to(dt)).float() * scale
    s = torch.where(visible_mask(col[None, None], lengths[:, None, None], sliding_window, attn_sinks), s, MASK)
    s = s.reshape(B, H, split_k, part_len)
    m = torch.full((B, H, split_k), M_INIT, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, split_k), dtype=torch.float32, device=q.device)
    m, _, p, l = online_block(m, l, s)
    acc = torch.einsum(
        "bhsk,bhskc->bhsc", p.to(vg.dtype), vg.reshape(B, H, split_k, part_len, C)
    ).float()
    m, l, acc = merge_partials(m, l, acc, axis=2)
    out, _ = finalize(m, l, acc, dtype=q.dtype)
    return out


def _dispatch(impl: str, q: Tensor, kernel, gather, *args, **kw) -> Tensor:
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "gather"
    if impl == "kernel":
        return kernel(q, *args, **kw)
    if impl == "gather":
        return gather(q, *args, **kw)
    raise ValueError(f"unknown paged attention impl {impl!r}")


def paged_attention(
    q: Tensor,
    k_pages: Tensor,
    v_pages: Tensor,
    page_table: Tensor,
    lengths: Tensor,
    impl: str = "auto",
    k_scale: OptTensor = None,
    v_scale: OptTensor = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Dispatch: 'auto' is the kernel for CUDA tensors and the gather for
    CPU tensors; 'kernel' and 'gather' force one lowering."""
    return _dispatch(
        impl, q, paged_attention_kernel, paged_attention_gather, k_pages, v_pages,
        page_table, lengths, k_scale, v_scale, split_k=split_k,
        sliding_window=sliding_window, attn_sinks=attn_sinks,
    )


# ----------------------------------------------------------------------
# Multi-row paged verify attention (speculative decoding)
# ----------------------------------------------------------------------


def paged_verify_attention_kernel(
    q: Tensor,  # (B, T, H_q, C)
    k_pages: Tensor,  # (H_kv, num_pages, page_size, C)
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    counts: Tensor,  # (B, T) int — keys visible to row t of slot b
    k_scale: OptTensor = None,
    v_scale: OptTensor = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Multi-row paged attention via the template (n_rows == T). Returns
    (B, T, H, C). q is transposed head-major once outside the kernel, so
    the kernel works in the pool's native (H, ...) layout. Row t masks to
    its own count (the caller passes lengths + t + 1, which makes the
    speculative chunk causal through the page table)."""
    out = paged_attention_template(
        q.transpose(1, 2), k_pages, v_pages, page_table, counts,
        k_scale, v_scale, split_k=split_k, sliding_window=sliding_window, attn_sinks=attn_sinks,
    )
    return out.transpose(1, 2)


def paged_verify_attention_gather(
    q: Tensor,  # (B, T, H_q, C)
    k_pages: Tensor,
    v_pages: Tensor,
    page_table: Tensor,
    counts: Tensor,  # (B, T) int
    k_scale: OptTensor = None,
    v_scale: OptTensor = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Gather lowering of the multi-row verify attention: pages gathered
    contiguous once (dequantized in int8 mode), then per-row count masks
    over the shared buffer, in the decode gather's
    mask-then-scale-then-f32-softmax order. split_k > 1 is the same
    stats-only split as the decode gather, applied per row. Returns
    (B, T, H, C)."""
    B, T, H, C = q.shape
    groups = H // k_pages.shape[0]
    page_size = k_pages.shape[2]
    max_pages = page_table.shape[1]
    S = max_pages * page_size
    split_k = normalize_split_k(split_k, max_pages)
    kg = _repeat_kv_heads(_gather_pages(k_pages, k_scale, page_table, q.dtype), groups)
    vg = _repeat_kv_heads(_gather_pages(v_pages, v_scale, page_table, q.dtype), groups)
    col = torch.arange(S, device=q.device)
    valid = visible_mask(col[None, None, None, :], counts[:, None, :, None], sliding_window, attn_sinks)  # (B, 1, T, S)
    # q takes the gathered buffer's dtype (jnp: q.astype(kg.dtype))
    scores = torch.einsum("bthc,bhkc->bhtk", q.to(kg.dtype), kg)
    if split_k == 1:
        scores = scores.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(scores.float() / math.sqrt(C), dim=-1).to(q.dtype)
        dt = torch.promote_types(probs.dtype, vg.dtype)  # jnp.einsum promotes
        return torch.einsum("bhtk,bhkc->bthc", probs.to(dt), vg.to(dt))

    part_len = (max_pages // split_k) * page_size
    s = torch.where(valid, scores.float() * (1.0 / math.sqrt(C)), MASK)  # the unsplit fat dot
    s = s.reshape(B, H, T, split_k, part_len)
    m = torch.full((B, H, T, split_k), M_INIT, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T, split_k), dtype=torch.float32, device=q.device)
    m, _, p, l = online_block(m, l, s)
    acc = torch.einsum(
        "bhtsk,bhskc->bhtsc", p.to(vg.dtype), vg.reshape(B, H, split_k, part_len, C)
    ).float()
    m, l, acc = merge_partials(m, l, acc, axis=3)
    out, _ = finalize(m, l, acc, dtype=q.dtype)  # (B, H, T, C)
    return out.transpose(1, 2)


def paged_verify_attention(
    q: Tensor,  # (B, T, H, C) — T = k+1 speculative positions per slot
    k_pages: Tensor,
    v_pages: Tensor,
    page_table: Tensor,
    counts: Tensor,  # (B, T) int
    impl: str = "auto",
    k_scale: OptTensor = None,
    v_scale: OptTensor = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Batched multi-row paged attention for speculative verification
    (GPT.verify_step_paged): every slot scores its k+1 candidate positions
    against its own pages in ONE call; under a window it slides per row.
    Dispatch mirrors `paged_attention`."""
    return _dispatch(
        impl, q, paged_verify_attention_kernel, paged_verify_attention_gather, k_pages,
        v_pages, page_table, counts, k_scale, v_scale, split_k=split_k,
        sliding_window=sliding_window, attn_sinks=attn_sinks,
    )
