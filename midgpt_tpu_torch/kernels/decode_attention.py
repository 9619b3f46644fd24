"""Paged decode attention for the continuous-batching engine (counterpart
of midgpt_tpu/kernels/decode_attention.py, decode spec).

K/V are read through a per-slot PAGE TABLE: physical pages of `page_size`
tokens live in a shared (H, num_pages, page_size, C) pool
(models/gpt.py PagedKVCache), and slot b's logical page j is pool page
`page_table[b, j]`. Each slot masks to its own true length, so one call
serves any mix of request lengths.

Two lowerings, as in the JAX package:

  * `paged_attention_kernel` — the template's decode spec
    (kernels/attention_template.py): the CUDA kernel for CUDA tensors, its
    plain per-page version for CPU tensors;
  * `paged_attention_gather` — gather each slot's pages contiguous and run
    the op-for-op attention of the contiguous decode step (the lowering JAX
    runs off-TPU): -inf mask BEFORE the 1/sqrt(C)-scaled f32 softmax for
    split 1; for split > 1 the same fat score product, partitioned
    statistics, merged with ops/online_softmax.merge_partials.

`paged_attention(impl="auto")` picks the kernel for CUDA tensors and the
gather for CPU tensors, just as JAX picks the gather off the TPU.
"""

from __future__ import annotations

import math

import torch

from midgpt_tpu_torch.kernels.attention_template import (
    normalize_split_k,
    paged_attention_template,
)
from midgpt_tpu_torch.ops.attention import visible_mask
from midgpt_tpu_torch.ops.online_softmax import M_INIT, MASK, finalize, merge_partials, online_block

Tensor = torch.Tensor


def paged_attention_kernel(
    q: Tensor,  # (B, H, C) — one query token per slot
    k_pages: Tensor,  # (H, num_pages, page_size, C) — ONE layer's pool
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    lengths: Tensor,  # (B,) int — visible keys per slot
    split_k: int = 1,
) -> Tensor:
    """Paged decode attention via the template (n_rows == 1: the per-row
    count IS the slot length). Returns (B, H, C)."""
    out = paged_attention_template(
        q[:, :, None, :], k_pages, v_pages, page_table, lengths[:, None],
        split_k=split_k,
    )
    return out[:, :, 0, :]


def _gather_pages(pages: Tensor, page_table: Tensor) -> Tensor:
    """Gather every slot's pages contiguous -> (B, H, S, C)."""
    H, _, page_size, C = pages.shape
    B, max_pages = page_table.shape
    g = pages[:, page_table.reshape(-1).long()]  # (H, B*max_pages, ps, C)
    return g.reshape(H, B, max_pages * page_size, C).transpose(0, 1)


def paged_attention_gather(
    q: Tensor,  # (B, H, C)
    k_pages: Tensor,  # (H, num_pages, page_size, C)
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    lengths: Tensor,  # (B,) int
    split_k: int = 1,
) -> Tensor:
    """Gather lowering: pages gathered contiguous, then the exact attention
    ops of the contiguous decode step. Returns (B, H, C) in q.dtype."""
    B, H, C = q.shape
    if k_pages.shape[0] != H:
        raise NotImplementedError(
            "GQA/MQA paged attention is not ported yet (ROADMAP.md port queue)"
        )
    page_size = k_pages.shape[2]
    max_pages = page_table.shape[1]
    S = max_pages * page_size
    split_k = normalize_split_k(split_k, max_pages)
    kg = _gather_pages(k_pages, page_table)
    vg = _gather_pages(v_pages, page_table)
    # jnp.einsum promotes mixed operand dtypes (e.g. f32 q over a bf16 pool)
    dt = torch.promote_types(q.dtype, kg.dtype)
    col = torch.arange(S, device=q.device)
    if split_k == 1:
        scores = torch.einsum("bhqc,bhkc->bhqk", q[:, :, None].to(dt), kg.to(dt))  # (B, H, 1, S)
        valid = visible_mask(col[None, None, None, :], lengths[:, None, None, None])
        scores = scores.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(scores.float() / math.sqrt(C), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bhkc->bhqc", probs.to(dt), vg.to(dt))[:, :, 0]

    # Fat score product above, partitioned statistics below: the masked f32
    # scores reshape into split_k partitions, one online block sweeps each,
    # and the partials merge with the kernel path's merge math.
    part_len = (max_pages // split_k) * page_size
    scale = 1.0 / math.sqrt(C)
    s = torch.einsum("bhc,bhkc->bhk", q.to(dt), kg.to(dt)).float() * scale
    s = torch.where(visible_mask(col[None, None], lengths[:, None, None]), s, MASK)
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


def paged_attention(
    q: Tensor,
    k_pages: Tensor,
    v_pages: Tensor,
    page_table: Tensor,
    lengths: Tensor,
    impl: str = "auto",
    split_k: int = 1,
) -> Tensor:
    """Dispatch: 'auto' is the kernel for CUDA tensors and the gather for
    CPU tensors; 'kernel' and 'gather' force one lowering."""
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "gather"
    if impl == "kernel":
        return paged_attention_kernel(
            q, k_pages, v_pages, page_table, lengths, split_k=split_k
        )
    if impl == "gather":
        return paged_attention_gather(
            q, k_pages, v_pages, page_table, lengths, split_k=split_k
        )
    raise ValueError(f"unknown paged attention impl {impl!r}")
