"""Softmax cross-entropy with integer labels, computed in float32
(counterpart of midgpt_tpu/ops/loss.py).

`fused_linear_cross_entropy` is the training loss: the mean CE of
`hidden @ lm_head.T` over token chunks, never materialising the full
(N, V) float32 logits. Each chunk's logits stay in the compute dtype
(bf16 on the main path, 8192 x 50304 x 2 bytes = 0.8 GB), with a streaming
logsumexp in f32: max in the compute dtype (a selection, exact), then
exp(logits.f32 - max) summed in f32. It is an autograd.Function whose
backward rebuilds p = exp(logits.f32 - lse) chunk by chunk: d logits =
(p - onehot) / N cast to the compute dtype, then d hidden = d logits @
lm_head and d lm_head = d logits^T @ hidden in the compute dtype.

On a vocab-parallel tp row (a `group`) lm_head is the rank's V/tp rows
and each chunk's logits its columns: the chunk max is all-reduced over the
row with MAX (exact, a selection), the f32 sum-exp and the label logit
(from the rank that holds the label, zero elsewhere) with SUM. The
backward stays on the rank's columns, and d hidden is summed over the row.
Without a group the whole head is the one shard and nothing is reduced.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def cross_entropy_loss(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean CE over all positions. logits (..., V) any float dtype, labels (...) ints."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - label_logits).mean()


def _chunks(n: int, chunk: int) -> tp.List[slice]:
    return [slice(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, chunk_tokens, remat, group, index):
        N, V = h.shape[0], w.shape[0]
        local = labels - index * V  # the labels among this shard's columns
        inside = (local >= 0) & (local < V)
        local = local.clamp(0, V - 1)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lse = torch.empty(N, dtype=torch.float32, device=h.device)
        kept = []
        for sl in _chunks(N, chunk_tokens):
            logits = h[sl] @ w.T  # compute dtype
            m = logits.amax(dim=-1).float()
            if group is not None:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            label_logits = torch.gather(logits, 1, local[sl, None])[:, 0].float()
            sums = torch.stack((torch.exp(logits.float() - m[:, None]).sum(dim=-1),
                                torch.where(inside[sl], label_logits, torch.zeros_like(label_logits))))
            if group is not None:
                dist.all_reduce(sums, group=group)
            lse[sl] = m + torch.log(sums[0])
            total = total + (lse[sl] - sums[1]).sum()
            if not remat:
                kept.append(logits)
        ctx.save_for_backward(h, w, local, inside, lse)
        ctx.kept, ctx.chunk, ctx.group = kept, chunk_tokens, group
        return total / N

    @staticmethod
    def backward(ctx, g):
        h, w, local, inside, lse = ctx.saved_tensors
        N = h.shape[0]
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        scale = g.float() / N
        for i, sl in enumerate(_chunks(N, ctx.chunk)):
            logits = ctx.kept[i] if ctx.kept else h[sl] @ w.T
            d = torch.exp(logits.float() - lse[sl, None])
            rows = torch.arange(d.shape[0], device=d.device)
            d[rows, local[sl]] -= inside[sl].float()
            d = (d * scale).to(h.dtype)
            dh[sl] = d @ w
            dw += (d.T @ h[sl]).float()
        ctx.kept = None
        if ctx.group is not None:
            dist.all_reduce(dh, group=ctx.group)
        return dh, dw.to(w.dtype), None, None, None, None, None


def _remat(N: int, chunk: int, remat_chunks: tp.Optional[bool]) -> bool:
    """The chunks' logits are recomputed in the backward past 8 chunks,
    unless the caller says (as the JAX package does)."""
    return -(-N // chunk) > 8 if remat_chunks is None else remat_chunks


def fused_linear_cross_entropy(
    hidden: Tensor,
    lm_head: Tensor,
    labels: Tensor,
    chunk_tokens: int = 8192,
    remat_chunks: tp.Optional[bool] = None,
    group=None,
    index: int = 0,
) -> Tensor:
    """Mean CE of `hidden @ lm_head.T` (hidden (B, T, D), lm_head (V, D),
    labels (B, T) ints) WITHOUT the full (B*T, V) float32 logits.

    remat_chunks: recompute each chunk's logits in the backward (True) or
    keep them in the compute dtype (False); None keeps them up to 8 chunks,
    as the JAX package does.

    `group`, `index`: a vocab-parallel tp row (parallel/tp.py TPTrain
    `vocab_row`): lm_head is this rank's rows [index * V, (index + 1) * V)
    of the whole head (module docstring). Collective then: every rank of
    the row calls it on the same hidden states and labels; each returns
    the whole loss."""
    B, T, D = hidden.shape
    N = B * T
    chunk = min(chunk_tokens, N)
    return _FusedLinearCE.apply(
        hidden.reshape(N, D), lm_head, labels.reshape(N).long(), chunk, _remat(N, chunk, remat_chunks), group,
        index,
    )
