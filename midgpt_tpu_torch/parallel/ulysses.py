"""All-to-all (DeepSpeed-Ulysses) sequence parallelism (counterpart of
midgpt_tpu/parallel/ulysses.py): the second sequence-parallel schedule
beside the ring (parallel/ring_attention.py), attn_impl='ulysses'.

Where the ring keeps the queries on their rank and moves K/V shards n-1
hops around the sp group, Ulysses re-shards once: an all-to-all trades the
sequence shards for head shards, every rank runs the dense causal flash
attention (ops/attention.py, impl 'flash': the CUDA kernels on the card)
over the FULL sequence for its H/n heads, and a second all-to-all brings
the sequence shards back. The heads must divide the group's size.

The all-to-all is an autograd function whose backward is the transposed
all-to-all; the attention inside is the dispatcher's differentiable one.
Both backends take CUDA buffers as they are (gloo's all_to_all_single
does, on the H100 machine's torch 2.11; its send and receive do not, so
the ring's hops stage through host memory). `A2A` counts the all-to-alls
and their bytes.
"""

from __future__ import annotations

import collections
import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.ops.attention import multihead_attention

Tensor = torch.Tensor

# all-to-alls made by this process and the bytes each sent
A2A: tp.Counter[str] = collections.Counter()


def _all_to_all(x: Tensor, group, split_axis: int, concat_axis: int) -> Tensor:
    """JAX's tiled all_to_all: `x` split into n chunks along `split_axis`,
    chunk i sent to rank i of `group`, the chunks received concatenated
    along `concat_axis` in rank order."""
    n = dist.get_world_size(group)
    shape = list(x.shape)
    # (n, ...) with the chunks along the leading axis, passed flat
    send = x.unflatten(split_axis, (n, shape[split_axis] // n)).movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    A2A["calls"] += 1
    A2A["bytes"] += send.numel() * send.element_size()
    # received chunk i is rank i's: the i-th part of the concat axis (the
    # other axes keep x's places, the split one at 1/n of its size)
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group, split_axis: int, concat_axis: int) -> Tensor:
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g: Tensor):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g.contiguous(), ctx.group, concat_axis, split_axis), None, None, None


def ulysses_attention(q: Tensor, k: Tensor, v: Tensor, group, block_size: int = 512, impl: str = "flash") -> Tensor:
    """Causal attention across the sp `group` (a process group, or None for
    one rank): q, k, v are this rank's (B, H, Tl, C) shards, contiguous
    sequence chunks in group order; returns its (B, H, Tl, C) output
    shard, differentiable. H must divide by the group's size."""
    n = 1 if group is None else dist.get_world_size(group)
    if n > 1:
        if q.shape[1] % n != 0:
            raise ValueError(f"n_head={q.shape[1]} not divisible by sp size {n}")
        # trade the sequence shards for head shards: (B, H/n, T, C)
        q, k, v = (_AllToAll.apply(a, group, 1, 2) for a in (q, k, v))
    out = multihead_attention(q, k, v, impl=impl, inference=True, block_size=block_size, layout="bhtc")
    if n > 1:
        out = _AllToAll.apply(out, group, 2, 1)  # the sequence shards back: (B, H, Tl, C)
    return out
