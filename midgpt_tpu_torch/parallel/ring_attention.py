"""Ring attention: causal self-attention over a sequence sharded on the
mesh's sp axis (counterpart of midgpt_tpu/parallel/ring_attention.py).

Each rank of an sp group holds a contiguous (B, H, Tl, C) shard of Q, K
and V: rank g of n holds global positions [g*Tl, (g+1)*Tl), the columns
parallel/data.py gives it. The K/V shards travel around the ring, one hop
a step, while every rank merges the online-softmax statistics of its own
queries against each visiting shard: after n steps every query has seen
every key once, with O(Tl) activations a rank and neighbour-to-neighbour
traffic only. The sequence is never gathered.

The causal structure is decided per pair of shards, as JAX decides it:
the diagonal pair (a rank's own shard, step 0) is causal attention; a
visiting shard j < g is wholly visible (full attention: the flash
kernels' causal=False bodies); j > g contributes nothing, its lse forced
to MASK so that its weight underflows to exactly 0 at the merge. That
pair's compute still runs, so every rank runs n pairs per call and the
hops stay in lockstep.

The ring is one `torch.autograd.Function`. Its forward saves q, k, v, the
output and the global lse only. Its backward is a second ring: dK and dV
accumulate in f32 and travel WITH their K/V shard, coming home on the n-th
hop with every rank's contribution; each pair's gradients come from the
flash backward given the GLOBAL out and lse, so p = exp(s - lse) is the
whole row's softmax and delta = rowsum(out * dout) is the global one (the
kernels compute it in place from out and dout); dQ accumulates locally.
Pairs merge through log-sum-exp statistics in f32
(ops/online_softmax.py `merge_normalized`).

Per pair: on CUDA tensors the flash kernels (kernels/flash_attention.py)
at `_resolve_pair_plan`'s blocks, and a shard length the kernels cannot
tile raises (no slower path on the card); on CPU tensors the plain pair
of JAX's jnp path (`_pair_fwd_plain`, `_pair_bwd_plain`: blockwise online
softmax over the visiting shard's blocks). The forward's pairs go through
the `midgpt::flash_fwd` op, so a remat policy that keeps it keeps them.

A hop is `batch_isend_irecv`: each rank sends its buffer to rank g+1 of
the sp group and receives rank g-1's. Over gloo, and only there, CUDA
buffers travel through host memory: gloo's send and receive refuse CUDA
tensors (torch 2.11 on the H100 machine), though its collectives take
them. NCCL sends them as they are. `HOPS` counts the hops and their
bytes.
"""

from __future__ import annotations

import collections
import math
import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.kernels import flash_attention as fa
from midgpt_tpu_torch.ops.attention import flash_block_sizes
from midgpt_tpu_torch.ops.online_softmax import M_INIT, MASK, finalize, merge_normalized, online_block

Tensor = torch.Tensor

# hops made by this process and the bytes each sent ("fwd" and "bwd")
HOPS: tp.Counter[str] = collections.Counter()


def _kernel_serves(Tl: int, block_size: int) -> bool:
    """The flash kernels tile this shard length at this block."""
    bq, bk = flash_block_sizes(Tl, block_size)
    return Tl % bq == 0 and Tl % bk == 0


def _divisor_block(Tl: int, block_size: int) -> int:
    blk = min(block_size, Tl)
    if Tl % blk:
        blk = max(d for d in range(1, blk + 1) if Tl % d == 0)
    return blk


def _resolve_pair_plan(Tl: int, block_size: int, use_kernel: bool) -> tp.Tuple[bool, int]:
    """(use_kernel, block_size) for this shard length, JAX's choice: the
    configured block when the kernels tile Tl with it, else the largest
    8-aligned divisor of Tl in [128, block_size] that they tile. Where none
    exists JAX falls back to its jnp pair; the port's kernels path raises
    instead. A pure function of its arguments, so the forward and backward
    rings agree."""
    if not use_kernel:
        return False, block_size
    if _kernel_serves(Tl, block_size):
        return True, block_size
    for d in range(min(block_size, Tl), 127, -1):
        if Tl % d == 0 and d % 8 == 0 and _kernel_serves(Tl, d):
            return True, d
    divisors = [d for d in range(8, Tl + 1) if Tl % d == 0 and d % 8 == 0]
    hint = f"e.g. attn_block_size={max(divisors)}" if divisors else "change the sequence shard length"
    raise ValueError(
        f"ring attention: shard length {Tl} is not tileable by attn_block_size={block_size} and has no "
        f"kernel-servable divisor >= 128; pick a block that divides the shard ({hint})"
    )


# ----------------------------------------------------------------------
# one pair: the local queries against one visiting K/V shard
# ----------------------------------------------------------------------


def _pair_fwd_plain(q: Tensor, k: Tensor, v: Tensor, causal: bool, block_size: int) -> tp.Tuple[Tensor, Tensor]:
    """JAX's `_pair_fwd_jnp`: blockwise online softmax over the visiting
    shard's blocks -> (out (B, H, Tl, C), lse (B, H, Tl) f32)."""
    B, H, Tl, C = q.shape
    scale = 1.0 / math.sqrt(C)
    blk = _divisor_block(Tl, block_size)
    rows = torch.arange(Tl, device=q.device)[:, None]
    cols = torch.arange(blk, device=q.device)[None, :]
    m = torch.full((B, H, Tl), M_INIT, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, C), dtype=torch.float32, device=q.device)
    for c0 in range(0, Tl, blk):
        k_blk, v_blk = k[:, :, c0:c0 + blk], v[:, :, c0:c0 + blk]
        s = torch.einsum("bhqc,bhkc->bhqk", q, k_blk).float() * scale
        if causal:
            s = torch.where(rows >= c0 + cols, s, MASK)
        m, alpha, p, l = online_block(m, l, s)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkc->bhqc", p.to(v_blk.dtype), v_blk).float()
    # every row has >= 1 visible key in both pair cases (diagonal: itself)
    return finalize(m, l, acc, dtype=q.dtype)


def _pair_bwd_plain(q, k, v, out, do, lse, delta, causal: bool, block_size: int) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """JAX's `_pair_bwd_jnp`: the pair's (dq, dk, dv) in f32 from the global
    statistics (p = exp(s - lse), delta), blockwise over the visiting
    shard's blocks."""
    B, H, Tl, C = q.shape
    scale = 1.0 / math.sqrt(C)
    blk = _divisor_block(Tl, block_size)
    rows = torch.arange(Tl, device=q.device)[:, None]
    cols = torch.arange(blk, device=q.device)[None, :]
    dq = torch.zeros((B, H, Tl, C), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, Tl, blk):
        k_blk, v_blk = k[:, :, c0:c0 + blk], v[:, :, c0:c0 + blk]
        s = torch.einsum("bhqc,bhkc->bhqk", q, k_blk).float() * scale
        if causal:
            s = torch.where(rows >= c0 + cols, s, MASK)
        p = torch.exp(s - lse[..., None])  # masked entries underflow to 0
        dvs.append(torch.einsum("bhqk,bhqc->bhkc", p.to(do.dtype), do))
        dp = torch.einsum("bhqc,bhkc->bhqk", do, v_blk).float()
        ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + torch.einsum("bhqk,bhkc->bhqc", ds, k_blk).float()
        dks.append(torch.einsum("bhqk,bhqc->bhkc", ds, q))
    return dq, torch.cat(dks, dim=2).float(), torch.cat(dvs, dim=2).float()


def _flat(t: Tensor) -> Tensor:
    B, H, T, C = t.shape
    return t.reshape(B * H, T, C)


def _pair_fwd(q, k, v, causal: bool, block_size: int, use_kernel: bool) -> tp.Tuple[Tensor, Tensor]:
    if not use_kernel:
        return _pair_fwd_plain(q, k, v, causal, block_size)
    B, H, Tl, C = q.shape
    bq, bk = flash_block_sizes(Tl, block_size)
    out, lse = fa.flash_fwd_op(_flat(q), _flat(k), _flat(v), bq, bk, causal)
    return out.reshape(B, H, Tl, C), lse.reshape(B, H, Tl)


def _pair_bwd(q, k, v, out, do, lse, delta, causal: bool, block_size: int,
              use_kernel: bool) -> tp.Tuple[Tensor, Tensor, Tensor]:
    if not use_kernel:
        return _pair_bwd_plain(q, k, v, out, do, lse, delta, causal, block_size)
    shape = q.shape
    bq, bk = flash_block_sizes(shape[2], block_size)
    grads = fa.flash_backward(_flat(q), _flat(k), _flat(v), _flat(out), lse.reshape(-1, shape[2]), _flat(do),
                              bq, bk, causal)
    return tuple(g.reshape(shape).float() for g in grads)


# ----------------------------------------------------------------------
# the ring
# ----------------------------------------------------------------------


def _hop(bufs: tp.Sequence[Tensor], group, phase: str) -> tp.List[Tensor]:
    """Each buffer sent to the next rank of `group`, the previous rank's
    received in its place (one message per buffer, told apart by tag)."""
    n, g = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (g + 1) % n)
    src = dist.get_global_rank(group, (g - 1) % n)
    host = bufs[0].is_cuda and dist.get_backend(group) == "gloo"
    sends = [b.to("cpu") if host else b.contiguous() for b in bufs]
    recvs = [torch.empty_like(t) for t in sends]
    ops = []
    for tag, (t, r) in enumerate(zip(sends, recvs)):
        ops += [dist.P2POp(dist.isend, t, dst, group, tag), dist.P2POp(dist.irecv, r, src, group, tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    HOPS[phase] += 1
    HOPS[f"{phase}_bytes"] += sum(t.numel() * t.element_size() for t in sends)
    return [r.to(b.device, non_blocking=False) if host else r for r, b in zip(recvs, bufs)]


def _group_place(group) -> tp.Tuple[int, int]:
    """(n, g): the group's size and this rank's place (1, 0 without one)."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, group, block_size: int) -> Tensor:
        n, g = _group_place(group)
        use_kernel, block_size = _resolve_pair_plan(q.shape[2], block_size, q.is_cuda)
        # the diagonal pair: causal attention on the local shard
        out, lse = _pair_fwd(q, k, v, True, block_size, use_kernel)
        if n > 1:
            m, l, acc = lse, torch.ones_like(lse), out.float()
            kv = torch.stack((k, v))
            for s in range(1, n):
                kv = _hop([kv], group, "fwd")[0]
                j = (g - s) % n  # the visiting shard's place in the sequence
                o_s, lse_s = _pair_fwd(q, kv[0], kv[1], False, block_size, use_kernel)
                if j > g:  # a later shard: its weight underflows to exactly 0
                    lse_s = torch.full_like(lse_s, MASK)
                m, l, acc = merge_normalized(m, l, acc, o_s, lse_s)
            # l >= exp(lse_d - m) > 0 (the diagonal seeds the sum): finalize's guards are no-ops
            out, lse = finalize(m, l, acc, dtype=q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.block_size = group, block_size
        return out

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        group, block_size = ctx.group, ctx.block_size
        n, g = _group_place(group)
        use_kernel, block_size = _resolve_pair_plan(q.shape[2], block_size, q.is_cuda)
        do = do.contiguous()
        # the global softmax's correction (the kernels compute it in place from out and do)
        delta = None if use_kernel else (out.float() * do.float()).sum(dim=-1)
        dq, dk, dv = _pair_bwd(q, k, v, out, do, lse, delta, True, block_size, use_kernel)
        if n > 1:
            kv, dkv = torch.stack((k, v)), torch.stack((dk, dv))
            for s in range(1, n):
                # dK/dV ride with their K/V shard
                kv, dkv = _hop([kv, dkv], group, "bwd")
                j = (g - s) % n
                dq_s, dk_s, dv_s = _pair_bwd(q, kv[0], kv[1], out, do, lse, delta, False, block_size, use_kernel)
                if j < g:
                    dq = dq + dq_s
                    dkv = dkv + torch.stack((dk_s, dv_s))
            dk, dv = _hop([dkv], group, "bwd")[0]  # the n-th hop: home
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q: Tensor, k: Tensor, v: Tensor, group, block_size: int = 1024) -> Tensor:
    """Causal attention across the sp `group` (a process group, or None for
    one rank): q, k, v are this rank's (B, H, Tl, C) shards, contiguous
    sequence chunks in group order; returns its (B, H, Tl, C) output
    shard, differentiable. Every rank of the group calls it together."""
    return _Ring.apply(q, k, v, group, block_size)
