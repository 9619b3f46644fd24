"""Flash attention with its backward (counterpart of
midgpt_tpu/kernels/flash_attention.py), causal or full.

The JAX package runs six Pallas bodies behind one `jax.custom_vjp`: the
forward's single-visit and tiled bodies, and the backward's fused body, its
single-visit and tiled dQ bodies and the tiled dK/dV body. The dispatch
between them is the tile policy `_block_sizes(T, block_q, block_k)`: one KV
block (`T // bk == 1`) is the single-visit path, several are the tiled
path, and a fused backward needs `T <= 1024` besides. This port keeps that
policy as its contract, and carries:

  * `flash_forward_plain` / `flash_backward_plain`: the plain PyTorch
    version, with the TPU bodies' rounding points (f32 score dots scaled
    after the dot, finite MASK, p rounded to V's dtype before PV, the
    online recurrence over block_k chunks on the tiled path; p rounded to
    dO's dtype before dV, delta = rowsum(O * dO) in f32, ds rounded to q's
    dtype before dQ and dK);
  * the CUDA kernels of `csrc/flash_attention.cu` (`flash_fwd` for bodies
    1-2, `flash_bwd_dq` for body 3's dQ and bodies 4-5, `flash_bwd_dkv` for
    body 3's dK/dV and body 6), launched by `flash_forward` /
    `flash_backward` for CUDA tensors. bfloat16 inputs take the tensor-core
    kernels: mma.sync bf16 products with f32 accumulators, bf16 tiles in
    padded shared memory read by ldmatrix, and K/V (forward, dQ) or Q/dO/O
    (dK/dV) tiles copied by cp.async in a two-stage ring, each warp owning
    16 rows. The rounding points above are the operand conversions the
    tensor cores need anyway: p and ds are rounded to bf16 where the score
    fragment is repacked, in registers, as the next product's operand. At
    the main path's shape the work (25.8-51.6 GFLOP per kernel) and the bytes
    (each tensor read or written once) bound the kernels about equally
    (chip_smoke.flash_bounds); the kernels add the forward's second Q.K^T
    and the backward's recomputed Q.K^T. float32 inputs keep the SIMT
    kernels with f32 FMAs: the tensor cores take f32 only as TF32, three
    decimal digits, and the f32 path is held to 1e-5. The source note says
    more;
  * `flash_attention(q, k, v, block_q, block_k)`, the `autograd.Function`
    over (B, H, T, C) that saves q, k, v, out and lse for the backward, as
    the JAX forward rule does. Its forward calls `flash_fwd_op`, the
    forward as one dispatcher op (`midgpt::flash_fwd`), which a remat
    policy can keep (ops/remat.py) as JAX's names `attn_out`/`attn_lse`.

Every function takes JAX's static `causal` (default True). causal=False
is full attention, no element mask: ring attention's off-diagonal pairs
(parallel/ring_attention.py), where the causal structure is decided per
pair of sequence shards. The kernels are the same sources' `Causal = false`
instantiations.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels or
raises — there is no fallback between the two. Each kernel has a launch
counter per causal flag (`FWD_LAUNCHES` ..., `FULL_FWD_LAUNCHES` ... for
causal=False) keyed by the dispatch it stands for: "single" or "tiled" (for
dK/dV, "single" is the fused backward, reached at T <= 1024 only).
"""

from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from midgpt_tpu_torch.kernels.build import LaunchCounter, load
from midgpt_tpu_torch.ops.online_softmax import M_INIT, MASK, finalize, online_block

Tensor = torch.Tensor

FWD_LAUNCHES = LaunchCounter("flash_fwd")
BWD_DQ_LAUNCHES = LaunchCounter("flash_bwd_dq")
BWD_DKV_LAUNCHES = LaunchCounter("flash_bwd_dkv")
FULL_FWD_LAUNCHES = LaunchCounter("flash_fwd_full")  # causal=False
FULL_BWD_DQ_LAUNCHES = LaunchCounter("flash_bwd_dq_full")
FULL_BWD_DKV_LAUNCHES = LaunchCounter("flash_bwd_dkv_full")
_COUNTERS = {True: (FWD_LAUNCHES, BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES),
             False: (FULL_FWD_LAUNCHES, FULL_BWD_DQ_LAUNCHES, FULL_BWD_DKV_LAUNCHES)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)  # csrc/flash_attention.cu instantiations


def _block_sizes(T: int, block_q: int, block_k: int) -> tp.Tuple[int, int]:
    """Clamp requested block sizes to ones that tile T exactly (the JAX
    kernel's policy, kept as the port's contract): requested blocks are
    honored when they divide T; otherwise the KV block widens to the whole
    sequence and the Q block falls back to the KV block. Widened blocks past
    bq * bk = 1M elements raise, as on the TPU, so both packages accept and
    refuse the same (T, block_q, block_k)."""
    bq = min(block_q, T)
    bk = min(block_k, T)
    if T % bk:
        bk = T
    if T % bq:
        bq = bk
    if bq * bk > 1024 * 1024:
        raise ValueError(
            f"blocks ({bq}, {bk}) for seq len {T} need a {bq}x{bk} f32 "
            "score tile that cannot fit VMEM; pass block sizes that divide "
            "T (or use the blockwise path)"
        )
    return bq, bk


def _variants(T: int, bk: int) -> tp.Tuple[str, str, str]:
    """(forward, dQ, dK/dV) dispatch names for a sequence of T in KV blocks
    of bk: the TPU body each kernel launch stands for."""
    single = T // bk == 1
    fwd = dq = "single" if single else "tiled"
    dkv = "single" if single and T <= 1024 else "tiled"
    return fwd, dq, dkv


def _visible(T: int, device, causal: bool) -> tp.Optional[Tensor]:
    """The (T, T) mask of visible (row, col) pairs: col <= row when causal;
    None (every pair) when not."""
    if not causal:
        return None
    rows = torch.arange(T, device=device)
    return rows[None, :] <= rows[:, None]


# ----------------------------------------------------------------------
# plain PyTorch version
# ----------------------------------------------------------------------


def flash_forward_plain(
    q: Tensor, k: Tensor, v: Tensor, block_q: int = 512, block_k: int = 1024, causal: bool = True
) -> tp.Tuple[Tensor, Tensor]:
    """q, k, v (N, T, C) -> (out (N, T, C) in q's dtype, lse (N, T) f32).

    Single visit (T // bk == 1): one softmax over the whole row, p =
    exp(s - m_final). Tiled: the online recurrence over KV chunks of bk
    columns, p = exp(s - m_running), the accumulator rescaled in f32. The
    TPU's Q tiling (bq) changes nothing per row: a chunk above a row's
    diagonal is all MASK there and leaves (m, l, acc) bit for bit as they
    were, so every row visits every chunk here. causal=False masks
    nothing."""
    N, T, C = q.shape
    _, bk = _block_sizes(T, block_q, block_k)
    scale = 1.0 / math.sqrt(C)
    qf = q.float()
    keep = _visible(T, q.device, causal)
    m = torch.full((N, T), M_INIT, dtype=torch.float32, device=q.device)
    l = torch.zeros((N, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((N, T, C), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, bk):
        kc, vc = k[:, c0 : c0 + bk], v[:, c0 : c0 + bk]
        s = torch.einsum("ntc,nsc->nts", qf, kc.float()) * scale
        if keep is not None:
            s = torch.where(keep[:, c0 : c0 + bk], s, MASK)
        m, alpha, p, l = online_block(m, l, s)
        pv = torch.einsum("nts,nsc->ntc", p.to(v.dtype).float(), vc.float())
        acc = acc * alpha[..., None] + pv
    return finalize(m, l, acc, dtype=q.dtype)


def flash_backward_plain(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
    block_q: int = 512, block_k: int = 1024, causal: bool = True,
) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv), each (N, T, C) in the inputs' dtype. The TPU's fused,
    single-visit and tiled backward bodies round at the same elementwise
    points and differ only in the order of their f32 sums, so one dense
    reconstruction stands for all of them."""
    N, T, C = q.shape
    _block_sizes(T, block_q, block_k)  # the same refusals as the kernels
    scale = 1.0 / math.sqrt(C)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("ntc,nsc->nts", qf, kf) * scale
    keep = _visible(T, q.device, causal)
    if keep is not None:
        s = torch.where(keep, s, MASK)
    p = torch.exp(s - lse[..., None])  # masked entries underflow to 0
    dv = torch.einsum("nts,ntc->nsc", p.to(dout.dtype).float(), dof)
    dp = torch.einsum("ntc,nsc->nts", dof, vf)
    delta = (out.float() * dof).sum(dim=-1)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("nts,nsc->ntc", ds, kf)
    dk = torch.einsum("nts,ntc->nsc", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------


def _kernel_lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    if lib.flash_fwd.argtypes is None:  # declare once per loaded library
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [vp] * 5 + [ci] * 4 + [cf, ci, ci, vp]
        lib.flash_bwd_dq.argtypes = [vp] * 7 + [ci] * 3 + [cf, ci, ci, vp]
        lib.flash_bwd_dkv.argtypes = [vp] * 8 + [ci] * 3 + [cf, ci, ci, vp]
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ci
        lib.flash_error_string.argtypes = [ci]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(*named: tp.Tuple[str, Tensor]) -> None:
    """The kernels take contiguous (N, T, C) tensors of one dtype (f32 or
    bf16) on one CUDA device, with C in {64, 128}, each starting on a
    16-byte boundary (the bf16 kernels copy and read 16-byte row pieces)."""
    (_, q), *rest = named
    if q.dim() != 3:
        raise ValueError(f"flash kernels take (N, T, C) tensors, got q {tuple(q.shape)}")
    C = q.shape[2]
    if C not in _HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernels are built for head_dim {_HEAD_DIMS}, got {C}"
        )
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"the flash kernels take float32 or bfloat16, got {q.dtype}")
    for name, t in rest:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary (data_ptr {t.data_ptr():#x})")


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.flash_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def _launch_forward(q, k, v, block_q, block_k, causal: bool) -> tp.Tuple[Tensor, Tensor]:
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_args(("q", q), ("k", k), ("v", v))
    N, T, C = q.shape
    _, bk = _block_sizes(T, block_q, block_k)
    out = torch.empty_like(q)
    lse = torch.empty((N, T), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            N, T, C, bk, 1.0 / math.sqrt(C), _DTYPE_CODE[q.dtype], int(causal), stream,
        )
    _raise_on(lib, rc, "flash_fwd")
    _COUNTERS[causal][0].add(_variants(T, bk)[0])
    return out, lse


def _check_backward(q, k, v, out, lse, dout):
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    _check_args(("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout))
    N, T, _ = q.shape
    lse = lse.contiguous()
    if lse.shape != (N, T) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 (N, T) = {(N, T)} on {q.device}")
    return q, k, v, out, lse, dout


def _launch_bwd_dq(q, k, v, out, lse, dout, variant: str, causal: bool = True) -> Tensor:
    """flash_bwd_dq on checked, contiguous inputs (see _check_backward)."""
    N, T, C = q.shape
    dq = torch.empty_like(q)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dq(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse)), dq.data_ptr(),
            N, T, C, 1.0 / math.sqrt(C), _DTYPE_CODE[q.dtype], int(causal), stream,
        )
    _raise_on(lib, rc, "flash_bwd_dq")
    _COUNTERS[causal][1].add(variant)
    return dq


def _launch_bwd_dkv(q, k, v, out, lse, dout, variant: str, causal: bool = True) -> tp.Tuple[Tensor, Tensor]:
    """flash_bwd_dkv on checked, contiguous inputs (see _check_backward)."""
    N, T, C = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dkv(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse)), dk.data_ptr(), dv.data_ptr(),
            N, T, C, 1.0 / math.sqrt(C), _DTYPE_CODE[q.dtype], int(causal), stream,
        )
    _raise_on(lib, rc, "flash_bwd_dkv")
    _COUNTERS[causal][2].add(variant)
    return dk, dv


def _launch_backward(q, k, v, out, lse, dout, block_q, block_k, causal: bool) -> tp.Tuple[Tensor, Tensor, Tensor]:
    args = _check_backward(q, k, v, out, lse, dout)
    T = args[0].shape[1]
    _, v_dq, v_dkv = _variants(T, _block_sizes(T, block_q, block_k)[1])
    dq = _launch_bwd_dq(*args, v_dq, causal)
    dk, dv = _launch_bwd_dkv(*args, v_dkv, causal)
    return dq, dk, dv


def _device_check(t: Tensor) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"no flash-attention kernel for device {t.device}")


def flash_forward(
    q: Tensor, k: Tensor, v: Tensor, block_q: int = 512, block_k: int = 1024, causal: bool = True
) -> tp.Tuple[Tensor, Tensor]:
    """(out, lse) of (N, T, C) inputs: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _device_check(q)
    if q.is_cuda:
        return _launch_forward(q, k, v, block_q, block_k, causal)
    return flash_forward_plain(q, k, v, block_q, block_k, causal)


def flash_backward(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
    block_q: int = 512, block_k: int = 1024, causal: bool = True,
) -> tp.Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv): the two CUDA backward kernels for CUDA tensors, the
    plain version for CPU tensors. delta = rowsum(out * dout) is computed
    from `out` and `dout` inside, so a caller whose `out` and `lse` are a
    larger softmax's (ring attention's global ones) gets that softmax's
    gradient restricted to these keys."""
    _device_check(q)
    if q.is_cuda:
        return _launch_backward(q, k, v, out, lse, dout, block_q, block_k, causal)
    return flash_backward_plain(q, k, v, out, lse, dout, block_q, block_k, causal)


@torch.library.custom_op("midgpt::flash_fwd", mutates_args=())
def flash_fwd_op(q: Tensor, k: Tensor, v: Tensor, block_q: int, block_k: int,
                 causal: bool = True) -> tp.Tuple[Tensor, Tensor]:
    """`flash_forward` as one dispatcher op, so a remat policy
    (ops/remat.py) sees the forward kernel — a ctypes launch is invisible
    to the dispatcher — and can keep its (out, lse) instead of launching it
    again in the backward's recompute."""
    return flash_forward(q, k, v, block_q, block_k, causal)


class _FlashAttention(torch.autograd.Function):
    """Residuals q, k, v, out, lse saved by the forward (the JAX `_fwd_rule`);
    the backward never re-runs the forward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k, causal=True):
        B, H, T, C = q.shape
        flat = [t.reshape(B * H, T, C) for t in (q, k, v)]
        out, lse = flash_fwd_op(*flat, block_q, block_k, causal)
        ctx.save_for_backward(*flat, out, lse)
        ctx.blocks = (block_q, block_k, causal)
        return out.reshape(B, H, T, C)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.reshape(q.shape), *ctx.blocks)
        shape = g.shape
        return dq.reshape(shape), dk.reshape(shape), dv.reshape(shape), None, None, None


def flash_attention(
    q: Tensor, k: Tensor, v: Tensor, block_q: int = 512, block_k: int = 1024, causal: bool = True
) -> Tensor:
    """Flash attention over (B, H, T, C), causal unless told otherwise,
    differentiable. Block sizes that do not tile T are adjusted by
    `_block_sizes` (KV block widens to T, Q block falls back to the KV
    block) rather than raising."""
    return _FlashAttention.apply(q, k, v, block_q, block_k, causal)
