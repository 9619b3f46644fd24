"""Paged-attention template, decode spec (counterpart of
midgpt_tpu/kernels/attention_template.py).

The JAX template is one Pallas kernel body (`_tpl_kernel`) instantiated for
several specs: query rows per slot (decode R = 1, speculative verify
R = k+1), int8 pages, split-K partitions, the GQA fold and the sliding
window. This port carries the DECODE spec — R = 1, bf16/f32 pool, MHA,
split_k in {1, 2, 4, 8} — as:

  * `paged_attention_template_plain`: the plain PyTorch version, a
    per-page online-softmax loop with the template's rounding points (f32
    score dots scaled after the dot, finite MASK past the count, f32
    running stats, p rounded to V's dtype before the PV product, in-place
    finalize for split 1 or f32 partials merged outside for split > 1);
  * the CUDA kernel `csrc/paged_attention.cu` (source note there: what it
    replaces, what bounds it, and its design), launched by
    `paged_attention_template` for CUDA tensors.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback between the two. The other specs (verify,
int8, GQA, window) are still to be ported (ROADMAP.md, port queue) and
raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
import math

import torch

from midgpt_tpu_torch.kernels.build import LaunchCounter, load
from midgpt_tpu_torch.ops.online_softmax import M_INIT, MASK, finalize, merge_partials, online_block

Tensor = torch.Tensor

# Launches of the CUDA kernel, keyed by the (normalized) split factor.
LAUNCHES = LaunchCounter("paged_attention_decode")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 512  # csrc/paged_attention.cu: kThreads * kMaxChan


def normalize_split_k(split_k: int, max_pages: int) -> int:
    """Largest pow2 <= split_k that divides the page-table width."""
    s = max(1, int(split_k))
    s = min(s, max_pages)
    s = 1 << (s.bit_length() - 1)  # pow2 floor (applied after the clamp)
    while max_pages % s:
        s //= 2
    return s


def paged_attention_template_plain(
    q: Tensor,  # (B, H, R, C) head-major query rows
    k_pages: Tensor,  # (H, num_pages, page_size, C) — ONE layer's pool
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    counts: Tensor,  # (B, R) int — keys visible to row r of slot b
    split_k: int = 1,
) -> Tensor:
    """Plain PyTorch version of the template (any R, MHA): all slots and
    partitions advance together, one logical page per step. Returns
    (B, H, R, C) in q.dtype."""
    B, H, R, C = q.shape
    ps = k_pages.shape[2]
    max_pages = page_table.shape[1]
    split_k = normalize_split_k(split_k, max_pages)
    pps = max_pages // split_k
    scale = 1.0 / math.sqrt(C)
    dev = q.device
    table = page_table.reshape(B, split_k, pps).long()
    counts = counts.long()
    m = torch.full((B, split_k, H, R), M_INIT, dtype=torch.float32, device=dev)
    l = torch.zeros((B, split_k, H, R), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, split_k, H, R, C), dtype=torch.float32, device=dev)
    qf = q.float()
    part0 = torch.arange(split_k, device=dev) * pps
    cols = torch.arange(ps, device=dev)
    for p in range(pps):
        idx = table[:, :, p]  # (B, split_k) physical pages
        k = k_pages[:, idx]  # (H, B, split_k, ps, C)
        v = v_pages[:, idx]
        page0 = (part0 + p) * ps  # (split_k,)
        # f32 dots (bf16 products are exact in f32), scaled after the dot
        s = torch.einsum("bhrc,hbspc->bshrp", qf, k.float()) * scale
        col = page0[None, :, None, None, None] + cols  # (1, s, 1, 1, ps)
        s = torch.where(col < counts[:, None, None, :, None], s, MASK)
        m_new, alpha, prob, l_new = online_block(m, l, s)
        pv = torch.einsum(
            "bshrp,hbspc->bshrc", prob.to(v.dtype).float(), v.float()
        )
        acc_new = acc * alpha[..., None] + pv
        # pages past the last row's count are skipped (pl.when in the kernel)
        live = (page0[None, :] < counts[:, None, R - 1])[:, :, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    if split_k == 1:
        out, _ = finalize(m[:, 0], l[:, 0], acc[:, 0])
        return out.to(q.dtype)
    m, l, acc = merge_partials(m, l, acc, axis=1)
    out, _ = finalize(m, l, acc)
    return out.to(q.dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = load("paged_attention")
    fn = lib.paged_attention_decode
    if fn.argtypes is None:  # declare once per loaded library
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [ci] * 7 + [ctypes.c_float, ci, vp]
        fn.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_decode_args(q, k_pages, v_pages, page_table, counts) -> None:
    B, H, R, C = q.shape
    if R != 1:
        raise NotImplementedError(
            f"paged attention with {R} query rows per slot is the template's "
            "verify spec, not ported yet (ROADMAP.md port queue: template "
            "specs)"
        )
    if k_pages.shape[0] != H:
        raise NotImplementedError(
            "GQA/MQA (fewer pool heads than query heads) is a template spec "
            "not ported yet (ROADMAP.md port queue: template specs)"
        )
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise NotImplementedError(
            f"paged decode kernel takes float32 or bfloat16 q/pools of one "
            f"dtype, got q {q.dtype}, pools {k_pages.dtype}/{v_pages.dtype} "
            "(int8 pages: ROADMAP.md port queue)"
        )
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != C:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    ps = k_pages.shape[2]
    if (ps * C * q.element_size()) % 16 or C > _MAX_C:
        raise ValueError(
            f"page_size * head_dim * itemsize must be a multiple of 16 bytes and "
            f"head_dim <= {_MAX_C} (got page_size {ps}, head_dim {C})"
        )
    if page_table.shape[0] != B or counts.shape != (B, R):
        raise ValueError("page_table / counts do not match the slot count")
    if B > 65535:
        raise ValueError(f"{B} slots exceed the kernel grid's slot axis")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("counts", counts)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch_decode(q, k_pages, v_pages, page_table, counts, split_k) -> Tensor:
    """Launch csrc/paged_attention.cu on q (B, H, 1, C); returns (B, H, 1, C)."""
    _check_decode_args(q, k_pages, v_pages, page_table, counts)
    B, H, _, C = q.shape
    _, P, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    split_k = normalize_split_k(split_k, max_pages)
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    cnt = counts.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    if split_k == 1:
        out = torch.empty_like(q)
        acc = m = l = None
    else:
        out = None
        acc = torch.empty((B, split_k, H, C), **f32)
        m = torch.empty((B, split_k, H), **f32)
        l = torch.empty((B, split_k, H), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_decode(
            ptr(q), ptr(k_pages), ptr(v_pages), ptr(pt), ptr(cnt), ptr(out),
            ptr(acc), ptr(m), ptr(l), B, H, P, ps, C, max_pages, split_k,
            1.0 / math.sqrt(C), _DTYPE_CODE[q.dtype], stream,
        )
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention_decode launch failed: {msg} ({rc})")
    LAUNCHES.add(split_k)
    if split_k == 1:
        return out
    m, l, acc = merge_partials(m, l, acc, axis=1)
    merged, _ = finalize(m, l, acc)
    return merged.to(q.dtype)[:, :, None, :]


def paged_attention_template(
    q: Tensor,  # (B, H, R, C)
    k_pages: Tensor,  # (H, num_pages, page_size, C)
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    counts: Tensor,  # (B, R) int
    split_k: int = 1,
) -> Tensor:
    """Instantiate the template: the plain version for CPU tensors, the
    CUDA kernel (decode spec) for CUDA tensors. Returns (B, H, R, C) in
    q.dtype."""
    if q.is_cuda:
        return _launch_decode(q, k_pages, v_pages, page_table, counts, split_k)
    if q.device.type != "cpu":
        raise NotImplementedError(f"no paged-attention kernel for device {q.device}")
    return paged_attention_template_plain(q, k_pages, v_pages, page_table, counts, split_k)
