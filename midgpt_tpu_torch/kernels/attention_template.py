"""Paged-attention template, decode, verify and int8 specs (counterpart of
midgpt_tpu/kernels/attention_template.py).

The JAX template is one Pallas kernel body (`_tpl_kernel`) instantiated for
several specs: query rows per slot (decode R = 1, speculative verify
R = k+1), int8 pages, split-K partitions, the GQA fold and the sliding
window. This port carries the DECODE and VERIFY specs — any R up to 16 rows
per slot, each row masked to its own count (counts nondecreasing per slot),
bf16/f32/int8 pool, MHA, split_k in {1, 2, 4, 8}, the query in its own dtype
over the pool's (an f32 query over a bf16 pool is served in f32, as JAX's
promoting dots do) — as:

  * `paged_attention_template_plain`: the plain PyTorch version, a
    per-page online-softmax loop with the template's rounding points (f32
    score dots scaled after the dot, finite MASK past each row's count, f32
    running stats, p rounded to V's dtype before the PV product — for int8
    pools K and V are dequantized to f32 and p stays f32 — in-place
    finalize for split 1 or f32 partials merged outside for split > 1);
  * the CUDA kernel `csrc/paged_attention.cu` (source note there: what it
    replaces, what bounds it, and its design), launched by
    `paged_attention_template` for CUDA tensors.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback between the two. The GQA fold and the sliding
window are still to be ported (ROADMAP.md, port queue) and raise
NotImplementedError (the window at GPTConfig).
"""

from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from midgpt_tpu_torch.kernels.build import LaunchCounter, load
from midgpt_tpu_torch.ops.online_softmax import M_INIT, MASK, finalize, merge_partials, online_block

Tensor = torch.Tensor

# Launches of the CUDA kernel, keyed by (spec, normalized split factor):
# spec "decode" (R = 1) or "verify" (R > 1), prefixed "int8-" over int8 pools.
LAUNCHES = LaunchCounter("paged_attention")

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_ROWS = 16  # csrc/paged_attention.cu: kMaxRows
_MAX_C = 512  # csrc/paged_attention.cu: kMaxChan


def normalize_split_k(split_k: int, max_pages: int) -> int:
    """Largest pow2 <= split_k that divides the page-table width."""
    s = max(1, int(split_k))
    s = min(s, max_pages)
    s = 1 << (s.bit_length() - 1)  # pow2 floor (applied after the clamp)
    while max_pages % s:
        s //= 2
    return s


def spec_name(n_rows: int, quantized: bool) -> str:
    """The LaunchCounter key's spec: decode / verify, int8- over int8 pools."""
    return ("int8-" if quantized else "") + ("decode" if n_rows == 1 else "verify")


def paged_attention_template_plain(
    q: Tensor,  # (B, H, R, C) head-major query rows
    k_pages: Tensor,  # (H, num_pages, page_size, C) — ONE layer's pool
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    counts: Tensor,  # (B, R) int — keys visible to row r of slot b, nondecreasing
    k_scale: tp.Optional[Tensor] = None,  # (num_pages, H, page_size) f32, int8 pools
    v_scale: tp.Optional[Tensor] = None,
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
    quantized = k_scale is not None
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
        k = k_pages[:, idx].float()  # (H, B, split_k, ps, C)
        v = v_pages[:, idx].float()
        if quantized:  # int8 x f32 scale, the page's (H, ps) scale row
            k = k * k_scale[idx].permute(2, 0, 1, 3)[..., None]
            v = v * v_scale[idx].permute(2, 0, 1, 3)[..., None]
        page0 = (part0 + p) * ps  # (split_k,)
        # f32 dots (bf16 products are exact in f32), scaled after the dot
        s = torch.einsum("bhrc,hbspc->bshrp", qf, k) * scale
        col = page0[None, :, None, None, None] + cols  # (1, s, 1, 1, ps)
        s = torch.where(col < counts[:, None, None, :, None], s, MASK)
        m_new, alpha, prob, l_new = online_block(m, l, s)
        if not quantized:  # p rounded to the pool's dtype; int8 pools keep f32 p
            prob = prob.to(v_pages.dtype).float()
        pv = torch.einsum("bshrp,hbspc->bshrc", prob, v)
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
    fn = lib.paged_attention
    if fn.argtypes is None:  # declare once per loaded library
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [ci] * 8 + [ctypes.c_float, ci, ci, vp]
        fn.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(q, k_pages, v_pages, page_table, counts, k_scale, v_scale) -> None:
    B, H, R, C = q.shape
    if k_pages.shape[0] != H:
        raise NotImplementedError(
            "GQA/MQA (fewer pool heads than query heads) is a template spec "
            "not ported yet (ROADMAP.md port queue: template specs GQA/window)"
        )
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"{R} query rows per slot: the kernel takes 1 to {MAX_ROWS}")
    if q.dtype not in _Q_CODE or k_pages.dtype not in _KV_CODE or v_pages.dtype != k_pages.dtype:
        raise NotImplementedError(
            f"paged attention kernel takes a float32 or bfloat16 q over float32, "
            f"bfloat16 or int8 pools of one dtype, got q {q.dtype}, pools "
            f"{k_pages.dtype}/{v_pages.dtype}"
        )
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != C:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    _, P, ps, _ = k_pages.shape
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools take both k_scale and v_scale; bf16/f32 pools take none")
    if quantized:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.shape != (P, H, ps) or s.dtype != torch.float32:
                raise ValueError(
                    f"{name} must be float32 of shape (num_pages, H, page_size) = "
                    f"{(P, H, ps)}, got {s.dtype} {tuple(s.shape)}"
                )
    if (ps * C * k_pages.element_size()) % 16 or C > _MAX_C:
        raise ValueError(
            f"page_size * head_dim * itemsize must be a multiple of 16 bytes and "
            f"head_dim <= {_MAX_C} (got page_size {ps}, head_dim {C}, {k_pages.dtype})"
        )
    if page_table.shape[0] != B or counts.shape != (B, R):
        raise ValueError("page_table / counts do not match the slot and row counts")
    if B > 65535:
        raise ValueError(f"{B} slots exceed the kernel grid's slot axis")
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("page_table", page_table), ("counts", counts)]
    if quantized:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, split_k) -> Tensor:
    """Launch csrc/paged_attention.cu on q (B, H, R, C); returns (B, H, R, C)."""
    _check_args(q, k_pages, v_pages, page_table, counts, k_scale, v_scale)
    B, H, R, C = q.shape
    _, P, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    split_k = normalize_split_k(split_k, max_pages)
    quantized = k_scale is not None
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if quantized:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    cnt = counts.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    if split_k == 1:
        out = torch.empty_like(q)
        acc = m = l = None
    else:
        out = None
        acc = torch.empty((B, split_k, H, R, C), **f32)
        m = torch.empty((B, split_k, H, R), **f32)
        l = torch.empty((B, split_k, H, R), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention(
            ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale), ptr(v_scale), ptr(pt),
            ptr(cnt), ptr(out), ptr(acc), ptr(m), ptr(l), B, H, R, P, ps, C, max_pages,
            split_k, 1.0 / math.sqrt(C), _Q_CODE[q.dtype], _KV_CODE[k_pages.dtype], stream,
        )
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention launch failed: {msg} ({rc})")
    LAUNCHES.add((spec_name(R, quantized), split_k))
    if split_k == 1:
        return out
    m, l, acc = merge_partials(m, l, acc, axis=1)
    merged, _ = finalize(m, l, acc)
    return merged.to(q.dtype)


def paged_attention_template(
    q: Tensor,  # (B, H, R, C)
    k_pages: Tensor,  # (H, num_pages, page_size, C)
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    counts: Tensor,  # (B, R) int
    k_scale: tp.Optional[Tensor] = None,  # (num_pages, H, page_size) f32, int8 pools
    v_scale: tp.Optional[Tensor] = None,
    split_k: int = 1,
) -> Tensor:
    """Instantiate the template: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors. Returns (B, H, R, C) in q.dtype."""
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, split_k)
    if q.device.type != "cpu":
        raise NotImplementedError(f"no paged-attention kernel for device {q.device}")
    if k_pages.shape[0] != q.shape[1]:
        _check_args(q, k_pages, v_pages, page_table, counts, k_scale, v_scale)  # raises: GQA
    return paged_attention_template_plain(
        q, k_pages, v_pages, page_table, counts, k_scale, v_scale, split_k
    )
