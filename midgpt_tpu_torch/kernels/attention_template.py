"""Paged-attention template (counterpart of
midgpt_tpu/kernels/attention_template.py).

The JAX template is one Pallas kernel body (`_tpl_kernel`) instantiated for
several specs: query rows per slot (decode R = 1, speculative verify
R = k+1), int8 pages, split-K partitions, the GQA fold and the sliding
window. This port carries all of them — R rows per slot, each masked to
its own count (counts nondecreasing per slot), bf16/f32/int8 pools,
split_k in {1, 2, 4, 8}, the query in its own dtype over the pool's (an f32
query over a bf16 pool is served in f32, as JAX's promoting dots do):

  * GQA/MQA: q arrives with H_q = G * H_kv heads (query head h reads K/V
    head h // G) and FOLDS into the row axis, (B, H_q, R, C) ->
    (B, H_kv, G*R, C), a free reshape, with the counts tiled G times
    (folded row g*R + r keeps row r's count); the output unfolds. One pass
    over a K/V page serves all G query heads.
  * sliding window + sinks: a row with n visible keys keeps the columns
    [n - W, n) and [0, sinks), and the page sweep skips pages wholly
    behind row 0's window (counts are nondecreasing, so row 0's window
    starts first) that hold no sink token.

Two versions carry it:

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
raises — there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from midgpt_tpu_torch.kernels.build import LaunchCounter, load
from midgpt_tpu_torch.ops.online_softmax import M_INIT, MASK, finalize, merge_partials, online_block

Tensor = torch.Tensor

# Launches of the CUDA kernel, keyed by (spec, normalized split factor);
# `spec_name` gives the spec.
LAUNCHES = LaunchCounter("paged_attention")

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# csrc/paged_attention.cu limits: (folded rows) x head_dim per slot and head
# (kMaxRowChan: the per-thread accumulators), head_dim (kMaxChan), and the
# shared memory of a block with a one-page tile (kSmemMax, kStages)
MAX_ROW_CHANNELS = 8192
_MAX_C = 512
_SMEM_MAX = 227 * 1024
_STAGES = 2


def normalize_split_k(split_k: int, max_pages: int) -> int:
    """Largest pow2 <= split_k that divides the page-table width."""
    s = max(1, int(split_k))
    s = min(s, max_pages)
    s = 1 << (s.bit_length() - 1)  # pow2 floor (applied after the clamp)
    while max_pages % s:
        s //= 2
    return s


def spec_name(n_rows: int, quantized: bool, groups: int = 1, sliding_window: int = 0) -> str:
    """The LaunchCounter key's spec: decode (R = 1) or verify (R > 1 rows
    before the fold), prefixed "gqa-" for a folded launch (G > 1), then
    "window-" under a sliding window, then "int8-" over int8 pools — e.g.
    "window-gqa-verify", "int8-gqa-decode"."""
    name = ("gqa-" if groups > 1 else "") + ("decode" if n_rows == 1 else "verify")
    return ("int8-" if quantized else "") + ("window-" if sliding_window else "") + name


def _fold(q: Tensor, counts: Tensor, kv_heads: int) -> tp.Tuple[Tensor, Tensor, int]:
    """GQA fold: q (B, H_q, R, C) -> (B, H_kv, G*R, C) (a free reshape:
    head h = kv*G + g is contiguous), counts (B, R) tiled to (B, G*R)
    (`repeat`, i.e. jnp.tile: folded row g*R + r keeps row r's count).
    Returns (q, counts, G)."""
    B, HQ, R, C = q.shape
    if HQ % kv_heads:
        raise ValueError(f"{HQ} query heads do not group over {kv_heads} pool heads")
    groups = HQ // kv_heads
    if groups == 1:
        return q, counts, 1
    return q.reshape(B, kv_heads, groups * R, C), counts.repeat(1, groups), groups


def paged_attention_template_plain(
    q: Tensor,  # (B, H_q, R, C) head-major query rows
    k_pages: Tensor,  # (H_kv, num_pages, page_size, C) — ONE layer's pool
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    counts: Tensor,  # (B, R) int — keys visible to row r of slot b, nondecreasing
    k_scale: tp.Optional[Tensor] = None,  # (num_pages, H_kv, page_size) f32, int8 pools
    v_scale: tp.Optional[Tensor] = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Plain PyTorch version of the template (any R, GQA fold, window):
    all slots and partitions advance together, one logical page per step.
    Returns (B, H_q, R, C) in q.dtype."""
    out_shape = q.shape
    q, counts, _ = _fold(q, counts, k_pages.shape[0])
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
        n = counts[:, None, None, :, None]
        keep = col < n
        if sliding_window:  # the window [n - W, n), widened by the sinks [0, S)
            keep = keep & ((col >= n - sliding_window) | (col < attn_sinks))
        s = torch.where(keep, s, MASK)
        m_new, alpha, prob, l_new = online_block(m, l, s)
        if not quantized:  # p rounded to the pool's dtype; int8 pools keep f32 p
            prob = prob.to(v_pages.dtype).float()
        pv = torch.einsum("bshrp,hbspc->bshrc", prob, v)
        acc_new = acc * alpha[..., None] + pv
        # pages past the last row's count are skipped (pl.when in the kernel),
        # and under a window those wholly behind row 0's window with no sink
        live = page0[None, :] < counts[:, None, R - 1]
        if sliding_window:
            ahead = (page0[None, :] + ps > counts[:, None, 0] - sliding_window) | (page0[None, :] < attn_sinks)
            live = live & ahead
        live = live[:, :, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    if split_k == 1:
        out, _ = finalize(m[:, 0], l[:, 0], acc[:, 0])
    else:
        m, l, acc = merge_partials(m, l, acc, axis=1)
        out, _ = finalize(m, l, acc)
    return out.to(q.dtype).reshape(out_shape)


def _kernel_lib() -> ctypes.CDLL:
    lib = load("paged_attention")
    fn = lib.paged_attention
    if fn.argtypes is None:  # declare once per loaded library
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [ci] * 10 + [ctypes.c_float, ci, ci, vp]
        fn.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(rows: int, head_dim: int, page_size: int, tile_pages: int, pool_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (csrc/paged_attention.cu
    `smem_for`): the K/V tile ring (and int8 scale rows), the query rows,
    three (row, key) score buffers, the (row, page, channel) PV partials and
    the per-(row, page) statistics."""
    keys = tile_pages * page_size
    item = torch.empty((), dtype=pool_dtype).element_size()
    ring = 2 * _STAGES * keys * head_dim * item + (2 * _STAGES * keys * 4 if pool_dtype == torch.int8 else 0)
    R = rows
    return ring + 4 * (R * head_dim + 3 * R * keys + R * tile_pages * head_dim + 2 * R * tile_pages + R)


def _check_args(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, sliding_window, attn_sinks) -> None:
    """Refuse what the kernel does not take. q is the FOLDED query
    (B, H_kv, G*R, C) with its tiled counts."""
    B, H, R, C = q.shape
    if sliding_window < 0 or attn_sinks < 0:
        raise ValueError(f"sliding_window={sliding_window} and attn_sinks={attn_sinks} must be >= 0")
    if R < 1 or R * C > MAX_ROW_CHANNELS:
        raise ValueError(
            f"{R} query rows per slot and K/V head (after the GQA fold) x head_dim {C} = "
            f"{R * C}: the kernel takes 1 row up to {MAX_ROW_CHANNELS} rows x channels"
        )
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
    if smem_bytes(R, C, ps, 1, k_pages.dtype) > _SMEM_MAX:
        raise ValueError(
            f"{R} rows x head_dim {C} over pages of {ps} {k_pages.dtype} keys need "
            f"{smem_bytes(R, C, ps, 1, k_pages.dtype)} bytes of shared memory with a "
            f"one-page tile; a block has {_SMEM_MAX}"
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


def _launch(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, split_k,
            sliding_window, attn_sinks) -> Tensor:
    """Launch csrc/paged_attention.cu on q (B, H_q, R, C), folded to the
    pool's heads; returns (B, H_q, R, C)."""
    out_shape, n_rows = q.shape, q.shape[2]
    q, counts, groups = _fold(q.contiguous(), counts, k_pages.shape[0])
    _check_args(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, sliding_window, attn_sinks)
    B, H, R, C = q.shape
    _, P, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    split_k = normalize_split_k(split_k, max_pages)
    quantized = k_scale is not None
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
            split_k, sliding_window, attn_sinks if sliding_window else 0, 1.0 / math.sqrt(C),
            _Q_CODE[q.dtype], _KV_CODE[k_pages.dtype], stream,
        )
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention launch failed: {msg} ({rc})")
    LAUNCHES.add((spec_name(n_rows, quantized, groups, sliding_window), split_k))
    if split_k > 1:
        m, l, acc = merge_partials(m, l, acc, axis=1)
        out, _ = finalize(m, l, acc)
    return out.to(q.dtype).reshape(out_shape)


def paged_attention_template(
    q: Tensor,  # (B, H_q, R, C)
    k_pages: Tensor,  # (H_kv, num_pages, page_size, C)
    v_pages: Tensor,
    page_table: Tensor,  # (B, max_pages) int
    counts: Tensor,  # (B, R) int
    k_scale: tp.Optional[Tensor] = None,  # (num_pages, H_kv, page_size) f32, int8 pools
    v_scale: tp.Optional[Tensor] = None,
    split_k: int = 1,
    sliding_window: int = 0,
    attn_sinks: int = 0,
) -> Tensor:
    """Instantiate the template: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors. GQA is inferred from the shapes (H_q a
    multiple of H_kv); sliding_window 0 is full causal attention, and the
    sinks count only under a window. Returns (B, H_q, R, C) in q.dtype."""
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, split_k,
                       sliding_window, attn_sinks)
    if q.device.type != "cpu":
        raise NotImplementedError(f"no paged-attention kernel for device {q.device}")
    return paged_attention_template_plain(
        q, k_pages, v_pages, page_table, counts, k_scale, v_scale, split_k, sliding_window, attn_sinks
    )
