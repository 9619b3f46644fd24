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
  * the CUDA kernels of `csrc/paged_attention.cu` (source note there: what
    they replace, what bounds them, and their design), launched by
    `paged_attention_template` for CUDA tensors: a partition kernel that
    writes raw partials of fixed runs of `partition_pages(...)` pages
    (tensor-core products for a bf16 query over bf16 or int8 pools, f32
    FMAs otherwise), then the merge kernel (`merge_partitions`, whose plain
    version is merge_partials + finalize).

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
# Launches of the CUDA merge kernel (one per template call on CUDA).
MERGE_LAUNCHES = LaunchCounter("paged_attention_merge")

# csrc/paged_attention.cu limits: (folded) rows x head_dim per slot and head
# (kMaxRowChan) and head_dim (kMaxChan); and the keys x head_dim of a
# partition (_PARTITION_ELEMS: its K and V fit shared memory). The kernel's
# choice of products and its shared memory live in the .cu alone: a block
# that does not fit is refused by the launcher.
MAX_ROW_CHANNELS = 8192
_MAX_C = 512
_PARTITION_ELEMS = 16384


def normalize_split_k(split_k: int, max_pages: int) -> int:
    """Largest pow2 <= split_k that divides the page-table width."""
    s = max(1, int(split_k))
    s = min(s, max_pages)
    s = 1 << (s.bit_length() - 1)  # pow2 floor (applied after the clamp)
    while max_pages % s:
        s //= 2
    return s


def partition_pages(max_pages: int, split_k: int, page_size: int, head_dim: int,
                    q_dtype: torch.dtype = torch.bfloat16, pool_dtype: torch.dtype = torch.bfloat16) -> int:
    """Pages per partition of the CUDA kernel (csrc/paged_attention.cu,
    "Partitions"): the largest divisor of max_pages / split_k (normalized)
    that is at most max(ceil(32 / page_size), ceil(max_pages / 32)) pages —
    at least 32 keys, at most ~32 partitions — and at most
    16384 / (page_size * head_dim) pages, so a partition's K and V fit
    shared memory. A pure function of the shapes and dtypes: never of the
    counts (a device sync, no CUDA-graph capture), nor of the rows or the
    GQA groups (a row's bits would depend on them). It divides every
    split's page run, so the partitions refine the caller's split.

    An f32 query over bf16 pools keeps the caller's split (P = max_pages /
    split_k): its p is rounded to bf16 relative to the running max of its
    partition, so only the caller's partitions give the plain version's
    roundings, which that pairing is held to at float32's tolerance."""
    per_split = max_pages // normalize_split_k(split_k, max_pages)
    if q_dtype == torch.float32 and pool_dtype == torch.bfloat16:
        return per_split
    cap = min(max(-(-32 // page_size), -(-max_pages // 32)), max(1, _PARTITION_ELEMS // (page_size * head_dim)))
    return max(d for d in range(1, min(cap, per_split) + 1) if per_split % d == 0)


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
        fn.argtypes = [vp] * 10 + [ci] * 10 + [ctypes.c_float, ci, ci, vp]
        fn.restype = ci
        lib.paged_attention_merge.argtypes = [vp] * 4 + [ci] * 6 + [vp]
        lib.paged_attention_merge.restype = ci
        lib.paged_attention_tensor_cores.argtypes = [ci] * 4
        lib.paged_attention_tensor_cores.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        if rc == 1:  # cudaErrorInvalidValue: the entry point's limits, or a block past shared memory
            msg += ": the kernel does not take these shapes (csrc/paged_attention.cu)"
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


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
    for name, t in named[1:3] + named[5:]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel copies 16 bytes at a time)")


def merge_partitions(m: Tensor, l: Tensor, acc: Tensor, dtype: torch.dtype) -> Tensor:
    """Merge raw per-partition partials m, l (B, n_parts, H, R) and acc
    (B, n_parts, H, R, C) along the partition axis and finalize to
    (B, H, R, C) in `dtype`: ops/online_softmax merge_partials + finalize
    for CPU tensors, the CUDA merge kernel (csrc `paged_attention_merge`:
    ascending partition order) for CUDA tensors."""
    if not acc.is_cuda:
        if acc.device.type != "cpu":
            raise NotImplementedError(f"no paged-attention merge kernel for device {acc.device}")
        out, _ = finalize(*merge_partials(m, l, acc, axis=1))
        return out.to(dtype)
    B, n_parts, H, R, C = acc.shape
    if m.shape != (B, n_parts, H, R) or l.shape != m.shape or dtype not in _Q_CODE:
        raise ValueError(f"partials m {tuple(m.shape)}, l {tuple(l.shape)}, acc {tuple(acc.shape)} to {dtype}")
    if {t.dtype for t in (m, l, acc)} != {torch.float32} or H > 65535 or B > 65535 or C > _MAX_C:
        raise ValueError(f"the merge takes float32 partials of at most 65535 heads and slots and "
                         f"head_dim <= {_MAX_C}")
    m, l, acc = m.contiguous(), l.contiguous(), acc.contiguous()
    out = torch.empty((B, H, R, C), dtype=dtype, device=acc.device)
    lib = _kernel_lib()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = lib.paged_attention_merge(acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
                                       B, n_parts, H, R, C, _Q_CODE[dtype], stream)
    _raise_on(lib, rc, "paged_attention_merge")
    MERGE_LAUNCHES.add()
    return out


def _launch(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, split_k,
            sliding_window, attn_sinks) -> Tensor:
    """Launch csrc/paged_attention.cu on q (B, H_q, R, C), folded to the
    pool's heads: the partition kernel writes raw partials of
    max_pages / partition_pages(...) partitions, the merge kernel finalizes
    them. Returns (B, H_q, R, C)."""
    out_shape, n_rows = q.shape, q.shape[2]
    q, counts, groups = _fold(q.contiguous(), counts, k_pages.shape[0])
    _check_args(q, k_pages, v_pages, page_table, counts, k_scale, v_scale, sliding_window, attn_sinks)
    B, H, R, C = q.shape
    _, P, ps, _ = k_pages.shape
    max_pages = page_table.shape[1]
    split_k = normalize_split_k(split_k, max_pages)
    pages = partition_pages(max_pages, split_k, ps, C, q.dtype, k_pages.dtype)
    n_parts = max_pages // pages
    quantized = k_scale is not None
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if quantized:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    cnt = counts.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, n_parts, H, R, C), **f32)
    m = torch.empty((B, n_parts, H, R), **f32)
    l = torch.empty((B, n_parts, H, R), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention(
            ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale), ptr(v_scale), ptr(pt),
            ptr(cnt), ptr(acc), ptr(m), ptr(l), B, H, R, P, ps, C, max_pages, pages,
            sliding_window, attn_sinks if sliding_window else 0, 1.0 / math.sqrt(C),
            _Q_CODE[q.dtype], _KV_CODE[k_pages.dtype], stream,
        )
    _raise_on(lib, rc, "paged_attention")
    LAUNCHES.add((spec_name(n_rows, quantized, groups, sliding_window), split_k))
    return merge_partitions(m, l, acc, q.dtype).reshape(out_shape)


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
