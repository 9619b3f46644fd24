"""Decoder-only GPT as a parameter dict + plain functions (counterpart of
midgpt_tpu/models/gpt.py).

Architecture, as in the JAX package:
  * pre-norm residual blocks with weightless RMSNorm (eps 1e-6 in blocks,
    1e-5 for the final norm)
  * fused QKV projection, QK-LayerNorm per head (learned scale, no bias);
    with `n_kv_heads` set (GQA/MQA) the K/V projection is its own leaf at
    n_kv_heads heads, each K/V head serving a group of query heads
  * an optional sliding window with attention sinks (`sliding_window`,
    `attn_sinks`) in every attention path
  * GPT-J rotary embeddings, in the 'interleaved' form or the identical
    'split' form (q/k projection rows permuted per head, rotate-half)
  * bias-free Linears, truncated-normal(±2σ)/sqrt(fan_in) init, embedding
    init N(0, 1/sqrt(D)), init-only weight tying (lm_head starts as an
    independent copy of wte)
  * GELU (tanh approximation, like `jax.nn.gelu`) MLP with 4x expansion,
    or, with `n_experts` set, the top-k routed MLP of n_experts such MLPs
    (`GPT._moe_mlp`: JAX's masked-dense lowering, the Switch load-balance
    term for training)
  * f32 softmax inside attention

The training forward (`hidden` / `apply` with inference=False) adds the
reference's dropout (embedding, attention probabilities on the naive path,
both residual branches) from a torch.Generator, and dispatches attention by
`attn_impl`: 'naive', 'blockwise' or 'flash' (the CUDA flash kernels for
CUDA tensors, their plain version for CPU tensors; ops/attention.py).

Parameters are a flat dict keyed by the JAX pytree paths, with the stacked
leading layer axis kept, so converting weights is a rename
(midgpt_tpu_torch/convert.py):

    wte (V, D), lm_head (V, D),
    blocks.attn.wqkv (L, 3, D, D), blocks.attn.wo (L, D, D),
    blocks.attn.q_scale (L, C), blocks.attn.k_scale (L, C),
    blocks.mlp.w_up (L, 4D, D), blocks.mlp.w_down (L, D, 4D)

and, when `n_kv_heads` is set (even to n_head, as in JAX), wqkv is the
query projection (L, 1, D, D) and blocks.attn.wkv (L, 2, H_kv*C, D) holds
k then v; when `n_experts` is E > 0, the MLP's two leaves give way to

    blocks.mlp.router (L, E, D), blocks.mlp.experts_up (L, E, 4D, D),
    blocks.mlp.experts_down (L, E, D, 4D)

in either attention layout (`param_names`).

The batch sampler (sampling/engine.py `generate`) runs `prefill` and
`decode_step` over a contiguous `KVCache`, updated in place. The serving
path is `decode_step_paged` + `prefill_paged_chunk`, plus
`verify_step_paged` for speculative decoding, over a bf16, f32 or int8
`PagedKVCache`, updated IN PLACE (the JAX code donates the pool to its
jitted step and gets a new one back; here the pool tensors are written
directly and the same cache object is returned).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import typing as tp

import torch
import torch.nn.functional as F

from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.kernels.decode_attention import paged_attention, paged_verify_attention
from midgpt_tpu_torch.ops import remat
from midgpt_tpu_torch.ops.attention import flash_kernel_usable, multihead_attention, visible_mask
from midgpt_tpu_torch.ops.dropout import dropout
from midgpt_tpu_torch.ops.moe import moe_down
from midgpt_tpu_torch.ops.norms import head_layer_norm, rms_norm
from midgpt_tpu_torch.ops.quant import dequantize_q8, quantize_q8
from midgpt_tpu_torch.ops.rope import (
    apply_rope_bthc,
    apply_rope_positions,
    rope_table,
    split_permutation,
)

Tensor = torch.Tensor
Params = tp.Dict[str, Tensor]

_ATTN_NAMES = ("blocks.attn.wqkv", "blocks.attn.wo", "blocks.attn.q_scale", "blocks.attn.k_scale")
WKV = "blocks.attn.wkv"  # the GQA layout's K/V projection (JAX AttentionParams.wkv)
_DENSE_MLP_NAMES = ("blocks.mlp.w_up", "blocks.mlp.w_down")
ROUTER = "blocks.mlp.router"  # the routed MLP's leaves (JAX MoEParams), in its order
MOE_MLP_NAMES = (ROUTER, "blocks.mlp.experts_up", "blocks.mlp.experts_down")


def layout_names(gqa: bool, moe: bool) -> tp.Tuple[str, ...]:
    """The leaves of one parameter layout, in JAX's pytree order: wkv after
    the attention's four leaves under GQA, the routed MLP's three leaves in
    place of the dense MLP's two under MoE."""
    return (("wte",) + _ATTN_NAMES + ((WKV,) if gqa else ())
            + (MOE_MLP_NAMES if moe else _DENSE_MLP_NAMES) + ("lm_head",))


def param_names(config: "GPTConfig") -> tp.Tuple[str, ...]:
    """The leaves of `config`'s parameter dict: JAX's pytree leaves, wkv
    present iff n_kv_heads is set (JAX keys the GQA layout on that, not on
    n_kv_heads < n_head), the routed MLP's iff n_experts > 0."""
    return layout_names(config.n_kv_heads is not None, config.n_experts > 0)


def param_shapes(config: "GPTConfig") -> tp.Dict[str, tp.Tuple[int, ...]]:
    """The shape of each leaf `GPT.init` makes (in `param_names` order),
    without making it: a checkpoint restore's template."""
    L, D, C, V, E = config.n_layer, config.n_embd, config.head_dim, config.vocab_size, config.n_experts
    gqa = config.n_kv_heads is not None
    shapes = {
        "wte": (V, D),
        "blocks.attn.wqkv": (L, 1 if gqa else 3, D, D),
        WKV: (L, 2, config.kv_heads * C, D),
        "blocks.attn.wo": (L, D, D),
        "blocks.attn.q_scale": (L, C),
        "blocks.attn.k_scale": (L, C),
        "blocks.mlp.w_up": (L, 4 * D, D),
        "blocks.mlp.w_down": (L, D, 4 * D),
        ROUTER: (L, E, D),
        "blocks.mlp.experts_up": (L, E, 4 * D, D),
        "blocks.mlp.experts_down": (L, E, D, 4 * D),
        "lm_head": (V, D),
    }
    return {name: shapes[name] for name in param_names(config)}


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model shape. Field names and validation follow the JAX GPTConfig so
    a config.json written by either package loads in both. attn_impl and
    attn_block_size pick the attention path of training and of the batch
    sampler's prefill, and its tiles, as in JAX; remat and remat_policy
    checkpoint each block of the training forward with JAX's policies
    (`GPT.hidden`, ops/remat.py). The other JAX
    lowering knobs (scan_unroll, qkv_proj, attn_layout, decode_layer_scan)
    are kept for that reason and change nothing here: every choice
    computes the same function."""

    block_size: int  # max sequence length
    vocab_size: int
    n_layer: int
    n_head: int
    n_embd: int
    dropout: float = 0.0
    attn_impl: str = "naive"
    attn_block_size: int = 1024
    remat: bool = True
    remat_policy: str = "dots"
    scan_unroll: int = 1
    qkv_proj: str = "fused"
    rope_style: str = "interleaved"
    attn_layout: str = "seq"
    n_experts: int = 0
    moe_top_k: int = 2
    decode_layer_scan: bool = False
    n_kv_heads: tp.Optional[int] = None
    sliding_window: int = 0
    attn_sinks: int = 0

    def __post_init__(self):
        if self.n_kv_heads is not None:
            if self.n_kv_heads < 1 or self.n_head % self.n_kv_heads:
                raise ValueError(
                    f"n_kv_heads={self.n_kv_heads} must be a positive divisor "
                    f"of n_head={self.n_head}"
                )
        if self.sliding_window != 0 and not (0 < self.sliding_window < self.block_size):
            raise ValueError(
                f"sliding_window={self.sliding_window} must be 0 (full "
                f"attention) or in [1, block_size={self.block_size})"
            )
        if self.attn_sinks < 0:
            raise ValueError(f"attn_sinks={self.attn_sinks} must be >= 0")
        if self.attn_sinks > 0 and self.sliding_window == 0:
            raise ValueError("attn_sinks > 0 requires sliding_window > 0")
        if self.sliding_window > 0:
            if self.attn_sinks + self.sliding_window > self.block_size:
                raise ValueError(
                    f"attn_sinks + sliding_window = {self.attn_sinks + self.sliding_window} "
                    f"exceeds block_size={self.block_size}"
                )
            if self.attn_impl not in ("naive", "blockwise"):
                raise ValueError(
                    f"sliding_window requires attn_impl 'naive' or 'blockwise' (got "
                    f"{self.attn_impl!r}: the flash/ring/ulysses training kernels carry no window mask)"
                )
        if self.rope_style not in ("interleaved", "split"):
            raise ValueError(f"unknown rope_style {self.rope_style!r} ('interleaved' or 'split')")
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} not divisible by n_head={self.n_head}")
        if self.attn_impl not in ("naive", "blockwise", "flash", "ring", "ulysses"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        # the routed MLP: JAX checks these in ExperimentConfig, with these messages
        if self.n_experts < 0:
            raise ValueError(f"n_experts={self.n_experts} must be >= 0")
        if self.n_experts > 0 and not (1 <= self.moe_top_k <= self.n_experts):
            raise ValueError(f"moe_top_k={self.moe_top_k} must be in [1, n_experts={self.n_experts}]")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        """K/V heads (n_head unless GQA/MQA is on)."""
        return self.n_head if self.n_kv_heads is None else self.n_kv_heads

    @property
    def kv_groups(self) -> int:
        """Query heads per K/V head (1 = MHA)."""
        return self.n_head // self.kv_heads


@dataclasses.dataclass
class KVCache:
    """Static-shape decode cache of the batch sampler (sampling/engine.py
    `generate`): keys and values of every layer, filled up to `length`.

    `length` is a 0-d int64 tensor on the cache's device, so a decode step
    reads its position without a host sync and can be captured in a CUDA
    graph. `GPT.prefill` and `GPT.decode_step` update the cache IN PLACE
    and return the same object (the JAX code returns a new cache)."""

    k: Tensor  # (n_layer, B, n_kv_heads, S, head_dim)
    v: Tensor
    length: Tensor  # () int64: number of valid positions

    @staticmethod
    def init(
        config: GPTConfig, batch_size: int, dtype: torch.dtype = torch.bfloat16, *, device: DeviceLike = None
    ) -> "KVCache":
        dev = resolve_device(device)
        shape = (config.n_layer, batch_size, config.kv_heads, config.block_size, config.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            length=torch.zeros((), dtype=torch.int64, device=dev),
        )


@dataclasses.dataclass
class PagedKVCache:
    """Paged decode cache for the continuous-batching serving engine.

    K/V live in a shared pool of fixed-size pages, (n_layer, kv_heads,
    num_pages, page_size, head_dim) per tensor (kv_heads = n_kv_heads under
    GQA: the pool shrinks with the K/V head count); a request occupies the
    pages the host-side allocator (sampling/serve.py PageAllocator) hands
    it. Page 0 is the SINK: never allocated, it is what unallocated
    page-table entries (zeros) point at, so inactive and short slots READ
    it — always masked. Page `num_pages` is the SPARE, one page past the
    allocator's range that no page table names: the decode and verify steps
    send the writes of slots that must not write there (JAX sends them past
    the pool, where XLA's scatter drops them; an out-of-range index would
    raise here), so every step writes all B slots with fixed shapes and no
    host sync. Nothing reads the spare page. Prefill pad positions are
    sliced off on the host (`prefill_paged_chunk`).

    bf16 and f32 pools, and the **int8 storage mode** (dtype=torch.int8):
    pages hold int8 codes with f32 absmax scales in the side buffers
    `k_scale`/`v_scale` of shape (n_layer, num_pages, kv_heads, page_size) —
    one scale per written K/V vector per head (ops/quant.py), quantized on
    every write and dequantized by every read. In bf16/f32 mode both scale
    fields are None."""

    k: Tensor  # (n_layer, kv_heads, num_pages + 1, page_size, head_dim): the spare page last
    v: Tensor
    k_scale: tp.Optional[Tensor] = None  # (n_layer, num_pages + 1, kv_heads, page_size) f32, int8 mode
    v_scale: tp.Optional[Tensor] = None

    @staticmethod
    def init(
        config: GPTConfig,
        num_pages: int,
        page_size: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        *,
        device: DeviceLike = None,
        tp_size: int = 1,
    ) -> "PagedKVCache":
        """A zeroed pool; with `tp_size` > 1, one tensor-parallel rank's
        shard of it: kv_heads / tp_size heads (parallel/serve_tp.py)."""
        if dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise NotImplementedError(f"paged cache dtype {dtype}: bf16, f32 and int8 are ported")
        if config.kv_heads % tp_size:
            raise ValueError(f"n_kv_heads={config.kv_heads} not divisible by tp={tp_size}")
        heads = config.kv_heads // tp_size
        # num_pages + 1: the allocator's pages 0..num_pages-1 and the spare
        shape = (config.n_layer, heads, num_pages + 1, page_size, config.head_dim)
        dev = resolve_device(device)
        scales = {}
        if dtype == torch.int8:
            sshape = (config.n_layer, num_pages + 1, heads, page_size)
            scales = {n: torch.zeros(sshape, dtype=torch.float32, device=dev) for n in ("k_scale", "v_scale")}
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            **scales,
        )

    @staticmethod
    def page_bytes(config: GPTConfig, page_size: int, dtype: torch.dtype) -> int:
        """K+V bytes of ONE page across all layers and K/V heads, without the
        int8 scale side buffers (`nbytes` counts those)."""
        per_tok = config.n_layer * config.kv_heads * config.head_dim
        return 2 * per_tok * page_size * torch.empty((), dtype=dtype).element_size()

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        """The allocator's pages; the spare page `num_pages` comes after them."""
        return self.k.shape[2] - 1

    @property
    def nbytes(self) -> int:
        """Device bytes of the pools (the spare page included) and, in int8
        mode, their scales."""
        tensors = [self.k, self.v] + ([self.k_scale, self.v_scale] if self.quantized else [])
        return sum(t.numel() * t.element_size() for t in tensors)


def _paged_write(
    pool: Tensor,  # (L, H, P, ps, C) — K or V pages
    scales: tp.Optional[Tensor],  # (L, P, H, ps) f32, or None (bf16/f32 mode)
    i: int,  # layer index
    write_pages: Tensor,  # (N,) physical page per written position
    offs: Tensor,  # (N,) in-page offset per written position
    val: Tensor,  # (N, H, C) — the K/V vectors to store
) -> None:
    """ONE column scatter into the paged pool, in place, quantizing iff
    `scales` is present. Positions that must not write name the spare page
    (PagedKVCache); duplicates among them are harmless, as nothing reads it.

    torch keeps ADJACENT advanced indices in place and puts SEPARATED ones
    first: the pool index [:, write_pages, offs] is (H, N, C) — hence the
    transpose of the (N, H, C) value — while the scale index
    [write_pages, :, offs] is (N, H), the quantizer's scale shape as it
    comes."""
    if scales is None:
        pool[i][:, write_pages, offs] = val.transpose(0, 1).to(pool.dtype)
        return
    q, s = quantize_q8(val)  # (N, H, C) int8, (N, H) f32
    pool[i][:, write_pages, offs] = q.transpose(0, 1)
    scales[i][write_pages, :, offs] = s


def _write_pages(page_table: Tensor, pos: Tensor, writes: Tensor, spare: int, page_size: int) -> Tensor:
    """Physical page of each position pos (B,) or (B, K1) of slot b, or the
    spare page where `writes` is False — fixed shapes, no host sync. The
    table column is clamped: a slot that does not write may carry a stale
    position past the table's width (a finished slot inside a fused group),
    and a CUDA gather out of range is a device-side assert (JAX's
    take_along_axis clamps)."""
    col = torch.clamp_max(pos // page_size, page_table.shape[1] - 1)
    pages = torch.gather(page_table, 1, col.reshape(pos.shape[0], -1)).reshape(pos.shape)
    return torch.where(writes, pages.long(), spare)


def _layer_pages(pool: Tensor, scales: tp.Optional[Tensor], i: int) -> tp.Tuple[Tensor, tp.Optional[Tensor]]:
    """Layer i's pages (H, P, ps, C) and scales (P, H, ps) | None — views."""
    return pool[i], None if scales is None else scales[i]


def _gather_layer_kv(
    pool_layer: Tensor,  # (H, P, ps, C)
    scales_layer: tp.Optional[Tensor],  # (P, H, ps) f32 | None
    page_rows: Tensor,  # (MP,) one slot's logical -> physical pages
    out_dtype: torch.dtype,
) -> Tensor:
    """Gather one slot's pages contiguous -> (H, MP*ps, C), dequantizing
    after the gather (cast to `out_dtype`) in int8 mode."""
    H, _, ps, C = pool_layer.shape
    rows = page_rows.long()
    S = page_rows.shape[0] * ps
    g = pool_layer[:, rows].reshape(H, S, C)
    if scales_layer is None:
        return g
    sg = scales_layer[rows].transpose(0, 1).reshape(H, S)  # (MP, H, ps) -> (H, S)
    return dequantize_q8(g, sg).to(out_dtype)


def _linear_init(gen: torch.Generator, out_features: int, in_features: int) -> Tensor:
    """Truncated-normal(±2σ) scaled 1/sqrt(fan_in)."""
    w = torch.empty(out_features, in_features)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w / math.sqrt(in_features)


@functools.lru_cache(maxsize=8)
def _split_perm(head_dim: int, device: torch.device) -> Tensor:
    """`split_permutation(head_dim)` as an index tensor on `device`, made
    once: a fresh host-to-device copy in every layer of every decode step
    would stall the host on the device each time."""
    return torch.as_tensor(split_permutation(head_dim), device=device)


def _block(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked block leaves, keyed by leaf name."""
    return {name.split(".", 1)[1]: t[i] for name, t in params.items() if name.startswith("blocks.")}


def _repeat_kv(config: GPTConfig, a: Tensor, dim: int) -> Tensor:
    """Broadcast K/V heads to the query head count (no-op for MHA). Query
    head h reads K/V head h // kv_groups, so each K/V head's copies sit at
    its group's query heads: `repeat_interleave` (jnp.repeat), not
    `Tensor.repeat` (jnp.tile) — the same grouping as the paged template's
    free (B, H_q, R, C) -> (B, H_kv, G*R, C) fold."""
    g = config.kv_groups
    return a if g == 1 else a.repeat_interleave(g, dim=dim)


class _Whole:
    """`GPT.init`'s default layout: every leaf whole (parallel/fsdp.py
    `ShardedInit` is a mesh rank's)."""

    def shape(self, name: str, shape: tp.Tuple[int, ...]) -> tp.Tuple[int, ...]:
        return shape

    def place(self, name: str, index: tp.Tuple[int, ...]) -> tp.Optional[tp.Tuple[int, ...]]:
        return index

    def cut(self, name: str, piece: Tensor, lead: int) -> Tensor:
        return piece


class GPT:
    """Namespace of plain functions over (GPTConfig, parameter dict)."""

    @staticmethod
    def init(
        config: GPTConfig,
        seed: tp.Union[int, torch.Generator],
        *,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.float32,
        shard: tp.Optional["_Whole"] = None,
    ) -> Params:
        """Random parameters from a seed (or a CPU torch.Generator), made
        in `dtype` on `device`. Drawn on the CPU, so a seed gives the same
        weights on every device; torch's generator is not JAX's, so init
        matches the JAX package in distribution, not bit for bit. Each
        leaf is allocated once on the device and filled layer by layer, so
        the host holds one layer's f32 draws at a time (a 7B model's
        weights are never all on the host, nor in f32 on a bf16 card).

        `shard` (parallel/fsdp.py `ShardedInit`) makes the leaves a mesh
        rank's shards at birth: each leaf is allocated at its shard's
        shape, every piece is still drawn in order (the generator advances
        through the pieces the rank skips), and only the rank's slice of a
        piece is kept, so the shards equal the whole init's slices bit for
        bit and the rank never holds more than its shards and one piece."""
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        L, D, V = config.n_layer, config.n_embd, config.vocab_size
        KVD = config.kv_heads * config.head_dim
        keep = shard or _Whole()
        params = {k: torch.empty(keep.shape(k, s), device=dev, dtype=dtype) for k, s in param_shapes(config).items()}

        def put(name: str, index: tp.Tuple[int, ...], piece: Tensor) -> None:
            """Piece `index` of a leaf (a layer's, or a layer's expert's,
            slice; the whole leaf at ()), where this rank keeps part of it."""
            local = keep.place(name, index)
            if local is not None:
                params[name][local].copy_(keep.cut(name, piece, len(index)))

        for i in range(L):
            if WKV in params:
                # GQA layout: q at full width, k/v at n_kv_heads * C each
                put("blocks.attn.wqkv", (i,), _linear_init(gen, D, D).reshape(1, D, D))
                put(WKV, (i,), _linear_init(gen, 2 * KVD, D).reshape(2, KVD, D))
            else:
                # iid rows: the (3, D, D) reshape of a (3D, D) init
                put("blocks.attn.wqkv", (i,), _linear_init(gen, 3 * D, D).reshape(3, D, D))
            put("blocks.attn.wo", (i,), _linear_init(gen, D, D))
            if ROUTER in params:
                # the router, then each expert's up and down projections
                put(ROUTER, (i,), _linear_init(gen, config.n_experts, D))
                for e in range(config.n_experts):
                    put("blocks.mlp.experts_up", (i, e), _linear_init(gen, 4 * D, D))
                for e in range(config.n_experts):
                    put("blocks.mlp.experts_down", (i, e), _linear_init(gen, D, 4 * D))
            else:
                put("blocks.mlp.w_up", (i,), _linear_init(gen, 4 * D, D))
                put("blocks.mlp.w_down", (i,), _linear_init(gen, D, 4 * D))
        embed = torch.randn(V, D, generator=gen) / math.sqrt(D)
        put("wte", (), embed)
        put("lm_head", (), embed)  # init-only tying: same values, an independent tensor
        params["blocks.attn.q_scale"].fill_(1.0)
        params["blocks.attn.k_scale"].fill_(1.0)
        return params

    @staticmethod
    def _qkv_weights(
        config: GPTConfig, blk: Params
    ) -> tp.Tuple[Tensor, tp.Optional[Tensor], Tensor, Tensor]:
        """(wqkv, wkv | None, q_scale, k_scale), rope_style-adjusted: for
        'split' the q and k rows are permuted per head by
        `split_permutation` (and the QK-norm scales with them), so q/k come
        out with interleaved pair (2i, 2i+1) at (i, i + C/2) and RoPE can use
        rotate-half. Under GQA the q rows of wqkv permute per query head and
        the k rows of wkv[0] per K/V head; wkv[1] (v) is untouched. Stored
        weights stay in the reference convention. The head counts are read
        from the weights, so a tensor-parallel shard (whole heads of each of
        q, k and v: parallel/serve_tp.py) permutes its own heads."""
        wqkv, wkv = blk["attn.wqkv"], blk.get("attn.wkv")
        q_scale, k_scale = blk["attn.q_scale"], blk["attn.k_scale"]
        if config.rope_style == "split":
            C = config.head_dim
            DQ, D = wqkv.shape[-2:]  # DQ = the (shard's) query heads x C
            perm = _split_perm(C, wqkv.device)
            if wkv is None:
                wqk = wqkv[:2].reshape(2, DQ // C, C, D)[:, :, perm, :].reshape(2, DQ, D)
                wqkv = torch.cat((wqk, wqkv[2:]), dim=0)
            else:
                KVD = wkv.shape[-2]
                wqkv = wqkv.reshape(DQ // C, C, D)[:, perm, :].reshape(1, DQ, D)
                wk = wkv[:1].reshape(KVD // C, C, D)[:, perm, :].reshape(1, KVD, D)
                wkv = torch.cat((wk, wkv[1:]), dim=0)
            q_scale, k_scale = q_scale[perm], k_scale[perm]
        return wqkv, wkv, q_scale, k_scale

    @staticmethod
    def _project_qkv(
        config: GPTConfig, blk: Params, h: Tensor
    ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """h (B, T, D) -> q (B, T, H, C), k, v (B, T, H_kv, C) after
        QK-LayerNorm (no RoPE): ONE product with a contiguous split — with
        (3D, D) for MHA, with the q rows of wqkv and the k/v rows of wkv
        concatenated, (D + 2 H_kv C, D), for GQA. K/V come out at the K/V
        head count: paged writes store them as they are, the training
        attention repeats them (_repeat_kv). On a tensor-parallel shard the
        widths are the shard's: H/tp query and H_kv/tp K/V heads."""
        B, T, D = h.shape
        C = config.head_dim
        wqkv, wkv, q_scale, k_scale = GPT._qkv_weights(config, blk)
        DQ = wqkv.shape[-2]
        if wkv is None:
            qkv = h @ wqkv.reshape(3 * DQ, D).T
            q, k, v = torch.split(qkv, DQ, dim=-1)
        else:
            KVD = wkv.shape[-2]
            qkv = h @ torch.cat((wqkv.reshape(DQ, D), wkv.reshape(2 * KVD, D)), dim=0).T
            q, k, v = torch.split(qkv, [DQ, KVD, KVD], dim=-1)
        q = head_layer_norm(q.reshape(B, T, -1, C), q_scale)
        k = head_layer_norm(k.reshape(B, T, -1, C), k_scale)
        return q, k, v.reshape(B, T, -1, C)

    @staticmethod
    def _attn_out_and_mlp(
        config: GPTConfig,
        blk: Params,
        x: Tensor,
        att: Tensor,
        *,
        generator: tp.Optional[torch.Generator] = None,
        inference: bool = True,
        return_moe_aux: bool = False,
        aux_reduce: tp.Optional[tp.Callable[[Tensor], Tensor]] = None,
        tp_row=None,
        ep_train=None,
    ) -> tp.Union[Tensor, tp.Tuple[Tensor, Tensor]]:
        """Shared tail of a block: merge heads, output projection, MLP (the
        routed one when n_experts > 0), residuals (each branch dropped out
        in training). att (B, T, H, C). With return_moe_aux (routed MLP
        only), returns (out, the block's load-balance term; `aux_reduce` as
        in `_moe_gates`).

        `tp_row`: a tp row's collectives, parallel/serve_tp.py TPShard on
        the serving paths or parallel/tp.py TPTrain in training. att holds
        the shard's heads, and the products of the row-parallel leaves
        (wo, w_down) are partial sums, summed over the row before their
        residual add (`reduce`, Megatron's g; TPShard sums only the leaves
        its specs shard). `copy` (Megatron's f, the identity when serving)
        goes before the w_up product. The routed MLP's banks are
        replicated over tp, so its output is whole and is not summed over
        the row. `ep_train` (parallel/tp.py EPTrain): the banks are the
        rank's experts (`_moe_mlp`)."""
        B, T = att.shape[:2]
        att = att.reshape(B, T, -1) @ blk["attn.wo"].T
        if tp_row is not None:
            att = tp_row.reduce("blocks.attn.wo", att)
        x = x + dropout(att, config.dropout, generator, inference)
        h = rms_norm(x)
        aux = None
        if config.n_experts > 0:
            h, aux = GPT._moe_mlp(config, blk, h, return_aux=return_moe_aux, aux_reduce=aux_reduce, ep=ep_train)
        else:
            if tp_row is not None:
                h = tp_row.copy(h)
            h = F.gelu(h @ blk["mlp.w_up"].T, approximate="tanh")  # jax.nn.gelu's default
            h = h @ blk["mlp.w_down"].T
            if tp_row is not None:
                h = tp_row.reduce("blocks.mlp.w_down", h)
        out = x + dropout(h, config.dropout, generator, inference)
        return (out, aux) if return_moe_aux else out

    @staticmethod
    def _moe_gates(
        config: GPTConfig, blk: Params, h: Tensor, with_aux: bool = True,
        aux_reduce: tp.Optional[tp.Callable[[Tensor], Tensor]] = None,
    ) -> tp.Tuple[Tensor, tp.Optional[Tensor]]:
        """Router -> (gates (..., E) in h.dtype, load-balance aux () f32, or
        None without `with_aux`), as JAX's `GPT._moe_gates`.

        The router product runs in h's dtype and is cast to f32. Exactly
        K = moe_top_k experts are selected per token, ties going to the
        lowest expert index (JAX's `jax.lax.top_k` order: a zero or
        collapsed router keeps K experts, never turning dense): each
        expert's rank counts the experts above it and the equal ones
        before it, a comparison that is the same on every device (torch's
        topk leaves the order of equal entries unspecified). The gates are
        the softmax of the logits masked to -inf outside the selection.

        aux = E * sum_e mean(P_e) * mean(assign_e) / K, with P the full f32
        softmax: 1.0 under balanced routing; differentiable through P only
        (the assignment is a hard count). Training asks for it behind
        moe_aux_coef; other callers skip it. The means are over the GLOBAL
        batch, as in JAX: on a data-parallel mesh, `aux_reduce` (a
        differentiable sum over the ranks, parallel/mesh.py `psum`) sums
        the per-expert sums and the token counts before the product."""
        E, K = config.n_experts, config.moe_top_k
        logits = (h @ blk["mlp.router"].T).float()
        if K < E:
            above = logits.unsqueeze(-2) > logits.unsqueeze(-1)  # [..., e, e']: l_e' > l_e
            idx = torch.arange(E, device=logits.device)
            tied_before = (logits.unsqueeze(-2) == logits.unsqueeze(-1)) & (idx[None, :] < idx[:, None])
            assign = (above | tied_before).sum(-1) < K  # (..., E): exactly K per token
            masked = logits.masked_fill(~assign, float("-inf"))
        else:
            assign, masked = torch.ones_like(logits, dtype=torch.bool), logits
        gates = torch.softmax(masked, dim=-1).to(h.dtype)
        if not with_aux:
            return gates, None
        tokens = tuple(range(logits.dim() - 1))
        if aux_reduce is None:
            mean_prob = torch.softmax(logits, dim=-1).mean(tokens)  # (E,)
            mean_assign = assign.float().mean(tokens) / K
        else:
            count = logits.new_full((1,), logits.numel() // E)
            sums = aux_reduce(torch.cat([torch.softmax(logits, dim=-1).sum(tokens), assign.float().sum(tokens), count]))
            mean_prob, mean_assign = sums[:E] / sums[-1], sums[E:2 * E] / sums[-1] / K
        return gates, E * (mean_prob * mean_assign).sum()

    @staticmethod
    def _moe_mlp(
        config: GPTConfig, blk: Params, h: Tensor, return_aux: bool = False,
        aux_reduce: tp.Optional[tp.Callable[[Tensor], Tensor]] = None, ep=None,
    ) -> tp.Tuple[Tensor, tp.Optional[Tensor]]:
        """Top-k routed expert MLP, JAX's masked-dense lowering:
        gelu(h . experts_up^T) for every expert, scaled by its gate (zero
        outside the selection), then one contraction over (expert, hidden)
        with experts_down. Every expert runs on every token (FLOPs E/top_k
        times a dense MLP's, as in JAX); there is no token dispatch and no
        shape that depends on the data, so a decode step stays capturable.
        Both banks are read in place: experts_up as its (E*4D, D) view,
        experts_down through `ops.moe.moe_down`.

        `ep` (parallel/tp.py EPTrain): the banks hold this rank's E/ep
        experts. The gates come from the whole router as without it; h
        and the gates pass f before the rank's experts read them (their
        columns of the gates), and the combine of the rank's experts
        passes g: JAX's masked-dense MLP with the expert axis sharded.

        Returns (out, aux | None): aux only with `return_aux`."""
        gates, aux = GPT._moe_gates(config, blk, h, with_aux=return_aux, aux_reduce=aux_reduce)
        up_w, down_w = blk["mlp.experts_up"], blk["mlp.experts_down"]
        lead, (E, D) = h.shape[:-1], (up_w.shape[0], config.n_embd)  # E: the experts this rank holds
        if ep is not None:
            h, gates = ep.copy(h), ep.copy(gates)[..., ep.experts(E)]
        up = F.gelu(h @ up_w.reshape(-1, D).T, approximate="tanh")  # (..., E*4D)
        up = up.reshape(*lead, E, -1) * gates[..., None]
        out = moe_down(up.reshape(-1, E, up.shape[-1]), down_w)
        if ep is not None:
            out = ep.reduce(out)
        return out.reshape(*lead, D), aux

    @staticmethod
    def _block_apply(
        config: GPTConfig,
        blk: Params,
        x: Tensor,
        sin: Tensor,
        cos: Tensor,
        *,
        generator: tp.Optional[torch.Generator] = None,
        inference: bool = False,
        policy: tp.Optional[str] = None,
        return_moe_aux: bool = False,
        aux_reduce: tp.Optional[tp.Callable[[Tensor], Tensor]] = None,
        tp_train=None,
        attn_fn: tp.Optional[tp.Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
        positions: tp.Optional[Tensor] = None,
        ep_train=None,
    ) -> tp.Union[Tensor, tp.Tuple[Tensor, Tensor]]:
        """One block: QKV, QK-norm, RoPE, attention, output projection, MLP.
        Under a remat `policy` the tensors it keeps by name are named
        (ops/remat.py `name`); otherwise nothing is. With return_moe_aux,
        returns (out, the block's load-balance term). `tp_train`: `blk` is
        a tp rank's shard (whole heads of q, k and v; `hidden`). `attn_fn`,
        `positions` and `ep_train`: `hidden`'s."""
        h = rms_norm(x)
        if tp_train is not None:
            h = tp_train.copy(h)
        q, k, v = GPT._project_qkv(config, blk, h)
        q = apply_rope_bthc(q, sin, cos, positions, style=config.rope_style)
        k = apply_rope_bthc(k, sin, cos, positions, style=config.rope_style)
        # GQA: the training attention takes equal head counts — K/V
        # repeat to the query heads after RoPE (which ran at H_kv)
        k, v = _repeat_kv(config, k, 2), _repeat_kv(config, v, 2)
        q, k, v = (remat.name(t, tag, policy) for t, tag in zip((q, k, v), ("q_rot", "k_rot", "v_proj")))
        if attn_fn is not None:
            # the injected attention (sequence parallelism), head-major as the kernels
            if config.dropout != 0.0 and not inference:
                raise NotImplementedError(
                    f"injected attention (attn_impl={config.attn_impl!r}) does not support attention-probability "
                    "dropout; use attn_impl='naive' or set dropout=0.0"
                )
            att = attn_fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            att = remat.name(att, "attn_out", policy).transpose(1, 2)
        else:
            att = multihead_attention(
                q, k, v, impl=config.attn_impl, dropout_rate=config.dropout,
                generator=generator, inference=inference,
                block_size=config.attn_block_size, layout="bthc",
                sliding_window=config.sliding_window, attn_sinks=config.attn_sinks,
                head_shard=None if tp_train is None else tp_train.heads,
            )
            if not (config.attn_impl == "flash" and flash_kernel_usable(x.shape[1], config.attn_block_size)):
                att = remat.name(att, "attn_out", policy)  # the flash op's out is kept as the op's
        return GPT._attn_out_and_mlp(config, blk, x, att, generator=generator, inference=inference,
                                     return_moe_aux=return_moe_aux, aux_reduce=aux_reduce, tp_row=tp_train,
                                     ep_train=ep_train)

    @staticmethod
    def hidden(
        config: GPTConfig,
        params: Params,
        tokens: Tensor,
        *,
        generator: tp.Optional[torch.Generator] = None,
        inference: bool = False,
        return_moe_aux: bool = False,
        aux_reduce: tp.Optional[tp.Callable[[Tensor], Tensor]] = None,
        layer_transform: tp.Optional[tp.Callable[[Params], Params]] = None,
        tp_train=None,
        attn_fn: tp.Optional[tp.Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
        positions: tp.Optional[Tensor] = None,
        rope_len: tp.Optional[int] = None,
        ep_train=None,
    ) -> tp.Union[Tensor, tp.Tuple[Tensor, Tensor]]:
        """Backbone forward -> final-normed hidden states (B, T, D).

        `return_moe_aux` (routed MLP configs only) also returns the MoE
        load-balance term averaged over layers, a () f32 scalar the training
        loss folds in as `moe_aux_coef * aux` (training/train.py). Off by
        default, so no other caller computes it. On a data-parallel mesh
        `aux_reduce` makes its means global (`_moe_gates`).

        `layer_transform` maps each layer's slice of the block leaves
        before the block runs, inside the block's checkpoint, as JAX's
        hook does (midgpt_tpu/models/gpt.py:963,1023): the ZeRO-3 schedule
        (parallel/shard_map_fsdp.py) gathers one layer's weights there, and
        under remat the recompute gathers them again.

        `tp_train` (parallel/tp.py TPTrain): `params` are a tp rank's
        shards of the Megatron leaves (the four block products, and wte
        under tp_vocab), and the forward places the row's collectives:
        Megatron's f before the QKV and w_up products, g after the wo and
        w_down products, the vocab-parallel lookup for wte. Head counts come
        from the shards' shapes, so RoPE, QK-norm and the GQA fold run on
        the rank's heads as they are; the routed MLP runs whole. Every rank
        of the row returns the same hidden states.

        `ep_train` (parallel/tp.py EPTrain): the routed MLP's banks are an
        ep rank's E/ep experts, and the forward places the ep group's f
        and g around them (`_moe_mlp`). Every rank of the group returns
        the same hidden states and aux term.

        `attn_fn`, `positions` and `rope_len` run the backbone on a LOCAL
        sequence shard, as JAX's hooks do (midgpt_tpu/models/gpt.py:964-981):
        `attn_fn(q, k, v)` over (B, H, T, C) replaces the config-dispatched
        attention (the sequence-parallel ring or Ulysses, bound to the mesh
        by training/train.py; K/V repeated to the query heads first, its
        output named "attn_out" for remat), and RoPE reads a table of
        `rope_len` rows at the absolute `positions` (T,) (shard g of Tl
        tokens passes g*Tl + arange(Tl)). Attention is the only op that
        mixes tokens, so nothing else changes. Injected attention refuses
        attention-probability dropout in training, as JAX's does.

        Training mode (inference=False) applies dropout at config.dropout
        from `generator` (required when dropout > 0). The lm_head projection
        is applied by `apply` (full logits) or fused into the chunked loss
        (training — ops/loss.py fused_linear_cross_entropy).

        With `config.remat`, a training forward that records gradients runs
        each block under torch.utils.checkpoint (ops/remat.py
        `checkpoint_block`): the backward recomputes the block, and
        `config.remat_policy` says what the forward keeps for it besides
        the block input —
          'none': nothing;
          'dots': the QKV, wo, w_up and w_down products, or the router,
            experts_up and combine (`midgpt::moe_down`) products of the
            routed MLP (not the batched products of naive or blockwise
            attention);
          'dots_attn': dots' tensors and the attention output (with flash,
            the forward kernel's out and lse, so it is not launched again);
          'flash': dots_attn's tensors and the rotated q and k, and v.
        Eval (`torch.no_grad`) and serving do not checkpoint. The dropout
        generator is set back for each block's recompute, so it draws the
        forward's masks."""
        if return_moe_aux and config.n_experts == 0:
            raise ValueError("return_moe_aux requires a routed MLP (n_experts > 0)")
        T = tokens.shape[1]
        vocab_sharded = tp_train is not None and tp_train.vocab
        x = tp_train.embed(params["wte"], tokens) if vocab_sharded else params["wte"][tokens]
        x = dropout(x, config.dropout, generator, inference)
        sin, cos = rope_table(config.head_dim, T if rope_len is None else rope_len, device=x.device)
        out = GPT.stage(config, params, x, range(config.n_layer), sin, cos, generator=generator,
                        inference=inference, return_moe_aux=return_moe_aux, aux_reduce=aux_reduce,
                        layer_transform=layer_transform, tp_train=tp_train, attn_fn=attn_fn, positions=positions,
                        ep_train=ep_train)
        if return_moe_aux:
            x, auxes = out
            return rms_norm(x, eps=1e-5), torch.stack(auxes).mean()
        return rms_norm(out, eps=1e-5)

    @staticmethod
    def stage(
        config: GPTConfig,
        params: Params,
        x: Tensor,
        layers: tp.Iterable[int],
        sin: Tensor,
        cos: Tensor,
        *,
        generator: tp.Optional[torch.Generator] = None,
        inference: bool = False,
        return_moe_aux: bool = False,
        aux_reduce: tp.Optional[tp.Callable[[Tensor], Tensor]] = None,
        layer_transform: tp.Optional[tp.Callable[[Params], Params]] = None,
        tp_train=None,
        attn_fn: tp.Optional[tp.Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
        positions: tp.Optional[Tensor] = None,
        ep_train=None,
    ) -> tp.Union[Tensor, tp.Tuple[Tensor, tp.List[Tensor]]]:
        """The residual stream x (B, T, D) through `layers`, a contiguous
        run of indices into the stacked block leaves of `params`, with the
        rope table (sin, cos): `hidden`'s layer loop (every layer), and a
        pipeline stage's (its L/pp local layers, parallel/pipeline.py),
        without the embedding and the final norm. The keywords are
        `hidden`'s, remat included: a training forward that records
        gradients checkpoints each block under `config.remat`. With
        return_moe_aux, returns (x, each layer's load-balance term)."""
        checkpointed = config.remat and not inference and torch.is_grad_enabled()
        policy = config.remat_policy if checkpointed else None
        auxes = []
        kw = dict(sin=sin, cos=cos, generator=generator, inference=inference, policy=policy,
                  return_moe_aux=return_moe_aux, aux_reduce=aux_reduce, tp_train=tp_train,
                  attn_fn=attn_fn, positions=positions, ep_train=ep_train)
        for i in layers:
            if layer_transform is None:
                block = functools.partial(GPT._block_apply, config, _block(params, i), **kw)
            else:
                def block(x, blk=_block(params, i)):
                    return GPT._block_apply(config, layer_transform(blk), x, **kw)
            out = remat.checkpoint_block(block, x, policy, generator) if checkpointed else block(x)
            if return_moe_aux:
                x, aux = out
                auxes.append(aux)
            else:
                x = out
        return (x, auxes) if return_moe_aux else x

    @staticmethod
    def apply(
        config: GPTConfig,
        params: Params,
        tokens: Tensor,
        *,
        generator: tp.Optional[torch.Generator] = None,
        inference: bool = False,
    ) -> Tensor:
        """Forward pass -> logits (B, T, V) in the params' floating dtype."""
        x = GPT.hidden(config, params, tokens, generator=generator, inference=inference)
        return x @ params["lm_head"].T

    @staticmethod
    def count_params(params: Params) -> int:
        """Parameter count excluding the duplicated tied embedding
        (reference model.py:161-164)."""
        return sum(p.numel() for p in params.values()) - params["lm_head"].numel()

    # ------------------------------------------------------------------
    # KV-cached decoding (the batch sampler, sampling/engine.py). Inference only.
    # ------------------------------------------------------------------

    @staticmethod
    def prefill_hidden(
        config: GPTConfig, params: Params, tokens: Tensor, cache: KVCache
    ) -> tp.Tuple[Tensor, KVCache]:
        """Run the prompt (B, T), T <= block_size, through the model, filling
        cache positions [0, T) and zeroing the rest. Attention is
        `multihead_attention` at the config's impl (flash: the forward
        kernel once per layer, or the blockwise path where its block does
        not tile T, as in JAX). The cache stores post-norm, post-RoPE keys
        and raw values, head-major, at the K/V head count.

        Returns (final-normed hidden states (B, T, D), cache with length T)."""
        T = tokens.shape[1]
        x = params["wte"][tokens.long()]
        sin, cos = rope_table(config.head_dim, T, device=x.device)
        for i in range(config.n_layer):
            blk = _block(params, i)
            q, k, v = GPT._project_qkv(config, blk, rms_norm(x))  # k/v (B, T, H_kv, C)
            qr = apply_rope_bthc(q, sin, cos, style=config.rope_style)
            kr = apply_rope_bthc(k, sin, cos, style=config.rope_style)
            att = multihead_attention(
                qr, _repeat_kv(config, kr, 2), _repeat_kv(config, v, 2),
                impl=config.attn_impl, inference=True, block_size=config.attn_block_size, layout="bthc",
                sliding_window=config.sliding_window, attn_sinks=config.attn_sinks,
            )
            x = GPT._attn_out_and_mlp(config, blk, x, att)
            for pool, new in ((cache.k, kr), (cache.v, v)):
                pool[i, :, :, :T] = new.transpose(1, 2)
                pool[i, :, :, T:] = 0
        cache.length.fill_(T)
        return rms_norm(x, eps=1e-5), cache

    @staticmethod
    def prefill(
        config: GPTConfig, params: Params, tokens: Tensor, cache: KVCache
    ) -> tp.Tuple[Tensor, KVCache]:
        """`prefill_hidden`, projected: (logits (B, T, V), cache with length
        T). The sampler projects the last position only
        (sampling/engine.py `_prefill_and_first`)."""
        x, cache = GPT.prefill_hidden(config, params, tokens, cache)
        return x @ params["lm_head"].T, cache

    @staticmethod
    def decode_step(
        config: GPTConfig, params: Params, token: Tensor, cache: KVCache
    ) -> tp.Tuple[Tensor, KVCache]:
        """One incremental decode step for the newest tokens (B,) at position
        `cache.length`, which must be below block_size (the sampler falls
        back to a windowed full forward there).

        Layer i writes its key and value into column `pos` in place, then
        attends over all S columns of the cache: scores in the query's dtype,
        `/ sqrt(C)` and the softmax in f32 under the mask `col <= pos` (and
        the sliding window with its sinks), probabilities cast back for the
        PV product. Under GQA the cache's heads are repeated for the two
        contractions only. The position stays on the device (no host read),
        so a step can be captured in a CUDA graph. The layers run as a
        Python loop: JAX's `decode_layer_scan` picks between two lowerings of
        the same function and changes nothing here.

        Returns (logits (B, V), cache with length + 1)."""
        S, C = config.block_size, config.head_dim
        pos = cache.length.reshape(1)
        x = params["wte"][token[:, None].long()]  # (B, 1, D)
        sin, cos = rope_table(C, S, device=x.device)
        visible = visible_mask(torch.arange(S, device=x.device), pos + 1, config.sliding_window, config.attn_sinks)
        for i in range(config.n_layer):
            blk = _block(params, i)
            q, k, v = GPT._project_qkv(config, blk, rms_norm(x))
            q = apply_rope_bthc(q, sin, cos, pos, style=config.rope_style).transpose(1, 2)  # (B, H, 1, C)
            k = apply_rope_bthc(k, sin, cos, pos, style=config.rope_style).transpose(1, 2)  # (B, H_kv, 1, C)
            cache.k[i][:, :, pos] = k.to(cache.k.dtype)
            cache.v[i][:, :, pos] = v.transpose(1, 2).to(cache.v.dtype)
            ck, cv = _repeat_kv(config, cache.k[i], 1), _repeat_kv(config, cache.v[i], 1)
            scores = torch.einsum("bhqc,bhkc->bhqk", q.to(ck.dtype), ck).masked_fill(~visible, float("-inf"))
            probs = torch.softmax(scores.float() / math.sqrt(C), dim=-1).to(ck.dtype)
            att = torch.einsum("bhqk,bhkc->bhqc", probs, cv)
            x = GPT._attn_out_and_mlp(config, blk, x, att.transpose(1, 2).to(x.dtype))
        x = rms_norm(x, eps=1e-5)
        cache.length.add_(1)
        return (x @ params["lm_head"].T)[:, 0], cache

    # ------------------------------------------------------------------
    # Paged decoding (continuous-batching serving engine, sampling/serve.py)
    # ------------------------------------------------------------------

    @staticmethod
    def decode_step_paged(
        config: GPTConfig,
        params: Params,
        token: Tensor,  # (B,) int — each slot's newest token
        cache: PagedKVCache,
        page_table: Tensor,  # (B, max_pages) int32 — logical -> physical page
        lengths: Tensor,  # (B,) int32 — tokens already in slot b's cache
        active: Tensor,  # (B,) bool — False: slot is empty / mid-prefill
        attn_impl: str = "auto",
        split_k: int = 1,  # key-sequence partitions per slot
        tp_shard=None,  # parallel/serve_tp.py TPShard: params and pool are this rank's shard
    ) -> tp.Tuple[Tensor, PagedKVCache]:
        """One decode step for B independent requests at B positions.

        Slot b writes its token's K/V at logical position lengths[b]
        (quantized in int8 mode) and attends to its lengths[b] + 1 valid
        tokens through the page table. Inactive slots write nothing to their
        pages (their page rows may hold real prefilled K/V; their writes go
        to the spare page, PagedKVCache) and attend to exactly one key,
        count = 1 on the sink page, producing finite logits the scheduler
        ignores. No host sync: a step can be captured in a CUDA graph. The pool is updated
        in place. A layer-prefix self-draft (sampling/spec.py) runs this
        with its n_layer-layer config against the target's whole pool: layer
        i of the draft is layer i of the pool.

        Under tensor parallelism (`tp_shard`) the params and the pool are
        this rank's shard: the step attends over its H/tp query and
        H_kv/tp pool heads and all-reduces the two row-parallel products of
        each block (`_attn_out_and_mlp`), so the residual stream and the
        logits are whole on every rank.

        Returns (logits (B, V), cache)."""
        C, ps = config.head_dim, cache.page_size
        pos = lengths.long()
        attn_counts = torch.clamp_min(active.to(torch.int32) * (lengths.to(torch.int32) + 1), 1)
        write_pages = _write_pages(page_table, pos, active, cache.num_pages, ps)
        offs = pos % ps
        x = params["wte"][token[:, None].long()]  # (B, 1, D)
        sin, cos = rope_table(C, config.block_size, device=x.device)
        positions = pos[:, None]  # (B, 1) per-slot absolute positions
        for i in range(config.n_layer):
            blk = _block(params, i)
            q, k, v = GPT._project_qkv(config, blk, rms_norm(x))
            q = apply_rope_positions(q, sin, cos, positions, style=config.rope_style)
            k = apply_rope_positions(k, sin, cos, positions, style=config.rope_style)
            q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]  # q (B, H, C), k/v (B, H_kv, C)
            _paged_write(cache.k, cache.k_scale, i, write_pages, offs, k1)
            _paged_write(cache.v, cache.v_scale, i, write_pages, offs, v1)
            kp, ksp = _layer_pages(cache.k, cache.k_scale, i)
            vp, vsp = _layer_pages(cache.v, cache.v_scale, i)
            att = paged_attention(
                q1, kp, vp, page_table, attn_counts, impl=attn_impl,
                k_scale=ksp, v_scale=vsp, split_k=split_k,
                sliding_window=config.sliding_window, attn_sinks=config.attn_sinks,
            )  # (B, H, C)
            x = GPT._attn_out_and_mlp(config, blk, x, att[:, None].to(x.dtype), tp_row=tp_shard)
        x = rms_norm(x, eps=1e-5)
        return (x @ params["lm_head"].T)[:, 0], cache

    @staticmethod
    def verify_step_paged(
        config: GPTConfig,
        params: Params,
        tokens: Tensor,  # (B, K1) int — [t_last, d_1, .., d_k] per slot
        cache: PagedKVCache,
        page_table: Tensor,  # (B, max_pages) int32
        lengths: Tensor,  # (B,) int32 — tokens already in slot b's cache
        active: Tensor,  # (B,) bool
        attn_impl: str = "auto",
        split_k: int = 1,  # key-sequence partitions per slot
        tp_shard=None,  # as decode_step_paged's
    ) -> tp.Tuple[Tensor, PagedKVCache]:
        """Score K1 = k+1 candidate tokens per slot in ONE batched paged
        forward — the target side of speculative decoding (sampling/spec.py).

        Slot b's token t sits at absolute position lengths[b] + t: its K/V
        is written there (quantized in int8 mode), all K1 columns of a layer
        before that layer's attention reads them, and its query attends to
        lengths[b] + t + 1 keys through the page table, so the per-row count
        IS the causal mask (kernels/decode_attention.py
        paged_verify_attention). Row t's logits score the token at position
        lengths[b] + t + 1: row 0 judges d_1 and row K1-1 supplies the bonus
        distribution. Inactive slots write to the spare page only and attend
        to the single sink key. Same per-layer op order as decode_step_paged,
        and no host sync either.

        Precondition (the scheduler's): lengths[b] + K1 <= block_size and
        the page table covers position lengths[b] + K1 - 1 for active slots.

        Returns (logits (B, K1, V), cache with the active slots' columns
        written)."""
        B, K1 = tokens.shape
        C, ps = config.head_dim, cache.page_size
        t_idx = torch.arange(K1, device=tokens.device)
        positions = lengths.long()[:, None] + t_idx[None, :]  # (B, K1)
        attn_counts = torch.clamp_min(active.to(torch.int32)[:, None] * (positions.to(torch.int32) + 1), 1)
        write_pages = _write_pages(page_table, positions, active[:, None], cache.num_pages, ps).reshape(-1)
        offs = (positions % ps).reshape(-1)
        x = params["wte"][tokens.long()]  # (B, K1, D)
        sin, cos = rope_table(C, config.block_size, device=x.device)
        for i in range(config.n_layer):
            blk = _block(params, i)
            q, k, v = GPT._project_qkv(config, blk, rms_norm(x))
            q = apply_rope_positions(q, sin, cos, positions, style=config.rope_style)
            k = apply_rope_positions(k, sin, cos, positions, style=config.rope_style)
            H = k.shape[2]
            _paged_write(cache.k, cache.k_scale, i, write_pages, offs, k.reshape(-1, H, C))
            _paged_write(cache.v, cache.v_scale, i, write_pages, offs, v.reshape(-1, H, C))
            kp, ksp = _layer_pages(cache.k, cache.k_scale, i)
            vp, vsp = _layer_pages(cache.v, cache.v_scale, i)
            att = paged_verify_attention(
                q, kp, vp, page_table, attn_counts, impl=attn_impl,
                k_scale=ksp, v_scale=vsp, split_k=split_k,
                sliding_window=config.sliding_window, attn_sinks=config.attn_sinks,
            )  # (B, K1, H, C)
            x = GPT._attn_out_and_mlp(config, blk, x, att.to(x.dtype), tp_row=tp_shard)
        x = rms_norm(x, eps=1e-5)
        return x @ params["lm_head"].T, cache

    @staticmethod
    def prefill_paged_chunk(
        config: GPTConfig,
        params: Params,
        tokens: Tensor,  # (1, T_c) int — one request's prompt chunk, padded
        start: int,  # absolute position of tokens[0, 0]
        n_valid: int,  # real tokens in this chunk (the rest is pad)
        cache: PagedKVCache,
        page_table: Tensor,  # (1, max_pages) int32
        tp_shard=None,  # as decode_step_paged's
    ) -> tp.Tuple[Tensor, PagedKVCache]:
        """Prefill ONE request's prompt chunk [start, start + n_valid) into
        its pages, attending causally to the chunk itself plus everything
        the slot already holds. Pad positions write nothing (masked out
        here); their logits are garbage the caller ignores. Attention is
        the gather lowering: the slot's pages gathered contiguous once per
        layer (dequantized to the activations' dtype in int8 mode), every
        chunk row masked to its own count.

        Returns (logits (1, T_c, V), cache)."""
        T_c = tokens.shape[1]
        C, ps = config.head_dim, cache.page_size
        dev = tokens.device
        positions = start + torch.arange(T_c, device=dev)  # (T_c,)
        write_pages = page_table[0, positions[:n_valid] // ps].long()
        offs = positions[:n_valid] % ps
        x = params["wte"][tokens.long()]  # (1, T_c, D)
        sin, cos = rope_table(C, config.block_size, device=dev)
        # Row t attends to start + t + 1 keys; pad rows clamp to the last
        # valid count (their output is discarded).
        attn_counts = torch.clamp_max(positions, start + n_valid - 1) + 1
        for i in range(config.n_layer):
            blk = _block(params, i)
            q, k, v = GPT._project_qkv(config, blk, rms_norm(x))
            qr = apply_rope_bthc(q, sin, cos, positions, style=config.rope_style)
            kr = apply_rope_bthc(k, sin, cos, positions, style=config.rope_style)
            _paged_write(cache.k, cache.k_scale, i, write_pages, offs, kr[0, :n_valid])
            _paged_write(cache.v, cache.v_scale, i, write_pages, offs, v[0, :n_valid])
            kg = _gather_layer_kv(*_layer_pages(cache.k, cache.k_scale, i), page_table[0], x.dtype)
            vg = _gather_layer_kv(*_layer_pages(cache.v, cache.v_scale, i), page_table[0], x.dtype)
            # GQA: the gathered (H_kv, S, C) buffers repeat to the query heads
            kg, vg = _repeat_kv(config, kg, 0), _repeat_kv(config, vg, 0)
            S = kg.shape[1]
            scores = torch.einsum("thc,hsc->hts", qr[0].to(kg.dtype), kg)
            ok = visible_mask(
                torch.arange(S, device=dev)[None, None, :], attn_counts[None, :, None],
                config.sliding_window, config.attn_sinks,
            )
            scores = scores.masked_fill(~ok, float("-inf"))
            probs = torch.softmax(scores.float() / math.sqrt(C), dim=-1).to(kg.dtype)
            att = torch.einsum("hts,hsc->thc", probs, vg)  # (T_c, H, C)
            x = GPT._attn_out_and_mlp(config, blk, x, att[None].to(x.dtype), tp_row=tp_shard)
        x = rms_norm(x, eps=1e-5)
        return x @ params["lm_head"].T, cache
