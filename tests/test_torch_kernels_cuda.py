"""The port's CUDA kernels against their plain PyTorch versions, on the
card (paged attention: the decode, verify, int8, GQA-fold and window specs,
the merge of its partitions and its capture in a CUDA graph; flash
attention: forward and both backward kernels, causal and full), and the decode step and the
overlap modes' fused decode group as CUDA-graph replays (bit for bit
against eager runs, launch tallies per replay, two groups in flight, a
capture beside another thread's sync), and the serving front door's
device side (the kernel on page tables that alias pages, replays after an
in-place hot swap, a resize dropping the old pool's captures, steps from
two threads).
Every test here needs an
NVIDIA GPU and skips with a reason without one. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances (kernel vs plain on the same inputs): float32 1e-5 absolute
and relative (summation order only); bfloat16 1e-2 — an f32 sum taken in
another order can move a bf16 rounding of p or of the output by one ulp.
Flash gradients are held relative to their largest magnitude: float32
1e-5 and bfloat16 1e-2 of max |want| absolute, plus the same relative.
TF32 is off so the plain version's f32 products are full f32."""

import math

import pytest
import torch

from midgpt_tpu_torch.kernels import attention_template as tpl
from midgpt_tpu_torch.kernels import flash_attention as fa
from midgpt_tpu_torch.kernels.decode_attention import paged_attention_kernel, paged_verify_attention_kernel
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache
from midgpt_tpu_torch.ops.online_softmax import M_INIT, finalize, merge_partials
from midgpt_tpu_torch.ops.quant import quantize_q8
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, dtype, B, H, C, ps, max_pages, counts, seed=0):
    g = torch.Generator().manual_seed(seed)
    need = [-(-c // ps) for c in counts]
    num_pages = 1 + sum(need) + 3
    perm = (torch.randperm(num_pages - 1, generator=g) + 1).tolist()
    table = torch.zeros(B, max_pages, dtype=torch.int32)
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    q = torch.randn(B, H, C, generator=g)
    k = torch.randn(H, num_pages, ps, C, generator=g)
    v = torch.randn(H, num_pages, ps, C, generator=g)
    cnt = torch.tensor(counts, dtype=torch.int32)
    return [t.to(dev, dtype) for t in (q, k, v)] + [table.to(dev), cnt.to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,C,ps,max_pages,counts,split_k",
    [
        (4, 2, 64, 8, 8, [19, 45, 1, 64], 1),
        (4, 2, 64, 8, 8, [19, 45, 1, 64], 2),
        (4, 2, 64, 8, 8, [19, 45, 1, 64], 4),
        (4, 12, 64, 8, 128, [1024, 700, 300, 1], 1),
        (4, 12, 64, 8, 128, [1024, 700, 300, 1], 2),
        (2, 4, 128, 16, 32, [500, 17], 8),
        (3, 2, 32, 8, 4, [0, 9, 32], 1),  # a count-0 slot gives a finite 0
        (3, 2, 16, 8, 4, [0, 9, 32], 2),  # head_dim 16: the serving chaos scenarios' tiny model
        (2, 2, 512, 8, 16, [128, 77], 2),  # widest head: tiles shrink to fit shared memory
    ],
)
def test_kernel_matches_plain(cuda, dtype, B, H, C, ps, max_pages, counts, split_k):
    q, k, v, table, cnt = _problem(cuda, dtype, B, H, C, ps, max_pages, counts)
    before = tpl.LAUNCHES.count
    got = paged_attention_kernel(q, k, v, table, cnt, split_k=split_k)
    torch.cuda.synchronize()
    assert tpl.LAUNCHES.count == before + 1
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, cnt[:, None], split_k=split_k)[:, :, 0]
    assert got.dtype == dtype and got.shape == (B, H, C)
    assert torch.isfinite(got).all()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for b, c in enumerate(counts):
        if c == 0:
            assert (got[b] == 0).all()


@pytest.mark.cuda
def test_decode_step_through_kernel_matches_gather(cuda):
    cfg = GPTConfig(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=128, rope_style="split")
    params = GPT.init(cfg, 0, device=cuda)
    table = torch.tensor([[3, 7, 1, 0], [5, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32, device=cuda)
    out = []
    for impl in ("gather", "kernel"):
        cache = PagedKVCache.init(cfg, num_pages=10, page_size=8, dtype=torch.float32, device=cuda)
        torch.manual_seed(0)
        cache.k.normal_()
        cache.v.normal_()
        logits, cache = GPT.decode_step_paged(
            cfg, params, torch.tensor([4, 9, 0], device=cuda), cache, table,
            torch.tensor([19, 11, 0], dtype=torch.int32, device=cuda),
            torch.tensor([True, True, False], device=cuda), attn_impl=impl, split_k=2,
        )
        out.append(logits)
    torch.testing.assert_close(out[1], out[0], atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("split_k", [1, 2])
def test_kernel_takes_an_f32_query_over_bf16_pools(cuda, split_k):
    """JAX's template promotes an f32 query over a bf16 pool: f32 scores
    and statistics, p rounded to the pool's bf16 before PV, f32 output."""
    q, k, v, table, cnt = _problem(cuda, torch.float32, 4, 12, 64, 8, 128, [1024, 700, 300, 1])
    k, v = k.bfloat16(), v.bfloat16()
    got = paged_attention_kernel(q, k, v, table, cnt, split_k=split_k)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, cnt[:, None], split_k=split_k)[:, :, 0]
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, table, cnt = _problem(cuda, torch.float32, 2, 2, 64, 8, 4, [5, 9])
    with pytest.raises(NotImplementedError):
        paged_attention_kernel(q, k.bfloat16(), v, table, cnt)  # pools of two dtypes
    q, k, v, table, cnt = _problem(cuda, torch.float32, 2, 2, 2, 3, 4, [5, 9])
    with pytest.raises(ValueError):
        paged_attention_kernel(q, k, v, table, cnt)  # a 3 x 2 f32 page is 24 bytes


def _verify_problem(dev, qdtype, pool, B, H, C, ps, max_pages, lengths, R, seed=0):
    """q (B, H, R, C), pools (bf16/f32, or int8 codes with (P, H, ps) f32
    scales), table and (B, R) counts lengths + t + 1 (1 for a length-0
    slot, as the verify step gives an inactive one)."""
    q, k, v, table, _ = _problem(dev, torch.float32, B, H, C, ps, max_pages, [c + R for c in lengths], seed)
    q = torch.randn(B, H, R, C, generator=torch.Generator().manual_seed(seed + 1)).to(dev, qdtype)
    t = torch.arange(R, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    counts = torch.where(lens[:, None] > 0, lens[:, None] + t + 1, 1).to(torch.int32)
    if pool == torch.int8:
        (k, ks), (v, vs) = (quantize_q8(x.transpose(0, 1)) for x in (k, v))  # per (page, head, position)
        return q, k.transpose(0, 1).contiguous(), v.transpose(0, 1).contiguous(), ks, vs, table, counts
    return q, k.to(pool), v.to(pool), None, None, table, counts


@pytest.mark.cuda
@pytest.mark.parametrize(
    "qdtype,pool", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                    (torch.float32, torch.int8), (torch.bfloat16, torch.int8)],
    ids=["f32", "bf16", "int8-f32q", "int8-bf16q"],
)
@pytest.mark.parametrize(
    "B,H,C,ps,max_pages,lengths,R,split_k",
    [
        (4, 2, 64, 8, 8, [18, 40, 0, 58], 3, 1),
        (4, 2, 64, 8, 8, [18, 40, 0, 58], 5, 2),
        (4, 12, 64, 8, 128, [1019, 695, 295, 0], 5, 1),
        (4, 12, 64, 8, 128, [1015, 691, 291, 0], 9, 2),
        (2, 4, 128, 16, 32, [480, 9], 16, 8),  # the row ceiling
        (3, 2, 64, 8, 4, [0, 9, 27], 1, 1),  # the decode spec over the same pools
    ],
)
def test_verify_and_int8_kernel_matches_plain(cuda, qdtype, pool, B, H, C, ps, max_pages, lengths, R, split_k):
    q, k, v, ks, vs, table, counts = _verify_problem(cuda, qdtype, pool, B, H, C, ps, max_pages, lengths, R)
    before = dict(tpl.LAUNCHES.by_variant)
    got = tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k)
    torch.cuda.synchronize()
    key = (tpl.spec_name(R, pool == torch.int8), tpl.normalize_split_k(split_k, max_pages))
    assert tpl.LAUNCHES.by_variant[key] == before.get(key, 0) + 1
    want = tpl.paged_attention_template_plain(q, k, v, table, counts, ks, vs, split_k=split_k)
    assert got.dtype == qdtype and got.shape == (B, H, R, C) and torch.isfinite(got).all()
    tol = TOL[qdtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("split_k", [1, 2])
def test_verify_rows_equal_decode_rows_bit_for_bit(cuda, pool, split_k):
    """A row's arithmetic does not depend on R: every row of a verify launch
    equals the decode launch at that row's count, bit for bit — what keeps
    greedy speculation token-identical to plain decode on the card."""
    q, k, v, ks, vs, table, counts = _verify_problem(
        cuda, torch.float32 if pool == torch.int8 else pool, pool, 4, 12, 64, 8, 128, [1015, 691, 291, 0], 9)
    rows = tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k)
    for t in range(9):
        one = tpl.paged_attention_template(q[:, :, t : t + 1].contiguous(), k, v, table,
                                           counts[:, t : t + 1].contiguous(), ks, vs, split_k=split_k)
        assert torch.equal(rows[:, :, t], one[:, :, 0]), f"row {t}"


@pytest.mark.cuda
def test_kernel_refuses_bad_verify_and_int8_args(cuda):
    q, k, v, ks, vs, table, counts = _verify_problem(cuda, torch.float32, torch.int8, 2, 2, 64, 8, 4, [5, 9], 3)
    with pytest.raises(ValueError, match="k_scale"):
        tpl.paged_attention_template(q, k, v, table, counts)  # int8 pools without scales
    with pytest.raises(ValueError, match="k_scale"):
        tpl.paged_attention_template(q, k, v, table, counts, ks.transpose(0, 1).contiguous(), vs)
    rows = tpl.MAX_ROW_CHANNELS // 64 + 1  # one row past the kernel's rows x channels
    wide = torch.zeros(2, 2, rows, 64, device=cuda)
    with pytest.raises(ValueError, match="rows"):
        tpl.paged_attention_template(wide, k, v, table, torch.ones(2, rows, dtype=torch.int32, device=cuda), ks, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_verify_step_through_kernel_matches_gather(cuda, dtype):
    """One verify forward (K1 = 5, one slot inactive) through the kernel
    and through the gather lowering, f32 activations: the logits within
    2e-5 (the int8 kernel reads f32 dequantized values and the gather casts
    them to f32 too), the pools within 2e-5 (int8: codes within one step,
    scales within 1e-5 relative)."""
    cfg = GPTConfig(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=128, rope_style="split")
    params = GPT.init(cfg, 0, device=cuda)
    table = torch.tensor([[3, 7, 1, 0], [5, 2, 4, 0], [0, 0, 0, 0]], dtype=torch.int32, device=cuda)
    out = []
    for impl in ("gather", "kernel"):
        cache = PagedKVCache.init(cfg, num_pages=10, page_size=8, dtype=dtype, device=cuda)
        torch.manual_seed(0)
        if dtype == torch.int8:
            cache.k.random_(-127, 128)
            cache.v.random_(-127, 128)
            cache.k_scale.uniform_(0.001, 0.02)
            cache.v_scale.uniform_(0.001, 0.02)
        else:
            cache.k.normal_()
            cache.v.normal_()
        logits, cache = GPT.verify_step_paged(
            cfg, params, torch.tensor([[4, 9, 1, 2, 3], [7, 8, 5, 6, 0], [0] * 5], device=cuda), cache, table,
            torch.tensor([19, 11, 0], dtype=torch.int32, device=cuda),
            torch.tensor([True, True, False], device=cuda), attn_impl=impl, split_k=2,
        )
        out.append((logits, cache))
    (lg, cg), (lk, ck) = out
    torch.testing.assert_close(lk[:2], lg[:2], atol=2e-5, rtol=0)
    for a, b in ((ck.k, cg.k), (ck.v, cg.v)):
        if dtype == torch.int8:  # layer 1's K/V differ by ulps: a code may tip by one step
            assert (a.int() - b.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    if dtype == torch.int8:
        for a, b in ((ck.k_scale, cg.k_scale), (ck.v_scale, cg.v_scale)):
            torch.testing.assert_close(a, b, atol=0, rtol=1e-5)


# GQA fold and sliding window (template rows 7'c, 7'd) at the serving main
# path's geometry (12 query heads over 3 K/V heads of 64: local_text_124m
# with n_kv_heads=3) and llama7b_long's (32 over 8 of 128): (B, H_q, H_kv,
# C, page size, table width, slot lengths before the R rows)
GQA_GEOMETRIES = {
    "main": (4, 12, 3, 64, 8, 128, [1015, 691, 291, 0]),
    "llama": (2, 32, 8, 128, 8, 512, [3990, 1400]),
}


def _gqa_problem(dev, qdtype, pool, geometry, R, seed=0):
    """q (B, H_q, R, C) over pools at H_kv heads, counts lengths + t + 1."""
    B, HQ, HKV, C, ps, max_pages, lengths = GQA_GEOMETRIES[geometry]
    _, k, v, ks, vs, table, counts = _verify_problem(dev, qdtype, pool, B, HKV, C, ps, max_pages, lengths, R, seed)
    q = torch.randn(B, HQ, R, C, generator=torch.Generator().manual_seed(seed + 2)).to(dev, qdtype)
    return q, k, v, ks, vs, table, counts


@pytest.mark.cuda
@pytest.mark.parametrize(
    "qdtype,pool", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8)],
    ids=["f32", "bf16", "int8-bf16q"],
)
@pytest.mark.parametrize("window,sinks", [(0, 0), (256, 4)], ids=["full", "window"])
@pytest.mark.parametrize("R", [1, 5, 9])
@pytest.mark.parametrize("geometry", list(GQA_GEOMETRIES))
@pytest.mark.parametrize("split_k", [1, 2])
def test_gqa_window_kernel_matches_plain(cuda, qdtype, pool, window, sinks, R, geometry, split_k):
    """The folded rows (G*R: 4 to 36 of 64 or 128 channels) and the
    windowed page sweep against the plain version, one launch of the
    spec's counter key each."""
    q, k, v, ks, vs, table, counts = _gqa_problem(cuda, qdtype, pool, geometry, R)
    groups = q.shape[1] // k.shape[0]
    before = dict(tpl.LAUNCHES.by_variant)
    got = tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k,
                                       sliding_window=window, attn_sinks=sinks)
    torch.cuda.synchronize()
    key = (tpl.spec_name(R, pool == torch.int8, groups, window), split_k)
    assert tpl.LAUNCHES.by_variant[key] == before.get(key, 0) + 1
    want = tpl.paged_attention_template_plain(q, k, v, table, counts, ks, vs, split_k=split_k,
                                              sliding_window=window, attn_sinks=sinks)
    assert got.dtype == qdtype and got.shape == q.shape and torch.isfinite(got).all()
    tol = TOL[qdtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(GQA_GEOMETRIES))
@pytest.mark.parametrize("split_k", [1, 2])
def test_full_window_and_gqa_rows_bit_for_bit(cuda, geometry, split_k):
    """A window at least every count gives exactly the windowless output;
    every row of a windowed GQA verify launch equals the windowed GQA decode
    launch at that row's count (a row's arithmetic depends on neither R nor
    the fold)."""
    q, k, v, ks, vs, table, counts = _gqa_problem(cuda, torch.bfloat16, torch.bfloat16, geometry, 5, seed=3)
    base = tpl.paged_attention_template(q, k, v, table, counts, split_k=split_k)
    wide = tpl.paged_attention_template(q, k, v, table, counts, split_k=split_k, sliding_window=table.shape[1] * 8,
                                        attn_sinks=4)
    assert torch.equal(wide, base)
    win = dict(split_k=split_k, sliding_window=256, attn_sinks=4)
    rows = tpl.paged_attention_template(q, k, v, table, counts, **win)
    for t in range(5):
        one = tpl.paged_attention_template(q[:, :, t : t + 1].contiguous(), k, v, table,
                                           counts[:, t : t + 1].contiguous(), **win)
        assert torch.equal(rows[:, :, t], one[:, :, 0]), f"row {t}"


@pytest.mark.cuda
def test_gqa_window_decode_step_through_kernel_matches_gather(cuda):
    """A GQA + window decode step (f32) through the kernel and the gather."""
    cfg = GPTConfig(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=128, rope_style="split",
                    n_kv_heads=2, sliding_window=12, attn_sinks=3)
    params = GPT.init(cfg, 0, device=cuda)
    table = torch.tensor([[3, 7, 1, 8], [5, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32, device=cuda)
    out = []
    for impl in ("gather", "kernel"):
        cache = PagedKVCache.init(cfg, num_pages=10, page_size=8, dtype=torch.float32, device=cuda)
        torch.manual_seed(0)
        cache.k.normal_()
        cache.v.normal_()
        logits, cache = GPT.decode_step_paged(
            cfg, params, torch.tensor([4, 9, 0], device=cuda), cache, table,
            torch.tensor([27, 11, 0], dtype=torch.int32, device=cuda),
            torch.tensor([True, True, False], device=cuda), attn_impl=impl, split_k=2,
        )
        out.append(logits)
    torch.testing.assert_close(out[1], out[0], atol=2e-5, rtol=0)


def _partials(dev, B, n_parts, H, R, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(B, n_parts, H, R, generator=g) * 4
    l = torch.rand(B, n_parts, H, R, generator=g) * 3 + 0.5
    acc = torch.randn(B, n_parts, H, R, C, generator=g)
    return m.to(dev), l.to(dev), acc.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n_parts,H,R,C", [(4, 32, 12, 1, 64), (4, 32, 3, 20, 64), (2, 5, 2, 3, 512)])
def test_merge_kernel_matches_plain(cuda, dtype, B, n_parts, H, R, C):
    """The merge kernel against merge_partials + finalize (f32 sums in
    another order: the dtype's tolerance), with neutral partitions (M_INIT,
    0, 0) in every row and one all-neutral row, which gives exactly 0."""
    m, l, acc = _partials(cuda, B, n_parts, H, R, C)
    m[:, 1::3], l[:, 1::3], acc[:, 1::3] = M_INIT, 0.0, 0.0
    m[0, :, 0, 0], l[0, :, 0, 0], acc[0, :, 0, 0] = M_INIT, 0.0, 0.0
    before = tpl.MERGE_LAUNCHES.count
    got = tpl.merge_partitions(m, l, acc, dtype)
    torch.cuda.synchronize()
    assert tpl.MERGE_LAUNCHES.count == before + 1
    out, _ = finalize(*merge_partials(m, l, acc, axis=1))
    assert got.dtype == dtype and got.shape == (B, H, R, C) and torch.isfinite(got).all()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), out.to(dtype).float(), atol=tol, rtol=tol)
    assert (got[0, 0, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_kernel_neutral_and_single_partitions_bit_for_bit(cuda, dtype):
    """Neutral partitions add exact zeros (the merge adds in ascending
    order), and a merge of one partition is exactly its acc / max(l, 1e-30)."""
    m, l, acc = _partials(cuda, 3, 6, 4, 5, 64, seed=1)
    m[:, 3:], l[:, 3:], acc[:, 3:] = M_INIT, 0.0, 0.0
    assert torch.equal(tpl.merge_partitions(m, l, acc, dtype),
                       tpl.merge_partitions(m[:, :3].contiguous(), l[:, :3].contiguous(), acc[:, :3].contiguous(),
                                            dtype))
    one = tpl.merge_partitions(m[:, :1].contiguous(), l[:, :1].contiguous(), acc[:, :1].contiguous(), dtype)
    assert torch.equal(one, (acc[:, 0] / l[:, 0, ..., None].clamp_min(1e-30)).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "qdtype,pool", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8)],
    ids=["f32", "bf16", "int8-bf16q"],
)
@pytest.mark.parametrize("geometry,R", [("main", 1), ("main", 9), ("llama", 5)])
def test_template_over_many_partitions(cuda, qdtype, pool, geometry, R):
    """A page bucket cut into more than 8 partitions (128 pages: 32; 512
    pages at C 128: 32), with slots whose pages end in different
    partitions: one launch of each kernel, the plain version's result."""
    q, k, v, ks, vs, table, counts = _gqa_problem(cuda, qdtype, pool, geometry, R, seed=5)
    max_pages, ps, C = table.shape[1], k.shape[2], k.shape[3]
    assert max_pages // tpl.partition_pages(max_pages, 1, ps, C) > 8
    before = (tpl.LAUNCHES.count, tpl.MERGE_LAUNCHES.count)
    got = tpl.paged_attention_template(q, k, v, table, counts, ks, vs)
    torch.cuda.synchronize()
    assert (tpl.LAUNCHES.count, tpl.MERGE_LAUNCHES.count) == (before[0] + 1, before[1] + 1)
    want = tpl.paged_attention_template_plain(q, k, v, table, counts, ks, vs)
    tol = TOL[qdtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize(
    "C,ps,R,max_pages",
    [
        (96, 8, 1, 128),  # C % 64 == 32: a 32-channel item after the 64-channel one
        (96, 16, 5, 64),
        (160, 8, 3, 64),
        (224, 32, 36, 16),  # 8064 rows x channels
        (32, 8, 256, 1024),  # the most rows, at a 32-page partition
        (512, 32, 16, 32),  # the widest head at 8192 rows x channels
    ],
)
def test_tensor_core_kernel_at_every_width(cuda, pool, C, ps, R, max_pages):
    """bf16 queries over bf16 or int8 pools take the tensor-core kernel at
    every head_dim that is a multiple of 32, with the most rows a block
    takes, against the plain version."""
    assert tpl._kernel_lib().paged_attention_tensor_cores(1, tpl._KV_CODE[pool], ps, C) == 1
    keys = max_pages * ps
    q, k, v, ks, vs, table, counts = _verify_problem(
        cuda, torch.bfloat16, pool, 3, 2, C, ps, max_pages, [keys - R - 5, keys // 3, 0], R)
    got = tpl.paged_attention_template(q, k, v, table, counts, ks, vs)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q, k, v, table, counts, ks, vs)
    assert got.shape == (3, 2, R, C) and torch.isfinite(got).all()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["decode", "gqa-verify", "int8-decode", "int8-gqa-verify"])
@pytest.mark.parametrize("split_k", [1, 2])
def test_template_captured_in_a_cuda_graph(cuda, spec, split_k):
    """Both launches of a template call replay from a CUDA graph and give
    the eager call's bits (no host sync, no attribute call in capture)."""
    pool = torch.int8 if spec.startswith("int8") else torch.bfloat16
    R = 5 if spec.endswith("verify") else 1
    q, k, v, ks, vs, table, counts = _gqa_problem(cuda, torch.bfloat16, pool, "main", R, seed=6)
    if "gqa" not in spec:  # MHA: every query head its own K/V head
        q = q[:, : k.shape[0]].contiguous()
    eager = tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    counts[0] = torch.clamp(counts[0] - 300, min=1)  # read at replay: no new capture for new counts
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k))


def _flash_inputs(dev, dtype, N, T, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(N, T, C, generator=g).to(dev, dtype) for _ in range(4)]


def _close_scaled(got, want, tol):
    """|got - want| <= tol * max|want| + tol * |want|."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "N,T,C,bq,bk",
    [
        (3, 256, 64, 512, 1024),  # single visit (bodies 1, 3)
        (2, 256, 128, 64, 128),  # tiled (bodies 2, 5, 6)
        (2, 200, 64, 64, 64),  # ragged T: the KV block widens to T, tiles mask their edge
        (2, 96, 128, 32, 32),  # tiled with chunks narrower than the kernel's tile
        (2, 256, 128, 512, 1024),  # single visit at C 128
        (2, 77, 64, 512, 1024),  # T not a multiple of 16: zero-filled rows past T
        (2, 77, 128, 512, 1024),
        (2, 128, 64, 32, 32),  # tiled, chunks of 32 inside the kernel's 64-column tiles at C 64
    ],
)
def test_flash_kernels_match_plain(cuda, dtype, N, T, C, bq, bk):
    q, k, v, do = _flash_inputs(cuda, dtype, N, T, C)
    counters = (fa.FWD_LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    before = [c.count for c in counters]
    out, lse = fa.flash_forward(q, k, v, bq, bk)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, bq, bk)
    torch.cuda.synchronize()
    assert [c.count for c in counters] == [b + 1 for b in before]
    want_out, want_lse = fa.flash_forward_plain(q, k, v, bq, bk)
    tol = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    # the backward from the kernel's own residuals, on both sides
    grads = fa.flash_backward_plain(q, k, v, out, lse, do, bq, bk)
    for got, want in zip((dq, dk, dv), grads):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _close_scaled(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "N,T,C,bq,bk",
    [(3, 256, 64, 512, 1024), (2, 256, 128, 64, 128), (2, 200, 64, 64, 64), (2, 77, 128, 512, 1024)],
)
def test_full_flash_kernels_match_plain(cuda, dtype, N, T, C, bq, bk):
    """causal=False (ring attention's off-diagonal pairs: every key visible
    to every row) against the plain version, single visit, tiled and
    ragged; the launches land on the causal=False counters only."""
    q, k, v, do = _flash_inputs(cuda, dtype, N, T, C, seed=6)
    full = fa._COUNTERS[False]
    before = [c.count for c in (*fa._COUNTERS[True], *full)]
    out, lse = fa.flash_forward(q, k, v, bq, bk, causal=False)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, bq, bk, causal=False)
    torch.cuda.synchronize()
    assert [c.count for c in (*fa._COUNTERS[True], *full)] == before[:3] + [b + 1 for b in before[3:]]
    want_out, want_lse = fa.flash_forward_plain(q, k, v, bq, bk, causal=False)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    for got, want in zip((dq, dk, dv), fa.flash_backward_plain(q, k, v, out, lse, do, bq, bk, causal=False)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _close_scaled(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 128])
def test_flash_kernels_at_one_token(cuda, dtype, C):
    """T = 1: one row sees one key, so p = 1, out = v, lse = q.k / sqrt(C)
    and dv = dout exactly. dq and dk are exactly 0 in exact arithmetic (dp
    and delta are the same dot product, dout . v); computed, they are the
    difference of two f32 sums of C terms taken in different orders, each
    within C * 2^-24 of the sum of the terms' magnitudes, so they are held
    to twice that difference's bound, 4 C 2^-24 of that sum, not to the
    plain version's equally noisy values."""
    N = 3
    q, k, v, do = _flash_inputs(cuda, dtype, N, 1, C, seed=4)
    out, lse = fa.flash_forward(q, k, v)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    scale = C ** -0.5
    assert torch.equal(out, v) and torch.equal(dv, do)
    want_lse = (q.float() * k.float()).sum(-1) * scale
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    terms = (do.float() * v.float()).abs().sum(-1, keepdim=True) * scale  # (N, 1, 1): sum |dout * v| / sqrt(C)
    for name, got, other in (("dq", dq, k), ("dk", dk, q)):
        bound = 4 * C * 2.0**-24 * terms * other.float().abs().amax(-1, keepdim=True)
        assert (got.float().abs() <= bound).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,C,bq,bk", [(4, 256, 64, 512, 1024), (2, 200, 128, 64, 64)])
def test_flash_kernels_repeat_bit_for_bit(cuda, N, T, C, bq, bk):
    """No atomics: two launches on the same bf16 inputs give the same bits
    of out, lse, dq, dk and dv."""
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, N, T, C, seed=2)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_forward(q, k, v, bq, bk)
        runs.append((out, lse, *fa.flash_backward(q, k, v, out, lse, do, bq, bk)))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_kernels_refuse_misaligned_tensors(cuda):
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 2, 64, 64)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)  # 2 bytes in
    shifted.copy_(q)
    before = fa.FWD_LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_forward(shifted, k, v, 64, 64)
    assert fa.FWD_LAUNCHES.count == before


@pytest.mark.cuda
def test_flash_autograd_through_kernels(cuda):
    q, k, v, _ = _flash_inputs(cuda, torch.float32, 4, 128, 64, seed=1)
    q, k, v = (t.reshape(2, 2, 128, 64) for t in (q, k, v))
    grads = []
    for dev in (cuda, torch.device("cpu")):  # the kernels, then the plain version
        qs, ks, vs = (t.detach().to(dev).requires_grad_() for t in (q, k, v))
        torch.sin(fa.flash_attention(qs, ks, vs, 64, 128)).sum().backward()
        grads.append([t.grad.cpu() for t in (qs, ks, vs)])
    for got, want in zip(*grads):
        _close_scaled(got, want, 1e-5)


@pytest.mark.cuda
def test_flash_kernel_refuses_other_head_dims(cuda):
    q, k, v, _ = _flash_inputs(cuda, torch.float32, 2, 64, 96)
    before = fa.FWD_LAUNCHES.count
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_forward(q, k, v, 64, 64)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_attention(q[None], k[None], v[None], 64, 64)
    assert fa.FWD_LAUNCHES.count == before


# ---------------------------------------------------------------- CUDA-graph replays of the decode loop

GRAPH_CFG = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=128, rope_style="split")


def _graph_params(dev, dtype, **extra):
    from midgpt_tpu_torch.utils.precision import cast_floating

    return cast_floating(GPT.init(GPTConfig(**GRAPH_CFG, **extra), 0, device=dev), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_captured_in_a_cuda_graph(cuda, dtype):
    """A captured decode step replays the eager step bit for bit (logits and
    pool pages) for two sets of new inputs copied into its static buffers,
    and one replay counts n_layer template and merge launches."""
    from midgpt_tpu_torch.kernels.build import CaptureTally

    cfg = GPTConfig(**GRAPH_CFG)
    params = _graph_params(cuda, dtype)
    graph_cache = PagedKVCache.init(cfg, num_pages=10, page_size=8, dtype=dtype, device=cuda)
    torch.manual_seed(0)
    graph_cache.k.normal_()
    graph_cache.v.normal_()
    eager_cache = PagedKVCache(k=graph_cache.k.clone(), v=graph_cache.v.clone())
    # static inputs, first all inactive: the warm-up writes the spare page only
    token = torch.zeros(3, dtype=torch.int64, device=cuda)
    table = torch.zeros(3, 4, dtype=torch.int32, device=cuda)
    lengths = torch.zeros(3, dtype=torch.int32, device=cuda)
    active = torch.zeros(3, dtype=torch.bool, device=cuda)

    def step(cache):
        return GPT.decode_step_paged(cfg, params, token, cache, table, lengths, active, attn_impl="kernel")[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(graph_cache)
    torch.cuda.current_stream().wait_stream(side)
    n = graph_cache.num_pages
    assert torch.equal(graph_cache.k[:, :, :n], eager_cache.k[:, :, :n])
    graph, tally = torch.cuda.CUDAGraph(), CaptureTally()
    before = (tpl.LAUNCHES.count, tpl.MERGE_LAUNCHES.count)
    with tally, torch.cuda.graph(graph):
        logits = step(graph_cache)
    assert (tpl.LAUNCHES.count, tpl.MERGE_LAUNCHES.count) == before  # a capture launches nothing
    inputs = [([4, 9, 0], [[3, 7, 1, 0], [5, 2, 0, 0], [0, 0, 0, 0]], [19, 11, 0], [True, True, False]),
              ([8, 1, 30], [[3, 7, 1, 0], [5, 2, 0, 0], [6, 8, 0, 0]], [20, 12, 9], [True, False, True])]
    for tok, tab, lens, act in inputs:
        for static, value in ((token, tok), (table, tab), (lengths, lens), (active, act)):
            static.copy_(torch.tensor(value, dtype=static.dtype))
        graph.replay()
        tally.replayed()
        want = step(eager_cache)
        torch.cuda.synchronize()
        assert torch.equal(logits, want)
        assert torch.equal(graph_cache.k[:, :, :n], eager_cache.k[:, :, :n])
        assert torch.equal(graph_cache.v[:, :, :n], eager_cache.v[:, :, :n])
    # two replays and two eager steps: n_layer launches of each kernel apiece
    assert tpl.LAUNCHES.count - before[0] == tpl.MERGE_LAUNCHES.count - before[1] == 4 * cfg.n_layer


def _group_engines(dev, dtype, **extra):
    """Two engines on the same weights and the same random pool: one
    replays captured groups, the other runs the same body eagerly. `extra`
    adds GPTConfig fields (the routed MLP)."""
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    cfg = GPTConfig(**GRAPH_CFG, **extra)
    params = _graph_params(dev, dtype, **extra)
    engines = []
    for _ in range(2):
        eng = ServeEngine(cfg, params, max_slots=3, page_size=8, num_pages=12, decode_chunk=4,
                          cache_dtype=dtype, device=dev, overlap="group", round_group=2, attn_impl="kernel")
        torch.manual_seed(1)
        eng.cache.k.normal_()
        eng.cache.v.normal_()
        engines.append(eng)
    return engines


# (token, lengths, active, eos, max_len, chain_mask, table) of two groups
# over one key (4 steps x 2 rounds, a 4-page bucket, split 1); the second
# chains slot 0 from the first's device outputs
_GROUP_A = ([5, 9, 0], [10, 3, 0], [1, 1, 0], [-1, -1, -1], [24, 16, 0], [0, 0, 0],
            [[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 0, 0]])
_GROUP_B = ([5, 30, 2], [10, 11, 5], [1, 1, 1], [-1, -1, -1], [32, 16, 16], [1, 0, 0],
            [[1, 2, 3, 8], [4, 5, 0, 0], [6, 7, 0, 0]])


def _packed(spec):
    import numpy as np

    from midgpt_tpu_torch.sampling.serve import _pack_group_inputs

    *rows, table = (np.asarray(x) for x in spec)
    return _pack_group_inputs(*rows, table)


def _eager_group(eng, spec, chain):
    out = eng._group_body(4, 1)(torch.as_tensor(_packed(spec), device=eng.device), *chain, False)
    torch.cuda.synchronize()
    return out


def _zero_chain(dev):
    return torch.zeros(3, dtype=torch.int64, device=dev), torch.zeros(3, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_replay_matches_eager_and_tallies_launches(cuda, dtype):
    """The fused group replays the eager body bit for bit for two sets of
    new inputs over one captured key; the capture's warm-up launches each
    kernel n_layer times (one masked step), and each replay n_layer x T."""
    _check_group_replay(cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_group_replay_matches_eager_and_tallies_launches(cuda, dtype):
    """The same with the routed MLP (4 experts, top-2) in every layer: its
    gates and masked-dense products capture, and replays equal the eager
    body bit for bit."""
    _check_group_replay(cuda, dtype, n_experts=4, moe_top_k=2)


def _check_group_replay(cuda, dtype, **extra):
    graph_eng, eager_eng = _group_engines(cuda, dtype, **extra)
    key = ("test", dtype)
    T, L = 8, graph_eng.config.n_layer
    for i, spec in enumerate((_GROUP_A, _GROUP_B)):
        before = (tpl.LAUNCHES.count, tpl.MERGE_LAUNCHES.count)
        res = graph_eng._graphs.dispatch(key, graph_eng._group_body(4, 1), _packed(spec), None)
        toks, emitted = res.host()
        launched = (tpl.LAUNCHES.count - before[0], tpl.MERGE_LAUNCHES.count - before[1])
        assert launched == ((L * T + (L if i == 0 else 0),) * 2)
        want, tok_fin, len_fin = _eager_group(eager_eng, spec, _zero_chain(cuda))
        assert torch.equal(torch.from_numpy(toks), want[:T].cpu())
        assert torch.equal(torch.from_numpy(emitted), want[T:].cpu().bool())
        assert torch.equal(res.tok_fin, tok_fin) and torch.equal(res.len_fin, len_fin)
        n = graph_eng.cache.num_pages
        assert torch.equal(graph_eng.cache.k[:, :, :n], eager_eng.cache.k[:, :, :n])
        assert torch.equal(graph_eng.cache.v[:, :, :n], eager_eng.cache.v[:, :, :n])
    assert graph_eng._graphs.stats() == {"captured": 1, "captures_per_key": [1], "replays": 2, "warmup_steps": 1}


@pytest.mark.cuda
def test_two_groups_in_flight_keep_the_first_outputs(cuda):
    """overlap="double"'s pattern: group B (chained to A's device outputs)
    is enqueued before A is read. The same graph's second replay overwrites
    its outputs, yet A's copies read afterwards equal A's eager run."""
    graph_eng, eager_eng = _group_engines(cuda, torch.bfloat16)
    key = ("test", "double")
    body = graph_eng._group_body(4, 1)
    res_a = graph_eng._graphs.dispatch(key, body, _packed(_GROUP_A), None)
    res_b = graph_eng._graphs.dispatch(key, body, _packed(_GROUP_B), (res_a.tok_fin, res_a.len_fin))
    got_b, got_a = res_b.host(), res_a.host()
    want_a = _eager_group(eager_eng, _GROUP_A, _zero_chain(cuda))
    want_b = _eager_group(eager_eng, _GROUP_B, want_a[1:])
    for (toks, emitted), (want, _, _) in ((got_a, want_a), (got_b, want_b)):
        assert torch.equal(torch.from_numpy(toks), want[:8].cpu())
        assert torch.equal(torch.from_numpy(emitted), want[8:].cpu().bool())
    assert torch.equal(res_a.len_fin, want_a[2]) and not torch.equal(res_a.len_fin, res_b.len_fin)


@pytest.mark.cuda
def test_group_replays_draw_fresh_samples(cuda):
    """temperature > 0 inside a captured group: the engine's generator is
    registered with the graph, so two replays of the same inputs draw
    different tokens (8 steps x 2 slots over ~96 tokens each)."""
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    cfg = GPTConfig(**GRAPH_CFG)
    eng = ServeEngine(cfg, _graph_params(cuda, torch.float32), max_slots=3, page_size=8, num_pages=12,
                      decode_chunk=4, cache_dtype=torch.float32, device=cuda, overlap="group", round_group=2,
                      temperature=1.0, seed=5)
    draws = [eng._graphs.dispatch("sampled", eng._group_body(4, 1), _packed(_GROUP_A), None).host()
             for _ in range(2)]
    (toks_1, emitted_1), (toks_2, emitted_2) = draws
    assert (emitted_1 == emitted_2).all() and emitted_1[:, :2].all()
    assert (toks_1[:, :2] != toks_2[:, :2]).any()
    assert ((0 <= toks_1) & (toks_1 < cfg.vocab_size)).all()


@pytest.mark.cuda
def test_capture_beside_a_thread_in_a_sync(cuda):
    """The armed watchdog forces each settle in a worker thread, and a worker
    abandoned by an expired deadline may still sit in an event's
    synchronize(). Captures are thread-local (sampling/graphs.py), so a new
    key captured while another thread keeps synchronizing succeeds, and its
    replay equals the eager body."""
    import threading

    graph_eng, eager_eng = _group_engines(cuda, torch.bfloat16)
    body = graph_eng._group_body(4, 1)
    first = graph_eng._graphs.dispatch(("test", "first"), body, _packed(_GROUP_A), None)
    stop, errors = threading.Event(), []

    def parked_worker():
        while not stop.is_set():
            try:
                first.host()  # Event.synchronize, as the watchdog's worker does
            except Exception as e:  # recorded for the assertion below
                errors.append(e)
                return

    worker = threading.Thread(target=parked_worker, daemon=True)
    worker.start()
    try:
        res = graph_eng._graphs.dispatch(("test", "captured beside a sync"), body, _packed(_GROUP_A), None)
        toks, emitted = res.host()
    finally:
        stop.set()
        worker.join(timeout=30)
    assert not worker.is_alive() and not errors
    assert graph_eng._graphs.stats()["captured"] == 2
    want = _eager_group(eager_eng, _GROUP_A, _zero_chain(cuda))[0]
    assert torch.equal(torch.from_numpy(toks), want[:8].cpu())
    assert torch.equal(torch.from_numpy(emitted), want[8:].cpu().bool())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "dots", "dots_attn", "flash"])
def test_remat_policy_matches_remat_off_through_the_kernels(cuda, policy):
    """A bf16 flash training forward and backward with per-block remat
    equals remat off bit for bit (deterministic kernels, the same ops), and
    the flash forward kernel is launched again in the backward exactly
    under the policies that do not keep its output."""
    import dataclasses

    from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy

    off = GPTConfig(block_size=256, vocab_size=256, n_layer=2, n_head=2, n_embd=256,
                    attn_impl="flash", rope_style="split", remat=False)
    params = GPT.init(off, 0, device=cuda, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randint(0, 256, (2, 256), generator=g).to(cuda) for _ in range(2))

    def run(cfg):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        fa.FWD_LAUNCHES.reset()
        loss = fused_linear_cross_entropy(GPT.hidden(cfg, p, x), p["lm_head"], y, 8192, None)
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        return loss, grads, fa.FWD_LAUNCHES.count

    want_loss, want_grads, want_fwd = run(off)
    loss, grads, fwd = run(dataclasses.replace(off, remat=True, remat_policy=policy))
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert want_fwd == off.n_layer
    assert fwd == off.n_layer * (2 if policy in ("none", "dots") else 1)


@pytest.mark.cuda
def test_remat_with_dropout_on_the_card(cuda):
    """Dropout from a CUDA generator under remat: the recompute draws the
    forward's masks, so loss and grads equal remat off bit for bit."""
    import dataclasses

    from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy

    off = GPTConfig(block_size=128, vocab_size=128, n_layer=2, n_head=2, n_embd=128, dropout=0.2, remat=False)
    params = GPT.init(off, 0, device=cuda)
    g = torch.Generator().manual_seed(1)
    x, y = (torch.randint(0, 128, (2, 128), generator=g).to(cuda) for _ in range(2))

    def run(cfg):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        gen = torch.Generator(device=cuda).manual_seed(7)
        h = GPT.hidden(cfg, p, x, generator=gen)
        loss = fused_linear_cross_entropy(h, p["lm_head"], y, 8192, None)
        return loss, torch.autograd.grad(loss, list(p.values()))

    want_loss, want_grads = run(off)
    for policy in ("none", "dots"):
        loss, grads = run(dataclasses.replace(off, remat=True, remat_policy=policy))
        assert torch.equal(loss, want_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


# ---------------------------------------------------------------- the batch sampler


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("T", [1, 7, 37, 200, 1000, 1023])
def test_flash_forward_at_prompt_lengths(cuda, dtype, C, T):
    """The batch sampler's prefill gives the forward any prompt length T <=
    attn_block_size, at the blocks `flash_block_sizes` picks (one KV block:
    the single-visit body): out and lse against the plain version."""
    from midgpt_tpu_torch.ops.attention import flash_block_sizes

    bq, bk = flash_block_sizes(T, 1024)
    q, k, v, _ = _flash_inputs(cuda, dtype, 6, T, C, seed=T)
    before = fa.FWD_LAUNCHES.by_variant["single"]
    out, lse = fa.flash_forward(q, k, v, bq, bk)
    torch.cuda.synchronize()
    assert fa.FWD_LAUNCHES.by_variant["single"] == before + 1
    want_out, want_lse = fa.flash_forward_plain(q, k, v, bq, bk)
    tol = TOL[dtype]
    assert out.dtype == dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


def _batch_model(dev, dtype):
    cfg = GPTConfig(**GRAPH_CFG, attn_impl="flash")
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), generator=torch.Generator().manual_seed(0)).to(dev)
    return cfg, _graph_params(dev, dtype), prompt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_decode_replay_matches_eager(cuda, dtype):
    """8 replays of the captured decode step after a flash prefill equal 8
    eager steps bit for bit: the tokens, both caches and the length."""
    from midgpt_tpu_torch.sampling import engine
    from midgpt_tpu_torch.sampling.graphs import StepGraphs

    cfg, params, prompt = _batch_model(cuda, dtype)
    knobs = (0.0, None, None)
    graphs = StepGraphs(cuda)
    cap = graphs.get("key", lambda: engine._new_batch(cfg, 3, dtype, cuda),
                     lambda state, gen: engine._decode_step(cfg, params, *knobs, state, gen), None)
    eager = engine._new_batch(cfg, 3, dtype, cuda)
    for batch in (cap.state, eager):
        first, _ = engine._prefill_and_first(cfg, params, prompt, *knobs, None, cache=batch.cache)
        batch.seq[:, :9] = prompt
        batch.seq[:, 9] = first
    graphs.replay(cap, 8)
    engine._decode_chunk(cfg, params, eager, *knobs, 8, None)
    torch.cuda.synchronize()
    got = cap.state
    assert torch.equal(got.seq[:, :18], eager.seq[:, :18])
    assert torch.equal(got.cache.k, eager.cache.k) and torch.equal(got.cache.v, eager.cache.v)
    assert int(got.cache.length) == int(eager.cache.length) == 17
    assert graphs.captures == 1 and graphs.replays == 8


@pytest.mark.cuda
def test_batch_generate_reuses_its_capture(cuda):
    """Two generate calls of one key share one capture (the second captures
    nothing), replay the same greedy tokens as the eager loop, and launch
    the flash forward once per layer for the prefill only."""
    from midgpt_tpu_torch.sampling import engine
    from midgpt_tpu_torch.sampling.graphs import StepGraphs

    cfg, params, prompt = _batch_model(cuda, torch.bfloat16)
    graphs = StepGraphs(cuda)
    stats = [{}, {}]
    before = fa.FWD_LAUNCHES.count
    outs = [engine.generate(cfg, params, prompt, 20, temperature=0.0, device=cuda, graphs=graphs, stats=s)
            for s in stats]
    assert fa.FWD_LAUNCHES.count - before == 2 * cfg.n_layer
    assert [s["captures"] for s in stats] == [1, 0] and graphs.captures == 1
    assert stats[1]["replays"] == 19 and stats[1]["chunks"] == [16, 2, 1]
    eager = engine.generate(cfg, params, prompt, 20, temperature=0.0, device=cuda, _eager=True)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], eager)
    assert torch.equal(outs[0][:, :9], prompt.cpu())


@pytest.mark.cuda
def test_batch_generate_replays_draw_from_the_callers_generator(cuda):
    """temperature > 0: the capture draws nothing from the caller's
    generator (its warm-up uses a scratch one), so a generator seeded alike
    gives the same tokens on the capturing call and on a replay-only call;
    another seed gives others."""
    from midgpt_tpu_torch.sampling import engine
    from midgpt_tpu_torch.sampling.graphs import StepGraphs

    cfg, params, prompt = _batch_model(cuda, torch.float32)
    graphs, gen = StepGraphs(cuda), torch.Generator(cuda)
    runs = []
    for seed in (11, 11, 12):
        gen.manual_seed(seed)
        runs.append(engine.generate(cfg, params, prompt, 24, temperature=1.0, device=cuda, generator=gen,
                                    graphs=graphs))
    assert graphs.captures == 1
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert ((0 <= runs[0]) & (runs[0] < cfg.vocab_size)).all()


# ---------------------------------------------------------------- the serving front door


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_k", [1, 2])
def test_kernel_on_page_tables_that_alias_pages(cuda, dtype, split_k):
    """A prefix-cache hit maps the same physical pages into several slots'
    tables: four slots share their first 16 pages (a 128-token template)
    and two of them a 17th, then each goes on through private pages. The
    kernel equals its plain version on that table."""
    counts = [300, 200, 140, 129]
    q, k, v, table, cnt = _problem(cuda, dtype, 4, 12, 64, 8, 64, counts)
    shared = torch.arange(1, 18, dtype=torch.int32, device=cuda)
    table[:, :16] = shared[:16]
    table[:2, 16] = shared[16]
    assert len({tuple(r[:16].tolist()) for r in table}) == 1
    got = paged_attention_kernel(q, k, v, table, cnt, split_k=split_k)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, cnt[:, None], split_k=split_k)[:, :, 0]
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _front_door_engine(dev, params, **kw):
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    return ServeEngine(GPTConfig(**GRAPH_CFG), params, max_slots=3, page_size=8, num_pages=24, decode_chunk=4,
                       cache_dtype=torch.float32, device=dev, **{"overlap": "group", "round_group": 2, **kw})


def _front_door_trace():
    g = torch.Generator().manual_seed(3)
    return [(torch.randint(0, GRAPH_CFG["vocab_size"], (n,), generator=g).numpy(), m)
            for n, m in ((5, 14), (19, 9), (11, 20), (26, 12))]


def _serve_all(eng, trace=None):
    uids = [eng.submit(p, m) for p, m in (trace or _front_door_trace())]
    done = eng.run()
    return [done[u].tokens.tolist() for u in uids]


@pytest.mark.cuda
def test_group_replays_after_an_in_place_hot_swap(cuda):
    """An engine captures its groups on weights A, flips to weights B in
    place (idle: at once) and serves again: no new capture, and the
    replays' f32 streams equal a fresh engine's on B, bit for bit."""
    eng = _front_door_engine(cuda, _graph_params(cuda, torch.float32))
    before = _serve_all(eng)
    captured = eng.stats()["decode_graphs"]["captured"]
    new = GPT.init(GPTConfig(**GRAPH_CFG), 7, device=cuda)
    assert eng.hot_swap(new, version="v2")["flipped"]
    after = _serve_all(eng)
    assert eng.stats()["decode_graphs"]["captured"] == captured
    assert sum(eng.stats()["decode_graphs"]["captures_per_key"]) == captured
    fresh = _front_door_engine(cuda, GPT.init(GPTConfig(**GRAPH_CFG), 7, device=cuda))
    assert after == _serve_all(fresh)
    assert after != before


@pytest.mark.cuda
def test_resize_leaves_no_capture_of_the_old_pool(cuda):
    """A grow and a shrink each drop every captured graph (they read the
    old pool) and the next dispatches recapture against the new one; the
    streams equal the run without a resize, and the device memory comes
    back to within the new pool's size of the value before."""
    eng = _front_door_engine(cuda, _graph_params(cuda, torch.float32), prefix_cache=True)
    want = _serve_all(eng)
    torch.cuda.synchronize()
    captured = eng.stats()["decode_graphs"]["captured"]
    old_pool, before = eng.cache, torch.cuda.memory_allocated(cuda)
    eng.resize(40)
    assert eng.stats()["decode_graphs"]["captured"] == 0 and eng.dropped_graphs == captured
    eng.resize(20)
    assert eng.cache is not old_pool and eng.cache.num_pages == 20
    del old_pool
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - before < eng.cache.nbytes
    assert _serve_all(eng) == want  # the trie's pages moved with their content: these prompts hit it now
    assert eng.stats()["decode_graphs"]["captured"] >= 1 and eng.dropped_graphs == captured


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", ["group", "double"])
def test_steps_from_two_threads_match_one(cuda, overlap):
    """The asyncio server steps the engine from worker threads. An engine
    built under a side stream and stepped from two threads in turn (each
    with the default stream current) gives the streams of one thread."""
    from concurrent.futures import ThreadPoolExecutor

    params = _graph_params(cuda, torch.float32)
    want = _serve_all(_front_door_engine(cuda, params, overlap=overlap))
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        eng = _front_door_engine(cuda, params, overlap=overlap)
    uids = [eng.submit(p, m) for p, m in _front_door_trace()]
    pools = [ThreadPoolExecutor(1), ThreadPoolExecutor(1)]
    try:
        turn = 0
        while not eng.idle:
            pools[turn % 2].submit(eng.step).result()
            turn += 1
    finally:
        for pool in pools:
            pool.shutdown()
    assert turn > 2 and [eng.finished[u].tokens.tolist() for u in uids] == want


# ---------------------------------------------------------------- page transport: spill, re-adoption, handoff


def _pool_ptrs(cache):
    return [t.data_ptr() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]


@pytest.mark.cuda
def test_readoption_keeps_captured_groups_valid(cuda):
    """An engine captures its groups, its trie is flushed into a spill tier
    and the same prompts come back: their pages are re-adopted from the host
    into the live pool in place. No pool tensor is rebound, the replays'
    f32 streams equal the first pass and a fresh engine's, bit for bit."""
    from midgpt_tpu_torch.sampling.fleet import SpillTier

    params = _graph_params(cuda, torch.float32)
    eng = _front_door_engine(cuda, params, prefix_cache=True)
    tier = SpillTier()
    eng.attach_spill(tier)
    ptrs = _pool_ptrs(eng.cache)
    want = _serve_all(eng)
    eng.flush_prefix_cache()
    assert tier.total_spilled >= 1
    again = _serve_all(eng)
    torch.cuda.synchronize()
    assert _pool_ptrs(eng.cache) == ptrs and eng.spill_readopted_pages >= 1 and tier.readopted >= 1
    assert again == want == _serve_all(_front_door_engine(cuda, params, prefix_cache=True))
    tier.assert_ledger("readoption")


@pytest.mark.cuda
def test_adopt_never_writes_the_spare_page(cuda):
    from midgpt_tpu_torch.sampling import disagg

    cfg = GPTConfig(**GRAPH_CFG)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        cache = PagedKVCache.init(cfg, num_pages=8, page_size=8, dtype=dtype, device=cuda)
        src = PagedKVCache.init(cfg, num_pages=8, page_size=8, dtype=dtype, device=cuda)
        for t in (src.k, src.v, cache.k[:, :, 8], cache.v[:, :, 8]):
            t.copy_(torch.randint(-100, 100, t.shape, device=cuda).to(dtype))
        spare = (cache.k[:, :, 8].clone(), cache.v[:, :, 8].clone())
        ptrs = _pool_ptrs(cache)
        disagg.adopt_pages(cache, [7, 1, 3], disagg.gather_pages(src, [1, 2, 7]))
        torch.cuda.synchronize()
        assert _pool_ptrs(cache) == ptrs
        assert torch.equal(cache.k[:, :, 8], spare[0]) and torch.equal(cache.v[:, :, 8], spare[1])
        assert torch.equal(cache.k[:, :, [7, 1, 3]], src.k[:, :, [1, 2, 7]])
        with pytest.raises(ValueError):
            disagg.adopt_pages(cache, [8], disagg.gather_pages(src, [1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_page_survives_spill_and_readoption_byte_for_byte(cuda, dtype):
    """A page spilled to the host (bf16 as raw 16-bit words, int8 with its
    scales) and adopted back into another page holds the same bytes."""
    from midgpt_tpu_torch.sampling import disagg
    from midgpt_tpu_torch.sampling.fleet import SpillTier

    cfg = GPTConfig(**GRAPH_CFG)
    cache = PagedKVCache.init(cfg, num_pages=8, page_size=8, dtype=dtype, device=cuda)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, device=cuda).mul(40).to(dtype))
    if cache.quantized:
        cache.k_scale.uniform_()
        cache.v_scale.uniform_()
    tier = SpillTier()
    tier.set_page_size(8)
    prompt = list(range(16))
    tier.spill(cache, tuple(prompt[:8]), 3, "v0")
    (blocks,) = tier.take_run(prompt, 0, 1, "v0")
    stacked = {k: b[:, None] if k.endswith("scale") else b[:, :, None] for k, b in blocks.items()}
    disagg.adopt_pages(cache, [6], stacked)
    torch.cuda.synchronize()
    def same(t, axis):
        return disagg.host_block(t.select(axis, 6)).tobytes() == disagg.host_block(t.select(axis, 3)).tobytes()

    assert same(cache.k, 2) and same(cache.v, 2)
    if cache.quantized:
        assert same(cache.k_scale, 1) and same(cache.v_scale, 1)
    assert tier.readopted == 1 and tier.corrupt_discarded == 0


@pytest.mark.cuda
def test_adopt_with_a_round_in_flight(cuda):
    """The decode role under overlap="double" keeps a round in flight while
    the next handoff is adopted into its pool: its f32 streams equal those
    of a decode role with nothing in flight, and a monolithic engine's."""
    from midgpt_tpu_torch.sampling.disagg import DisaggServe
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    params = _graph_params(cuda, torch.float32)
    trace = _front_door_trace() * 2

    def run(**decode_kw):
        d = DisaggServe(GPTConfig(**GRAPH_CFG), params, page_size=8, num_pages=40, decode_chunk=4,
                        cache_dtype=torch.float32, device=cuda, prefill_kw=dict(max_slots=2, prefill_chunk=32),
                        decode_kw=dict(max_slots=4, **decode_kw))
        uids = []
        for p, m in trace:  # staggered: handoffs land while the decode role runs
            uids.append(d.submit(p, m))
            d.step()
        d.run()
        return [d.finished[u].tokens.tolist() for u in uids], d.queue.pages_copied

    inflight, shipped = run(overlap="double", round_group=4)
    settled, _ = run()
    mono = ServeEngine(GPTConfig(**GRAPH_CFG), params, max_slots=3, page_size=8, num_pages=40, decode_chunk=4,
                       cache_dtype=torch.float32, device=cuda)
    assert shipped >= 1 and inflight == settled == _serve_all(mono, trace)


@pytest.mark.cuda
def test_worker_process_streams_as_an_in_process_engine(cuda):
    """A fleet worker process on the card (sampling/fleet_proc.py: GPT.init
    at the same seed, f32, this process's TF32 switches) serves f32 streams
    equal to an in-process engine's, bit for bit, launching the paged and
    merge kernels in its own process (n_layer per decode step) while this
    process launches none."""
    import dataclasses

    from midgpt_tpu_torch.sampling import fleet_proc as fp
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    cfg = GPTConfig(**GRAPH_CFG)
    engine = dict(max_slots=3, page_size=8, num_pages=40, decode_chunk=4)
    spec = {"model": dataclasses.asdict(cfg), "seed": 0, "engine": {**engine, "cache_dtype": "float32"},
            "device": "cuda", "torch_config": fp.parent_torch_config()}
    want = _serve_all(ServeEngine(cfg, GPT.init(cfg, 0, device=cuda), temperature=0.0, prefix_cache=True,
                                  cache_dtype=torch.float32, device=cuda, **engine))
    workers = fp.spawn_workers(spec, 1)
    try:
        rep = fp.connect_replica(workers[0][1])
        before = fp.process_launch_counts()
        got = _serve_all(rep)
        assert fp.process_launch_counts() == before
        counts = rep.launch_counts()["launches"]
        steps = rep.stats()["decode_steps"]
        rep.close()
    finally:
        fp.kill_workers(workers)
    assert got == want
    assert steps >= 1 and sum(counts["paged_attention"].values()) == sum(counts["paged_attention_merge"].values()) \
        == cfg.n_layer * steps


@pytest.mark.cuda
def test_moe_tie_order_on_the_card_equals_the_cpus(cuda):
    """Exactly K experts a token, ties to the lowest index, on the card as
    on the CPU: on an all-equal (zero) router experts 0 and 1, and on an
    integer-valued router with many ties (exact products in f32 and bf16)
    the same selection, token for token."""
    cfg = GPTConfig(**GRAPH_CFG, n_experts=8, moe_top_k=2)
    g = torch.Generator().manual_seed(0)
    h = torch.randint(-1, 2, (4, 64, 128), generator=g).float()
    router = torch.randint(-1, 2, (8, 128), generator=g).float()
    router[5] = router[2]  # experts 2 and 5 tie on every token
    for rtr in (torch.zeros(8, 128), router):
        for dtype in (torch.float32, torch.bfloat16):
            want, _ = GPT._moe_gates(cfg, {"mlp.router": rtr.to(dtype)}, h.to(dtype))
            got, _ = GPT._moe_gates(cfg, {"mlp.router": rtr.to(cuda, dtype)}, h.to(cuda, dtype))
            assert torch.equal(got.cpu() > 0, want > 0)
            assert ((want > 0).sum(-1) == 2).all()
    zero, _ = GPT._moe_gates(cfg, {"mlp.router": torch.zeros(8, 128, device=cuda)}, h.to(cuda))
    assert (zero[..., :2] == 0.5).all() and (zero[..., 2:] == 0).all()


@pytest.mark.cuda
def test_moe_block_on_the_card_equals_the_cpus(cuda):
    """The f32 block tail with the routed MLP (8 experts, top-2; the
    combine product `midgpt::moe_down` and its backward) on the card
    against the CPU on the same inputs: output, aux and every gradient at
    1e-5 absolute and relative (summation order; TF32 off)."""
    cfg = GPTConfig(**GRAPH_CFG, n_experts=8, moe_top_k=2)
    params = GPT.init(cfg, 0, device="cpu")
    blk = {k.split(".", 1)[1]: v[0] for k, v in params.items() if k.startswith(("blocks.mlp.", "blocks.attn.wo"))}
    g = torch.Generator().manual_seed(1)
    x, att, w = torch.randn(2, 16, 128, generator=g), torch.randn(2, 16, 2, 64, generator=g), torch.randn(2, 16, 128, generator=g)

    def run(dev):
        b = {k: v.to(dev).requires_grad_() for k, v in blk.items()}
        out, aux = GPT._attn_out_and_mlp(cfg, b, x.to(dev), att.to(dev), return_moe_aux=True)
        loss = (out * w.to(dev)).sum() + aux
        return [out, aux] + list(torch.autograd.grad(loss, list(b.values())))

    for got, want in zip(run(cuda), run("cpu")):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [8, 4096], ids=["decode", "train"])
def test_moe_mlp_reads_the_expert_banks_in_place(cuda, tokens):
    """The routed MLP's forward and backward at GPT-2 small's width (8
    experts of 4 x 768) copy no expert bank: experts_up is read as its
    (E*4D, D) view and experts_down through `midgpt::moe_down`'s batched
    views. Activation-sized copies inside the batched products, if any,
    are printed, not held."""
    from torch.profiler import ProfilerActivity, profile

    cfg = GPTConfig(block_size=1024, vocab_size=96, n_layer=1, n_head=12, n_embd=768, n_experts=8, moe_top_k=2)
    params = GPT.init(cfg, 0, device=cuda, dtype=torch.bfloat16)
    blk = {k.split(".", 1)[1]: v[0].requires_grad_() for k, v in params.items() if k.startswith("blocks.mlp.")}
    h = torch.randn(1, tokens, 768, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    bank = blk["mlp.experts_up"].numel()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out, _ = GPT._moe_mlp(cfg, blk, h)
        out.float().square().sum().backward()
    torch.cuda.synchronize()
    copies = [(e.name, e.input_shapes[0]) for e in prof.events()
              if e.name in ("aten::copy_", "aten::clone", "aten::contiguous") and e.input_shapes and e.input_shapes[0]]
    sizes = [(name, shape, math.prod(shape)) for name, shape in copies]
    print(f"copies in the routed MLP at {tokens} tokens: {sizes}")
    assert not [c for c in sizes if c[2] == bank and tokens not in c[1]], sizes  # a bank has no token axis


_ONE_RANK = """
import sys
from midgpt_tpu_torch import launch
launch.main(sys.argv[1:])
"""


@pytest.mark.cuda
def test_one_nccl_rank_trains_as_the_single_device_trainer(cuda, tmp_path, monkeypatch):
    """`launch --multihost` as the one rank of an NCCL group (a single-GPU
    node's path) gives the single-device launcher's losses and checkpoint
    bytes; more ranks on a node than cards is refused for NCCL, naming
    gloo."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np

    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.parallel import dist

    r = np.random.default_rng(0)
    stream = np.where(r.random(20000) < 0.1, r.integers(0, 64, 20000), np.arange(20000) % 17).astype(np.uint16)
    stream.tofile(tmp_path / "train.bin")
    stream[:4000].tofile(tmp_path / "val.bin")
    sets = {"data_dir": tmp_path, "max_steps": 3, "eval_interval": 2, "eval_steps": 1, "batch_size": 4,
            "g_accum_iters": 2, "log_interval": 1, "spec_layers": 0, "warmup_steps": 1, "lr_decay_steps": 3,
            "model_config.block_size": 64, "model_config.n_layer": 2, "model_config.n_embd": 128,
            "model_config.n_head": 2, "model_config.vocab_size": 64, "model_config.attn_block_size": 64}
    args = ["--config=local_text_124m", *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MIDGPT_DIST_FILE=str(tmp_path / "store"))
    p = subprocess.run([sys.executable, "-c", _ONE_RANK, "--multihost", f"--rundir={tmp_path / 'rank'}", *args],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "over 1 rank(s), backend nccl" in p.stdout
    launch.main([f"--rundir={tmp_path / 'single'}", *args])

    def losses(d):
        recs = [json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
        return [{k: v for k, v in rec.items() if k.startswith("loss")} for rec in recs]

    assert losses("rank") == losses("single")
    for name in ("params.npz", "opt_state.npz"):
        assert (tmp_path / "rank" / "2" / name).read_bytes() == (tmp_path / "single" / "2" / name).read_bytes()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="NCCL takes one card per rank.*gloo"):
        dist.init()
    assert not dist.initialized()


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp2_ranks_sharing_the_card_train_as_one_rank(cuda, tmp_path, schedule):
    """`launch --multihost --backend gloo --set mesh.pp=2` on two ranks that
    share the card (a layer a stage, the flash kernels in each stage, the
    stage sends staged through the host) trains as the single-device
    launcher in f32: every loss, the steps' and the evals', at 2e-5."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np

    from midgpt_tpu_torch import launch

    r = np.random.default_rng(0)
    stream = np.where(r.random(20000) < 0.1, r.integers(0, 64, 20000), np.arange(20000) % 17).astype(np.uint16)
    stream.tofile(tmp_path / "train.bin")
    stream[:4000].tofile(tmp_path / "val.bin")
    sets = {"data_dir": tmp_path, "max_steps": 3, "eval_interval": 2, "eval_steps": 1, "batch_size": 4,
            "g_accum_iters": 2, "log_interval": 1, "spec_layers": 0, "warmup_steps": 1, "lr_decay_steps": 3,
            "model_config.block_size": 64, "model_config.n_layer": 2, "model_config.n_embd": 128,
            "model_config.n_head": 2, "model_config.vocab_size": 64, "model_config.attn_block_size": 64,
            "compute_dtype": "float32", "mesh.fsdp": 1}
    args = ["--config=local_text_124m", *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]
    pp = ["--set", "mesh.pp=2", "--set", f"pipeline_schedule={schedule}", "--set", "pipeline_microbatches=2"]
    procs = [subprocess.Popen([sys.executable, "-c", _ONE_RANK, "--multihost", "--backend", "gloo",
                               f"--rundir={tmp_path / 'pp'}", *args, *pp],
                              env=dict(os.environ, RANK=str(i), WORLD_SIZE="2", LOCAL_RANK=str(i),
                                       LOCAL_WORLD_SIZE="2", MIDGPT_DIST_FILE=str(tmp_path / "store")),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-3000:] for _, err in outs]
    assert "'pp': 2" in outs[0][0] and "over 2 rank(s), backend gloo" in outs[0][0]
    launch.main([f"--rundir={tmp_path / 'single'}", *args])

    def losses(d):
        recs = [json.loads(line) for line in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
        return {(rec["step"], k): v for rec in recs for k, v in rec.items() if k.startswith("loss")}

    got, want = losses("pp"), losses("single")
    assert sorted(got) == sorted(want) and len(want) >= 6
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=2e-5), k
