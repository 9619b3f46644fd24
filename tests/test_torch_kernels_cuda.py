"""The port's CUDA kernels against their plain PyTorch versions, on the
card (paged attention: the decode, verify, int8, GQA-fold and window specs,
the merge of its partitions and its capture in a CUDA graph; flash
attention: forward and both backward kernels), and the decode step and the
overlap modes' fused decode group as CUDA-graph replays (bit for bit
against eager runs, launch tallies per replay, two groups in flight, a
capture beside another thread's sync).
Every test here needs an
NVIDIA GPU and skips with a reason without one. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances (kernel vs plain on the same inputs): float32 1e-5 absolute
and relative (summation order only); bfloat16 1e-2 — an f32 sum taken in
another order can move a bf16 rounding of p or of the output by one ulp.
Flash gradients are held relative to their largest magnitude: float32
1e-5 and bfloat16 1e-2 of max |want| absolute, plus the same relative.
TF32 is off so the plain version's f32 products are full f32."""

import pytest
import torch

from midgpt_tpu_torch.kernels import attention_template as tpl
from midgpt_tpu_torch.kernels import flash_attention as fa
from midgpt_tpu_torch.kernels.decode_attention import paged_attention_kernel, paged_verify_attention_kernel
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache
from midgpt_tpu_torch.ops.online_softmax import M_INIT, finalize, merge_partials
from midgpt_tpu_torch.ops.quant import quantize_q8

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


def _graph_params(dev, dtype):
    from midgpt_tpu_torch.utils.precision import cast_floating

    return cast_floating(GPT.init(GPTConfig(**GRAPH_CFG), 0, device=dev), dtype)


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


def _group_engines(dev, dtype):
    """Two engines on the same weights and the same random pool: one
    replays captured groups, the other runs the same body eagerly."""
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    cfg = GPTConfig(**GRAPH_CFG)
    params = _graph_params(dev, dtype)
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
    graph_eng, eager_eng = _group_engines(cuda, dtype)
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
