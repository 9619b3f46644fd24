"""The port's CUDA kernels against their plain PyTorch versions, on the
card (paged attention: the decode, verify and int8 specs). Every test here needs an NVIDIA GPU and skips with a reason without
one. The file imports no JAX, so it also runs where JAX is absent:

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
    wide = torch.zeros(2, 2, tpl.MAX_ROWS + 1, 64, device=cuda)
    with pytest.raises(ValueError, match="rows"):
        tpl.paged_attention_template(wide, k, v, table, torch.ones(2, tpl.MAX_ROWS + 1, dtype=torch.int32,
                                                                   device=cuda), ks, vs)


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
