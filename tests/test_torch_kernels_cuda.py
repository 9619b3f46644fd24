"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips with a reason without
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
from midgpt_tpu_torch.kernels.decode_attention import paged_attention_kernel
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache

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
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, cnt[:, None], split_k)[:, :, 0]
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
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, cnt[:, None], split_k)[:, :, 0]
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
