"""Port parity, flash attention: the port's `flash_attention`
autograd.Function on CPU tensors (its plain version) against JAX's
`flash_attention` custom VJP, called directly so that its Pallas bodies run
in interpret mode off the TPU (as tests/test_flash.py runs them); the tile
policy tables; and the port's blockwise path against JAX's. The CUDA
kernels against the plain version: tests/test_torch_kernels_cuda.py.

Tolerances: float32 forward 1e-5 and gradients of sum(sin(out)) 3e-5,
absolute and relative (summation order only: both sides round nowhere in
f32); bfloat16 forward 2e-2 absolute and relative — the two sides sum the
f32 dots in another order, which can move a bf16 rounding of p or of the
output by one ulp (2^-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.kernels.flash_attention import _block_sizes as j_block_sizes
from midgpt_tpu.kernels.flash_attention import flash_attention as j_flash
from midgpt_tpu.ops.attention import blockwise_causal_attention as j_blockwise
from midgpt_tpu.ops.attention import flash_block_sizes as j_flash_block_sizes
from midgpt_tpu_torch.kernels import flash_attention as fa
from midgpt_tpu_torch.ops.attention import blockwise_causal_attention, flash_block_sizes
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)


def _qkv(shape, seed=0, dtype="float32"):
    r = np.random.default_rng(seed)
    arrays = [r.standard_normal(shape).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":  # round once, hand both sides the same values
        arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    return [jnp.asarray(a, jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays]


# (T, block_q, block_k): single visit; tiled; tiled with bq < bk; a ragged T
# whose requested blocks do not divide it (the KV block widens to T)
CASES = [(128, 64, 128), (128, 32, 64), (192, 64, 96), (100, 64, 64)]


@pytest.mark.parametrize("T,bq,bk", CASES)
def test_forward_f32_matches_jax_interpret(T, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 2, T, 64), seed=T)
    want = j_flash(jq, jk, jv, bq, bk)
    got = fa.flash_attention(tq, tk, tv, bq, bk)
    assert got.shape == tq.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,bq,bk", [(128, 64, 128), (128, 32, 64), (100, 64, 64)])
def test_gradients_f32_match_jax(T, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, T, 32), seed=T + 1)
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(j_flash(q, k, v, bq, bk))), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    torch.sin(fa.flash_attention(tq, tk, tv, bq, bk)).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=3e-5, rtol=3e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("T,bq,bk", [(128, 64, 128), (128, 32, 64)])
def test_forward_bf16_matches_jax_interpret(T, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, T, 64), seed=7, dtype="bfloat16")
    want = j_flash(jq, jk, jv, bq, bk)
    got = fa.flash_attention(tq, tk, tv, bq, bk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_lse_is_logsumexp_of_scaled_scores():
    _, (tq, tk, tv) = _qkv((3, 40, 64), seed=3)
    _, lse = fa.flash_forward(tq, tk, tv, 16, 8)
    s = torch.einsum("ntc,nsc->nts", tq, tk) / 8.0
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5, rtol=1e-5)


def test_block_size_tables_equal_jax():
    for T in (64, 100, 128, 768, 1024, 2048, 4096):
        for bq in (32, 64, 128, 512, 1024, 2048):
            for bk in (64, 128, 512, 1024, 2048):
                try:
                    want = j_block_sizes(T, bq, bk)
                except ValueError:
                    with pytest.raises(ValueError):
                        fa._block_sizes(T, bq, bk)
                    continue
                assert fa._block_sizes(T, bq, bk) == want, (T, bq, bk)
        for blk in (64, 256, 512, 1024, 4096):
            assert flash_block_sizes(T, blk) == j_flash_block_sizes(T, blk), (T, blk)


def test_dispatch_variants():
    assert fa._variants(1024, 1024) == ("single", "single", "single")  # bodies 1, 3, 3
    assert fa._variants(1024, 512) == ("tiled", "tiled", "tiled")  # bodies 2, 5, 6
    assert fa._variants(2048, 2048) == ("single", "single", "tiled")  # bodies 1, 4, 6


@pytest.mark.parametrize("offset,bad", [(0, None), (8, None), (1, "q"), (4, "k"), (2, "dout")])
def test_kernel_arguments_start_on_16_bytes(offset, bad):
    """The kernels' argument check (run before any launch) refuses a tensor
    whose data does not start on a 16-byte boundary: the bf16 kernels copy
    16-byte row pieces with cp.async. Checked here on CPU tensors, which it
    reads the same way."""
    N, T, C = 2, 8, 64
    names = ("q", "k", "v", "out", "dout")
    named = []
    for name in names:
        shift = offset if name == (bad or "q") else 0
        t = torch.zeros(N * T * C + 16, dtype=torch.bfloat16)[shift : shift + N * T * C].view(N, T, C)
        named.append((name, t))
    if bad is None:
        fa._check_args(*named)
    else:
        with pytest.raises(ValueError, match=f"{bad} does not start on a 16-byte boundary"):
            fa._check_args(*named)


def test_cpu_never_launches_a_kernel():
    _, (tq, tk, tv) = _qkv((1, 1, 64, 64), seed=5)
    counters = (fa.FWD_LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    before = [c.count for c in counters]
    tq.requires_grad_()
    fa.flash_attention(tq, tk, tv, 32, 32).sum().backward()
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("T,blk", [(96, 32), (100, 32), (64, 64)])
def test_blockwise_matches_jax(T, blk):
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 2, T, 32), seed=T + 9)
    want = j_blockwise(jq, jk, jv, block_size=blk)
    got = blockwise_causal_attention(tq, tk, tv, block_size=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
