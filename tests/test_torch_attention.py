"""Port parity, paged decode attention: the port's plain template version
against the JAX Pallas kernel in interpret mode (`paged_attention_kernel`,
how it runs off-TPU), and the port's gather lowering against JAX's. The
CUDA kernel against the plain version: tests/test_torch_kernels_cuda.py.

Problem: 4 slots with non-contiguous page tables whose unused entries
point at the sink page 0, ragged page-unaligned counts, and one inactive
slot with count = 1 (it reads only the sink's first key).

Tolerances: float32 1e-5 absolute and relative (summation order only);
bfloat16 inputs and output 1e-2 absolute and relative — an f32 sum
taken in another order can move a bf16 rounding of p or of the output
by one ulp (2^-8 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.kernels.decode_attention import (
    paged_attention_gather as j_gather,
    paged_attention_kernel as j_kernel,
)
from midgpt_tpu_torch.kernels import attention_template as tpl
from midgpt_tpu_torch.kernels.decode_attention import (
    paged_attention,
    paged_attention_gather as t_gather,
    paged_attention_kernel as t_kernel,
)

B, H, C = 4, 2, 64
PS, NP, MP = 8, 24, 8  # page_size, pool pages, logical pages per slot
TABLE = np.array(
    [
        [3, 17, 9, 0, 0, 0, 0, 0],
        [5, 2, 21, 11, 7, 14, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0],  # inactive: everything on the sink
        [4, 8, 12, 16, 20, 1, 6, 10],
    ],
    np.int32,
)
COUNTS = np.array([19, 45, 1, 64], np.int32)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _problem(dtype: str, seed: int = 0):
    r = np.random.default_rng(seed)
    arrays = [r.standard_normal(s).astype(np.float32) for s in ((B, H, C), (H, NP, PS, C), (H, NP, PS, C))]
    if dtype == "bfloat16":  # round once, hand both sides the same values
        arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    return arrays


def _both(arrays, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = [jnp.asarray(a, jd) for a in arrays]
    t = [torch.from_numpy(a).to(td) for a in arrays]
    return j, t


def _close(got: torch.Tensor, want, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want).astype(np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split_k", [1, 2, 4])
def test_plain_template_matches_jax_interpret_kernel(dtype, split_k):
    (jq, jk, jv), (tq, tk, tv) = _both(_problem(dtype), dtype)
    want = j_kernel(jq, jk, jv, jnp.asarray(TABLE), jnp.asarray(COUNTS), split_k=split_k)
    got = t_kernel(tq, tk, tv, torch.from_numpy(TABLE), torch.from_numpy(COUNTS), split_k=split_k)
    assert got.dtype == tq.dtype and got.shape == (B, H, C)
    _close(got, want, dtype)


@pytest.mark.parametrize("split_k", [1, 2])
def test_plain_template_f32_query_over_bf16_pools_matches_jax(split_k):
    """Mixed dtypes, as `sample --ckpt_dir` of an f32-compute run serves:
    an f32 query over bf16 pools; JAX's dots promote, p is rounded to the
    pool's bf16 before PV and the output is f32. Tolerance: float32's."""
    q, k, v = _problem("bfloat16", seed=4)
    q = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)  # f32, not bf16-exact
    want = j_kernel(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                    jnp.asarray(TABLE), jnp.asarray(COUNTS), split_k=split_k)
    got = t_kernel(torch.from_numpy(q), torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                   torch.from_numpy(TABLE), torch.from_numpy(COUNTS), split_k=split_k)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split_k", [1, 2])
def test_gather_matches_jax_gather(dtype, split_k):
    (jq, jk, jv), (tq, tk, tv) = _both(_problem(dtype, seed=1), dtype)
    want = j_gather(jq, jk, jv, jnp.asarray(TABLE), jnp.asarray(COUNTS), split_k=split_k)
    got = t_gather(tq, tk, tv, torch.from_numpy(TABLE), torch.from_numpy(COUNTS), split_k=split_k)
    _close(got, want, dtype)


def test_auto_dispatch_takes_the_gather_on_cpu():
    _, (tq, tk, tv) = _both(_problem("float32", seed=2), "float32")
    pt, cnt = torch.from_numpy(TABLE), torch.from_numpy(COUNTS)
    before = tpl.LAUNCHES.count
    np.testing.assert_array_equal(
        paged_attention(tq, tk, tv, pt, cnt).numpy(), t_gather(tq, tk, tv, pt, cnt).numpy()
    )
    assert tpl.LAUNCHES.count == before  # the CPU never launches the kernel


def test_zero_count_slot_is_finite_zero():
    _, (tq, tk, tv) = _both(_problem("float32", seed=3), "float32")
    counts = torch.tensor([0, 5, 0, 9], dtype=torch.int32)
    got = t_kernel(tq, tk, tv, torch.from_numpy(TABLE), counts)
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all() and (got[2] == 0).all()


def test_normalize_split_k():
    assert [tpl.normalize_split_k(s, 8) for s in (1, 2, 3, 4, 8, 16)] == [1, 2, 2, 4, 8, 8]
    assert tpl.normalize_split_k(4, 6) == 2  # pow2 divisor of an odd-width table


def test_unported_specs_raise():
    """The GQA fold and the sliding window are the template's specs still
    to be ported: the kernel's argument check, the plain version and the
    gather refuse fewer pool heads than query heads, and GPTConfig refuses
    a window. The verify and int8 specs are ported (tests/test_torch_spec.py)."""
    from midgpt_tpu_torch.models.gpt import GPTConfig

    q = torch.zeros(1, 2, 2, C)  # 2 query heads, 2 rows
    pages = torch.zeros(1, 4, PS, C)  # 1 pool head: GQA
    table = torch.zeros(1, 2, dtype=torch.int32)
    counts = torch.ones(1, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="GQA"):
        tpl._check_args(q, pages, pages, table, counts, None, None)
    with pytest.raises(NotImplementedError, match="GQA"):
        tpl.paged_attention_template(q, pages, pages, table, counts)
    with pytest.raises(NotImplementedError, match="GQA"):
        t_gather(q[:, :, 0], pages, pages, table, counts[:, 0])
    with pytest.raises(NotImplementedError, match="sliding_window"):
        GPTConfig(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32, sliding_window=16)
