"""The paged-attention kernel's partitions, on the CPU: the partition rule
(`partition_pages`) is a pure function of the shapes that refines the
caller's split and keeps a partition within what the kernel stages, the
merge's plain version has the properties the CUDA merge relies on, and the
plain template at the kernel's partition count matches JAX's Pallas
template (interpret mode) at split 1 and at that count — the rounding
contract the CUDA kernel runs. The kernels themselves against the plain
version: tests/test_torch_kernels_cuda.py.

Tolerances, as tests/test_torch_attention.py: float32 1e-5 absolute and
relative (summation order only); bfloat16 1e-2 (an f32 sum taken in
another order can move a bf16 rounding by one ulp). An f32 query over int8
pools keeps p in f32: float32's."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.kernels.attention_template import paged_attention_template as j_template
from midgpt_tpu.ops.quant import quantize_q8 as j_quantize
from midgpt_tpu_torch.kernels import attention_template as tpl
from midgpt_tpu_torch.ops.online_softmax import M_INIT, finalize, merge_partials
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
B, C, PS, NP, MP = 2, 32, 8, 40, 16  # a 16-page bucket: partitions of 4 pages


@pytest.mark.parametrize(
    "max_pages,page_size,head_dim,want",
    [
        (128, 8, 64, 4),  # the serving bucket: 32 partitions of 32 keys
        (512, 8, 128, 16),  # llama7b_long: 32 partitions
        (16, 16, 128, 2),  # pages of 16: still 32 keys
        (16, 8, 512, 4),  # widest head
        (512, 16, 512, 2),  # K and V of a partition fit shared memory: 16384 elements
        (8, 8, 64, 4),
        (4, 8, 64, 4),  # one partition
        (6, 8, 64, 3),  # a width that is no power of two
        (7, 8, 64, 1),
    ],
)
def test_partition_pages_is_a_function_of_shapes(max_pages, page_size, head_dim, want):
    params = set(inspect.signature(tpl.partition_pages).parameters)
    assert params == {"max_pages", "split_k", "page_size", "head_dim", "q_dtype", "pool_dtype"}
    assert tpl.partition_pages(max_pages, 1, page_size, head_dim) == want
    for split in (1, 2, 3, 4, 8, 16):
        pages = tpl.partition_pages(max_pages, split, page_size, head_dim)
        per_split = max_pages // tpl.normalize_split_k(split, max_pages)
        assert per_split % pages == 0 and pages * page_size * head_dim <= 16384 or pages == 1
        if per_split % want == 0:  # the rule does not move with the split where it need not
            assert pages == want


@pytest.mark.parametrize("split", [1, 2, 4])
def test_an_f32_query_over_bf16_pools_keeps_the_callers_split(split):
    """Its p is rounded to bf16 relative to the partition's max, so the
    kernel partitions as the plain version does; every other pairing takes
    the rule's partitions."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    assert tpl.partition_pages(128, split, 8, 64, f32, bf16) == 128 // split
    for q_dtype, pool in ((f32, f32), (f32, i8), (bf16, bf16), (bf16, i8), (bf16, f32)):
        assert tpl.partition_pages(128, split, 8, 64, q_dtype, pool) == 4


@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("head_dim", [32, 64, 128, 512])
@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_partitions_stay_within_the_staged_keys(pool, head_dim, page_size):
    """The kernel stages a whole partition's K and V at once, so at every
    bucket width (1 to 4096 pages) and split the rule keeps a partition
    within 16384 keys x channels (or one page) and divides the split's run;
    the launcher refuses a block past shared memory, and
    tests/test_torch_kernels_cuda.py runs the most rows at the largest
    partitions on the card."""
    for mp in (2**i for i in range(13)):
        for split in (1, 2, 8):
            pages = tpl.partition_pages(mp, split, page_size, head_dim, torch.bfloat16, pool)
            assert (mp // tpl.normalize_split_k(split, mp)) % pages == 0
            assert pages == 1 or pages * page_size * head_dim <= 16384


def _partials(seed, n_parts=5, H=3, R=2):
    r = np.random.default_rng(seed)
    m = torch.from_numpy(r.standard_normal((B, n_parts, H, R)).astype(np.float32))
    l = torch.from_numpy(r.uniform(0.5, 3.0, (B, n_parts, H, R)).astype(np.float32))
    acc = torch.from_numpy(r.standard_normal((B, n_parts, H, R, C)).astype(np.float32))
    return m, l, acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_partitions_plain_version(dtype):
    """On the CPU `merge_partitions` is merge_partials + finalize; a neutral
    partition (M_INIT, 0, 0) adds exact zeros (torch sums 4 and 5 terms in
    different orders, so to the f32 tolerance here; the CUDA merge adds in
    ascending order and is held bit for bit on the card); an all-neutral row
    gives 0; one partition gives exactly its own acc / l."""
    m, l, acc = _partials(0)
    out = tpl.merge_partitions(m, l, acc, dtype)
    want, _ = finalize(*merge_partials(m, l, acc, axis=1))
    assert out.dtype == dtype and out.shape == (B, 3, 2, C)
    assert torch.equal(out, want.to(dtype))
    m[:, 2], l[:, 2], acc[:, 2] = M_INIT, 0.0, 0.0  # partition 2 neutral ...
    keep = [0, 1, 3, 4]
    torch.testing.assert_close(tpl.merge_partitions(m, l, acc, dtype),
                               tpl.merge_partitions(m[:, keep], l[:, keep], acc[:, keep], dtype),
                               atol=TOL["float32"], rtol=TOL["float32"])
    m[1, :, 0], l[1, :, 0], acc[1, :, 0] = M_INIT, 0.0, 0.0  # ... and every partition of one head
    out = tpl.merge_partitions(m, l, acc, dtype)
    assert torch.isfinite(out).all() and (out[1, 0] == 0).all()
    one = tpl.merge_partitions(m[:, :1], l[:, :1], acc[:, :1], dtype)
    assert torch.equal(one, (acc[:, 0] / l[:, 0, ..., None].clamp_min(1e-30)).to(dtype))


def _problem(hq, hkv, n_rows, dtype, seed=0):
    """q (B, H_q, R, C), pools (H_kv, NP, PS, C), a table that fills 13 and
    9 of its 16 pages and parks the rest on the sink page, counts ending at
    100 and 70 (nondecreasing rows), as numpy."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, hq, n_rows, C)).astype(np.float32)
    k = r.standard_normal((hkv, NP, PS, C)).astype(np.float32)
    v = r.standard_normal((hkv, NP, PS, C)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    perm = r.permutation(np.arange(1, NP))
    table = np.zeros((B, MP), np.int32)
    table[0, :13], table[1, :9] = perm[:13], perm[13:22]
    counts = (np.array([100, 70])[:, None] - n_rows + 1 + np.arange(n_rows)[None]).astype(np.int32)
    return q, k, v, table, counts


@pytest.mark.parametrize(
    "dtype,hq,hkv,n_rows,window,sinks",
    [
        ("float32", 2, 2, 1, 0, 0),  # decode
        ("bfloat16", 4, 2, 3, 0, 0),  # GQA verify: 6 folded rows
        ("bfloat16", 4, 2, 1, 24, 3),  # windowed GQA decode
        ("int8", 4, 2, 3, 0, 0),  # an f32 query over int8 pools
    ],
)
def test_plain_template_at_the_kernel_partition_count_matches_jax(dtype, hq, hkv, n_rows, window, sinks):
    n_parts = MP // tpl.partition_pages(MP, 1, PS, C)
    assert n_parts == 4 and tpl.normalize_split_k(n_parts, MP) == n_parts
    q, k, v, table, counts = _problem(hq, hkv, n_rows, dtype)
    win = dict(sliding_window=window, attn_sinks=sinks)
    if dtype == "int8":
        pools = []
        for x in (k, v):
            codes, scales = j_quantize(jnp.asarray(x).transpose(1, 0, 2, 3))
            pools += [np.asarray(codes).transpose(1, 0, 2, 3).copy(), np.asarray(scales)]
        k8, ks, v8, vs = pools
        jargs = [jnp.asarray(a) for a in (q, k8, v8, table, counts, ks, vs)]
        targs = [torch.from_numpy(a) for a in (q, k8, v8, table, counts, ks, vs)]
        tol = TOL["float32"]
    else:
        jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
        jargs = [jnp.asarray(a, jd) for a in (q, k, v)] + [jnp.asarray(table), jnp.asarray(counts)]
        targs = [torch.from_numpy(a).to(td) for a in (q, k, v)] + [torch.from_numpy(table), torch.from_numpy(counts)]
        tol = TOL[dtype]
    for split in (1, n_parts):
        want = np.asarray(j_template(*jargs, split_k=split, **win)).astype(np.float32)
        got = tpl.paged_attention_template_plain(*targs, split_k=split, **win)
        assert got.shape == (B, hq, n_rows, C) and got.dtype == targs[0].dtype
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
