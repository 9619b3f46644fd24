"""Port parity, int8 paged KV cache: the quantizer bit for bit, the int8
pool's writes (codes and scales), the int8 gather lowering, and the int8
paged prefill/decode forwards (logits, pools and scales), against
midgpt_tpu on the same inputs. The int8 template spec (plain version and
kernel) and int8 speculative serving: tests/test_torch_spec.py and
tests/test_torch_kernels_cuda.py.

Tolerances: the quantizer's codes and scales exact (same f32 division,
half-to-even rounding, same scale product); float32 logits 2e-5 absolute
(a few f32 matmul/softmax summation-order ulps through two layers);
attention outputs f32 1e-5 and bf16 1e-2, absolute and relative, as
tests/test_torch_attention.py; the pools of the two-layer forward hold
identical codes and scales within f32 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.kernels.decode_attention import paged_attention_gather as j_gather
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.models.gpt import PagedKVCache as JCache
from midgpt_tpu.models.gpt import _paged_write as j_paged_write
from midgpt_tpu.ops.quant import dequantize_q8 as j_dequant
from midgpt_tpu.ops.quant import quantize_q8 as j_quant
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.kernels.decode_attention import paged_attention_gather as t_gather
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache, _paged_write
from midgpt_tpu_torch.ops.quant import Q8_MAX, dequantize_q8, quantize_q8
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

CPU = torch.device("cpu")
SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _quant_inputs():
    """Gaussian vectors, an all-zero vector, and exact halfway ties: amax
    127 makes the scale exactly 1, so x / scale lands on k + 0.5."""
    r = np.random.default_rng(0)
    x = (3.0 * r.standard_normal((6, 3, 17))).astype(np.float32)
    x[1, 2] = 0.0
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5], np.float32)
    x[2, 0, : len(ties)] = ties
    x[2, 0, len(ties):] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(dtype):
    x = _quant_inputs()
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jq, js = j_quant(jx)
    tq, ts = quantize_q8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_q8(tq, ts).numpy(), np.asarray(j_dequant(jq, js)))
    assert np.abs(tq.numpy().astype(np.int32)).max() <= Q8_MAX  # -128 never produced
    assert (ts[1, 2] == 0).item() and not tq[1, 2].any()  # all-zero vector: scale 0, codes 0
    if dtype == "float32":  # halves round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        np.testing.assert_array_equal(tq[2, 0, :10].numpy(), [127, 0, 2, 2, 0, -2, -2, 126, -126, 4])


def test_int8_cache_layout_matches_jax():
    cfg, jcfg = GPTConfig(**SHAPE), JConfig(**SHAPE)
    tc = PagedKVCache.init(cfg, num_pages=9, page_size=8, dtype=torch.int8, device=CPU)
    jc = JCache.init(jcfg, num_pages=9, page_size=8, dtype=jnp.int8)
    assert tc.quantized and jc.quantized
    assert tc.num_pages == 9  # the allocator's pages; the spare page (index 9) comes after them
    for t, j, axis in ((tc.k, jc.k, 2), (tc.v, jc.v, 2), (tc.k_scale, jc.k_scale, 1), (tc.v_scale, jc.v_scale, 1)):
        assert tuple(t.narrow(axis, 0, 9).shape) == j.shape and t.shape[axis] == 10
        assert str(t.dtype)[6:] == str(j.dtype)
    want = sum(a.size * a.dtype.itemsize for a in (jc.k, jc.v, jc.k_scale, jc.v_scale))
    assert tc.nbytes == want * 10 // 9
    for dt, jdt in ((torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16)):
        assert PagedKVCache.page_bytes(cfg, 8, dt) == JCache.page_bytes(jcfg, 8, jdt)
    bf = PagedKVCache.init(cfg, num_pages=9, page_size=8, dtype=torch.bfloat16, device=CPU)
    assert not bf.quantized and bf.k_scale is None and bf.nbytes == 2 * tc.k.numel() * 2


def test_int8_paged_write_matches_jax():
    """The quantizing column scatter: codes land at (page, offset) of every
    head and the scales at [page, head, offset] — torch's separated
    advanced indices put the (N, H) dims first, as the scale shape is."""
    L, H, P, ps, C = 2, 3, 6, 4, 16
    r = np.random.default_rng(1)
    val = r.standard_normal((5, H, C)).astype(np.float32)
    pages = np.array([2, 2, 5, 1, 3], np.int32)
    offs = np.array([0, 3, 1, 2, 0], np.int32)
    jp, js = j_paged_write(
        jnp.zeros((L, H, P, ps, C), jnp.int8), jnp.zeros((L, P, H, ps), jnp.float32), 1,
        jnp.asarray(pages), jnp.asarray(offs), jnp.asarray(val),
    )
    tp_, ts = torch.zeros(L, H, P, ps, C, dtype=torch.int8), torch.zeros(L, P, H, ps)
    _paged_write(tp_, ts, 1, torch.from_numpy(pages).long(), torch.from_numpy(offs).long(), torch.from_numpy(val))
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


B, H, C = 3, 2, 64
PS, NP = 8, 7
TABLE = np.array([[3, 1, 0, 0], [5, 2, 6, 0], [4, 0, 0, 0]], np.int32)
LENGTHS = np.array([11, 24, 1], np.int32)


def _int8_problem(seed=0):
    """q, int8 pools and their (P, H, ps) scales, quantized per (page, head,
    position) over C by the JAX quantizer."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, C)).astype(np.float32)
    out = [q]
    for _ in range(2):
        f = r.standard_normal((H, NP, PS, C)).astype(np.float32)
        codes, scales = j_quant(jnp.asarray(f.transpose(1, 0, 2, 3)))
        out += [np.asarray(codes).transpose(1, 0, 2, 3).copy(), np.array(scales)]
    return out  # q, kq, ks, vq, vs


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split_k", [1, 2])
def test_int8_gather_matches_jax_gather(qdtype, split_k):
    """Dequantized right after the gather, cast to q's dtype."""
    q, kq, ks, vq, vs = _int8_problem(seed=split_k)
    if qdtype == "bfloat16":
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    jd, td = (jnp.bfloat16, torch.bfloat16) if qdtype == "bfloat16" else (jnp.float32, torch.float32)
    want = j_gather(jnp.asarray(q, jd), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(TABLE),
                    jnp.asarray(LENGTHS), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), split_k=split_k)
    t = [torch.from_numpy(a) for a in (kq, ks, vq, vs)]
    got = t_gather(torch.from_numpy(q).to(td), t[0], t[2], torch.from_numpy(TABLE), torch.from_numpy(LENGTHS),
                   k_scale=t[1], v_scale=t[3], split_k=split_k)
    assert got.dtype == td
    tol = 1e-2 if qdtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32), atol=tol, rtol=tol)


_j_prefill = jax.jit(JGPT.prefill_paged_chunk, static_argnums=(0,))
_j_decode = jax.jit(JGPT.decode_step_paged, static_argnums=(0, 7, 8, 9))


def test_int8_paged_prefill_and_decode_match_jax():
    """Two prefill chunks for slot 0, one for slot 1, then two decode steps
    with slot 2 inactive, all on an int8 pool: logits of every valid row,
    the scales, and the pools must agree."""
    jcfg = JConfig(**SHAPE, rope_style="split")
    tcfg = GPTConfig(**SHAPE, rope_style="split")
    jp = JGPT.init(jcfg, jax.random.PRNGKey(3))
    tp_ = params_from_numpy(_flatten(jp), device=CPU)
    ps, n_pages = 8, 12
    jc = JCache.init(jcfg, num_pages=n_pages, page_size=ps, dtype=jnp.int8)
    tc = PagedKVCache.init(tcfg, num_pages=n_pages, page_size=ps, dtype=torch.int8, device=CPU)
    table = np.array([[3, 7, 1, 0], [5, 2, 0, 0], [9, 0, 0, 0]], np.int32)
    prompts = [np.random.default_rng(4).integers(0, 96, 21), np.random.default_rng(5).integers(0, 96, 9)]
    chunk = 16
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            n_valid = min(chunk, len(prompt) - start)
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :n_valid] = prompt[start : start + n_valid]
            row = table[slot : slot + 1]
            jl, jc = _j_prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(start, jnp.int32),
                                jnp.asarray(n_valid, jnp.int32), jc, jnp.asarray(row))
            tl, tc = GPT.prefill_paged_chunk(tcfg, tp_, torch.from_numpy(toks), start, n_valid, tc,
                                             torch.from_numpy(row))
            np.testing.assert_allclose(tl.numpy()[0, :n_valid], np.asarray(jl)[0, :n_valid], atol=2e-5, rtol=0)
    lengths = np.array([21, 9, 0], np.int32)
    token = np.array([5, 17, 0], np.int32)
    active = np.array([True, True, False])
    for split_k in (1, 2):
        jl, jc = _j_decode(jcfg, jp, jnp.asarray(token), jc, jnp.asarray(table), jnp.asarray(lengths),
                           jnp.asarray(active), "gather", None, split_k)
        tl, tc = GPT.decode_step_paged(tcfg, tp_, torch.from_numpy(token), tc, torch.from_numpy(table),
                                       torch.from_numpy(lengths), torch.from_numpy(active),
                                       attn_impl="gather", split_k=split_k)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
        token = np.asarray(jl).argmax(-1).astype(np.int32)
        lengths = lengths + active
    assert_int8_pools_match(tc, jc)
    assert not tc.k[:, :, 0].any() and not tc.k_scale[:, 0].any()  # nothing reached the sink


def assert_int8_pools_match(tc, jc):
    """Identical codes; scales within f32 1e-5 relative (the written K/V
    vectors differ from JAX's by matmul summation-order ulps, which move a
    scale by an ulp and, on this problem, no code)."""
    n = jc.num_pages  # pages 0..n-1: the port's spare page n has no JAX counterpart
    for tp_, ts, jp, js in ((tc.k, tc.k_scale, jc.k, jc.k_scale), (tc.v, tc.v_scale, jc.v, jc.v_scale)):
        np.testing.assert_array_equal(tp_[:, :, :n].numpy(), np.asarray(jp))
        np.testing.assert_allclose(ts[:, :n].numpy(), np.asarray(js), atol=0, rtol=1e-5)
