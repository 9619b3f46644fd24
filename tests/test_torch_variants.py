"""Port parity, attention variants: GQA/MQA (`n_kv_heads`) and the sliding
window with attention sinks (`sliding_window`, `attn_sinks`), from the
template to training and serving, against midgpt_tpu on the same inputs
(numpy-seeded) and converted weights.

* Template: the port's plain version against JAX's
  `paged_attention_template` in interpret mode over {GQA 4/2, MQA 4/1,
  window 10 + 3 sinks on GQA} x {f32, bf16, int8} x split {1, 2} x
  {decode, verify R 3} (the kernel-level shapes of
  tests/test_attention_variants.py VARIANTS); a window wider than every
  count equals no window bit for bit. Both gathers against JAX's.
* Training attention: naive and blockwise with a window and sinks.
* Model: `apply`, `hidden` (flash's plain version for GQA),
  `prefill_paged_chunk`, `decode_step_paged` and `verify_step_paged`
  (logits and pools, f32 and int8); n_kv_heads == n_head converts from
  JAX's GQA layout; the 3-step train step against JAX's `make_train_step`.
* Serving: greedy engine streams identical to JAX's engine for GQA,
  GQA + window with page reclamation (counter equal and > 0, the resident
  bound, conservation) and a GQA self-draft; the launcher on the CPU with
  `--set model_config.n_kv_heads=2`, then `sample --ckpt_dir`.
* Config: JAX's validation negative paths.

Tolerances: float32 2e-5 absolute and relative (summation order; JAX's
template test holds the same against its dense oracle); bfloat16 1e-2 (an
f32 sum in another order can move a bf16 rounding by one ulp); logits 2e-5
and pools 1e-5 absolute (test_torch_model.py's); int8 pools: codes within
one step, scales 1e-5 relative (an ulp of the K/V vector can tip a code);
train step as tests/test_torch_train.py (losses 1e-5 relative, parameters
2e-5 absolute)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.kernels.attention_template import paged_attention_template as j_template
from midgpt_tpu.kernels.decode_attention import paged_attention_gather as j_gather
from midgpt_tpu.kernels.decode_attention import paged_verify_attention_gather as j_verify_gather
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.models.gpt import PagedKVCache as JCache
from midgpt_tpu.ops.attention import blockwise_causal_attention as j_blockwise
from midgpt_tpu.ops.attention import naive_causal_attention as j_naive
from midgpt_tpu.ops.quant import quantize_q8 as j_quantize
from midgpt_tpu.parallel.data import make_global_batch
from midgpt_tpu.parallel.mesh import batch_spec, make_mesh
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu.sampling.spec import self_draft as j_self_draft
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_train_step as j_make_train_step
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.convert import params_from_numpy, params_to_numpy
from midgpt_tpu_torch.data.dataset import TokenDataset
from midgpt_tpu_torch.kernels import attention_template as tpl
from midgpt_tpu_torch.kernels.decode_attention import paged_attention_gather, paged_verify_attention_gather
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache, param_names
from midgpt_tpu_torch.ops.attention import blockwise_causal_attention, naive_causal_attention
from midgpt_tpu_torch.sampling.serve import ServeEngine
from midgpt_tpu_torch.sampling.spec import self_draft
from midgpt_tpu_torch.training.optim import make_optimizer
from midgpt_tpu_torch.training.train import make_train_step
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = {"float32": 2e-5, "bfloat16": 1e-2}

# kernel level: tests/test_attention_variants.py's VARIANTS and problem
B, C = 2, 128
PS, NP, MP = 8, 7, 4
VARIANTS = {
    "gqa": dict(hq=4, hkv=2, window=0, sinks=0),
    "mqa": dict(hq=4, hkv=1, window=0, sinks=0),
    "window": dict(hq=4, hkv=2, window=10, sinks=3),
}
# model level: the two variants of the slice (GQA 4 query heads per K/V
# head at local_text_124m; here 4 over 2, and the window + sinks on it)
SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)
MODELS = {
    "gqa": dict(n_kv_heads=2),
    "gqa_window": dict(n_kv_heads=2, sliding_window=16, attn_sinks=4),
}


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _kernel_problem(hq, hkv, n_rows, dtype, seed=0):
    """q (B, H_q, R, C), pools (H_kv, NP, PS, C), a table with repeats and
    ragged page-unaligned counts (base + t + 1 per verify row), as numpy."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, hq, n_rows, C)).astype(np.float32)
    k = r.standard_normal((hkv, NP, PS, C)).astype(np.float32)
    v = r.standard_normal((hkv, NP, PS, C)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = map(_bf16_exact, (q, k, v))
    table = r.integers(0, NP, (B, MP)).astype(np.int32)
    base = np.array([19, MP * PS - n_rows], np.int32)
    counts = (base[:, None] + np.arange(n_rows)[None] + 1).astype(np.int32)
    return q, k, v, table, counts


def _int8_pools(k, v):
    """int8 codes and (NP, H_kv, PS) scales, quantized by JAX (bit-exact
    with ops/quant.py, tests/test_torch_quant.py)."""
    out = []
    for x in (k, v):
        qp, s = j_quantize(jnp.asarray(x).transpose(1, 0, 2, 3))
        out += [np.asarray(qp).transpose(1, 0, 2, 3).copy(), np.asarray(s)]
    return out  # k8, ks, v8, vs


# ----------------------------------------------------------------------
# Template, gathers, training attention
# ----------------------------------------------------------------------


def _matrix(variants, dtypes, splits, modes, cheap):
    """The parameter grid, each cell slow unless `cheap(cell)`: every cell
    is a JAX interpret-mode (or eager) compile of ~1 s, so each variant's f32
    decode at split 1 and the window's verify at split 2 in every dtype stay
    in the fast tier."""
    return [
        pytest.param(*cell, marks=() if cheap(*cell) else pytest.mark.slow)
        for cell in ((v, d, s, m) for v in variants for d in dtypes for s in splits for m in modes)
    ]


@pytest.mark.parametrize(
    "variant,dtype,split,mode",
    _matrix(VARIANTS, ("float32", "bfloat16", "int8"), (1, 2), ("decode", "verify"),
            lambda v, d, s, m: (s, m) == (1, "decode") and d == "float32" or (s, m) == (2, "verify")
            and v == "window"),
)
def test_plain_template_matches_jax_interpret_template(variant, dtype, split, mode):
    """The GQA fold and the window through the port's plain version and
    JAX's Pallas template (interpret mode) on the same inputs. int8: an f32
    query over int8 pools with their scales (f32 tolerance)."""
    vt = VARIANTS[variant]
    n_rows = 1 if mode == "decode" else 3
    q, k, v, table, counts = _kernel_problem(vt["hq"], vt["hkv"], n_rows, dtype)
    win = dict(sliding_window=vt["window"], attn_sinks=vt["sinks"])
    if dtype == "int8":
        k8, ks, v8, vs = _int8_pools(k, v)
        want = j_template(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(table),
                          jnp.asarray(counts), jnp.asarray(ks), jnp.asarray(vs), split_k=split, **win)
        got = tpl.paged_attention_template(*map(torch.from_numpy, (q, k8, v8, table, counts, ks, vs)),
                                           split_k=split, **win)
        tol = TOL["float32"]
    else:
        jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
        want = j_template(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(table), jnp.asarray(counts),
                          split_k=split, **win)
        got = tpl.paged_attention_template(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                           torch.from_numpy(table), torch.from_numpy(counts), split_k=split, **win)
        tol = TOL[dtype]
        assert got.dtype == td
    assert got.shape == (B, vt["hq"], n_rows, C)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("split", [1, 2])
def test_full_window_is_bit_identical_to_windowless(split):
    q, k, v, table, counts = (torch.from_numpy(a) for a in _kernel_problem(4, 2, 3, "float32", seed=5))
    base = tpl.paged_attention_template(q, k, v, table, counts, split_k=split)
    wide = tpl.paged_attention_template(q, k, v, table, counts, split_k=split, sliding_window=MP * PS, attn_sinks=3)
    assert torch.equal(wide, base)


def test_fold_is_repeat_interleave_and_tiled_counts():
    """Folding G query heads into rows gives each query head the MHA result
    against its group's K/V head (query head h reads K/V head h // G)."""
    q, k, v, table, counts = (torch.from_numpy(a) for a in _kernel_problem(4, 2, 3, "float32", seed=6))
    got = tpl.paged_attention_template(q, k, v, table, counts)
    mha = tpl.paged_attention_template(q, k.repeat_interleave(2, 0), v.repeat_interleave(2, 0), table, counts)
    np.testing.assert_allclose(got.numpy(), mha.numpy(), atol=1e-6, rtol=0)
    assert tpl.spec_name(1, False, 4, 0) == "gqa-decode"
    assert tpl.spec_name(5, True, 4, 256) == "int8-window-gqa-verify"
    assert tpl.spec_name(1, False) == "decode"
    with pytest.raises(ValueError, match="group"):
        tpl.paged_attention_template(q[:, :3], k, v, table, counts)


@pytest.mark.parametrize(
    "variant,pool,split,mode",
    _matrix(VARIANTS, ("float32", "int8"), (1, 2), ("decode", "verify"),
            lambda v, p, s, m: (s, m) == (1, "decode") and p == "float32" or (s, m) == (2, "verify")
            and v == "window"),
)
def test_gathers_match_jax_gathers(variant, pool, split, mode):
    vt = VARIANTS[variant]
    n_rows = 1 if mode == "decode" else 3
    q, k, v, table, counts = _kernel_problem(vt["hq"], vt["hkv"], n_rows, "float32", seed=1)
    win = dict(sliding_window=vt["window"], attn_sinks=vt["sinks"])
    pools = (k, v, None, None)
    if pool == "int8":
        k8, ks, v8, vs = _int8_pools(k, v)
        pools = (k8, v8, ks, vs)
    jpools = [None if a is None else jnp.asarray(a) for a in pools]
    tpools = [None if a is None else torch.from_numpy(a) for a in pools]
    if mode == "decode":
        want = j_gather(jnp.asarray(q[:, :, 0]), jpools[0], jpools[1], jnp.asarray(table), jnp.asarray(counts[:, 0]),
                        jpools[2], jpools[3], split_k=split, **win)
        got = paged_attention_gather(torch.from_numpy(q[:, :, 0]), tpools[0], tpools[1], torch.from_numpy(table),
                                     torch.from_numpy(counts[:, 0]), tpools[2], tpools[3], split_k=split, **win)
    else:
        qt = np.ascontiguousarray(q.transpose(0, 2, 1, 3))  # (B, T, H_q, C)
        want = j_verify_gather(jnp.asarray(qt), jpools[0], jpools[1], jnp.asarray(table), jnp.asarray(counts),
                               jpools[2], jpools[3], split_k=split, **win)
        got = paged_verify_attention_gather(torch.from_numpy(qt), tpools[0], tpools[1], torch.from_numpy(table),
                                            torch.from_numpy(counts), tpools[2], tpools[3], split_k=split, **win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("window,sinks", [(5, 0), (7, 3)])
@pytest.mark.parametrize("impl", ["naive", "blockwise"])
def test_training_attention_window_matches_jax(impl, window, sinks):
    r = np.random.default_rng(2)
    q, k, v = (r.standard_normal((2, 3, 24, 16)).astype(np.float32) for _ in range(3))  # (B, H, T, C)
    if impl == "naive":
        want = j_naive(*map(jnp.asarray, (q, k, v)), sliding_window=window, attn_sinks=sinks)
        bthc = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
        got = naive_causal_attention(*bthc, sliding_window=window, attn_sinks=sinks).transpose(1, 2)
    else:
        want = j_blockwise(*map(jnp.asarray, (q, k, v)), block_size=8, sliding_window=window, attn_sinks=sinks)
        got = blockwise_causal_attention(*map(torch.from_numpy, (q, k, v)), block_size=8,
                                         sliding_window=window, attn_sinks=sinks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"], rtol=TOL["float32"])


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------


def _pair(variant, seed=0, **over):
    shape = {**SHAPE, **MODELS[variant], **over}
    jcfg, tcfg = JConfig(**shape), GPTConfig(**shape)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)  # non-trivial QK-norm scales: the split permutation of them matters
    jp.blocks.attn.q_scale = jnp.asarray(r.uniform(0.5, 1.5, jp.blocks.attn.q_scale.shape), jnp.float32)
    jp.blocks.attn.k_scale = jnp.asarray(r.uniform(0.5, 1.5, jp.blocks.attn.k_scale.shape), jnp.float32)
    return jcfg, jp, tcfg, params_from_numpy(_flatten(jp), config=tcfg, device=CPU)


@pytest.mark.parametrize(
    "variant,rope_style",
    [("gqa", "interleaved"), pytest.param("gqa", "split", marks=pytest.mark.slow),
     pytest.param("gqa_window", "interleaved", marks=pytest.mark.slow), ("gqa_window", "split")],
)
def test_apply_logits_match_jax(variant, rope_style):
    jcfg, jp, tcfg, tp_ = _pair(variant, rope_style=rope_style)
    assert tp_["blocks.attn.wkv"].shape == (2, 2, 2 * 8, 32) and tp_["blocks.attn.wqkv"].shape == (2, 1, 32, 32)
    tokens = np.random.default_rng(1).integers(0, 96, (2, 40))
    want = np.asarray(JGPT.apply(jcfg, jp, jnp.asarray(tokens), inference=True))
    got = GPT.apply(tcfg, tp_, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("variant,impl", [("gqa", "flash"), ("gqa", "blockwise"), ("gqa_window", "blockwise")])
def test_training_hidden_matches_jax(variant, impl):
    """The training forward (K/V repeated to the query heads after RoPE);
    flash is its plain version here."""
    jcfg, jp, tcfg, tp_ = _pair(variant, seed=3, attn_impl=impl, attn_block_size=16, rope_style="split")
    tokens = np.random.default_rng(4).integers(0, 96, (2, 64))
    want = JGPT.hidden(jcfg, jp, jnp.asarray(tokens))
    got = GPT.hidden(tcfg, tp_, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_n_kv_heads_equal_to_n_head_takes_the_gqa_layout():
    """JAX keys the GQA layout on n_kv_heads being set, even to n_head: a q
    wqkv (L, 1, D, D) and a wkv (L, 2, D, D). Such a run converts and
    computes JAX's logits; the MHA layout is refused for its config."""
    jcfg, jp, tcfg, tp_ = _pair("gqa", n_kv_heads=4)
    assert "blocks.attn.wkv" in param_names(tcfg) and tp_["blocks.attn.wkv"].shape == (2, 2, 32, 32)
    assert set(GPT.init(tcfg, 0, device=CPU)) == set(param_names(tcfg)) == set(tp_)
    tokens = np.random.default_rng(1).integers(0, 96, (2, 16))
    want = np.asarray(JGPT.apply(jcfg, jp, jnp.asarray(tokens), inference=True))
    np.testing.assert_allclose(GPT.apply(tcfg, tp_, torch.from_numpy(tokens)).numpy(), want, atol=2e-5, rtol=0)
    back = params_to_numpy(tp_)
    for k_, v_ in _flatten(jp).items():
        np.testing.assert_array_equal(back[k_.lstrip(".")], v_)
    mha = _flatten(JGPT.init(JConfig(**SHAPE), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="wkv"):
        params_from_numpy(mha, config=tcfg, device=CPU)


# jitted as the JAX engine runs them (one compile instead of op-by-op)
_j_prefill = jax.jit(JGPT.prefill_paged_chunk, static_argnums=(0,))
_j_decode = jax.jit(JGPT.decode_step_paged, static_argnums=(0, 7, 8, 9))
_j_verify = jax.jit(JGPT.verify_step_paged, static_argnums=(0, 7, 8, 9))


def _close_pools(tc, jc, quantized):
    n = jc.num_pages  # pages 0..n-1: the port's spare page n has no JAX counterpart
    if quantized:
        assert np.abs(tc.k[:, :, :n].numpy().astype(np.int32) - np.asarray(jc.k).astype(np.int32)).max() <= 1
        assert np.abs(tc.v[:, :, :n].numpy().astype(np.int32) - np.asarray(jc.v).astype(np.int32)).max() <= 1
        for a, b in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            np.testing.assert_allclose(a[:, :n].numpy(), np.asarray(b), atol=0, rtol=1e-5)
    else:
        np.testing.assert_allclose(tc.k[:, :, :n].numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tc.v[:, :, :n].numpy(), np.asarray(jc.v), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "variant,dtype",
    [pytest.param("gqa", "float32", marks=pytest.mark.slow), ("gqa", "int8"), ("gqa_window", "float32"),
     pytest.param("gqa_window", "int8", marks=pytest.mark.slow)],
)
def test_paged_prefill_decode_verify_match_jax(variant, dtype):
    """Prefill chunks (a prompt past the window), decode steps at split 1
    and 2 with an inactive slot, then a verify forward: logits of every
    valid row and the K/V pools (at H_kv heads) agree with JAX's."""
    jcfg, jp, tcfg, tp_ = _pair(variant, seed=2, rope_style="split")
    ps, n_pages = 8, 16
    jdt, tdt = ("int8", torch.int8) if dtype == "int8" else (jnp.float32, torch.float32)
    jc = JCache.init(jcfg, num_pages=n_pages, page_size=ps, dtype=jdt)
    tc = PagedKVCache.init(tcfg, num_pages=n_pages, page_size=ps, dtype=tdt, device=CPU)
    assert tc.k.shape == (2, 2, n_pages + 1, ps, 8) and tuple(tc.k[:, :, :n_pages].shape) == tuple(jc.k.shape)
    assert PagedKVCache.page_bytes(tcfg, ps, tdt) == JCache.page_bytes(jcfg, ps, jdt)
    table = np.array([[3, 7, 1, 12, 14, 0, 0, 0], [5, 2, 0, 0, 0, 0, 0, 0], [9, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    prompts = [np.random.default_rng(3).integers(0, 96, 37), np.random.default_rng(4).integers(0, 96, 9)]
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
    _close_pools(tc, jc, dtype == "int8")

    lengths = np.array([37, 9, 0], np.int32)
    token = np.array([5, 17, 0], np.int32)
    active = np.array([True, True, False])
    for split_k in (1, 2):
        jl, jc = _j_decode(jcfg, jp, jnp.asarray(token), jc, jnp.asarray(table), jnp.asarray(lengths),
                                        jnp.asarray(active), "gather", None, split_k)
        tl, tc = GPT.decode_step_paged(tcfg, tp_, torch.from_numpy(token), tc, torch.from_numpy(table),
                                       torch.from_numpy(lengths), torch.from_numpy(active), attn_impl="gather",
                                       split_k=split_k)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
        _close_pools(tc, jc, dtype == "int8")
        token = np.asarray(jl).argmax(-1).astype(np.int32)
        lengths = lengths + active
    tokens = np.random.default_rng(5).integers(0, 96, (3, 4)).astype(np.int32)
    jl, jc = _j_verify(jcfg, jp, jnp.asarray(tokens), jc, jnp.asarray(table), jnp.asarray(lengths),
                                    jnp.asarray(active), "gather", None, 2)
    tl, tc = GPT.verify_step_paged(tcfg, tp_, torch.from_numpy(tokens), tc, torch.from_numpy(table),
                                   torch.from_numpy(lengths), torch.from_numpy(active), attn_impl="gather", split_k=2)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=2e-5, rtol=0)
    _close_pools(tc, jc, dtype == "int8")
    # the template's plain version (the kernel's oracle) gives the gather's logits
    kl, _ = GPT.verify_step_paged(tcfg, tp_, torch.from_numpy(tokens), tc, torch.from_numpy(table),
                                  torch.from_numpy(lengths), torch.from_numpy(active), attn_impl="kernel", split_k=2)
    np.testing.assert_allclose(kl.numpy()[:2], tl.numpy()[:2], atol=2e-5, rtol=0)


@pytest.mark.parametrize("variant,impl", [("gqa", "flash"), ("gqa_window", "blockwise")])
def test_train_step_matches_jax(tmp_path, variant, impl):
    """Three G=2 steps from the same (JAX-initialized) params on the same
    batches, as tests/test_torch_train.py holds MHA: each step's loss and
    the params after it, wkv included."""
    r = np.random.default_rng(0)  # tests/test_torch_train.py's learnable stream
    stream = np.where(r.random(20000) < 0.1, r.integers(0, 64, 20000), np.arange(20000) % 17).astype(np.uint16)
    stream.tofile(tmp_path / "train.bin")
    stream[:4000].tofile(tmp_path / "val.bin")
    base = dict(
        rundir="", data_dir=str(tmp_path), learning_rate=1e-2, batch_size=4, warmup_steps=2, min_lr=1e-3,
        lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=10,
        param_dtype="float32", compute_dtype="float32", g_accum_iters=2, shard_model=False, eval_steps=2,
    )
    # tests/test_torch_train.py's model, with 4 query heads over 2 K/V heads
    model = dict(SHAPE, block_size=32, vocab_size=64, n_embd=64, **MODELS[variant], attn_impl=impl,
                 attn_block_size=16)
    if variant == "gqa_window":
        model.update(sliding_window=8, attn_sinks=2)
    jc = JExperimentConfig(**base, mesh=JMeshConfig(data=1, fsdp=1, sp=1), model_config=JConfig(**model))
    tc = ExperimentConfig(**base, mesh=MeshConfig(data=1, fsdp=1, sp=1), model_config=GPTConfig(**model))
    mesh = make_mesh(jc.mesh, devices=jax.devices()[:1])
    jp, j_state, specs, j_opt = j_init_state(jc, mesh)
    j_step, *_ = j_make_train_step(jc, j_opt, mesh, specs)
    opt, _ = make_optimizer(tc)
    tp_ = params_from_numpy(_flatten(jp), config=tc.model_config, device=CPU)
    t_state = opt.init(tp_)
    t_step, *_ = make_train_step(tc, opt)
    ds = TokenDataset(str(tmp_path), seed=11)
    for i in range(3):
        x, y = ds.batch("train", i, 32, 4, 2)
        jp, j_state, j_loss = j_step(jp, j_state, make_global_batch(x, mesh, batch_spec()),
                                     make_global_batch(y, mesh, batch_spec()), jax.random.PRNGKey(i))
        tp_, t_state, t_loss = t_step(tp_, t_state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
        for k_, v_ in _flatten(jp).items():
            np.testing.assert_allclose(tp_[k_.lstrip(".")].numpy(), v_, atol=2e-5, rtol=0, err_msg=f"step {i} {k_}")


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

ENGINE = dict(max_slots=3, page_size=8, prefill_chunk=16, decode_chunk=8, temperature=0.0)
SERVE_CASES = {
    # (model variant, pool pages, trace, draft layers): "gqa" preempts on
    # its small pool; "window" streams one request far past its window
    # beside two short ones; "spec" runs a one-layer GQA self-draft
    "gqa": ("gqa", 10, ((5, 20), (23, 16), (11, 24)), 0),
    "window": ("gqa_window", 16, ((12, 44), (5, 10), (20, 12)), 0),
    "spec": ("gqa", 16, ((5, 14), (11, 18)), 1),
}


def _serve_trace(spec):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, SHAPE["vocab_size"], n).astype(np.int32), m) for n, m in spec]


@pytest.fixture(scope="module")
def engines():
    """Per case, run on first use: the JAX engine's streams and counters,
    and the weights."""
    return _References()


class _References(dict):
    def __missing__(self, name):
        self[name] = _jax_reference(name)
        return self[name]


def _jax_reference(name):
    variant, pages, spec, draft = SERVE_CASES[name]
    jcfg = JConfig(**SHAPE, **MODELS[variant])
    jp = JGPT.init(jcfg, jax.random.PRNGKey(0))
    kw = {}
    if draft:
        dcfg, dparams = j_self_draft(jcfg, jp, draft)
        kw = dict(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True, spec_k_max=2)
    eng = JServeEngine(jcfg, jp, cache_dtype=jnp.float32, num_pages=pages, **ENGINE, **kw)
    uids = [eng.submit(p, m) for p, m in _serve_trace(spec)]
    done = eng.run()
    return dict(
        flat=_flatten(jp), streams=[done[u].tokens for u in uids], preemptions=eng.preemptions,
        reclaimed=eng.window_reclaimed_pages, spec=(eng._spec_drafted, eng._spec_accepted),
    )


def _port_serve(ref, name, **kw):
    variant, pages, spec, draft = SERVE_CASES[name]
    cfg = GPTConfig(**SHAPE, **MODELS[variant])
    params = params_from_numpy(ref["flat"], config=cfg, device=CPU)
    if draft:
        dcfg, dparams = self_draft(cfg, params, draft)
        kw.update(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True, spec_k_max=2)
    eng = ServeEngine(cfg, params, cache_dtype=torch.float32, device=CPU, num_pages=pages, **ENGINE, **kw)
    assert eng.cache.k.shape[1] == cfg.kv_heads
    ps, W, sinks = eng.page_size, cfg.sliding_window, cfg.attn_sinks
    bound = -(-sinks // ps) + -(-W // ps) + 2 if W else None
    uids = [eng.submit(p, m) for p, m in _serve_trace(spec)]
    while not eng.idle:
        eng.step()
        live = [sum(p >= 0 for p in s.pages) for s in eng.slots if s is not None]
        # conservation: free + live non-placeholder pages == num_pages - 1
        assert eng.allocator.free_count + sum(live) == eng.allocator.num_pages - 1
        if bound is not None:  # tests/test_attention_variants.py:271's resident bound
            assert max(live, default=0) <= bound, (live, bound)
    assert eng.allocator.free_count == eng.allocator.num_pages - 1
    return eng, [eng.finished[u].tokens for u in uids]


@pytest.mark.parametrize(
    "name,kw",
    [pytest.param("gqa", {}, marks=pytest.mark.slow),
     pytest.param("gqa", dict(attn_impl="kernel", split_k=2), marks=pytest.mark.slow),
     ("window", {}), pytest.param("window", dict(attn_impl="kernel"), marks=pytest.mark.slow),
     ("spec", {}), pytest.param("spec", dict(attn_impl="kernel"), marks=pytest.mark.slow)],
    ids=["gqa", "gqa-template-split2", "window", "window-template", "spec", "spec-template"],
)
def test_port_engine_matches_jax_engine(engines, name, kw):
    """Greedy streams identical to JAX's engine on the same weights, with
    equal preemption, window-reclamation and acceptance counters."""
    ref = engines[name]
    eng, got = _port_serve(ref, name, **kw)
    for i, (g, w) in enumerate(zip(got, ref["streams"])):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.preemptions == ref["preemptions"]
    st = eng.stats()
    assert st["window_reclaimed_pages"] == ref["reclaimed"]
    if name == "gqa":
        assert ref["preemptions"] >= 1, "the trace must force a preemption"
    if name == "window":
        assert st["window_reclaimed_pages"] > 0
    if name == "spec":
        assert (eng._spec_drafted, eng._spec_accepted) == ref["spec"] and st["spec"]["rounds"] > 0
        assert st["window_reclaimed_pages"] == 0


def _run(args, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_launch_gqa_on_cpu_then_serve_its_params(tmp_path):
    """The slice's entry points: the launcher trains local_text_124m with
    `--set model_config.n_kv_heads=2` (cut to a tiny width), its params.npz
    carries wkv in its final checkpoint step's params.npz and its
    config.json round-trips n_kv_heads; `sample --ckpt_dir` serves it."""
    import json

    r = np.random.default_rng(0)
    stream = r.integers(0, 64, 20000).astype(np.uint16)
    stream.tofile(tmp_path / "train.bin")
    stream[:4000].tofile(tmp_path / "val.bin")
    rundir = tmp_path / "run"
    sets = {
        "data_dir": tmp_path, "max_steps": 2, "eval_interval": 2, "eval_steps": 1, "batch_size": 2,
        "g_accum_iters": 1, "warmup_steps": 1, "lr_decay_steps": 2, "log_interval": 1, "spec_layers": 0,
        "model_config.block_size": 32, "model_config.n_layer": 2, "model_config.n_embd": 64,
        "model_config.n_head": 4, "model_config.vocab_size": 64, "model_config.attn_block_size": 16,
        "model_config.n_kv_heads": 2,
    }
    args = [a for k, v in sets.items() for a in ("--set", f"{k}={v}")]
    out = _run(["-m", "midgpt_tpu_torch.launch", "--config=local_text_124m", "--device", "cpu",
                f"--rundir={rundir}", *args])
    assert out.returncode == 0, out.stderr
    assert json.loads((rundir / "config.json").read_text())["model_config"]["n_kv_heads"] == 2
    with np.load(rundir / "1" / "params.npz") as f:  # the forced final save of step max_steps - 1
        assert f["blocks.attn.wkv"].shape == (2, 2, 2 * 16, 64) and f["blocks.attn.wqkv"].shape == (2, 1, 64, 64)
    out = _run(["-m", "midgpt_tpu_torch.sample", f"--ckpt_dir={rundir}", "--device=cpu", "--start_ids=1,2,3",
                "--num_samples=2", "--max_new_tokens=4", "--temperature=0", "--engine=continuous"])
    assert out.returncode == 0, out.stderr
    assert "2 requests on cpu" in out.stdout


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------

BASE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)


@pytest.mark.parametrize(
    "extra,match",
    [
        (dict(n_kv_heads=3), "n_kv_heads"),  # not a divisor of n_head
        (dict(n_kv_heads=0), "n_kv_heads"),
        (dict(sliding_window=64), "sliding_window"),  # must be < block_size
        (dict(sliding_window=-8), "sliding_window"),
        (dict(attn_sinks=4), "attn_sinks"),  # sinks require a window
        (dict(sliding_window=60, attn_sinks=8), "exceeds"),
        (dict(sliding_window=16, attn_impl="flash"), "naive"),  # the flash kernels carry no window
    ],
    ids=["kv-not-divisor", "kv-zero", "window-too-wide", "window-negative", "sinks-without-window",
         "sinks-plus-window-exceeds", "window-with-flash"],
)
def test_config_validation_negative_paths(extra, match):
    """JAX's validation (tests/test_attention_variants.py:359-372, plus the
    window-needs-naive-or-blockwise rule): both packages refuse the same
    configs with a ValueError."""
    with pytest.raises(ValueError, match=match):
        JConfig(**BASE, **extra)
    with pytest.raises(ValueError, match=match):
        GPTConfig(**BASE, **extra)
