"""Port parity, speculative decoding's building blocks: the template's
verify and int8 specs (the plain version against JAX's Pallas template in
interpret mode), the verify gather lowering, `GPT.verify_step_paged`
(logits, pools and scales), `self_draft`, the rejection sampler
(statistically) and `sample.main` with speculation and an int8 pool. The
engine's speculative streams: tests/test_torch_spec_serve.py; the CUDA
kernel against the plain version: tests/test_torch_kernels_cuda.py.

Template problem: 4 slots with non-contiguous page tables whose unused
entries point at the sink page 0, per-row counts lengths + t + 1 (ragged,
page-unaligned, nondecreasing), and one inactive slot whose rows all see
the sink's first key only.

Tolerances, as tests/test_torch_attention.py: float32 outputs 1e-5 absolute
and relative (summation order only); a bfloat16 query or output 1e-2 (an
f32 sum taken in another order can move a bf16 rounding by one ulp);
float32 logits 2e-5 absolute (two layers of f32 matmuls)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.kernels.attention_template import paged_attention_template as j_template
from midgpt_tpu.kernels.decode_attention import paged_verify_attention_gather as j_verify_gather
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.models.gpt import PagedKVCache as JCache
from midgpt_tpu.ops.quant import quantize_q8 as j_quant
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.convert import params_to_numpy
from midgpt_tpu_torch.kernels import attention_template as tpl
from midgpt_tpu_torch.kernels.decode_attention import (
    paged_verify_attention,
    paged_verify_attention_gather,
    paged_verify_attention_kernel,
)
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache
from midgpt_tpu_torch.sampling.spec import self_draft, speculative_accept

CPU = torch.device("cpu")
B, H, C = 4, 2, 64
PS, NP = 8, 24
TABLE = np.array(
    [
        [3, 17, 9, 0, 0, 0, 0, 0],
        [5, 2, 21, 11, 7, 14, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0],  # inactive: everything on the sink
        [4, 8, 12, 16, 20, 1, 6, 10],
    ],
    np.int32,
)
LENGTHS = np.array([18, 40, 0, 58], np.int32)
ACTIVE = np.array([1, 1, 0, 1], np.int32)
MODES = {  # query dtype, pool kind
    "f32": ("float32", "float32"),
    "bf16": ("bfloat16", "bfloat16"),
    "int8-f32q": ("float32", "int8"),
    "int8-bf16q": ("bfloat16", "int8"),
}


def _bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _counts(R):
    """(B, R) verify counts, as GPT.verify_step_paged makes them."""
    t = np.arange(R)
    return np.maximum(ACTIVE[:, None] * (LENGTHS[:, None] + t[None, :] + 1), 1).astype(np.int32)


def _problem(R, mode, seed=0, layout="bhrc"):
    """numpy inputs: q (layout), pools (int8 codes or floats) and their
    (P, H, ps) scales or None, for both frameworks."""
    qdt, pool = MODES[mode]
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, R, C) if layout == "bhrc" else (B, R, H, C)).astype(np.float32)
    if qdt == "bfloat16":
        q = _bf16_exact(q)
    pools, scales = [], []
    for _ in range(2):
        f = r.standard_normal((H, NP, PS, C)).astype(np.float32)
        if pool == "int8":
            codes, s = j_quant(jnp.asarray(f.transpose(1, 0, 2, 3)))
            pools.append(np.asarray(codes).transpose(1, 0, 2, 3).copy())
            scales.append(np.array(s))
        else:
            pools.append(_bf16_exact(f) if pool == "bfloat16" else f)
            scales.append(None)
    return q, pools, scales


def _jax_args(q, pools, scales, mode):
    qdt, pool = MODES[mode]
    jq = jnp.asarray(q, getattr(jnp, qdt))
    jp = [jnp.asarray(p) if pool == "int8" else jnp.asarray(p, getattr(jnp, pool)) for p in pools]
    js = [None if s is None else jnp.asarray(s) for s in scales]
    return jq, jp, js


def _torch_args(q, pools, scales, mode):
    qdt, pool = MODES[mode]
    tq = torch.from_numpy(q).to(getattr(torch, qdt))
    tp_ = [torch.from_numpy(p) if pool == "int8" else torch.from_numpy(p).to(getattr(torch, pool)) for p in pools]
    ts = [None if s is None else torch.from_numpy(s) for s in scales]
    return tq, tp_, ts


def _close(got, want, qdtype):
    tol = 1e-2 if qdtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("R", [1, 3, 5])
def test_plain_template_matches_jax_interpret_template(R, mode, split_k):
    """The verify (R > 1) and int8 specs of the plain version against the
    Pallas template itself, in interpret mode."""
    q, pools, scales = _problem(R, mode, seed=R)
    jq, (jk, jv), (jks, jvs) = _jax_args(q, pools, scales, mode)
    tq, (tk, tv), (tks, tvs) = _torch_args(q, pools, scales, mode)
    counts = _counts(R)
    want = j_template(jq, jk, jv, jnp.asarray(TABLE), jnp.asarray(counts), jks, jvs, split_k=split_k)
    got = tpl.paged_attention_template(tq, tk, tv, torch.from_numpy(TABLE), torch.from_numpy(counts),
                                       tks, tvs, split_k=split_k)
    assert got.dtype == tq.dtype and got.shape == (B, H, R, C)
    _close(got, want, MODES[mode][0])


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8-f32q", "int8-bf16q"])
def test_verify_gather_matches_jax_verify_gather(mode, split_k):
    q, pools, scales = _problem(4, mode, seed=20 + split_k, layout="brhc")
    jq, (jk, jv), (jks, jvs) = _jax_args(q, pools, scales, mode)
    tq, (tk, tv), (tks, tvs) = _torch_args(q, pools, scales, mode)
    counts = _counts(4)
    want = j_verify_gather(jq, jk, jv, jnp.asarray(TABLE), jnp.asarray(counts), jks, jvs, split_k=split_k)
    got = paged_verify_attention_gather(tq, tk, tv, torch.from_numpy(TABLE), torch.from_numpy(counts),
                                        tks, tvs, split_k=split_k)
    assert got.shape == (B, 4, H, C) and str(got.dtype)[6:] == str(np.asarray(want).dtype)
    _close(got, want, MODES[mode][0])


def test_verify_kernel_lowering_matches_gather_on_cpu():
    """On the CPU the kernel lowering is the plain template; it agrees with
    the gather lowering (f32) and dispatch rejects an unknown impl."""
    q, pools, scales = _problem(3, "f32", seed=30, layout="brhc")
    tq, (tk, tv), _ = _torch_args(q, pools, scales, "f32")
    table, counts = torch.from_numpy(TABLE), torch.from_numpy(_counts(3))
    before = tpl.LAUNCHES.count
    a = paged_verify_attention_kernel(tq, tk, tv, table, counts, split_k=2)
    b = paged_verify_attention(tq, tk, tv, table, counts)  # auto: the gather on the CPU
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    assert tpl.LAUNCHES.count == before
    with pytest.raises(ValueError, match="unknown paged"):
        paged_verify_attention(tq, tk, tv, table, counts, impl="nope")


# ---------------------------------------------------------------- model

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
_j_verify = jax.jit(JGPT.verify_step_paged, static_argnums=(0, 7, 8, 9))
_j_prefill = jax.jit(JGPT.prefill_paged_chunk, static_argnums=(0,))


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _filled_caches(jcfg, jp, dtype):
    """A JAX pool prefilled for two slots, and the same pool carried into
    the port as numpy arrays (codes and scales in int8 mode)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[dtype]
    jc = JCache.init(jcfg, num_pages=12, page_size=8, dtype=jdt)
    table = np.array([[3, 7, 1, 0], [5, 2, 0, 0], [9, 0, 0, 0]], np.int32)
    for slot, n in ((0, 13), (1, 7)):
        prompt = np.random.default_rng(slot).integers(0, 96, 16).astype(np.int32)
        _, jc = _j_prefill(jcfg, jp, jnp.asarray(prompt[None]), jnp.asarray(0, jnp.int32),
                           jnp.asarray(n, jnp.int32), jc, jnp.asarray(table[slot : slot + 1]))
    fields = {n: torch.from_numpy(np.array(getattr(jc, n))) for n in ("k", "v")}
    if dtype == "int8":
        fields.update({n: torch.from_numpy(np.array(getattr(jc, n))) for n in ("k_scale", "v_scale")})
    tc = PagedKVCache(**fields)
    assert tc.k.dtype == tdt
    return jc, tc, table, np.array([13, 7, 0], np.int32)


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_verify_step_paged_matches_jax(dtype, split_k):
    """K1 = 4 rows per slot, slot 2 inactive, from one filled pool: the
    logits of the active slots, and the pools (and scales) afterwards."""
    jcfg, tcfg = JConfig(**SHAPE, rope_style="split"), GPTConfig(**SHAPE, rope_style="split")
    jp = JGPT.init(jcfg, jax.random.PRNGKey(1))
    tp_ = params_from_numpy(_flatten(jp), device=CPU)
    jc, tc, table, lengths = _filled_caches(jcfg, jp, dtype)
    tokens = np.random.default_rng(2).integers(0, 96, (3, 4)).astype(np.int32)
    active = np.array([True, True, False])
    jl, jc = _j_verify(jcfg, jp, jnp.asarray(tokens), jc, jnp.asarray(table), jnp.asarray(lengths),
                       jnp.asarray(active), "gather", None, split_k)
    tl, tc = GPT.verify_step_paged(tcfg, tp_, torch.from_numpy(tokens), tc, torch.from_numpy(table),
                                   torch.from_numpy(lengths), torch.from_numpy(active), attn_impl="gather",
                                   split_k=split_k)
    assert tl.shape == (3, 4, 96)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=2e-5, rtol=0)
    if dtype == "int8":
        for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for t, j in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=0, rtol=1e-5)
    else:
        for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_verify_step_matches_sequential_decode(attn_impl):
    """The verify forward IS the target's scoring of the speculative chain:
    the same logits and pool writes as K1 sequential decode steps."""
    jcfg, tcfg = JConfig(**SHAPE), GPTConfig(**SHAPE)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(4))
    tp_ = params_from_numpy(_flatten(jp), device=CPU)
    _, tc, table, lengths = _filled_caches(jcfg, jp, "float32")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 96, (3, 4)).astype(np.int32))
    active = torch.tensor([True, True, False])
    seq = PagedKVCache(k=tc.k.clone(), v=tc.v.clone())
    ref, lens = [], torch.from_numpy(lengths)
    for t in range(4):
        lg, seq = GPT.decode_step_paged(tcfg, tp_, tokens[:, t], seq, torch.from_numpy(table), lens, active,
                                        attn_impl=attn_impl)
        ref.append(lg)
        lens = lens + active.int()
    vl, tc = GPT.verify_step_paged(tcfg, tp_, tokens, tc, torch.from_numpy(table), torch.from_numpy(lengths),
                                   active, attn_impl=attn_impl)
    np.testing.assert_allclose(vl[:2].numpy(), torch.stack(ref, 1)[:2].numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tc.k.numpy(), seq.k.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tc.v.numpy(), seq.v.numpy(), atol=2e-5, rtol=2e-5)


def test_self_draft_shares_embeddings():
    cfg = GPTConfig(**{**SHAPE, "n_layer": 4})
    params = GPT.init(cfg, 0, device=CPU)
    dcfg, dparams = self_draft(cfg, params, 2)
    assert dcfg.n_layer == 2 and dcfg.block_size == cfg.block_size and dcfg.n_embd == cfg.n_embd
    assert dparams["wte"] is params["wte"] and dparams["lm_head"] is params["lm_head"]
    for name, leaf in dparams.items():
        if name.startswith("blocks."):
            assert leaf.shape[0] == 2 and torch.equal(leaf, params[name][:2])
            assert leaf.data_ptr() == params[name].data_ptr()  # a view: nothing copied
    for bad in (0, cfg.n_layer):
        with pytest.raises(ValueError, match="n_draft_layers"):
            self_draft(cfg, params, bad)


# ---------------------------------------------------------------- sampler


def test_spec_statistical_rejection_sampler():
    """With a deliberately WRONG draft distribution, the token the sampler
    emits at a position is still distributed as the warped TARGET softmax:
    10k vectorized draws, total-variation tolerance."""
    V, K, N = 16, 2, 10_000
    rng = np.random.default_rng(7)
    t_log = rng.normal(0.0, 1.5, (1, K + 1, V)).astype(np.float32)
    q_log = rng.normal(0.0, 1.5, (1, K, V)).astype(np.float32)  # the wrong draft
    p = torch.softmax(torch.from_numpy(t_log[0]), -1).numpy()
    q = torch.softmax(torch.from_numpy(q_log[0]), -1).numpy()
    tv_pq = 0.5 * np.abs(p[0] - q[0]).sum()
    assert tv_pq > 0.25, f"test has no power: draft too close (TV={tv_pq})"
    q64 = q.astype(np.float64)
    drafts = np.stack([rng.choice(V, size=N, p=q64[i] / q64[i].sum()) for i in range(K)], axis=1)
    gen = torch.Generator().manual_seed(0)
    n_accept, out = speculative_accept(
        torch.from_numpy(np.broadcast_to(t_log, (N, K + 1, V)).copy()),
        torch.from_numpy(np.broadcast_to(q[None], (N, K, V)).copy()),
        torch.from_numpy(drafts), gen, temperature=1.0,
    )
    assert n_accept.dtype == torch.int32 and out.shape == (N, K + 1)
    first = out[:, 0].numpy()  # accepted d_1 or its correction: must be ~ p_1
    emp = np.bincount(first, minlength=V) / N
    tv = 0.5 * np.abs(emp - p[0]).sum()
    assert tv < 0.03, f"emitted dist deviates from target: TV={tv}"
    tv_q = 0.5 * np.abs(emp - q[0]).sum()
    assert tv_q > 0.15, f"emitted dist tracks the DRAFT: TV={tv_q}"
    # greedy degenerates to argmax equality: the emitted token is the
    # target's argmax, whether the draft was accepted or corrected
    n0, out0 = speculative_accept(
        torch.from_numpy(np.broadcast_to(t_log, (4, K + 1, V)).copy()), None,
        torch.from_numpy(drafts[:4]), None, temperature=0.0,
    )
    tgt = t_log[0].argmax(-1)
    assert (out0[:, 0].numpy() == tgt[0]).all()
    for b in range(4):
        n = int(n0[b])
        np.testing.assert_array_equal(out0[b, :n].numpy(), drafts[b, :n])
        assert n == K or drafts[b, n] != tgt[n]


# ---------------------------------------------------------------- sample.main


def _run_dir(tmp_path, **cfg_kw):
    """A tiny run directory in the converter's layout (config.json +
    params.npz) with no codec: prompts come from --start_ids."""
    from midgpt_tpu_torch.config import load_config, to_json

    base = load_config("shakespeare_char")
    mc = GPTConfig(**SHAPE)
    cfg = base.replace(data_dir=str(tmp_path / "no_data"), compute_dtype="float32", model_config=mc, **cfg_kw)
    d = tmp_path / "run"
    d.mkdir()
    (d / "config.json").write_text(to_json(cfg))
    np.savez(d / "params.npz", **params_to_numpy(GPT.init(mc, 0, device=CPU)))
    return str(d)


@pytest.mark.parametrize(
    "flags,config_kw,want",
    [
        (["--kv_dtype", "int8"], dict(spec_layers=1), ["self-draft: first 1/2 layers", "kv cache int8", "speculative:"]),
        (["--spec_layers", "1"], dict(), ["self-draft: first 1/2 layers", "kv cache bf16", "speculative:"]),
        (["--spec_layers", "0"], dict(spec_layers=1, kv_cache_dtype="int8"), ["kv cache int8"]),
    ],
    ids=["config-spec-int8", "flag-spec", "spec-off"],
)
def test_sample_main_speculates_as_configured(tmp_path, capsys, flags, config_kw, want):
    from midgpt_tpu_torch import sample

    run = _run_dir(tmp_path, **config_kw)
    sample.main(["--ckpt_dir", run, "--device", "cpu", "--start_ids", "1,2,3", "--num_samples", "2",
                 "--max_new_tokens", "9", "--temperature", "0", *flags])
    out = capsys.readouterr().out
    for w in want:
        assert w in out, out
    if "speculative:" not in want:
        assert "speculative:" not in out and "self-draft" not in out
    assert "2 requests on cpu" in out
    samples = [line for line in out.splitlines() if line.startswith("1 2 3 ")]
    assert len(samples) == 2 and all(len(s.split()) == 3 + 9 for s in samples)


def test_sample_main_refuses_two_drafts(tmp_path):
    from midgpt_tpu_torch import sample

    run = _run_dir(tmp_path)
    with pytest.raises(SystemExit):
        sample.main(["--ckpt_dir", run, "--device", "cpu", "--start_ids", "1", "--spec_layers", "1",
                     "--draft_ckpt", run])


def test_sample_main_with_a_separate_draft(tmp_path, capsys):
    from midgpt_tpu_torch import sample

    run = _run_dir(tmp_path)
    with open(f"{run}/config.json") as f:
        assert json.load(f)["spec_layers"] == 0
    sample.main(["--ckpt_dir", run, "--device", "cpu", "--start_ids", "4,5", "--num_samples", "1",
                 "--max_new_tokens", "6", "--temperature", "0", "--draft_ckpt", run])
    out = capsys.readouterr().out
    assert f"draft model: {run}" in out and "speculative:" in out
    # the draft is the target itself here: every proposal is accepted
    assert "accept_rate 1.00" in out
