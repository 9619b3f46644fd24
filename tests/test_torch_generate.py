"""Port parity, the batch sampler: the port's contiguous KV cache, prefill,
decode step and `generate` against the JAX package's on the same converted
weights (midgpt_tpu_torch/convert.py from `GPT.init`), in float32 at
tests/test_sampling.py's size (2 layers, n_embd 32, 2 heads, S 32, vocab
96). Tolerances as JAX's own tests: prefill logits and cache 2e-5, decode
logits 3e-5 (atol and rtol; summation order only). Greedy tokens are held
exactly: to JAX's `generate` in every variant (GQA, a window with sinks,
the flash body at a ragged prompt, where JAX runs its Pallas body in
interpret mode as tests/test_flash.py does), and to the port's own paged
engine. The chunk lengths are held to those JAX's own loop dispatches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.models.gpt import KVCache as JKVCache
from midgpt_tpu.sampling import engine as jengine
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, KVCache
from midgpt_tpu_torch.sampling import engine
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

SHAPE = dict(block_size=32, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
CPU = torch.device("cpu")
VARIANTS = {
    "mha": {},
    "gqa": dict(n_kv_heads=1),
    "window": dict(sliding_window=8, attn_sinks=2, attn_impl="blockwise"),
    "flash": dict(attn_impl="flash"),
}
# greedy generate cases: (variant, prompt length, new tokens)
CASES = {
    "short": ("mha", 8, 12),
    "exact_fill": ("mha", 8, 24),  # 8 + 24 = S: the cache fills, no overflow
    "overflow": ("mha", 30, 10),
    "cropped": ("mha", 40, 5),  # a prompt longer than S
    "gqa": ("gqa", 8, 12),
    "window": ("window", 20, 14),  # the window and its sinks, then overflow
    "flash_ragged": ("flash", 13, 10),
}
FAST_CASES = ("short", "overflow")


def _prompt(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture
def flash_interpret(monkeypatch):
    """JAX's flash dispatch reaches its Pallas body (interpret mode), not
    the off-TPU blockwise fallback."""
    import importlib

    monkeypatch.setattr(importlib.import_module("midgpt_tpu.kernels.flash_attention"), "RUN_INTERPRET_OFF_TPU", True)


@pytest.fixture(scope="module")
def models():
    """{variant: (JAX config, JAX params, port config, port params)}, made once."""
    out = {}
    for name, kw in VARIANTS.items():
        jcfg = JConfig(**SHAPE, **kw)
        jp = JGPT.init(jcfg, jax.random.PRNGKey(0))
        flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        cfg = GPTConfig(**SHAPE, **kw)
        out[name] = (jcfg, jp, cfg, params_from_numpy(flat, config=cfg, device=CPU))
    return out


# ---------------------------------------------------------------- (a), (b): prefill and decode_step


@pytest.mark.parametrize("variant", ["mha", pytest.param("gqa", marks=pytest.mark.slow),
                                     pytest.param("window", marks=pytest.mark.slow)])
def test_prefill_and_decode_steps_match_jax(models, variant):
    """(a) prefill logits and the cache's k/v, length equal; (b) the logits
    of 5 decode steps, each compared in turn."""
    jcfg, jp, cfg, pp = models[variant]
    tokens = _prompt(2, 10, seed=1)
    jlog, jc = JGPT.prefill(jcfg, jp, jnp.asarray(tokens), JKVCache.init(jcfg, 2, dtype=jnp.float32))
    cache = KVCache.init(cfg, 2, torch.float32, device=CPU)
    log, got = GPT.prefill(cfg, pp, torch.from_numpy(tokens), cache)
    assert got is cache and cache.length.dtype == torch.int64 and cache.length.dim() == 0
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc.k), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jc.v), atol=2e-5, rtol=2e-5)
    assert int(cache.length) == int(jc.length) == 10
    extra = _prompt(2, 5, seed=2)
    for i in range(5):
        jlog, jc = JGPT.decode_step(jcfg, jp, jnp.asarray(extra[:, i]), jc)
        log, cache = GPT.decode_step(cfg, pp, torch.from_numpy(extra[:, i]), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=3e-5, rtol=3e-5, err_msg=f"decode step {i}")
    assert int(cache.length) == int(jc.length) == 15
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc.k), atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------- (c): greedy generate == JAX's


@pytest.mark.parametrize(
    "case", [c if c in FAST_CASES else pytest.param(c, marks=pytest.mark.slow) for c in CASES]
)
def test_greedy_generate_matches_jax(models, flash_interpret, case):
    variant, T0, n_new = CASES[case]
    jcfg, jp, cfg, pp = models[variant]
    prompt = _prompt(2, T0, seed=3)
    want = np.asarray(jengine.generate(jcfg, jp, jnp.asarray(prompt), n_new, temperature=0.0))
    got = engine.generate(cfg, pp, prompt, n_new, temperature=0.0, device=CPU)
    assert got.dtype == torch.int64 and got.shape == (2, T0 + n_new) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- (d): JAX's chunk rule


def _jax_chunks(T0, n_new, S, monkeypatch):
    """The chunk lengths JAX's own `generate` loop dispatches, its programs
    replaced by stubs that only record (no model runs, nothing compiles)."""
    chunks = []
    B = 1
    monkeypatch.setattr(jengine, "_prefill_and_first", lambda *a: (jnp.zeros((B,), jnp.int32), None))

    def chunk(config, params, token, cache, temperature, top_k, top_p, n, key):
        chunks.append(n)
        return token, cache, jnp.zeros((n, B), jnp.int32)

    monkeypatch.setattr(jengine, "_decode_chunk", chunk)
    monkeypatch.setattr(jengine, "_window_forward", lambda config, params, window: jnp.zeros((B, 8)))
    cfg = JConfig(block_size=S, vocab_size=8, n_layer=1, n_head=1, n_embd=8)
    jengine.generate(cfg, None, jnp.zeros((B, T0), jnp.int32), n_new, temperature=0.0)
    return chunks


@pytest.mark.parametrize("T0,n_new,S", [(8, 12, 32), (30, 10, 32), (5, 150, 128)])
def test_chunk_lengths_follow_jax_rule(monkeypatch, T0, n_new, S):
    cfg = GPTConfig(**{**SHAPE, "block_size": S})
    stats = {}
    engine.generate(cfg, GPT.init(cfg, 0, device=CPU), _prompt(1, T0), n_new, temperature=0.0, device=CPU,
                    stats=stats)
    want = _jax_chunks(T0, n_new, S, monkeypatch)
    assert stats["chunks"] == want and want
    assert stats["overflow_tokens"] == n_new - 1 - sum(want)
    assert stats["captures"] == stats["replays"] == 0  # the CPU runs the step eagerly


# ---------------------------------------------------------------- (e): == the port's paged engine


def test_greedy_generate_matches_the_paged_engine(models):
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    _, _, cfg, pp = models["mha"]
    prompt = _prompt(1, 19, seed=13)
    want = engine.generate(cfg, pp, prompt, 10, temperature=0.0, device=CPU)
    eng = ServeEngine(cfg, pp, max_slots=2, page_size=8, prefill_chunk=8, decode_chunk=4, temperature=0.0,
                      cache_dtype=torch.float32, device=CPU)
    uid = eng.submit(prompt[0], 10)
    np.testing.assert_array_equal(eng.run()[uid].tokens, want[0].numpy())


# ---------------------------------------------------------------- (f): sampling


def test_top_k_one_is_greedy_and_a_seeded_run_repeats(models):
    _, _, cfg, pp = models["mha"]
    prompt = _prompt(3, 6, seed=4)
    greedy = engine.generate(cfg, pp, prompt, 30, temperature=0.0, device=CPU)
    top1 = engine.generate(cfg, pp, prompt, 30, temperature=0.8, top_k=1, device=CPU,
                           generator=torch.Generator().manual_seed(7))
    assert torch.equal(top1, greedy)
    runs = [engine.generate(cfg, pp, prompt, 30, temperature=1.0, top_p=0.9, device=CPU,
                            generator=torch.Generator().manual_seed(11)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], greedy)
    assert ((0 <= runs[0]) & (runs[0] < SHAPE["vocab_size"])).all()


def test_generate_refuses_params_elsewhere(models):
    _, _, cfg, pp = models["mha"]
    with pytest.raises(ValueError, match="params lie on cpu"):
        engine.generate(cfg, pp, _prompt(1, 4), 2, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.generate(cfg, pp, _prompt(1, 4), 2)  # no device given: CUDA or nothing
