"""Port parity, speculative serving: the port's ServeEngine with a draft
against the JAX ServeEngine with the same draft on the same converted
weights — greedy, a mixed-length trace on a pool small enough to force
recompute preemption, adaptive k. Token streams must be IDENTICAL to JAX's
and to the port's own plain decode, for a layer-prefix self-draft on the
target's pool (f32 and int8 pools, through the gather and through the
template's plain version) and for a separately initialized draft model with
its own pool, with the acceptance counters equal too; every page returns to the pool after run(), and a live
slot always holds exactly ceil(length / page_size) pages (page-aligned
rollback)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu.sampling.spec import self_draft as j_self_draft
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.sampling.serve import ServeEngine
from midgpt_tpu_torch.sampling.spec import self_draft

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(max_slots=3, page_size=8, num_pages=10, prefill_chunk=16, decode_chunk=8, temperature=0.0)
CPU = torch.device("cpu")
# (cache dtype, draft, k schedule): "self" = the first layer of the target
# on its pool, "separate" = an independently initialized one-layer model
# with its own pool; k adapts over {1, 2, 4} in one case and stays at 4 in
# the others (each k is one more set of JAX programs to compile)
ADAPTIVE, FIXED = dict(spec_k_max=4), dict(spec_k_min=4, spec_k_max=4, spec_adapt=False)
CASES = {
    "f32-self": ("float32", "self", ADAPTIVE),
    "int8-self": ("int8", "self", FIXED),
    "f32-separate": ("float32", "separate", FIXED),
}


def _trace():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, SHAPE["vocab_size"], n).astype(np.int32), m) for n, m in zip((5, 23, 11), (30, 24, 40))]


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def reference():
    """The weights, and per case the JAX engine's streams, preemptions and
    acceptance counters."""
    jcfg = JConfig(**SHAPE)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(0))
    jdcfg = dataclasses.replace(jcfg, n_layer=1)
    jdp = JGPT.init(jdcfg, jax.random.PRNGKey(99))
    out = {"target": _flatten(jp), "separate": _flatten(jdp)}
    for name, (dtype, draft, k_kw) in CASES.items():
        if draft == "self":
            dcfg, dparams = j_self_draft(jcfg, jp, 1)
        else:
            dcfg, dparams = jdcfg, jdp
        eng = JServeEngine(
            jcfg, jp, cache_dtype="int8" if dtype == "int8" else jnp.float32, draft_params=dparams,
            draft_config=dcfg, draft_shares_cache=draft == "self", **ENGINE, **k_kw,
        )
        uids = [eng.submit(p, m) for p, m in _trace()]
        done = eng.run()
        out[name] = ([done[u].tokens for u in uids], eng.preemptions, eng._spec_drafted, eng._spec_accepted)
    return out


def _port_engine(ref, dtype, draft=None, **kw):
    cfg = GPTConfig(**SHAPE)
    params = params_from_numpy(ref["target"], device=CPU)
    spec = {}
    if draft == "self":
        dcfg, dparams = self_draft(cfg, params, 1)
        spec = dict(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True)
    elif draft == "separate":
        spec = dict(draft_params=params_from_numpy(ref["separate"], device=CPU),
                    draft_config=dataclasses.replace(cfg, n_layer=1))
    return ServeEngine(cfg, params, cache_dtype=getattr(torch, dtype), device=CPU, **{**ENGINE, **spec, **kw})


def _run(eng, check_pages=False):
    uids = [eng.submit(p, m) for p, m in _trace()]
    while not eng.idle:
        eng.step()
        if check_pages:  # page-aligned rollback, and page conservation
            held = 0
            for slot in eng.slots:
                if slot is not None:
                    assert len(slot.pages) == -(-slot.length // eng.page_size), (slot.length, slot.pages)
                    held += len(slot.pages)
            assert eng.allocator.free_count + held == eng.allocator.num_pages - 1
    assert eng.allocator.free_count == eng.allocator.num_pages - 1
    return [eng.finished[u].tokens for u in uids]


@pytest.mark.parametrize(
    "case,kw",
    [("f32-self", {}), ("f32-self", dict(attn_impl="kernel")), ("int8-self", {}),
     ("int8-self", dict(attn_impl="kernel", split_k=2)), ("f32-separate", {})],
    ids=["f32-self", "f32-self-template", "int8-self", "int8-self-template-split2", "f32-separate"],
)
def test_port_spec_engine_matches_jax_spec_engine(reference, case, kw):
    want, want_preempt, want_drafted, want_accepted = reference[case]
    dtype, draft, k_kw = CASES[case]
    assert want_preempt >= 1, "the trace must force a preemption"
    eng = _port_engine(reference, dtype, draft, **k_kw, **kw)
    got = _run(eng, check_pages=True)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.preemptions == want_preempt
    assert (eng._spec_drafted, eng._spec_accepted) == (want_drafted, want_accepted)
    st = eng.stats()
    assert st["spec"]["rounds"] > 0 and st["spec"]["tokens_per_verify"] >= 1.0 and st["decode_tokens"] > 0
    assert 0.0 <= st["spec"]["accept_rate"] <= 1.0 and st["spec"]["draft_steps"] >= st["spec"]["rounds"]
    if draft == "separate":
        assert eng.draft_cache is not None and st["spec"]["accept_rate"] < 0.9  # a wrong draft: low acceptance
    else:
        assert eng.draft_cache is None


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spec_streams_equal_plain_decode(reference, dtype):
    """Greedy speculation changes throughput, never tokens: the port's
    speculative streams equal its plain decode on the same pool dtype."""
    plain = _run(_port_engine(reference, dtype))
    spec = _run(_port_engine(reference, dtype, "self"))
    for i, (a, b) in enumerate(zip(plain, spec)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


def test_spec_eos_finishes_mid_round(reference):
    """EOS inside an accepted speculative chain truncates the request at the
    EOS token, frees the slot, and discards the rest of the round."""
    p = _trace()[0][0]
    probe = _port_engine(reference, "float32", "self", max_slots=1, num_pages=17)
    u = probe.submit(p, 10)
    gen = probe.run()[u].tokens[len(p):]
    eos_idx = next(i for i in range(len(gen)) if gen[i] not in gen[:i] and i > 0)
    eng = _port_engine(reference, "float32", "self", max_slots=1, num_pages=17)
    u2 = eng.submit(p, 10, eos_id=int(gen[eos_idx]))
    out = eng.run()[u2].tokens
    assert out[-1] == gen[eos_idx] and len(out) == len(p) + eos_idx + 1
    assert eng.allocator.free_count == eng.allocator.num_pages - 1 and eng.idle


def test_stochastic_spec_serving_runs(reference):
    """temperature > 0 through the draft's warped sampling and the rejection
    sampler: in-vocab tokens, each request's full budget."""
    eng = _port_engine(reference, "int8", "self", temperature=0.8, top_k=20, seed=7)
    for toks, (p, m) in zip(_run(eng), _trace()):
        assert len(toks) == len(p) + m and (toks >= 0).all() and (toks < SHAPE["vocab_size"]).all()


def test_spec_engine_validation(reference):
    cfg = GPTConfig(**SHAPE)
    params = params_from_numpy(reference["target"], device=CPU)
    dcfg, dparams = self_draft(cfg, params, 1)
    with pytest.raises(ValueError, match="come together"):
        ServeEngine(cfg, params, device=CPU, draft_params=dparams)
    with pytest.raises(ValueError, match="power of two"):
        ServeEngine(cfg, params, device=CPU, draft_params=dparams, draft_config=dcfg, spec_k_max=3)
    with pytest.raises(ValueError, match="spec_k_min"):
        ServeEngine(cfg, params, device=CPU, draft_params=dparams, draft_config=dcfg, spec_k_max=2, spec_k_min=4)
    with pytest.raises(ValueError, match="block_size"):
        ServeEngine(cfg, params, device=CPU, draft_params=dparams,
                    draft_config=dataclasses.replace(dcfg, block_size=128))
    with pytest.raises(ValueError, match="layer-prefix"):
        ServeEngine(cfg, params, device=CPU, draft_params=dparams,
                    draft_config=dataclasses.replace(dcfg, n_head=1, n_embd=16), draft_shares_cache=True)
