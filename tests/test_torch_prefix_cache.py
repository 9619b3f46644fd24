"""Port parity, the prefix cache: the port's trie (sampling/prefix_cache.py)
against JAX's on one seeded sequence of operations, and the port's engine
with `prefix_cache=True` against JAX's on converted weights — greedy, f32
pools, a template-headed trace on a pool small enough to make the trie
reclaim pages. Token streams must be IDENTICAL (and equal to the cache-off
streams), `prefix_stats` equal, and pages conserved. Also: the byte-budget
pool gives JAX's page count, `evict_shared_prefix` mid-trace leaves every
live stream as the unfaulted run's, and a poisoned page the trie holds is
scrubbed when the trie lets it go. int8 and self-draft variants are slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.sampling.prefix_cache import PrefixCache as JPrefixCache
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu.sampling.spec import self_draft as j_self_draft
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.sampling.ops import assert_conserved
from midgpt_tpu_torch.sampling.prefix_cache import PrefixCache
from midgpt_tpu_torch.sampling.serve import ServeEngine
from midgpt_tpu_torch.sampling.spec import self_draft
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(max_slots=3, page_size=8, num_pages=16, prefill_chunk=16, decode_chunk=4, temperature=0.0)
CPU = torch.device("cpu")
JAX_DTYPES = {"f32": jnp.float32, "int8": "int8"}
PORT_DTYPES = {"f32": torch.float32, "int8": "int8"}


@pytest.fixture(scope="module")
def weights():
    """JAX's params and their numpy leaves, for converted port weights."""
    jp = JGPT.init(JConfig(**SHAPE), jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return jp, flat


def _template_trace(seed=0, n_templated=6, n_unique=3, t_len=24):
    """Two shared t_len-token heads with short unique tails, then a few
    unique prompts (JAX's tests/test_prefix_cache.py trace)."""
    rng = np.random.default_rng(seed)
    templates = [rng.integers(0, SHAPE["vocab_size"], t_len).astype(np.int32) for _ in range(2)]
    trace = []
    for i in range(n_templated):
        tail = rng.integers(0, SHAPE["vocab_size"], int(rng.integers(2, 7))).astype(np.int32)
        trace.append((np.concatenate([templates[i % 2], tail]), int(rng.integers(6, 12))))
    for _ in range(n_unique):
        trace.append((rng.integers(0, SHAPE["vocab_size"], int(rng.integers(4, 12))).astype(np.int32),
                      int(rng.integers(6, 12))))
    return trace


def _drive(eng, trace, first=4):
    """Submit `first` requests, step twice (the trie fills), submit the
    rest, run to the end; returns the streams in submission order."""
    uids = [eng.submit(p, m) for p, m in trace[:first]]
    eng.step()
    eng.step()
    uids += [eng.submit(p, m) for p, m in trace[first:]]
    done = eng.run()
    return [np.asarray(done[u].tokens) for u in uids]


def _port(flat, prefix=True, dtype="f32", draft=0, **kw):
    cfg, params = GPTConfig(**SHAPE), params_from_numpy(flat, device=CPU)
    if draft:
        dcfg, dparams = self_draft(cfg, params, draft)
        kw.update(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True, spec_k_max=4,
                  spec_k_min=4, spec_adapt=False)
    return ServeEngine(cfg, params, cache_dtype=PORT_DTYPES[dtype], device=CPU, prefix_cache=prefix,
                       **{**ENGINE, **kw})


def _jax(jp, dtype="f32", draft=0):
    cfg, kw = JConfig(**SHAPE), {}
    if draft:
        dcfg, dparams = j_self_draft(cfg, jp, draft)
        kw.update(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True, spec_k_max=4,
                  spec_k_min=4, spec_adapt=False)
    return JServeEngine(cfg, jp, cache_dtype=JAX_DTYPES[dtype], prefix_cache=True, **ENGINE, **kw)


def _drained(eng):
    assert eng.idle
    assert eng.allocator.free_count + eng.prefix_cache.page_count() == eng.allocator.num_pages - 1
    assert eng.prefix_cache.referenced_page_count() == 0
    assert_conserved(eng, "after the trace")


# ----------------------------------------------------------------------
# the trie
# ----------------------------------------------------------------------


def test_trie_matches_jax_trie_op_for_op():
    """A seeded sequence of 400 match / insert_live / release / evict /
    peek / remap_pages calls on both tries: every return value, page list,
    refcount and stat equal (exact)."""
    rng = np.random.default_rng(0)
    ps = 4
    heads = [rng.integers(0, 6, 16).tolist() for _ in range(3)]
    tries = (PrefixCache(ps), JPrefixCache(ps))
    live = []  # (tokens, pages, n_shared) per reader, the same on both sides
    next_page = [1]

    def fresh(n):
        got = list(range(next_page[0], next_page[0] + n))
        next_page[0] += n
        return got

    for step in range(400):
        op = rng.integers(0, 6)
        if op <= 1 or not live:  # admit a reader: match, then insert its prompt
            toks = heads[int(rng.integers(0, 3))][: int(rng.integers(4, 17))] + rng.integers(0, 6, 3).tolist()
            res = [t.match(toks, max_tokens=len(toks) - 1) for t in tries]
            assert (res[0].pages, res[0].tokens, res[0].cow_truncated) == (
                res[1].pages, res[1].tokens, res[1].cow_truncated), step
            pages = res[0].pages + fresh(-(-len(toks) // ps) - len(res[0].pages))
            shared = [t.insert_live(toks, pages, len(res[0].pages)) for t in tries]
            assert shared[0] == shared[1], step
            live.append((toks, pages, shared[0]))
        elif op == 2:  # a reader departs
            toks, pages, n_shared = live.pop(int(rng.integers(0, len(live))))
            freed = [t.release(toks, pages, n_shared) for t in tries]
            assert freed[0] == freed[1], step
        elif op == 3:
            n = int(rng.integers(0, 4))
            assert tries[0].evict(n) == tries[1].evict(n), step
        elif op == 4:
            toks = heads[int(rng.integers(0, 3))]
            assert tries[0].peek(toks) == tries[1].peek(toks), step
        else:  # a resize's remap: every held page to a new id
            held = sorted(tries[0].pages_held())
            assert held == sorted(tries[1].pages_held())
            mapping = {p: 1000 + step * 50 + i for i, p in enumerate(held)}
            assert tries[0].remap_pages(mapping) == tries[1].remap_pages(mapping)
            live = [(t, [mapping.get(p, p) for p in pg], n) for t, pg, n in live]
        assert tries[0].stats() == tries[1].stats(), step
        assert tries[0].referenced_pages() == tries[1].referenced_pages(), step
    assert tries[0].evict(0, force_all=True) == tries[1].evict(0, force_all=True)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_streams(weights):
    """JAX's streams and prefix stats on the template trace, f32."""
    eng = _jax(weights[0])
    streams = _drive(eng, _template_trace())
    return streams, eng.prefix_stats(), eng.preemptions


def test_prefix_engine_matches_jax_and_cache_off(weights, jax_streams):
    """Cache on: the same streams as JAX's engine (exact), the same
    prefix_stats and preemptions, and the same streams as the cache off;
    the trie absorbed prefill work and reclaimed pages under pressure; every
    page and refcount conserved at the end."""
    want, want_stats, want_preempt = jax_streams
    eng = _port(weights[1])
    got = _drive(eng, _template_trace())
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    st = eng.prefix_stats()
    assert st == want_stats
    assert eng.preemptions == want_preempt
    assert st["hit_rate"] > 0 and st["reclaimed_pages"] > 0
    off = _port(weights[1], prefix=False)
    for i, (g, w) in enumerate(zip(_drive(off, _template_trace()), got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}, cache off")
    assert eng.prefilled_tokens + st["matched_tokens"] >= off.prefilled_tokens > eng.prefilled_tokens
    _drained(eng)


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["int8", "self-draft"])
def test_prefix_engine_variants_match_jax(weights, variant):
    """int8 pools (a shared page shares its scales) and a 1-layer self-draft
    (drafts attend through the shared tables; a rollback never frees a
    shared page): streams and prefix_stats equal JAX's, exact."""
    kw = dict(dtype="int8") if variant == "int8" else dict(draft=1)
    trace = _template_trace(seed=2)
    jeng = _jax(weights[0], **kw)
    want = _drive(jeng, trace)
    eng = _port(weights[1], **kw)
    got = _drive(eng, trace)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.prefix_stats() == jeng.prefix_stats() and eng.prefix_stats()["hit_rate"] > 0
    _drained(eng)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "gqa"])
def test_pool_hbm_bytes_gives_jax_num_pages(dtype):
    """The byte budget divides by one page's K+V bytes (no int8 scales, no
    spare page): the port's num_pages equals JAX's for every dtype and for
    a GQA pool (3 budgets each)."""
    shape = dict(SHAPE, n_head=4, n_kv_heads=2 if dtype == "gqa" else None)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8", "gqa": jnp.bfloat16}[dtype]
    pdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": "int8", "gqa": torch.bfloat16}[dtype]
    for budget in (1 << 20, 3 * 10**6 + 7, 100):
        j = JServeEngine(JConfig(**shape), {}, pool_hbm_bytes=budget, cache_dtype=jdt)
        p = ServeEngine(GPTConfig(**shape), {}, pool_hbm_bytes=budget, cache_dtype=pdt, device=CPU)
        assert p.allocator.num_pages == j.allocator.num_pages >= 2
        assert p.cache.num_pages == p.allocator.num_pages  # the spare page comes on top


def test_evict_shared_prefix_mid_trace_keeps_live_streams(weights, jax_streams):
    """The evict_shared_prefix fault at rounds 3 and 6 flushes every
    unreferenced trie page: each stream equals the unfaulted run's (JAX's,
    exact), referenced entries survive, pages stay conserved."""
    faults.clear()
    eng = _port(weights[1])
    faults.activate("evict_shared_prefix", step=3)
    faults.activate("evict_shared_prefix", step=6)
    try:
        got = _drive(eng, _template_trace())
        fired = faults.fired_counts()
    finally:
        faults.clear()
    assert fired == {"evict_shared_prefix": 2}
    for i, (g, w) in enumerate(zip(got, jax_streams[0])):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.prefix_stats()["reclaimed_pages"] > jax_streams[1]["reclaimed_pages"]
    _drained(eng)


def test_poisoned_page_in_the_trie_is_scrubbed_before_reuse(weights):
    """poisoned_page corrupts a running slot's first page, which the slot
    then donates to the trie on finishing: the page stays poisoned while the
    trie holds it, is scrubbed when a flush frees it, and a request that
    lands on it afterwards streams as in an unfaulted engine."""
    trace = _template_trace(seed=4, n_templated=2, n_unique=0)
    eng = _port(weights[1], num_pages=12)
    faults.clear()
    faults.activate("poisoned_page", step=2)
    try:
        uid = eng.submit(*trace[0])
        eng.step()
        eng.step()
        page = eng.slots[0].pages[0]
        eng.run()
    finally:
        faults.clear()
    assert eng.poisoned_uids == [uid] and page in eng.prefix_cache.pages_held()
    assert page in eng._poisoned_pages and torch.isnan(eng.cache.k[:, :, page]).all()
    eng.flush_prefix_cache()
    assert not eng._poisoned_pages and eng.prefix_cache.page_count() == 0
    assert (eng.cache.k[:, :, page] == 0).all() and (eng.cache.v[:, :, page] == 0).all()
    # the scrubbed page is the next one handed out (the free list pops its end)
    eng.allocator._free.remove(page)
    eng.allocator._free.append(page)
    fresh = _port(weights[1], num_pages=12)
    prompt, m = trace[1]
    u_got, u_fresh = eng.submit(prompt, m), fresh.submit(prompt, m)
    eng.step()
    assert eng.slots[0].pages[0] == page
    np.testing.assert_array_equal(eng.run()[u_got].tokens, fresh.run()[u_fresh].tokens)
    _drained(eng)
