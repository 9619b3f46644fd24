"""Port parity, disaggregated prefill/decode (sampling/disagg.py) against
JAX's midgpt_tpu/sampling/disagg.py, on converted weights (2 layers,
n_embd 32, greedy).

* DisaggServe, f32 and int8 pools: the streams, the handoff queue's stats,
  the fallback count and the decode role's prefix hits equal JAX's (exact),
  and the streams equal a monolithic engine's; handoffs are forced to the
  re-prefill fallback (the decode pool held full until one falls back).
  The int8 pair runs under `-m slow` (its JAX engines compile another
  program set).
* `rebalance` moves the same pages as JAX's, and ModelOps' re-role
  decisions on one scripted signal sequence equal JAX's.
* `adopt_pages` writes in place (no pool tensor rebound), refuses the sink
  and the spare page, and leaves the spare page untouched; `mesh=` is
  refused naming its ROADMAP item.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.sampling import disagg as j_disagg
from midgpt_tpu.sampling import ops as j_ops
from midgpt_tpu.sampling import serve as j_serve
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig, PagedKVCache
from midgpt_tpu_torch.sampling import disagg, ops, serve

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(page_size=8, num_pages=31, decode_chunk=4, prefill_chunk=16, max_slots=3)
ROLES = dict(prefill_kw=dict(prefill_chunk=32, max_slots=2), decode_kw=dict(max_slots=4))
CPU = torch.device("cpu")
DTYPES = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one thread, and the suite's workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(jp):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}


def _trace(n=6, seed=1):
    """Template traffic: two 16-token heads, short tails."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, 96, 16).astype(np.int32) for _ in range(2)]
    return [(np.concatenate([heads[i % 2], rng.integers(0, 96, int(rng.integers(2, 6))).astype(np.int32)]),
             int(rng.integers(6, 16))) for i in range(n)]


def _drive(d):
    """The trace through `d`, the decode pool held full until the first
    handoff falls back to re-prefill; returns what the tests compare."""
    eng = d.decode
    held = eng.allocator.alloc(eng.allocator.free_count)
    uids = [d.submit(p, m) for p, m in _trace()]
    for _ in range(200):
        if d.fallback_reprefills:
            break
        d.step()
    eng.allocator.free(held)
    d.run()
    st = d.stats()
    return ([d.finished[u].tokens.tolist() for u in uids], [d.finished[u].status for u in uids], st["queue"],
            d.fallback_reprefills, eng._prefix_matched_tokens, eng._prefix_matchable_tokens)


def _re_roles(d, mod):
    """ModelOps over `d` on a scripted signal sequence; returns the
    decisions and both roles' pool sizes."""
    m = mod.ModelOps(d, clock=lambda: 0.0)
    item = lambda: types.SimpleNamespace(uid=0, n_pages=0, blocks={})
    m.tick()  # in band
    for _ in range(5):
        d.queue.push(item())
    m.tick()  # deep handoff backlog: prefill -> decode
    m.apply = False
    m.tick()  # the same signal, advisory: recorded, not applied
    m.apply = True
    d.queue._q.clear()
    m.low_free_frac = 1.1  # every prefill page counts as starved
    m.tick()  # decode -> prefill
    m.low_free_frac = 0.15
    m.tick()
    return ([(x.kind, x.reason, x.args, x.applied, x.error) for x in m.decisions],
            d.prefill.allocator.num_pages, d.decode.allocator.num_pages, d.re_roles)


@pytest.fixture(scope="module")
def weights():
    jp = JGPT.init(JConfig(**SHAPE), jax.random.PRNGKey(0))
    return jp, params_from_numpy(_flat(jp), device=CPU)


def _jax_disagg(jp, dtype):
    return j_disagg.DisaggServe(JConfig(**SHAPE), jp, cache_dtype=DTYPES[dtype][1], **ENGINE, **ROLES)


def _port_disagg(pp, dtype):
    return disagg.DisaggServe(GPTConfig(**SHAPE), pp, cache_dtype=DTYPES[dtype][0], device=CPU, **ENGINE, **ROLES)


@pytest.fixture(scope="module")
def jax_runs(weights):
    """One JAX reference pass for the module (its engines compile)."""
    jp, _ = weights
    out = {"f32": _drive(_jax_disagg(jp, "f32"))}
    d = _jax_disagg(jp, "f32")
    out["rebalance"] = d.rebalance(4)
    out["re_role"] = _re_roles(_jax_disagg(jp, "f32"), j_ops)
    return out


@pytest.mark.parametrize("dtype", [pytest.param("f32"), pytest.param("int8", marks=pytest.mark.slow)])
def test_disagg_equals_jax_and_a_monolithic_engine(weights, jax_runs, dtype):
    jp, pp = weights
    got = _drive(_port_disagg(pp, dtype))
    assert got == (jax_runs[dtype] if dtype in jax_runs else _drive(_jax_disagg(jp, dtype)))
    streams, statuses, queue, fallbacks, matched, _ = got
    assert fallbacks >= 1 and set(statuses) == {"ok"} and queue["pages_copied"] >= 2 and matched > 0
    mono = serve.ServeEngine(GPTConfig(**SHAPE), pp, cache_dtype=DTYPES[dtype][0], device=CPU, prefix_cache=True,
                             temperature=0.0, **ENGINE)
    uids = [mono.submit(p, m) for p, m in _trace()]
    mono.run()
    assert streams == [mono.finished[u].tokens.tolist() for u in uids]


def test_rebalance_and_re_role_equal_jax(weights, jax_runs):
    _, pp = weights
    got = _port_disagg(pp, "f32").rebalance(4)
    want = jax_runs["rebalance"]
    for side in ("src_resize", "dst_resize"):
        for key in ("from_pages", "to_pages", "pages_migrated", "trie_pages_evicted", "max_slots"):
            assert got[side][key] == want[side][key]
    assert {k: got[k] for k in ("src", "dst", "pages")} == {k: want[k] for k in ("src", "dst", "pages")}
    decisions = _re_roles(_port_disagg(pp, "f32"), ops)
    assert decisions == jax_runs["re_role"]
    assert [d[:2] for d in decisions[0]] == [("none", "in_band"), ("re_role", "handoff_backlog_deep"),
                                             ("re_role", "handoff_backlog_deep"), ("re_role", "prefill_starved"),
                                             ("none", "in_band")]
    assert [d[3] for d in decisions[0]] == [False, True, False, True, False]


def test_adopt_writes_in_place_and_never_the_spare_page():
    cfg = GPTConfig(**SHAPE)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        cache = PagedKVCache.init(cfg, num_pages=6, page_size=8, dtype=dtype, device=CPU)
        cache.k[:, :, 6] = 7  # the spare page
        ptrs = [t.data_ptr() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]
        src = PagedKVCache.init(cfg, num_pages=6, page_size=8, dtype=dtype, device=CPU)
        g = torch.Generator().manual_seed(0)
        for t in (src.k, src.v):
            t.copy_(torch.randint(-100, 100, t.shape, generator=g).to(dtype))
        if src.quantized:
            src.k_scale.uniform_(generator=g)
            src.v_scale.uniform_(generator=g)
        blocks = disagg.gather_pages(src, [1, 4])
        if dtype == torch.bfloat16:
            assert blocks["k"].dtype == np.uint16
        disagg.adopt_pages(cache, [5, 2], blocks)
        assert [t.data_ptr() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None] == ptrs
        assert torch.equal(cache.k[:, :, [5, 2]], src.k[:, :, [1, 4]])
        assert torch.equal(cache.v[:, :, [5, 2]], src.v[:, :, [1, 4]])
        if src.quantized:
            assert torch.equal(cache.k_scale[:, [5, 2]], src.k_scale[:, [1, 4]])
        assert (cache.k[:, :, 6] == 7).all() and (cache.k[:, :, [0, 1, 3, 4]] == 0).all()
        for bad in ([6], [0], [3, 3]):
            with pytest.raises(ValueError):
                disagg.adopt_pages(cache, bad, disagg.gather_pages(src, [1] * len(bad)))
    # JAX's refusal: roles need a mesh of two data rows
    from midgpt_tpu_torch.parallel.serve_tp import make_serve_mesh

    with pytest.raises(ValueError, match="data >= 2"):
        disagg.DisaggServe(cfg, {}, mesh=make_serve_mesh(1, device=CPU))
    with pytest.raises(ValueError, match="greedy"):
        disagg.DisaggServe(cfg, {}, temperature=0.8)
