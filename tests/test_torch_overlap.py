"""Port parity, the decode loop's overlap modes: `overlap="group"` (round_group
decode rounds fused into one program) and `overlap="double"` (one group in
flight while the previous round's host work runs), against midgpt_tpu's
engine and `_serve_decode_group` on the same converted weights — greedy,
float32, through the gather lowering and the template's plain version.

* `parse_overlap` and `_round_group_bucket` equal JAX's on one table of
  inputs, bad specs included.
* `_serve_decode_group` called directly on seeded inputs — a chained slot,
  an EOS that fires mid-group, a max_len below the group's T (the finished
  slot's stale position then passes the table's width), an inactive slot
  mid-prefill — gives JAX's tokens, emitted mask, final tokens and lengths,
  and pool pages 0..num_pages-1.
* `decode_step_paged` and `verify_step_paged` with inactive slots, with
  `torch.nonzero` patched to raise (the host sync is gone): pages
  0..num_pages-1 equal JAX's, the sink untouched.
* The engine in off, double and group:2 against the JAX engine in the same
  mode on one mixed trace that forces preemption: identical streams, equal
  preemptions, equal `dispatch_log`, every page back in the pool. Then
  tests/test_overlap.py's cases: an EOS inside a group, admission landing
  two dispatches late under "double" (one under "off") for FCFS and SLO,
  and an in-flight request cancelled without collateral.

Tolerances: tokens and lengths exact (greedy argmax); pools 1e-5 absolute
(test_torch_model.py's). The slow tier widens the matrix: group:4, an int8
pool, a forced split, a speculative engine (which keeps its own rounds in
every mode) and the sliding window's page reclamation under "double".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.models.gpt import PagedKVCache as JCache
from midgpt_tpu.sampling import serve as jserve
from midgpt_tpu.sampling.scheduler import FCFSScheduler as JFCFS
from midgpt_tpu.sampling.scheduler import SLOScheduler as JSLO
from midgpt_tpu.sampling.spec import self_draft as j_self_draft
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache
from midgpt_tpu_torch.sampling import serve as tserve
from midgpt_tpu_torch.sampling.scheduler import FCFSScheduler, SLOScheduler
from midgpt_tpu_torch.sampling.spec import self_draft
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(max_slots=3, page_size=8, num_pages=10, prefill_chunk=16, decode_chunk=8, temperature=0.0)
MODES = [("off", 1), ("double", 1), ("group", 2)]
CPU = torch.device("cpu")
POOL_ATOL = 1e-5


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig(**SHAPE)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, GPTConfig(**SHAPE), _flatten(jp)


def _trace(seed=0, lengths=(5, 23, 11), max_new=(30, 24, 40)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, SHAPE["vocab_size"], n).astype(np.int32), m) for n, m in zip(lengths, max_new)]


def _engines(weights, overlap, round_group, attn_impl="gather", jax_kw=(), port_kw=(), **kw):
    """(JAX engine, port engine) of one mode on the same weights; `kw` goes
    to both, `jax_kw` / `port_kw` to one."""
    jcfg, jp, tcfg, flat = weights
    kw = {**ENGINE, "cache_dtype": "float32", **kw}
    j = jserve.ServeEngine(jcfg, jp, overlap=overlap, round_group=round_group, **kw, **dict(jax_kw))
    t = tserve.ServeEngine(tcfg, params_from_numpy(flat, device=CPU), device=CPU, overlap=overlap,
                           round_group=round_group, attn_impl=attn_impl, **kw, **dict(port_kw))
    return j, t


def _assert_conserved(eng):
    assert eng.allocator.free_count == eng.allocator.num_pages - 1, "page leak"


# ---------------------------------------------------------------- the CLI form


def test_parse_overlap_and_round_group_bucket_match_jax():
    for spec in ("off", "double", "group:1", "group:3", "group:4", "group:16",
                 "", "group", "group:", "group:0", "group:x", "triple"):
        try:
            want = jserve.parse_overlap(spec)
        except ValueError as e:
            with pytest.raises(ValueError, match="bad overlap spec"):
                tserve.parse_overlap(spec)
            assert "bad overlap spec" in str(e)
        else:
            assert tserve.parse_overlap(spec) == want
    for k in (-3, 0, 1, 2, 3, 4, 5, 7, 8, 9, 64):
        assert tserve._round_group_bucket(k) == jserve._round_group_bucket(k)
    assert tserve._ROUND_GROUP_CAP == jserve._ROUND_GROUP_CAP
    with pytest.raises(ValueError, match="overlap must be"):
        tserve.ServeEngine(GPTConfig(**SHAPE), {}, device=CPU, overlap="triple")


# ---------------------------------------------------------------- the group program

_j_decode = jax.jit(JGPT.decode_step_paged, static_argnums=(0, 7, 8, 9))
_j_verify = jax.jit(JGPT.verify_step_paged, static_argnums=(0, 7, 8, 9))
N_PAGES, PS = 16, 8
TABLE = np.array([[3, 7, 1, 0], [5, 2, 0, 0], [9, 10, 11, 12], [13, 14, 0, 0]], np.int32)


def _pools(jcfg, tcfg, seed=0):
    """The same random pool (page 0, the sink, zero) on both sides; the
    port's carries its spare page."""
    jc = JCache.init(jcfg, num_pages=N_PAGES, page_size=PS, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal(jc.k.shape).astype(np.float32) for _ in range(2))
    k[:, :, 0] = v[:, :, 0] = 0
    jc = JCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tc = PagedKVCache.init(tcfg, num_pages=N_PAGES, page_size=PS, dtype=torch.float32, device=CPU)
    tc.k[:, :, :N_PAGES] = torch.from_numpy(k)
    tc.v[:, :, :N_PAGES] = torch.from_numpy(v)
    return jc, tc


def _assert_pools_close(tc, jc):
    assert tc.num_pages == jc.num_pages == N_PAGES
    np.testing.assert_allclose(tc.k[:, :, :N_PAGES].numpy(), np.asarray(jc.k), atol=POOL_ATOL, rtol=0)
    np.testing.assert_allclose(tc.v[:, :, :N_PAGES].numpy(), np.asarray(jc.v), atol=POOL_ATOL, rtol=0)
    assert not tc.k[:, :, 0].any() and not tc.v[:, :, 0].any()  # nothing reached the sink


def _group_inputs(eos_slot1):
    """Slot 0 chained (its host view one round stale), slot 1 with an EOS,
    slot 2 with max_len 3 steps ahead (then parked at 32 = the table's full
    width, a column past it), slot 3 inactive mid-prefill (its pages hold
    K/V that must survive)."""
    return dict(
        token=np.array([11, 22, 33, 0]),
        lengths=np.array([10, 9, 29, 0], np.int32),
        active=np.array([True, True, True, False]),
        eos=np.array([-1, eos_slot1, -1, -1]),
        max_len=np.array([24, 16, 32, 0], np.int32),
        chain_mask=np.array([True, False, False, False]),
        chain_token=np.array([44, 0, 0, 0]),
        chain_len=np.array([13, 0, 0, 0], np.int32),
    )


def _run_groups(weights, attn_impl, eos_slot1):
    jcfg, jp, tcfg, flat = weights
    jc, tc = _pools(jcfg, tcfg)
    x = _group_inputs(eos_slot1)
    n, rg = 4, 2
    jx = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in x.items()}
    jc, *jout = jserve._serve_decode_group(
        jcfg, jp, jx["token"], jc, jnp.asarray(TABLE), jx["lengths"], jx["active"], jx["eos"], jx["max_len"],
        jx["chain_mask"], jx["chain_token"], jx["chain_len"], n, rg, 0.0, None, None, "gather", None, None, 1,
    )
    tp_ = params_from_numpy(flat, device=CPU)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    tout = tserve._serve_decode_group(
        tcfg, tp_, t["token"], tc, torch.from_numpy(TABLE), t["lengths"], t["active"], t["eos"], t["max_len"],
        t["chain_mask"], t["chain_token"], t["chain_len"], n, rg, 0.0, None, None, attn_impl,
    )
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout], jc, tc


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_serve_decode_group_matches_jax(weights, attn_impl):
    (jt, _, _, _), *_ = _run_groups(weights, "gather", -1)
    eos = int(jt[2, 1])  # slot 1's third token: the EOS fires inside the group
    (jt, je, jtf, jlf), (tt, te, ttf, tlf), jc, tc = _run_groups(weights, attn_impl, eos)
    T = 8
    assert tt.shape == te.shape == (T, 4) and te.dtype == bool
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(ttf, jtf)
    np.testing.assert_array_equal(tlf, jlf)
    # the staging is what the docstring says: chained slot 0 steps all T,
    # slot 1 stops after its EOS (fired before T), slot 2 after 3 steps,
    # slot 3 never; slot 2 ends parked past the table's last column
    assert te[:, 0].all() and 1 <= te[:, 1].sum() < T and te[:, 2].sum() == 3 and not te[:, 3].any()
    assert tlf[0] == 13 + T and tlf[2] == 32 == TABLE.shape[1] * PS
    _assert_pools_close(tc, jc)


def _no_sync(*args, **kwargs):
    raise AssertionError("a paged step called torch.nonzero (a host sync)")


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_paged_steps_write_without_a_sync(weights, monkeypatch, attn_impl):
    """Decode steps (slot 3 inactive, slot 2's stale length past the table's
    width) and one verify forward (slots 2 and 3 inactive): pool pages
    0..N_PAGES-1 equal JAX's after each, with torch.nonzero raising; the
    inactive slots' writes land on the spare page only."""
    jcfg, jp, tcfg, flat = weights
    tp_ = params_from_numpy(flat, device=CPU)
    jc, tc = _pools(jcfg, tcfg, seed=1)
    monkeypatch.setattr(torch, "nonzero", _no_sync)
    monkeypatch.setattr(torch.Tensor, "nonzero", _no_sync)
    token = np.array([4, 9, 17, 0], np.int32)
    lengths = np.array([19, 11, 32, 5], np.int32)
    active = np.array([True, True, False, False])
    for split_k in (1, 2):
        jl, jc = _j_decode(jcfg, jp, jnp.asarray(token), jc, jnp.asarray(TABLE), jnp.asarray(lengths),
                           jnp.asarray(active), "gather", None, split_k)
        tl, tc = GPT.decode_step_paged(tcfg, tp_, torch.from_numpy(token), tc, torch.from_numpy(TABLE),
                                       torch.from_numpy(lengths), torch.from_numpy(active), attn_impl=attn_impl,
                                       split_k=split_k)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=2e-5, rtol=0)
        _assert_pools_close(tc, jc)
        token = np.asarray(jl).argmax(-1).astype(np.int32)
        lengths = lengths + active
    assert tc.k[:, :, N_PAGES].abs().sum() > 0  # the inactive slots' writes went to the spare page
    tokens = np.random.default_rng(2).integers(0, 96, (4, 3)).astype(np.int32)
    active = np.array([True, True, False, False])
    jl, jc = _j_verify(jcfg, jp, jnp.asarray(tokens), jc, jnp.asarray(TABLE), jnp.asarray(lengths),
                       jnp.asarray(active), "gather", None, 1)
    tl, tc = GPT.verify_step_paged(tcfg, tp_, torch.from_numpy(tokens), tc, torch.from_numpy(TABLE),
                                   torch.from_numpy(lengths), torch.from_numpy(active), attn_impl=attn_impl)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=2e-5, rtol=0)
    _assert_pools_close(tc, jc)


# ---------------------------------------------------------------- the engine


def _drive(eng, trace, script=()):
    """Submit `trace`, apply `script` ((step index, action) pairs: run
    actions before that many steps have run), run to the end; returns
    the streams."""
    uids = [eng.submit(p, m) for p, m in trace]
    steps = 0
    for at, action in script:
        while steps < at:
            eng.step()
            steps += 1
        action(eng, uids)
    done = eng.run()
    return uids, [np.asarray(done[u].tokens) for u in uids]


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's streams, preemptions and dispatch log per mode."""
    out = {}
    for overlap, rg in MODES:
        j, _ = _engines(weights, overlap, rg)
        _, streams = _drive(j, _trace())
        out[(overlap, rg)] = streams, j.preemptions, list(j.dispatch_log)
    return out


@pytest.mark.parametrize("overlap,round_group", MODES, ids=[f"{o}:{g}" for o, g in MODES])
@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_engine_overlap_modes_match_jax(weights, jax_streams, overlap, round_group, attn_impl):
    want, want_preempt, want_log = jax_streams[(overlap, round_group)]
    assert want_preempt >= 1, "the trace must force a preemption"
    _, t = _engines(weights, overlap, round_group, attn_impl)
    _, got = _drive(t, _trace())
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert t.preemptions == want_preempt
    assert list(t.dispatch_log) == want_log
    _assert_conserved(t)
    st = t.stats()
    assert (st["overlap_mode"], st["round_group"], st["overlap_kills"]) == (overlap, round_group, 0)
    assert st["decode_graphs"] is None  # the CPU runs the group body eagerly
    # every mode streams what the classic engine streams
    np.testing.assert_equal(got, jax_streams[("off", 1)][0])


def test_eos_inside_a_group_stops_exactly(weights):
    """An EOS fired inside a fused group (not at its edge) stops the stream
    at the token the classic engine stops at; the eos id is taken from the
    stream without one, so greedy decoding hits it mid-group."""
    trace = _trace(seed=7, lengths=(25,), max_new=(17,))
    p, _ = trace[0]
    _, (free,) = _drive(_engines(weights, "off", 1)[1], trace)
    eos = int(free[len(p) + 5])
    outs = {}
    for overlap, rg in MODES:
        j, t = _engines(weights, overlap, rg)
        u = t.submit(*trace[0], eos_id=eos)
        ju = j.submit(*trace[0], eos_id=eos)
        outs[overlap] = np.asarray(t.run()[u].tokens)
        np.testing.assert_array_equal(outs[overlap], np.asarray(j.run()[ju].tokens))
        assert list(t.dispatch_log) == list(j.dispatch_log)
        _assert_conserved(t)
    assert len(outs["off"]) < len(free), "the EOS never fired"
    for got in outs.values():
        np.testing.assert_array_equal(got, outs["off"])


@pytest.mark.parametrize("sched", ["fcfs", "slo"])
def test_double_admission_lands_two_dispatches_late(weights, sched):
    """Under "double", round N+1's dispatch is enqueued before round N's
    host work admits a request, so it first appears in dispatch N+2; the
    classic engine admits before it dispatches (one round). B's prompt fits
    one prefill chunk, so the distance is the policy boundary alone."""
    (pa, ma), (pb, mb) = _trace(seed=11, lengths=(25, 12), max_new=(33, 9))
    make = {"fcfs": (FCFSScheduler, JFCFS), "slo": (SLOScheduler, JSLO)}[sched]
    first = {}
    for overlap in ("double", "off"):
        # a pool with room for both requests: B must not wait for pages
        j, t = _engines(weights, overlap, 1, jax_kw=dict(scheduler=make[1]()), port_kw=dict(scheduler=make[0]()),
                        num_pages=39)
        for eng in (j, t):
            ua = eng.submit(pa, ma)
            for _ in range(3):
                eng.step()
            r0 = eng.rounds
            assert any(ua in uids for _, uids in eng.dispatch_log)
            ub = eng.submit(pb, mb)
            eng.step()
            eng.step()
            if eng is t:
                first[overlap] = min(r for r, uids in eng.dispatch_log if ub in uids) - r0
            eng.run()
        assert list(t.dispatch_log) == list(j.dispatch_log)
        for u in (ua, ub):
            np.testing.assert_array_equal(t.finished[u].tokens, j.finished[u].tokens)
        _assert_conserved(t)
    assert first == {"double": 2, "off": 1}


def test_inflight_cancel_has_no_collateral(weights):
    """Cancelling a request whose group is still IN FLIGHT discards its
    unsettled tokens and touches nobody else: the survivor streams as in
    the JAX engine and every page comes home."""
    (pa, ma), (pc, mc) = _trace(seed=13, lengths=(25, 12), max_new=(17, 33))
    j, t = _engines(weights, "double", 1)
    for eng in (j, t):
        ua = eng.submit(pa, ma)
        uc = eng.submit(pc, mc)
        for _ in range(8):
            eng.step()
            if eng._inflight is not None and uc in dict(eng.dispatch_log).get(eng.rounds, ()):
                break
        else:
            pytest.fail("the victim never entered an in-flight dispatch")
        assert eng.cancel(uc)
        eng.run()
    assert t.finished[uc].status == "cancelled" and len(t.finished[uc].tokens) < len(pc) + mc
    for u in (ua, uc):
        np.testing.assert_array_equal(t.finished[u].tokens, j.finished[u].tokens)
    assert list(t.dispatch_log) == list(j.dispatch_log)
    _assert_conserved(t)


# ---------------------------------------------------------------- wider matrix


@pytest.mark.slow
@pytest.mark.parametrize("kw", [dict(cache_dtype="int8"), dict(split_k=2), dict(decode_chunk=4)],
                         ids=["int8", "split2", "chunk4"])
@pytest.mark.parametrize("overlap,round_group", [("group", 4), ("double", 2)])
def test_overlap_wide_matrix_matches_jax(weights, kw, overlap, round_group):
    j, t = _engines(weights, overlap, round_group, "kernel", **kw)
    _, want = _drive(j, _trace(seed=3))
    _, got = _drive(t, _trace(seed=3))
    np.testing.assert_equal(got, want)
    assert t.preemptions == j.preemptions and list(t.dispatch_log) == list(j.dispatch_log)
    _assert_conserved(t)


@pytest.mark.slow
@pytest.mark.parametrize("overlap,round_group", [("group", 2), ("double", 1)])
def test_speculative_engine_keeps_its_rounds_in_every_mode(weights, overlap, round_group):
    jcfg, jp, tcfg, flat = weights
    jd, jdp = j_self_draft(jcfg, jp, 1)
    td, tdp = self_draft(tcfg, params_from_numpy(flat, device=CPU), 1)
    j, t = _engines(weights, overlap, round_group, jax_kw=dict(draft_params=jdp, draft_config=jd),
                    port_kw=dict(draft_params=tdp, draft_config=td),
                    spec_k_min=2, spec_k_max=2, spec_adapt=False, draft_shares_cache=True)
    _, want = _drive(j, _trace())
    _, got = _drive(t, _trace())
    np.testing.assert_equal(got, want)
    assert t.spec_stats()["rounds"] > 0 and t.decode_steps == 0 and not t.dispatch_log
    _assert_conserved(t)


@pytest.mark.slow
def test_window_reclaim_under_double_matches_jax():
    """GQA with a 16-token window and 4 sinks under "double": reclamation
    runs inside the settle, one round late, and frees what JAX's does."""
    shape = dict(SHAPE, n_head=4, n_kv_heads=2, sliding_window=16, attn_sinks=4)
    jcfg = JConfig(**shape)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(1))
    weights = (jcfg, jp, GPTConfig(**shape), _flatten(jp))
    trace = _trace(seed=5, lengths=(40, 9, 17), max_new=(20, 40, 30))
    j, t = _engines(weights, "double", 1, "kernel")
    _, want = _drive(j, trace)
    _, got = _drive(t, trace)
    np.testing.assert_equal(got, want)
    assert t.window_reclaimed_pages == j.window_reclaimed_pages > 0
    assert list(t.dispatch_log) == list(j.dispatch_log)
    _assert_conserved(t)
