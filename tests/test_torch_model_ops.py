"""Port parity, zero-downtime model ops (sampling/ops.py): the port's hot
swap, pool resize and ModelOps controller against JAX's on converted
weights, greedy, f32 pools.

* Hot swap: every refusal carries JAX's `reason` and leaves the engine as
  it was; a swap staged mid-trace flips at the same round as JAX's, and the
  streams on both sides of the flip equal JAX's (exact).
* Resize: a grow-then-shrink mid-trace through the `pool_resize` fault,
  with the prefix cache on, leaves every stream equal to a run without a
  resize and to JAX's (exact), pages conserved at every round; a refused
  shrink carries JAX's fields.
* ModelOps: one scripted signal sequence under an injected clock gives
  JAX's decisions (kind, reason, arguments, applied).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.robustness import faults as j_faults
from midgpt_tpu.sampling import ops as j_ops
from midgpt_tpu.sampling.scheduler import set_backlog_budget as j_set_budget
from midgpt_tpu.sampling.serve import BackpressureError as JBackpressure
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.sampling import ops
from midgpt_tpu_torch.sampling.scheduler import set_backlog_budget
from midgpt_tpu_torch.sampling.serve import BackpressureError, ServeEngine
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(max_slots=3, page_size=8, num_pages=16, prefill_chunk=16, decode_chunk=4, temperature=0.0)
CPU = torch.device("cpu")


def _flat(jp):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}


@pytest.fixture(scope="module")
def weights():
    """Two sets of JAX params (the live and the swapped-in weights)."""
    return [JGPT.init(JConfig(**SHAPE), jax.random.PRNGKey(s)) for s in (0, 11)]


def _jax(jp, **kw):
    return JServeEngine(JConfig(**SHAPE), jp, **{"cache_dtype": jnp.float32, **ENGINE, **kw})


def _port(jp, **kw):
    return ServeEngine(GPTConfig(**SHAPE), params_from_numpy(_flat(jp), device=CPU), device=CPU,
                       **{"cache_dtype": torch.float32, **ENGINE, **kw})


def _trace(seed, n=3, lo=18, hi=30, bl=8, bh=14):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, SHAPE["vocab_size"], int(m)).astype(np.int32) for m in rng.integers(lo, hi, size=n)]
    return list(zip(prompts, (int(b) for b in rng.integers(bl, bh, size=n))))


# ----------------------------------------------------------------------
# hot swap
# ----------------------------------------------------------------------


def _refusal(case, eng, live, new, wide, cfg, stray):
    """Make `eng` refuse one swap; returns the HotSwapError."""
    cls = ops.HotSwapError if isinstance(eng, ServeEngine) else j_ops.HotSwapError
    with pytest.raises(cls) as ei:
        if case == "pending":
            eng.submit(*_trace(1, n=1)[0])
            eng.step()
            eng.hot_swap(new, version="v2")
            eng.hot_swap(new, version="v3")
        else:
            eng.hot_swap(*{
                "tree_structure": ({"stray": stray},),
                "shape": (wide,),
                "dtype": (live,),
                "config": (new,),
                "draft_unexpected": (new,),
            }[case], **{"config": {"config": dataclasses.replace(cfg, block_size=128)},
                        "draft_unexpected": {"draft_params": new}}.get(case, {}))
    return ei.value


@pytest.mark.parametrize("case", ["tree_structure", "shape", "dtype", "config", "draft_unexpected", "pending"])
def test_hot_swap_refusals_carry_jax_reason(weights, case):
    """Each refusal raises before the engine changes, with JAX's `reason`
    (and, for the pending swap, JAX's `got`)."""
    jp, jp_new = weights
    wide_j = JGPT.init(JConfig(**dict(SHAPE, n_embd=48)), jax.random.PRNGKey(1))
    j_live = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp_new) if case == "dtype" else jp_new
    jerr = _refusal(case, _jax(jp), j_live, jp_new, wide_j, JConfig(**SHAPE), jnp.zeros(()))
    eng = _port(jp)
    new = params_from_numpy(_flat(jp_new), device=CPU)
    p_live = {k: v.bfloat16() for k, v in new.items()} if case == "dtype" else new
    perr = _refusal(case, eng, p_live, new, params_from_numpy(_flat(wide_j), device=CPU), GPTConfig(**SHAPE),
                    torch.zeros(()))
    assert perr.reason == jerr.reason == case.replace("pending", "swap_pending")
    if case in ("shape", "dtype"):
        assert perr.path and perr.expected != perr.got
    if case == "pending":
        assert perr.got == jerr.got == "v3" and eng.stats()["swap_pending"] and not eng.idle
    else:
        assert eng.hot_swaps == 0 and eng.weights_version == "inline" and not eng.stats()["swap_pending"]


def _swap_run(make, live, new):
    """Three requests, a swap staged at round 3 (admission pauses), one
    more request queued behind it; returns streams, statuses and the flip's
    record."""
    eng = make(live)
    trace = _trace(4)
    uids = [eng.submit(p, b) for p, b in trace]
    for _ in range(3):
        eng.step()
    summary = eng.hot_swap(new, version="v2")
    assert summary["staged"] and not summary["flipped"]
    late = eng.submit(*_trace(5, n=1)[0])
    done = eng.run()
    rec = dict(eng.swap_history[-1])
    rec.pop("swap_latency_s")
    return [done[u].tokens.tolist() for u in uids + [late]], rec, eng.weights_version


def test_hot_swap_mid_trace_matches_jax_on_both_sides_of_the_flip(weights):
    """The old streams finish on the old weights, the queued arrival runs
    on the new ones; streams and the flip's record equal JAX's, and the
    late stream equals a fresh engine's on the new weights."""
    jp, jp_new = weights
    new = params_from_numpy(_flat(jp_new), device=CPU)
    got = _swap_run(_port, jp, new)
    want = _swap_run(_jax, jp, jp_new)
    assert got == want
    assert got[1]["flip_round"] > got[1]["staged_round"] and got[2] == "v2"
    fresh = _port(jp_new)
    u = fresh.submit(*_trace(5, n=1)[0])
    assert fresh.run()[u].tokens.tolist() == got[0][-1]


def test_hot_swap_fault_flips_in_place_and_keeps_a_self_draft_old(weights):
    """hot_swap_mid_decode stages swap_source()'s payload; the flip writes
    into the engine's own tensors (their storage is unchanged), and a
    layer-prefix self-draft keeps the old weights, as JAX's does on a
    target-only swap."""
    from midgpt_tpu_torch.sampling.spec import self_draft

    jp, jp_new = weights
    cfg, params = GPTConfig(**SHAPE), params_from_numpy(_flat(jp), device=CPU)
    dcfg, dparams = self_draft(cfg, params, 1)
    old_draft = {k: v.clone() for k, v in dparams.items()}
    eng = ServeEngine(cfg, params, cache_dtype=torch.float32, device=CPU, draft_params=dparams, draft_config=dcfg,
                      draft_shares_cache=True, **ENGINE)
    ptrs = {k: v.data_ptr() for k, v in eng.params.items()}
    new = params_from_numpy(_flat(jp_new), device=CPU)
    eng.swap_source = lambda: {"params": new, "version": "v2"}
    faults.clear()
    faults.activate("hot_swap_mid_decode", step=2)
    try:
        eng.submit(*_trace(6, n=1)[0])
        eng.run()
    finally:
        faults.clear()
    assert eng.weights_version == "v2" and eng.hot_swaps == 1
    assert {k: v.data_ptr() for k, v in eng.params.items()} == ptrs
    assert all(torch.equal(eng.params[k], new[k]) for k in new)
    assert all(torch.equal(eng.draft_params[k], old_draft[k]) for k in old_draft)


# ----------------------------------------------------------------------
# resize
# ----------------------------------------------------------------------


def _resize_run(make, jp, plan, **kw):
    """The template-headed trace with the prefix cache on; `plan` resizes
    at rounds 3 (grow) and 5 (shrink) through the pool_resize fault.
    Conservation is asserted after every round."""
    eng = make(jp, prefix_cache=True, **kw)
    eng.resize_plan = list(plan)
    rng = np.random.default_rng(3)
    head = rng.integers(0, SHAPE["vocab_size"], 16).astype(np.int32)
    trace = [(np.concatenate([head, rng.integers(0, SHAPE["vocab_size"], n).astype(np.int32)]), m)
             for n, m in ((3, 14), (5, 12), (2, 16), (6, 10))]
    uids = [eng.submit(p, m) for p, m in trace[:3]]
    conserve = ops.assert_conserved if isinstance(eng, ServeEngine) else j_ops.assert_conserved
    flt = faults if isinstance(eng, ServeEngine) else j_faults
    flt.clear()
    for r in (3, 5):
        flt.activate("pool_resize", step=r)
    try:
        while not eng.idle:
            eng.step()
            conserve(eng, f"round {eng.rounds}")
            if eng.rounds == 4:
                uids.append(eng.submit(*trace[3]))
    finally:
        flt.clear()
    return [eng.finished[u].tokens.tolist() for u in uids], eng


def test_resize_grow_then_shrink_matches_no_resize_and_jax(weights):
    """Grow 16 -> 24 pages at round 3, shrink to 14 at round 5: streams
    equal the run without a resize and JAX's run without one (exact), the
    trie's pages moved with their content, pages conserved at every
    round."""
    jp = weights[0]
    got, eng = _resize_run(_port, jp, [24, 14])
    assert [(r["from_pages"], r["to_pages"]) for r in eng.resize_history] == [(16, 24), (24, 14)]
    assert all(r["pages_migrated"] > 0 for r in eng.resize_history)
    assert eng.allocator.num_pages == eng.cache.num_pages == 14 and eng.cache.k.shape[2] == 15  # + the spare
    assert eng.prefix_stats()["hit_rate"] > 0
    plain, _ = _resize_run(_port, jp, [])
    want, _ = _resize_run(_jax, jp, [])
    assert got == plain == want


@pytest.mark.slow
def test_resize_matches_jax_resize_int8(weights):
    """The same grow-then-shrink on int8 pools on both sides (the scales
    move with their pages): streams equal JAX's resized run, exact."""
    jp = weights[0]
    got, eng = _resize_run(_port, jp, [24, 14], cache_dtype="int8")
    want, jeng = _resize_run(_jax, jp, [24, 14], cache_dtype="int8")
    assert got == want
    assert [r["pages_migrated"] for r in eng.resize_history] == [r["pages_migrated"] for r in jeng.resize_history]


def test_refused_resize_carries_jax_fields(weights):
    """Below the resident working set, and below the live slot count: the
    same structured, retryable refusals as JAX's, and nothing changes."""
    jp = weights[0]
    errs = []
    for make, err in ((_port, ops.PoolResizeError), (_jax, j_ops.PoolResizeError)):
        eng = make(jp)
        for p, b in _trace(6, lo=20, hi=31, bl=16, bh=24):
            eng.submit(p, b)
        for _ in range(3):
            eng.step()
        live = sum(s is not None for s in eng.slots)
        fields = []
        for kw in (dict(num_pages=2), dict(max_slots=live - 1)):
            with pytest.raises(err) as ei:
                eng.resize(**kw)
            e = ei.value
            fields.append((e.requested_pages, e.resident_pages, e.num_pages, e.requested_slots, e.live_slots,
                           e.retryable))
        assert eng.allocator.num_pages == 16 and eng.resizes == 0
        errs.append(fields)
    assert errs[0] == errs[1] and errs[0][0][1] >= 2 and errs[0][1][5] is True


# ----------------------------------------------------------------------
# the controller
# ----------------------------------------------------------------------


def _decisions(make, jp, ModelOps, Backpressure, set_budget):
    """JAX's decision-table script: shed_threshold, the interval gate, grow
    on a TTFT breach, shrink on surplus, in band."""
    t = {"now": 100.0}
    eng = make(jp, max_backlog_pages=1)
    mops = ModelOps(eng, clock=lambda: t["now"], min_interval_s=10.0, ttft_budget_ms=200.0)
    with pytest.raises(Backpressure):
        eng.submit(np.zeros(24, np.int32), 8)
    mops.tick()
    t["now"] += 1.0
    mops.tick()
    t["now"] += 100.0
    mops.tick(ttft_p95_ms=500.0)
    set_budget(eng, None)
    t["now"] += 100.0
    mops.tick()
    t["now"] += 100.0
    mops.high_free_frac = 1.1
    mops.tick()
    return [(d.kind, d.reason, d.args, d.applied, d.error) for d in mops.decisions], eng.allocator.num_pages


def test_model_ops_makes_jax_decisions(weights):
    got = _decisions(_port, weights[0], ops.ModelOps, BackpressureError, set_backlog_budget)
    want = _decisions(_jax, weights[0], j_ops.ModelOps, JBackpressure, j_set_budget)
    assert got == want
    assert [d[0] for d in got[0]] == ["shed_threshold", "none", "grow", "shrink", "none"]


class _FakeRole:
    """The signals ModelOps reads off one role of a disaggregated pair."""

    def __init__(self, pages, free):
        self.allocator = type("A", (), {"num_pages": pages, "free_count": free})()
        self.shed = self._uid = 0

    def _backlog_pages(self):
        return 0


class _FakeDisagg:
    """A duck-typed disaggregated target: two roles, a handoff queue of
    some depth, and a rebalance that moves pages or refuses."""

    def __init__(self, err_cls):
        self.prefill, self.decode = _FakeRole(17, 16), _FakeRole(17, 16)
        self.depth = 0
        self.err_cls = err_cls
        self.obs = None
        self.queue = type("Q", (), {"stats": lambda _: {"depth": self.depth}})()

    def rebalance(self, n, *, src, dst):
        a, b = getattr(self, src).allocator, getattr(self, dst).allocator
        if a.free_count < n:
            raise self.err_cls("refused", requested_pages=a.num_pages - n, resident_pages=a.num_pages,
                               num_pages=a.num_pages)
        a.num_pages -= n
        a.free_count -= n
        b.num_pages += n
        b.free_count += n


def _disagg_decisions(mod):
    d = _FakeDisagg(mod.PoolResizeError)
    mops = mod.ModelOps(d, rebalance_pages=6)
    d.depth = 5
    mops.tick()  # deep backlog: prefill -> decode
    mops.tick()
    mops.tick()  # the prefill pool is down to 4 free pages: refused, recorded
    d.depth = 0
    d.prefill.allocator.free_count = 0
    mops.tick()  # starved prefill, roomy decode: decode -> prefill
    mops.tick()
    return [(x.kind, x.reason, x.args, x.applied, x.error is None) for x in mops.decisions]


def test_model_ops_re_roles_a_disagg_target_as_jax_does():
    """ModelOps over a disaggregated pair (JAX's _tick_disagg): a deep
    handoff queue moves pages prefill -> decode, a refused move is recorded
    and not raised, a starved prefill role takes pages back."""
    got = _disagg_decisions(ops)
    assert got == _disagg_decisions(j_ops)
    assert [(k, a) for k, _, _, a, _ in got] == [("re_role", True), ("re_role", True), ("re_role", False),
                                                  ("re_role", True), ("none", False)]
