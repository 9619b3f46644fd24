"""Port parity, the fleet (sampling/fleet.py) and its spill tier, against
JAX's midgpt_tpu/sampling/fleet.py.

* SpillTier: one seeded sequence of spills, duplicates, peeks, takes, a
  corruption, a stall, a stale version, a capacity drop, an export and an
  import gives JAX's return values, stats and `_blocks_crc` after every
  operation, for f32, int8 (with scales) and bf16 pools (raw 16-bit words
  on the host); the page size binds once.
* PageHandoffQueue: the backoff schedule and the exhaustion are JAX's.
* FleetRouter policy, on duck-typed replicas shared by both routers:
  affinity choices for seeded prompts, placement, failover after
  consecutive failures, the stale-heartbeat crash on an injected clock, the
  aggregated shed and the terminal shed past the budget equal JAX's.
* A page damaged by `poisoned_page` never reaches the tier. (The router on
  real engines against JAX's, an `engine_crash` run and a staged spill
  re-adopted at admission, is in tests/test_torch_chaos_serve.py, which
  compiles the same JAX engines.)
* `loadgen --device cpu --fleet 2` prints a line JAX's
  `check_serve_slo_bench` accepts, fleet fields included.
"""

import gc
import json
import threading
import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.analysis.bench_contract import check_serve_slo_bench
from midgpt_tpu.robustness import faults as j_faults
from midgpt_tpu.sampling import disagg as j_disagg
from midgpt_tpu.sampling import fleet as j_fleet
from midgpt_tpu.sampling import serve as j_serve
from midgpt_tpu_torch import loadgen
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig
from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.sampling import disagg, fleet, graphs, serve

PS = 8
SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(max_slots=3, page_size=8, num_pages=31, prefill_chunk=16, decode_chunk=4, temperature=0.0,
              prefix_cache=True)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one thread, and the suite's workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registries():
    faults.clear()
    j_faults.clear()
    yield
    faults.clear()
    j_faults.clear()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------- the spill tier


def _caches(dtype, n_pages=8, seed=0):
    """The same pool content as a port cache (torch) and a JAX cache: k/v
    (L, H, P, ps, C), scales (L, P, H, ps) for int8."""
    rng = np.random.default_rng(seed)
    shape = (2, 2, n_pages, PS, 4)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random((2, n_pages, 2, PS)).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        ks = vs = None
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    port = types.SimpleNamespace(k=torch.from_numpy(k).to(tdt), v=torch.from_numpy(v).to(tdt),
                                 k_scale=None if ks is None else torch.from_numpy(ks),
                                 v_scale=None if vs is None else torch.from_numpy(vs))
    jx = types.SimpleNamespace(k=jnp.asarray(k, jdt), v=jnp.asarray(v, jdt),
                               k_scale=None if ks is None else jnp.asarray(ks),
                               v_scale=None if vs is None else jnp.asarray(vs))
    return port, jx


def _spill_ops(mod, cache):
    """A seeded operation sequence on a fresh tier of module `mod`; returns
    one record per operation: its result (blocks as bytes), the tier's stats
    and every resident entry's (key, crc of its blocks, stored checksum)."""
    tier = mod.SpillTier()
    tier.set_page_size(PS)
    rng = np.random.default_rng(5)
    a, b, c = (list(rng.integers(0, 96, 4 * PS)) for _ in range(3))

    def spill(prompt, pages, version="v0"):
        return [tier.spill(cache, tuple(prompt[: (d + 1) * PS]), p, version) for d, p in enumerate(pages)]

    def blocks(run):
        return [{k: b.tobytes() for k, b in sorted(x.items())} for x in run]

    ops = [
        lambda: spill(a, [1, 2, 3]),
        lambda: spill(a, [1]),  # duplicate under the same version: skipped
        lambda: spill(b, [4]),
        lambda: tier.peek_run(a, 0, 4, "v0"),
        lambda: blocks(tier.take_run(a, 0, 2, "v0")),
        lambda: tier.corrupt_one(),  # b's page, the newest
        lambda: blocks(tier.take_run(b, 0, 1, "v0")),  # caught: discarded
        lambda: (tier.arm_stall(), tier.peek_run(a, 2, 1, "v0"), tier.peek_run(a, 2, 1, "v0")),
        lambda: tier.spill(cache, tuple(a[: 3 * PS]), 5, "v1"),  # after a hot swap: replaces the stale entry
        lambda: tier.take_run(a, 2, 1, "v0"),  # the old version's take: stale, discarded
        lambda: spill(c, [6, 7]),
        lambda: setattr(tier, "capacity_bytes", tier._entries[tuple(c[:PS])].nbytes) or tier._enforce_capacity(),
        lambda: [(it.key, it.checksum, it.weights_version) for it in tier.export_entries()],
        lambda: tier.import_entries([mod.SpillTransferItem(key=tuple(c[:PS]), blocks=_first_blocks(cache),
                                                           checksum=mod._blocks_crc(_first_blocks(cache)),
                                                           weights_version="v0")]),
        lambda: blocks(tier.take_run(c, 0, 1, "v0")),
    ]
    out = []
    for op in ops:
        res = op()
        tier.assert_ledger("spill ops")
        out.append((res, tier.stats(), sorted((k, mod._blocks_crc(e.blocks), e.checksum)
                                              for k, e in tier._entries.items())))
    with pytest.raises(ValueError, match="already bound"):
        tier.set_page_size(16)
    with pytest.raises(RuntimeError, match="before any engine"):
        mod.SpillTier().peek_run(a, 0, 1, "v0")
    return out


def _first_blocks(cache):
    """Page 1's blocks as host arrays (the same bytes for either cache)."""
    if isinstance(cache.k, torch.Tensor):
        got = {"k": disagg.host_block(cache.k[:, :, 1]), "v": disagg.host_block(cache.v[:, :, 1])}
        if cache.k_scale is not None:
            got.update(k_scale=disagg.host_block(cache.k_scale[:, 1]), v_scale=disagg.host_block(cache.v_scale[:, 1]))
        return got
    got = {"k": np.asarray(cache.k[:, :, 1]), "v": np.asarray(cache.v[:, :, 1])}
    if cache.k_scale is not None:
        got.update(k_scale=np.asarray(cache.k_scale[:, 1]), v_scale=np.asarray(cache.v_scale[:, 1]))
    return got


def _jax_spill_transfer():
    from midgpt_tpu.sampling.fleet_proc import SpillTransferItem

    return SpillTransferItem


@pytest.mark.parametrize("dtype", ["f32", "int8", "bf16"])
def test_spill_tier_equals_jax(dtype):
    port_cache, jax_cache = _caches(dtype)
    j_mod = types.SimpleNamespace(SpillTier=j_fleet.SpillTier, _blocks_crc=j_fleet._blocks_crc,
                                  SpillTransferItem=_jax_spill_transfer())
    got, want = _spill_ops(fleet, port_cache), _spill_ops(j_mod, jax_cache)
    assert got == want
    final = got[-1][1]
    assert final["corrupt_discarded"] == 1 and final["stall_fallbacks"] == 1 and final["capacity_dropped"] >= 1
    assert final["stale_discarded"] >= 2 and final["readopted"] == 3 and final["transferred"] >= 1
    if dtype == "bf16":  # raw words on the host: the crc covers exactly the bytes that go back
        assert disagg.host_block(port_cache.k[:, :, 1]).dtype == np.uint16


def test_handoff_queue_schedule_equals_jax():
    def run(mod):
        clock = _Clock()
        q = mod.PageHandoffQueue(retries=4, base_s=1.0, clock=clock)
        item = lambda uid: types.SimpleNamespace(uid=uid, n_pages=2, blocks={"k": np.zeros(4, np.float32)})
        q.push(item(7))
        q.push(item(8))
        seen = []
        it = q.pop()
        for dt in (0.0, 1.0, 2.0, 4.0):
            try:
                q.requeue(it)
            except mod.HandoffRetryExhausted as e:
                seen.append(("exhausted", e.uid, e.attempts))
                break
            seen.append(("backoff", q.pop() is None, it._not_before))
            clock.t += dt if dt else 1.0
            it = q.pop() or q.pop(now=clock.t + 100)
        seen.append(q.pop().uid)
        with pytest.raises(ValueError, match="retries"):
            mod.PageHandoffQueue(retries=0)
        return seen, q.stats()

    assert run(disagg) == run(j_disagg)


# ---------------------------------------------------------------- router policy on duck-typed replicas


class _FakeEngine:
    """Just enough ServeEngine surface for the router: capacity-bounded
    submit, a deterministic finish after `steps_to_finish` rounds,
    injectable step failures and clock stalls. `mod` is the serve module
    whose BackpressureError / FinishedRequest it raises and returns."""

    def __init__(self, mod, *, capacity=4, steps_to_finish=2, page_size=8, clock=None, retryable_shed=True):
        self.mod = mod
        self.prefix_cache = object()
        self.temperature = 0.0
        self.page_size = page_size
        self.capacity = capacity
        self.steps_to_finish = steps_to_finish
        self.retryable_shed = retryable_shed
        self.on_token = None
        self.finished = {}
        self.active = {}
        self._uid = 0
        self.fail_steps = 0
        self.stall_s = 0.0
        self._clock = clock
        self.rounds = self.preemptions = self.shed = self.spill_readopted_pages = 0
        self._prefix_matched_tokens = self._prefix_matchable_tokens = 0

    def attach_spill(self, spill):
        spill.set_page_size(self.page_size)

    def prefix_stats(self):
        return {"hit_rate": 0.0}

    def submit(self, prompt, max_new_tokens, eos_id=None, ttl_s=None):
        if len(self.active) >= self.capacity:
            self.shed += 1
            raise self.mod.BackpressureError("fake full", needed_pages=1, backlog_pages=self.capacity,
                                             budget_pages=self.capacity, retryable=self.retryable_shed)
        uid = self._uid
        self._uid += 1
        self.active[uid] = [np.asarray(prompt, np.int32), int(max_new_tokens), self.steps_to_finish]
        return uid

    @property
    def idle(self):
        return not self.active

    def step(self):
        self.rounds += 1
        if self.fail_steps > 0:
            self.fail_steps -= 1
            raise RuntimeError("injected replica failure")
        if self.stall_s and self._clock is not None:
            self._clock.t += self.stall_s
        for uid in [u for u, rec in self.active.items() if rec[2] <= 1]:
            prompt, m, _ = self.active.pop(uid)
            self.finished[uid] = self.mod.FinishedRequest(uid, np.concatenate([prompt, np.arange(m, dtype=np.int32)]),
                                                          [0.0] * m, "ok")
        for rec in self.active.values():
            rec[2] -= 1


def _prompt(template, tail):
    return np.asarray(list(template) + list(tail), np.int32)


def _drain(router):
    done = router.run()
    return ({u: (fr.tokens.tolist(), fr.status) for u, fr in sorted(done.items())}, router.crash_log,
            router.failovers, router.failed_over_streams, router.shed_streams, router.router_shed,
            router.failover_queue.stats())


def _scenario(name, fmod, smod):
    clock = _Clock()
    fake = lambda **kw: _FakeEngine(smod, **kw)
    if name == "affinity":
        router = fmod.FleetRouter([fake() for _ in range(3)], clock=clock)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 50304, int(rng.integers(9, 40))) for _ in range(64)]
        return [[router._affinity(p, alive) for p in prompts] for alive in ([0, 1, 2], [0, 2], [1, 2], [1])] + [
            router._affinity(np.arange(8), [0, 1, 2])]
    if name == "placement":
        router = fmod.FleetRouter([fake(capacity=8) for _ in range(2)], clock=clock)
        p = _prompt(range(8), [9, 9])
        placed = [router._pending[router.submit(p, 4)].replica for _ in range(3)]
        router.engines[placed[0]].capacity = 3
        placed.append(router._pending[router.submit(p, 4)].replica)
        placed.append(router._pending[router.submit(np.arange(5), 4)].replica)  # no affinity: least loaded
        return placed, _drain(router)
    if name == "consecutive_failures":
        router = fmod.FleetRouter([fake(capacity=8, clock=clock) for _ in range(2)], clock=clock,
                                  max_consecutive_failures=2)
        uids = [router.submit(_prompt(range(t, t + 8), [1]), 3) for t in (0, 100, 200)]
        router.engines[router._pending[uids[0]].replica].fail_steps = 2
        return _drain(router), router.alive
    if name == "heartbeat":
        router = fmod.FleetRouter([fake(capacity=8, clock=clock) for _ in range(2)], clock=clock,
                                  heartbeat_timeout_s=5.0)
        uid = router.submit(_prompt(range(8), [1]), 3)
        router.engines[router._pending[uid].replica].stall_s = 50.0
        return _drain(router), router.alive
    if name == "aggregated_shed":
        out = []
        for retryable in (True, False):
            router = fmod.FleetRouter([fake(capacity=0, clock=clock, retryable_shed=retryable) for _ in range(2)],
                                      clock=clock)
            with pytest.raises(smod.BackpressureError) as ei:
                router.submit(_prompt(range(8), [1]), 4)
            e = ei.value
            out.append((e.retryable, e.needed_pages, e.backlog_pages, e.budget_pages, router.router_shed))
        return out
    if name == "terminal_shed":
        eng0, eng1 = fake(capacity=1, clock=clock), fake(capacity=0, clock=clock)
        router = fmod.FleetRouter([eng0, eng1], clock=clock, max_consecutive_failures=1, failover_retries=3)
        uid = router.submit(_prompt(range(8), [1]), 3)
        eng0.fail_steps = 1
        return router._pending[uid].replica, _drain(router)
    if name == "checks":
        msgs = []
        for engines in ([fake()], [fake()], [fake(page_size=8), fake(page_size=16)]):
            if len(msgs) == 0:
                engines[0].temperature = 0.7
            if len(msgs) == 1:
                engines[0].prefix_cache = None
            with pytest.raises(ValueError) as ei:
                fmod.FleetRouter(engines)
            msgs.append(str(ei.value))
        return msgs
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["affinity", "placement", "consecutive_failures", "heartbeat", "aggregated_shed",
                                  "terminal_shed", "checks"])
def test_router_policy_equals_jax(name):
    got = _scenario(name, fleet, serve)
    assert got == _scenario(name, j_fleet, j_serve)
    if name == "consecutive_failures":
        assert got[0][1][0]["reason"] == "consecutive_failures" and got[0][3] >= 1
    if name == "heartbeat":
        assert got[0][1][0]["reason"] == "heartbeat_stale"
    if name == "terminal_shed":
        assert got[1][4] == 1


def test_router_records_step_errors_and_holds_itself_weakly():
    """Each exception a replica's step raises is kept with its replica and
    round (the health check absorbs it); the token relays reach the router
    through a weak reference, so a dropped router is freed at once, with
    the collector off, and a relay that outlives it delivers nothing."""
    clock = _Clock()
    router = fleet.FleetRouter([_FakeEngine(serve, capacity=8, clock=clock) for _ in range(2)], clock=clock,
                               max_consecutive_failures=2)
    uid = router.submit(_prompt(range(8), [1]), 3)
    victim = router._pending[uid].replica
    router.engines[victim].fail_steps = 2
    router.run()
    assert router.step_errors == [{"replica": victim, "round": r, "error": "RuntimeError('injected replica failure')"}
                                  for r in (1, 2)]
    assert [c["reason"] for c in router.crash_log] == ["consecutive_failures"]
    relay = router.engines[0].on_token
    ref = weakref.ref(router)
    was = gc.isenabled()
    gc.disable()
    try:
        del router
        assert ref() is None
    finally:
        if was:
            gc.enable()
    relay(0, 1, 0.0)


def test_capture_gc_pause_nests_across_threads():
    """The collector stays off while any capture is in flight, whichever
    thread began first, and comes back on after the last one."""
    first_in, release = threading.Event(), threading.Event()

    def capture():
        with graphs._gc_paused():
            first_in.set()
            release.wait(5)

    assert gc.isenabled()
    t = threading.Thread(target=capture)
    t.start()
    first_in.wait(5)
    with graphs._gc_paused():
        release.set()
        t.join(5)
        assert not gc.isenabled()
    assert gc.isenabled()


# ---------------------------------------------------------------- real engines


def _trace(n=4, seed=1):
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, 96, 16).astype(np.int32) for _ in range(2)]
    return [(np.concatenate([heads[i % 2], rng.integers(0, 96, int(rng.integers(2, 6))).astype(np.int32)]),
             int(rng.integers(6, 16))) for i in range(n)]


def test_tainted_page_never_reaches_the_tier():
    """poisoned_page damages a live page; the slot reading it taints what
    it wrote. On the flush the trie evicts those pages through on_evict
    before they are scrubbed: the engine skips them, so every resident
    spilled page is finite."""
    pp = GPT.init(GPTConfig(**SHAPE), 0, device=CPU, dtype=torch.float32)
    eng = serve.ServeEngine(GPTConfig(**SHAPE), pp, cache_dtype=torch.float32, device=CPU, **ENGINE)
    tier = fleet.SpillTier()
    eng.attach_spill(tier)
    faults.activate("poisoned_page", step=3)
    for p, m in _trace():
        eng.submit(p, m)
    eng.run()
    faults.clear()
    assert eng.poisoned_uids
    eng.flush_prefix_cache()
    assert eng.stats()["spill_tainted_skips"] >= 1
    assert tier.total_spilled >= 1
    assert all(np.isfinite(b).all() for e in tier._entries.values() for b in e.blocks.values())
    tier.assert_ledger("tainted")
    with pytest.raises(ValueError, match="prefix_cache"):
        serve.ServeEngine(GPTConfig(**SHAPE), pp, device=CPU, prefix_cache=False).attach_spill(tier)


def test_loadgen_fleet_passes_the_serve_slo_contract(capsys):
    """Two replicas, template traffic, two points: the contract holds with
    the fleet fields, nothing failed over, nothing was captured, every
    request completed."""
    assert loadgen.main(["--device", "cpu", "--fleet", "2", "--rates", "20,60", "--template-frac", "0.5",
                         "--n-requests", "4"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert check_serve_slo_bench(rec) == []
    assert rec["fleet_size"] == 2 and rec["failovers"] == 0 and rec["spill_hits"] >= 0 and rec["prefix_cache"]
    # how much the trie hits depends on whether a head's first request has
    # finished its prefill when the next arrives: host timing, on the CPU
    assert 0.0 <= rec["prefix_hit_rate"] <= 1.0
    for p in rec["points"]:
        assert p["completed"] == p["n_offered"] and p["captures"] == 0 and p["fleet_size"] == 2
        assert p["failovers"] == 0 and p["step_errors"] == 0
