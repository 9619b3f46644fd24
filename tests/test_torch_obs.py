"""Port parity, observability and the serving faults: midgpt_tpu_torch/obs
against midgpt_tpu/obs on the same event sequences, and the port engine
under `kill_mid_decode`, `kill_overlapped_round` and `poisoned_page`
against the JAX `ServeEngine` under the same plan.

* Tracer: the same spans, completes, instants and async pairs on the same
  fake clock give equal `events()`, `export()`, dumps and ring drops.
* Metrics: counters, gauges and histograms (nearest-rank percentiles over
  a bounded reservoir) give equal summaries, snapshots and
  `to_prometheus()`; `Observability.record_round` equal decompositions,
  snapshots and dump files.
* The engine, greedy, float32, on the CPU (gather lowering): under each
  fault the port's streams, preemptions, kill counters and poisoned uids
  equal JAX's, every page comes home, and the streams equal an unfaulted
  run's but for the poisoned slot's. Obs on or off, and an armed watchdog,
  leave the streams identical; an expired watchdog raises StepHangError.

Tolerances: none — event lists, text and tokens are compared exactly.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from midgpt_tpu import obs as j_obs
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.robustness import faults as j_faults
from midgpt_tpu.sampling import serve as jserve
from midgpt_tpu_torch import obs
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.robustness.errors import StepHangError
from midgpt_tpu_torch.robustness.watchdog import StepWatchdog
from midgpt_tpu_torch.sampling import graphs
from midgpt_tpu_torch.sampling import serve as tserve
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

CPU = torch.device("cpu")
SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
# 10 pages of 8 for 3 slots: the trace below forces preemptions
ENGINE = dict(max_slots=3, page_size=8, num_pages=10, prefill_chunk=16, decode_chunk=8, temperature=0.0,
              cache_dtype="float32")


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    j_faults.clear()
    yield
    faults.clear()
    j_faults.clear()


class _Clock:
    """Deterministic clock: each read advances by the next seeded step."""

    def __init__(self, seed=0):
        self._steps = iter(np.random.default_rng(seed).uniform(1e-4, 3e-3, 100_000))
        self.t = 10.0

    def __call__(self):
        self.t += float(next(self._steps))
        return self.t


def _record(tracer):
    """One event sequence: nested spans, explicit completes, instants with
    args, async pairs on two tids — 70 events into the tracer."""
    for i in range(10):
        with tracer.span("outer", "phase", "engine"):
            with tracer.span("inner", "", "train"):
                pass
            tracer.instant("admitted", "lifecycle", "engine", args={"uid": i, "slot": i % 3})
        tracer.complete("decode.dispatch", "round", "engine", 10.0 + i, 0.001 * i, args=None if i % 2 else {"i": i})
        tracer.async_begin("request", f"r{i}", "lifecycle", "engine", args={"uid": i})
        tracer.async_end("request", f"r{i}", "lifecycle", "server")
        tracer.instant("finish", tid="server")


@pytest.mark.parametrize("capacity", [16384, 25], ids=["roomy", "ring drops"])
def test_tracer_matches_jax(tmp_path, capacity):
    t = obs.Tracer(capacity=capacity, clock=_Clock())
    j = j_obs.Tracer(capacity=capacity, clock=_Clock())
    for tracer in (t, j):
        _record(tracer)
    assert t.events() == j.events() and len(t) == len(j)
    assert t.dropped == j.dropped == max(0, 70 - capacity)
    assert t.export() == j.export()
    t.dump(str(tmp_path / "t.json"))
    j.dump(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    t.clear()
    assert len(t) == 0 and t.dropped == 0 and t.export() == []


def test_null_tracer_matches_jax(tmp_path):
    for null in (obs.NULL_TRACER, j_obs.NULL_TRACER):
        _record(null)
        assert len(null) == 0 and null.events() == [] and null.export() == [] and null.dropped == 0
    obs.NULL_TRACER.dump(str(tmp_path / "t.json"))
    j_obs.NULL_TRACER.dump(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def _fill(registry, seed=0):
    rng = np.random.default_rng(seed)
    registry.counter("rounds", "rounds seen").inc()
    registry.counter("rounds").inc(2.5)
    registry.counter("odd.name-x").inc(7)
    registry.gauge("pages_free", "free pages").set(123)
    registry.gauge("zero")
    h = registry.histogram("latency_s", "round latency", maxlen=64)
    for v in rng.exponential(0.01, 200):  # 200 > maxlen: the reservoir keeps the newest 64
        h.observe(v)
    registry.histogram("empty", "never observed")
    small = registry.histogram("three")
    for v in (3.0, 1.0, 2.0):
        small.observe(v)
    return registry


def test_metrics_match_jax():
    t, j = _fill(obs.MetricsRegistry()), _fill(j_obs.MetricsRegistry())
    assert t.snapshot() == j.snapshot()
    assert t.to_prometheus() == j.to_prometheus()
    s = t.histogram("three").summary()
    assert (s["p50"], s["p95"], s["max"], s["n"]) == (2.0, 3.0, 3.0, 3)  # nearest rank
    assert t.counter("rounds") is t.counter("rounds")  # create-or-get


def test_observability_matches_jax(tmp_path):
    t, j = obs.Observability(clock=_Clock(1)), j_obs.Observability(clock=_Clock(1))
    rng = np.random.default_rng(3)
    for _ in range(40):
        t0, a, b, c, hid = (float(x) for x in rng.uniform(0, 0.01, 5))
        for o in (t, j):
            o.record_round("decode", "engine", t0, t0 + a, t0 + a + b, t0 + a + b + c, hidden_s=hid)
            o.tracer.instant("fault.poisoned_page", "fault", "engine")
    assert t.round_decomp() == j.round_decomp()
    assert t.snapshot() == j.snapshot()
    assert t.snapshot()["round_decomp"]["rounds"] == 40
    t.dump(str(tmp_path / "t"))
    j.dump(str(tmp_path / "j"))
    for name in ("flight_recorder.json", "flight_recorder.prom"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    assert obs.DISABLED_SNAPSHOT == j_obs.DISABLED_SNAPSHOT == {"enabled": False}


def test_flight_recorder_dumps_only_once_touched(tmp_path, monkeypatch):
    monkeypatch.setattr(obs, "_FLIGHT", None)
    assert obs.dump_flight_recorder(str(tmp_path / "a")) is None and not (tmp_path / "a").exists()
    rec = obs.flight_recorder()
    assert obs.flight_recorder() is rec
    rec.tracer.instant("train.preempt", "train", "train", args={"step": 3})
    path = obs.dump_flight_recorder(str(tmp_path / "b"))
    events = json.loads(open(path).read())["traceEvents"]
    assert events[0]["name"] == "train.preempt" and events[0]["args"] == {"step": 3}
    assert (tmp_path / "b" / "flight_recorder.prom").exists()


# ---------------------------------------------------------------- the engine under faults


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig(**SHAPE)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, GPTConfig(**SHAPE), _flatten(jp)


def _trace(seed=0, lengths=(5, 23, 11, 17), max_new=(30, 24, 40, 12)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, SHAPE["vocab_size"], n).astype(np.int32), m) for n, m in zip(lengths, max_new)]


def _port(weights, overlap, **kw):
    _, _, tcfg, flat = weights
    return tserve.ServeEngine(tcfg, params_from_numpy(flat, device=CPU), device=CPU, overlap=overlap,
                              attn_impl="gather", **ENGINE, **kw)


def _run(eng):
    uids = [eng.submit(p, m) for p, m in _trace()]
    done = eng.run()
    assert eng.allocator.free_count == eng.allocator.num_pages - 1, "page leak"
    return [np.asarray(done[u].tokens) for u in uids]


@pytest.fixture(scope="module")
def unfaulted(weights):
    return {mode: _run(_port(weights, mode)) for mode in ("off", "double")}


CASES = [
    ("off", "kill_mid_decode@4"),
    ("double", "kill_overlapped_round@3"),
    ("double", "kill_mid_decode@5"),
    ("off", "poisoned_page@4"),
    ("double", "poisoned_page@4"),
]


@pytest.mark.parametrize("overlap,plan", CASES, ids=[f"{o}-{p}" for o, p in CASES])
def test_engine_faults_match_jax(weights, unfaulted, overlap, plan):
    jcfg, jp, _, _ = weights
    j_faults.activate_plan(plan)
    j = jserve.ServeEngine(jcfg, jp, overlap=overlap, **ENGINE)
    want = _run(j)
    faults.activate_plan(plan)
    t = _port(weights, overlap)
    got = _run(t)
    kind = plan.split("@")[0]
    assert faults.fired_counts() == j_faults.fired_counts() == {kind: 1}
    assert t.poisoned_uids == j.poisoned_uids
    assert (t.decode_kills, t.overlap_kills, t.preemptions) == (j.decode_kills, j.overlap_kills, j.preemptions)
    assert t.stats()["decode_kills"] == t.decode_kills and t.stats()["poisoned_uids"] == t.poisoned_uids
    if kind == "poisoned_page":
        assert len(t.poisoned_uids) == 1
    else:
        assert t.preemptions > 0 and max(t.decode_kills, t.overlap_kills) == 1
    # Recompute preemption regenerates each stream exactly, so every stream
    # but the poisoned slot's equals the unfaulted run's. The JAX engine
    # breaks that where the poisoned page is freed and handed to another
    # request before its columns are rewritten (0 * NaN through the masked
    # columns); the port scrubs the page when it is freed, so it departs
    # from JAX exactly there — pinned here. A poisoned slot's own stream is
    # garbage by design (after a scrub the port's may recover where JAX's
    # does not), so it is not compared.
    leaked = [i for i, (w, u) in enumerate(zip(want, unfaulted[overlap]))
              if i not in j.poisoned_uids and not np.array_equal(w, u)]
    assert leaked == ([0] if (overlap, plan) == ("double", "poisoned_page@4") else [])
    for i, (g, w, u) in enumerate(zip(got, want, unfaulted[overlap])):
        if i in t.poisoned_uids:
            continue
        np.testing.assert_array_equal(g, u, err_msg=f"request {i} vs the unfaulted run")
        if i not in leaked:
            np.testing.assert_array_equal(g, w, err_msg=f"request {i} vs JAX")
    if kind != "poisoned_page":  # no scrub in play: every stream equals JAX's
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("overlap", ["off", "double"])
def test_obs_and_watchdog_leave_streams_identical(weights, unfaulted, overlap):
    o = obs.Observability()
    wd = StepWatchdog(60.0)
    eng = _port(weights, overlap, obs=o, watchdog=wd)
    for i, (g, u) in enumerate(zip(_run(eng), unfaulted[overlap])):
        np.testing.assert_array_equal(g, u, err_msg=f"request {i}")
    snap = eng.stats()["obs"]
    assert snap["enabled"] and snap["round_decomp"]["rounds"] > 0 and snap["spans_dropped"] == 0
    names = {e["name"] for e in o.tracer.export()}
    assert {"engine.round", "engine.expire", "engine.admit", "engine.prefill", "prefill.chunk",
            "prefill.first_token", "decode.dispatch", "decode.device_wait", "decode.host_post",
            "admitted", "preempt", "finish"} <= names
    assert wd.syncs == snap["round_decomp"]["rounds"] and wd.expiries == 0
    assert _port(weights, overlap).stats()["obs"] == {"enabled": False}


def test_expired_engine_watchdog_raises(weights, monkeypatch):
    """A settle whose force never lands: the engine's watchdog raises
    StepHangError instead of hanging the server."""
    never = threading.Event()
    monkeypatch.setattr(graphs.GroupResult, "host", lambda self: never.wait())
    eng = _port(weights, "double", watchdog=StepWatchdog(0.2, poll_s=0.01))
    for p, m in _trace():
        eng.submit(p, m)
    try:
        with pytest.raises(StepHangError, match="serve.overlap_sync") as ei:
            for _ in range(10):
                eng.step()
        assert ei.value.waited_s >= 0.2 and eng.watchdog.expiries == 1
    finally:
        never.set()
