"""Port parity, serving chaos (robustness/chaos_serve.py) and the fleet on
real engines, against JAX's midgpt_tpu/robustness/chaos_serve.py and
midgpt_tpu/sampling/fleet.py, with the tiny model's weights carried across
(the port's `_tiny_model` returns JAX's, converted).

* `run_serving_chaos`: the port's summary equals JAX's for the same plan
  and seed: submit_storm, engine_crash, spill_corrupt and handoff_stall
  here; the other seven in-process plans under `-m slow` (the hot swap's
  checkpoint differs in format, so its version and latency are not
  compared, nor which clients slow_client's bounded buffer sheds: that
  depends on when the consumer tasks run).
* FleetRouter on those engines (2 replicas of 31 pages, f32, greedy): the
  streams, crash log and failed-over streams of an `engine_crash` run, and
  the streams, spill ledger and re-adopted pages of a staged spill equal
  JAX's (exact), and every stream equals a single engine's.
* The entry point prints one JSON line with `tools/chaos_run.py --serve`'s
  keys plus `device`; the one kind the port does not hook (resume_reshard)
  is refused. (The worker-process kinds run in tests/test_torch_fleet_proc.py.)
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.analysis.bench_contract import parse_single_json_line
from midgpt_tpu.robustness import chaos_serve as j_chaos
from midgpt_tpu.robustness import faults as j_faults
from midgpt_tpu.sampling import fleet as j_fleet
from midgpt_tpu.sampling import serve as j_serve
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.robustness import chaos_serve, faults
from midgpt_tpu_torch.sampling import fleet, serve

CPU = torch.device("cpu")
FAST_PLANS = ["submit_storm@2", "engine_crash@6", "spill_corrupt", "handoff_stall"]
SLOW_PLANS = [("kill_mid_decode@6", 5), ("kill_overlapped_round@6", 5), ("poisoned_page@3", 5), ("slow_client@1", 5),
              ("evict_shared_prefix@7", 6), ("hot_swap_mid_decode@5", 5), ("pool_resize@4,pool_resize@8", 5)]
ENGINE = dict(max_slots=3, page_size=8, num_pages=31, prefill_chunk=16, decode_chunk=4, temperature=0.0,
              prefix_cache=True)


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


def _flat(jp):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny model at seed 0 and the port's copy of it."""
    cfg, jp = j_chaos._tiny_model(0)
    pcfg = GPTConfig(block_size=cfg.block_size, vocab_size=cfg.vocab_size, n_layer=cfg.n_layer, n_head=cfg.n_head,
                     n_embd=cfg.n_embd)
    assert pcfg == chaos_serve._tiny_cfg()
    return jp, params_from_numpy(_flat(jp), device=CPU)


@pytest.fixture
def port_weights(tiny, monkeypatch):
    """The port's scenarios on JAX's weights."""
    monkeypatch.setattr(chaos_serve, "_tiny_model", lambda seed, device: (chaos_serve._tiny_cfg(), tiny[1]))


def _fleet_runs(fmod, make):
    """An engine_crash@6 run and a staged spill (the first request alone,
    both tries flushed, the rest re-adopting), both through the port's
    `drive_fleet` (one arrival per round), which drives either router."""
    fm = faults if fmod is fleet else j_faults
    flush = None if fmod is fleet else (lambda eng: eng._evict_shared_prefix_fault())
    trace = j_chaos._trace(j_chaos._tiny_cfg(), 1, 6, shared=True)
    out = {}
    fm.activate("engine_crash", step=6)
    router = fmod.FleetRouter([make(), make()])
    uids = list(chaos_serve.drive_fleet(router, trace))
    fm.clear()
    fmod.assert_fleet_conserved(router, "crash")
    st = router.stats()
    out["crash"] = ([router.finished[u].tokens.tolist() for u in uids], st["crash_log"], st["failed_over_streams"],
                    st["alive"], st["prefix_hit_rate"], st["spill"])
    router = fmod.FleetRouter([make(), make()])
    uids = list(chaos_serve.drive_fleet(router, trace, stage_spill=True, flush=flush))
    fmod.assert_fleet_conserved(router, "spill")
    out["spill"] = ([router.finished[u].tokens.tolist() for u in uids], router.spill.stats(),
                    [e.spill_readopted_pages for e in router.engines], router.prefix_hit_rate())
    return out


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """One JAX reference pass for the module (its engines compile): the
    fast plans' summaries and the fleet runs."""
    jp, _ = tiny
    out = {plan: j_chaos.run_serving_chaos(plan, seed=0) for plan in FAST_PLANS}
    out["fleet"] = _fleet_runs(j_fleet, lambda: j_serve.ServeEngine(j_chaos._tiny_cfg(), jp, cache_dtype=jnp.float32,
                                                                    **ENGINE))
    return out


@pytest.mark.parametrize("plan", FAST_PLANS)
def test_chaos_summary_equals_jax(jax_ref, port_weights, plan):
    got = chaos_serve.run_serving_chaos(plan, seed=0, device="cpu")
    assert got == jax_ref[plan]
    kind = plan.split("@")[0]
    assert got["faults_fired"] == {kind: 1} and got["parity_ok"] == got["parity_checked"] >= 1
    if kind == "engine_crash":
        assert got["failovers"] == 1 and got["failed_over_streams"] >= 1 and got["statuses"] == {"ok": 5}
    if kind == "spill_corrupt":
        assert got["spill"]["corrupt_discarded"] >= 1
    if kind == "handoff_stall":
        assert got["spill"]["stall_fallbacks"] >= 1
    if kind == "submit_storm":
        assert got["shed"] >= 1


@pytest.mark.slow
@pytest.mark.parametrize("plan,n", SLOW_PLANS)
def test_chaos_summary_equals_jax_slow(port_weights, plan, n):
    got = chaos_serve.run_serving_chaos(plan, seed=0, n_requests=n, device="cpu")
    want = j_chaos.run_serving_chaos(plan, seed=0, n_requests=n)
    if "hot_swap" in plan:
        # the checkpoint (and so the version hash) and the flip's latency differ
        for s in (got, want):
            s.pop("weights_version")
            s["swap"].pop("swap_latency_s")
    if "slow_client" in plan:
        # which clients a bounded buffer sheds depends on when the consumer
        # tasks run (host timing); the victim's shed and everyone's parity do not
        assert set(got) == set(want) and got["faults_fired"] == want["faults_fired"]
        assert got["statuses"]["slow_client"] >= 1 and got["parity_ok"] == got["parity_checked"] >= 1
        assert want["parity_ok"] == want["parity_checked"]
        return
    if "pool_resize" in plan:
        for s in (got, want):
            for r in s["resizes"]:
                r.pop("migrate_s", None)
                r.pop("gather_bucket", None)
    assert got == want


@pytest.mark.parametrize("run", ["crash", "spill"])
def test_fleet_streams_equal_jax(tiny, jax_ref, run):
    _, pp = tiny
    make = lambda: serve.ServeEngine(chaos_serve._tiny_cfg(), pp, cache_dtype=torch.float32, device=CPU, **ENGINE)
    got = _fleet_runs(fleet, make)[run]
    assert got == jax_ref["fleet"][run]
    if run == "crash":
        assert got[1][0]["reason"] == "fault" and got[2] >= 1 and got[3] == 1
    else:
        assert got[1]["readopted"] >= 1 and sum(got[2]) == got[1]["readopted"]
    single = make()
    uids = [single.submit(p, m) for p, m in j_chaos._trace(j_chaos._tiny_cfg(), 1, 6, shared=True)]
    single.run()
    assert got[0] == [single.finished[u].tokens.tolist() for u in uids]


def test_entry_point_prints_chaos_run_line(jax_ref, capsys):
    assert chaos_serve.main(["--device", "cpu", "--fault", "engine_crash@6"]) == 0
    rec, problems = parse_single_json_line(capsys.readouterr().out)
    assert not problems, problems
    assert set(rec) == {"tool", "mode", "status", "wall_s", "faults_requested", "device"} | set(jax_ref["engine_crash@6"])
    assert rec["tool"] == "chaos_run" and rec["mode"] == "serve" and rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["faults_requested"] == ["engine_crash@6"] and rec["faults_fired"] == {"engine_crash": 1}
    # a training kind never fires in serving: refused as JAX's serving chaos tool refuses it
    assert chaos_serve.main(["--device", "cpu", "--fault", "resume_reshard@3"]) == 1
    rec, problems = parse_single_json_line(capsys.readouterr().out)
    assert not problems and rec["status"] == "failed" and "no armed fault fired" in rec["error"]
    assert set(chaos_serve.PROC_KINDS) <= set(faults.HOOKED)
