"""Port parity, robustness slice: the supervisor (rollback with the data
window skipped, hang restarts, the budget, the ledger), preemption
(emergency saves, the grace budget, the signal handlers), the hung-step
watchdog, the fault registry and the checkpoint faults of
midgpt_tpu_torch/robustness and training/, against midgpt_tpu's.

All on the CPU in float32 at a tiny size (2 layers, width 64, T 32),
seeded synthetic bins, backoffs 0. One JAX runtime (one device) serves the
module's JAX runs. Tolerances: the port's supervised losses against JAX's,
rtol 1e-5 (the train-step tolerance of tests/test_torch_train.py); a
resumed port run against the port's straight run, rtol 1e-6 (JAX's own,
tests/test_robustness.py); an armed watchdog, bit for bit.
"""

import json
import os
import signal
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.parallel.mesh import make_mesh
from midgpt_tpu.robustness import faults as j_faults
from midgpt_tpu.robustness import preempt as j_preempt
from midgpt_tpu.robustness.supervisor import supervise as j_supervise
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_runtime as j_make_runtime
from midgpt_tpu_torch import launch
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.robustness import faults, preempt
from midgpt_tpu_torch.robustness import supervisor as sup_mod
from midgpt_tpu_torch.robustness import watchdog as wd_mod
from midgpt_tpu_torch.robustness.errors import (
    CheckpointWriteError,
    DivergenceError,
    SimulatedPreemption,
    StepHangError,
)
from midgpt_tpu_torch.robustness.supervisor import supervise
from midgpt_tpu_torch.robustness.watchdog import StepWatchdog
from midgpt_tpu_torch.training import checkpoint as ckpt
from midgpt_tpu_torch.training import train as train_mod
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.train import train

CPU = torch.device("cpu")
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=64, attn_impl="naive")
# 12 steps, saves at 0, 4, 8 and the final 11; a fault at data step 6 is
# caught at its log sync, past the step-4 save.
BASE = dict(
    rundir="", learning_rate=1e-2, batch_size=4, warmup_steps=2, min_lr=1e-3, lr_decay_steps=12,
    max_steps=12, beta2=0.95, weight_decay=1e-4, eval_interval=4, param_dtype="float32",
    compute_dtype="float32", g_accum_iters=1, shard_model=False, eval_steps=1, log_interval=1,
    restart_backoff_sec=0.0, ckpt_retry_backoff_sec=0.0,
)
K = 6


def _configs(data_dir, **over):
    base = dict(BASE, data_dir=str(data_dir), **over)
    j = JExperimentConfig(**base, mesh=JMeshConfig(data=1, fsdp=1, sp=1), model_config=JGPTConfig(**MODEL))
    t = ExperimentConfig(**base, mesh=MeshConfig(data=1, fsdp=1, sp=1), model_config=GPTConfig(**MODEL))
    return j, t


def _config(data_dir, **over) -> ExperimentConfig:
    return _configs(data_dir, **over)[1]


def _flatten(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _logged(rundir) -> dict:
    """{step: loss/optimized}, later lines (a restarted attempt's) winning."""
    out = {}
    for line in Path(rundir, "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "loss/optimized" in rec:
            out[rec["step"]] = rec["loss/optimized"]
    return out


def _ledger(rundir) -> dict:
    return json.loads(Path(rundir, sup_mod.STATE_NAME).read_text())


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    preempt.reset()
    j_faults.clear()
    j_preempt.reset()
    yield
    faults.clear()
    preempt.reset()
    j_faults.clear()
    j_preempt.reset()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A learnable stream: token[i+1] = (token[i] + 1) % 17, with noise."""
    d = tmp_path_factory.mktemp("stream")
    r = np.random.default_rng(0)
    stream = np.where(r.random(20000) < 0.1, r.integers(0, 64, 20000), np.arange(20000) % 17)
    stream.astype(np.uint16).tofile(d / "train.bin")
    stream[:4000].astype(np.uint16).tofile(d / "val.bin")
    return d


@pytest.fixture(scope="module")
def jax_runs(data_dir, tmp_path_factory):
    """JAX's supervised runs on one device, sharing one runtime: under
    nan_grad@K and under hang_step@K with a 0.3 s watchdog. Returns
    {plan: (result, rundir)} and JAX's initial parameters."""
    jc, _ = _configs(data_dir)
    rt = j_make_runtime(jc, devices=jax.devices()[:1])
    init = _flatten(j_init_state(jc, make_mesh(jc.mesh, devices=jax.devices()[:1]))[0])
    runs = {}
    for plan, over in ((f"nan_grad@{K}", {}), (f"hang_step@{K}", {"watchdog_deadline_s": 0.3})):
        rundir = tmp_path_factory.mktemp("jax")
        j_faults.clear()
        try:
            cfg = jc.replace(rundir=str(rundir), fault_plan=plan, **over)
            runs[plan] = (j_supervise(cfg, runtime=rt, sleep_fn=lambda s: None), rundir)
        finally:
            j_faults.clear()
    return runs, init


@pytest.fixture
def jax_init(jax_runs, monkeypatch):
    """Start the port's runs from JAX's initial parameters."""
    flat = jax_runs[1]
    real = train_mod.init_state

    def init_state(config, device=None):
        params, _, optimizer = real(config, device)
        params = params_from_numpy(flat, device=CPU)
        return params, optimizer.init(params), optimizer

    monkeypatch.setattr(train_mod, "init_state", init_state)


@pytest.fixture(scope="module")
def straight(data_dir, tmp_path_factory):
    """The port's uninterrupted 12-step run (its own init)."""
    rundir = tmp_path_factory.mktemp("straight")
    return train(_config(data_dir, rundir=str(rundir)), device=CPU), rundir


# ---------------------------------------------------------------- the supervisor against JAX's


def test_supervisor_rollback_matches_jax(data_dir, jax_runs, jax_init, tmp_path):
    """nan_grad@K: both supervisors roll back to step 4, skip the data window
    [5, 6] and move the offset by 2; equal ledgers, and the port's logged
    losses (the rolled-back attempt's from step 5 on) equal JAX's."""
    j_result, j_dir = jax_runs[0][f"nan_grad@{K}"]
    result = supervise(_config(data_dir, rundir=str(tmp_path), fault_plan=f"nan_grad@{K}"), device=CPU)
    sup, j_sup = result["supervisor"], j_result["supervisor"]
    for key in ("data_step_offset", "windows_skipped", "restarts", "hung_steps", "faults_fired"):
        assert sup[key] == j_sup[key], key
    assert sup["windows_skipped"] == [[5, 6]] and sup["data_step_offset"] == 2
    ledger, j_ledger = _ledger(tmp_path), _ledger(j_dir)
    for key in ("data_step_offset", "windows_skipped", "restarts", "hung_steps"):
        assert ledger[key] == j_ledger[key], key
    assert ledger["mesh"] == {"n_devices": 1, "axes": {"data": 1}}
    got, want = _logged(tmp_path), _logged(j_dir)
    assert sorted(got) == sorted(want) == list(range(12))
    np.testing.assert_allclose([got[s] for s in range(12)], [want[s] for s in range(12)], rtol=1e-5)
    np.testing.assert_allclose(result["metrics"]["loss/final"], j_result["metrics"]["loss/final"], rtol=1e-5)
    assert (tmp_path / "flight_recorder.json").exists()
    events = [e["name"] for e in json.loads((tmp_path / "flight_recorder.json").read_text())["traceEvents"]]
    assert {"train.step", "train.eval", "train.divergence"} <= set(events)


def test_supervisor_hang_restart_matches_jax(data_dir, jax_runs, jax_init, tmp_path):
    """hang_step@K with a 0.3 s watchdog: the sync at step K never lands, the
    watchdog dumps the recorder and raises, the supervisor marks the step
    hung and restarts from step 4 WITHOUT moving the offset; equal ledgers,
    and the replay's losses equal JAX's."""
    j_result, j_dir = jax_runs[0][f"hang_step@{K}"]
    cfg = _config(data_dir, rundir=str(tmp_path), fault_plan=f"hang_step@{K}", watchdog_deadline_s=0.3)
    result = supervise(cfg, device=CPU)
    sup, j_sup = result["supervisor"], j_result["supervisor"]
    assert sup["hung_steps"] == j_sup["hung_steps"] == [K]
    assert sup["restarts"] == j_sup["restarts"] == 1
    assert sup["data_step_offset"] == j_sup["data_step_offset"] == 0
    assert sup["faults_fired"] == j_sup["faults_fired"] == {"hang_step": 1}
    assert _ledger(tmp_path)["hung_steps"] == _ledger(j_dir)["hung_steps"] == [K]
    assert (tmp_path / "flight_recorder.json").exists() and (tmp_path / "flight_recorder.prom").exists()
    got, want = _logged(tmp_path), _logged(j_dir)
    np.testing.assert_allclose([got[s] for s in range(12)], [want[s] for s in range(12)], rtol=1e-5)


# ---------------------------------------------------------------- the supervisor, port only


def test_supervisor_budget_exhaustion_diagnosis(data_dir, tmp_path):
    cfg = _config(data_dir, rundir=str(tmp_path), fault_plan=f"nan_grad@{K}", max_restarts=0)
    with pytest.raises(RuntimeError, match=r"budget \(0\) exhausted.*\[5, 6\]"):
        supervise(cfg, device=CPU)


def test_supervisor_no_checkpoint_fails_loudly(data_dir):
    """A divergence with nothing saved (no rundir): nothing to roll back to."""
    with pytest.raises(RuntimeError, match="NO verified checkpoint"):
        supervise(_config(data_dir, fault_plan="nan_grad@3"), device=CPU)


def test_divergence_error_carries_structure(data_dir, tmp_path):
    faults.activate_plan(f"nan_grad@{K}")
    with pytest.raises(DivergenceError) as ei:
        train(_config(data_dir, rundir=str(tmp_path)), device=CPU)
    e = ei.value
    assert (e.step, e.last_good_step, e.rundir) == (K, 4, str(tmp_path))
    assert isinstance(e, FloatingPointError)


def test_on_resume_mesh_refuses_another_device_count(data_dir, tmp_path):
    sup_mod._save_state(str(tmp_path), {"mesh": {"n_devices": 4, "axes": {"data": 1, "fsdp": 4}}})
    with pytest.raises(RuntimeError, match="on_resume_mesh='same' refuses"):
        supervise(_config(data_dir, rundir=str(tmp_path)), device=CPU)
    with pytest.raises(NotImplementedError, match="item 8"):
        supervise(_config(data_dir, rundir=str(tmp_path), on_resume_mesh="any"), device=CPU)


def test_corrupt_ledger_quarantined(tmp_path, capsys):
    path = tmp_path / sup_mod.STATE_NAME
    path.write_text('{"data_step_offset": 3, "windo')  # torn mid-write
    assert sup_mod._load_state(str(tmp_path)) == {}
    assert Path(str(path) + ".corrupt").exists() and not path.exists()
    assert "quarantined" in capsys.readouterr().out
    sup_mod.append_note(str(tmp_path), {"event": "x"})
    assert sup_mod._load_state(str(tmp_path))["notes"] == [{"event": "x"}]
    path.write_text("[1, 2]")  # not an object: corrupt too
    assert sup_mod._load_state(str(tmp_path)) == {}
    assert "quarantined" in capsys.readouterr().out


# ---------------------------------------------------------------- preemption


def test_preemption_emergency_save_and_exact_resume(data_dir, straight, tmp_path):
    """preempt@5: the emergency save lands at step 5, verified; no final
    eval; a rerun resumes there and continues the straight run."""
    straight_result, straight_dir = straight
    cfg = _config(data_dir, rundir=str(tmp_path), fault_plan="preempt@5")
    interrupted = supervise(cfg, device=CPU)
    assert interrupted["metrics"]["preempted"] is True and "loss/final" not in interrupted["metrics"]
    assert CheckpointManager(str(tmp_path)).latest_verified_step() == 5
    assert (tmp_path / "flight_recorder.json").exists()
    preempt.reset()
    resumed = train(_config(data_dir, rundir=str(tmp_path)), device=CPU)
    assert resumed["resumed_from"] == 5
    a, b = _logged(straight_dir), _logged(tmp_path)
    np.testing.assert_allclose([b[s] for s in range(12)], [a[s] for s in range(12)], rtol=1e-6)
    np.testing.assert_allclose(resumed["metrics"]["loss/final"], straight_result["metrics"]["loss/final"], rtol=1e-6)


def test_preempt_grace_budget_skips_save_loudly(data_dir, tmp_path, capsys):
    """The grace budget is spent before the save could start: no step-6
    checkpoint, a ledger note, a recorder dump, a loud line."""
    cfg = _config(data_dir, rundir=str(tmp_path), fault_plan="preempt@6", preempt_grace_s=1e-9)
    result = supervise(cfg, device=CPU)
    assert result["metrics"]["preempted"] is True
    assert CheckpointManager(str(tmp_path)).latest_verified_step() == 4
    notes = _ledger(tmp_path)["notes"]
    assert {"event": "preempt_save_skipped", "step": 6, "grace_s": 1e-9} in notes
    assert (tmp_path / "flight_recorder.json").exists()
    assert "skipping the emergency save" in capsys.readouterr().out


def test_sigterm_handler_sets_flag_one_shot():
    """The real signal path: SIGTERM sets the flag and arms the grace clock;
    the handler is one-shot (the previous one is back); reset restores."""
    original = signal.getsignal(signal.SIGTERM)
    preempt.install_handlers((signal.SIGTERM,))
    try:
        assert signal.getsignal(signal.SIGTERM) is preempt.request
        assert not preempt.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert preempt.requested() and preempt.any_host_requested()
        assert preempt.requested_at() is not None
        assert signal.getsignal(signal.SIGTERM) is original  # one-shot
    finally:
        preempt.reset()
    assert not preempt.requested() and preempt.requested_at() is None
    assert signal.getsignal(signal.SIGTERM) is original


def test_launch_supervises_and_restores_the_handlers(data_dir, tmp_path, monkeypatch):
    """The launcher runs under the supervisor (the fault plan takes effect)
    with the handlers installed, and restores the caller's on return; a
    plan naming an unhooked kind is refused before training."""
    original = signal.getsignal(signal.SIGINT)
    seen, real = [], sup_mod.supervise

    def spy(config, **kw):
        seen.append(signal.getsignal(signal.SIGTERM) is preempt.request)
        return real(config, **kw)

    monkeypatch.setattr(sup_mod, "supervise", spy)
    sets = {"data_dir": data_dir, "max_steps": 8, "eval_interval": 4, "eval_steps": 1, "batch_size": 4,
            "g_accum_iters": 1, "log_interval": 1, "spec_layers": 0, "restart_backoff_sec": 0,
            "fault_plan": "nan_grad@5", "model_config.block_size": 32, "model_config.n_layer": 2,
            "model_config.n_embd": 64, "model_config.n_head": 2, "model_config.vocab_size": 64}
    args = ["--config=local_text_124m", "--device=cpu", f"--rundir={tmp_path}"]
    result = launch.main(args + [a for k, v in sets.items() for a in ("--set", f"{k}={v}")])
    assert seen == [True]
    assert result["supervisor"]["restarts"] == 1 and result["supervisor"]["faults_fired"] == {"nan_grad": 1}
    assert signal.getsignal(signal.SIGINT) is original
    sets["fault_plan"] = "slow_client@2"
    with pytest.raises(NotImplementedError, match="slow_client"):
        launch.main(args + [a for k, v in sets.items() for a in ("--set", f"{k}={v}")])
    assert signal.getsignal(signal.SIGINT) is original


def test_sigterm_to_a_launcher_saves_and_exits_cleanly(data_dir, tmp_path):
    """A real SIGTERM to a launcher subprocess once step 2 is logged: one
    emergency save at the next step boundary, verified, a dumped flight
    recorder holding `train.preempt`, and exit code 0."""
    import subprocess
    import time

    sets = {"data_dir": data_dir, "max_steps": 400, "eval_interval": 1000, "eval_steps": 1, "batch_size": 4,
            "g_accum_iters": 1, "log_interval": 1, "spec_layers": 0, "preempt_grace_s": 60,
            "model_config.block_size": 32, "model_config.n_layer": 2, "model_config.n_embd": 64,
            "model_config.n_head": 2, "model_config.vocab_size": 64}
    argv = [sys.executable, "-m", "midgpt_tpu_torch.launch", "--config=local_text_124m", "--device=cpu",
            f"--rundir={tmp_path}", *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(argv, cwd=Path(__file__).resolve().parent.parent, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not (tmp_path / "metrics.jsonl").exists() or 2 not in _logged_complete(tmp_path):
            assert proc.poll() is None and time.time() < deadline
            time.sleep(0.005)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    said = [line for line in out.splitlines() if line.startswith("preemption: emergency checkpoint at step")]
    assert len(said) == 1, out
    boundary = int(said[0].split("step ")[1].split()[0])
    assert 2 <= boundary < 399 and CheckpointManager(str(tmp_path)).latest_verified_step() == boundary
    events = json.loads((tmp_path / "flight_recorder.json").read_text())["traceEvents"]
    assert any(e["name"] == "train.preempt" and e["args"] == {"step": boundary} for e in events)


def _logged_complete(rundir) -> set:
    """Steps a running launcher has logged a loss for (complete lines only)."""
    lines = Path(rundir, "metrics.jsonl").read_text().split("\n")[:-1]
    return {rec["step"] for rec in map(json.loads, lines) if "loss/optimized" in rec}


# ---------------------------------------------------------------- the watchdog


def test_watchdog_armed_is_invisible(data_dir, straight, tmp_path):
    """An armed watchdog that never expires changes nothing: bit-identical
    logged losses."""
    _, straight_dir = straight
    train(_config(data_dir, rundir=str(tmp_path), watchdog_deadline_s=60.0), device=CPU)
    a, b = _logged(straight_dir), _logged(tmp_path)
    assert sorted(a) == sorted(b)
    assert [a[s] for s in sorted(a)] == [b[s] for s in sorted(b)]


class _FakeClock:
    """Advances `dt` per read; raises when `armed` is False (no read allowed)."""

    def __init__(self, dt=0.5, armed=True):
        self.t, self.dt, self.armed, self.reads = 0.0, dt, armed, 0

    def __call__(self):
        assert self.armed, "the clock was read"
        self.reads += 1
        self.t += self.dt
        return self.t


def test_watchdog_disabled_is_a_plain_call():
    clock = _FakeClock(armed=False)
    wd = StepWatchdog(0.0, clock=clock)
    before = threading.active_count()
    assert not wd.enabled and wd.sync(lambda: 42) == 42
    assert threading.active_count() == before and wd.syncs == 0


def test_watchdog_returns_value_and_propagates_errors():
    wd = StepWatchdog(100.0, clock=_FakeClock(dt=0.0), poll_s=0.001)
    assert wd.sync(lambda: "landed") == "landed"

    def boom():
        raise KeyError("inner")

    with pytest.raises(KeyError, match="inner"):
        wd.sync(boom)
    assert wd.syncs == 2 and wd.expiries == 0


def test_watchdog_expiry_raises_dumps_and_calls_hook(tmp_path):
    """A sync that never lands: expiry on the fake clock (0.5 s a read against
    a 2 s deadline), the instant and dump first, then the hook, then
    StepHangError with the step and the wait."""
    calls, never = [], threading.Event()
    wd = StepWatchdog(2.0, rundir=str(tmp_path), clock=_FakeClock(dt=0.5), poll_s=0.001,
                      on_expire=lambda step, waited: calls.append((step, waited)))
    with pytest.raises(StepHangError) as ei:
        wd.sync(never.wait, step=7, label="unit")
    e = ei.value
    assert e.step == 7 and 2.0 <= e.waited_s < 2.5 and e.rundir == str(tmp_path)
    assert calls == [(7, e.waited_s)] and wd.expiries == 1
    events = json.loads((tmp_path / "flight_recorder.json").read_text())["traceEvents"]
    assert any(ev["name"] == "watchdog.expired" and ev["args"]["step"] == 7 for ev in events)
    assert (tmp_path / "flight_recorder.prom").exists()
    never.set()  # let the abandoned worker end


def test_watchdog_exit_escalation(monkeypatch):
    codes, never = [], threading.Event()

    def fake_exit(code):
        codes.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(wd_mod.os, "_exit", fake_exit)
    wd = StepWatchdog(1.0, escalate="exit", clock=_FakeClock(dt=0.5), poll_s=0.001)
    with pytest.raises(SystemExit):
        wd.sync(never.wait)
    assert codes == [wd_mod.EXIT_CODE] == [17]
    never.set()
    with pytest.raises(ValueError, match="escalate"):
        StepWatchdog(1.0, escalate="ignore")


# ---------------------------------------------------------------- the fault registry


def test_registry_matches_jax_and_fires_as_jax_does():
    assert faults.KINDS == j_faults.KINDS and set(faults.DESCRIPTIONS) == set(j_faults.DESCRIPTIONS)
    assert all(faults.DESCRIPTIONS[k] == j_faults.DESCRIPTIONS[k] for k in faults.HOOKED)
    for reg in (faults, j_faults):
        reg.activate_plan("nan_grad@12,ckpt_io_error*2, hang_step@3*2")
    for reg in (faults, j_faults):
        fired = [reg.should_fire("nan_grad", step=11), reg.should_fire("nan_grad", step=12),
                 reg.should_fire("nan_grad", step=12), reg.should_fire("ckpt_io_error"),
                 reg.should_fire("ckpt_io_error", step=5), reg.should_fire("ckpt_io_error"),
                 reg.should_fire("hang_step"), reg.should_fire("hang_step", step=3),
                 reg.should_fire("hang_step", step=3), reg.should_fire("hang_step", step=3)]
        assert fired == [False, True, False, True, True, False, False, True, True, False]
    assert faults.fired_counts() == j_faults.fired_counts() == {"nan_grad": 1, "ckpt_io_error": 2, "hang_step": 2}
    for bad in ("nan_grad@x", "@3", "nan grad"):
        with pytest.raises(ValueError, match="bad fault spec"):
            faults.activate_plan(bad)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.activate("no_such_kind")


@pytest.mark.parametrize("kind", sorted(faults.UNHOOKED))
def test_unhooked_kind_raises_on_activation(kind):
    with pytest.raises(NotImplementedError, match=rf"{kind}.*ROADMAP.md"):
        faults.activate(kind)
    with pytest.raises(NotImplementedError):
        faults.activate_plan(f"nan_grad@3,{kind}@2")
    assert faults.active() == []  # nothing of the plan was activated
    assert kind not in faults.HOOKED and set(faults.HOOKED) | set(faults.UNHOOKED) == set(faults.KINDS)


def test_should_fire_is_exact_under_threads():
    """Eight threads consume one 2,000-firing fault under a 1 µs switch
    interval: exactly 2,000 firings, none lost or doubled."""
    faults.activate("ckpt_io_error", times=2000)
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def consume():
            got.append(sum(faults.should_fire("ckpt_io_error") for _ in range(400)))

        threads = [threading.Thread(target=consume) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sum(got) == 2000 and faults.fired_counts() == {"ckpt_io_error": 2000}


@pytest.mark.parametrize("field,value,match", [
    ("watchdog_deadline_s", -1.0, "must be >= 0"),
    ("watchdog_escalate", "ignore", "unknown watchdog_escalate"),
    ("on_resume_mesh", "some", "unknown on_resume_mesh"),
    ("preempt_grace_s", -1.0, "preempt_grace_s=-1.0 must be >= 0"),
])
def test_config_rejects_bad_supervisor_knobs_as_jax_does(data_dir, field, value, match):
    jc, tc = _configs(data_dir)
    for cfg in (jc, tc):
        with pytest.raises(ValueError, match=match):
            cfg.replace(**{field: value})


# ---------------------------------------------------------------- checkpoint faults


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 32, generator=g), "b": torch.randn(32, generator=g)}


@pytest.mark.parametrize("kind", ["ckpt_io_error", "ckpt_enospc"])
def test_transient_write_faults_are_retried(tmp_path, kind):
    faults.activate(kind, times=2)
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1, write_retries=3, retry_backoff_sec=0.0)
    mngr.save(0, {"params": _params()})
    mngr.wait()
    assert faults.fired_counts() == {kind: 2} and mngr.history[0]["attempts"] == 3
    assert mngr.verified_steps() == [0] and sorted(os.listdir(tmp_path / "0")) == [
        "format.json", "midgpt_manifest.json", "params.npz"]  # the partial bytes were swept
    mngr.close()


def test_enospc_budget_exhaustion_leaves_no_partial(tmp_path):
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1, write_retries=2, retry_backoff_sec=0.0)
    kept = _params()
    mngr.save(1, {"params": kept})
    mngr.wait()
    faults.activate("ckpt_enospc", times=5)
    mngr.save(2, {"params": _params(1)})
    with pytest.raises(CheckpointWriteError, match="2 attempt"):
        mngr.wait()
    assert not (tmp_path / "2").exists() and mngr.latest_verified_step() == 1
    assert torch.equal(mngr.restore(1, {"params": kept})["params"]["w"], kept["w"])
    mngr.close()


@pytest.mark.parametrize("barrier", ["save", "wait", "close"])
def test_kill_mid_save_strikes_in_the_writer_thread(tmp_path, barrier):
    """kill_mid_save@2: the writer thread lands the items, truncates one and
    dies before the manifest; the next barrier raises the same
    SimulatedPreemption (never retried: one attempt), the partial step stays
    un-manifested and the verified step 1 survives."""
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1, max_to_keep=1, retry_backoff_sec=0.0)
    mngr.save(1, {"params": _params()})
    mngr.wait()
    faults.activate("kill_mid_save", step=2)
    mngr.save(2, {"params": _params(1)})
    with pytest.raises(SimulatedPreemption, match="step 2"):
        {"save": lambda: mngr.save(3, {"params": _params(2)}), "wait": mngr.wait, "close": mngr.close}[barrier]()
    assert mngr.history[1]["attempts"] == 1 and faults.fired_counts() == {"kill_mid_save": 1}
    assert (tmp_path / "2" / "params.npz").exists() and not (tmp_path / "2" / ckpt.MANIFEST_NAME).exists()
    assert mngr.latest_verified_step() == 1 and mngr.verified_steps() == [1]
    mngr.close()


def test_truncate_after_manifest_is_caught_at_the_barrier(tmp_path, capsys):
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1, max_to_keep=1)
    mngr.save(1, {"params": _params()})
    mngr.wait()
    faults.activate("truncate_ckpt_item", step=2)
    mngr.save(2, {"params": _params(1)})
    mngr.wait()
    assert "step 2 failed post-save verification" in capsys.readouterr().out
    assert (tmp_path / "2" / ckpt.MANIFEST_NAME).exists() and mngr.verify(2)
    # no GC off an unverified save: step 1 (max_to_keep 1) survives
    assert mngr.verified_steps() == [1] and mngr.latest_verified_step() == 1
    mngr.close()
