"""Port parity, checkpoint slice: the step directories of
midgpt_tpu_torch/training/checkpoint.py (round trip, partial restore, the
save filter, the format marker, manifests, verified-only GC, the write
retry, writer-thread errors, the snapshot), resume through the launcher
(in-process and after a SIGKILL) against a straight run, the resume's
finiteness check, JAX's state continued by the port, the sampler's
restore, the config's checks, and the golden trajectory.

All on the CPU in float32 at a tiny size (2 layers, width 64, T 32-64).
Tolerances: a resumed run against the straight run, losses and final
eval at rtol 1e-6 (JAX's own, tests/test_robustness.py); the port resumed
from JAX's converted state against JAX's next steps, loss rtol 1e-5 and
params atol 2e-5 (tests/test_torch_train.py's train-step tolerances); the
golden trajectory at atol 1e-4 (tests/test_golden_loss.py's), though the
fixture was recorded on a 2 x 4 mesh and the port runs one device."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.parallel.data import make_global_batch
from midgpt_tpu.parallel.mesh import batch_spec, make_mesh
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_train_step as j_make_train_step
from midgpt_tpu_torch import launch
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, load_config
from midgpt_tpu_torch.convert import (
    opt_state_from_numpy,
    opt_state_from_optax,
    opt_state_to_numpy,
    params_from_numpy,
    write_step,
)
from midgpt_tpu_torch.data.dataset import TokenDataset
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, param_shapes
from midgpt_tpu_torch.robustness.backoff import backoff_delays, retry_with_backoff
from midgpt_tpu_torch.robustness.errors import CheckpointCorruptError, CheckpointWriteError
from midgpt_tpu_torch.training import checkpoint as ckpt
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.optim import make_optimizer
from midgpt_tpu_torch.training.train import init_state, make_train_step, state_template, train

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=64)


def _config(data_dir="", **over) -> ExperimentConfig:
    base = dict(
        rundir="", data_dir=str(data_dir), learning_rate=1e-2, batch_size=4, warmup_steps=2,
        min_lr=1e-3, lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4,
        eval_interval=1000, param_dtype="float32", compute_dtype="float32", g_accum_iters=2,
        shard_model=False, eval_steps=2, log_interval=1,
    )
    model = dict(MODEL, attn_block_size=16, **over.pop("model", {}))
    base.update(over)
    return ExperimentConfig(**base, mesh=MeshConfig(data=1, fsdp=1, sp=1), model_config=GPTConfig(**model))


def _state(config, seed=0):
    params, opt_state, opt = init_state(config.replace(seed=seed), CPU)
    # a state whose moments and counts are not all zero
    g = torch.Generator().manual_seed(seed + 1)
    grads = {k: 0.01 * torch.randn(v.shape, generator=g) for k, v in params.items()}
    opt_state = opt.update(grads, opt_state, params)
    return params, opt_state


def _equal_state(a, b):
    pa, oa = a
    pb, ob = b
    assert list(pa) == list(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]) and pa[k].dtype == pb[k].dtype, k
        assert torch.equal(oa.mu[k], ob.mu[k]) and torch.equal(oa.nu[k], ob.nu[k]), k
    assert (oa.adam_count, oa.schedule_count) == (ob.adam_count, ob.schedule_count)


def _flatten(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A learnable stream: token[i+1] = (token[i] + 1) % 17, with noise."""
    d = tmp_path_factory.mktemp("stream")
    r = np.random.default_rng(0)
    stream = np.where(r.random(20000) < 0.1, r.integers(0, 64, 20000), np.arange(20000) % 17)
    stream.astype(np.uint16).tofile(d / "train.bin")
    stream[:4000].astype(np.uint16).tofile(d / "val.bin")
    return d


# ---------------------------------------------------------------- the manager


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_roundtrip_state(tmp_path, param_dtype):
    """Restore into a differently-valued live state gives back the saved
    values bit for bit; a bf16 master parameter is widened on disk and cast
    back exactly."""
    config = _config(param_dtype=param_dtype)
    saved = _state(config, seed=0)
    mngr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    assert mngr.latest_step() is None and mngr.latest_verified_step() is None
    assert mngr.save(3, {"params": saved[0], "opt_state": saved[1]})
    mngr.wait()
    assert mngr.latest_step() == 3 and mngr.verified_steps() == [3]
    assert mngr.weights_version(3).startswith("3:") and mngr.weights_version(4) is None
    other = _state(config, seed=7)
    restored = mngr.restore(3, {"params": other[0], "opt_state": other[1]})
    _equal_state((restored["params"], restored["opt_state"]), saved)
    with np.load(tmp_path / "ckpt" / "3" / "params.npz") as f:
        assert f["wte"].dtype == np.float32
    # the same state gives the same bytes: identical manifests, step aside
    mngr.save(4, {"params": saved[0], "opt_state": saved[1]})
    mngr.wait()
    files = [json.loads((tmp_path / "ckpt" / s / ckpt.MANIFEST_NAME).read_text())["files"] for s in ("3", "4")]
    assert files[0] == files[1]
    mngr.close()


def test_partial_restore_params_only(tmp_path):
    """The sampler's restore: only "params", into a meta template (shape and
    dtype only) placed by `device=`; `param_shapes` is the template."""
    config = _config()
    params, opt_state = _state(config)
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mngr.save(7, {"params": params, "opt_state": opt_state})
    like = {"params": state_template(config)["params"]}
    restored = mngr.restore(7, like, device=CPU)
    assert set(restored) == {"params"}
    assert all(torch.equal(restored["params"][k], params[k]) for k in params)
    with pytest.raises(ValueError, match="meta template"):
        mngr.restore(7, like)
    bad = {"params": {**like["params"], "wte": torch.empty(3, 3, device="meta")}}
    with pytest.raises(ValueError, match="saved shape"):
        mngr.restore(7, bad, device=CPU)
    mngr.close()


@pytest.mark.parametrize("n_kv_heads", [None, 1])
def test_param_shapes_match_init(n_kv_heads):
    cfg = GPTConfig(**MODEL, n_kv_heads=n_kv_heads)
    params = GPT.init(cfg, 0, device=CPU)
    shapes = param_shapes(cfg)
    assert list(shapes) == list(params)
    assert all(tuple(params[k].shape) == shapes[k] for k in params)


def test_save_interval_filtering_and_force(tmp_path):
    params, opt_state = _state(_config())
    state = {"params": params, "opt_state": opt_state}
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=10)
    assert mngr.save(0, state) is True
    assert mngr.should_save(0) is False  # in flight
    assert mngr.save(3, state) is False  # filtered
    assert mngr.save(10, state) is True
    assert mngr.save(13, state, force=True) is True
    mngr.wait()
    assert mngr.latest_step() == 13 and not mngr.should_save(10) and mngr.should_save(20)
    with pytest.raises(ValueError, match="already has a verified"):
        mngr.save(13, state, force=True)
    mngr.close()


def test_format_marker_rejects_mismatched_checkpoint(tmp_path, monkeypatch):
    params, _ = _state(_config())
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mngr.save(0, {"params": params})
    mngr.close()
    monkeypatch.setattr(ckpt, "FORMAT", {"version": 99, "qkv_layout": "other", "container": "npz"})
    with pytest.raises(ValueError, match="format"):
        CheckpointManager(str(tmp_path)).restore(0, {"params": params})


def _truncate(path: Path):
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])


def test_truncated_item_raises_corrupt(tmp_path):
    params, opt_state = _state(_config())
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mngr.save(2, {"params": params, "opt_state": opt_state})
    mngr.wait()
    _truncate(tmp_path / "2" / "opt_state.npz")
    assert not mngr.is_verified(2)  # the cached verification follows the file
    with pytest.raises(CheckpointCorruptError, match="truncated item file: opt_state.npz") as ei:
        mngr.restore(2, {"params": params})
    assert ei.value.step == 2 and ei.value.problems
    mngr.close()


@pytest.mark.parametrize("damage", ["unmanifested", "corrupt"])
def test_latest_verified_step_skips_a_bad_newer_step(tmp_path, damage):
    params, opt_state = _state(_config())
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    for s in (1, 2):
        mngr.save(s, {"params": params, "opt_state": opt_state})
    mngr.wait()
    if damage == "unmanifested":  # a save killed before its manifest
        (tmp_path / "2" / ckpt.MANIFEST_NAME).unlink()
    else:  # bit rot after the commit
        raw = bytearray((tmp_path / "2" / "params.npz").read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        (tmp_path / "2" / "params.npz").write_bytes(bytes(raw))
    fresh = CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert fresh.latest_step() == 2 and fresh.latest_verified_step() == 1
    assert fresh.verified_steps() == [1]
    # a new save at the damaged step replaces it
    assert fresh.should_save(2) == (damage == "unmanifested")
    fresh.save(2, {"params": params, "opt_state": opt_state}, force=True)
    assert fresh.latest_verified_step() == 2
    fresh.close()


def test_gc_keeps_max_to_keep_verified_steps(tmp_path):
    params, opt_state = _state(_config())
    state = {"params": params, "opt_state": opt_state}
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=1)
    for s in range(4):
        mngr.save(s, state)
    mngr.wait()
    assert mngr.all_steps() == [2, 3]
    # a newer step that fails verification never costs the older ones
    (tmp_path / "3" / ckpt.MANIFEST_NAME).unlink()
    mngr.save(4, state)
    mngr.wait()
    assert mngr.all_steps() == [2, 3, 4] and mngr.verified_steps() == [2, 4]
    # the only verified step survives any number of failed saves
    only = CheckpointManager(str(tmp_path / "only"), max_to_keep=1, save_interval_steps=1)
    only.save(0, state)
    only.wait()
    (tmp_path / "only" / "5").mkdir()  # a partial newer step
    assert only.verified_steps() == [0] and only.latest_verified_step() == 0
    only.close()
    mngr.close()


def test_write_retry_recovers_from_one_oserror(tmp_path, monkeypatch):
    params, _ = _state(_config())
    real, calls = ckpt._write_npz, []

    def flaky(path, arrays):
        calls.append(path)
        if len(calls) == 1:
            Path(path).write_bytes(b"partial")  # bytes land, then the write dies
            raise OSError(28, "No space left on device")
        real(path, arrays)

    monkeypatch.setattr(ckpt, "_write_npz", flaky)
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1, retry_backoff_sec=0.0)
    mngr.save(0, {"params": params})
    mngr.wait()
    assert len(calls) == 2 and mngr.history[0]["attempts"] == 2 and mngr.verified_steps() == [0]
    restored = mngr.restore(0, {"params": params})["params"]
    assert all(torch.equal(restored[k], params[k]) for k in params)
    mngr.close()


def test_write_retries_exhausted_raise_and_leave_no_partial(tmp_path, monkeypatch):
    params, _ = _state(_config())

    def failing(path, arrays):
        Path(path).write_bytes(b"partial")
        raise OSError(5, "I/O error")

    monkeypatch.setattr(ckpt, "_write_npz", failing)
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1, write_retries=3, retry_backoff_sec=0.0)
    mngr.save(4, {"params": params})
    with pytest.raises(CheckpointWriteError) as ei:
        mngr.wait()
    assert ei.value.step == 4 and ei.value.attempts == 3 and isinstance(ei.value.__cause__, OSError)
    assert mngr.all_steps() == [] and not (tmp_path / "4").exists()
    mngr.close()  # the error was raised once, at the barrier
    assert list(backoff_delays(4, 0.5)) == [0.5, 1.0, 2.0]
    with pytest.raises(ValueError):
        retry_with_backoff(lambda: None, retries=0, base_s=0.0, retry_on=(OSError,))


def test_writer_thread_error_raised_at_wait(tmp_path, monkeypatch):
    """A failure of another kind in the writer thread is not retried and
    never swallowed: the next barrier raises it."""
    params, _ = _state(_config())

    def broken(path, arrays):
        raise RuntimeError("writer thread failed")

    monkeypatch.setattr(ckpt, "_write_npz", broken)
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mngr.save(1, {"params": params})
    with pytest.raises(RuntimeError, match="writer thread failed"):
        mngr.wait()
    assert mngr.all_steps() == []
    mngr.close()


def test_snapshot_is_taken_before_later_in_place_steps(tmp_path, monkeypatch):
    """The writer is held until the optimizer has updated params and moments
    in place twice: the checkpoint still holds the state at save time."""
    config = _config()
    params, opt_state = _state(config)
    before = ({k: v.clone() for k, v in params.items()},
              opt_state_from_numpy(opt_state_to_numpy(opt_state), device=CPU))
    go, real = threading.Event(), ckpt._write_npz

    def held(path, arrays):
        assert go.wait(30)
        real(path, arrays)

    monkeypatch.setattr(ckpt, "_write_npz", held)
    opt, _ = make_optimizer(config)
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    mngr.save(5, {"params": params, "opt_state": opt_state})
    for _ in range(2):
        opt_state = opt.update({k: torch.ones_like(v) for k, v in params.items()}, opt_state, params)
    assert not torch.equal(params["wte"], before[0]["wte"])
    go.set()
    restored = mngr.restore(5, {"params": params, "opt_state": opt_state})
    _equal_state((restored["params"], restored["opt_state"]), before)
    mngr.close()


def test_back_to_back_saves_keep_each_snapshot(tmp_path):
    """Saves in a row, each followed at once by an in-place update, with the
    interpreter switching threads every few microseconds: every step
    restores the state it was saved from (a writer reading a buffer the
    next snapshot overwrote would break this)."""
    config = _config()
    params, opt_state = _state(config)
    mngr = CheckpointManager(str(tmp_path), max_to_keep=100, save_interval_steps=1)
    copies = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.time()
        for s in range(12):
            copies.append({k: v.clone() for k, v in params.items()})
            mngr.save(s, {"params": params})
            for v in params.values():
                v.add_(1.0)
        mngr.wait()
        assert time.time() - t0 < 60
    finally:
        sys.setswitchinterval(interval)
    for s, want in enumerate(copies):
        got = mngr.restore(s, {"params": params})["params"]
        assert all(torch.equal(got[k], want[k]) for k in want), s
    mngr.close()


# ---------------------------------------------------------------- resume


def _launch_args(data_dir, rundir, max_steps):
    sets = {
        "data_dir": data_dir, "max_steps": max_steps, "eval_interval": 4, "eval_steps": 2,
        "batch_size": 4, "g_accum_iters": 2, "learning_rate": 1e-2, "warmup_steps": 2,
        "lr_decay_steps": 20, "min_lr": 1e-3, "log_interval": 1, "spec_layers": 0,
        "compute_dtype": "float32", "model_config.block_size": 32, "model_config.n_layer": 2,
        "model_config.n_embd": 64, "model_config.n_head": 2, "model_config.vocab_size": 64,
        "model_config.attn_block_size": 16, "model_config.dropout": 0.1, "model_config.attn_impl": "naive",
    }
    return ["--config=local_text_124m", "--device=cpu", f"--rundir={rundir}",
            *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]


def _logged(rundir) -> dict:
    """{step: loss/optimized}, later lines (a resumed run's) winning."""
    out = {}
    for line in Path(rundir, "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "loss/optimized" in rec:
            out[rec["step"]] = rec["loss/optimized"]
    return out


@pytest.fixture(scope="module")
def straight16(data_dir, tmp_path_factory):
    rundir = tmp_path_factory.mktemp("straight")
    return launch.main(_launch_args(data_dir, rundir, 16)), rundir


def _assert_continues(straight, straight_dir, resumed, rundir, first):
    a, b = _logged(straight_dir), _logged(rundir)
    steps = list(range(first, 16))
    np.testing.assert_allclose([b[s] for s in steps], [a[s] for s in steps], rtol=1e-6)
    np.testing.assert_allclose(resumed["metrics"]["loss/final"], straight["metrics"]["loss/final"], rtol=1e-6)
    for k, v in straight["params"].items():
        np.testing.assert_allclose(resumed["params"][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_exact_continuation_resume(data_dir, straight16, tmp_path):
    """Train 8 (saves at 0 and 4, final save 7), rerun the launcher to 16:
    it resumes at 8 and continues the straight 16-step run, dropout
    included."""
    straight, straight_dir = straight16
    first = launch.main(_launch_args(data_dir, tmp_path, 8))
    assert first["resumed_from"] is None and [r["step"] for r in first["checkpoints"]] == [0, 4, 7]
    # max_to_keep 2; the launcher's supervisor keeps its ledger beside the steps
    assert sorted(os.listdir(tmp_path)) == ["4", "7", "config.json", "metrics.jsonl", "supervisor_state.json"]
    resumed = launch.main(_launch_args(data_dir, tmp_path, 16))
    assert resumed["resumed_from"] == 7 and resumed["restore_s"] is not None
    _assert_continues(straight, straight_dir, resumed, tmp_path, 8)
    assert CheckpointManager(str(tmp_path)).verified_steps() == [12, 15]


def test_sigkilled_launcher_resumes_to_the_end(data_dir, straight16, tmp_path):
    """A launcher subprocess is SIGKILLed as soon as a step after 0 is
    verified; a rerun resumes from the newest verified step (never a
    partial one) and ends where the straight run ends."""
    straight, straight_dir = straight16
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", "midgpt_tpu_torch.launch", *_launch_args(data_dir, tmp_path, 16)],
                            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.time() + 120
    try:
        while not (tmp_path / "4" / ckpt.MANIFEST_NAME).exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.time() < deadline
            time.sleep(0.005)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        proc.stderr.close()
    verified = CheckpointManager(str(tmp_path)).verified_steps()
    assert verified and max(verified) >= 4
    resumed = launch.main(_launch_args(data_dir, tmp_path, 16))
    assert resumed["resumed_from"] == max(verified)
    _assert_continues(straight, straight_dir, resumed, tmp_path, max(verified) + 1)


def test_resume_rejects_non_finite_checkpoint(data_dir, tmp_path):
    """A restored NaN aborts the resume: the manifest guards the bytes, the
    finiteness sweep the values."""
    config = _config(data_dir, rundir=str(tmp_path), max_steps=4, eval_interval=2)
    train(config, device=CPU)
    mngr = CheckpointManager(str(tmp_path))
    step = mngr.latest_verified_step()
    state = mngr.restore(step, state_template(config), device=CPU)
    state["params"]["blocks.attn.wo"][0, 0, 0] = float("nan")
    mngr.save(step + 1, state, force=True)
    mngr.close()
    with pytest.raises(FloatingPointError, match="corrupt"):
        train(config.replace(max_steps=10), device=CPU)


@pytest.mark.parametrize("log_interval,caught_at", [(1, 5), (100, 6)], ids=["log sync", "pre-save check"])
def test_divergence_names_the_last_good_checkpoint(data_dir, tmp_path, monkeypatch, log_interval, caught_at):
    """The sticky loss turns NaN from step 5: the log sync (or, without a
    log there, the check before the step-6 save) raises DivergenceError
    naming step 4, the newest verified checkpoint, and saves nothing
    poisoned."""
    from midgpt_tpu_torch.robustness.errors import DivergenceError
    from midgpt_tpu_torch.training import train as train_mod

    calls, real = [], train_mod.health_flag

    def poisoned(grads, loss, prev_loss):
        calls.append(None)
        out = real(grads, loss, prev_loss)
        return out * float("nan") if len(calls) > 5 else out

    monkeypatch.setattr(train_mod, "health_flag", poisoned)
    config = _config(data_dir, rundir=str(tmp_path), max_steps=8, eval_interval=2, log_interval=log_interval)
    with pytest.raises(DivergenceError) as ei:
        train(config, device=CPU)
    assert (ei.value.step, ei.value.last_good_step, ei.value.rundir) == (caught_at, 4, str(tmp_path))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


def test_port_continues_jax_state(data_dir, tmp_path):
    """JAX trains 3 steps; its params and optax state go through convert and
    write_step into a port step directory; the port resumes there and its
    next 3 steps equal JAX's."""
    N, M = 3, 3
    base = dict(
        rundir="", data_dir=str(data_dir), learning_rate=1e-2, batch_size=4, warmup_steps=2,
        min_lr=1e-3, lr_decay_steps=20, max_steps=N + M, beta2=0.95, weight_decay=1e-4,
        eval_interval=1000, param_dtype="float32", compute_dtype="float32", g_accum_iters=2,
        shard_model=False, eval_steps=2,
    )
    jc = JExperimentConfig(**base, mesh=JMeshConfig(data=1, fsdp=1, sp=1),
                           model_config=JGPTConfig(**MODEL, attn_impl="flash", attn_block_size=16))
    tc = _config(data_dir, rundir=str(tmp_path), max_steps=N + M, model={"attn_impl": "flash"})
    mesh = make_mesh(jc.mesh, devices=jax.devices()[:1])
    jp, j_state, specs, j_opt = j_init_state(jc, mesh)
    j_step, *_ = j_make_train_step(jc, j_opt, mesh, specs)
    ds = TokenDataset(str(data_dir), seed=jc.data_seed)
    j_losses = []
    for i in range(N + M):
        if i == N:
            state = opt_state_from_optax(_flatten(j_state), config=tc.model_config, device=CPU)
            assert (state.adam_count, state.schedule_count) == (N, N)
            write_step(str(tmp_path), N - 1, _flatten(jp), state)
        x, y = ds.batch("train", i, 32, 4, 2)
        jp, j_state, loss = j_step(jp, j_state, make_global_batch(x, mesh, batch_spec()),
                                   make_global_batch(y, mesh, batch_spec()), jax.random.PRNGKey(i))
        j_losses.append(float(loss))
    result = train(tc, device=CPU)
    assert result["resumed_from"] == N - 1
    got = _logged(tmp_path)
    np.testing.assert_allclose([got[s] for s in range(N, N + M)], j_losses[N:], rtol=1e-5)
    for k, v in _flatten(jp).items():
        np.testing.assert_allclose(result["params"][k.lstrip(".")].numpy(), v, atol=2e-5, rtol=0, err_msg=k)
    assert result["opt_state"].adam_count == N + M


def test_golden_trajectory(tmp_path):
    """JAX's init for the golden spec, transplanted through convert, then
    200 single-device f32 steps of the port's train step on the golden
    stream: the fixture's losses at its own tolerance."""
    import golden_runner

    spec = golden_runner.GOLDEN_SPEC
    fixture = json.loads((ROOT / "tests" / "golden" / "tiny_fp32.json").read_text())
    assert fixture["spec"] == spec
    golden_runner.make_stream(str(tmp_path))
    common = dict(
        rundir="", data_dir=str(tmp_path), learning_rate=spec["learning_rate"], batch_size=spec["batch_size"],
        warmup_steps=spec["warmup_steps"], min_lr=spec["min_lr"], lr_decay_steps=spec["lr_decay_steps"],
        max_steps=spec["steps"], eval_interval=10**9, beta2=spec["beta2"], weight_decay=spec["weight_decay"],
        param_dtype="float32", compute_dtype="float32", g_accum_iters=1, shard_model=False,
        seed=spec["seed"], data_seed=spec["data_seed"],
    )
    shape = {k: spec[k] for k in ("block_size", "vocab_size", "n_layer", "n_head", "n_embd")}
    jc = JExperimentConfig(**common, mesh=JMeshConfig(data=1, fsdp=1, sp=1), model_config=JGPTConfig(**shape))
    tc = ExperimentConfig(**common, mesh=MeshConfig(data=1, fsdp=1, sp=1), model_config=GPTConfig(**shape))
    assert tc.model_config.attn_impl == jc.model_config.attn_impl
    jp, *_ = j_init_state(jc, make_mesh(jc.mesh, devices=jax.devices()[:1]))
    params = params_from_numpy(_flatten(jp), device=CPU)
    opt, _ = make_optimizer(tc)
    opt_state = opt.init(params)
    step = make_train_step(tc, opt)[0]
    ds = TokenDataset(str(tmp_path), seed=spec["data_seed"])
    T, B = spec["block_size"], spec["batch_size"]
    losses = []
    for itr in range(spec["steps"]):
        x, y = ds.batch("train", itr, T, B, 1)
        params, opt_state, loss = step(params, opt_state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        if (itr + 1) % spec["record_every"] == 0:
            losses.append(round(loss.item(), 6))
    np.testing.assert_allclose(losses, fixture["losses"], rtol=0, atol=1e-4)


# ---------------------------------------------------------------- sampling


def _serve(run):
    from midgpt_tpu_torch import sample

    sample.main(["--ckpt_dir", str(run), "--device", "cpu", "--start_ids", "1,2,3", "--num_samples", "1",
                 "--max_new_tokens", "4", "--temperature", "0", "--spec_layers", "0"])


@pytest.mark.parametrize("layout", ["verified steps", "no verified step", "bare params.npz"])
def test_sample_reads_the_newest_verified_step(tmp_path, capsys, layout):
    from midgpt_tpu_torch.config import to_json
    from midgpt_tpu_torch.convert import params_to_numpy

    config = _config(str(tmp_path / "no_data"), rundir=str(tmp_path))
    (tmp_path / "config.json").write_text(to_json(config))
    params, opt_state = _state(config)
    if layout == "bare params.npz":
        np.savez(tmp_path / "params.npz", **params_to_numpy(params))
        _serve(tmp_path)
        out = capsys.readouterr().out
        assert "1 requests on cpu" in out and "restored checkpoint" not in out
        return
    mngr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    for s in (3, 6):
        mngr.save(s, {"params": params, "opt_state": opt_state})
    mngr.close()
    np.savez(tmp_path / "params.npz", **params_to_numpy(params))  # ignored beside step directories
    if layout == "verified steps":
        _truncate(tmp_path / "6" / "params.npz")  # the newest step is corrupt: step 3 is served
        _serve(tmp_path)
        out = capsys.readouterr().out
        assert "restored checkpoint step 3" in out and "1 requests on cpu" in out
        return
    _truncate(tmp_path / "3" / "params.npz")
    (tmp_path / "6" / ckpt.MANIFEST_NAME).unlink()
    with pytest.raises(CheckpointCorruptError, match="no verified checkpoint") as ei:
        _serve(tmp_path)
    assert any("truncated item file: params.npz" in p for p in ei.value.problems)
    assert any("step 6: no midgpt_manifest.json" in p for p in ei.value.problems)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize(
    "field,value,match",
    [
        ("data_step_offset", -1, "data_step_offset=-1 must be >= 0"),
        ("max_restarts", -1, "max_restarts=-1 must be >= 0"),
        ("ckpt_max_to_keep", 0, "ckpt_max_to_keep=0 must be >= 1"),
        ("ckpt_write_retries", 0, "ckpt_write_retries=0 must be >= 1"),
        ("preempt_check_interval", 0, "preempt_check_interval=0 must be >= 1"),
        ("restart_backoff_sec", -0.5, "backoff seconds must be >= 0"),
        ("ckpt_retry_backoff_sec", -0.5, "backoff seconds must be >= 0"),
    ],
)
def test_config_rejects_bad_robustness_knobs_as_jax_does(field, value, match):
    import dataclasses

    good = load_config("local_text_124m")
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(good, **{field: value})
    j_good = JExperimentConfig(
        **{f.name: getattr(good, f.name) for f in dataclasses.fields(good)
           if f.name not in ("mesh", "model_config", "spec_layers")},
        model_config=JGPTConfig(**MODEL), spec_layers=0,
    )
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(j_good, **{field: value})
