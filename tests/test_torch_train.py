"""Port parity, training slice: the optimizer chain and its schedule
against optax, the fused cross-entropy against JAX's, TokenDataset batches,
the sticky health flag, the model's training forward, the train step
against JAX's `make_train_step`, and the launcher end to end on the CPU.

Tolerances (all float32): schedule 1e-9 relative (the port computes it in
float64, JAX in float32 — one f32 ulp); optimizer parameters 1e-6
absolute after five steps (f32 elementwise math in another order); CE
value 1e-6 relative and gradients 1e-6 absolute; model hidden states
2e-5 absolute (summation order through two layers); train-step losses
1e-5 relative and parameters 2e-5 absolute over three steps (both sides
accumulate f32 microgradients; Adam's normalised update turns a relative
gradient difference into an absolute parameter one of about lr times it)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.data.dataset import TokenDataset as JTokenDataset
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.ops.loss import cross_entropy_loss as j_ce
from midgpt_tpu.ops.loss import fused_linear_cross_entropy as j_fused_ce
from midgpt_tpu.parallel.data import make_global_batch
from midgpt_tpu.parallel.mesh import batch_spec, make_mesh
from midgpt_tpu.training.optim import make_optimizer as j_make_optimizer
from midgpt_tpu.training.optim import make_schedule as j_make_schedule
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_train_step as j_make_train_step
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.data.dataset import TokenDataset
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig
from midgpt_tpu_torch.ops.loss import cross_entropy_loss, fused_linear_cross_entropy
from midgpt_tpu_torch.training.optim import make_optimizer, opt_step_count
from midgpt_tpu_torch.training.train import health_flag, make_train_step
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=64)


def _configs(data_dir, **over):
    base = dict(
        rundir="", data_dir=str(data_dir), learning_rate=1e-2, batch_size=4,
        warmup_steps=2, min_lr=1e-3, lr_decay_steps=20, max_steps=20, beta2=0.95,
        weight_decay=1e-4, eval_interval=10, param_dtype="float32",
        compute_dtype="float32", g_accum_iters=2, shard_model=False, eval_steps=2,
    )
    model = dict(MODEL, attn_impl="flash", attn_block_size=16)
    model.update(over.pop("model", {}))
    base.update(over)
    j = JExperimentConfig(**base, mesh=JMeshConfig(data=1, fsdp=1, sp=1), model_config=JGPTConfig(**model))
    t = ExperimentConfig(**base, mesh=MeshConfig(data=1, fsdp=1, sp=1), model_config=GPTConfig(**model))
    return j, t


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
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


def test_schedule_matches_optax(data_dir):
    jc, tc = _configs(data_dir, warmup_steps=7, lr_decay_steps=30, learning_rate=3e-3, min_lr=1e-4)
    want, got = j_make_schedule(jc), make_optimizer(tc)[1]
    for count in (0, 1, 3, 6, 7, 8, 15, 29, 30, 31, 100):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0  # the first step moves nothing


def test_optimizer_chain_matches_optax(data_dir):
    jc, tc = _configs(data_dir, warmup_steps=2, lr_decay_steps=8, weight_decay=0.1)
    r = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    j_opt, _ = j_make_optimizer(jc)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_opt.init(j_params)
    opt, _ = make_optimizer(tc)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    for i in range(5):
        scale = 10.0 if i == 3 else 0.05  # step 3 is clipped, the rest are not
        grads = {k: (scale * r.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        updates, j_state = j_opt.update({k: jnp.asarray(v) for k, v in grads.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        before = {k: v.clone() for k, v in t_params.items()}
        t_state = opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, t_state, t_params)
        if i == 0:  # lr 0 at count 0: nothing moves, weight decay included
            assert all(torch.equal(before[k], t_params[k]) for k in shapes)
        for k in shapes:
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]), atol=1e-6, rtol=0)
    assert opt_step_count(t_state) == 5


def test_cross_entropy_matches_jax():
    r = np.random.default_rng(1)
    logits = (3 * r.standard_normal((2, 7, 50))).astype(np.float32)
    labels = r.integers(0, 50, (2, 7))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(j_ce(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("chunk,remat", [(16, None), (16, True), (1000, False)])
def test_fused_ce_value_and_grads_match_jax(chunk, remat):
    r = np.random.default_rng(2)
    h = r.standard_normal((2, 19, 24)).astype(np.float32)  # 38 tokens: a ragged last chunk
    w = (0.3 * r.standard_normal((40, 24))).astype(np.float32)
    y = r.integers(0, 40, (2, 19))
    want, (jdh, jdw) = jax.value_and_grad(
        lambda h_, w_: j_fused_ce(h_, w_, jnp.asarray(y), chunk), argnums=(0, 1)
    )(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = fused_linear_cross_entropy(th, tw, torch.from_numpy(y), chunk, remat)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-6, rtol=0)


def test_token_dataset_matches_jax(data_dir, tmp_path):
    j, t = JTokenDataset(str(data_dir), seed=7), TokenDataset(str(data_dir), seed=7)
    for split, step, g in (("train", 0, None), ("train", 5, 3), ("val", 2, 2)):
        for a, b in zip(j.batch(split, step, 16, 4, g), t.batch(split, step, 16, 4, g)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(j.batch("val", 9, 16, 4, 8, accum_slice=(2, 3)), t.batch("val", 9, 16, 4, 8, accum_slice=(2, 3))):
        np.testing.assert_array_equal(a, b)
    x, y = t.batch("train", 1, 16, 4, 2)
    assert x.shape == (2, 4, 16) and x.dtype == np.int32
    np.testing.assert_array_equal(y[..., :-1], x[..., 1:])
    # the meta.pkl split-size fingerprint refuses bins from another prepare run
    import pickle

    for name in ("train.bin", "val.bin"):
        (tmp_path / name).write_bytes((data_dir / name).read_bytes())
    with open(tmp_path / "meta.pkl", "wb") as f:
        pickle.dump({"split_tokens": {"train": 123, "val": 4000}}, f)
    with pytest.raises(ValueError, match="meta.pkl"):
        TokenDataset(str(tmp_path))
    # one node: the whole stream (tests/test_torch_parallel.py holds the split by node to JAX's by process)
    whole = TokenDataset(str(data_dir), shard_by_process=True)
    for split in ("train", "val"):
        np.testing.assert_array_equal(whole[split], t[split])


def test_health_flag_is_sticky():
    good = {"a": torch.ones(3), "b": torch.zeros(2)}
    bad = {"a": torch.tensor([1.0, float("inf"), 0.0]), "b": torch.zeros(2)}
    one, nan = torch.tensor(1.5), torch.tensor(float("nan"))
    assert health_flag(good, one, torch.tensor(0.0)).item() == 1.5
    assert health_flag(bad, one, torch.tensor(0.0)).isnan()
    assert health_flag(good, nan, torch.tensor(0.0)).isnan()
    assert health_flag(good, one, nan).isnan()  # once NaN, always NaN
    big = {"a": torch.full((3,), 1e20), "b": torch.zeros(2)}  # finite, norm overflows
    assert health_flag(big, one, torch.tensor(0.0)).item() == 1.5


@pytest.mark.parametrize("impl", ["flash", "blockwise", "naive"])
def test_training_hidden_matches_jax(data_dir, impl):
    jc, tc = _configs(data_dir, model={"attn_impl": impl, "rope_style": "split"})
    jp = JGPT.init(jc.model_config, jax.random.PRNGKey(3))
    tp_ = params_from_numpy(_flatten(jp), device=CPU)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 32))
    want = JGPT.hidden(jc.model_config, jp, jnp.asarray(tokens))
    got = GPT.hidden(tc.model_config, tp_, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_dropout_is_on_only_in_training():
    cfg = GPTConfig(**MODEL, dropout=0.5)
    params = GPT.init(cfg, 0, device=CPU)
    tokens = torch.randint(0, 64, (2, 32), generator=torch.Generator().manual_seed(0))
    a = GPT.hidden(cfg, params, tokens, inference=True)
    assert torch.equal(a, GPT.hidden(cfg, params, tokens, inference=True))
    g1, g2 = (torch.Generator().manual_seed(s) for s in (1, 1))
    b1 = GPT.hidden(cfg, params, tokens, generator=g1)
    assert torch.equal(b1, GPT.hidden(cfg, params, tokens, generator=g2))  # seeded
    assert not torch.allclose(a, b1)
    with pytest.raises(ValueError, match="generator"):
        GPT.hidden(cfg, params, tokens)
    with pytest.raises(NotImplementedError, match="naive"):
        GPT.hidden(dataclasses.replace(cfg, attn_impl="blockwise"), params, tokens,
                   generator=torch.Generator().manual_seed(0))


def test_train_step_matches_jax(data_dir):
    """Three G=2 steps from the same (JAX-initialized) params on the same
    batches: each step's loss and the params after it. Step 1 runs at lr 0
    and moves nothing; steps 2 and 3 move everything."""
    jc, tc = _configs(data_dir)
    mesh = make_mesh(jc.mesh, devices=jax.devices()[:1])
    jp, j_state, specs, j_opt = j_init_state(jc, mesh)
    j_step, *_ = j_make_train_step(jc, j_opt, mesh, specs)
    opt, _ = make_optimizer(tc)
    tp_ = params_from_numpy(_flatten(jp), device=CPU)
    t_state = opt.init(tp_)
    t_step, *_ = make_train_step(tc, opt)
    ds = TokenDataset(str(data_dir), seed=11)
    for i in range(3):
        x, y = ds.batch("train", i, 32, 4, 2)
        jp, j_state, j_loss = j_step(
            jp, j_state, make_global_batch(x, mesh, batch_spec()),
            make_global_batch(y, mesh, batch_spec()), jax.random.PRNGKey(i),
        )
        tp_, t_state, t_loss = t_step(tp_, t_state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
        flat = _flatten(jp)
        for k, v in flat.items():
            np.testing.assert_allclose(tp_[k.lstrip(".")].numpy(), v, atol=2e-5, rtol=0, err_msg=f"step {i} {k}")


def _run(args, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


TINY = [
    "--set", "max_steps=4", "--set", "eval_interval=2", "--set", "eval_steps=2",
    "--set", "batch_size=4", "--set", "g_accum_iters=2", "--set", "warmup_steps=1",
    "--set", "lr_decay_steps=4", "--set", "log_interval=1", "--set", "spec_layers=0",
    "--set", "model_config.block_size=32", "--set", "model_config.n_layer=2",
    "--set", "model_config.n_embd=64", "--set", "model_config.n_head=2",
    "--set", "model_config.vocab_size=64", "--set", "model_config.attn_block_size=16",
]


def test_launch_on_cpu_then_serve_its_params(data_dir, tmp_path):
    import json

    rundir = tmp_path / "run"
    r = _run(["-m", "midgpt_tpu_torch.launch", "--config=local_text_124m", "--device", "cpu",
              f"--rundir={rundir}", "--set", f"data_dir={data_dir}", *TINY])
    assert r.returncode == 0, r.stderr
    assert "cannot be resumed" not in r.stdout
    # saves at steps 0 and 2 and the final step 3; the two newest verified are
    # kept; the supervisor's ledger beside them
    assert {p.name for p in rundir.iterdir()} == {"config.json", "metrics.jsonl", "supervisor_state.json", "2", "3"}
    assert {p.name for p in (rundir / "3").iterdir()} == {
        "params.npz", "opt_state.npz", "format.json", "midgpt_manifest.json"}
    records = [json.loads(line) for line in (rundir / "metrics.jsonl").read_text().splitlines()]
    losses = [rec["loss/optimized"] for rec in records if "loss/optimized" in rec]
    assert len(losses) == 4 and all(np.isfinite(losses))
    r = _run(["-m", "midgpt_tpu_torch.sample", f"--ckpt_dir={rundir}", "--device=cpu",
              "--start_ids=1,2,3", "--num_samples=2", "--max_new_tokens=4", "--temperature=0", "--engine=continuous"])
    assert r.returncode == 0, r.stderr
    assert "restored checkpoint step 3" in r.stdout and "2 requests on cpu" in r.stdout


def test_launch_needs_cuda_unless_cpu_is_asked(data_dir):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    r = _run(["-m", "midgpt_tpu_torch.launch", "--config=local_text_124m", "--debug",
              "--set", f"data_dir={data_dir}", *TINY])
    assert r.returncode != 0 and "CUDA" in r.stderr
    r = _run(["-m", "midgpt_tpu_torch.launch", "--config=local_text_124m", "--multihost", "--device=cpu"])
    assert r.returncode != 0 and "multihost runs must prespecify --rundir" in r.stderr  # as JAX's launcher


def test_debug_run_traces_its_second_step_only(data_dir, tmp_path, monkeypatch):
    """`--debug` on the CPU: a 2-step launcher run writes one Chrome trace,
    of step 1 (the first step after the first), to <tempdir>/midgpt_trace
    (no run directory under --debug), and writes nothing else."""
    import json
    import tempfile

    from midgpt_tpu_torch import launch

    tmp, cwd = tmp_path / "tmp", tmp_path / "cwd"
    tmp.mkdir()
    cwd.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    monkeypatch.chdir(cwd)
    tiny = [a if not a.startswith("max_steps=") else "max_steps=2" for a in TINY]
    launch.main(["--config=local_text_124m", "--device=cpu", "--debug", "--set", f"data_dir={data_dir}", *tiny])
    written = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())
    assert written == ["tmp/midgpt_trace/trace_step1.json"]
    events = json.loads((tmp / "midgpt_trace" / "trace_step1.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
