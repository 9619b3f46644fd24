"""Port parity, tensor-parallel training (parallel/tp.py TPTrain, the 2D
specs of parallel/fsdp.py, ops/loss.py `fused_linear_cross_entropy(group=)`,
models/gpt.py `hidden(tp_train=)`, training/train.py on a (data, fsdp, tp)
mesh, `launch --multihost --set mesh.tp=N`): JAX runs on the 8 virtual CPU
devices of tests/conftest.py, the port on gloo CPU ranks (one torch
thread each) that torchrun starts.

  (a) no processes: the training specs against JAX's tp_param_specs (MHA,
      GQA and MoE layouts; tp 1 is the FSDP rule), the mesh's fill order
      and groups against JAX's device layout, each rank's rows against the
      shard JAX's batch_spec puts on its device, the sharded dropout draw,
      the config checks under tp (openwebtext_xl's 25 heads), the launcher
      and chaos_train under tp;
  (b) one group of 4 ranks under `torchrun --standalone` runs every job
      (tests/torch_tp_train_ranks.py) while the test runs JAX's step on the
      (fsdp 2, tp 2) mesh:
      - two f32 steps (the second clips) of (data 1, tp 2), (data 2, tp 2)
        and (fsdp 2, tp 2) in both fsdp_modes, tp_vocab off, GQA with
        n_kv_heads = tp, and the routed MLP with its aux term, each against
        the single-device trainer on the same weights and batches; the
        (fsdp 2, tp 2) step against JAX's step on the same mesh (`-m slow`:
        every case against JAX's, and JAX's FSDP-only oracle);
      - the reduced gradients and global norm of (data 2, tp 2) with
        tp_vocab off and of (fsdp 2, tp 2) with fsdp-sharded QK-norm scales
        against one device's: the scales summed over the tp row, the
        replicated stream's leaves (lm_head, wte) not summed over it, the
        loss a mean over the data x fsdp batch positions;
      - Megatron's f and g around a column- then row-parallel product, and
        the vocab-parallel CE with chunks kept and recomputed, against the
        dense computation;
      - dropout on every site: the tp row's residual streams bit-equal, and
        the step equal to one device's drawing from the same generators;
      - each remat policy under tp bit-equal to remat off;
      - a tp 2 checkpoint with the single-device bytes, restored on 1 rank
        and on (data 2, tp 2); the resume (data 2, tp 2) -> (data 1, tp 2)
        -> (data 2, tp 2) against the straight run;
      - `launch --multihost --device cpu --set mesh.tp=2` on the 4 ranks.

Tolerances (float32 throughout), as tests/test_torch_parallel.py states
them: step losses 2e-5 relative; parameters 2e-5 absolute (within lr where
a gradient cancels to the f32 noise of its sum); mu 1e-6 and nu 1e-8
absolute; reduced gradients 1e-5 relative and within 1e-5 of the step's
global norm, or of the leaf's largest entry for the QK-norm scales (the
ranks sum a product's partials in another order than one device's single
product, and where a gradient cancels only that order's noise is left);
the vocab-parallel CE's loss 1e-6 relative (its sum of exponentials is
split over the row) and its gradients within 1e-6 of their largest
entry; the f/g pair 1e-5 relative; the elastic trajectory 1e-5
relative. Remat and the tp row's copies of the stream are bit for bit."""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.parallel.data import make_global_batch
from midgpt_tpu.parallel.mesh import batch_spec
from midgpt_tpu.parallel.mesh import make_mesh as j_make_mesh
from midgpt_tpu.parallel.tp import tp_param_specs as j_tp_param_specs
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_train_step as j_make_train_step
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, load_config, to_json
from midgpt_tpu_torch.convert import opt_state_from_optax
from midgpt_tpu_torch.models.gpt import GPTConfig, param_shapes
from midgpt_tpu_torch.ops.dropout import dropout
from midgpt_tpu_torch.parallel.data import rank_rows
from midgpt_tpu_torch.parallel.mesh import make_mesh
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.optim import OptState
from midgpt_tpu_torch.training.train import state_specs

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import full_state  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=64, attn_impl="flash", attn_block_size=16)
LAYOUTS = {"mha": {}, "gqa": {"n_kv_heads": 2}, "moe": {"n_experts": 4, "moe_top_k": 2}}
ALL4 = [0, 1, 2, 3]
# the step cases: (mesh, ranks, config overrides)
CASES = {
    "data1_tp2": (dict(data=1, fsdp=1, tp=2), [0, 1], {}),
    "data2_tp2": (dict(data=2, fsdp=1, tp=2), ALL4, {}),
    "fsdp2_tp2": (dict(data=1, fsdp=2, tp=2), ALL4, {}),
    "fsdp2_tp2_shard_map": (dict(data=1, fsdp=2, tp=2), ALL4, {"fsdp_mode": "shard_map"}),
    "tp_vocab_off": (dict(data=2, fsdp=1, tp=2), ALL4, {"tp_vocab": False}),
    "gqa": (dict(data=1, fsdp=1, tp=2), [0, 1], {"model": LAYOUTS["gqa"]}),
    "moe_aux": (dict(data=2, fsdp=1, tp=2), ALL4, {"model": LAYOUTS["moe"], "moe_aux_coef": 0.01}),
}
JAX_FAST = ("fsdp2_tp2",)  # held to JAX's step in the fast tier; `-m slow` takes every case
GRAD_CASES = {
    "data2_tp2_vocab_off": (dict(data=2, fsdp=1, tp=2), {"tp_vocab": False}),
    "fsdp2_tp2_sharded_scales": (dict(data=1, fsdp=2, tp=2), {"fsdp_min_size": 0}),
}
POLICIES = ("none", "dots", "dots_attn", "flash")


def _configs(**over):
    base = dict(
        rundir="", data_dir="", learning_rate=1e-2, batch_size=4, warmup_steps=1, min_lr=1e-3,
        lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=10,
        param_dtype="float32", compute_dtype="float32", g_accum_iters=2, shard_model=True,
        fsdp_min_size=512, eval_steps=2,
    )
    model = dict(MODEL, **over.pop("model", {}))
    mesh = dict(sp=1, **over.pop("mesh", dict(data=1, fsdp=1, tp=2)))
    base.update(over)
    j = JExperimentConfig(**base, mesh=JMeshConfig(**mesh), model_config=JGPTConfig(**model))
    t = ExperimentConfig(**base, mesh=MeshConfig(**mesh), model_config=GPTConfig(**model))
    return j, t


def _case_configs(case):
    mesh, _, over = CASES[case]
    over = {k: (dict(v) if isinstance(v, dict) else v) for k, v in over.items()}
    return _configs(mesh=dict(mesh), **over)


def _flatten(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _named(tree) -> dict:
    return {k.lstrip("."): v for k, v in _flatten(tree).items()}


def _layout(over) -> str:
    model = over.get("model", {})
    return next(name for name, m in LAYOUTS.items() if m == model)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A learnable stream: token[i+1] = (token[i] + 1) % 17, with noise."""
    d = tmp_path_factory.mktemp("stream")
    r = np.random.default_rng(0)
    stream = np.where(r.random(20000) < 0.1, r.integers(0, 64, 20000), np.arange(20000) % 17)
    stream.astype(np.uint16).tofile(d / "train.bin")
    stream[:4000].astype(np.uint16).tofile(d / "val.bin")
    return d


# ---------------------------------------------------------------- (a) no processes


def _jax_specs(model, mesh, vocab_parallel, min_size):
    abstract = jax.eval_shape(lambda k: JGPT.init(JGPTConfig(**model), k), jax.random.PRNGKey(0))
    jmesh = j_make_mesh(JMeshConfig(sp=1, **mesh), devices=jax.devices()[:mesh["data"] * mesh["fsdp"] * mesh["tp"]])
    specs = j_tp_param_specs(abstract, jmesh, True, min_size, vocab_parallel=vocab_parallel)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]:
        name = jax.tree_util.keystr(path).lstrip(".")
        ndim = len(param_shapes(GPTConfig(**model))[name])
        out[name] = tuple(spec) + (None,) * (ndim - len(spec))
    return out


@pytest.mark.parametrize("vocab", [True, False], ids=["tp_vocab", "tp_vocab_off"])
@pytest.mark.parametrize("mesh", [dict(data=1, fsdp=2, tp=1), dict(data=1, fsdp=1, tp=2), dict(data=1, fsdp=2, tp=2)],
                         ids=["fsdp2", "tp2", "fsdp2_tp2"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_state_specs_match_jax(layout, mesh, vocab):
    """The training state's 2D specs are JAX's tp_param_specs, leaf for
    leaf, at the config's shard_model, fsdp_min_size and tp_vocab; at tp 1
    the FSDP rule."""
    model = dict(MODEL, **LAYOUTS[layout])
    _, t = _configs(model=LAYOUTS[layout], mesh=dict(mesh), tp_vocab=vocab, fsdp_min_size=0)
    got = state_specs(t, types.SimpleNamespace(**mesh))
    assert got == _jax_specs(model, mesh, vocab, 0)
    if mesh["tp"] == 2:
        assert got["blocks.attn.wqkv"] == (None, None, "tp", "fsdp" if mesh["fsdp"] == 2 else None)
        assert got["blocks.attn.q_scale"][1] != "tp"


def test_mesh_fills_data_fsdp_tp_as_jax_lays_out_devices(monkeypatch):
    """Rank i of a (data 2, fsdp 2, tp 2) mesh sits where JAX's make_mesh
    puts device i, and each group holds the ranks JAX's axes name."""
    jmesh = j_make_mesh(JMeshConfig(data=2, fsdp=2, sp=1, tp=2), devices=jax.devices()[:8])
    coords = {int(d.id): idx for idx, d in np.ndenumerate(jmesh.devices)}
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for r in range(8):
        monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
        m = make_mesh(MeshConfig(data=2, fsdp=2, tp=2), ranks=range(8), device=CPU)
        d, f, _, t, _, _ = coords[r]
        assert (m.data_index, m.fsdp_index, m.tp_index, m.batch_index) == (d, f, t, 2 * d + f)
        same = lambda *axes: tuple(sorted(q for q, c in coords.items()  # noqa: E731
                                          if all(c[a] == coords[r][a] for a in axes)))
        assert m.tp_group == same(0, 1) and m.fsdp_group == same(0, 3) and m.data_group == same(1, 3)
        assert m.batch_group == same(3) and m.group == tuple(range(8))


@pytest.mark.parametrize("mesh", [dict(data=2, fsdp=1, tp=2), dict(data=1, fsdp=2, tp=2)], ids=["data2", "fsdp2"])
def test_rows_follow_the_batch_position_as_jax_shards_them(mesh, monkeypatch):
    """Each rank keeps the rows JAX's batch_spec places on its device: the
    ranks of a tp row the same ones, split by (data, fsdp) position."""
    jmesh = j_make_mesh(JMeshConfig(sp=1, **mesh), devices=jax.devices()[:4])
    x = np.arange(2 * 8 * 5, dtype=np.int32).reshape(2, 8, 5)
    xg = make_global_batch(x, jmesh, batch_spec())
    shards = {int(s.device.id): np.asarray(s.data) for s in xg.addressable_shards}
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for r in range(4):
        monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
        m = make_mesh(MeshConfig(**mesh), ranks=range(4), device=CPU)
        np.testing.assert_array_equal(rank_rows(x, m), shards[int(jmesh.devices.flat[r].id)])


def test_sharded_dropout_draws_the_whole_mask():
    """A tp rank's dropout over its heads keeps what one device's dropout
    over every head keeps there, and leaves its generator where one
    device's would be."""
    x = torch.randn(2, 6, 8, 8)
    whole = dropout(x, 0.3, torch.Generator().manual_seed(4))
    for i in range(2):
        gen = torch.Generator().manual_seed(4)
        got = dropout(x[:, 3 * i:3 * (i + 1)], 0.3, gen, shard=(1, i, 2))
        torch.testing.assert_close(got, whole[:, 3 * i:3 * (i + 1)], rtol=0, atol=0)
        after = torch.Generator().manual_seed(4)
        dropout(x, 0.3, after)
        assert torch.equal(gen.get_state(), after.get_state())


@pytest.mark.parametrize("preset,mesh", [
    ("openwebtext_xl", dict(tp=2)),
    ("local_text_124m", dict(tp=5)),
    ("openwebtext", dict(tp=4, fsdp=1)),
], ids=["xl_25_heads", "heads_by_5", "tp4"])
def test_config_checks_under_tp_match_jax(preset, mesh):
    """JAX's tp checks on the presets, with its messages: GPT-2 XL's 25
    heads do not split over 2; a tp that divides everything passes."""
    from importlib import import_module

    j_cfg = import_module(f"midgpt_tpu.configs.{preset}").config
    t_cfg = load_config(preset)
    try:
        j_cfg.replace(mesh=dataclasses.replace(j_cfg.mesh, **mesh))
    except ValueError as e:
        with pytest.raises(ValueError) as t_err:
            t_cfg.replace(mesh=dataclasses.replace(t_cfg.mesh, **mesh))
        assert str(t_err.value) == str(e)
        return
    assert t_cfg.replace(mesh=dataclasses.replace(t_cfg.mesh, **mesh)).mesh.tp == mesh["tp"]


def test_launcher_and_chaos_train_take_tp(tmp_path):
    """The launcher no longer names tp among the axes it leaves unused;
    chaos_train refuses a reshard that cannot keep whole tp rows, before
    any rank starts."""
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.robustness import chaos_train

    assert not hasattr(launch, "unused_mesh")
    base = ["--config=local_text_124m", f"--rundir={tmp_path}", "--device", "cpu", "--set", "mesh.tp=2"]
    with pytest.raises(SystemExit):
        chaos_train.main([*base, "--nproc", "2", "--fault", "resume_reshard@2"])
    with pytest.raises(SystemExit):
        chaos_train.main([*base, "--nproc", "3"])


# ---------------------------------------------------------------- (b) one group of 4 ranks


K1, K2, ELASTIC_STEPS = 3, 5, 8
SETS = {"max_steps": 3, "eval_interval": 2, "eval_steps": 1, "batch_size": 4, "g_accum_iters": 1,
        "log_interval": 1, "spec_layers": 0, "warmup_steps": 1, "lr_decay_steps": 3,
        "model_config.block_size": 32, "model_config.n_layer": 2, "model_config.n_embd": 64,
        "model_config.n_head": 2, "model_config.vocab_size": 64, "model_config.attn_block_size": 16,
        "mesh.fsdp": 1, "mesh.tp": 2, "fsdp_min_size": 512}


def _jax_steps(jc, mesh, jp, x, y):
    """JAX's train step on each global batch of (x, y) from params `jp` and
    a fresh optimizer state: (losses, params, optimizer state)."""
    jp = jax.tree.map(lambda a: a + 0, jp)  # the step donates its params
    _, j_state, specs, j_opt = j_init_state(jc, mesh)
    step, _, _ = j_make_train_step(jc, j_opt, mesh, specs)
    losses = []
    for i in range(len(x)):
        jp, j_state, loss = step(jp, j_state, make_global_batch(x[i], mesh, batch_spec()),
                                 make_global_batch(y[i], mesh, batch_spec()), jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, _named(jp), _flatten(j_state)


def _jax_case(case, d):
    """JAX's step for `case` on its mesh, from the group's weights."""
    jc, _ = _case_configs(case)
    mesh = CASES[case][0]
    jmesh = j_make_mesh(jc.mesh, devices=jax.devices()[:mesh["data"] * mesh["fsdp"] * mesh["tp"]])
    jp, _, _, _ = j_init_state(jc, jmesh)
    jp = dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)
    b = np.load(d / "batches.npz")
    return _jax_steps(jc, jmesh, jp, b["x"].astype(np.int32), b["y"].astype(np.int32))


@pytest.fixture(scope="module")
def group(data_dir, tmp_path_factory):
    """Start the 4 ranks under torchrun on every job, compute JAX's side
    meanwhile, and return both."""
    d = tmp_path_factory.mktemp("tp_group")
    jobs, jax_side = [], {}
    # JAX's init of each layout, lm_head scaled so that step 0's gradient
    # norm stays under 1 (no clip) and step 1's const batch clips
    for layout, model in LAYOUTS.items():
        jc, _ = _configs(model=model, mesh=dict(data=1, fsdp=1, tp=1))
        jp = JGPT.init(jc.model_config, jax.random.PRNGKey(jc.seed))
        np.savez(d / f"w_{layout}.npz", **_flatten(dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)))
    r = np.random.default_rng(3)
    seqs = np.stack([r.integers(0, 64, (2, 4, 33)), np.full((2, 4, 33), 5)]).astype(np.int32)
    np.savez(d / "batches.npz", x=seqs[..., :-1], y=seqs[..., 1:])
    batches = str(d / "batches.npz")
    for case, (mesh, ranks, over) in CASES.items():
        _, t = _case_configs(case)
        jobs.append({"kind": "step", "config": to_json(t), "mesh": mesh, "ranks": ranks, "batches": batches,
                     "weights": str(d / f"w_{_layout(over)}.npz"), "out": str(d / f"step_{case}.npz")})
    for case, (mesh, over) in GRAD_CASES.items():
        _, t = _configs(mesh=dict(mesh), **over)
        jobs.append({"kind": "grads", "config": to_json(t), "mesh": mesh, "ranks": ALL4, "batches": batches,
                     "weights": str(d / "w_mha.npz"), "out": str(d / f"grads_{case}.npz")})
    jobs.append({"kind": "collectives", "mesh": dict(data=1, fsdp=1, tp=2), "ranks": [0, 1],
                 "out": str(d / "collectives")})
    _, td = _configs(model={"attn_impl": "naive", "dropout": 0.1}, data_dir=str(data_dir), max_steps=2,
                     lr_decay_steps=2, eval_interval=1000, eval_steps=1, log_interval=1)
    jobs.append({"kind": "dropout", "config": to_json(td), "mesh": dict(data=1, fsdp=1, tp=2), "ranks": [0, 1],
                 "out": str(d / "dropout")})
    remat = {"off": to_json(_configs()[1])}
    for policy in POLICIES:
        remat[policy] = to_json(_configs(model={"remat": True, "remat_policy": policy})[1])
    jobs.append({"kind": "remat", "configs": remat, "mesh": dict(data=1, fsdp=1, tp=2), "ranks": [2, 3],
                 "batches": batches, "weights": str(d / "w_mha.npz"), "out": str(d / "remat.npz")})
    # a tp 2 checkpoint restored on 1 rank and on (data 2, tp 2)
    _, tf = _configs(mesh=dict(data=-1, fsdp=1, tp=2), rundir=str(d / "ckpt"))
    jobs.append({"kind": "ckpt", "config": to_json(tf), "seed": 9, "step": 6,
                 "save_mesh": {"data": 1, "fsdp": 1, "tp": 2}, "save_ranks": [0, 1],
                 "restore": [[{"data": 1, "fsdp": 1}, [0]], [{"data": -1, "fsdp": 1, "tp": 2}, ALL4]],
                 "out": str(d / "f")})
    # (data 2, tp 2) -> (data 1, tp 2) -> (data 2, tp 2)
    _, te = _configs(mesh=dict(data=-1, fsdp=1, tp=2), data_dir=str(data_dir), rundir=str(d / "g_run"),
                     max_steps=ELASTIC_STEPS, lr_decay_steps=ELASTIC_STEPS, eval_interval=2, eval_steps=1,
                     log_interval=1, g_accum_iters=1, restart_backoff_sec=0.0)
    jobs.append({"kind": "elastic", "config": to_json(te), "mesh": {"data": -1, "fsdp": 1, "tp": 2},
                 "ranks2": ALL4, "ranks1": [0, 1], "k1": K1, "k2": K2, "straight": str(d / "g_straight"),
                 "out": str(d / "g.json")})
    jobs.append({"kind": "launch", "out": str(d / "launch.txt"),
                 "argv": ["--multihost", "--config=local_text_124m", "--device=cpu", f"--rundir={d / 'launch_run'}",
                          *[a for k, v in {**SETS, "data_dir": data_dir}.items() for a in ("--set", f"{k}={v}")]]})
    spec = d / "spec.json"
    spec.write_text(json.dumps({"jobs": jobs}))
    script = Path(__file__).resolve().parent / "torch_tp_train_ranks.py"
    env = {k: v for k, v in os.environ.items() if k != "MIDGPT_DIST_FILE"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
                             str(script), str(spec)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        for case in JAX_FAST:  # JAX's side while the ranks run
            jax_side[case] = _jax_case(case, d)
        out = proc.communicate(timeout=400)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    return d, jax_side


def _check_step(out, ref, prefix="", lr=1e-2):
    """`out`'s losses, params and moments against `ref`'s (an npz of the
    same keys under `prefix`, or JAX's (losses, params, state))."""
    if isinstance(ref, tuple):
        losses, params, state = ref
        moments = opt_state_from_optax(state, device=CPU)
        ref_mu = {k: v.numpy() for k, v in moments.mu.items()}
        ref_nu = {k: v.numpy() for k, v in moments.nu.items()}
    else:
        losses = ref[f"{prefix}loss"]
        params, ref_mu, ref_nu = ({k[len(prefix) + len(t) + 1:]: ref[k] for k in ref.files
                                   if k.startswith(f"{prefix}{t}.")} for t in ("p", "mu", "nu"))
    np.testing.assert_allclose(out["loss"], losses, rtol=2e-5)
    for tag, want, tol in (("mu", ref_mu, 1e-6), ("nu", ref_nu, 1e-8)):
        for k, v in want.items():
            np.testing.assert_allclose(out[f"{tag}.{k}"], v, atol=tol, rtol=0, err_msg=f"{tag} {k}")
    for k, v in params.items():
        # where a gradient cancels to the f32 noise of its sum, Adam's
        # normalised update turns the reduction order's noise into up to lr
        sound = np.sqrt(ref_nu[k]) > 10 * 1e-8
        got = out[f"p.{k}"]
        np.testing.assert_allclose(got[sound], v[sound], atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[~sound], v[~sound], atol=lr, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_step_matches_the_single_device_step(group, case):
    d, _ = group
    out = np.load(d / f"step_{case}.npz")
    _check_step(out, out, prefix="ref.")
    assert out["loss"][1] < out["loss"][0] or case == "moe_aux"  # the const batch is easier


@pytest.mark.parametrize("case", [c if c in JAX_FAST else pytest.param(c, marks=pytest.mark.slow)
                                  for c in sorted(CASES)])
def test_tp_step_matches_jax_on_the_same_mesh(group, case):
    d, jax_side = group
    ref = jax_side[case] if case in jax_side else _jax_case(case, d)
    _check_step(np.load(d / f"step_{case}.npz"), ref)


@pytest.mark.slow
def test_tp_step_matches_jax_fsdp_only_oracle(group):
    """(fsdp 2, tp 2) against JAX's (data 2, fsdp 2) step: the FSDP-only
    oracle of tests/test_tp.py, on the port's side."""
    d, _ = group
    jc, _ = _configs(mesh=dict(data=2, fsdp=2, tp=1))
    jmesh = j_make_mesh(jc.mesh, devices=jax.devices()[:4])
    jp, _, _, _ = j_init_state(jc, jmesh)
    jp = dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)
    b = np.load(d / "batches.npz")
    _check_step(np.load(d / "step_fsdp2_tp2.npz"), _jax_steps(jc, jmesh, jp, b["x"], b["y"]))


def test_shard_map_tp_matches_gspmd_tp(group):
    """JAX's test_train_step_shard_map_tp_matches_gspmd, on the port: the
    ZeRO-3 schedule with the tp collectives inside its layer loop."""
    d, _ = group
    _check_step(np.load(d / "step_fsdp2_tp2_shard_map.npz"), np.load(d / "step_fsdp2_tp2.npz"))


def _close_grads(got, want, what, tol=1e-5, scale=None):
    """Gradients within `tol` relative, and absolute of `scale` (default:
    the leaf's largest entry): the row sums partial products in another
    order than one device, and where a gradient cancels only that order's
    noise is left."""
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _grads(d, case):
    g = np.load(d / f"grads_{case}.npz")
    steps = sorted({int(k.split(".")[0]) for k in g.files})
    return g, steps


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_every_reduced_gradient_and_the_norm_match_one_device(group, case):
    """The loss is a mean over the data x fsdp batch positions: every
    leaf's reduced gradient, whole, and the clip's global norm equal one
    device's (a loss divided by the rank count would halve them)."""
    d, _ = group
    g, steps = _grads(d, case)
    assert steps == [0, 1]
    for i in steps:
        norm = g[f"{i}.ref.norm"]
        np.testing.assert_allclose(g[f"{i}.norm"], norm, rtol=1e-6)
        for k in g.files:
            if k.startswith(f"{i}.g."):
                _close_grads(g[k], g[k.replace(f"{i}.g.", f"{i}.ref.g.")], k, scale=norm)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("leaf", ["blocks.attn.q_scale", "blocks.attn.k_scale"])
def test_head_region_scales_are_summed_over_the_tp_row(group, case, leaf):
    """The QK-norm scales are whole on every tp rank but act on its heads:
    their gradient is the row's sum (one rank's share would be about half).
    Step 0's random batch (step 1's constant one cancels them to noise)."""
    d, _ = group
    g, _ = _grads(d, case)
    got, want = g[f"0.g.{leaf}"], g[f"0.ref.g.{leaf}"]
    _close_grads(got, want, leaf)
    assert np.abs(want).max() > 1e-4  # a share missing would show


@pytest.mark.parametrize("leaf", ["lm_head", "wte"])
def test_replicated_stream_leaves_are_not_summed_over_the_tp_row(group, leaf):
    """With tp_vocab off, wte and lm_head act on the replicated stream:
    every tp rank holds the whole gradient, so a sum over the row would
    double it."""
    d, _ = group
    g, steps = _grads(d, "data2_tp2_vocab_off")
    for i in steps:
        _close_grads(g[f"{i}.g.{leaf}"], g[f"{i}.ref.g.{leaf}"], leaf, scale=g[f"{i}.ref.norm"])


@pytest.mark.parametrize("rank", [0, 1])
def test_f_and_g_around_column_and_row_products_equal_the_dense_product(group, rank):
    d, _ = group
    out = np.load(d / f"collectives.{rank}.npz")
    for tag in ("y", "dx", "dw1", "dw2"):
        np.testing.assert_allclose(out[f"fg.{tag}.{rank}"], out[f"fg.{tag}.want.{rank}"], rtol=1e-5, atol=1e-6,
                                   err_msg=tag)


@pytest.mark.parametrize("batch", [2, 8], ids=["3_chunks_kept", "12_chunks_recomputed"])
@pytest.mark.parametrize("rank", [0, 1])
def test_vocab_parallel_ce_equals_the_fused_ce(group, batch, rank):
    d, _ = group
    out = np.load(d / f"collectives.{rank}.npz")
    np.testing.assert_allclose(out[f"ce{batch}.loss.{rank}"], out[f"ce{batch}.loss.want.{rank}"], rtol=1e-6)
    for tag in ("dh", "dw"):
        _close_grads(out[f"ce{batch}.{tag}.{rank}"], out[f"ce{batch}.{tag}.want.{rank}"], tag, tol=1e-6)


def test_dropout_masks_agree_across_the_tp_row(group):
    """`train` with embedding, attention-probability and residual dropout:
    both ranks of the row hold the same residual stream after every block,
    bit for bit (their generators are seeded by batch position), and the
    run is one device's drawing from the same generators (f32 limits)."""
    d, _ = group
    a, b = np.load(d / "dropout.0.npz"), np.load(d / "dropout.1.npz")
    assert len(a.files) == len(b.files) >= 8
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    runs = np.load(d / "dropout.runs.npz")
    np.testing.assert_allclose(runs["loss"], runs["ref.loss"], rtol=2e-5)
    for k in runs.files:
        if k.startswith("p."):
            np.testing.assert_allclose(runs[k], runs[f"ref.{k}"], atol=2e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_under_tp_is_bit_equal_to_off(group, policy):
    d, _ = group
    runs = np.load(d / "remat.npz")
    for k in runs.files:
        if k.startswith("off."):
            np.testing.assert_array_equal(runs[k.replace("off.", f"{policy}.", 1)], runs[k], err_msg=k)


def test_tp_checkpoint_has_single_device_bytes_and_restores_on_1_and_data2_tp2(group, tmp_path):
    d, _ = group
    _, tf = _configs(mesh=dict(data=-1, fsdp=1, tp=2))
    params, mu, nu = full_state(tf, 9)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(6, {"params": params, "opt_state": OptState(3, mu, nu, 3)}, force=True)
    mngr.close()
    for f in sorted(os.listdir(tmp_path / "6")):
        assert (tmp_path / "6" / f).read_bytes() == (d / "ckpt" / "6" / f).read_bytes(), f
    for i in (0, 1):
        out = np.load(d / f"f_{i}.npz")
        for tag, tree in (("p", params), ("mu", mu), ("nu", nu)):
            for k, v in tree.items():
                np.testing.assert_array_equal(out[f"{tag}.{k}"], v.numpy(), err_msg=f"restore {i} {tag} {k}")
    # the (data 2, tp 2) leader's shard of wte: its V/tp rows
    np.testing.assert_array_equal(np.load(d / "f_1.npz")["shard.wte"], params["wte"].numpy()[:32])


def test_tp_resume_across_data_counts_continues_the_trajectory(group):
    """(data 2, tp 2) preempted at step K1, resumed on (data 1, tp 2) and
    preempted at K2, resumed on (data 2, tp 2): the final eval loss is the
    straight run's; on_resume_mesh='same' refuses the smaller mesh."""
    d, _ = group
    rec = json.loads((d / "g.json").read_text())
    assert rec["preempted"] == [True, True]
    assert "on_resume_mesh='same' refuses" in rec["refused"]
    assert [m["n_devices"] for m in rec["mesh_history"]] == [4, 2, 4]
    assert [(m["axes"]["data"], m["axes"]["tp"]) for m in rec["mesh_history"]] == [(2, 2), (1, 2), (2, 2)]
    a, b = _losses(d / "g_straight"), _losses(d / "g_run")
    assert sorted(a) == sorted(b) == list(range(ELASTIC_STEPS))
    np.testing.assert_allclose([b[s] for s in a], [a[s] for s in a], rtol=1e-5)


def _losses(rundir) -> dict:
    recs = [json.loads(line) for line in Path(rundir, "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r["loss/optimized"] for r in recs if "loss/optimized" in r}


def test_launch_multihost_trains_on_mesh_tp(group):
    d, _ = group
    text = (d / "launch.txt").read_text()
    assert "'tp': 2" in text and "over 4 rank(s), backend gloo" in text
    recs = [json.loads(line) for line in (d / "launch_run" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/optimized"] for r in recs if "loss/optimized" in r]
    assert len(losses) == SETS["max_steps"] and all(np.isfinite(losses))
    assert sorted(int(s) for s in os.listdir(d / "launch_run") if s.isdigit())[-1] == SETS["max_steps"] - 1


@pytest.mark.slow
def test_chaos_train_resumes_across_data_counts_with_tp_fixed(data_dir, tmp_path):
    """chaos_train's reshard on 4 ranks under tp 2: 4 -> 2 ranks (data 2
    -> 1), the loss at JAX's f32 parity bound against an unfaulted run."""
    sets = {**SETS, "max_steps": 4, "lr_decay_steps": 4, "data_dir": data_dir}
    argv = [sys.executable, "-m", "midgpt_tpu_torch.robustness.chaos_train", "--config=local_text_124m",
            f"--rundir={tmp_path / 'run'}", "--device", "cpu", "--nproc", "4", "--fault", "resume_reshard@2",
            *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["loss_parity"] and rec["supervisor"]["mesh_history"][-1]["n_devices"] == 2
    assert rec["final_mesh"]["axes"]["tp"] == 2
