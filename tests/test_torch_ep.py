"""Port parity, expert-parallel training (the ep axis of parallel/mesh.py,
parallel/tp.py `EPTrain`, models/gpt.py `hidden(ep_train=)`, the ep rules
of parallel/fsdp.py `reduce_grads`, `gather_ep` and `ShardedInit`,
training/optim.py `global_norm`, training/checkpoint.py and `launch
--multihost --set mesh.ep=N`): JAX runs on the 8 virtual CPU devices of
tests/conftest.py, the port on gloo CPU ranks (one torch thread each)
that torchrun starts.

  (a) no processes: the training specs against JAX's tp_param_specs on
      meshes with ep (the banks' expert axis over 'ep', fsdp on their last
      axis, every other leaf the fsdp/tp rule); the sharded-at-birth init
      under ep against the dense init's slices, bit for bit; the mesh's
      fill order and groups against JAX's device layout (ep fastest,
      every group but ep_group, pp_group and the whole group inside one ep
      index); each rank's rows against JAX's batch shards (the ep ranks of
      a position read the same rows); JAX's config checks under ep with
      its messages; chaos_train's whole sp x tp x pp x ep blocks;
  (b) one group of 4 ranks under `torchrun --standalone` runs every job
      (tests/torch_ep_ranks.py) while the test runs JAX's steps:
      - the routed MLP of one layer on ep 2 (the rank's experts, f and g)
        against the whole MLP: output, aux term, the gradients into h,
        the router and the rank's experts;
      - two f32 MoE steps (aux coefficient 0.01; the second clips) of
        (ep 2) and (fsdp 2, ep 2) against JAX's make_train_step on the
        same mesh and against the single-device trainer, and of (tp 2,
        ep 2) and (sp 2, ep 2) (the ring) against the single-device
        trainer;
      - the reduced gradients and the clip's norm of (data 2, ep 2) and of
        (fsdp 2, ep 2) (every leaf fsdp-sharded) against one device's: a
        bank's over the ranks that saw other rows, a replicated leaf's
        never over ep;
      - an (fsdp 2, ep 2) checkpoint with the single-device bytes,
        restored on one rank and on (ep 2); a one-rank checkpoint restored
        on (fsdp 2, ep 2);
      - `launch --multihost --device cpu --set mesh.ep=2` on the 4 ranks.
  `-m slow` adds one group of 8 ranks: (data 2, fsdp 2, ep 2) against
  JAX's step on the same mesh (tests/test_moe.py's ep cell) and one
  device, and chaos_train's resume_reshard under ep 2 (4 ranks, 2, 4).

Tolerances (float32): losses 1e-5 relative; parameters 2e-5 absolute, as
tests/test_torch_parallel.py and tests/test_torch_tp_train.py hold them
(a wrong reduction moves a weight by ~lr, 1e-2 here; Adam's normalised
update turns the reduction order's f32 noise in a small gradient entry
into up to ~1.3e-5 on a few of wqkv's 24,573 entries, against JAX and
against one device alike, and within lr where a gradient cancels to that
noise); mu 1e-6 and nu 1e-8 absolute; reduced gradients 1e-5 relative and within 1e-5 of the
step's global norm; the routed MLP's output and gradients 1e-5 relative
and within 1e-6 of their largest entry (the combine's partial sums over E
are added in another order). The init and the checkpoint bytes are bit
for bit."""

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
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, to_json
from midgpt_tpu_torch.convert import opt_state_from_optax
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, param_shapes
from midgpt_tpu_torch.parallel import fsdp
from midgpt_tpu_torch.parallel.data import rank_rows
from midgpt_tpu_torch.parallel.mesh import make_mesh
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.optim import OptState
from midgpt_tpu_torch.training.train import state_specs

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import full_state  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MOE = dict(n_experts=4, moe_top_k=2)
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=64, attn_impl="flash", attn_block_size=16,
             **MOE)
LAYOUTS = {"moe": {}, "gqa_moe": {"n_kv_heads": 2}}
AXES = ("data", "fsdp", "sp", "tp", "pp", "ep")
ALL4 = [0, 1, 2, 3]
LR = 1e-2
# the step cases: (mesh, ranks, config overrides)
CASES = {
    "ep2": (dict(data=1, fsdp=1, ep=2), [0, 1], {}),
    "fsdp2_ep2": (dict(data=1, fsdp=2, ep=2), ALL4, {}),
    "tp2_ep2": (dict(data=1, fsdp=1, tp=2, ep=2), ALL4, {}),
    "sp2_ep2": (dict(data=1, fsdp=1, sp=2, ep=2), ALL4, {"model": {"attn_impl": "ring"}}),
}
JAX_CASES = ("ep2", "fsdp2_ep2")  # held to JAX's step on the same mesh
GRAD_CASES = {
    "data2_ep2": (dict(data=2, fsdp=1, ep=2), {}),
    "fsdp2_ep2_all_sharded": (dict(data=1, fsdp=2, ep=2), {"fsdp_min_size": 0}),
}
SLOW_CASES = {"data2_fsdp2_ep2": (dict(data=2, fsdp=2, ep=2), list(range(8)), {})}
SETS = {"max_steps": 3, "eval_interval": 2, "eval_steps": 1, "batch_size": 4, "g_accum_iters": 1,
        "log_interval": 1, "spec_layers": 0, "warmup_steps": 1, "lr_decay_steps": 3,
        "model_config.block_size": 32, "model_config.n_layer": 2, "model_config.n_embd": 64,
        "model_config.n_head": 2, "model_config.vocab_size": 64, "model_config.attn_block_size": 16,
        "model_config.n_experts": 4, "model_config.moe_top_k": 2, "moe_aux_coef": 0.01,
        "mesh.fsdp": 1, "mesh.ep": 2, "fsdp_min_size": 512}


def _configs(**over):
    base = dict(
        rundir="", data_dir="", learning_rate=LR, batch_size=4, warmup_steps=1, min_lr=1e-3,
        lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=10,
        param_dtype="float32", compute_dtype="float32", g_accum_iters=2, shard_model=True,
        fsdp_min_size=512, eval_steps=2, moe_aux_coef=0.01,
    )
    model = dict(MODEL, **over.pop("model", {}))
    mesh = dict(dict(sp=1), **over.pop("mesh", dict(data=1, fsdp=1, ep=2)))
    base.update(over)
    j = JExperimentConfig(**base, mesh=JMeshConfig(**mesh), model_config=JGPTConfig(**model))
    t = ExperimentConfig(**base, mesh=MeshConfig(**mesh), model_config=GPTConfig(**model))
    return j, t


def _case_configs(case):
    mesh, _, over = {**CASES, **SLOW_CASES}[case]
    over = {k: (dict(v) if isinstance(v, dict) else v) for k, v in over.items()}
    return _configs(mesh=dict(mesh), **over)


def _flatten(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _named(tree) -> dict:
    return {k.lstrip("."): v for k, v in _flatten(tree).items()}


def _full(mesh: dict) -> dict:
    return {ax: mesh.get(ax, 1) for ax in AXES}


def _ns_mesh(axes: dict, r: int) -> types.SimpleNamespace:
    """Rank r's axis sizes and indices on a mesh, as parallel/mesh.py
    numbers them (ep fastest)."""
    a = _full(axes)
    idx, stride = {}, 1
    for ax in reversed(AXES):
        idx[f"{ax}_index"] = (r // stride) % a[ax]
        stride *= a[ax]
    return types.SimpleNamespace(**a, **idx)


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


@pytest.mark.parametrize("vocab", [True, False], ids=["tp_vocab", "tp_vocab_off"])
@pytest.mark.parametrize("min_size", [0, 2**18], ids=["min0", "min_default"])
@pytest.mark.parametrize("mesh", [dict(ep=2), dict(fsdp=2, ep=2), dict(tp=2, ep=2), dict(fsdp=2, tp=2, ep=2),
                                  dict(ep=4)], ids=["ep2", "fsdp2_ep2", "tp2_ep2", "fsdp2_tp2_ep2", "ep4"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_state_specs_match_jax(layout, mesh, min_size, vocab):
    """The training state's specs are JAX's tp_param_specs, leaf for leaf:
    the banks' expert axis over 'ep' (fsdp on their last axis where it
    divides), every other leaf the fsdp/tp rule."""
    model = dict(MODEL, **LAYOUTS[layout])
    full = _full(mesh)
    n = int(np.prod(list(full.values())))
    abstract = jax.eval_shape(lambda k: JGPT.init(JGPTConfig(**model), k), jax.random.PRNGKey(0))
    jmesh = j_make_mesh(JMeshConfig(**full), devices=jax.devices()[:n])
    shapes = param_shapes(GPTConfig(**model))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            j_tp_param_specs(abstract, jmesh, True, min_size, vocab_parallel=vocab),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]:
        name = jax.tree_util.keystr(path).lstrip(".")
        want[name] = tuple(spec) + (None,) * (len(shapes[name]) - len(spec))
    _, t = _configs(model=LAYOUTS[layout], mesh=full, tp_vocab=vocab, fsdp_min_size=min_size)
    got = state_specs(t, types.SimpleNamespace(**full))
    assert got == want
    for name in ("blocks.mlp.experts_up", "blocks.mlp.experts_down"):
        assert got[name][1] == "ep" and (got[name][3] == "fsdp") == (full["fsdp"] > 1 and (
            min_size == 0 or np.prod(shapes[name]) > min_size))
    assert "ep" not in got["blocks.mlp.router"]


@pytest.mark.parametrize("mesh", [dict(ep=2), dict(fsdp=2, ep=2), dict(tp=2, ep=2), dict(sp=2, ep=4)],
                         ids=["ep2", "fsdp2_ep2", "tp2_ep2", "sp2_ep4"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_at_birth_init_is_the_dense_init_sliced(layout, mesh):
    """GPT.init(shard=ShardedInit) on every rank of the mesh: each leaf is
    the dense init's slice under the training specs, bit for bit, each
    bank holding only the rank's experts (the generator still steps
    through the experts a rank skips)."""
    cfg = GPTConfig(**dict(MODEL, **LAYOUTS[layout]))
    dense = GPT.init(cfg, 7, device=CPU)
    _, t = _configs(model=LAYOUTS[layout], mesh=_full(mesh), fsdp_min_size=0)
    shapes = param_shapes(cfg)
    for r in range(int(np.prod(list(mesh.values())))):
        m = _ns_mesh(mesh, r)
        specs = state_specs(t, m)
        got = GPT.init(cfg, 7, device=CPU, shard=fsdp.ShardedInit(specs, m, shapes))
        assert list(got) == list(dense)
        E = cfg.n_experts // m.ep
        assert got["blocks.mlp.experts_up"].shape[1] == E
        for k, v in dense.items():
            want = fsdp.shard(v, specs[k], m)
            assert got[k].shape == want.shape and torch.equal(got[k], want), (r, k)
        torch.testing.assert_close(got["blocks.mlp.experts_down"], dense["blocks.mlp.experts_down"][
            :, m.ep_index * E:(m.ep_index + 1) * E].chunk(m.fsdp, dim=3)[m.fsdp_index], rtol=0, atol=0)


@pytest.mark.parametrize("mesh", [dict(data=2, fsdp=2, ep=2), dict(sp=2, tp=2, ep=2)],
                         ids=["data2_fsdp2_ep2", "sp2_tp2_ep2"])
def test_mesh_lays_out_ep_as_jax_lays_out_devices(mesh, monkeypatch):
    """Rank i sits where JAX's make_mesh puts device i (ep the fastest
    axis), each group holds the ranks JAX's axes name, and every group but
    ep_group and the whole group lies inside one ep index."""
    full = _full(mesh)
    jmesh = j_make_mesh(JMeshConfig(**full), devices=jax.devices()[:8])
    coords = {int(d.id): idx for idx, d in np.ndenumerate(jmesh.devices)}
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for r in range(8):
        monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
        m = make_mesh(MeshConfig(**full), ranks=range(8), device=CPU)
        c = coords[r]
        assert tuple(getattr(m, f"{ax}_index") for ax in AXES) == c
        assert m.batch_index == c[0] * full["fsdp"] + c[1]
        same = lambda *axes: tuple(sorted(q for q, k in coords.items()  # noqa: E731
                                          if all(k[a] == c[a] for a in axes)))
        assert m.ep_group == same(0, 1, 2, 3, 4) and m.group == tuple(range(8))
        named = {"tp_group": (0, 1, 2, 4, 5), "fsdp_group": (0, 2, 3, 4, 5), "data_group": (1, 2, 3, 4, 5),
                 "sp_group": (0, 1, 3, 4, 5), "batch_group": (3, 4, 5), "stage_group": (4, 5)}
        for group, axes in named.items():
            members = same(*axes)
            assert getattr(m, group) == (members if len(members) > 1 else None), (r, group)


@pytest.mark.parametrize("mesh", [dict(ep=2), dict(data=2, ep=2), dict(fsdp=2, ep=2), dict(data=2, sp=2, ep=2)],
                         ids=["ep2", "data2_ep2", "fsdp2_ep2", "data2_sp2_ep2"])
def test_rows_follow_the_batch_position_under_ep(mesh, monkeypatch):
    """Each rank keeps the rows (and, under sp, the columns) JAX's
    batch_spec places on its device: the ep ranks of a position the same
    ones."""
    full = _full(mesh)
    n = int(np.prod(list(full.values())))
    jmesh = j_make_mesh(JMeshConfig(**full), devices=jax.devices()[:n])
    x = np.arange(2 * 8 * 6, dtype=np.int32).reshape(2, 8, 6)
    spec = batch_spec(shard_seq=full["sp"] > 1)
    shards = {int(s.device.id): np.asarray(s.data) for s in make_global_batch(x, jmesh, spec).addressable_shards}
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for r in range(n):
        monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
        m = make_mesh(MeshConfig(**full), ranks=range(n), device=CPU)
        np.testing.assert_array_equal(rank_rows(x, m), shards[int(jmesh.devices.flat[r].id)])


CHECKS = {
    "dense": ({"mesh": dict(ep=2)}, {"n_experts": 0}),
    "indivisible": ({"mesh": dict(ep=2)}, {"n_experts": 3}),
    "shard_map": ({"mesh": dict(ep=2), "fsdp_mode": "shard_map"}, {}),
    "pp": ({"mesh": dict(ep=2, pp=2)}, {}),
    "aux_pp": ({"mesh": dict(ep=2, pp=2), "moe_aux_coef": 0.01}, {}),
    "ep4_ok": ({"mesh": dict(ep=4)}, {}),
    "fsdp_ok": ({"mesh": dict(fsdp=2, ep=2)}, {}),
    "tp_ok": ({"mesh": dict(tp=2, ep=2)}, {}),
    "sp_ring_ok": ({"mesh": dict(sp=2, ep=2)}, {"attn_impl": "ring"}),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_config_checks_under_ep_match_jax(case):
    """JAX's MoE checks under ep, with its messages; what JAX accepts, the
    port accepts."""
    over, model = CHECKS[case]
    over = {k: (dict(v) if isinstance(v, dict) else v) for k, v in over.items()}
    mesh = dict(dict(data=-1, fsdp=1, sp=1), **over.pop("mesh"))
    kw = dict(rundir="", data_dir="", learning_rate=1e-3, batch_size=8, warmup_steps=1, min_lr=1e-4,
              lr_decay_steps=10, max_steps=10, beta2=0.99, weight_decay=0.0, eval_interval=5,
              param_dtype="float32", compute_dtype="float32", g_accum_iters=1, shard_model=True, **over)
    model = dict(MODEL, **model)
    try:
        JExperimentConfig(**kw, mesh=JMeshConfig(**mesh), model_config=JGPTConfig(**model))
    except ValueError as e:
        with pytest.raises(ValueError) as t_err:
            ExperimentConfig(**kw, mesh=MeshConfig(**mesh), model_config=GPTConfig(**model))
        assert str(t_err.value) == str(e)
        assert not case.endswith("_ok")
        return
    assert case.endswith("_ok")
    assert ExperimentConfig(**kw, mesh=MeshConfig(**mesh), model_config=GPTConfig(**model)).mesh.ep == mesh["ep"]


def test_chaos_train_keeps_whole_ep_blocks(tmp_path):
    """chaos_train refuses a rank count that splits a position's ep group,
    and a reshard that cannot keep whole blocks, before any rank starts."""
    from midgpt_tpu_torch.robustness import chaos_train

    base = ["--config=local_text_124m", f"--rundir={tmp_path}", "--device", "cpu", "--set", "mesh.ep=2",
            "--set", "model_config.n_experts=4"]
    with pytest.raises(SystemExit):
        chaos_train.main([*base, "--nproc", "3"])
    with pytest.raises(SystemExit):
        chaos_train.main([*base, "--nproc", "2", "--fault", "resume_reshard@2"])


# ---------------------------------------------------------------- (b) groups of ranks


def _check_step(out, ref, prefix="", lr=LR):
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
    np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
    assert sorted(params) == sorted(k[2:] for k in out.files if k.startswith("p."))
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


def _jax_case(case, d):
    """JAX's two steps for `case` on its mesh from the group's weights and
    batches: (losses, params, optimizer state)."""
    jc, _ = _case_configs(case)
    mesh = _full({**CASES, **SLOW_CASES}[case][0])
    jmesh = j_make_mesh(jc.mesh, devices=jax.devices()[:int(np.prod(list(mesh.values())))])
    jp, j_state, specs, j_opt = j_init_state(jc, jmesh)
    jp = dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)
    assert "ep" in str(specs.blocks.mlp.experts_up)  # the experts really shard over 'ep'
    step, _, _ = j_make_train_step(jc, j_opt, jmesh, specs)
    b = np.load(d / "batches.npz")
    losses = []
    for i in range(len(b["x"])):
        jp, j_state, loss = step(jp, j_state, make_global_batch(b["x"][i].astype(np.int32), jmesh, batch_spec()),
                                 make_global_batch(b["y"][i].astype(np.int32), jmesh, batch_spec()),
                                 jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, _named(jp), _flatten(j_state)


def _run_group(d, jobs, n, side=None, timeout=400):
    spec = d / "spec.json"
    spec.write_text(json.dumps({"jobs": jobs}))
    script = Path(__file__).resolve().parent / "torch_ep_ranks.py"
    env = {k: v for k, v in os.environ.items() if k != "MIDGPT_DIST_FILE"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n),
                             str(script), str(spec)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        got = side() if side is not None else None  # the test's side while the ranks run
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    return got


def _inputs(d):
    """JAX's init (lm_head scaled so that step 0's gradient norm stays
    under 1 and the const batch of step 1 clips) and two steps' batches."""
    jc, _ = _configs(mesh=dict(data=1, fsdp=1))
    jp = JGPT.init(jc.model_config, jax.random.PRNGKey(jc.seed))
    np.savez(d / "w.npz", **_flatten(dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)))
    r = np.random.default_rng(3)
    seqs = np.stack([r.integers(0, 64, (2, 4, 33)), np.full((2, 4, 33), 5)]).astype(np.int32)
    np.savez(d / "batches.npz", x=seqs[..., :-1], y=seqs[..., 1:])
    return str(d / "w.npz"), str(d / "batches.npz")


def _step_jobs(d, cases, weights, batches):
    jobs = []
    for case, (mesh, ranks, _) in cases.items():
        _, t = _case_configs(case)
        jobs.append({"kind": "step", "config": to_json(t), "mesh": mesh, "ranks": ranks, "batches": batches,
                     "weights": weights, "out": str(d / f"step_{case}.npz")})
    return jobs


@pytest.fixture(scope="module")
def group(data_dir, tmp_path_factory):
    """Start the 4 ranks under torchrun on every job, compute JAX's steps
    meanwhile, and return both."""
    d = tmp_path_factory.mktemp("ep_group")
    weights, batches = _inputs(d)
    jobs = _step_jobs(d, CASES, weights, batches)
    for case, (mesh, over) in GRAD_CASES.items():
        _, t = _configs(mesh=dict(mesh), **over)
        jobs.append({"kind": "grads", "config": to_json(t), "mesh": mesh, "ranks": ALL4, "batches": batches,
                     "weights": weights, "out": str(d / f"grads_{case}.npz")})
    _, tm = _configs()
    jobs.append({"kind": "moe_mlp", "config": to_json(tm), "mesh": dict(data=1, fsdp=1, ep=2), "ranks": [2, 3],
                 "out": str(d / "moe_mlp")})
    # an (fsdp 2, ep 2) checkpoint restored on 1 rank and on (ep 2); a one-rank checkpoint restored on (fsdp 2, ep 2)
    _, tf = _configs(mesh=dict(data=-1, fsdp=2, ep=2), rundir=str(d / "ckpt"))
    jobs.append({"kind": "ckpt", "config": to_json(tf), "seed": 9, "step": 6,
                 "save_mesh": {"data": 1, "fsdp": 2, "ep": 2}, "save_ranks": ALL4,
                 "restore": [[{"data": 1, "fsdp": 1}, [0]], [{"data": 1, "fsdp": 1, "ep": 2}, [2, 3]]],
                 "out": str(d / "f")})
    _, t1 = _configs(mesh=dict(data=-1, fsdp=2, ep=2), rundir=str(d / "ckpt1"))
    jobs.append({"kind": "ckpt", "config": to_json(t1), "seed": 9, "step": 6,
                 "save_mesh": {"data": 1, "fsdp": 1}, "save_ranks": [1],
                 "restore": [[{"data": 1, "fsdp": 2, "ep": 2}, ALL4]], "out": str(d / "f1")})
    jobs.append({"kind": "launch", "out": str(d / "launch.txt"),
                 "argv": ["--multihost", "--config=local_text_124m", "--device=cpu", f"--rundir={d / 'launch_run'}",
                          *[a for k, v in {**SETS, "data_dir": data_dir}.items() for a in ("--set", f"{k}={v}")]]})
    jax_side = _run_group(d, jobs, 4, side=lambda: {case: _jax_case(case, d) for case in JAX_CASES})
    return d, jax_side


def test_ep_moe_mlp_is_the_whole_mlp(group):
    """EPTrain's f and g around the rank's experts: the whole MLP's output
    and aux term on every rank, the whole gradient into h and the router,
    and the rank's experts' share of the banks' gradients."""
    d, _ = group
    for r in (0, 1):
        out = np.load(d / f"moe_mlp.{r}.npz")
        keys = [k for k in out.files if not k.startswith("want.")]
        assert sorted(keys) == ["aux", "d.mlp.experts_down", "d.mlp.experts_up", "d.mlp.router", "dh", "out"]
        for k in keys:
            want = out[f"want.{k}"]
            np.testing.assert_allclose(out[k], want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=f"{r} {k}")


@pytest.mark.parametrize("case", JAX_CASES)
def test_ep_step_matches_jax_on_the_same_mesh(group, case):
    d, jax_side = group
    _check_step(np.load(d / f"step_{case}.npz"), jax_side[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_step_matches_the_single_device_step(group, case):
    d, _ = group
    out = np.load(d / f"step_{case}.npz")
    _check_step(out, out, prefix="ref.")
    assert out["p.blocks.mlp.experts_up"].shape[1] == MOE["n_experts"]  # gathered whole


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_reduced_gradients_and_the_norm_match_one_device(group, case):
    """Each bank's gradient summed over the ranks of its ep index that saw
    other rows, the replicated leaves' (the router among them) over the
    batch positions only, the loss a mean over the batch positions: every
    leaf's reduced gradient, whole, and the clip's global norm (each
    expert once) equal one device's."""
    d, _ = group
    g = np.load(d / f"grads_{case}.npz")
    steps = sorted({int(k.split(".")[0]) for k in g.files})
    assert steps == [0, 1]
    for i in steps:
        norm = g[f"{i}.ref.norm"]
        np.testing.assert_allclose(g[f"{i}.norm"], norm, rtol=1e-6)
        for k in g.files:
            if k.startswith(f"{i}.g."):
                want = g[k.replace(f"{i}.g.", f"{i}.ref.g.")]
                np.testing.assert_allclose(g[k], want, rtol=1e-5, atol=1e-5 * norm, err_msg=k)


def test_ep_checkpoint_restores_on_one_rank_and_back(group, tmp_path):
    """An (fsdp 2, ep 2) checkpoint has the single-device bytes (the
    expert axis gathered whole) and restores on one rank and on (ep 2); a
    one-rank checkpoint restores on (fsdp 2, ep 2)."""
    d, _ = group
    _, tf = _configs(mesh=dict(data=-1, fsdp=2, ep=2))
    params, mu, nu = full_state(tf, 9)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(6, {"params": params, "opt_state": OptState(3, mu, nu, 3)}, force=True)
    mngr.close()
    for f in sorted(os.listdir(tmp_path / "6")):
        assert (tmp_path / "6" / f).read_bytes() == (d / "ckpt" / "6" / f).read_bytes(), f
    for name in ("f_0", "f_1", "f1_0"):
        out = np.load(d / f"{name}.npz")
        for tag, tree in (("p", params), ("mu", mu), ("nu", nu)):
            for k, v in tree.items():
                np.testing.assert_array_equal(out[f"{tag}.{k}"], v.numpy(), err_msg=f"restore {name} {tag} {k}")


def test_launch_multihost_trains_on_mesh_ep(group):
    d, _ = group
    text = (d / "launch.txt").read_text()
    assert "'ep': 2" in text and "'data': 2" in text and "over 4 rank(s), backend gloo" in text
    assert "not ported yet" not in text
    recs = [json.loads(line) for line in (d / "launch_run" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/optimized"] for r in recs if "loss/optimized" in r]
    assert len(losses) == SETS["max_steps"] and all(np.isfinite(losses))
    assert any("loss/val_final" in r and np.isfinite(r["loss/val_final"]) for r in recs)
    assert sorted(int(s) for s in os.listdir(d / "launch_run") if s.isdigit())[-1] == SETS["max_steps"] - 1


@pytest.fixture(scope="module")
def slow_group(data_dir, tmp_path_factory):
    """8 ranks: (data 2, fsdp 2, ep 2) against JAX and one device, and
    chaos_train's reshard under ep 2."""
    d = tmp_path_factory.mktemp("ep_slow")
    weights, batches = _inputs(d)
    jobs = _step_jobs(d, SLOW_CASES, weights, batches)
    sets = {**SETS, "data_dir": data_dir, "max_steps": 6, "lr_decay_steps": 6, "eval_interval": 2}
    jobs.append({"kind": "chaos", "out": str(d / "chaos.json"),
                 "argv": ["--config=local_text_124m", f"--rundir={d / 'chaos_run'}", "--device", "cpu", "--nproc",
                          "4", "--fault", "resume_reshard@2", "--fault", "resume_reshard@4",
                          *[a for k, v in sets.items() if k != "log_interval" for a in ("--set", f"{k}={v}")]]})
    jax_side = _run_group(d, jobs, 8, side=lambda: {case: _jax_case(case, d) for case in SLOW_CASES}, timeout=600)
    return d, jax_side


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(SLOW_CASES))
def test_ep_step_on_8_ranks_matches_jax_and_one_device(slow_group, case):
    d, jax_side = slow_group
    out = np.load(d / f"step_{case}.npz")
    _check_step(out, jax_side[case])
    _check_step(out, out, prefix="ref.")


@pytest.mark.slow
def test_chaos_train_reshards_under_ep(slow_group):
    """resume_reshard@2 and @4 on 4 ranks of (data 2, ep 2): 4 ranks, then
    2 (data 1, ep 2), then 4 again, the final loss at f32 parity with an
    unfaulted run on 4."""
    d, _ = slow_group
    got = json.loads((d / "chaos.json").read_text())
    summary = json.loads(got["stdout"].strip().splitlines()[-1])
    assert got["rc"] == 0 and summary["status"] == "ok", summary
    history = summary["supervisor"]["mesh_history"]
    assert [(m["n_devices"], m["axes"]["data"], m["axes"]["ep"]) for m in history] == [(4, 2, 2), (2, 1, 2), (4, 2, 2)]
    assert summary["loss_parity"] is True
