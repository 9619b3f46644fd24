"""Port parity, pipeline training (parallel/pipeline.py: GPipe and 1F1B
over the mesh's pp axis; parallel/mesh.py's pp groups; models/gpt.py
`GPT.stage` and the sharded-at-birth `GPT.init(shard=)`; the pp rules of
parallel/fsdp.py `reduce_grads`, training/optim.py `global_norm`,
training/checkpoint.py and `launch --multihost --set mesh.pp=N`): JAX
runs on the 8 virtual CPU devices of tests/conftest.py, the port on gloo
CPU ranks (one torch thread each) that torchrun starts.

  (a) no processes: the specs against JAX's pipeline_param_specs on the
      meshes of tests/test_pipeline.py; the sharded-at-birth init against
      the dense init's slices, bit for bit, on fsdp 2, tp 2, sp 2, pp 2
      and (fsdp 2, tp 2, pp 2); the mesh's fill order and groups against
      JAX's device layout under pp, and at pp 1 the groups (and their
      order of creation) of the slices before the pipeline; each rank's
      rows against JAX's batch shards; JAX's config checks with its
      messages; the launcher's note;
  (b) one group of 4 ranks under `torchrun --standalone` runs every job
      (tests/torch_pp_ranks.py) while the test runs JAX's functions:
      - on pp 2 with JAX's CFG (4 layers of 64, f32, its weights through
        convert.py): the port's GPipe loss, eval and reduced gradients
        against JAX's make_pipeline_loss, its 1F1B against
        make_pipeline_loss_and_grad; the CE rows each stage ran (B/pp for
        GPipe, Bm/pp a microbatch for 1F1B) and the stage sends;
      - two f32 steps of (fsdp 2, pp 2) under 1F1B and of (tp 2, pp 2)
        under GPipe against the single-device trainer; the reduced
        gradients and the clip's norm of (data 2, pp 2) against one
        device's;
      - 1F1B's stash high-water mark at M 4 (a fixed microbatch);
      - a pp 2 checkpoint with the single-device bytes, restored on one
        rank and on (fsdp 2, pp 2); a one-rank checkpoint restored on pp 2;
      - `launch --multihost --device cpu --set mesh.pp=2 --set
        pipeline_schedule=1f1b` on the 4 ranks.
  `-m slow` adds one group of 8 ranks: (data 2, fsdp 2, pp 2) under GPipe
  against one device, and 1F1B's stash at M 16.

Tolerances (float32): against JAX, loss 1e-5 relative, gradients 1e-6
absolute and 1e-5 relative; against one device, as
tests/test_torch_tp_train.py states them (losses 2e-5 relative, params
2e-5 absolute or lr where a gradient cancels, mu 1e-6, nu 1e-8, reduced
gradients 1e-5 of the step's global norm). The init and the checkpoint
bytes are bit for bit."""

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
from midgpt_tpu.parallel.fsdp import constrain
from midgpt_tpu.parallel.mesh import batch_spec
from midgpt_tpu.parallel.mesh import make_mesh as j_make_mesh
from midgpt_tpu.parallel.pipeline import make_pipeline_loss, make_pipeline_loss_and_grad
from midgpt_tpu.parallel.pipeline import pipeline_param_specs as j_pipeline_param_specs
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, to_json
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, param_shapes
from midgpt_tpu_torch.parallel import fsdp
from midgpt_tpu_torch.parallel.data import rank_rows
from midgpt_tpu_torch.parallel.mesh import make_mesh
from midgpt_tpu_torch.parallel.pipeline import pipeline_param_specs
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.optim import OptState
from midgpt_tpu_torch.training.train import state_specs

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import full_state  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CFG = dict(block_size=32, vocab_size=128, n_layer=4, n_head=2, n_embd=64)  # tests/test_pipeline.py's
MODEL = dict(CFG, vocab_size=64, n_head=4, attn_impl="flash", attn_block_size=16)  # the steps' (the flash op's plain body)
ALL4 = [0, 1, 2, 3]
JAX_B, JAX_M = 8, 4  # the JAX-parity batch: 4 microbatches of 2 rows (1 a stage in 1F1B's CE)
# the step cases: (mesh, ranks, config overrides)
CASES = {
    "fsdp2_pp2_1f1b": (dict(data=1, fsdp=2, pp=2), ALL4, {"pipeline_schedule": "1f1b", "pipeline_microbatches": 2}),
    "tp2_pp2_gpipe": (dict(data=1, fsdp=1, tp=2, pp=2), ALL4, {"pipeline_microbatches": 4}),
}
GRAD_CASES = {"data2_pp2_gpipe": (dict(data=2, fsdp=1, pp=2), {"pipeline_microbatches": 2})}
SLOW_CASES = {"data2_fsdp2_pp2_gpipe": (dict(data=2, fsdp=2, pp=2), list(range(8)), {})}
SETS = {"max_steps": 3, "eval_interval": 2, "eval_steps": 1, "batch_size": 8, "g_accum_iters": 1,
        "log_interval": 1, "spec_layers": 0, "warmup_steps": 1, "lr_decay_steps": 3,
        "model_config.block_size": 32, "model_config.n_layer": 2, "model_config.n_embd": 64,
        "model_config.n_head": 2, "model_config.vocab_size": 64, "model_config.attn_block_size": 16,
        "mesh.fsdp": 1, "mesh.pp": 2, "pipeline_schedule": "1f1b", "pipeline_microbatches": 2,
        "fsdp_min_size": 512}


def _configs(model=None, **over):
    base = dict(
        rundir="", data_dir="", learning_rate=1e-2, batch_size=8, warmup_steps=1, min_lr=1e-3,
        lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=10,
        param_dtype="float32", compute_dtype="float32", g_accum_iters=2, shard_model=True,
        fsdp_min_size=512, eval_steps=2,
    )
    mesh = dict(sp=1, **over.pop("mesh", dict(data=1, fsdp=1, pp=2)))
    base.update(over)
    model = dict(MODEL if model is None else model)
    j = JExperimentConfig(**base, mesh=JMeshConfig(**mesh), model_config=JGPTConfig(**model))
    t = ExperimentConfig(**base, mesh=MeshConfig(**mesh), model_config=GPTConfig(**model))
    return j, t


def _port_config(model, mesh, **over):
    """The port's config alone (no JAX twin), the steps' other fields."""
    base = dataclasses.asdict(_configs()[1])
    base.pop("model_config"), base.pop("mesh")
    return ExperimentConfig(**dict(base, **over), mesh=MeshConfig(**mesh), model_config=GPTConfig(**model))


def _named(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v) for p, v in leaves}


def _spec_tuples(specs, shapes) -> dict:
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]:
        name = jax.tree_util.keystr(path).lstrip(".")
        out[name] = tuple(spec) + (None,) * (len(shapes[name]) - len(spec))
    return out


def _ns_mesh(axes: dict, r: int) -> types.SimpleNamespace:
    """Rank r's axis sizes and indices on a (data, fsdp, sp, tp, pp) mesh,
    as parallel/mesh.py numbers them (pp fastest)."""
    a = {k: axes.get(k, 1) for k in ("data", "fsdp", "sp", "tp", "pp")}
    return types.SimpleNamespace(**a, pp_index=r % a["pp"], tp_index=(r // a["pp"]) % a["tp"],
                                 sp_index=(r // (a["pp"] * a["tp"])) % a["sp"],
                                 fsdp_index=(r // (a["pp"] * a["tp"] * a["sp"])) % a["fsdp"])


# ---------------------------------------------------------------- (a) no processes


@pytest.mark.parametrize("min_size", [0, 2**18], ids=["min0", "min_default"])
@pytest.mark.parametrize("shard_model", [True, False], ids=["shard", "replicate"])
@pytest.mark.parametrize("mesh", [dict(data=4, pp=2), dict(data=2, pp=4), dict(fsdp=2, pp=4), dict(data=2, fsdp=2, pp=2),
                                  dict(fsdp=2, tp=2, pp=2), dict(tp=2, pp=2)],
                         ids=["data4_pp2", "data2_pp4", "fsdp2_pp4", "data2_fsdp2_pp2", "fsdp2_tp2_pp2", "tp2_pp2"])
def test_pipeline_param_specs_match_jax(mesh, shard_model, min_size):
    """Leaf by leaf, JAX's pipeline_param_specs: the layer axis over 'pp',
    fsdp on another axis, the Megatron axis over 'tp', wte and lm_head
    pp- and tp-replicated."""
    jcfg = JGPTConfig(**CFG)
    full = {**dict(data=1, fsdp=1, sp=1, tp=1, pp=1), **mesh}
    n = full["data"] * full["fsdp"] * full["tp"] * full["pp"]
    jmesh = j_make_mesh(JMeshConfig(**full), devices=jax.devices()[:n])
    abstract = jax.eval_shape(lambda k: JGPT.init(jcfg, k), jax.random.PRNGKey(0))
    shapes = param_shapes(GPTConfig(**CFG))
    want = _spec_tuples(j_pipeline_param_specs(abstract, jmesh, shard_model, min_size), shapes)
    got = pipeline_param_specs(shapes, {"fsdp": full["fsdp"], "tp": full["tp"]}, shard_model, min_size)
    assert got == want
    assert all(got[k][0] == "pp" for k in got if k.startswith("blocks."))
    t = _port_config(CFG, full, shard_model=shard_model, fsdp_min_size=min_size)
    assert state_specs(t, types.SimpleNamespace(**full)) == got


INIT_MESHES = {"fsdp2": dict(fsdp=2), "tp2": dict(tp=2), "sp2": dict(sp=2), "pp2": dict(pp=2),
               "fsdp2_tp2_pp2": dict(fsdp=2, tp=2, pp=2)}
LAYOUTS = {"mha": {}, "gqa": {"n_kv_heads": 2}, "moe": {"n_experts": 4, "moe_top_k": 2}}


@pytest.mark.parametrize("mesh,layout", [(m, lay) for m in INIT_MESHES for lay in LAYOUTS
                                         if not ("pp" in INIT_MESHES[m] and lay == "moe")])  # MoE refuses pp
def test_sharded_at_birth_init_is_the_dense_init_sliced(mesh, layout):
    """GPT.init(shard=ShardedInit) on every rank of the mesh: each leaf is
    the dense init's slice under the training specs, bit for bit, and
    allocated at the shard's shape (the generator still steps through the
    pieces a rank skips)."""
    mesh, layout = INIT_MESHES[mesh], LAYOUTS[layout]
    cfg = GPTConfig(**dict(MODEL, **layout))
    dense = GPT.init(cfg, 7, device=CPU)
    t = _port_config(dict(MODEL, **layout), mesh, fsdp_min_size=0)
    size = int(np.prod(list(mesh.values())))
    shapes = param_shapes(cfg)
    for r in range(size):
        m = _ns_mesh(mesh, r)
        specs = state_specs(t, m)
        got = GPT.init(cfg, 7, device=CPU, shard=fsdp.ShardedInit(specs, m, shapes))
        assert list(got) == list(dense)
        for k, v in dense.items():
            want = fsdp.shard(v, specs[k], m)
            assert got[k].shape == want.shape and torch.equal(got[k], want), (r, k)


def test_mesh_lays_out_pp_as_jax_lays_out_devices(monkeypatch):
    """Rank i of a (data 2, tp 2, pp 2) mesh sits where JAX's make_mesh
    puts device i (pp the fastest axis); every group but pp_group and the
    whole group stays inside one stage, pp_group spans a position's
    stages, and the neighbours are the adjacent stages."""
    jmesh = j_make_mesh(JMeshConfig(data=2, fsdp=1, sp=1, tp=2, pp=2), devices=jax.devices()[:8])
    coords = {int(d.id): idx for idx, d in np.ndenumerate(jmesh.devices)}
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for r in range(8):
        monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
        m = make_mesh(MeshConfig(data=2, fsdp=1, tp=2, pp=2), ranks=range(8), device=CPU)
        d, _, _, t, p, _ = coords[r]
        assert (m.data_index, m.tp_index, m.pp_index, m.batch_index) == (d, t, p, d)
        same = lambda *axes: tuple(sorted(q for q, c in coords.items()  # noqa: E731
                                          if all(c[a] == coords[r][a] for a in axes)))
        assert m.tp_group == same(0, 4) and m.data_group == same(3, 4) and m.pp_group == same(0, 3)
        assert m.batch_group == same(3, 4) and m.stage_group == same(4) and m.group == tuple(range(8))
        assert m.prev_stage == (r - 1 if p else None) and m.next_stage == (r + 1 if p == 0 else None)


def _old_groups(D, F, S, T):
    """The process groups the mesh created before the pipeline, in their
    order of creation (the (data, fsdp, sp, tp) layout, tp fastest)."""
    at = lambda d, f, s, t: ((d * F + f) * S + s) * T + t  # noqa: E731
    calls = [tuple(range(D * F * S * T))]
    rows = [[at(d, f, s, t) for t in range(T)] for d in range(D) for f in range(F) for s in range(S)]
    lists = []
    if T > 1:
        lists.append(rows)
    if F > 1:
        lists.append([[at(d, f, s, t) for f in range(F)] for d in range(D) for s in range(S) for t in range(T)])
    if D > 1:
        lists.append([[at(d, f, s, t) for d in range(D)] for f in range(F) for s in range(S) for t in range(T)])
    if S > 1:
        lists.append([[at(d, f, s, t) for s in range(S)] for d in range(D) for f in range(F) for t in range(T)])
    if D > 1 and S > 1:
        lists.append([[at(d, f, s, t) for d in range(D) for s in range(S)] for f in range(F) for t in range(T)])
    if T > 1 and D * F * S > 1:
        lists.append([[row[t] for row in rows] for t in range(T)])
    for members in lists:
        calls += [] if len(members) == 1 else [tuple(m) for m in members]
    return calls


@pytest.mark.parametrize("mesh", [dict(data=2, fsdp=2, tp=2), dict(data=2, sp=2, tp=2), dict(fsdp=2, sp=2),
                                  dict(data=4)], ids=["data2_fsdp2_tp2", "data2_sp2_tp2", "fsdp2_sp2", "data4"])
def test_make_mesh_at_pp1_keeps_its_groups(mesh, monkeypatch):
    """At pp 1 the mesh creates the groups it created before the pipeline,
    in the same order (every rank creates every group), and each rank's
    indices and neighbours are unchanged (no pp group, no neighbours)."""
    made = []
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: made.append(tuple(ranks)) or tuple(ranks))
    full = dict(dict(data=1, fsdp=1, sp=1, tp=1), **mesh)
    n = int(np.prod(list(full.values())))
    monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda: n - 1)
    m = make_mesh(MeshConfig(**full), ranks=range(n), device=CPU)
    assert made == _old_groups(full["data"], full["fsdp"], full["sp"], full["tp"])
    assert (m.pp, m.pp_index, m.pp_group, m.prev_stage, m.next_stage) == (1, 0, None, None, None)
    assert m.stage_group == m.group and m.batch_index == (n - 1) // (full["sp"] * full["tp"])


@pytest.mark.parametrize("mesh", [dict(data=2, pp=2), dict(fsdp=2, pp=2), dict(data=2, tp=2, pp=2)],
                         ids=["data2_pp2", "fsdp2_pp2", "data2_tp2_pp2"])
def test_rows_follow_the_batch_position_under_pp(mesh, monkeypatch):
    """Each rank keeps the rows JAX's batch_spec places on its device: the
    stages of a position (and the ranks of its tp row) the same ones."""
    full = dict(dict(data=1, fsdp=1, sp=1, tp=1), **mesh)
    n = int(np.prod(list(full.values())))
    jmesh = j_make_mesh(JMeshConfig(**full), devices=jax.devices()[:n])
    x = np.arange(2 * 8 * 5, dtype=np.int32).reshape(2, 8, 5)
    shards = {int(s.device.id): np.asarray(s.data) for s in make_global_batch(x, jmesh, batch_spec()).addressable_shards}
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for r in range(n):
        monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
        m = make_mesh(MeshConfig(**full), ranks=range(n), device=CPU)
        np.testing.assert_array_equal(rank_rows(x, m), shards[int(jmesh.devices.flat[r].id)])


CHECKS = {
    "layers": ({"mesh": dict(fsdp=1, pp=3)}, {}),
    "dropout": ({"mesh": dict(fsdp=1, pp=2)}, {"dropout": 0.1}),
    "shard_map": ({"mesh": dict(fsdp=1, pp=2), "fsdp_mode": "shard_map"}, {}),
    "sp": ({"mesh": dict(fsdp=1, sp=2, pp=2)}, {}),
    "ring": ({"mesh": dict(fsdp=1, pp=2)}, {"attn_impl": "ring"}),
    "1f1b_tp": ({"mesh": dict(fsdp=1, tp=2, pp=2), "pipeline_schedule": "1f1b"}, {}),
    "batch": ({"mesh": dict(fsdp=1, pp=2), "pipeline_microbatches": 3}, {}),
    "schedule": ({"mesh": dict(fsdp=1, pp=2), "pipeline_schedule": "zb"}, {}),
    "microbatches": ({"mesh": dict(fsdp=1, pp=2), "pipeline_microbatches": -1}, {}),
    "moe": ({"mesh": dict(fsdp=1, pp=2)}, {"n_experts": 4, "moe_top_k": 2}),
    "moe_aux": ({"mesh": dict(fsdp=1, pp=2), "moe_aux_coef": 0.01}, {"n_experts": 4, "moe_top_k": 2}),
    "tp_vocab_exempt": ({"mesh": dict(fsdp=1, tp=2, pp=2)}, {"vocab_size": 95}),
    "fsdp_ok": ({"mesh": dict(fsdp=2, pp=2)}, {}),
    "tp_ok": ({"mesh": dict(fsdp=1, tp=2, pp=2)}, {}),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_config_checks_under_pp_match_jax(case):
    """JAX's pipeline checks (and its MoE and tp_vocab ones under pp), with
    its messages; what JAX accepts, the port accepts."""
    over, model = CHECKS[case]
    over = {k: (dict(v) if isinstance(v, dict) else v) for k, v in over.items()}
    base = dict(rundir="", data_dir="", learning_rate=1e-3, batch_size=8, warmup_steps=1, min_lr=1e-4,
                lr_decay_steps=10, max_steps=10, beta2=0.99, weight_decay=0.0, eval_interval=5,
                param_dtype="float32", compute_dtype="float32", g_accum_iters=1, shard_model=True)
    mesh = over.pop("mesh")
    kw = dict(base, **over)
    try:
        JExperimentConfig(**kw, mesh=JMeshConfig(**mesh), model_config=JGPTConfig(**dict(CFG, **model)))
    except ValueError as e:
        with pytest.raises(ValueError) as t_err:
            ExperimentConfig(**kw, mesh=MeshConfig(**mesh), model_config=GPTConfig(**dict(CFG, **model)))
        assert str(t_err.value) == str(e)
        return
    assert case.endswith(("_ok", "_exempt"))
    assert ExperimentConfig(**kw, mesh=MeshConfig(**mesh), model_config=GPTConfig(**dict(CFG, **model))).mesh.pp == 2


def test_launcher_and_mesh_take_pp(monkeypatch):
    """The launcher names no axis it leaves unused (every axis trains); a
    training mesh lays pp out, and beside ep (MoE refuses pp, the mesh
    does not) a stage's neighbours are ep ranks apart."""
    from midgpt_tpu_torch import launch

    assert not hasattr(launch, "unused_mesh")
    m = make_mesh(MeshConfig(data=1, fsdp=1, pp=1), ranks=[0], device=CPU)
    assert (m.pp, m.pp_index, m.prev_stage, m.next_stage) == (1, 0, None, None)
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda: 1)
    m = make_mesh(MeshConfig(data=1, fsdp=1, pp=2, ep=2), ranks=range(4), device=CPU)
    assert (m.pp_index, m.ep_index, m.pp_group, m.ep_group, m.prev_stage, m.next_stage) == (0, 1, (1, 3), (0, 1),
                                                                                            None, 3)


# ---------------------------------------------------------------- (b) groups of ranks


def _jax_pipeline(d):
    """JAX's GPipe value and grad and its 1F1B loss and grad on pp 2, from
    the weights and the batch the ranks read."""
    jcfg = JGPTConfig(**CFG)
    jmesh = j_make_mesh(JMeshConfig(data=1, fsdp=1, sp=1, tp=1, pp=2), devices=jax.devices()[:2])
    jp = JGPT.init(jcfg, jax.random.PRNGKey(0))
    specs = j_pipeline_param_specs(jp, jmesh)
    sharded = jax.jit(lambda p: constrain(p, specs, jmesh))(jp)
    b = np.load(d / "jax_batch.npz")
    xg, yg = (make_global_batch(b[n][0].astype(np.int32), jmesh, batch_spec(with_accum=False)) for n in ("x", "y"))
    pipe = make_pipeline_loss(jcfg, jmesh, specs, 8192, microbatches=JAX_M)
    out = {}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, a, c: pipe(p, a, c, None)))(sharded, xg, yg)
    out["gpipe"] = (float(loss), _named(grads))
    lag = make_pipeline_loss_and_grad(jcfg, jmesh, specs, 8192, microbatches=JAX_M)
    loss, grads = jax.jit(lambda p, a, c: lag(p, a, c, None))(sharded, xg, yg)
    out["1f1b"] = (float(loss), _named(grads))
    return out


def _run_group(d, jobs, n, side=None, timeout=400):
    spec = d / "spec.json"
    spec.write_text(json.dumps({"jobs": jobs}))
    script = Path(__file__).resolve().parent / "torch_pp_ranks.py"
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


def _step_batches(d, name, B):
    r = np.random.default_rng(3)
    seqs = np.stack([r.integers(0, 64, (2, B, 33)), np.full((2, B, 33), 5)]).astype(np.int32)
    np.savez(d / name, x=seqs[..., :-1], y=seqs[..., 1:])
    return str(d / name)


def _weights(d, model, name):
    jc = JGPTConfig(**model)
    jp = JGPT.init(jc, jax.random.PRNGKey(0))
    np.savez(d / name, **_named(dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)))
    return str(d / name)


def _step_jobs(d, cases, batches, weights):
    jobs = []
    for case, (mesh, ranks, over) in cases.items():
        _, t = _configs(mesh=dict(mesh), **over)
        jobs.append({"kind": "step", "config": to_json(t), "mesh": mesh, "ranks": ranks, "batches": batches,
                     "weights": weights, "out": str(d / f"step_{case}.npz")})
    return jobs


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
def group(data_dir, tmp_path_factory):
    """Start the 4 ranks under torchrun on every job, compute JAX's side
    meanwhile, and return both."""
    d = tmp_path_factory.mktemp("pp_group")
    jobs = []
    jp = JGPT.init(JGPTConfig(**CFG), jax.random.PRNGKey(0))
    np.savez(d / "w_jax.npz", **_named(jp))
    r = np.random.default_rng(1)
    seq = r.integers(0, CFG["vocab_size"], (1, JAX_B, CFG["block_size"] + 1)).astype(np.int32)
    np.savez(d / "jax_batch.npz", x=seq[..., :-1], y=seq[..., 1:])
    for schedule in ("gpipe", "1f1b"):
        _, t = _configs(model=CFG, mesh=dict(data=1, fsdp=1, pp=2), batch_size=JAX_B, g_accum_iters=1,
                        pipeline_schedule=schedule, pipeline_microbatches=JAX_M)
        jobs.append({"kind": "pipe", "config": to_json(t), "mesh": dict(data=1, fsdp=1, pp=2), "ranks": [0, 1],
                     "weights": str(d / "w_jax.npz"), "batches": str(d / "jax_batch.npz"),
                     "out": str(d / f"pipe_{schedule}.npz")})
    batches, weights = _step_batches(d, "batches.npz", 8), _weights(d, MODEL, "w_model.npz")
    jobs += _step_jobs(d, CASES, batches, weights)
    for case, (mesh, over) in GRAD_CASES.items():
        _, t = _configs(mesh=dict(mesh), **over)
        jobs.append({"kind": "grads", "config": to_json(t), "mesh": mesh, "ranks": ALL4, "batches": batches,
                     "weights": weights, "out": str(d / f"grads_{case}.npz")})
    _, ts = _configs(pipeline_schedule="1f1b")
    jobs.append({"kind": "stash", "config": to_json(ts), "mesh": dict(data=1, fsdp=1, pp=2), "ranks": [2, 3],
                 "weights": weights, "microbatches": [4], "micro": 2, "out": str(d / "stash.json")})
    # a pp 2 checkpoint restored on 1 rank and on (fsdp 2, pp 2); a one-rank checkpoint restored on pp 2
    _, tf = _configs(mesh=dict(data=-1, fsdp=1, pp=2), rundir=str(d / "ckpt"))
    jobs.append({"kind": "ckpt", "config": to_json(tf), "seed": 9, "step": 6,
                 "save_mesh": {"data": 1, "fsdp": 1, "pp": 2}, "save_ranks": [0, 1],
                 "restore": [[{"data": 1, "fsdp": 1}, [0]], [{"data": 1, "fsdp": 2, "pp": 2}, ALL4]],
                 "out": str(d / "f")})
    _, t1 = _configs(mesh=dict(data=-1, fsdp=1, pp=2), rundir=str(d / "ckpt1"))
    jobs.append({"kind": "ckpt", "config": to_json(t1), "seed": 9, "step": 6,
                 "save_mesh": {"data": 1, "fsdp": 1}, "save_ranks": [0],
                 "restore": [[{"data": 1, "fsdp": 1, "pp": 2}, [2, 3]]], "out": str(d / "f1")})
    jobs.append({"kind": "launch", "out": str(d / "launch.txt"),
                 "argv": ["--multihost", "--config=local_text_124m", "--device=cpu", f"--rundir={d / 'launch_run'}",
                          *[a for k, v in {**SETS, "data_dir": data_dir}.items() for a in ("--set", f"{k}={v}")]]})
    return d, _run_group(d, jobs, 4, side=lambda: _jax_pipeline(d))


def _check_step(out, prefix="ref.", lr=1e-2):
    """`out`'s losses, params and moments against the single-device run's
    (the same keys under `prefix`)."""
    ref = {k[len(prefix):]: out[k] for k in out.files if k.startswith(prefix)}
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=2e-5)
    for tag, tol in (("mu", 1e-6), ("nu", 1e-8)):
        for k in (k for k in ref if k.startswith(f"{tag}.")):
            np.testing.assert_allclose(out[k], ref[k], atol=tol, rtol=0, err_msg=k)
    for k in (k for k in ref if k.startswith("p.")):
        # where a gradient cancels to the f32 noise of its sum, Adam's
        # normalised update turns the reduction order's noise into up to lr
        sound = np.sqrt(ref[k.replace("p.", "nu.", 1)]) > 10 * 1e-8
        np.testing.assert_allclose(out[k][sound], ref[k][sound], atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(out[k][~sound], ref[k][~sound], atol=lr, rtol=0, err_msg=k)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_matches_jax_on_pp2(group, schedule):
    """The port's schedule on 2 gloo ranks against JAX's on the pp 2 mesh
    (make_pipeline_loss's value and grad, make_pipeline_loss_and_grad):
    the loss, GPipe's eval forward, and every reduced gradient, whole."""
    d, jax_side = group
    out = np.load(d / f"pipe_{schedule}.npz")
    loss, grads = jax_side[schedule]
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(out["eval"], jax_side["gpipe"][0], rtol=1e-5)
    assert sorted(k[2:] for k in out.files if k.startswith("g.")) == sorted(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(out[f"g.{k}"], v, atol=1e-6, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_each_stage_runs_the_ce_on_b_over_pp_rows(group, schedule):
    """The v2 loss (JAX's test_pipeline_ce_volume_sharded_over_pp): every
    stage runs the final norm and the CE on its 1/pp of the rows, once for
    GPipe's whole batch, once a microbatch for 1F1B (then once for the
    eval's GPipe forward); the stage sends are the schedule's (activations
    one way, their gradients back)."""
    d, _ = group
    out = np.load(d / f"pipe_{schedule}.npz")
    train = [JAX_B // 2] if schedule == "gpipe" else [JAX_B // JAX_M // 2] * JAX_M
    want = [train + [JAX_B // 2]] * 2
    assert out["rows"].tolist() == want
    sends = json.loads(str(out["sends"]))
    # stage 0 (the leader): an activation a microbatch forward, its CE rows' gradients back (1F1B: a microbatch)
    assert sends["fwd"] == JAX_M and "bwd" not in sends
    assert sends["ce"] == (1 if schedule == "gpipe" else JAX_M)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp_step_matches_the_single_device_step(group, case):
    d, _ = group
    out = np.load(d / f"step_{case}.npz")
    _check_step(out)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_reduced_gradients_and_the_norm_match_one_device(group, case):
    """Block gradients summed only inside their stage, wte's and lm_head's
    over the stages too, the loss a mean over the batch positions: every
    leaf's reduced gradient, whole, and the clip's global norm (each
    stage's layers once, the replicated leaves once) equal one device's."""
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


def test_1f1b_stash_is_bounded_by_2pp(group):
    """1F1B's defining bound (JAX's test_1f1b_activation_stash_is_m_independent):
    at most 2 pp live stashed microbatches on each stage (here 2 pp - 1 on
    stage 0: B runs before F in a tick)."""
    d, _ = group
    marks = json.loads((d / "stash.json").read_text())
    assert [m["4"] for m in marks] == [3, 1]


def test_pp_checkpoint_restores_on_one_rank_and_back(group, tmp_path):
    """A pp 2 checkpoint has the single-device bytes (the layer axis
    gathered whole) and restores on one rank and on (fsdp 2, pp 2); a
    one-rank checkpoint restores on pp 2."""
    d, _ = group
    _, tf = _configs(mesh=dict(data=-1, fsdp=1, pp=2))
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


def test_launch_multihost_trains_on_mesh_pp(group):
    d, _ = group
    text = (d / "launch.txt").read_text()
    assert "'pp': 2" in text and "'data': 2" in text and "over 4 rank(s), backend gloo" in text
    assert "not ported yet" not in text
    recs = [json.loads(line) for line in (d / "launch_run" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/optimized"] for r in recs if "loss/optimized" in r]
    assert len(losses) == SETS["max_steps"] and all(np.isfinite(losses))
    assert any("loss/val_final" in r and np.isfinite(r["loss/val_final"]) for r in recs)
    assert sorted(int(s) for s in os.listdir(d / "launch_run") if s.isdigit())[-1] == SETS["max_steps"] - 1


@pytest.fixture(scope="module")
def slow_group(tmp_path_factory):
    """8 ranks: (data 2, fsdp 2, pp 2) under GPipe against one device, and
    1F1B's stash at M 16."""
    d = tmp_path_factory.mktemp("pp_slow")
    batches, weights = _step_batches(d, "batches.npz", 8), _weights(d, MODEL, "w_model.npz")
    jobs = _step_jobs(d, SLOW_CASES, batches, weights)
    _, ts = _configs(pipeline_schedule="1f1b")
    jobs.append({"kind": "stash", "config": to_json(ts), "mesh": dict(data=1, fsdp=1, pp=2), "ranks": [0, 1],
                 "weights": weights, "microbatches": [4, 16], "micro": 2, "out": str(d / "stash.json")})
    _run_group(d, jobs, 8, timeout=600)
    return d


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(SLOW_CASES))
def test_pp_step_on_8_ranks_matches_the_single_device_step(slow_group, case):
    out = np.load(slow_group / f"step_{case}.npz")
    _check_step(out)


@pytest.mark.slow
def test_1f1b_stash_is_the_same_at_m4_and_m16(slow_group):
    marks = json.loads((slow_group / "stash.json").read_text())
    assert [(m["4"], m["16"]) for m in marks] == [(3, 3), (1, 1)]
