"""Port parity, the data and fsdp axes (parallel/): JAX runs on the 8
virtual CPU devices of tests/conftest.py, the port on gloo CPU ranks (one
torch thread each) that torchrun starts, or that a test starts itself and
joins through a FileStore.

  (a) fsdp_leaf_spec and make_mesh against JAX's fsdp_param_specs and
      make_mesh (no processes);
  (b) each rank's rows under shard_by_process against JAX's sample_batch
      on JAX's per-process slice, 2 nodes x 2 ranks (no processes);
  (b)-(j) one group of 4 ranks under `torchrun --standalone` runs every
      job (tests/torch_parallel_ranks.py) while the test computes JAX's
      side:
  (b) `train` on 2 nodes x 2 ranks (torchrun's node variables set so)
      against JAX's step on a (data=2, fsdp=2) mesh fed as JAX's 2
      processes feed it, each from its slice of the stream: the per-step
      losses, the final eval loss, params and moments;
  (c) JAX's step on a (data=2, fsdp=2) mesh against 4 ranks, 2 steps of
      G 2 in f32 from the same weights, under both fsdp_modes; step 1
      takes the clip branch, step 0 does not;
  (d) one rank's launcher-free `train` equals the single-device trainer
      bit for bit (losses and the checkpoint's bytes);
  (e) the routed MLP with moe_aux_coef on 2 data ranks against JAX's
      (data=2) step (the aux term's means over the global batch);
  (f) a checkpoint saved on 2 ranks has the bytes of one saved by a
      single device, and restores whole on 1 and on 4 ranks;
  (g) the resume from 2 ranks to 1 and back to 2 continues the
      uninterrupted run's trajectory; on_resume_mesh="same" refuses;
  (i) `launch --multihost --device cpu` on the group's 4 ranks;
  (j) `chaos_train` in rank 0 prints JAX's train_chaos fields
      (ckpt_enospc on one rank; `-m slow`: resume_reshard from 2 ranks
      to 1 and back, from the test process);
  (h) a SIGTERM to one of 2 launcher ranks (FileStore) saves once and
      both exit 0.

Tolerances (float32 throughout): step losses 1e-5 relative and
parameters 2e-5 absolute over two steps (as tests/test_torch_train.py:
the ranks sum f32 gradients in another order than XLA's reduction; Adam's
normalised update turns a relative gradient difference into an absolute
parameter one of about lr times it, and within lr where a gradient
cancels to f32 noise, see `_check_step`); mu 1e-6 and nu 1e-8 absolute
(the moments are a gradient and its square: one f32 ulp of each at these
magnitudes, times a few reductions); the eval loss 1e-5 relative; the
elastic trajectory 1e-5 relative, chaos_train's float32 parity bound
(JAX's: f32 reassociation only)."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.data.dataset import TokenDataset as JTokenDataset
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.parallel.data import make_global_batch
from midgpt_tpu.parallel.fsdp import fsdp_param_specs
from midgpt_tpu.parallel.mesh import batch_spec
from midgpt_tpu.parallel.mesh import make_mesh as j_make_mesh
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_train_step as j_make_train_step
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, load_config, to_json
from midgpt_tpu_torch.convert import opt_state_from_optax, write_step
from midgpt_tpu_torch.data.dataset import TokenDataset
from midgpt_tpu_torch.models.gpt import GPTConfig, param_shapes
from midgpt_tpu_torch.parallel import fsdp
from midgpt_tpu_torch.parallel.data import node_batch_size, rank_rows
from midgpt_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.optim import OptState
from midgpt_tpu_torch.training.train import state_template, train

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import full_state  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=64, attn_impl="flash", attn_block_size=16)
PRESETS = ("shakespeare_char", "openwebtext", "openwebtext_mh", "openwebtext_xl", "local_text_124m",
           "local_text_124m_10k", "wide610m", "llama7b_long", "llama7b_32k")


def _configs(**over):
    base = dict(
        rundir="", data_dir="", learning_rate=1e-2, batch_size=4, warmup_steps=1, min_lr=1e-3,
        lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=10,
        param_dtype="float32", compute_dtype="float32", g_accum_iters=2, shard_model=True,
        fsdp_min_size=512, eval_steps=2,
    )
    model = dict(MODEL, **over.pop("model", {}))
    mesh = over.pop("mesh", dict(data=2, fsdp=2, sp=1))
    base.update(over)
    j = JExperimentConfig(**base, mesh=JMeshConfig(**mesh), model_config=JGPTConfig(**model))
    t = ExperimentConfig(**base, mesh=MeshConfig(**mesh), model_config=GPTConfig(**model))
    return j, t


def _flatten(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _named(tree) -> dict:
    return {k.lstrip("."): v for k, v in _flatten(tree).items()}


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


def _env(rank: int, world: int, store: Path, local_world: int = None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    local_world = local_world or world
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
               LOCAL_WORLD_SIZE=str(local_world), GROUP_RANK=str(rank // local_world),
               MIDGPT_DIST_FILE=str(store))
    return env


# ---------------------------------------------------------------- (a) the leaf rule and the mesh


def _shape_configs():
    """GPT-2 small, a GQA and a routed-MLP shape (the three leaf layouts)."""
    small = dict(block_size=1024, vocab_size=50304, n_layer=12, n_head=12, n_embd=768)
    return {
        "gpt2_small": small,
        "gqa": dict(small, n_layer=2, n_head=12, n_kv_heads=4),
        "moe": dict(small, n_layer=2, n_experts=8, moe_top_k=2),
    }


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", sorted(_shape_configs()))
def test_leaf_specs_match_jax(shape, n_shards):
    """Every leaf shards on JAX's axis (or stays replicated) at 1-8 shards,
    for each leaf layout."""
    model = _shape_configs()[shape]
    abstract = jax.eval_shape(lambda k: JGPT.init(JGPTConfig(**model), k), jax.random.PRNGKey(0))
    mesh = j_make_mesh(JMeshConfig(data=-1, fsdp=n_shards, sp=1), devices=jax.devices()[:n_shards])
    want = {}
    specs = fsdp_param_specs(abstract, mesh)
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]:
        axes = [i for i, e in enumerate(spec) if e == "fsdp"]
        want[jax.tree_util.keystr(path).lstrip(".")] = axes[0] if axes else None
    got = fsdp.param_specs(param_shapes(GPTConfig(**model)), n_shards)
    assert got == want
    if n_shards > 1:
        assert got["wte"] == 1 and got["blocks.attn.q_scale"] is None


@pytest.mark.parametrize("preset", PRESETS)
def test_mesh_shape_matches_jax(preset, monkeypatch):
    """JAX's arithmetic on each preset's MeshConfig at 1-16 devices: the
    -1 inference, the fsdp clamp and the error text; a mesh with sp, tp,
    pp or ep above 1 lays out on the ranks (llama7b_32k's sp 8 on 8)."""
    from importlib import import_module

    j_mesh_cfg = import_module(f"midgpt_tpu.configs.{preset}").config.mesh
    cfg = load_config(preset).mesh
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for n in (1, 2, 4, 8):
        try:
            want = dict(j_make_mesh(j_mesh_cfg, devices=jax.devices()[:n]).shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).replace("*", r"\*")):
                mesh_shape(cfg, n)
            continue
        assert mesh_shape(cfg, n) == want, n
        if all(mesh_shape(cfg, n)[ax] == 1 for ax in ("sp", "tp", "pp", "ep")):
            m = make_mesh(cfg, ranks=[0], device=CPU) if n == 1 else None
            assert m is None or (m.size, m.group) == (1, None)
        else:
            m = make_mesh(dataclasses.replace(cfg, data=-1), ranks=list(range(n)), device=CPU)
            assert m.shape == want and m.size == n


def test_mesh_refuses_unported_axes_and_fills_in_order(monkeypatch):
    """No axis refuses any more: sp, tp, pp and ep lay out (their groups:
    tests/test_torch_sp.py, tests/test_torch_tp_train.py,
    tests/test_torch_pipeline.py, tests/test_torch_ep.py), last axis
    fastest."""
    with pytest.raises(ValueError, match="mesh 3x2x1x1x1x1 != 4 devices"):
        mesh_shape(MeshConfig(data=3, fsdp=2), 4)
    m = Mesh({"data": 2, "fsdp": 2, "sp": 1, "tp": 1, "pp": 1, "ep": 1}, [0], CPU)
    assert (m.index, m.data_index, m.fsdp_index, m.is_leader) == (0, 0, 0, True)
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda: 1)
    m = make_mesh(MeshConfig(data=1, fsdp=1, tp=2), ranks=[0, 1], device=CPU)
    assert (m.shape["tp"], m.index, m.tp_index, m.batch_index, m.tp_group) == (2, 1, 1, 0, (0, 1))
    m = make_mesh(MeshConfig(data=1, fsdp=1, sp=2), ranks=[0, 1], device=CPU)
    assert (m.shape["sp"], m.index, m.sp_index, m.batch_index, m.sp_group) == (2, 1, 1, 0, (0, 1))
    m = make_mesh(MeshConfig(data=1, fsdp=1, pp=2), ranks=[0, 1], device=CPU)
    assert (m.shape["pp"], m.index, m.pp_index, m.batch_index, m.pp_group, m.prev_stage) == (2, 1, 1, 0, (0, 1), 0)
    m = make_mesh(MeshConfig(data=1, fsdp=1, ep=2), ranks=[0, 1], device=CPU)
    assert (m.shape["ep"], m.index, m.ep_index, m.batch_index, m.ep_group, m.stage_group) == (2, 1, 1, 0, (0, 1), None)


@pytest.mark.parametrize("over", [
    {"fsdp_mode": "zero3"},
    {"fsdp_mode": "shard_map", "moe_aux_coef": 0.01, "model": {"n_experts": 4}},
    {"fsdp_mode": "shard_map", "mesh": dict(data=-1, fsdp=1, sp=2, tp=2)},
], ids=["unknown_mode", "moe_aux_with_shard_map", "shard_map_tp_sp"])
def test_config_refuses_what_jax_refuses(over):
    """JAX's FSDP-mode checks, with its messages."""
    with pytest.raises(ValueError) as j_err:
        _configs(**{k: (dict(v) if isinstance(v, dict) else v) for k, v in over.items()})
    with pytest.raises(ValueError) as t_err:
        ExperimentConfig(**{f.name: getattr(_configs()[1], f.name) for f in dataclasses.fields(ExperimentConfig)
                            if f.name not in ("mesh", "model_config", *over)},
                         mesh=MeshConfig(**over.get("mesh", dict(data=2, fsdp=2, sp=1))),
                         model_config=GPTConfig(**dict(MODEL, **over.get("model", {}))),
                         **{k: v for k, v in over.items() if k not in ("mesh", "model")})
    assert str(t_err.value) == str(j_err.value)


def test_dist_refuses_a_backend_that_cannot_start(monkeypatch):
    """No quiet fallback: an unknown backend, or NCCL for CPU ranks, raises
    before any process group exists; without one the run is rank 0 of 1
    on node 0 of 1, and torchrun's variables name the node."""
    from midgpt_tpu_torch.parallel import dist

    with pytest.raises(ValueError, match="unknown backend 'mpi'"):
        dist.init("cpu", "mpi")
    with pytest.raises(ValueError, match="'nccl' needs CUDA ranks"):
        dist.init("cpu", "nccl")
    assert not dist.initialized() and (dist.rank(), dist.world(), dist.node(), dist.n_nodes()) == (0, 1, 0, 1)
    for k, v in _env(5, 8, Path("unused"), local_world=4).items():
        monkeypatch.setenv(k, v)
    assert (dist.node(), dist.n_nodes(), dist.local_rank(), dist.local_world()) == (1, 2, 1, 4)


# ---------------------------------------------------------------- (b) the data split


def test_rows_by_node_match_jax_processes(data_dir, monkeypatch):
    """2 nodes x 2 ranks: node n holds JAX process n's slice of each split,
    draws JAX's process-local batch, and rank r of it keeps rows
    [r*b, (r+1)*b): the global batch in (data, fsdp) order."""
    B, T, G = 8, 16, 2
    for node in (0, 1):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda node=node: node)
        jds = JTokenDataset(str(data_dir), seed=5, shard_by_process=True)
        for local in (0, 1):
            rank = 2 * node + local
            for k, v in _env(rank, 4, data_dir / "unused", local_world=2).items():
                monkeypatch.setenv(k, v)
            tds = TokenDataset(str(data_dir), seed=5, shard_by_process=True)
            for split in ("train", "val"):
                np.testing.assert_array_equal(tds[split], jds[split])
            mesh = types.SimpleNamespace(size=4, index=rank, tp=1, sp=1, batch_size=4, batch_index=rank)  # rank r of (2, 2)
            nb = node_batch_size(B, mesh)
            assert nb == B // 2
            for split, step in (("train", 3), ("val", 7)):
                jx, jy = jds.batch(split, step, T, nb, G)
                tx, ty = tds.batch(split, step, T, nb, G)
                np.testing.assert_array_equal(rank_rows(tx, mesh), jx[:, local * 2:(local + 1) * 2])
                np.testing.assert_array_equal(rank_rows(ty, mesh), jy[:, local * 2:(local + 1) * 2])


# ---------------------------------------------------------------- (c)-(g): one group of 4 ranks


K1, K2, ELASTIC_STEPS = 3, 5, 8
# the launcher's and chaos_train's runs: --set overrides of local_text_124m
SETS = {"max_steps": 4, "eval_interval": 2, "eval_steps": 1, "batch_size": 4, "g_accum_iters": 1,
        "log_interval": 1, "spec_layers": 0, "warmup_steps": 1, "lr_decay_steps": 4,
        "model_config.block_size": 32, "model_config.n_layer": 2, "model_config.n_embd": 64,
        "model_config.n_head": 2, "model_config.vocab_size": 64, "model_config.attn_block_size": 16,
        "mesh.fsdp": 2, "fsdp_min_size": 512}


def _sets(**over):
    return [a for k, v in {**SETS, **over}.items() for a in ("--set", f"{k}={v}")]




def _elastic_config(data_dir, rundir):
    _, t = _configs(mesh=dict(data=-1, fsdp=2, sp=1), data_dir=str(data_dir), rundir=str(rundir),
                    max_steps=ELASTIC_STEPS, lr_decay_steps=ELASTIC_STEPS, eval_interval=2, eval_steps=1,
                    log_interval=1, g_accum_iters=1, restart_backoff_sec=0.0)
    return t


N2_STEPS = 4  # (b): `train` resumes from step 0 and trains steps 1-3


def _node_batches(data_dir, jc, split, steps, batch_size, G):
    """The global batch of each data step as JAX's 2 processes feed a
    (data=2, fsdp=2) mesh: process n draws batch_size // 2 rows from its
    slice of the stream; process 0's rows come first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "process_count", lambda: 2)
        per = []
        for node in (0, 1):
            mp.setattr(jax, "process_index", lambda node=node: node)
            ds = JTokenDataset(str(data_dir), seed=jc.data_seed, shard_by_process=True)
            per.append([ds.batch(split, s, jc.model_config.block_size, batch_size // 2, G) for s in steps])
    x = np.stack([np.concatenate([per[0][i][0], per[1][i][0]], axis=1) for i in range(len(steps))])
    y = np.stack([np.concatenate([per[0][i][1], per[1][i][1]], axis=1) for i in range(len(steps))])
    return x.astype(np.int32), y.astype(np.int32)


@pytest.fixture(scope="module")
def group(data_dir, tmp_path_factory):
    """Start the 4 ranks under torchrun on every job, compute JAX's side
    meanwhile, and return both."""
    d = tmp_path_factory.mktemp("group")
    jobs, jax_side = [], {}
    # (c): JAX's init on the (2, 2) mesh, lm_head scaled so that step 0's
    # gradient norm stays under 1 (no clip) and step 1's const batch clips
    jc, tc = _configs()
    jmesh = j_make_mesh(jc.mesh, devices=jax.devices()[:4])
    jp, _, _, _ = j_init_state(jc, jmesh)
    jp = dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)
    np.savez(d / "weights.npz", **_flatten(jp))
    r = np.random.default_rng(3)
    seqs = np.stack([r.integers(0, 64, (2, 4, 33)), np.full((2, 4, 33), 5)]).astype(np.int32)
    x, y = seqs[..., :-1], seqs[..., 1:]
    np.savez(d / "batches.npz", x=x, y=y)
    for mode in ("gspmd", "shard_map"):
        _, tcm = _configs(fsdp_mode=mode)
        jobs.append({"kind": "step", "config": to_json(tcm), "mesh": {"data": 2, "fsdp": 2}, "ranks": [0, 1, 2, 3],
                     "weights": str(d / "weights.npz"), "batches": str(d / "batches.npz"),
                     "out": str(d / f"c_{mode}.npz")})
    # (e): the routed MLP on 2 data ranks
    je, te = _configs(model={"n_experts": 4, "moe_top_k": 2}, moe_aux_coef=0.01, mesh=dict(data=2, fsdp=1, sp=1))
    emesh = j_make_mesh(je.mesh, devices=jax.devices()[:2])
    ep, _, _, _ = j_init_state(je, emesh)
    np.savez(d / "moe_weights.npz", **_flatten(ep))
    jobs.append({"kind": "step", "config": to_json(te), "mesh": {"data": 2, "fsdp": 1}, "ranks": [0, 1],
                 "weights": str(d / "moe_weights.npz"), "batches": str(d / "batches.npz"), "out": str(d / "e.npz")})
    # (d): one rank's train
    _, td = _configs(mesh=dict(data=-1, fsdp=2, sp=1), data_dir=str(data_dir), rundir=str(d / "d_rank"),
                     max_steps=4, lr_decay_steps=4, eval_interval=2, eval_steps=1, log_interval=1)
    jobs.append({"kind": "train", "config": to_json(td), "mesh": {"data": -1, "fsdp": 2}, "ranks": [0]})
    # (f): save on 2, restore on 1 and on 4
    _, tf = _configs(mesh=dict(data=-1, fsdp=2, sp=1), rundir=str(d / "f_mesh"))
    jobs.append({"kind": "ckpt", "config": to_json(tf), "seed": 9, "step": 6,
                 "save_mesh": {"data": 1, "fsdp": 2}, "save_ranks": [0, 1],
                 "restore": [[{"data": 1, "fsdp": 1}, [0]], [{"data": -1, "fsdp": 4}, [0, 1, 2, 3]]],
                 "out": str(d / "f")})
    # (g): 2 -> 1 -> 2
    jobs.append({"kind": "elastic", "config": to_json(_elastic_config(data_dir, d / "g_run")),
                 "mesh": {"data": -1, "fsdp": 2}, "ranks2": [0, 1], "ranks1": [0], "k1": K1, "k2": K2,
                 "straight": str(d / "g_straight"), "out": str(d / "g.json")})
    # (b): `train` on 2 nodes x 2 ranks from JAX's init, written as step 0
    jb, tb = _configs(data_dir=str(data_dir), rundir=str(d / "b_run"), max_steps=N2_STEPS, eval_interval=1000,
                      log_interval=1)
    _, j_state0, _, _ = j_init_state(jb, jmesh)
    write_step(tb.rundir, 0, _flatten(jp), opt_state_from_optax(_flatten(j_state0), config=tb.model_config, device=CPU))
    jobs.append({"kind": "train", "config": to_json(tb), "mesh": {"data": 2, "fsdp": 2}, "ranks": [0, 1, 2, 3],
                 "local_world": 2})
    # (i): the launcher on the group's 4 ranks
    jobs.append({"kind": "launch", "out": str(d / "i.txt"),
                 "argv": ["--multihost", "--config=local_text_124m", "--device=cpu", f"--rundir={d / 'i_run'}",
                          *_sets(data_dir=data_dir)]})
    # (j): chaos_train in rank 0, last (the other ranks wait at the closing barrier)
    jobs.append({"kind": "chaos", "out": str(d / "j.json"),
                 "argv": ["--config=local_text_124m", f"--rundir={d / 'j_run'}", "--device", "cpu", "--nproc", "1",
                          "--fault", "ckpt_enospc", *_sets(data_dir=data_dir)]})
    spec = d / "spec.json"
    spec.write_text(json.dumps({"jobs": jobs}))
    script = Path(__file__).resolve().parent / "torch_parallel_ranks.py"
    env = {k: v for k, v in os.environ.items() if k != "MIDGPT_DIST_FILE"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
                             str(script), str(spec)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # JAX's side while the ranks run
        for mode in ("gspmd", "shard_map"):
            jcm, _ = _configs(fsdp_mode=mode)
            jax_side[mode] = _jax_steps(jcm, jmesh, jp, x, y)
        jax_side["moe"] = _jax_steps(je, emesh, ep, x, y)
        jax_side["norms"] = _jax_norms(jc, jp, x, y)
        G, B = jb.g_accum_iters, jb.batch_size
        xb, yb = _node_batches(data_dir, jb, "train", range(1, N2_STEPS), B, G)
        val = _node_batches(data_dir, jb, "val", [1_000_000_000 + N2_STEPS], B, jb.eval_steps)
        jax_side["nodes"] = _jax_steps(jb, jmesh, jp, xb, yb, val=(val[0][0], val[1][0]))
        out = proc.communicate(timeout=400)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    return d, jax_side, (tc, td, tf, tb)


def _jax_steps(jc, mesh, jp, x, y, val=None):
    """JAX's train step on each global batch of (x, y) from params `jp` and
    a fresh optimizer state: (losses, params, optimizer state) and, given
    a `val` batch (N, B, T) pair, the mean eval loss at the final params."""
    jp = jax.tree.map(lambda a: a + 0, jp)  # the step donates its params
    _, j_state, specs, j_opt = j_init_state(jc, mesh)
    step, _, eval_loss_many = j_make_train_step(jc, j_opt, mesh, specs)
    losses = []
    for i in range(len(x)):
        jp, j_state, loss = step(jp, j_state, make_global_batch(x[i], mesh, batch_spec()),
                                 make_global_batch(y[i], mesh, batch_spec()), jax.random.PRNGKey(i))
        losses.append(float(loss))
    out = (losses, _named(jp), _flatten(j_state))
    if val is None:
        return out
    spec = batch_spec(with_accum=True)
    total = eval_loss_many(jp, make_global_batch(val[0], mesh, spec), make_global_batch(val[1], mesh, spec))
    return (*out, float(total) / len(val[0]))


def _jax_norms(jc, jp, x, y):
    """The global gradient norm of each step's first microbatch pair at
    the starting weights (the clip branch's input)."""
    from midgpt_tpu.ops.loss import fused_linear_cross_entropy as j_ce

    def loss(p, xb, yb):
        h = JGPT.hidden(jc.model_config, p, xb, inference=True)
        return j_ce(h, p.lm_head, yb, 8192, None)

    g = jax.grad(lambda p: (loss(p, x[0, 0], y[0, 0]) + loss(p, x[0, 1], y[0, 1])) / 2)
    g1 = jax.grad(lambda p: (loss(p, x[1, 0], y[1, 0]) + loss(p, x[1, 1], y[1, 1])) / 2)
    return float(optax.global_norm(g(jp))), float(optax.global_norm(g1(jp)))


def _check_step(out, ref, lr=1e-2):
    losses, params, state = ref[:3]
    np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
    moments = opt_state_from_optax(state, device=CPU)
    for tag, tol in (("mu", 1e-6), ("nu", 1e-8)):
        for k, v in getattr(moments, tag).items():
            np.testing.assert_allclose(out[f"{tag}.{k}"], v.numpy(), atol=tol, rtol=0, err_msg=f"{tag} {k}")
    for k, v in params.items():
        # Where a gradient cancels to the f32 noise of its sum (sqrt(nu)
        # below 10 eps: ~1e-9 gradients, seen on the routed MLP's leaves),
        # Adam's normalised update turns the reduction order's noise into
        # up to lr x O(1); there the parameter is held within lr.
        sound = np.sqrt(moments.nu[k].numpy()) > 10 * 1e-8
        got = out[f"p.{k}"]
        np.testing.assert_allclose(got[sound], v[sound], atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[~sound], v[~sound], atol=lr, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_fsdp_step_matches_jax_data2_fsdp2(group, mode):
    d, jax_side, _ = group
    norms = jax_side["norms"]
    assert norms[0] < 1.0 <= norms[1]  # step 0 keeps g, step 1 takes g / norm
    _check_step(np.load(d / f"c_{mode}.npz"), jax_side[mode])


def test_moe_aux_on_two_data_ranks_matches_jax(group):
    d, jax_side, _ = group
    _check_step(np.load(d / "e.npz"), jax_side["moe"])


def _losses(rundir) -> dict:
    recs = [json.loads(line) for line in Path(rundir, "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r["loss/optimized"] for r in recs if "loss/optimized" in r}


def test_one_rank_is_the_single_device_trainer(group, tmp_path):
    d, _, (_, td, _, _) = group
    train(td.replace(rundir=str(tmp_path)), device=CPU)
    assert _losses(tmp_path) == _losses(d / "d_rank")
    for name in ("params.npz", "opt_state.npz", "midgpt_manifest.json"):
        assert (tmp_path / "3" / name).read_bytes() == (d / "d_rank" / "3" / name).read_bytes(), name


def test_checkpoint_from_two_ranks_has_single_device_bytes_and_restores_on_1_and_4(group, tmp_path):
    d, _, (_, _, tf, _) = group
    params, mu, nu = full_state(tf, 9)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(6, {"params": params, "opt_state": OptState(3, mu, nu, 3)}, force=True)
    mngr.close()
    for f in sorted(os.listdir(tmp_path / "6")):
        assert (tmp_path / "6" / f).read_bytes() == (d / "f_mesh" / "6" / f).read_bytes(), f
    for i, n in enumerate((1, 4)):
        out = np.load(d / f"f_{i}.npz")
        for tag, tree in (("p", params), ("mu", mu), ("nu", nu)):
            for k, v in tree.items():
                np.testing.assert_array_equal(out[f"{tag}.{k}"], v.numpy(), err_msg=f"{n} ranks {tag} {k}")
        np.testing.assert_array_equal(out["shard.wte"], params["wte"].numpy()[:, :64 // n])  # the leader's slice


def test_train_on_two_nodes_matches_jax_two_processes(group):
    """`train` on 2 nodes x 2 ranks draws each node's rows from its own
    slice of the stream, as JAX's 2 processes do: the logged losses of
    steps 1-3, the final eval loss and the checkpointed params and
    moments against JAX's (data=2, fsdp=2) step on the same feed."""
    d, jax_side, (_, _, _, tb) = group
    ref = jax_side["nodes"]
    recs = [json.loads(line) for line in (d / "b_run" / "metrics.jsonl").read_text().splitlines()]
    losses = _losses(d / "b_run")
    assert sorted(losses) == list(range(1, N2_STEPS))
    (val_final,) = [r["loss/val_final"] for r in recs if "loss/val_final" in r]
    np.testing.assert_allclose(val_final, ref[3], rtol=1e-5)
    mngr = CheckpointManager(tb.rundir)
    state = mngr.restore(N2_STEPS - 1, state_template(tb), device=CPU)
    out = {"loss": np.asarray([losses[s] for s in sorted(losses)])}
    for tag, tree in (("p", state["params"]), ("mu", state["opt_state"].mu), ("nu", state["opt_state"].nu)):
        out.update({f"{tag}.{k}": v.numpy() for k, v in tree.items()})
    _check_step(out, ref)


def test_resume_two_to_one_to_two_ranks_continues_the_trajectory(group):
    d, _, _ = group
    out = json.loads((d / "g.json").read_text())
    assert out["preempted"] == [True, True]
    assert "on_resume_mesh='same' refuses" in out["refused"]
    assert [m["n_devices"] for m in out["mesh_history"]] == [2, 1, 2]
    assert [m["axes"]["fsdp"] for m in out["mesh_history"]] == [2, 1, 2]
    a, b = _losses(d / "g_straight"), _losses(d / "g_run")
    assert sorted(a) == sorted(b) == list(range(ELASTIC_STEPS))
    np.testing.assert_allclose([b[s] for s in a], [a[s] for s in a], rtol=1e-5)


def test_reduction_order_alone_moves_the_loss(data_dir):
    """The single-device trainer in bf16 on one batch of 4 rows per step,
    as one microbatch or as two of 2 (the same function, its bf16
    gradients rounded and summed in another order): within four steps the
    losses part by more than JAX's parity rtol of 1e-5 (chaos_train's
    float32 bound) and stay within chaos_train's bfloat16 bound of 1e-3."""
    from midgpt_tpu_torch.robustness.chaos_train import PARITY_RTOL
    from midgpt_tpu_torch.training.train import init_state, make_train_step

    _, base = _configs(mesh=dict(data=-1, fsdp=1, sp=1), compute_dtype="bfloat16", learning_rate=1e-3)
    ds = TokenDataset(str(data_dir), seed=1337)
    runs = []
    for G in (1, 2):
        cfg = base.replace(g_accum_iters=G, batch_size=4 // G)
        params, state, opt = init_state(cfg, CPU)
        step, _ = make_train_step(cfg, opt)
        losses = []
        for i in range(4):
            x, y = (torch.from_numpy(a.reshape(G, 4 // G, 32)).long() for a in ds.batch("train", i, 32, 4))
            params, state, loss = step(params, state, x, y)
            losses.append(loss.item())
        runs.append(np.asarray(losses))
    rel = np.abs(runs[0] - runs[1]) / np.abs(runs[1])
    assert rel[0] < 1e-6 and PARITY_RTOL["float32"] < rel.max() < PARITY_RTOL["bfloat16"], rel


# ---------------------------------------------------------------- (h)-(j): the launcher and chaos_train


def test_sigterm_to_one_rank_saves_once_on_all_and_exits_zero(data_dir, tmp_path):
    argv = [sys.executable, "-m", "midgpt_tpu_torch.launch", "--multihost", "--config=local_text_124m",
            "--device=cpu", f"--rundir={tmp_path / 'run'}",
            *_sets(data_dir=data_dir, max_steps=400, eval_interval=1000, lr_decay_steps=400, preempt_grace_s=60)]
    procs = [subprocess.Popen(argv, cwd=ROOT, env=_env(r, 2, tmp_path / "store"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        deadline = time.time() + 120
        while not (tmp_path / "run" / "metrics.jsonl").exists() or 2 not in _losses(tmp_path / "run"):
            assert all(p.poll() is None for p in procs) and time.time() < deadline
            time.sleep(0.01)
        procs[1].send_signal(signal.SIGTERM)  # the non-leader only
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    said = [line for line in outs[0].splitlines() if line.startswith("preemption: emergency checkpoint at step")]
    assert len(said) == 1 and not any("preemption" in line for line in outs[1].splitlines()), outs
    boundary = int(said[0].split("step ")[1].split()[0])
    assert CheckpointManager(str(tmp_path / "run")).latest_verified_step() == boundary
    assert outs[0].count(f"checkpoint step {boundary} verified") == 1


def test_launch_multihost_under_torchrun(group):
    """`launch --multihost --device cpu` on the 4 ranks torchrun started
    (env://): data 2 x fsdp 2, trained and checkpointed to the end."""
    d = group[0]
    assert "over 4 rank(s), backend gloo" in (d / "i.txt").read_text()
    assert sorted(_losses(d / "i_run")) == [0, 1, 2, 3]
    assert CheckpointManager(str(d / "i_run")).latest_verified_step() == 3
    ledger = json.loads((d / "i_run" / "supervisor_state.json").read_text())
    axes = ledger["mesh"]["axes"]
    assert ledger["mesh"]["n_devices"] == 4 and (axes["data"], axes["fsdp"]) == (2, 2)


def _train_chaos_record(rc, stdout):
    out = stdout.strip().splitlines()
    assert rc == 0 and len(out) == 1, out
    rec = json.loads(out[0])
    assert {"detected_at_ms", "restarts", "final_mesh", "n_devices_final", "loss_parity", "bench"} <= set(rec)
    assert rec["bench"] == "train_chaos" and rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["loss_parity"] is True and rec["detected_at_ms"] > 0
    return rec


def test_chaos_train_prints_train_chaos_fields(group):
    """One rank, ckpt_enospc at the first save (chaos_train run by the
    group's rank 0): the retry absorbs it, and the summary carries JAX's
    train_chaos fields; a serving kind is refused."""
    from midgpt_tpu_torch.robustness import chaos_train

    out = json.loads((group[0] / "j.json").read_text())
    rec = _train_chaos_record(out["rc"], out["stdout"])
    assert rec["faults_fired"] == {"ckpt_enospc": 1} and rec["restarts"] == 0
    assert rec["n_devices_final"] == 1 and [m["n_devices"] for m in rec["supervisor"]["mesh_history"]] == [1]
    with pytest.raises(SystemExit):  # a serving kind belongs to chaos_serve
        chaos_train.main(["--config=local_text_124m", "--rundir=x", "--fault", "engine_crash@2"])


@pytest.mark.slow
def test_chaos_train_resume_reshard_two_one_two(data_dir, tmp_path, capfd, monkeypatch):
    """resume_reshard at data steps 1 and 2 on 2 ranks: chaos_train resumes
    on 1 rank, then on 2 again; the final loss is the uninterrupted 2-rank
    run's at chaos_train's parity bound."""
    from midgpt_tpu_torch.robustness import chaos_train

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    rc = chaos_train.main(["--config=local_text_124m", f"--rundir={tmp_path / 'run'}", "--device", "cpu",
                           "--fault", "resume_reshard@1", "--fault", "resume_reshard@2", *_sets(data_dir=data_dir)])
    rec = _train_chaos_record(rc, capfd.readouterr().out)
    assert rec["faults_fired"] == {"resume_reshard": 2} and rec["restarts"] == 2
    assert [m["n_devices"] for m in rec["supervisor"]["mesh_history"]] == [2, 1, 2]
    assert rec["n_devices_final"] == 2 and rec["final_mesh"]["axes"]["fsdp"] == 2
