"""Port parity, sequence-parallel training (parallel/ring_attention.py,
parallel/ulysses.py, the flash kernels' causal=False plain versions, the
sp axis of parallel/mesh.py and parallel/data.py, `GPT.hidden(attn_fn=,
positions=, rope_len=)`, training/train.py `sequence_parallel`,
shard_map's `sequence_parallel`, `launch --multihost --set mesh.sp=N`):
JAX runs on the 8 virtual CPU devices of tests/conftest.py, the port on
gloo CPU ranks (one torch thread each) that torchrun starts.

  (a) no processes: the plain causal=False forward and backward against
      JAX's _flash_forward / _flash_backward(causal=False) bodies in
      interpret mode (one single-visit and one tiled shape);
      merge_normalized against JAX's; the mesh's (data, fsdp, sp, tp) fill
      and groups against JAX's device layout; each rank's rows and
      columns against the shard JAX's batch_spec(shard_seq=True) puts on
      its device; the ring's block plan against JAX's; the config checks
      against JAX's, with its messages; what refuses (sp with another
      attention, dropout with injected attention, chaos_train's reshard
      below whole sp x tp blocks) and what the launcher no longer names;
  (b) one group of 4 ranks under `torchrun --standalone` runs every job
      (tests/torch_sp_ranks.py) while the test runs JAX's side:
      - the ring and Ulysses, outputs and gradients, on sp 2 and sp 4
        against JAX's ring_attention_sharded(use_kernel=False) and
        ulysses_attention_sharded on the same inputs;
      - two f32 steps (the second clips) of (sp 2), (fsdp 2, sp 2) and
        (data 2, sp 2) under both schedules, (fsdp 2, sp 2) ring under
        fsdp_mode shard_map, ring on (sp 2, tp 2) and ring with GQA, each
        against the single-device trainer on the same weights and
        batches; the (fsdp 2, sp 2) ring step against JAX's step on the
        same mesh (`-m slow`: every case against JAX's);
      - remat policies under sp bit-equal to remat off;
      - an (sp 2) run resumed on 1 rank, then on (sp 2, tp 2), against the
        straight (sp 2) run;
      - `launch --multihost --device cpu --set mesh.sp=2` on the 4 ranks.

Tolerances (float32 throughout): the flash plain versions as
tests/test_torch_flash.py states them (forward 1e-5, gradients 3e-5,
absolute and relative); the ring and Ulysses 1e-5 on outputs and 3e-5 on
gradients, absolute and relative (summation order only); the steps as
tests/test_torch_tp_train.py states them: losses 2e-5 relative,
parameters 2e-5 absolute (within lr where a gradient cancels to the f32
noise of its sum), mu 1e-6 and nu 1e-8 absolute; the elastic
trajectory 1e-5 relative. Remat is bit for bit."""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.ops.online_softmax import merge_normalized as j_merge_normalized
from midgpt_tpu.parallel import ring_attention as j_ring
from midgpt_tpu.parallel.data import make_global_batch
from midgpt_tpu.parallel.mesh import batch_spec
from midgpt_tpu.parallel.mesh import make_mesh as j_make_mesh
from midgpt_tpu.parallel.ulysses import ulysses_attention_sharded as j_ulysses
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_train_step as j_make_train_step
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, to_json
from midgpt_tpu_torch.convert import opt_state_from_optax
from midgpt_tpu_torch.kernels import flash_attention as fa
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig
from midgpt_tpu_torch.ops.online_softmax import merge_normalized
from midgpt_tpu_torch.parallel import ring_attention as ring
from midgpt_tpu_torch.parallel.data import rank_rows
from midgpt_tpu_torch.parallel.mesh import make_mesh
from midgpt_tpu_torch.training.train import sequence_parallel
from torch_threads import one_thread  # noqa: F401 (autouse: one torch thread)

jfa = importlib.import_module("midgpt_tpu.kernels.flash_attention")  # the module, not the re-exported function
ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=64, attn_impl="ring", attn_block_size=16)
ALL4 = [0, 1, 2, 3]
RING, ULYSSES = {"attn_impl": "ring"}, {"attn_impl": "ulysses"}
# the step cases: (mesh, ranks, config overrides)
CASES = {
    "sp2_ring": (dict(data=1, fsdp=1, sp=2), [0, 1], {"model": RING}),
    "sp2_ulysses": (dict(data=1, fsdp=1, sp=2), [2, 3], {"model": ULYSSES}),
    "fsdp2_sp2_ring": (dict(data=1, fsdp=2, sp=2), ALL4, {"model": RING}),
    "fsdp2_sp2_ulysses": (dict(data=1, fsdp=2, sp=2), ALL4, {"model": ULYSSES}),
    "fsdp2_sp2_ring_shard_map": (dict(data=1, fsdp=2, sp=2), ALL4, {"model": RING, "fsdp_mode": "shard_map"}),
    "data2_sp2_ring": (dict(data=2, fsdp=1, sp=2), ALL4, {"model": RING}),
    "data2_sp2_ulysses": (dict(data=2, fsdp=1, sp=2), ALL4, {"model": ULYSSES}),
    "sp2_tp2_ring": (dict(data=1, fsdp=1, sp=2, tp=2), ALL4, {"model": RING}),
    "sp2_ring_gqa": (dict(data=1, fsdp=1, sp=2), [0, 1], {"model": {**RING, "n_kv_heads": 2}}),
}
JAX_FAST = ("fsdp2_sp2_ring",)  # held to JAX's step in the fast tier; `-m slow` takes every case
POLICIES = ("none", "dots_attn")
K1, K2, ELASTIC_STEPS = 3, 5, 8


def _configs(**over):
    base = dict(
        rundir="", data_dir="", learning_rate=1e-2, batch_size=4, warmup_steps=1, min_lr=1e-3,
        lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=10,
        param_dtype="float32", compute_dtype="float32", g_accum_iters=2, shard_model=True,
        fsdp_min_size=512, eval_steps=2,
    )
    model = dict(MODEL, **over.pop("model", {}))
    mesh = dict(over.pop("mesh", dict(data=1, fsdp=1, sp=2)))
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


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(4)]


# ---------------------------------------------------------------- (a) no processes


@pytest.mark.parametrize("T,bq,bk", [(64, 32, 64), (128, 32, 64)], ids=["single", "tiled"])
def test_full_flash_plain_matches_jax_interpret(T, bq, bk):
    """The causal=False forward (out, lse) and backward of the plain
    versions against JAX's causal=False Pallas bodies in interpret mode,
    the backward from the same (out, lse) on both sides."""
    B, H, C = 1, 2, 64
    q, k, v, do = _inputs((B, H, T, C), T)
    j_out, j_lse = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), bq, bk, causal=False)
    flat = lambda a: torch.from_numpy(a.reshape(B * H, T, C))  # noqa: E731
    out, lse = fa.flash_forward(flat(q), flat(k), flat(v), bq, bk, causal=False)
    np.testing.assert_allclose(out.numpy().reshape(q.shape), np.asarray(j_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy().reshape(B, H, T), np.asarray(j_lse)[..., 0], atol=1e-5, rtol=1e-5)
    j_grads = jfa._flash_backward(bq, bk, (*(jnp.asarray(a) for a in (q, k, v)), j_out, j_lse), jnp.asarray(do),
                                  causal=False)
    grads = fa.flash_backward(flat(q), flat(k), flat(v), out, lse, flat(do), bq, bk, causal=False)
    for got, want, name in zip(grads, j_grads, "qkv"):
        np.testing.assert_allclose(got.numpy().reshape(q.shape), np.asarray(want), atol=3e-5, rtol=3e-5,
                                   err_msg=f"d{name}")
    # full attention: every key visible to every row
    s = torch.einsum("ntc,nsc->nts", flat(q), flat(k)) / np.sqrt(C)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5, rtol=1e-5)


def test_merge_normalized_matches_jax():
    r = np.random.default_rng(4)
    m, l, lse = (r.standard_normal((2, 3, 5)).astype(np.float32) for _ in range(3))
    l = np.abs(l) + 0.5
    acc, out = (r.standard_normal((2, 3, 5, 8)).astype(np.float32) for _ in range(2))
    lse[0] = -1.0e30  # a masked partial contributes exactly nothing
    want = j_merge_normalized(*(jnp.asarray(a) for a in (m, l, acc, out, lse)))
    got = merge_normalized(*(torch.from_numpy(a) for a in (m, l, acc, out, lse)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[2][0].numpy(), acc[0] * np.exp(m[0] - got[0][0].numpy())[..., None])


def test_mesh_fills_data_fsdp_sp_tp_as_jax_lays_out_devices(monkeypatch):
    """Rank i of a (data 2, fsdp 1, sp 2, tp 2) and of a (fsdp 2, sp 2,
    tp 2) mesh sits where JAX's make_mesh puts device i, and each group
    holds the ranks JAX's axes name."""
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for shape in (dict(data=2, fsdp=1, sp=2, tp=2), dict(data=1, fsdp=2, sp=2, tp=2)):
        jmesh = j_make_mesh(JMeshConfig(**shape), devices=jax.devices()[:8])
        coords = {int(d.id): idx for idx, d in np.ndenumerate(jmesh.devices)}
        for r in range(8):
            monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
            m = make_mesh(MeshConfig(**shape), ranks=range(8), device=CPU)
            d, f, s, t, _, _ = coords[r]
            assert (m.data_index, m.fsdp_index, m.sp_index, m.tp_index) == (d, f, s, t)
            assert m.batch_index == d * shape["fsdp"] + f and m.token_shards == 4
            same = lambda *axes: tuple(sorted(q for q, c in coords.items()  # noqa: E731
                                              if all(c[a] == coords[r][a] for a in axes)))
            assert m.tp_group == same(0, 1, 2) and m.sp_group == same(0, 1, 3)
            assert (m.data_group or same(1, 2, 3)) == same(1, 2, 3)
            assert (m.fsdp_group or same(0, 2, 3)) == same(0, 2, 3)
            assert m.replica_group == same(1, 3) and m.batch_group == same(3)


@pytest.mark.parametrize("mesh", [dict(data=1, fsdp=1, sp=4), dict(data=2, fsdp=1, sp=2), dict(data=1, fsdp=2, sp=2)],
                         ids=["sp4", "data2_sp2", "fsdp2_sp2"])
def test_blocks_follow_jax_sequence_sharding(mesh, monkeypatch):
    """Each rank keeps the rows and columns JAX's batch_spec(shard_seq=True)
    places on its device."""
    jmesh = j_make_mesh(JMeshConfig(**mesh), devices=jax.devices()[:4])
    x = np.arange(2 * 4 * 8, dtype=np.int32).reshape(2, 4, 8)
    xg = make_global_batch(x, jmesh, batch_spec(shard_seq=True))
    shards = {int(s.device.id): np.asarray(s.data) for s in xg.addressable_shards}
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    for r in range(4):
        monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda r=r: r)
        m = make_mesh(MeshConfig(**mesh), ranks=range(4), device=CPU)
        np.testing.assert_array_equal(rank_rows(x, m), shards[int(jmesh.devices.flat[r].id)])


def test_pair_plan_matches_jax():
    """The ring's block choice: JAX's for every shard length its kernels
    serve; where JAX falls back to its jnp pair (warning), the port's
    kernel path raises, and its plain path keeps the block."""
    import warnings

    for Tl in (64, 256, 1280, 2560, 4096, 16384):
        for block in (128, 512, 1024):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = j_ring._resolve_pair_plan(Tl, block, True)
            if want[0]:
                assert ring._resolve_pair_plan(Tl, block, True) == want, (Tl, block)
            else:
                with pytest.raises(ValueError, match="not tileable"):
                    ring._resolve_pair_plan(Tl, block, True)
            assert ring._resolve_pair_plan(Tl, block, False) == j_ring._resolve_pair_plan(Tl, block, False)


@pytest.mark.parametrize("over", [
    {"model": {"attn_impl": "ulysses", "n_head": 4}, "mesh": dict(data=-1, fsdp=1, sp=2, tp=4)},
    {"model": {"attn_impl": "ulysses", "n_head": 6, "n_embd": 96}, "mesh": dict(data=-1, fsdp=1, sp=4)},
    {"model": {"attn_impl": "ulysses", "n_head": 8}, "mesh": dict(data=-1, fsdp=1, sp=2, tp=2)},
    {"model": {"attn_impl": "ring"}, "mesh": dict(data=-1, fsdp=1, sp=2, tp=2), "fsdp_mode": "shard_map"},
    {"model": {"attn_impl": "ring"}, "mesh": dict(data=-1, fsdp=1, sp=2, pp=2)},
    {"model": {"attn_impl": "ring"}, "mesh": dict(data=-1, fsdp=1, sp=1, pp=2)},
    {"model": {"attn_impl": "ring"}, "mesh": dict(data=-1, fsdp=2, sp=4)},
], ids=["ulysses_tp_sp", "ulysses_sp", "ulysses_ok", "shard_map_tp_sp", "pp_sp", "pp_ring", "ring_ok"])
def test_config_checks_under_sp_match_jax(over):
    """JAX's sequence-parallel checks, with its messages: Ulysses needs
    whole heads per (tp, sp) device; shard_map under tp refuses sp; the
    pipeline refuses sp and the sp schedules. What JAX accepts, the port
    accepts."""
    try:
        _configs(**{k: (dict(v) if isinstance(v, dict) else v) for k, v in over.items()})
    except ValueError as e:
        with pytest.raises(ValueError) as t_err:
            _torch_config(over)
        assert str(t_err.value) == str(e)
        return
    assert _torch_config(over).mesh.sp == over["mesh"]["sp"]


def _torch_config(over):
    """The port's config alone (JAX's may refuse first)."""
    base = _configs(mesh=dict(data=1, fsdp=1, sp=1))[1]
    kept = {f.name: getattr(base, f.name) for f in dataclasses.fields(ExperimentConfig)
            if f.name not in ("mesh", "model_config", *over)}
    return ExperimentConfig(**kept, mesh=MeshConfig(**over["mesh"]),
                            model_config=GPTConfig(**dict(MODEL, **over.get("model", {}))),
                            **{k: v for k, v in over.items() if k not in ("mesh", "model")})


def test_what_sequence_parallelism_refuses(tmp_path):
    """sp with an attention that is not sequence-parallel raises; injected
    attention refuses dropout in training, as JAX's does; the launcher no
    longer names sp; chaos_train refuses a reshard that cannot keep whole
    sp x tp blocks, before any rank starts."""
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.robustness import chaos_train

    mesh = types.SimpleNamespace(sp=2, sp_index=0, sp_group=None)
    with pytest.raises(ValueError, match="mesh.sp=2 trains with attn_impl 'ring' or 'ulysses'"):
        sequence_parallel(GPTConfig(**dict(MODEL, attn_impl="flash")), mesh)
    cfg = GPTConfig(**dict(MODEL, dropout=0.1))
    params = GPT.init(cfg, 0, device=CPU)
    with pytest.raises(NotImplementedError, match="injected attention"):
        GPT.hidden(cfg, params, torch.zeros((1, 8), dtype=torch.long), generator=torch.Generator(),
                   **sequence_parallel(cfg, None)(torch.zeros((1, 8))))
    assert not hasattr(launch, "unused_mesh")
    base = ["--config=local_text_124m", f"--rundir={tmp_path}", "--device", "cpu", "--set", "mesh.sp=2",
            "--set", "model_config.attn_impl=ring"]
    with pytest.raises(SystemExit):
        chaos_train.main([*base, "--nproc", "2", "--fault", "resume_reshard@2"])
    with pytest.raises(SystemExit):
        chaos_train.main([*base, "--nproc", "3"])


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_one_rank_schedule_is_dense_attention(impl):
    """Bound without a mesh (one rank, as JAX binds it on any mesh), the
    ring is its diagonal pair and Ulysses the dense flash attention: the
    hidden states equal the unbound forward's (blockwise), at positions
    arange(T) of a T-row table."""
    cfg = GPTConfig(**dict(MODEL, attn_impl=impl))
    params = GPT.init(cfg, 3, device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (2, 32)))
    hooks = sequence_parallel(cfg, None)(tokens)
    assert torch.equal(hooks["positions"], torch.arange(32)) and hooks["rope_len"] == 32
    bound = GPT.hidden(cfg, params, tokens, inference=True, **hooks)
    torch.testing.assert_close(bound, GPT.hidden(cfg, params, tokens, inference=True), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- (b) one group of 4 ranks


def _jax_attention(schedule, inputs, n, block):
    """JAX's sharded ring (its jnp pair) or Ulysses on an sp-only mesh of n
    devices: (out, dq, dk, dv) as numpy."""
    jmesh = j_make_mesh(JMeshConfig(data=1, fsdp=1, sp=n), devices=jax.devices()[:n])
    q, k, v, do = (jnp.asarray(a) for a in inputs)
    if schedule == "ring":
        fn = lambda q, k, v: j_ring.ring_attention_sharded(q, k, v, jmesh, block_size=block,  # noqa: E731
                                                            use_kernel=False)
    else:
        fn = lambda q, k, v: j_ulysses(q, k, v, jmesh, block_size=block)  # noqa: E731
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(a) for a in (out, *vjp(do))]


def _jax_steps(jc, mesh, jp, x, y):
    jp = jax.tree.map(lambda a: a + 0, jp)  # the step donates its params
    _, j_state, specs, j_opt = j_init_state(jc, mesh)
    step, _, _ = j_make_train_step(jc, j_opt, mesh, specs)
    spec = batch_spec(shard_seq=mesh.shape["sp"] > 1)
    losses = []
    for i in range(len(x)):
        jp, j_state, loss = step(jp, j_state, make_global_batch(x[i], mesh, spec),
                                 make_global_batch(y[i], mesh, spec), jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, _named(jp), _flatten(j_state)


def _jax_case(case, d):
    jc, _ = _case_configs(case)
    mesh = CASES[case][0]
    n = mesh["data"] * mesh["fsdp"] * mesh["sp"] * mesh.get("tp", 1)
    jmesh = j_make_mesh(jc.mesh, devices=jax.devices()[:n])
    jp = JGPT.init(jc.model_config, jax.random.PRNGKey(jc.seed))
    jp = dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)
    b = np.load(d / "batches.npz")
    return _jax_steps(jc, jmesh, jp, b["x"].astype(np.int32), b["y"].astype(np.int32))


ATTN_RUNS = [(schedule, ranks) for schedule in ("ring", "ulysses") for ranks in ([0, 1], ALL4)]
ATTN_JAX_FAST = (("ring", 2), ("ring", 4), ("ulysses", 2))  # JAX's Ulysses compiles slowly: sp 4 is `-m slow`
# the ring's pairs in blocks of 8 (two blocks a pair at sp 2); Ulysses' dense attention in one block
ATTN_SHAPE, ATTN_BLOCK = (2, 4, 32, 16), {"ring": 8, "ulysses": 32}


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
    d = tmp_path_factory.mktemp("sp_group")
    jobs, jax_side = [], {}
    np.savez(d / "attn.npz", **dict(zip(("q", "k", "v", "do"), _inputs(ATTN_SHAPE, 11))))
    for schedule, ranks in ATTN_RUNS:
        jobs.append({"kind": "attention", "schedule": schedule, "ranks": ranks, "block_size": ATTN_BLOCK[schedule],
                     "inputs": str(d / "attn.npz"), "out": str(d / f"attn_{schedule}_{len(ranks)}")})
    # JAX's init of each layout, lm_head scaled so that step 0's gradient
    # norm stays under 1 (no clip) and step 1's const batch clips
    for layout, model in (("mha", {}), ("gqa", {"n_kv_heads": 2})):
        jc, _ = _configs(model=model, mesh=dict(data=1, fsdp=1, sp=1))
        jp = JGPT.init(jc.model_config, jax.random.PRNGKey(jc.seed))
        np.savez(d / f"w_{layout}.npz", **_flatten(dataclasses.replace(jp, lm_head=jp.lm_head * 0.3)))
    r = np.random.default_rng(3)
    seqs = np.stack([r.integers(0, 64, (2, 4, 33)), np.full((2, 4, 33), 5)]).astype(np.int32)
    np.savez(d / "batches.npz", x=seqs[..., :-1], y=seqs[..., 1:])
    for case, (mesh, ranks, over) in CASES.items():
        _, t = _case_configs(case)
        layout = "gqa" if "n_kv_heads" in over["model"] else "mha"
        jobs.append({"kind": "step", "config": to_json(t), "mesh": mesh, "ranks": ranks,
                     "batches": str(d / "batches.npz"), "weights": str(d / f"w_{layout}.npz"),
                     "out": str(d / f"step_{case}.npz")})
    remat = {"off": to_json(_configs()[1])}
    for policy in POLICIES:
        remat[policy] = to_json(_configs(model={"remat": True, "remat_policy": policy})[1])
    jobs.append({"kind": "remat", "configs": remat, "mesh": dict(data=1, fsdp=1, sp=2), "ranks": [2, 3],
                 "batches": str(d / "batches.npz"), "weights": str(d / "w_mha.npz"), "out": str(d / "remat.npz")})
    # (sp 2) -> 1 rank -> (sp 2, tp 2)
    _, te = _configs(data_dir=str(data_dir), rundir=str(d / "g_run"), max_steps=ELASTIC_STEPS,
                     lr_decay_steps=ELASTIC_STEPS, eval_interval=2, eval_steps=1, log_interval=1, g_accum_iters=1,
                     restart_backoff_sec=0.0)
    jobs.append({"kind": "elastic_sp", "config": to_json(te), "k1": K1, "k2": K2, "straight": str(d / "g_straight"),
                 "meshes": [[dict(data=1, fsdp=1, sp=2), [0, 1]], [dict(data=1, fsdp=1), [0]],
                            [dict(data=1, fsdp=1, sp=2, tp=2), ALL4]], "out": str(d / "g.json")})
    sets = {"max_steps": 3, "eval_interval": 2, "eval_steps": 1, "batch_size": 4, "g_accum_iters": 1,
            "log_interval": 1, "spec_layers": 0, "warmup_steps": 1, "lr_decay_steps": 3,
            "model_config.block_size": 32, "model_config.n_layer": 2, "model_config.n_embd": 64,
            "model_config.n_head": 2, "model_config.vocab_size": 64, "model_config.attn_block_size": 16,
            "model_config.attn_impl": "ring", "mesh.fsdp": 1, "mesh.sp": 2, "fsdp_min_size": 512,
            "data_dir": data_dir}
    jobs.append({"kind": "launch", "out": str(d / "launch.txt"),
                 "argv": ["--multihost", "--config=local_text_124m", "--device=cpu", f"--rundir={d / 'launch_run'}",
                          *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]})
    spec = d / "spec.json"
    spec.write_text(json.dumps({"jobs": jobs}))
    script = Path(__file__).resolve().parent / "torch_sp_ranks.py"
    env = {k: v for k, v in os.environ.items() if k != "MIDGPT_DIST_FILE"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
                             str(script), str(spec)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:  # JAX's side while the ranks run
        for schedule, n in ATTN_JAX_FAST:
            jax_side[(schedule, n)] = _jax_attention(schedule, _attn_inputs(d), n, ATTN_BLOCK[schedule])
        for case in JAX_FAST:
            jax_side[case] = _jax_case(case, d)
        out = proc.communicate(timeout=400)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    return d, jax_side


def _attn_inputs(d):
    return [np.load(d / "attn.npz")[n] for n in ("q", "k", "v", "do")]


@pytest.mark.parametrize("schedule,n", [sn if sn in ATTN_JAX_FAST else pytest.param(*sn, marks=pytest.mark.slow)
                                        for sn in (("ring", 2), ("ring", 4), ("ulysses", 2), ("ulysses", 4))])
def test_attention_matches_jax_sharded(group, schedule, n):
    """Each rank's output shard and gradients of the ring and Ulysses
    against the same columns of JAX's sharded ones."""
    d, jax_side = group
    want = jax_side.get((schedule, n)) or _jax_attention(schedule, _attn_inputs(d), n, ATTN_BLOCK[schedule])
    Tl = ATTN_SHAPE[2] // n
    for g in range(n):
        got = np.load(d / f"attn_{schedule}_{n}.{g}.npz")
        cols = slice(g * Tl, (g + 1) * Tl)
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            tol = 1e-5 if name == "out" else 3e-5
            np.testing.assert_allclose(got[name], w[:, :, cols], atol=tol, rtol=tol, err_msg=f"{name} shard {g}")


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
def test_step_matches_one_device(group, case):
    """Two f32 steps on the case's mesh equal the single-device trainer's on
    the same weights and batches (the second step clips)."""
    d, _ = group
    out = np.load(d / f"step_{case}.npz")
    _check_step(out, out, prefix="ref.")
    assert out["loss"][1] < out["loss"][0]  # the const batch is easier


@pytest.mark.parametrize("case", JAX_FAST)
def test_step_matches_jax(group, case):
    d, jax_side = group
    _check_step(np.load(d / f"step_{case}.npz"), jax_side[case])


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(set(CASES) - set(JAX_FAST)))
def test_every_step_matches_jax(group, case):
    d, _ = group
    _check_step(np.load(d / f"step_{case}.npz"), _jax_case(case, d))


def test_remat_under_sp_is_remat_off(group):
    d, _ = group
    runs = np.load(d / "remat.npz")
    off = {k[4:]: runs[k] for k in runs.files if k.startswith("off.")}
    for policy in POLICIES:
        for k, v in off.items():
            np.testing.assert_array_equal(runs[f"{policy}.{k}"], v, err_msg=f"{policy} {k}")


def test_resume_across_sp_sizes_continues_the_straight_run(group):
    """(sp 2) steps 0-3, 1 rank steps 4-5, then (sp 2, tp 2) to the end:
    the final loss is the straight (sp 2) run's; the "same" policy refuses
    the move to one rank."""
    d, _ = group
    g = json.loads((d / "g.json").read_text())
    assert g["preempted"] == [True, True]
    assert "refused" in g and "on_resume_mesh" in g["refused"]
    assert [h["n_devices"] for h in g["mesh_history"]] == [2, 1, 4]
    assert g["mesh_history"][-1]["axes"]["sp"] == 2 and g["mesh_history"][-1]["axes"]["tp"] == 2
    np.testing.assert_allclose(g["loss_final"], g["straight"], rtol=1e-5)


def test_launcher_trains_on_sp(group):
    d, _ = group
    text = (d / "launch.txt").read_text()
    assert "'sp': 2" in text and "over 4 rank(s), backend gloo" in text
    assert (d / "launch_run" / "2").is_dir()
