"""Port parity, tensor-parallel serving (parallel/tp.py, parallel/serve_tp.py,
ServeEngine(mesh=), DisaggServe(mesh=), loadgen --tp): JAX runs on the 8
virtual CPU devices of tests/conftest.py, the port on gloo CPU ranks (one
torch thread each) that torchrun starts.

  (a) the leaf rule: the port's tp_param_specs, serve_param_specs and pool
      specs equal JAX's leaf for leaf (MHA, GQA and MoE layouts, tp 2 and
      4, fsdp 1 and 2, vocab_parallel on and off), and a rank's shard of
      JAX-layout weights equals the slice JAX's sharding puts on its
      device (no processes);
  (b) the shard algebra in one process: two shards stepped in two threads
      whose all-reduce sums their partials, against the single-device
      step (f32 1e-5 relative), the routed MLP not summed;
  (c) one group of 4 ranks under `torchrun --standalone` runs every job
      (tests/torch_tp_ranks.py) while the test runs JAX's engines on JAX's
      tiny config (tests/test_tp_serving.py): the tp 2 engine's greedy
      streams (f32 with the prefix cache, int8, GQA, MoE, a self-draft)
      against the single-device engine's and (f32 with the prefix cache;
      `-m slow`: every case) JAX's single-device and tp 2 engines', its
      logits at 1e-5
      relative, stats()["mesh"] and the per-shard bytes, the ranks'
      streams at temperature > 0, a forced divergence, a live resize,
      `loadgen --tp 2 --device cpu`'s serve_slo line, and DisaggServe on
      a (data 2, tp 2) mesh against a monolithic engine;
  (d) the refusals and checks: JAX's indivisible-heads message, the
      captured overlap modes under tp, the training mesh's tp axis, the
      config's tp checks.

Parity is exact for these greedy streams: the row's all-reduce sums two
f32 partial products, which round differently from one product only at
the last bits, and no stream here sits at a near-tie."""

import json
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.analysis.bench_contract import check_serve_slo_bench
from midgpt_tpu.config import ExperimentConfig as JExperimentConfig
from midgpt_tpu.config import MeshConfig as JMeshConfig
from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.parallel import serve_tp as j_serve_tp
from midgpt_tpu.parallel.mesh import make_mesh as j_make_mesh
from midgpt_tpu.parallel.tp import tp_param_specs as j_tp_param_specs
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu.sampling.spec import self_draft as j_self_draft
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache, param_shapes
from midgpt_tpu_torch.parallel import serve_tp
from midgpt_tpu_torch.parallel.mesh import make_mesh
from midgpt_tpu_torch.parallel.tp import tp_param_specs
from midgpt_tpu_torch.sampling.serve import ServeEngine
from midgpt_tpu_torch.sampling.spec import self_draft

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TINY = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)  # JAX's tests/test_tp_serving.py CFG
MODELS = {
    "tiny": TINY,
    "gqa": dict(TINY, n_head=4, n_kv_heads=2),
    "moe": dict(TINY, n_experts=4, moe_top_k=2),
}
# JAX's engine geometry (tests/test_tp_serving.py `_run`)
ENGINE = dict(max_slots=3, page_size=8, num_pages=29, prefill_chunk=8, decode_chunk=8, temperature=0.0)
# (model, cache dtype, prefix cache, self-draft) of each tp 2 case
CASES = {
    "f32_prefix": ("tiny", "f32", True, False),
    "int8": ("tiny", "int8", False, False),
    "gqa": ("gqa", "f32", False, False),
    "moe": ("moe", "f32", False, False),
    "spec": ("tiny", "f32", False, True),
}
LOGIT_RTOL = 1e-5
DISAGG_EXTRA = [([3, 5, 7, 11, 13], 6)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _trace(seed, n=4):
    """JAX's tests/test_tp_serving.py trace."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 30, size=n)
    return ([rng.integers(1, TINY["vocab_size"], size=int(n_)).tolist() for n_ in lens],
            [int(b) for b in rng.integers(5, 18, size=n)])


@pytest.fixture(scope="module")
def jax_params():
    return {name: JGPT.init(JGPTConfig(**m), jax.random.PRNGKey(0)) for name, m in MODELS.items()}


def _jax_streams(jp, case, mesh=None, seed=0):
    model, dtype, prefix, spec = CASES[case]
    cfg = JGPTConfig(**MODELS[model])
    kw = {}
    if spec:
        dcfg, dparams = j_self_draft(cfg, jp, 1)
        kw = dict(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True, spec_k_max=4)
    eng = JServeEngine(cfg, jp, **ENGINE, cache_dtype=jnp.float32 if dtype == "f32" else "int8",
                       prefix_cache=prefix, mesh=mesh, **kw)
    prompts, budgets = _trace(seed)
    uids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    done = eng.run()
    return [done[u].tokens.tolist() for u in uids]


# ---------------------------------------------------------------- (a) the leaf rule


def _shape_configs():
    small = dict(block_size=1024, vocab_size=50304, n_layer=2, n_head=12, n_embd=768)
    return {
        "gpt2_small": small,
        "odd_vocab": dict(small, vocab_size=50257),
        "gqa": dict(small, n_kv_heads=4),
        "moe": dict(small, n_experts=8, moe_top_k=2),
    }


def _jax_specs(tree, shapes) -> dict:
    """JAX's PartitionSpecs as the port writes specs: one entry per axis."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        name = jax.tree_util.keystr(path).lstrip(".")
        out[name] = tuple(spec) + (None,) * (len(shapes[name]) - len(spec))
    return out


@pytest.mark.parametrize("vocab_parallel", [True, False], ids=["vocab", "novocab"])
@pytest.mark.parametrize("fsdp", [1, 2])
@pytest.mark.parametrize("n_tp", [2, 4])
@pytest.mark.parametrize("shape", sorted(_shape_configs()))
def test_tp_specs_match_jax(shape, n_tp, fsdp, vocab_parallel):
    model = _shape_configs()[shape]
    abstract = jax.eval_shape(lambda k: JGPT.init(JGPTConfig(**model), k), jax.random.PRNGKey(0))
    mesh = j_make_mesh(JMeshConfig(data=-1, fsdp=fsdp, sp=1, tp=n_tp), devices=jax.devices()[:fsdp * n_tp])
    shapes = param_shapes(GPTConfig(**model))
    for min_size in (0, 2**18):
        want = _jax_specs(j_tp_param_specs(abstract, mesh, True, min_size, vocab_parallel), shapes)
        got = tp_param_specs(shapes, {"tp": n_tp, "fsdp": fsdp, "ep": 1}, True, min_size, vocab_parallel)
        assert got == want, min_size
    assert got["blocks.attn.wo"][2] == "tp" and got["blocks.attn.q_scale"] == (None, None)


@pytest.mark.parametrize("n_tp", [2, 4])
@pytest.mark.parametrize("shape", sorted(_shape_configs()))
def test_serve_specs_match_jax(shape, n_tp):
    """The serving rule (vocab off, no size gate) and the pool's specs."""
    model = _shape_configs()[shape]
    abstract = jax.eval_shape(lambda k: JGPT.init(JGPTConfig(**model), k), jax.random.PRNGKey(0))
    shapes = param_shapes(GPTConfig(**model))
    want = _jax_specs(j_serve_tp.serve_param_specs(abstract, j_serve_tp.make_serve_mesh(tp_size=n_tp)), shapes)
    got = serve_tp.serve_param_specs(shapes, n_tp)
    assert got == want
    assert got["wte"] == got["lm_head"] == (None, None)
    # the routed MLP's banks are not tp leaves: replicated, so never summed
    assert all(got[k] == (None,) * len(shapes[k]) for k in shapes if "experts" in k or "router" in k)
    assert serve_tp.POOL_SPEC == tuple(j_serve_tp.POOL_SPEC) and serve_tp.SCALE_SPEC == tuple(j_serve_tp.SCALE_SPEC)
    assert set(serve_tp.serve_cache_specs(True)) == {"k", "v", "k_scale", "v_scale"}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_rank_shards_equal_jax_slices(jax_params, model):
    """Each rank's shard of the converted JAX weights is the block JAX's
    serving sharding places on that rank's device."""
    jp = jax_params[model]
    mesh = j_serve_tp.make_serve_mesh(tp_size=2)
    placed = _flatten_shards(j_serve_tp.put_sharded(jp, j_serve_tp.serve_param_specs(jp, mesh), mesh), mesh)
    flat = {k.lstrip("."): v for k, v in _flatten(jp).items()}
    for i in range(2):
        shard = serve_tp.shard_params(flat, 2, i)
        for k, v in shard.items():
            np.testing.assert_array_equal(v.numpy(), placed[i][k], err_msg=f"{model} {k} shard {i}")


def _flatten_shards(tree, mesh):
    """{device index: {leaf: the block on that device}} of a sharded tree."""
    devs = list(mesh.devices.flat)
    out = {i: {} for i in range(len(devs))}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = jax.tree_util.keystr(path).lstrip(".")
        for s in x.addressable_shards:
            out[devs.index(s.device)][name] = np.asarray(s.data)
    return out


# ---------------------------------------------------------------- (b) the shard algebra in one process


class _ThreadRow:
    """Two shards stepped in two threads: `psum_tp` sums the row's partial
    products in shard order, as the gloo all-reduce does."""

    def __init__(self, n):
        self.tp, self.n = n, n
        self._barrier = threading.Barrier(n)
        self._parts = [None] * n
        self.calls = []

    def view(self, i):
        row = self

        class View:
            tp = row.tp
            tp_index = i

            def psum_tp(self, t):
                row._parts[i] = t.clone()
                row._barrier.wait()
                total = sum(row._parts[j] for j in range(row.n))
                row._barrier.wait()
                if i == 0:
                    row.calls.append(tuple(t.shape))
                t.copy_(total)
                return t

        return View()


@pytest.mark.parametrize("model", ["tiny", "gqa", "moe", "split_rope"])
def test_shard_algebra_matches_one_device(model):
    """Per-shard decode and prefill steps, their row-parallel products
    summed, equal the single-device steps at f32 1e-5 relative; the routed
    MLP's output is whole on each shard and is not summed."""
    kw = MODELS["tiny"] if model == "split_rope" else MODELS[model]
    cfg = GPTConfig(**kw, rope_style="split" if model == "split_rope" else "interleaved")
    params = GPT.init(cfg, 3, device=CPU)
    specs = serve_tp.serve_param_specs({k: tuple(v.shape) for k, v in params.items()}, 2)
    row = _ThreadRow(2)
    shards = [serve_tp.TPShard(row.view(i), specs) for i in range(2)]
    assert ("blocks.mlp.w_down" in shards[0].reduced) == (model != "moe")
    rng = np.random.default_rng(0)
    B, ps = 3, 8
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], dtype=torch.int32)
    tokens = torch.tensor(rng.integers(0, 96, (1, 12)))
    step_tok = torch.tensor(rng.integers(0, 96, B))
    lengths = torch.tensor([12, 3, 9], dtype=torch.int32)
    active = torch.tensor([True, True, False])

    def run(params_, tp_shard, tp_size):
        cache = PagedKVCache.init(cfg, 8, ps, torch.float32, device=CPU, tp_size=tp_size)
        pre, cache = GPT.prefill_paged_chunk(cfg, params_, tokens, 0, 12, cache, table[:1], tp_shard=tp_shard)
        dec, cache = GPT.decode_step_paged(cfg, params_, step_tok, cache, table, lengths, active, attn_impl="gather",
                                           tp_shard=tp_shard)
        return pre, dec

    want = run(params, None, 1)
    got = [None, None]

    def worker(i):
        got[i] = run(serve_tp.shard_params(params, 2, i, specs), shards[i], 2)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g in got:
        for a, b in zip(g, want):
            assert (a - b).abs().max() <= LOGIT_RTOL * b.abs().max()
    # two all-reduces a layer (one for MoE: the attention's only), per forward
    per_layer = 1 if model == "moe" else 2
    assert len(row.calls) == 2 * per_layer * cfg.n_layer


# ---------------------------------------------------------------- (c) one group of 4 ranks


@pytest.fixture(scope="module")
def group(jax_params, tmp_path_factory):
    """Start the 4 ranks under torchrun on every job, compute JAX's side
    meanwhile, and return both."""
    d = tmp_path_factory.mktemp("tp")
    weights = {}
    for name, jp in jax_params.items():
        weights[name] = str(d / f"{name}.npz")
        np.savez(weights[name], **_flatten(jp))
    prompts, budgets = _trace(0)
    trace = [[p, b] for p, b in zip(prompts, budgets)]
    cases = []
    for name, (model, dtype, prefix, spec) in CASES.items():
        cases.append({"name": name, "model": MODELS[model], "weights": weights[model], "trace": trace,
                      "engine": dict(ENGINE, dtype=dtype, prefix_cache=prefix, **({"spec": True} if spec else {}))})
    tiny = {"model": TINY, "weights": weights["tiny"], "trace": trace, "tp": 2}
    jobs = [
        {"kind": "serve", "tp": 2, "cases": cases},
        dict(tiny, kind="sampled", engine=dict(ENGINE, dtype="f32")),
        dict(tiny, kind="diverge", engine=dict(ENGINE, dtype="f32")),
        dict(tiny, kind="resize", engine=dict(ENGINE, dtype="f32"), resize_after=3, num_pages=40),
        {"kind": "loadgen", "argv": ["--tp", "2", "--device", "cpu", "--rates", "20,60", "--n-requests", "4",
                                     "--prefix-cache", "--template-frac", "0.5"]},
        # a prompt shorter than a page: its handoff carries no page
        dict(tiny, kind="disagg", engine=dict(ENGINE, dtype="f32"), trace=trace + DISAGG_EXTRA),
    ]
    spec = d / "spec.json"
    out = d / "out"
    spec.write_text(json.dumps({"jobs": jobs, "out": str(out)}))
    script = Path(__file__).resolve().parent / "torch_tp_ranks.py"
    env = {k: v for k, v in os.environ.items() if k != "MIDGPT_DIST_FILE"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
                             str(script), str(spec)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # JAX's engines compile for seconds each: the fast tier runs the f32
        # prefix case's two, `-m slow` every case's; the port's single-device
        # engine (held to JAX's in each case by the single-device tests)
        # stands beside every case
        jax_side = {"f32_prefix": _jax_streams(jax_params["tiny"], "f32_prefix"),
                    "tp2_f32_prefix": _jax_streams(jax_params["tiny"], "f32_prefix",
                                                   mesh=j_serve_tp.make_serve_mesh(tp_size=2))}
        jax_side["port"] = {case: _port_streams(case) for case in CASES}
        jax_side["port_disagg"] = _port_streams("f32_prefix", extra=DISAGG_EXTRA)
        log = proc.communicate(timeout=400)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-6000:]
    ranks = [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(4)]
    return ranks, jax_side


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp2_streams_equal_jax(group, case):
    """The tp 2 engine's greedy streams equal the single-device engine's,
    on both ranks (f32 with the prefix cache: JAX's single-device and tp 2
    engines'; `-m slow`: JAX's in every case), and its prefill logits
    equal the whole weights' at 1e-5 relative."""
    ranks, jax_side = group
    lead, follow = ranks[0][case], ranks[1][case]
    assert lead["streams"] == jax_side["port"][case]
    assert follow["streams"] == lead["streams"]
    assert lead["logit_err"] <= LOGIT_RTOL and follow["logit_err"] <= LOGIT_RTOL
    if case == "f32_prefix":
        assert lead["streams"] == jax_side["f32_prefix"] == jax_side["tp2_f32_prefix"]
    if case == "spec":
        assert lead["spec"]["rounds"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(set(CASES) - {"f32_prefix"}))
def test_tp2_streams_equal_jax_tp2(group, jax_params, case):
    """JAX's single-device and tp 2 engines in the other cases (their
    compiles are the heavy part)."""
    ranks, _ = group
    jp = jax_params[CASES[case][0]]
    assert ranks[0][case]["streams"] == _jax_streams(jp, case)
    assert ranks[0][case]["streams"] == _jax_streams(jp, case, mesh=j_serve_tp.make_serve_mesh(tp_size=2))


def test_tp_stats_and_per_shard_bytes(group):
    """stats() names the mesh, the pool holds each rank's heads, and the
    shards' bytes add up to the single-device pool's."""
    ranks, _ = group
    for case in ("f32_prefix", "gqa", "int8"):
        rec = ranks[0][case]
        assert rec["mesh"] == {"data": 1, "tp": 2}
        assert rec["per_shard"] * 2 == rec["total"]
        model = GPTConfig(**MODELS[CASES[case][0]])
        assert rec["pool"][1] == model.kv_heads // 2
        dtype = torch.float32 if CASES[case][1] == "f32" else torch.int8
        whole = PagedKVCache.init(model, ENGINE["num_pages"], ENGINE["page_size"], dtype, device=CPU)
        assert rec["total"] == whole.nbytes


def test_tp_ranks_agree_when_sampling(group):
    ranks, _ = group
    lead, follow = ranks[0]["sampled"], ranks[1]["sampled"]
    assert lead["streams"] == follow["streams"]
    assert len({tuple(s) for s in lead["streams"]}) == len(lead["streams"])


def test_tp_divergence_raises_on_every_rank(group):
    """A follower whose allocator hands out pages in another order: both
    ranks raise in the round of the first admission, in seconds (the
    collectives' limit is 120 s)."""
    ranks, _ = group
    for r in (0, 1):
        rec = ranks[r]["diverge"]
        assert rec["raised"] and "different host decisions" in rec["raised"]
        assert rec["round"] == 1 and rec["seconds"] < 60
    assert "diverge" not in ranks[2]


def test_tp_resize_keeps_streams_and_heads(group):
    """A live resize mid-trace on the leader, journaled to its follower:
    the streams are the unresized single-device engine's, and each rank's
    new pool holds its heads."""
    ranks, jax_side = group
    want = jax_side["port"]["f32_prefix"]  # the prefix cache changes no greedy token
    for r in (0, 1):
        rec = ranks[r]["resize"]
        assert rec["streams"] == want
        assert rec["resizes"] == 1 and rec["pool"][1] == 1 and rec["pool"][2] == 41


def _port_streams(case, extra=()):
    """The port's single-device engine on the case's trace and JAX's
    weights (tests/test_torch_serve.py, test_torch_variants.py and
    test_torch_moe.py hold it to JAX's engine)."""
    model, dtype, prefix, spec = CASES[case]
    cfg = GPTConfig(**MODELS[model])
    jp = JGPT.init(JGPTConfig(**MODELS[model]), jax.random.PRNGKey(0))
    params = params_from_numpy(_flatten(jp), config=cfg, device=CPU)
    kw = {}
    if spec:
        dcfg, dparams = self_draft(cfg, params, 1)
        kw = dict(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True, spec_k_max=4)
    eng = ServeEngine(cfg, params, device=CPU, **ENGINE, cache_dtype=torch.float32 if dtype == "f32" else torch.int8,
                      prefix_cache=prefix, **kw)
    prompts, budgets = _trace(0)
    uids = [eng.submit(p, b) for p, b in list(zip(prompts, budgets)) + list(extra)]
    done = eng.run()
    return [done[u].tokens.tolist() for u in uids]


def test_loadgen_tp_line(group):
    """`loadgen --tp 2 --device cpu` under torchrun: the leader prints one
    serve_slo line with its mesh, JAX's contract holds; the other ranks
    print nothing."""
    ranks, _ = group
    lines = ranks[0]["loadgen"]["stdout"].strip().splitlines()
    rec = json.loads(lines[-1])
    assert ranks[0]["loadgen"]["rc"] == 0 and check_serve_slo_bench(rec) == []
    assert rec["tp"] == 2 and rec["mesh"] == {"data": 1, "tp": 2}
    assert len(rec["points"]) == 2 and all(p["completed"] == p["n_offered"] == 4 for p in rec["points"])
    for r in (1, 2, 3):
        assert ranks[r]["loadgen"] == {"rc": 0, "stdout": ""}


def test_disagg_on_a_role_mesh(group):
    """DisaggServe on (data 2, tp 2) over 4 ranks: row 0 prefills, row 1
    decodes, each tp-sharded; the streams are a monolithic prefix-cache
    engine's (JAX's on its trace), pages crossed, and nothing re-prefilled;
    a request shorter than a page crosses with no page."""
    ranks, jax_side = group
    rec = ranks[0]["disagg"]
    assert rec["streams"] == jax_side["port_disagg"]
    assert rec["streams"][:4] == jax_side["f32_prefix"]
    assert rec["queue"]["pages_copied"] > 0 and rec["fallback"] == 0
    assert rec["meshes"] == [{"data": 1, "tp": 2}] * 2
    assert [ranks[r]["disagg"]["finished"] for r in (1, 2, 3)] == [5, 5, 5]


# ---------------------------------------------------------------- (d) refusals and checks


def _row(n_tp):
    """A stand-in for one rank's (data 1, tp) row: the checks read only these."""
    return types.SimpleNamespace(tp=n_tp, data=1, member=True)


def test_tp_rejects_indivisible_heads(jax_params):
    """JAX's refusal, with its message."""
    jcfg = JGPTConfig(**dict(TINY, n_head=3, n_embd=48))
    with pytest.raises(ValueError, match="n_head") as j_err:
        JServeEngine(jcfg, JGPT.init(jcfg, jax.random.PRNGKey(0)), max_slots=2, page_size=8, num_pages=29,
                     temperature=0.0, cache_dtype=jnp.float32, mesh=j_serve_tp.make_serve_mesh(tp_size=2))
    with pytest.raises(ValueError) as t_err:
        ServeEngine(GPTConfig(**dict(TINY, n_head=3, n_embd=48)), {}, device=CPU, mesh=_row(2))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="n_kv_heads=1 not divisible by mesh tp=2"):
        ServeEngine(GPTConfig(**dict(TINY, n_kv_heads=1)), {}, device=CPU, mesh=_row(2))


@pytest.mark.parametrize("overlap", ["group", "double"])
def test_captured_overlap_modes_are_refused_under_tp(overlap):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        ServeEngine(GPTConfig(**TINY), {}, device=CPU, mesh=_row(2), overlap=overlap)
    with pytest.raises(ValueError, match="one tp row"):
        ServeEngine(GPTConfig(**TINY), {}, device=CPU, mesh=types.SimpleNamespace(tp=2, data=2, member=True))


def test_training_mesh_still_refuses_tp(monkeypatch):
    """A training mesh takes tp (tests/test_torch_tp_train.py), beside ep
    too (tests/test_torch_ep.py): no axis is refused any more. On (tp 2,
    ep 2) a tp row is ranks ep apart and each ep group lies in one tp
    index; without a mesh a serving mesh has no shape."""
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda: 3)
    m = make_mesh(MeshConfig(data=1, fsdp=1, tp=2, ep=2), ranks=[0, 1, 2, 3], device=CPU)
    assert (m.tp_index, m.ep_index, m.tp_group, m.ep_group) == (1, 1, (1, 3), (2, 3))
    assert serve_tp.mesh_shape(None) is None


@pytest.mark.parametrize("model,mesh", [
    (dict(TINY, n_head=3, n_embd=48), dict(tp=2)),
    (dict(TINY, n_head=4, n_kv_heads=1), dict(tp=2)),
    (dict(TINY, vocab_size=95), dict(tp=2)),
    (TINY, dict(tp=0)),
], ids=["n_head", "n_kv_heads", "vocab", "tp0"])
def test_config_tp_checks_match_jax(model, mesh):
    base = dict(rundir="", data_dir="", learning_rate=1e-2, batch_size=4, warmup_steps=1, min_lr=1e-3,
                lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=10,
                param_dtype="float32", compute_dtype="float32", shard_model=True, g_accum_iters=1)
    with pytest.raises(ValueError) as j_err:
        JExperimentConfig(**base, mesh=JMeshConfig(**mesh), model_config=JGPTConfig(**model))
    with pytest.raises(ValueError) as t_err:
        ExperimentConfig(**base, mesh=MeshConfig(**mesh), model_config=GPTConfig(**model))
    assert str(t_err.value) == str(j_err.value)


def test_shard_leaf_takes_jax_layout_numpy():
    """convert.py's JAX-layout arrays shard as they are (no torch copy first)."""
    a = np.arange(2 * 3 * 8 * 4, dtype=np.float32).reshape(2, 3, 8, 4)
    got = serve_tp.shard_leaf(a, (None, None, "tp", None), 2, 1)
    np.testing.assert_array_equal(got.numpy(), a[:, :, 4:])
    assert serve_tp.shard_leaf(a, (None,) * 4, 2, 1).shape == a.shape
