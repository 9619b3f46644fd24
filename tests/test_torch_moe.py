"""Port parity, the routed MoE MLP (`n_experts`, top-k gates, the Switch
load-balance term): the port's `GPT._moe_gates`, `_moe_mlp`, block tail,
forward, loss and gradients, train step, remat policies, paged serving and
batch sampling against the JAX package's on JAX's weights carried across
by `convert.params_from_numpy`, at tests/test_moe.py's size (2 layers,
n_embd 32, 2 heads, E 4, top-2; vocab 96), inputs from numpy seeds. Also
the MoE configuration checks, `flops_per_token`, the worker spec, the hot
swap, and the standalone JAX-to-port checkpoint converter
(tools/jax_to_port.py).

Tolerances (float32; JAX at 'highest' matmul precision, conftest.py):
gates and aux 1e-6 absolute (one product and a softmax); the block tail
1e-5; logits 2e-5; loss 1e-5 relative and gradients 2e-5 absolute, the
train step's (tests/test_torch_train.py: summation order through two
layers). Selections, greedy streams and the remat policies are held
exactly. The converted run continues JAX's losses at 1e-5 relative."""

import dataclasses
import json
import os
import subprocess
import sys
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
from midgpt_tpu.ops.loss import fused_linear_cross_entropy as j_fused_ce
from midgpt_tpu.parallel.data import make_global_batch
from midgpt_tpu.parallel.mesh import batch_spec, make_mesh
from midgpt_tpu.sampling import engine as jengine
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu.training.metrics import flops_per_token as j_flops_per_token
from midgpt_tpu.training.train import init_state as j_init_state
from midgpt_tpu.training.train import make_train_step as j_make_train_step
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, param_names
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy
from midgpt_tpu_torch.sampling import engine
from midgpt_tpu_torch.sampling.serve import ServeEngine
from midgpt_tpu_torch.training.metrics import flops_per_token
from midgpt_tpu_torch.training.optim import make_optimizer
from midgpt_tpu_torch.training.train import make_train_step

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SHAPE = dict(block_size=32, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
MOE4 = dict(SHAPE, n_experts=4, moe_top_k=2)
ENGINE = dict(max_slots=3, page_size=8, num_pages=10, prefill_chunk=16, decode_chunk=8, temperature=0.0)
AUX_COEF = 0.01  # Switch's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models run fastest on one thread, and the suite's workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port params) of the MoE model."""
    jcfg, tcfg = JGPTConfig(**MOE4), GPTConfig(**MOE4)
    jp = jax.jit(lambda k: JGPT.init(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(_flatten(jp), config=tcfg, device=CPU)


def _layer0(jp, tp_):
    jmlp = jax.tree.map(lambda a: a[0], jp.blocks.mlp)
    blk = {k.split(".", 1)[1]: v[0] for k, v in tp_.items() if k.startswith("blocks.")}
    return jmlp, blk


def _h(shape=(2, 16, 32), seed=8, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------- gates and the aux term


def test_gates_and_aux_match_jax(pair):
    jcfg, jp, tcfg, tp_ = pair
    jmlp, blk = _layer0(jp, tp_)
    h = _h()
    want_g, want_aux = JGPT._moe_gates(jcfg, jmlp, jnp.asarray(h))
    got_g, got_aux = GPT._moe_gates(tcfg, blk, torch.from_numpy(h))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=1e-6, rtol=0)
    assert ((got_g > 0).sum(-1) == 2).all()
    assert GPT._moe_gates(tcfg, blk, torch.from_numpy(h), with_aux=False)[1] is None


def test_ties_keep_exactly_k_experts_lowest_index_first(pair):
    """A zero router ties every expert: exactly K survive, experts 0 and 1,
    at 0.5 each, and aux is exactly 1.0 (balanced). On the collapsed router
    of tests/test_moe.py (h all ones, router row 0 all ones) P is e_0 and
    the selection {0, 1}: aux 2.0. Both as JAX's."""
    jcfg, jp, tcfg, tp_ = pair
    jmlp, blk = _layer0(jp, tp_)
    h = _h((2, 8, 32), seed=6)
    zero = {**blk, "mlp.router": torch.zeros_like(blk["mlp.router"])}
    gates, aux = GPT._moe_gates(tcfg, zero, torch.from_numpy(h))
    want = torch.zeros(2, 8, 4)
    want[..., :2] = 0.5
    assert torch.equal(gates, want) and aux.item() == 1.0
    collapsed = torch.zeros_like(blk["mlp.router"])
    collapsed[0] = 1.0
    ones = np.ones_like(h)
    _, aux = GPT._moe_gates(tcfg, {**blk, "mlp.router": collapsed}, torch.from_numpy(ones))
    _, j_aux = JGPT._moe_gates(jcfg, dataclasses.replace(jmlp, router=jnp.asarray(collapsed.numpy())),
                               jnp.asarray(ones))
    np.testing.assert_allclose(aux.item(), 2.0, rtol=1e-6)
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-6)


def test_tie_order_matches_jax_top_k_on_many_ties(pair):
    """Integer-valued router products tie often (up to all four experts):
    the selected set equals `jax.lax.top_k`'s, token for token."""
    jcfg, jp, tcfg, tp_ = pair
    jmlp, blk = _layer0(jp, tp_)
    r = np.random.default_rng(3)
    h = r.integers(-1, 2, (4, 32, 32)).astype(np.float32)
    router = r.integers(-1, 2, (4, 32)).astype(np.float32)
    router[3] = router[1]  # experts 1 and 3 tie on every token
    want, _ = JGPT._moe_gates(jcfg, dataclasses.replace(jmlp, router=jnp.asarray(router)), jnp.asarray(h))
    got, _ = GPT._moe_gates(tcfg, {**blk, "mlp.router": torch.from_numpy(router)}, torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
    logits = h @ router.T
    assert (np.sort(logits, -1)[..., 1] == np.sort(logits, -1)[..., 2]).mean() > 0.2  # the ties are there


# ---------------------------------------------------------------- the block and the model


def test_block_tail_matches_jax(pair):
    jcfg, jp, tcfg, tp_ = pair
    jblock = jax.tree.map(lambda a: a[0], jp.blocks)
    _, blk = _layer0(jp, tp_)
    x, att = _h((2, 5, 32), seed=7, scale=2.0), _h((2, 5, 2, 16), seed=9, scale=2.0)
    want, want_aux = jax.jit(lambda b, x, a: JGPT._attn_out_and_mlp(jcfg, b, x, a, return_moe_aux=True))(
        jblock, jnp.asarray(x), jnp.asarray(att))
    got, got_aux = GPT._attn_out_and_mlp(tcfg, blk, torch.from_numpy(x), torch.from_numpy(att), return_moe_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=1e-6, rtol=0)
    assert torch.equal(GPT._attn_out_and_mlp(tcfg, blk, torch.from_numpy(x), torch.from_numpy(att)), got)


def test_one_expert_top_one_is_the_dense_model():
    """E 1, top-1: the gate is exactly 1.0, so the routed model is the
    dense one on the same weights, in logits and gradients; the router's
    gradient is exactly 0."""
    dense_cfg, moe_cfg = GPTConfig(**SHAPE), GPTConfig(**SHAPE, n_experts=1, moe_top_k=1)
    dense = GPT.init(dense_cfg, 0, device=CPU)
    moe = {k: v for k, v in dense.items() if not k.startswith("blocks.mlp.")}
    moe["blocks.mlp.router"] = torch.zeros(2, 1, 32)
    moe["blocks.mlp.experts_up"] = dense["blocks.mlp.w_up"][:, None].clone()
    moe["blocks.mlp.experts_down"] = dense["blocks.mlp.w_down"][:, None].clone()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (2, 32)))

    def run(cfg, params):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        logits = GPT.apply(cfg, p, tokens, inference=True)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 96), tokens.roll(-1, 1).reshape(-1))
        return logits.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    (l_d, g_d), (l_m, g_m) = run(dense_cfg, dense), run(moe_cfg, moe)
    torch.testing.assert_close(l_m, l_d, atol=1e-6, rtol=0)
    torch.testing.assert_close(g_m["blocks.mlp.experts_up"][:, 0], g_d["blocks.mlp.w_up"], atol=1e-6, rtol=0)
    torch.testing.assert_close(g_m["blocks.mlp.experts_down"][:, 0], g_d["blocks.mlp.w_down"], atol=1e-6, rtol=0)
    torch.testing.assert_close(g_m["wte"], g_d["wte"], atol=1e-6, rtol=0)
    assert torch.equal(g_m["blocks.mlp.router"], torch.zeros(2, 1, 32))


def _batch(seed=1, B=3, T=32):
    r = np.random.default_rng(seed)
    return r.integers(0, 96, (B, T)), r.integers(0, 96, (B, T))


def _port_loss_and_grads(cfg, params, x, y, coef=AUX_COEF):
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    h, aux = GPT.hidden(cfg, p, torch.from_numpy(x), return_moe_aux=True)
    loss = fused_linear_cross_entropy(h, p["lm_head"], torch.from_numpy(y), 8192, None) + coef * aux
    return loss.detach(), aux.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def test_logits_loss_and_grads_match_jax(pair):
    """Logits; CE + 0.01 aux and every gradient (the router's through
    both its gates and the aux term) against jax.value_and_grad."""
    jcfg, jp, tcfg, tp_ = pair
    x, y = _batch()
    def j_loss(params):
        h, aux = JGPT.hidden(jcfg, params, jnp.asarray(x), inference=True, return_moe_aux=True)
        return j_fused_ce(h, params.lm_head, jnp.asarray(y), 8192) + AUX_COEF * aux, (aux, h @ params.lm_head.T)

    (want_loss, (want_aux, want)), want_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jp)
    got = GPT.apply(tcfg, tp_, torch.from_numpy(x), inference=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    loss, aux, grads = _port_loss_and_grads(tcfg, tp_, x, y)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6, rtol=0)
    for k, v in _flatten(want_grads).items():
        np.testing.assert_allclose(grads[k.lstrip(".")].numpy(), v, atol=2e-5, rtol=0, err_msg=k)
    assert grads["blocks.mlp.router"].abs().max() > 0
    with pytest.raises(ValueError, match="routed MLP"):
        GPT.hidden(GPTConfig(**SHAPE), GPT.init(GPTConfig(**SHAPE), 0, device=CPU), torch.from_numpy(x),
                   return_moe_aux=True)


def _exp_kw(**over):
    kw = dict(
        rundir="", data_dir="", learning_rate=1e-2, batch_size=4, warmup_steps=1, min_lr=1e-3,
        lr_decay_steps=20, max_steps=20, beta2=0.95, weight_decay=1e-4, eval_interval=1000,
        param_dtype="float32", compute_dtype="float32", g_accum_iters=2, shard_model=False, eval_steps=2,
    )
    kw.update(over)
    return kw


def test_train_step_matches_jax_and_coef_zero_is_ce(pair):
    """Two G=2 steps at moe_aux_coef 0.01 from JAX's weights: the losses
    and the parameters after each step equal JAX's. At coefficient 0 the
    step's loss is exactly the CE of the same weights and batch."""
    jcfg, jp, tcfg, tp_ = pair
    jc = JExperimentConfig(**_exp_kw(moe_aux_coef=AUX_COEF), mesh=JMeshConfig(data=1, fsdp=1, sp=1),
                           model_config=jcfg)
    tc = ExperimentConfig(**_exp_kw(moe_aux_coef=AUX_COEF), mesh=MeshConfig(data=1, fsdp=1, sp=1),
                          model_config=tcfg)
    from midgpt_tpu.parallel.tp import tp_param_specs
    from midgpt_tpu.training.optim import make_optimizer as j_make_optimizer

    mesh = make_mesh(jc.mesh, devices=jax.devices()[:1])
    jp_ = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), jp)  # buffers of its own: the step donates them
    specs = tp_param_specs(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jp_), mesh,
                           jc.shard_model, jc.fsdp_min_size)
    j_opt = j_make_optimizer(jc)[0]
    j_state = jax.jit(j_opt.init)(jp_)
    j_step, *_ = j_make_train_step(jc, j_opt, mesh, specs)
    opt, _ = make_optimizer(tc)
    params = {k: v.clone() for k, v in tp_.items()}
    state = opt.init(params)
    t_step, *_ = make_train_step(tc, opt)
    r = np.random.default_rng(5)
    for i in range(2):
        x = r.integers(0, 96, (2, 4, 32)).astype(np.int32)
        y = np.roll(x, -1, axis=-1)
        jp_, j_state, j_loss = j_step(jp_, j_state, make_global_batch(x, mesh, batch_spec()),
                                      make_global_batch(y, mesh, batch_spec()), jax.random.PRNGKey(i))
        params, state, loss = t_step(params, state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
        for k, v in _flatten(jp_).items():
            np.testing.assert_allclose(params[k.lstrip(".")].numpy(), v, atol=2e-5, rtol=0, err_msg=f"step {i} {k}")
    # coefficient 0: the aux term is never computed
    tc0 = tc.replace(moe_aux_coef=0.0, g_accum_iters=1)
    opt0, _ = make_optimizer(tc0)
    step0, *_ = make_train_step(tc0, opt0)
    p0 = {k: v.clone() for k, v in tp_.items()}
    x, y = (torch.from_numpy(a).long() for a in _batch(seed=2, B=4))
    ce = fused_linear_cross_entropy(GPT.hidden(tcfg, tp_, x, inference=True), tp_["lm_head"], y, 8192, None)
    _, _, loss0 = step0(p0, opt0.init(p0), x[None], y[None])
    assert loss0.item() == ce.item()


# ---------------------------------------------------------------- remat


@pytest.mark.parametrize("policy", ("none", "dots", "dots_attn", "flash"))
def test_remat_policy_equals_remat_off(pair, policy):
    """CE + aux and every gradient under each policy == remat off, bit for
    bit (flash attention: its plain version here)."""
    _, _, tcfg, tp_ = pair
    off = dataclasses.replace(tcfg, attn_impl="flash", remat=False)
    x, y = _batch(seed=4)
    want = _port_loss_and_grads(off, tp_, x, y)
    got = _port_loss_and_grads(dataclasses.replace(off, remat=True, remat_policy=policy), tp_, x, y)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k


@pytest.mark.parametrize("policy", ("none", "dots"))
def test_dots_keeps_the_three_moe_products(pair, policy):
    """Under 'dots' the block keeps the router and experts_up products
    (`aten.mm`) and the combine product (`midgpt::moe_down`), as JAX's
    dots_with_no_batch_dims_saveable keeps its three einsums; 'none' keeps
    nothing."""
    _, _, tcfg, tp_ = pair
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    x = torch.from_numpy(_batch()[0])
    p = {k: v.clone().requires_grad_() for k, v in tp_.items()}
    h, aux = GPT.hidden(cfg, p, x, return_moe_aux=True)
    node = h.grad_fn.next_functions[0][0]  # the last block's output, under the final norm
    while node is not None and "_Keep" not in type(node).__name__:
        node = node.next_functions[0][0] if node.next_functions else None
    if policy == "none":
        assert node is None
        return
    kept = [func for func, _, _ in node.layout]
    shapes = [tuple(t.shape) for t in node.saved_tensors]
    N, E, D = x.numel(), cfg.n_experts, cfg.n_embd
    assert kept.count(torch.ops.midgpt.moe_down.default) == 1
    assert (N, E) in shapes and (N, E * 4 * D) in shapes  # the router's and experts_up's products


# ---------------------------------------------------------------- serving and sampling


def _trace():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 96, n).astype(np.int32), m) for n, m in zip((5, 13, 9), (26, 18, 22))]


@pytest.fixture(scope="module")
def served(pair):
    """JAX's engine on the MoE weights: greedy f32 streams of a trace that
    forces a recompute preemption, and the preemption count."""
    jcfg, jp, _, _ = pair
    eng = JServeEngine(jcfg, jp, cache_dtype=jnp.float32, **ENGINE)
    uids = [eng.submit(p, m) for p, m in _trace()]
    done = eng.run()
    return [done[u].tokens for u in uids], eng.preemptions


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_paged_streams_match_jax_engine(pair, served, attn_impl):
    _, _, tcfg, tp_ = pair
    want, want_preempt = served
    eng = ServeEngine(tcfg, tp_, cache_dtype=torch.float32, device=CPU, attn_impl=attn_impl, **ENGINE)
    uids = [eng.submit(p, m) for p, m in _trace()]
    done = eng.run()
    for i, (u, w) in enumerate(zip(uids, want)):
        np.testing.assert_array_equal(done[u].tokens, w, err_msg=f"request {i}")
    assert want_preempt >= 1 and eng.preemptions == want_preempt
    assert eng.allocator.free_count == eng.allocator.num_pages - 1


def test_batch_generate_matches_jax(pair):
    """Greedy `generate` past the cache (a windowed overflow) == JAX's."""
    jcfg, jp, tcfg, tp_ = pair
    prompt = np.random.default_rng(2).integers(0, 96, (2, 20)).astype(np.int32)
    want = np.asarray(jengine.generate(jcfg, jp, jnp.asarray(prompt), 16, temperature=0.0))
    got = engine.generate(tcfg, tp_, prompt, 16, temperature=0.0, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)


def test_worker_spec_and_hot_swap_carry_the_experts(pair):
    """A config's n_experts survives the JSON spec into a worker's engine,
    and a hot swap writes all three MoE leaves into the live tensors."""
    from midgpt_tpu_torch.sampling.fleet_proc import build_worker_engine

    _, _, tcfg, tp_ = pair
    spec = json.loads(json.dumps({"model": dataclasses.asdict(tcfg), "seed": 0, "device": "cpu",
                                  "engine": {"max_slots": 2, "page_size": 8, "num_pages": 9}}))
    eng, _ = build_worker_engine(spec)
    assert eng.config == tcfg and list(eng.params) == list(param_names(tcfg))
    live = {k: v.data_ptr() for k, v in eng.params.items()}
    eng.hot_swap({k: v.clone() for k, v in tp_.items()}, version="v2")
    assert eng.weights_version == "v2" and {k: v.data_ptr() for k, v in eng.params.items()} == live
    for k in ("blocks.mlp.router", "blocks.mlp.experts_up", "blocks.mlp.experts_down"):
        assert torch.equal(eng.params[k], tp_[k]), k


# ---------------------------------------------------------------- configuration and accounting


_J_CFG, _T_CFG = JGPTConfig(**SHAPE), GPTConfig(**SHAPE)


@pytest.mark.parametrize("over, model, match", [
    (dict(moe_aux_coef=0.01), {}, "routed MLP"),
    (dict(moe_aux_coef=0.01, fsdp_mode="shard_map"), MOE4, "gspmd"),
    (dict(moe_aux_coef=0.01, mesh=dict(fsdp=1, pp=2)), MOE4, "pp"),
    (dict(mesh=dict(fsdp=1, pp=2)), MOE4, "pp"),
    (dict(mesh=dict(ep=2)), {}, "n_experts"),
    (dict(mesh=dict(ep=2)), dict(SHAPE, n_experts=3), "divisible"),
    (dict(mesh=dict(ep=2), fsdp_mode="shard_map"), MOE4, "gspmd"),
], ids=["aux-dense", "aux-shard-map", "aux-pp", "pp", "ep-dense", "ep-indivisible", "ep-shard-map"])
def test_experiment_config_refuses_as_jax_does(over, model, match):
    mesh = over.pop("mesh", {})
    for exp, mesh_cls, cfg_cls in ((JExperimentConfig, JMeshConfig, JGPTConfig),
                                   (ExperimentConfig, MeshConfig, GPTConfig)):
        with pytest.raises(ValueError, match=match):
            exp(**_exp_kw(**over), mesh=mesh_cls(**mesh), model_config=cfg_cls(**(model or SHAPE)))
    # a valid ep > 1 mesh constructs in both
    for exp, mesh_cls, cfg_cls in ((JExperimentConfig, JMeshConfig, JGPTConfig),
                                   (ExperimentConfig, MeshConfig, GPTConfig)):
        exp(**_exp_kw(), mesh=mesh_cls(ep=2), model_config=cfg_cls(**MOE4))


@pytest.mark.parametrize("kw, match", [
    (dict(n_experts=-1), "n_experts=-1 must be >= 0"),
    (dict(n_experts=4, moe_top_k=0), r"moe_top_k=0 must be in \[1, n_experts=4\]"),
    (dict(n_experts=4, moe_top_k=5), r"moe_top_k=5 must be in \[1, n_experts=4\]"),
])
def test_model_config_refuses_as_jax_does(kw, match):
    with pytest.raises(ValueError, match=match):
        GPTConfig(**SHAPE, **kw)
    with pytest.raises(ValueError, match=match):
        JExperimentConfig(**_exp_kw(), mesh=JMeshConfig(), model_config=JGPTConfig(**SHAPE, **kw))


@pytest.mark.parametrize("kw", [{}, dict(n_experts=8, moe_top_k=2), dict(n_experts=4, moe_top_k=4)],
                         ids=["dense", "e8-top2", "e4-top4"])
def test_flops_per_token_is_jax_accounting(kw):
    """The MFU the port reports uses JAX's FLOPs a token: active experts
    for the routed MLP (local_text_124m's shape)."""
    shape = dict(block_size=1024, vocab_size=50304, n_layer=12, n_head=12, n_embd=768, **kw)
    assert flops_per_token(GPTConfig(**shape)) == j_flops_per_token(JGPTConfig(**shape))
    assert flops_per_token(GPTConfig(**shape), 512) == j_flops_per_token(JGPTConfig(**shape), 512)


# ---------------------------------------------------------------- the JAX-to-port converter


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _converter():
    """tools/jax_to_port.py as a module (in process: JAX is already up here)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_to_port", ROOT / "tools" / "jax_to_port.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converter_writes_a_port_step_of_a_jax_checkpoint(pair, tmp_path, capsys):
    """One command: JAX's checkpoint of an MoE model (weights and optax
    state after one update) becomes a port step directory with
    config.json, leaf for leaf."""
    from midgpt_tpu.config import to_json
    from midgpt_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
    from midgpt_tpu_torch.config import from_json
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager
    from midgpt_tpu_torch.training.train import state_template

    from midgpt_tpu.training.optim import make_optimizer as j_make_optimizer

    jcfg, jp, _, _ = pair
    jc = JExperimentConfig(**_exp_kw(rundir=str(tmp_path / "jax"), moe_aux_coef=AUX_COEF),
                           mesh=JMeshConfig(data=1, fsdp=1, sp=1), model_config=jcfg)
    j_opt = j_make_optimizer(jc)[0]
    grads = jax.tree.map(lambda a: 0.01 * jnp.ones_like(a), jp)
    _, j_state = jax.jit(j_opt.update)(grads, jax.jit(j_opt.init)(jp), jp)
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "config.json").write_text(to_json(jc))
    mngr = JCheckpointManager(str(tmp_path / "jax"), save_interval_steps=1)
    mngr.save(7, {"params": jp, "opt_state": j_state}, force=True)
    mngr.close()
    assert _converter().main([f"--jax_rundir={tmp_path / 'jax'}", f"--out={tmp_path / 'port'}"]) == 0
    assert "converted step 7" in capsys.readouterr().out
    tc = from_json((tmp_path / "port" / "config.json").read_text())
    assert tc.model_config.n_experts == 4 and tc.rundir == str(tmp_path / "port")
    state = CheckpointManager(str(tmp_path / "port")).restore(7, state_template(tc), device=CPU)
    want = _flatten(jp)
    for k, v in want.items():
        np.testing.assert_array_equal(state["params"][k.lstrip(".")].numpy(), v, err_msg=k)
    mu = _flatten(j_state[1].mu)
    for k, v in mu.items():
        np.testing.assert_array_equal(state["opt_state"].mu[k.lstrip(".")].numpy(), v, err_msg=k)
    assert state["opt_state"].adam_count == 1


@pytest.mark.slow  # JAX trains, saves and restores through orbax; the port's launcher resumes (~20 s)
def test_port_launcher_resumes_a_converted_jax_moe_run(tmp_path):
    """JAX trains an f32 MoE model (aux 0.01) for 3 steps and saves step 2;
    the converter writes a port step; the port's launcher resumes at step 3
    and its losses of steps 3-5 continue JAX's own at 1e-5 relative."""
    from midgpt_tpu.config import to_json
    from midgpt_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.data.dataset import TokenDataset

    data = tmp_path / "data"
    data.mkdir()
    r = np.random.default_rng(0)
    stream = np.where(r.random(20000) < 0.1, r.integers(0, 96, 20000), np.arange(20000) % 17)
    stream.astype(np.uint16).tofile(data / "train.bin")
    stream[:4000].astype(np.uint16).tofile(data / "val.bin")
    N, M = 3, 3
    jc = JExperimentConfig(**_exp_kw(rundir=str(tmp_path / "jax"), data_dir=str(data), moe_aux_coef=AUX_COEF,
                                     max_steps=N + M, warmup_steps=2),
                           mesh=JMeshConfig(data=1, fsdp=1, sp=1), model_config=JGPTConfig(**MOE4))
    mesh = make_mesh(jc.mesh, devices=jax.devices()[:1])
    jp, j_state, specs, j_opt = j_init_state(jc, mesh)
    j_step, *_ = j_make_train_step(jc, j_opt, mesh, specs)
    ds = TokenDataset(str(data), seed=jc.data_seed)
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "config.json").write_text(to_json(jc))
    losses = []
    for i in range(N + M):
        x, y = ds.batch("train", i, 32, 4, 2)
        jp, j_state, loss = j_step(jp, j_state, make_global_batch(x, mesh, batch_spec()),
                                   make_global_batch(y, mesh, batch_spec()), jax.random.PRNGKey(i))
        losses.append(float(loss))
        if i == N - 1:
            mngr = JCheckpointManager(str(tmp_path / "jax"), save_interval_steps=1)
            mngr.save(i, {"params": jp, "opt_state": j_state}, force=True)
            mngr.close()
    out = subprocess.run([sys.executable, "tools/jax_to_port.py", f"--jax_rundir={tmp_path / 'jax'}",
                          f"--out={tmp_path / 'port'}"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    result = launch.main(["--config=shakespeare_char", "--device=cpu", f"--rundir={tmp_path / 'port'}",
                          "--set", f"data_dir={data}", *_launcher_sets(jc)])
    assert result["resumed_from"] == N - 1
    got = {}
    for line in (tmp_path / "port" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "loss/optimized" in rec:
            got[rec["step"]] = rec["loss/optimized"]
    np.testing.assert_allclose([got[s] for s in range(N, N + M)], losses[N:], rtol=1e-5)


def _launcher_sets(jc):
    """--set overrides that make the launcher's preset the JAX run's config."""
    mc = jc.model_config
    over = {"learning_rate": jc.learning_rate, "batch_size": jc.batch_size, "warmup_steps": jc.warmup_steps,
            "min_lr": jc.min_lr, "lr_decay_steps": jc.lr_decay_steps, "max_steps": jc.max_steps,
            "beta2": jc.beta2, "weight_decay": jc.weight_decay, "eval_interval": jc.eval_interval,
            "param_dtype": jc.param_dtype, "compute_dtype": jc.compute_dtype, "g_accum_iters": jc.g_accum_iters,
            "eval_steps": jc.eval_steps, "log_interval": 1, "moe_aux_coef": jc.moe_aux_coef,
            "data_seed": jc.data_seed, "seed": jc.seed, "spec_layers": 0}
    over.update({f"model_config.{k}": v for k, v in dataclasses.asdict(mc).items()
                 if k in ("block_size", "vocab_size", "n_layer", "n_head", "n_embd", "n_experts", "moe_top_k",
                          "dropout", "attn_impl", "remat", "rope_style")})
    return [a for k, v in over.items() for a in ("--set", f"{k}={v}")]
