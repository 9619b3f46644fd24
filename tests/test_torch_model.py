"""Port parity, model: the weight converter, `GPT.apply` logits, the paged
prefill/decode forwards (logits AND pool contents), and init statistics,
against midgpt_tpu on converted weights. Init is held by statistics and
transplanted weights, never bit for bit (JAX threefry != torch).

Tolerance: float32 logits 2e-5 absolute (a few f32 matmul/softmax
summation-order ulps through two layers); pool contents 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.models.gpt import PagedKVCache as JCache
from midgpt_tpu_torch.convert import params_from_numpy, params_to_numpy
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache, param_names
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

CPU = torch.device("cpu")
SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ATOL = 2e-5


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(rope_style="interleaved", seed=0):
    jcfg = JConfig(**SHAPE, rope_style=rope_style)
    tcfg = GPTConfig(**SHAPE, rope_style=rope_style)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(seed))
    # non-trivial QK-norm scales so the split permutation of them matters
    r = np.random.default_rng(seed)
    jp.blocks.attn.q_scale = jnp.asarray(r.uniform(0.5, 1.5, jp.blocks.attn.q_scale.shape), jnp.float32)
    jp.blocks.attn.k_scale = jnp.asarray(r.uniform(0.5, 1.5, jp.blocks.attn.k_scale.shape), jnp.float32)
    return jcfg, jp, tcfg, params_from_numpy(_flatten(jp), device=CPU)


def test_converter_round_trip():
    _, jp, _, tp_ = _pair()
    flat = _flatten(jp)
    back = params_to_numpy(tp_)
    assert set(back) == {k.lstrip(".") for k in flat}
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k.lstrip(".")], v)
    # and back into the JAX pytree, leaf for leaf
    treedef = jax.tree_util.tree_structure(jp)
    rebuilt = jax.tree_util.tree_unflatten(treedef, [back[k.lstrip(".")] for k in flat])
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_converter_refuses_unported_leaves():
    """The routed MoE MLP's leaves (JAX MoEParams) convert, with a config
    and without one (the router names the layout); a leaf set that fits no
    layout, the dense MLP's and the routed one's together, is refused. GQA's
    wkv converts too (tests/test_torch_variants.py)."""
    _, jp, _, _ = _pair()
    flat = _flatten(jp)
    dense = {k: flat.pop(k) for k in (".blocks.mlp.w_up", ".blocks.mlp.w_down")}
    flat[".blocks.mlp.router"] = np.zeros((2, 4, 32), np.float32)
    flat[".blocks.mlp.experts_up"] = np.ones((2, 4, 128, 32), np.float32)
    flat[".blocks.mlp.experts_down"] = np.ones((2, 4, 32, 128), np.float32)
    moe_cfg = GPTConfig(**SHAPE, n_experts=4)
    for config in (None, moe_cfg):
        got = params_from_numpy(flat, config=config, device=CPU)
        assert list(got) == list(param_names(moe_cfg))
        assert got["blocks.mlp.experts_up"].shape == (2, 4, 128, 32)
    assert set(params_to_numpy(got)) == {k.lstrip(".") for k in flat}
    with pytest.raises(ValueError, match="layout"):
        params_from_numpy({**flat, **dense}, device=CPU)
    with pytest.raises(ValueError, match="layout"):
        params_from_numpy(flat, config=GPTConfig(**SHAPE), device=CPU)


def test_block_tail_uses_tanh_gelu_like_jax():
    """jax.nn.gelu defaults to the tanh approximation: the block tail must
    match it, and the exact-erf GELU would not (the pin is sensitive)."""
    jcfg, jp, tcfg, tp_ = _pair(seed=6)
    r = np.random.default_rng(7)
    x = (2 * r.standard_normal((2, 5, 32))).astype(np.float32)
    att = (2 * r.standard_normal((2, 5, 2, 16))).astype(np.float32)
    jblock = jax.tree.map(lambda a: a[0], jp.blocks)
    want = np.asarray(JGPT._attn_out_and_mlp(jcfg, jblock, jnp.asarray(x), jnp.asarray(att)))
    blk = {k.split(".", 1)[1]: v[0] for k, v in tp_.items() if k.startswith("blocks.")}
    got = GPT._attn_out_and_mlp(tcfg, blk, torch.from_numpy(x), torch.from_numpy(att)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    xr = torch.from_numpy(x) + torch.from_numpy(att).reshape(2, 5, 32) @ blk["attn.wo"].T
    hn = xr * torch.rsqrt((xr * xr).mean(-1, keepdim=True) + 1e-6)
    h = torch.nn.functional.gelu(hn @ blk["mlp.w_up"].T)  # exact erf
    erf_out = (xr + h @ blk["mlp.w_down"].T).numpy()
    assert np.abs(erf_out - want).max() > 1e-4


@pytest.mark.parametrize("rope_style", ["interleaved", "split"])
def test_apply_logits_match_jax(rope_style):
    jcfg, jp, tcfg, tp_ = _pair(rope_style)
    tokens = np.random.default_rng(1).integers(0, 96, (2, 16))
    want = np.asarray(JGPT.apply(jcfg, jp, jnp.asarray(tokens), inference=True))
    got = GPT.apply(tcfg, tp_, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# jitted like the JAX engine runs them (one compile instead of op-by-op)
_j_prefill = jax.jit(JGPT.prefill_paged_chunk, static_argnums=(0,))
_j_decode = jax.jit(JGPT.decode_step_paged, static_argnums=(0, 7, 8, 9))


@pytest.mark.parametrize("rope_style", ["interleaved", "split"])
def test_paged_prefill_and_decode_match_jax(rope_style):
    """Two prefill chunks (the second padded) for slot 0, a one-chunk
    prefill for slot 1, then decode steps with slot 2 inactive: logits of
    every valid row and pool pages 0..n_pages-1 must agree; pad writes are
    dropped on both sides, and the inactive slot's writes go to the port's
    spare page (JAX drops them past the pool)."""
    jcfg, jp, tcfg, tp_ = _pair(rope_style, seed=2)
    ps, n_pages = 8, 12
    jc = JCache.init(jcfg, num_pages=n_pages, page_size=ps, dtype=jnp.float32)
    tc = PagedKVCache.init(tcfg, num_pages=n_pages, page_size=ps, dtype=torch.float32, device=CPU)
    table = np.array([[3, 7, 1, 0], [5, 2, 0, 0], [9, 0, 0, 0]], np.int32)
    prompt0 = np.random.default_rng(3).integers(0, 96, 21)
    prompt1 = np.random.default_rng(4).integers(0, 96, 9)
    chunk = 16
    for slot, prompt in ((0, prompt0), (1, prompt1)):
        for start in range(0, len(prompt), chunk):
            n_valid = min(chunk, len(prompt) - start)
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :n_valid] = prompt[start : start + n_valid]
            row = table[slot : slot + 1]
            jl, jc = _j_prefill(
                jcfg, jp, jnp.asarray(toks), jnp.asarray(start, jnp.int32),
                jnp.asarray(n_valid, jnp.int32), jc, jnp.asarray(row),
            )
            tl, tc = GPT.prefill_paged_chunk(
                tcfg, tp_, torch.from_numpy(toks), start, n_valid, tc, torch.from_numpy(row)
            )
            np.testing.assert_allclose(tl.numpy()[0, :n_valid], np.asarray(jl)[0, :n_valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.k[:, :, :n_pages].numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc.v[:, :, :n_pages].numpy(), np.asarray(jc.v), atol=1e-5, rtol=0)

    lengths = np.array([21, 9, 0], np.int32)
    token = np.array([5, 17, 0], np.int32)
    active = np.array([True, True, False])
    for split_k in (1, 2):  # two steps: the unsplit and a split lowering
        jl, jc = _j_decode(
            jcfg, jp, jnp.asarray(token), jc, jnp.asarray(table), jnp.asarray(lengths),
            jnp.asarray(active), "gather", None, split_k,
        )
        tl, tc = GPT.decode_step_paged(
            tcfg, tp_, torch.from_numpy(token), tc, torch.from_numpy(table),
            torch.from_numpy(lengths), torch.from_numpy(active), attn_impl="gather", split_k=split_k,
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tc.k[:, :, :n_pages].numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tc.v[:, :, :n_pages].numpy(), np.asarray(jc.v), atol=1e-5, rtol=0)
        token = np.asarray(jl).argmax(-1).astype(np.int32)
        lengths = lengths + active
    # no write reached the sink page (the pool parity above covers the
    # inactive slot's own page 9, which JAX's dropped write leaves alone)
    assert not tc.k[:, :, 0].any() and not tc.v[:, :, 0].any()


def test_decode_template_plain_path_matches_gather_path():
    """attn_impl='kernel' on CPU runs the template's plain version: same
    logits as the gather lowering within f32 tolerance."""
    _, _, tcfg, tp_ = _pair(seed=5)
    table = torch.tensor([[3, 7, 1, 0], [5, 2, 0, 0]], dtype=torch.int32)
    outs = []
    for impl in ("gather", "kernel"):
        c = PagedKVCache.init(tcfg, num_pages=10, page_size=8, dtype=torch.float32, device=CPU)
        torch.manual_seed(0)
        c.k.normal_()
        c.v.normal_()
        logits, c = GPT.decode_step_paged(
            tcfg, tp_, torch.tensor([4, 9]), c, table, torch.tensor([19, 11], dtype=torch.int32),
            torch.tensor([True, True]), attn_impl=impl, split_k=2,
        )
        outs.append(logits)
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=ATOL, rtol=0)


def test_init_statistics():
    """Init is held by statistics: truncated normal(±2σ)/sqrt(fan_in) for
    projections, N(0, 1/sqrt(D)) embeddings, unit QK-norm scales, lm_head
    an independent copy of wte — and the same moments as the JAX init."""
    shape = dict(block_size=64, vocab_size=512, n_layer=2, n_head=4, n_embd=128)
    tp_ = GPT.init(GPTConfig(**shape), 0, device=CPU)
    jp = _flatten(JGPT.init(JConfig(**shape), jax.random.PRNGKey(0)))
    D = 128
    trunc_std = 0.8796256610342398  # std of N(0,1) truncated to [-2, 2]
    for name, fan_in in (("blocks.attn.wqkv", D), ("blocks.attn.wo", D),
                         ("blocks.mlp.w_up", D), ("blocks.mlp.w_down", 4 * D)):
        w = tp_[name]
        assert w.abs().max() <= 2 / fan_in**0.5 + 1e-7
        assert abs(w.std().item() * fan_in**0.5 - trunc_std) < 0.02
        assert abs(w.mean().item()) * fan_in**0.5 < 0.02
        assert abs(w.std().item() - jp["." + name].std()) / jp["." + name].std() < 0.03
    assert abs(tp_["wte"].std().item() * D**0.5 - 1.0) < 0.02
    assert torch.equal(tp_["lm_head"], tp_["wte"])
    assert tp_["lm_head"].data_ptr() != tp_["wte"].data_ptr()
    assert (tp_["blocks.attn.q_scale"] == 1).all() and (tp_["blocks.attn.k_scale"] == 1).all()
    # same seed, same weights; another seed, others
    assert torch.equal(GPT.init(GPTConfig(**shape), 0, device=CPU)["wte"], tp_["wte"])
    assert not torch.equal(GPT.init(GPTConfig(**shape), 1, device=CPU)["wte"], tp_["wte"])


PRESETS = ["openwebtext", "shakespeare_char", "local_text_124m", "wide610m", "openwebtext_xl", "openwebtext_mh",
           "local_text_124m_10k", "llama7b_long", "llama7b_32k"]


@pytest.mark.parametrize("name", PRESETS)
def test_configs_load_from_jax_config_json(name):
    """A config.json written by the JAX package loads in the port, and the
    port's presets equal the JAX presets field for field."""
    import dataclasses

    from midgpt_tpu.config import load_config as j_load, to_json
    from midgpt_tpu_torch.config import from_json, load_config

    from midgpt_tpu_torch.config import to_json as t_to_json

    jcfg = j_load(name)
    for got in (from_json(to_json(jcfg)), load_config(name)):
        assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    assert t_to_json(load_config(name)) == to_json(jcfg)


def test_every_jax_preset_has_a_port_preset():
    import pkgutil

    import midgpt_tpu.configs

    assert sorted(m.name for m in pkgutil.iter_modules(midgpt_tpu.configs.__path__)) == sorted(PRESETS)


@pytest.mark.parametrize("name", PRESETS)
def test_launcher_names_a_mesh_it_leaves_unused(name, monkeypatch):
    """The launcher leaves no mesh axis unused any more, so it names none
    (its note is gone): each preset's mesh with ep 2 over a routed MLP
    lays out on twice the ranks of its sp x tp x pp block, ep the fastest
    axis, and the data and fsdp axes clamp to the ranks there are,
    silently, as in JAX."""
    import dataclasses

    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.parallel.mesh import make_mesh

    assert not hasattr(launch, "unused_mesh")
    cfg = load_config(name)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=-1, ep=2),
                      model_config=dataclasses.replace(cfg.model_config, n_experts=4))
    n = 2 * max(1, cfg.mesh.sp) * max(1, cfg.mesh.tp) * max(1, cfg.mesh.pp)
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks, **kw: tuple(ranks))
    monkeypatch.setattr("midgpt_tpu_torch.parallel.dist.rank", lambda: 1)
    m = make_mesh(cfg.mesh, ranks=range(n), device="cpu")
    assert (m.size, m.shape["ep"], m.ep_index, m.ep_group, m.batch_index) == (n, 2, 1, (0, 1), 0)


def _stacked_init(config, seed, dtype):
    """GPT.init as it was before it filled its leaves layer by layer: every
    layer's f32 draws stacked on the host, then cast."""
    import math

    from midgpt_tpu_torch.models.gpt import WKV, _linear_init, param_names

    gen = torch.Generator().manual_seed(seed)
    L, D, C, V = config.n_layer, config.n_embd, config.head_dim, config.vocab_size
    KVD = config.kv_heads * C
    gqa = config.n_kv_heads is not None
    E = config.n_experts
    wqkv, wkv, wo, w_up, w_down, router = [], [], [], [], [], []
    for _ in range(L):
        if gqa:
            wqkv.append(_linear_init(gen, D, D).reshape(1, D, D))
            wkv.append(_linear_init(gen, 2 * KVD, D).reshape(2, KVD, D))
        else:
            wqkv.append(_linear_init(gen, 3 * D, D).reshape(3, D, D))
        wo.append(_linear_init(gen, D, D))
        if E:  # the router, then each expert's up and down projections
            router.append(_linear_init(gen, E, D))
            w_up.append(torch.stack([_linear_init(gen, 4 * D, D) for _ in range(E)]))
            w_down.append(torch.stack([_linear_init(gen, D, 4 * D) for _ in range(E)]))
        else:
            w_up.append(_linear_init(gen, 4 * D, D))
            w_down.append(_linear_init(gen, D, 4 * D))
    embed = torch.randn(V, D, generator=gen) / math.sqrt(D)
    params = {
        "wte": embed, "blocks.attn.wqkv": torch.stack(wqkv), "blocks.attn.wo": torch.stack(wo),
        "blocks.attn.q_scale": torch.ones(L, C), "blocks.attn.k_scale": torch.ones(L, C),
        "blocks.mlp.w_up": torch.stack(w_up), "blocks.mlp.w_down": torch.stack(w_down), "lm_head": embed.clone(),
    }
    if gqa:
        params[WKV] = torch.stack(wkv)
    if E:
        params.update({"blocks.mlp.router": torch.stack(router), "blocks.mlp.experts_up": params.pop("blocks.mlp.w_up"),
                       "blocks.mlp.experts_down": params.pop("blocks.mlp.w_down")})
    return {k: params[k].to(dtype) for k in param_names(config)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extra", [{}, dict(n_kv_heads=1), dict(n_experts=3)])
def test_init_fills_each_layer_with_the_stacked_draws(dtype, extra):
    """Filling preallocated leaves layer by layer in the target dtype gives
    the values of every layer's draws stacked in f32 and cast: a seed's
    weights did not change."""
    cfg = GPTConfig(**SHAPE, **extra)
    got = GPT.init(cfg, 3, device=CPU, dtype=dtype)
    want = _stacked_init(cfg, 3, dtype)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == dtype and torch.equal(got[k], want[k]), k
    assert got["lm_head"].data_ptr() != got["wte"].data_ptr()


@pytest.mark.parametrize("extra", [dict(n_experts=2)])
def test_unported_variants_raise(extra):
    """The routed MLP is ported: its config constructs and GPT.init makes
    its leaves; a top-k outside [1, n_experts] raises as JAX's check does."""
    cfg = GPTConfig(**SHAPE, **extra)
    assert set(GPT.init(cfg, 0, device=CPU)) == set(param_names(cfg))
    with pytest.raises(ValueError, match=r"moe_top_k=3 must be in \[1, n_experts=2\]"):
        GPTConfig(**SHAPE, **extra, moe_top_k=3)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT.init(GPTConfig(**SHAPE), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache.init(GPTConfig(**SHAPE), num_pages=4)
