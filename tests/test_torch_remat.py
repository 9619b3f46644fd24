"""Per-block remat (ops/remat.py, `GPT.hidden` with `remat=True`): each of
JAX's four policies gives the loss and gradients of remat off, with
dropout too; the policies keep their activations in the stated order of
size; the flash forward is recomputed under 'none' and 'dots' only; eval
does not checkpoint; and the 'flash' policy on the flash path matches
JAX's remat'd `GPT.hidden` plus CE on converted weights.

Tolerances: remat against remat off is held bit for bit (torch.equal):
the recompute runs the same ops on the same inputs, and kept outputs are
the forward's own. Against JAX (float32, two layers): loss 1e-5 relative
and gradients 2e-5 absolute, the train step's tolerances
(tests/test_torch_train.py: summation order through two layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JGPTConfig
from midgpt_tpu.ops.loss import fused_linear_cross_entropy as j_fused_ce
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.kernels import flash_attention as fa
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig
from midgpt_tpu_torch.ops import remat
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy
from midgpt_tpu_torch.training.optim import make_optimizer
from midgpt_tpu_torch.training.train import _generators, make_train_step
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

CPU = torch.device("cpu")
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=32, rope_style="split", remat=False)
POLICIES = ("none", "dots", "dots_attn", "flash")


def _batch(seed=1, B=3, T=32, V=64):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, V, (B, T), generator=g), torch.randint(0, V, (B, T), generator=g)


def _loss_and_grads(cfg, params, x, y, generator=None, saved=None):
    """f32 loss and gradients of hidden + fused CE. `saved`, a dict, gets
    {storage pointer: bytes} of every storage autograd saves for the
    backward, but the parameters'."""
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    param_ptrs = {t.untyped_storage().data_ptr() for t in p.values()}

    def pack(t):
        s = t.untyped_storage()
        if saved is not None and s.data_ptr() not in param_ptrs:
            saved[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h = GPT.hidden(cfg, p, x, generator=generator)
        loss = fused_linear_cross_entropy(h, p["lm_head"], y, 8192, None)
    return loss.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", [
    dict(attn_impl="flash"),
    dict(attn_impl="naive"),
    dict(attn_impl="blockwise", attn_block_size=16),
    dict(attn_impl="flash", n_kv_heads=1),
])
def test_policy_equals_remat_off(policy, model):
    off = GPTConfig(**MODEL, **model)
    params = GPT.init(off, 0, device=CPU)
    x, y = _batch()
    want = _loss_and_grads(off, params, x, y)
    _assert_same(_loss_and_grads(dataclasses.replace(off, remat=True, remat_policy=policy), params, x, y), want)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_with_dropout_equals_remat_off(policy):
    """Dropout (embedding, attention probabilities, both residuals) from a
    seeded generator: the recompute must draw the forward's masks."""
    off = GPTConfig(**MODEL, attn_impl="naive", dropout=0.1)
    params = GPT.init(off, 0, device=CPU)
    x, y = _batch()
    want = _loss_and_grads(off, params, x, y, torch.Generator().manual_seed(5))
    on = dataclasses.replace(off, remat=True, remat_policy=policy)
    gen = torch.Generator().manual_seed(5)
    _assert_same(_loss_and_grads(on, params, x, y, gen), want)
    # the generator ends where the forward left it, not where a recompute did
    ref = torch.Generator().manual_seed(5)
    with torch.no_grad():
        GPT.hidden(off, params, x, generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())


def test_train_step_with_remat_and_dropout_equals_remat_off(tmp_path):
    """Two G=2 steps of `make_train_step` with the per-microstep dropout
    generators: identical losses and parameters with remat on and off."""
    def config(remat_on):
        return ExperimentConfig(
            rundir="", data_dir=str(tmp_path), learning_rate=1e-2, batch_size=3, warmup_steps=1,
            min_lr=1e-3, lr_decay_steps=10, max_steps=10, beta2=0.95, weight_decay=1e-4,
            eval_interval=10, param_dtype="float32", compute_dtype="float32", g_accum_iters=2,
            shard_model=False, mesh=MeshConfig(data=1, fsdp=1, sp=1),
            model_config=GPTConfig(**{**MODEL, "remat": remat_on}, attn_impl="naive", dropout=0.1),
        )

    runs = []
    for remat_on in (False, True):
        cfg = config(remat_on)
        opt, _ = make_optimizer(cfg)
        params = GPT.init(cfg.model_config, 0, device=CPU)
        state = opt.init(params)
        step, _ = make_train_step(cfg, opt)
        losses = []
        for i in range(2):
            x = torch.stack([_batch(seed=10 * i + g)[0] for g in range(2)])
            y = torch.stack([_batch(seed=10 * i + g)[1] for g in range(2)])
            params, state, loss = step(params, state, x, y, _generators(cfg, i, 2, CPU))
            losses.append(loss)
        runs.append((losses, params))
    (l_off, p_off), (l_on, p_on) = runs
    assert all(torch.equal(a, b) for a, b in zip(l_on, l_off))
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_off)


def test_saved_bytes_fall_in_policy_order():
    """Bytes of the distinct storages saved-tensor hooks see for the
    backward (parameters left out), at attn_impl='flash': none < dots <=
    dots_attn <= flash < remat off."""
    off = GPTConfig(**MODEL, attn_impl="flash")
    params = GPT.init(off, 0, device=CPU)
    x, y = _batch()

    def saved_bytes(cfg):
        saved = {}
        _loss_and_grads(cfg, params, x, y, saved=saved)
        return sum(saved.values())

    got = {p: saved_bytes(dataclasses.replace(off, remat=True, remat_policy=p)) for p in POLICIES}
    got["off"] = saved_bytes(off)
    assert got["none"] < got["dots"] <= got["dots_attn"] <= got["flash"] < got["off"], got


@pytest.mark.parametrize("policy", (*POLICIES, None))
def test_flash_forward_recomputed_only_under_none_and_dots(policy, monkeypatch):
    """The backward runs the flash forward again (its plain version on the
    CPU) exactly when the policy does not keep the forward's out and lse."""
    calls = []
    plain = fa.flash_forward_plain
    monkeypatch.setattr(fa, "flash_forward_plain", lambda *a: calls.append(1) or plain(*a))
    off = GPTConfig(**MODEL, attn_impl="flash")
    cfg = off if policy is None else dataclasses.replace(off, remat=True, remat_policy=policy)
    params = GPT.init(off, 0, device=CPU)
    x, y = _batch()
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss = fused_linear_cross_entropy(GPT.hidden(cfg, p, x), p["lm_head"], y, 8192, None)
    assert len(calls) == off.n_layer
    torch.autograd.grad(loss, list(p.values()))
    assert len(calls) == off.n_layer * (2 if policy in ("none", "dots") else 1)


def test_eval_and_inference_do_not_checkpoint(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("checkpointed outside a training forward")

    monkeypatch.setattr(remat, "checkpoint_block", refuse)
    cfg = GPTConfig(**{**MODEL, "remat": True}, attn_impl="flash")
    params = GPT.init(cfg, 0, device=CPU)
    x, _ = _batch()
    with torch.no_grad():
        a = GPT.hidden(cfg, params, x)
    b = GPT.hidden(cfg, params, x, inference=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["everything", None])
def test_unknown_policy_raises(policy):
    cfg = GPTConfig(**{**MODEL, "remat": True, "remat_policy": policy})
    params = {k: v.requires_grad_() for k, v in GPT.init(cfg, 0, device=CPU).items()}
    with pytest.raises(ValueError, match="remat_policy"):
        GPT.hidden(cfg, params, _batch()[0])


def test_launcher_override_picks_the_none_policy():
    """`--set model_config.remat_policy=none` is the 'none' policy (a str
    field keeps the word); a field that may be None still reads it as
    None."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.launch import apply_overrides

    cfg = apply_overrides(load_config("openwebtext"), [("model_config.remat_policy", "none"),
                                                      ("loss_remat_chunks", "none")])
    assert cfg.model_config.remat_policy == "none" and cfg.loss_remat_chunks is None


def _flatten(params) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v) for p, v in leaves}


def test_flash_policy_matches_jax():
    """remat=True, remat_policy='flash', attn_impl='flash': the port's loss
    and gradients against JAX's remat'd `GPT.hidden` plus fused CE on the
    same (JAX-initialized) weights."""
    model = dict(MODEL, attn_impl="flash", remat=True, remat_policy="flash")
    jcfg, tcfg = JGPTConfig(**model), GPTConfig(**model)
    jp = JGPT.init(jcfg, jax.random.PRNGKey(3))
    x, y = (t.numpy() for t in _batch())

    def j_loss(params):
        return j_fused_ce(JGPT.hidden(jcfg, params, jnp.asarray(x)), params.lm_head, jnp.asarray(y), 8192)

    want_loss, want_grads = jax.value_and_grad(j_loss)(jp)
    loss, grads = _loss_and_grads(tcfg, params_from_numpy(_flatten(jp), device=CPU), torch.from_numpy(x),
                                  torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k, v in _flatten(want_grads).items():
        np.testing.assert_allclose(grads[k].numpy(), v, atol=2e-5, rtol=0, err_msg=k)
