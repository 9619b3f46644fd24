"""Port parity, serving engine: the port's ServeEngine against the JAX
ServeEngine on the same converted weights — greedy, float32 cache, a
mixed-length trace on a pool small enough to force recompute preemption.
Token streams must be IDENTICAL and the preemption counts equal, through
the gather lowering, the template's plain version, and a forced split-K;
every page returns to the pool after run()."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.sampling.serve import PageAllocator, ServeEngine
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(max_slots=3, page_size=8, num_pages=10, prefill_chunk=16, decode_chunk=8, temperature=0.0)
CPU = torch.device("cpu")


def _trace():
    rng = np.random.default_rng(0)
    return [
        (rng.integers(0, SHAPE["vocab_size"], n).astype(np.int32), m)
        for n, m in zip((5, 23, 11), (30, 24, 40))
    ]


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's streams and preemption count, plus the weights."""
    jp = JGPT.init(JConfig(**SHAPE), jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    eng = JServeEngine(JConfig(**SHAPE), jp, cache_dtype=jnp.float32, **ENGINE)
    uids = [eng.submit(p, m) for p, m in _trace()]
    done = eng.run()
    return flat, [done[u].tokens for u in uids], eng.preemptions


def _port_run(flat, **kw):
    eng = ServeEngine(
        GPTConfig(**SHAPE), params_from_numpy(flat, device=CPU),
        cache_dtype=torch.float32, device=CPU, **{**ENGINE, **kw},
    )
    uids = [eng.submit(p, m) for p, m in _trace()]
    done = eng.run()
    return eng, [done[u].tokens for u in uids]


@pytest.mark.parametrize(
    "kw", [dict(), dict(attn_impl="kernel"), dict(split_k=2), dict(attn_impl="kernel", split_k=2)],
    ids=["gather", "template", "gather-split2", "template-split2"],
)
def test_port_engine_matches_jax_engine(reference, kw):
    flat, want, want_preempt = reference
    assert want_preempt >= 1, "the trace must force a preemption"
    eng, got = _port_run(flat, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.preemptions == want_preempt
    assert eng.allocator.free_count == eng.allocator.num_pages - 1  # page conservation
    st = eng.stats()
    assert st["decode_tokens"] > 0 and st["rounds"] > 0
    if "split_k" in kw:
        assert set(st["split_rounds"]) == {2}


def test_page_allocator():
    a = PageAllocator(8)  # pages 1..7 allocatable, 0 is the sink
    assert a.free_count == 7
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert a.alloc(5) is None and a.free_count == 4  # failed alloc is a no-op
    a.free(got)
    assert a.free_count == 7
    with pytest.raises(ValueError):
        a.free([0])  # the sink must never enter the free list


def test_cancel_and_timeout_free_pages(reference):
    flat = reference[0]
    now = [0.0]
    eng = ServeEngine(
        GPTConfig(**SHAPE), params_from_numpy(flat, device=CPU), cache_dtype=torch.float32,
        device=CPU, clock=lambda: now[0], **ENGINE,
    )
    trace = _trace()
    a = eng.submit(*trace[0])
    b = eng.submit(*trace[1], ttl_s=5.0)
    c = eng.submit(*trace[2])
    eng.step()
    assert eng.cancel(a)
    now[0] = 10.0  # b's deadline passes
    done = eng.run()
    assert done[a].status == "cancelled" and done[b].status == "timeout"
    assert done[c].status == "ok" and len(done[c].tokens) == len(trace[2][0]) + trace[2][1]
    assert eng.allocator.free_count == eng.allocator.num_pages - 1


def test_engine_validation():
    cfg = GPTConfig(**SHAPE)
    params = {}
    # a tp mesh serves with overlap "off": the captured modes wait for NCCL between cards
    tp2 = types.SimpleNamespace(tp=2, data=1, member=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        ServeEngine(cfg, params, device=CPU, mesh=tp2, overlap="group")
    with pytest.raises(ValueError, match="not both"):
        ServeEngine(cfg, params, device=CPU, pool_hbm_bytes=1 << 20, num_pages=10)
    with pytest.raises(ValueError, match="unknown cache dtype"):
        ServeEngine(cfg, params, device=CPU, cache_dtype="int4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(cfg, params)  # no device given: CUDA or nothing
