"""Port parity, the streaming front door: the port's AsyncServeServer
(sampling/server.py) against JAX's on converted weights, greedy, f32 pools,
one scenario at a time — streaming with a client that walks away
mid-stream, a TTL expiry, the backpressure retry, the `slow_client` shed
and a drain through the preemption flag. Every scenario submits before the
driver starts and keys its clock on the engine's round counter, so the
round each event lands in is the same on both sides. Streams and statuses
must be IDENTICAL. Also the engine's streaming hooks: `on_token` and
`on_finish` fire in JAX's order with JAX's statuses (ok, EOS, timeout,
cancelled), overlap off and "double". Tolerances: none (tokens, statuses
and event lists are compared exactly).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import GPT as JGPT
from midgpt_tpu.models.gpt import GPTConfig as JConfig
from midgpt_tpu.robustness import faults as j_faults
from midgpt_tpu.robustness import preempt as j_preempt
from midgpt_tpu.sampling.serve import ServeEngine as JServeEngine
from midgpt_tpu.sampling.server import AsyncServeServer as JServer
from midgpt_tpu.sampling.server import ServerDraining as JDraining
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPTConfig
from midgpt_tpu_torch.robustness import faults, preempt
from midgpt_tpu_torch.sampling.serve import ServeEngine
from midgpt_tpu_torch.sampling.server import AsyncServeServer, ServerDraining
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

SHAPE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)
ENGINE = dict(max_slots=3, page_size=8, num_pages=16, prefill_chunk=16, decode_chunk=4, temperature=0.0)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sides():
    """Per side: (engine factory, server class, draining error, faults, preempt)."""
    jp = JGPT.init(JConfig(**SHAPE), jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp_ = params_from_numpy(flat, device=CPU)

    def jax_engine(**kw):
        return JServeEngine(JConfig(**SHAPE), jp, cache_dtype=jnp.float32, **{**ENGINE, **kw})

    def port_engine(**kw):
        return ServeEngine(GPTConfig(**SHAPE), tp_, cache_dtype=torch.float32, device=CPU, **{**ENGINE, **kw})

    return {"jax": (jax_engine, JServer, JDraining, j_faults, j_preempt),
            "port": (port_engine, AsyncServeServer, ServerDraining, faults, preempt)}


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SHAPE["vocab_size"], int(rng.integers(4, 24))).astype(np.int32) for _ in range(n)]


def _round_clock(holder):
    """A clock that reads the engine's round counter: deadlines land on the
    same round on both sides whatever the host's speed."""
    return lambda: float(holder[0].rounds) if holder else 0.0


async def _serve(server, submits, consume):
    """Submit everything before the driver runs (the submits apply at round
    0), then consume each stream with `consume(server, i, uid)`."""
    futs = [asyncio.ensure_future(server.submit(p, m, **kw)) for p, m, kw in submits]
    await asyncio.sleep(0)
    driver = asyncio.create_task(server.run())
    uids = await asyncio.gather(*futs)
    out = await asyncio.gather(*(consume(server, i, u) for i, u in enumerate(uids)))
    await server.drain()
    await driver
    return uids, out


async def _consume_all(server, i, uid):
    return [tok async for tok in server.stream(uid)]


def _scenario(name, side):
    """Run one scenario on one side; returns what a client saw, the
    terminal records, and the engine (pages must have come home)."""
    make, Server, Draining, flt, pre = side
    holder = []
    if name == "stream_and_walk_away":
        eng = make()
        submits = [(p, m, {}) for p, m in zip(_prompts(2, seed=2), (12, 20))]

        async def consume(server, i, uid):
            got = []
            async for tok in server.stream(uid):
                got.append(tok)
                if i == 1 and len(got) == 3:
                    break  # the client walks away mid-stream
            return got

        server = Server(eng, idle_poll_s=0.001)
        uids, out = asyncio.run(_serve(server, submits, consume))
        st = server.stats()
        assert st["cancelled"] == 1 and st["free_pages"] == eng.allocator.num_pages - 1
        assert st["weights_version"] == "inline" and st["swap_pending"] is False
        assert st["prefix"]["enabled"] is False and st["prefix"]["prefilled_tokens"] > 0
        statuses = [eng.finished[u].status for u in uids]
        return out, statuses, [eng.finished[uids[0]].tokens.tolist()], eng
    if name == "ttl_timeout":
        eng = make(clock=_round_clock(holder))
        holder.append(eng)
        p1, p2 = _prompts(2, seed=5)
        submits = [(p1, 30, {"ttl_s": 3.0}), (p2, 12, {})]
        uids, out = asyncio.run(_serve(Server(eng, idle_poll_s=0.001), submits, _consume_all))
        return out, [eng.finished[u].status for u in uids], [eng.finished[u].tokens.tolist() for u in uids], eng
    if name == "backpressure_retry":
        eng = make(max_backlog_pages=2)
        p = np.arange(10, dtype=np.int32)

        async def main():
            server = Server(eng, submit_retries=8, retry_backoff_s=0.02, idle_poll_s=0.001)
            driver = asyncio.create_task(server.run())
            u1 = await server.submit(p, 6)  # 2 pages: the whole budget
            c1 = asyncio.create_task(_consume_all(server, 0, u1))
            u2 = await server.submit(p, 6)  # sheds, backs off, then admits
            out = await asyncio.gather(c1, _consume_all(server, 1, u2))
            await server.drain()
            await driver
            return [u1, u2], out

        uids, out = asyncio.run(main())
        assert eng.shed >= 1, "the second submit must have been shed at least once"
        return out, [eng.finished[u].status for u in uids], [], eng
    if name == "slow_client":
        eng = make()
        flt.clear()
        flt.activate("slow_client", step=0)  # the first submit's uid
        try:
            submits = [(p, m, {}) for p, m in zip(_prompts(2, seed=4), (30, 10))]
            uids, out = asyncio.run(_serve(Server(eng, max_buffered_tokens=8, idle_poll_s=0.001), submits,
                                           _consume_all))
        finally:
            flt.clear()
        return out, [eng.finished[u].status for u in uids], [eng.finished[u].tokens.tolist() for u in uids], eng
    assert name == "drain_on_preempt_flag"
    eng = make()
    p1, p2 = _prompts(2, seed=3)
    pre.reset()

    async def main():
        server = Server(eng, idle_poll_s=0.001)
        driver = asyncio.create_task(server.run())
        u1 = await server.submit(p1, 12)
        stream = server.stream(u1)
        first = await stream.__anext__()
        pre.request()  # what the SIGTERM handler does
        toks = [first] + [tok async for tok in stream]
        with pytest.raises(Draining):
            await server.submit(p2, 4)
        await asyncio.wait_for(driver, timeout=30)
        assert server.draining
        return [u1], [toks]

    try:
        uids, out = asyncio.run(main())
    finally:
        pre.reset()
    return out, [eng.finished[u].status for u in uids], [], eng


@pytest.mark.parametrize(
    "name", ["stream_and_walk_away", "ttl_timeout", "backpressure_retry", "slow_client", "drain_on_preempt_flag"]
)
def test_server_matches_jax_server(sides, name):
    got = _scenario(name, sides["port"])
    want = _scenario(name, sides["jax"])
    assert got[:3] == want[:3]
    statuses = {"stream_and_walk_away": ["ok", "cancelled"], "ttl_timeout": ["timeout", "ok"],
                "backpressure_retry": ["ok", "ok"], "slow_client": ["slow_client", "ok"],
                "drain_on_preempt_flag": ["ok"]}[name]
    assert got[1] == statuses
    if name == "slow_client":
        assert got[0][0] == []  # the wedged stream delivered nothing
    eng = got[3]
    assert eng.idle and eng.allocator.free_count == eng.allocator.num_pages - 1


def _hook_events(make, overlap):
    """The hooks' calls on a trace with an EOS stop, a TTL expiry, a
    cancellation and plain finishes, as (kind, uid, token or status)."""
    holder, events = [], []
    eng = make(clock=_round_clock(holder), overlap=overlap, round_group=1,
               on_token=lambda uid, tok, t: events.append(("token", uid, tok)),
               on_finish=lambda fr: events.append(("finish", fr.uid, fr.status, len(fr.tokens))))
    holder.append(eng)
    prompts = _prompts(4, seed=11)
    eos = eng.submit(prompts[0], 20, eos_id=EOS_ID)
    ttl = eng.submit(prompts[1], 30, ttl_s=4.0)
    cancel = eng.submit(prompts[2], 30)
    eng.submit(prompts[3], 9)
    for _ in range(3):
        eng.step()
    assert eng.cancel(cancel)
    eng.run()
    assert [eng.finished[u].status for u in (eos, ttl, cancel)] == ["ok", "timeout", "cancelled"]
    assert len(eng.finished[eos].tokens) < len(prompts[0]) + 20  # it stopped at its EOS
    return events


EOS_ID = 29  # the first request's greedy stream emits it as its 5th token (checked above)


@pytest.mark.parametrize("overlap", ["off", "double"])
def test_hooks_fire_in_jax_order(sides, overlap):
    got = _hook_events(sides["port"][0], overlap)
    assert got == _hook_events(sides["jax"][0], overlap)
    assert sorted(e[2] for e in got if e[0] == "finish") == ["cancelled", "ok", "ok", "timeout"]


@pytest.mark.parametrize("kind", ["slow_client", "evict_shared_prefix", "hot_swap_mid_decode", "pool_resize"])
def test_serving_fault_kind_is_hooked(kind):
    """The four kinds this slice hooks activate, alone and in a plan, and
    their descriptions are JAX's."""
    faults.clear()
    try:
        assert faults.activate(kind, step=3).kind == kind
        assert [f.kind for f in faults.activate_plan(f"{kind}@5*2")] == [kind]
        assert kind in faults.HOOKED and kind not in faults.UNHOOKED
        assert faults.DESCRIPTIONS[kind] == j_faults.DESCRIPTIONS[kind]
    finally:
        faults.clear()
