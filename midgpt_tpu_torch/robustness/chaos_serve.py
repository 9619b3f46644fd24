"""Serving chaos scenarios: inject a serving fault kind into a seeded trace
and assert the engine DEGRADES instead of breaking (the port's counterpart
of midgpt_tpu/robustness/chaos_serve.py, in-process scenarios).

`run_serving_chaos` runs the same seeded request trace twice, once
fault-free for reference and once with a fault plan armed, and checks
three invariants:

  1. **Alive**: the engine (and, for client faults, the async front door)
     finishes the trace.
  2. **Conserved**: every pool page is free or held by the trie at zero
     references afterwards, whatever was shed, killed or poisoned.
  3. **Isolated**: the greedy streams of UNAFFECTED requests equal the
     fault-free run's. "Affected" is engine-reported: `poisoned_uids` for
     poisoned_page, non-"ok" statuses for sheds, timeouts and cancels.
     kill_mid_decode and kill_overlapped_round (the engine under
     overlap="double", the reference plain) affect nobody: recovery is
     recompute preemption.

Model ops ride the same harness: `hot_swap_mid_decode@k` stages weights
saved and restored through the port's verified checkpoints
(training/checkpoint.py) and checks each stream against the side of the
flip that served it; `pool_resize@j,pool_resize@k` grows then shrinks an
int8 pool mid-trace, every stream equal to a no-resize pass.

The fleet scenarios run the trace through TWO replicas behind a
FleetRouter with its shared spill tier (sampling/fleet.py):
`engine_crash@k` kills the busiest replica at router round k with zero
accepted streams dropped; `handoff_stall` / `spill_corrupt` hit the spill
path (a staged flush fills the tier first) and cost a re-prefill, never a
token; `assert_fleet_conserved` holds after the drain.

The worker-process scenarios (`proc_kill9`, `conn_drop`, `wire_corrupt`,
`wire_stall`) run the same trace through two worker PROCESSES
(sampling/fleet_proc.py, spawned on the scenario's device) behind a
FleetRouter: zero drops (`proc_kill9` SIGKILLs the busiest worker and the
failover is detected through the wire alone), conservation checked inside
the workers, every stream equal to a fault-free pass served by a third
worker, the wire kinds absorbed with their transport counter showing the
fault bit, and the router process launching no kernel and capturing no
graph (`router_launches_delta`).

Faults are deterministic for a seeded trace: round-keyed kinds fire on the
engine's (or router's) round counter, slow_client on the victim uid,
submit_storm on the arrival index. Every fault pass runs under a flight
recorder (obs/) and leaves `flight_recorder.json` + `.prom`: in
`trace_dir` when given, and in a fresh temporary directory, named in the
failing AssertionError, when an invariant breaks without one.

The scenarios run on CUDA unless `device="cpu"` is given; the tiny model's
weights are the port's init at the seed. The entry point prints one JSON
line with `tools/chaos_run.py --serve`'s fields plus `device`:

    python -m midgpt_tpu_torch.robustness.chaos_serve --fault engine_crash@6 [--fault ...] \\
        [--seed 0] [--n-requests 5] [--rundir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import sys
import tempfile
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.device import DeviceLike, device_label, resolve_device
from midgpt_tpu_torch.obs import Observability
from midgpt_tpu_torch.robustness import faults

# Storm burst: how many clone requests submit_storm slams in at its arrival
# index (several times the backlog budget below).
STORM_SIZE = 8
# Backlog budget armed for storm scenarios: small enough that the burst
# MUST shed, big enough that the base trace admits.
STORM_BACKLOG_PAGES = 24
# Grow-then-shrink targets of the pool_resize scenario, in plan order from
# the 29-page base geometry below (JAX's values).
RESIZE_TARGETS = [43, 37]

# The worker-process kinds (module docstring).
PROC_KINDS = ("proc_kill9", "conn_drop", "wire_corrupt", "wire_stall")
FLEET_KINDS = ("engine_crash", "handoff_stall", "spill_corrupt")


def _tiny_cfg():
    from midgpt_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(block_size=64, vocab_size=96, n_layer=2, n_head=2, n_embd=32)


def _tiny_model(seed: int, device: torch.device):
    """(config, f32 params) of the scenarios' tiny model: the port's init
    at `seed` on `device`."""
    from midgpt_tpu_torch.models.gpt import GPT

    cfg = _tiny_cfg()
    return cfg, GPT.init(cfg, seed, device=device, dtype=torch.float32)


def _trace(cfg, seed: int, n_requests: int, shared: bool = False):
    rng = np.random.default_rng(seed)
    out = []
    # `shared`: template-heavy traffic (two 16-token system prompts with
    # short unique tails), drawn only in shared mode: the plain scenarios'
    # traces must stay the RNG stream their step-keyed plans were tuned on.
    templates = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32) for _ in range(2)] if shared else []
    for i in range(n_requests):
        if shared:
            tail = rng.integers(0, cfg.vocab_size, int(rng.integers(2, 6))).astype(np.int32)
            prompt = np.concatenate([templates[i % 2], tail])
            m = int(rng.integers(6, 16))
        else:
            # draw order (t0, m, prompt) is load-bearing: the plain
            # scenarios' step-keyed fault plans were tuned against it
            t0 = int(rng.integers(4, 24))
            m = int(rng.integers(6, 16))
            prompt = rng.integers(0, cfg.vocab_size, t0).astype(np.int32)
        out.append((prompt, m))
    return out


def _engine(cfg, params, device, *, max_backlog_pages=None, clock=None, prefix=False, obs=None,
            cache_dtype=torch.float32, overlap="off", num_pages=29, obs_tid="engine"):
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    kw: tp.Dict[str, tp.Any] = {}
    if clock is not None:
        kw["clock"] = clock
    return ServeEngine(
        cfg, params, max_slots=3, page_size=8, num_pages=num_pages, prefill_chunk=16, decode_chunk=4,
        temperature=0.0, cache_dtype=cache_dtype, max_backlog_pages=max_backlog_pages, prefix_cache=prefix,
        overlap=overlap, obs=obs, obs_tid=obs_tid, device=device, **kw,
    )


def _run_plain(eng, trace, storm: bool):
    """Drive the engine synchronously. Returns (uid -> trace index,
    n_storm_shed). With `storm`, each arrival consults submit_storm (step =
    arrival index) and, when it fires, STORM_SIZE clones of that request go
    in at once: the admitted ones compete for the pool, the rest shed."""
    from midgpt_tpu_torch.sampling.serve import BackpressureError

    uid_to_idx: tp.Dict[int, int] = {}
    storm_shed = 0
    for idx, (prompt, m) in enumerate(trace):
        if storm and faults.should_fire("submit_storm", step=idx):
            for _ in range(STORM_SIZE):
                try:
                    eng.submit(prompt, m)  # clones: outside the parity check
                except BackpressureError:
                    storm_shed += 1
        try:
            uid_to_idx[eng.submit(prompt, m)] = idx
        except BackpressureError:
            storm_shed += 1
    eng.run()
    return uid_to_idx, storm_shed


def _run_trickle(eng, trace, arrival_stride: int = 2):
    """Drive the engine with one submission every `arrival_stride` rounds,
    so a mid-trace model op has traffic on both sides of its boundary."""
    uid_to_idx: tp.Dict[int, int] = {}
    pending = list(enumerate(trace))
    r = 0
    while pending or not eng.idle:
        if pending and r % arrival_stride == 0:
            idx, (prompt, m) = pending.pop(0)
            uid_to_idx[eng.submit(prompt, m)] = idx
        eng.step()
        r += 1
        assert r < 10_000, "trickle drive did not converge"
    return uid_to_idx


def _run_server(eng, trace):
    """Drive the engine through the async front door, one consumer task per
    request, collecting the tokens each client was delivered."""
    from midgpt_tpu_torch.sampling.server import AsyncServeServer

    delivered: tp.Dict[int, tp.List[int]] = {}
    uid_to_idx: tp.Dict[int, int] = {}

    async def main():
        server = AsyncServeServer(eng, max_buffered_tokens=4, submit_retries=1, idle_poll_s=0.001)
        stepper = asyncio.create_task(server.run())

        async def consume(uid):
            delivered[uid] = []
            async for tok in server.stream(uid):
                delivered[uid].append(tok)

        consumers = []
        for idx, (prompt, m) in enumerate(trace):
            uid = await server.submit(prompt, m)
            uid_to_idx[uid] = idx
            consumers.append(asyncio.create_task(consume(uid)))
        await asyncio.gather(*consumers)
        await server.drain()
        await stepper

    asyncio.run(main())
    return uid_to_idx, delivered


# -- shared scaffolding (one constructor, one postmortem policy) ------------------


def _reference_pass(cfg, params, trace, device, *, prefix=False, cache_dtype=torch.float32):
    """Fault-free pass -> {trace index: reference tokens}. Clears the
    registry first: an armed plan must never leak into a reference."""
    faults.clear()
    ref = _engine(cfg, params, device, prefix=prefix, cache_dtype=cache_dtype)
    ref_uids, _ = _run_plain(ref, trace, storm=False)
    return {idx: np.asarray(ref.finished[uid].tokens) for uid, idx in ref_uids.items()}


def _armed_engine(cfg, params, device, fault_plan, **engine_kw):
    """Arm `fault_plan` and build the engine under fault with its flight
    recorder. Returns (eng, obs, armed)."""
    faults.clear()
    armed = faults.activate_plan(fault_plan)
    obs = Observability()
    return _engine(cfg, params, device, obs=obs, **engine_kw), obs, armed


def _run_scenario(obs, trace_dir, body):
    """Run `body()` (the fault pass and its checks) under the postmortem
    policy: the flight recorder lands in `trace_dir` when given, and on any
    failure also without one (a fresh temporary directory, its path added
    to the exception). Returns body's summary with "trace" set."""
    try:
        summary = body()
    except BaseException as e:
        d = trace_dir or tempfile.mkdtemp(prefix="midgpt_chaos_postmortem_")
        path = obs.dump(d)
        e.args = (tuple([f"{e.args[0]}\n[flight recorder: {path}]"] + list(e.args[1:])) if e.args
                  else (f"[flight recorder: {path}]",))
        raise
    summary["trace"] = None if trace_dir is None else obs.dump(trace_dir)
    return summary


def _assert_drained_conserved(eng) -> int:
    """Invariant 2: the engine drained, every page free or held by the trie
    with zero live references. Returns the trie's page count."""
    assert eng.idle, "engine left work behind"
    trie_pages = 0 if eng.prefix_cache is None else eng.prefix_cache.page_count()
    assert eng.allocator.free_count + trie_pages == eng.allocator.num_pages - 1, (
        f"page leak: {eng.allocator.free_count} free + {trie_pages} trie of {eng.allocator.num_pages - 1} allocatable"
    )
    if eng.prefix_cache is not None:
        dangling = eng.prefix_cache.referenced_page_count()
        assert dangling == 0, f"{dangling} trie refcount(s) outlived the drain"
    return trie_pages


def run_serving_chaos(fault_plan: str, *, seed: int = 0, n_requests: int = 5, trace_dir: tp.Optional[str] = None,
                      device: DeviceLike = None) -> tp.Dict[str, tp.Any]:
    """Run the scenario (module docstring); returns the summary dict the
    entry point prints. Raises AssertionError when an invariant breaks:
    that IS the chaos verdict."""
    dev = resolve_device(device)
    kw = dict(seed=seed, n_requests=n_requests, trace_dir=trace_dir, device=dev)
    if any(k in fault_plan for k in PROC_KINDS):
        return _run_proc_fleet_chaos(fault_plan, **kw)
    if any(k in fault_plan for k in FLEET_KINDS):
        return _run_fleet_chaos(fault_plan, **kw)
    if "hot_swap_mid_decode" in fault_plan:
        return _run_hot_swap_chaos(fault_plan, **kw)
    if "pool_resize" in fault_plan:
        return _run_pool_resize_chaos(fault_plan, **kw)
    cfg, params = _tiny_model(seed, dev)
    uses_server = "slow_client" in fault_plan
    uses_storm = "submit_storm" in fault_plan
    # the trie flush needs a trie: both passes run cache-on over template
    # traffic, so the reference also proves the cache parity-clean
    uses_prefix = "evict_shared_prefix" in fault_plan
    # the overlap kill needs an in-flight round: only the fault pass runs
    # double-buffered, so invariant 3 doubles as an overlap parity check
    uses_overlap = "kill_overlapped_round" in fault_plan
    trace = _trace(cfg, seed + 1, n_requests, shared=uses_prefix)

    ref_tokens = _reference_pass(cfg, params, trace, dev, prefix=uses_prefix)
    eng, obs, armed = _armed_engine(
        cfg, params, dev, fault_plan,
        max_backlog_pages=STORM_BACKLOG_PAGES if uses_storm else None,
        prefix=uses_prefix,
        overlap="double" if uses_overlap else "off",
    )

    def body() -> tp.Dict[str, tp.Any]:
        delivered: tp.Optional[tp.Dict[int, tp.List[int]]] = None
        storm_shed = 0
        if uses_server:
            uid_to_idx, delivered = _run_server(eng, trace)
        else:
            uid_to_idx, storm_shed = _run_plain(eng, trace, storm=uses_storm)
        fired = faults.fired_counts()
        faults.clear()

        _assert_drained_conserved(eng)

        # -- invariant 3: unaffected greedy streams are the reference's ----
        affected = set(eng.poisoned_uids)
        statuses: tp.Dict[str, int] = {}
        parity_checked = parity_ok = 0
        for uid, idx in uid_to_idx.items():
            fr = eng.finished.get(uid)
            assert fr is not None, f"request {uid} vanished"
            statuses[fr.status] = statuses.get(fr.status, 0) + 1
            if fr.status != "ok":
                affected.add(uid)  # shed/timeout/slow_client: partial by design
            if uid in affected:
                continue
            parity_checked += 1
            if np.array_equal(np.asarray(fr.tokens), ref_tokens[idx]):
                parity_ok += 1
            if delivered is not None:
                # what the client consumed is a prefix of the reference
                # generation: streaming may trail the engine, never diverge
                prompt_len = len(trace[idx][0])
                got = np.asarray(delivered[uid], np.int32)
                want = ref_tokens[idx][prompt_len:prompt_len + len(got)]
                assert np.array_equal(got, want), f"delivered stream diverged for request {uid}"
        assert parity_ok == parity_checked, f"greedy parity broke on {parity_checked - parity_ok} unaffected request(s)"
        assert sum(fired.values()) >= min(1, len(armed)), "no armed fault fired"
        if fired.get("kill_overlapped_round"):
            assert eng.overlap_kills >= 1, "overlap kill fired but no in-flight round was ever dropped"

        return {
            "mode": "serve",
            "fault_plan": fault_plan,
            "faults_fired": fired,
            "n_requests": n_requests,
            "statuses": statuses,
            "overlap_mode": eng.overlap,
            "overlap_kills": eng.overlap_kills,
            "shed": eng.shed + storm_shed,
            "timeouts": eng.timeouts,
            "cancelled": eng.cancelled,
            "decode_kills": eng.decode_kills,
            "preemptions": eng.preemptions,
            "poisoned": len(eng.poisoned_uids),
            "parity_checked": parity_checked,
            "parity_ok": parity_ok,
            "pages_conserved": True,
            "prefix_cache": eng.prefix_cache is not None,
            "prefix_reclaimed": eng.prefix_evictions,
            "prefix_hit_rate": eng.prefix_stats()["hit_rate"],
        }

    return _run_scenario(obs, trace_dir, body)


# -- fleet scenarios (sampling/fleet.py) ----------------------------------------


def _fleet_router(cfg, params, device, obs, n_replicas: int = 2):
    """`n_replicas` prefix-cached greedy engines of 31 pages (JAX's fleet
    geometry) behind a FleetRouter with its shared spill tier."""
    from midgpt_tpu_torch.sampling.fleet import FleetRouter

    return FleetRouter([
        _engine(cfg, params, device, prefix=True, obs=obs, num_pages=31, obs_tid=f"replica{i}")
        for i in range(n_replicas)
    ])


def drive_fleet(router, trace, *, stage_spill: bool = False, flush=None, watch=None) -> tp.Dict[int, int]:
    """Drive a FleetRouter through `trace` with one arrival per router
    round (a mid-trace crash finds streams in flight) until it is idle;
    `watch(router)` after every round. With `stage_spill` the first request
    runs alone first, then every alive replica's trie is flushed
    (`flush(engine)`, by default `engine.flush_prefix_cache()`), spilling
    its pages into the shared tier, so each later same-template admission
    consults the tier. Returns uid -> trace index."""
    uid_to_idx: tp.Dict[int, int] = {}
    pending = list(enumerate(trace))
    if stage_spill and pending:
        idx, (prompt, m) = pending.pop(0)
        uid_to_idx[router.submit(prompt, m)] = idx
        router.run()
        for i, rep in enumerate(router.engines):
            if router.alive[i] and flush is None:
                rep.flush_prefix_cache()
            elif router.alive[i]:
                flush(rep)
    r = 0
    while pending or not router.idle:
        if pending:
            idx, (prompt, m) = pending.pop(0)
            uid_to_idx[router.submit_retry(prompt, m)] = idx
        router.step()
        if watch is not None:
            watch(router)
        r += 1
        assert r < 10_000, "fleet drive did not converge"
    return uid_to_idx


def _run_fleet_chaos(fault_plan, *, seed, n_requests, trace_dir, device):
    """The fleet gate: the shared-template trace through a 2-replica fleet
    with `fault_plan` armed, the three invariants extended across replicas
    and tiers (zero accepted streams dropped; every alive replica's pool
    law and the spill ledger; EVERY stream, failover replays included,
    equal to a fault-free single-engine pass).

    The spill kinds need resident spilled pages, so the scenario STAGES the
    tier: the first request runs alone, then every replica's trie is
    flushed (spilling its pages); the remaining same-template requests then
    consult the tier on admission, where the armed stall refuses the first
    useful run and the armed corruption is caught by the take-side crc."""
    from midgpt_tpu_torch.sampling.fleet import assert_fleet_conserved

    cfg, params = _tiny_model(seed, device)
    trace = _trace(cfg, seed + 1, n_requests, shared=True)
    ref_tokens = _reference_pass(cfg, params, trace, device, prefix=True)

    faults.clear()
    armed = faults.activate_plan(fault_plan)
    obs = Observability()
    router = _fleet_router(cfg, params, device, obs)
    stage_spill = any(k in fault_plan for k in ("handoff_stall", "spill_corrupt"))

    def body() -> tp.Dict[str, tp.Any]:
        uid_to_idx = drive_fleet(router, trace, stage_spill=stage_spill)
        fired = faults.fired_counts()
        faults.clear()

        assert_fleet_conserved(router, "after drain")
        for i, rep in enumerate(router.engines):
            if router.alive[i]:
                _assert_drained_conserved(rep)

        statuses: tp.Dict[str, int] = {}
        parity_checked = parity_ok = 0
        for uid, idx in uid_to_idx.items():
            fr = router.finished.get(uid)
            assert fr is not None, f"accepted stream {uid} vanished"
            statuses[fr.status] = statuses.get(fr.status, 0) + 1
            assert fr.status == "ok", f"accepted stream {uid} dropped with status {fr.status!r}"
            parity_checked += 1
            if np.array_equal(np.asarray(fr.tokens), ref_tokens[idx]):
                parity_ok += 1
        assert parity_ok == parity_checked, (
            f"greedy parity broke on {parity_checked - parity_ok} stream(s) vs the fault-free single-engine pass"
        )
        assert sum(fired.values()) >= min(1, len(armed)), "no armed fault fired"
        if fired.get("engine_crash"):
            assert router.failovers >= 1, "crash fired but nobody died"
            assert router.failed_over_streams >= 1, (
                "crash fired with no accepted streams to fail over — the gate proved nothing"
            )
        if fired.get("handoff_stall"):
            assert router.spill.stall_fallbacks >= 1, "stall armed but no consult ever fell back to re-prefill"
        if fired.get("spill_corrupt"):
            assert router.spill.corrupt_discarded >= 1, "corruption armed but never caught by the take-side checksum"

        return {
            "mode": "serve",
            "fault_plan": fault_plan,
            "faults_fired": fired,
            "n_requests": n_requests,
            "statuses": statuses,
            "shed": sum(e.shed for e in router.engines),
            "timeouts": sum(e.timeouts for e in router.engines),
            "cancelled": sum(e.cancelled for e in router.engines),
            "decode_kills": sum(e.decode_kills for e in router.engines),
            "preemptions": sum(e.preemptions for e in router.engines),
            "poisoned": 0,
            "parity_checked": parity_checked,
            "parity_ok": parity_ok,
            "pages_conserved": True,
            "prefix_cache": True,
            "prefix_reclaimed": sum(e.prefix_evictions for e in router.engines),
            "prefix_hit_rate": router.prefix_hit_rate(),
            "fleet_size": len(router.engines),
            "alive": sum(router.alive),
            "failovers": router.failovers,
            "failed_over_streams": router.failed_over_streams,
            "dropped_streams": 0,
            "spill": router.spill.stats(),
        }

    return _run_scenario(obs, trace_dir, body)


# -- worker-process fleet scenarios (sampling/fleet_proc.py) ----------------------


def proc_worker_spec(seed: int, *, device: DeviceLike = None) -> tp.Dict[str, tp.Any]:
    """The worker spec of the fleet scenarios: the tiny model at `seed` (the
    port's init, so every worker on one device holds the same weights), the
    31-page fleet pool, f32, this process's numeric knobs, on `device`; a
    CPU worker runs one torch thread."""
    import dataclasses

    from midgpt_tpu_torch.sampling.fleet_proc import parent_torch_config

    dev = resolve_device(device)
    spec = {
        "model": dataclasses.asdict(_tiny_cfg()),
        "seed": seed,
        "engine": {"max_slots": 3, "page_size": 8, "num_pages": 31, "prefill_chunk": 16, "decode_chunk": 4,
                   "cache_dtype": "float32"},
        "device": dev.type,
        "torch_config": parent_torch_config(),
    }
    if dev.type == "cpu":
        spec["threads"] = 1
    return spec


def _proc_reference_pass(port: int, trace) -> tp.Dict[int, np.ndarray]:
    """A fault-free pass over the wire on an already spawned worker of the
    fleet's spec -> {trace index: tokens}. Worker against worker keeps the
    parity claim about the process boundary alone. All requests go in at
    once: greedy streams do not depend on the batch's composition."""
    from midgpt_tpu_torch.sampling.fleet_proc import connect_replica

    faults.clear()
    rep = connect_replica(port)
    uid_to_idx = {rep.submit(prompt, m): idx for idx, (prompt, m) in enumerate(trace)}
    rep.run()
    ref = {idx: np.asarray(rep.finished[uid].tokens) for uid, idx in uid_to_idx.items()}
    rep.close()
    return ref


def _run_proc_fleet_chaos(fault_plan, *, seed, n_requests, trace_dir, device):
    """The fleet gate across a process boundary: two worker PROCESSES
    behind a FleetRouter speaking the framed socket transport.

      1. Alive: `proc_kill9` SIGKILLs the busiest worker mid-decode and the
         fleet still finishes every accepted stream, zero drops; detection
         flows through the wire (ReplicaGoneError, then the consecutive-
         failure health check and the engine_crash failover).
      2. Conserved across the boundary: each alive worker runs the pool law
         and its tier's ledger in its own process (the `conserve` RPC), and
         the router's tier ledger closes.
      3. Bit-identical: every stream, failover replays included, equals a
         fault-free pass served by its own worker (`_proc_reference_pass`).

    The wire kinds are absorbed by the transport: the same invariants, and
    the kind's counter shows it bit (reconnects, corrupt_frames,
    deadline_expiries). The router process launches no kernel and captures
    no graph: its launch counters and captures are the same after the drive
    as before."""
    from midgpt_tpu_torch.sampling.fleet import FleetRouter, assert_fleet_conserved
    from midgpt_tpu_torch.sampling.fleet_proc import connect_replica, kill_workers, process_launch_counts, \
        spawn_workers

    cfg = _tiny_cfg()
    trace = _trace(cfg, seed + 1, n_requests, shared=True)
    launches_before = process_launch_counts()
    procs = []
    try:
        # all three workers (the reference and two replicas) spawn together
        procs = spawn_workers(proc_worker_spec(seed, device=device), 3)
        ref_tokens = _proc_reference_pass(procs[0][1], trace)
        kill_workers(procs[:1])

        faults.clear()
        armed = faults.activate_plan(fault_plan)
        obs = Observability()
        replicas = [connect_replica(port, retry_base_s=0.05, obs=obs) for _, port in procs[1:]]
        router = FleetRouter(replicas)

        def body() -> tp.Dict[str, tp.Any]:
            # one arrival a router round: the round-keyed kill lands mid-decode
            uid_to_idx = drive_fleet(router, trace)
            fired = faults.fired_counts()
            faults.clear()

            assert_fleet_conserved(router, "after proc drain")

            statuses: tp.Dict[str, int] = {}
            parity_checked = parity_ok = 0
            for uid, idx in uid_to_idx.items():
                fr = router.finished.get(uid)
                assert fr is not None, f"accepted stream {uid} vanished"
                statuses[fr.status] = statuses.get(fr.status, 0) + 1
                assert fr.status == "ok", f"accepted stream {uid} dropped with status {fr.status!r}"
                parity_checked += 1
                if np.array_equal(np.asarray(fr.tokens), ref_tokens[idx]):
                    parity_ok += 1
            assert parity_ok == parity_checked, (
                f"greedy parity broke on {parity_checked - parity_ok} stream(s) vs the fault-free worker's pass"
            )
            assert sum(fired.values()) >= min(1, len(armed)), "no armed fault fired"
            transport = router.transport_stats()
            if fired.get("proc_kill9"):
                assert router.proc_failovers >= 1, "kill -9 fired but the wire never reported the death"
                assert router.failed_over_streams >= 1, (
                    "kill -9 fired with no accepted streams to fail over — the gate proved nothing"
                )
            if fired.get("conn_drop"):
                assert transport["reconnects"] >= 1, "connection dropped but no RPC ever reconnected"
            if fired.get("wire_corrupt"):
                assert transport["corrupt_frames"] >= 1, "frame corruption armed but the checksum never rejected one"
            if fired.get("wire_stall"):
                assert transport["deadline_expiries"] >= 1, "stall armed but no RPC deadline ever expired"

            launches_after = process_launch_counts()
            assert launches_after == launches_before, (
                f"the router process launched kernels or captured graphs: {launches_before} -> {launches_after}"
            )

            return {
                "mode": "serve",
                "fault_plan": fault_plan,
                "faults_fired": fired,
                "n_requests": n_requests,
                "statuses": statuses,
                "shed": router.router_shed,
                "timeouts": sum(e.timeouts for e in router.engines),
                "cancelled": sum(e.cancelled for e in router.engines),
                "decode_kills": sum(e.decode_kills for e in router.engines),
                "preemptions": sum(e.preemptions for e in router.engines),
                "poisoned": 0,
                "parity_checked": parity_checked,
                "parity_ok": parity_ok,
                "pages_conserved": True,
                "prefix_cache": True,
                "prefix_reclaimed": sum(e.prefix_evictions for e in router.engines),
                "prefix_hit_rate": router.prefix_hit_rate(),
                "fleet_size": len(router.engines),
                "alive": sum(router.alive),
                "failovers": router.failovers,
                "failed_over_streams": router.failed_over_streams,
                "dropped_streams": 0,
                "spill": router.spill.stats(),
                "procs": True,
                "proc_failovers": router.proc_failovers,
                "worker_pids": [rep.pid for rep in replicas],
                "transport": transport,
                "router_launches_delta": 0,
            }

        return _run_scenario(obs, trace_dir, body)
    finally:
        faults.clear()
        kill_workers(procs)


# -- model-ops scenarios (sampling/ops.py) ----------------------------------------


def _verified_swap_weights(cfg, seed: int, root_dir: str, device):
    """Fresh weights through the verified-checkpoint path: init at another
    seed, save with the manifest-stamping CheckpointManager, restore as a
    sampler restores. Returns (params, step, "<step>:<sha12>" version)."""
    import os
    import types

    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.sampling.engine import restore_for_sampling
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager

    ckpt_dir = os.path.join(root_dir, "swap_ckpt")
    mgr = CheckpointManager(ckpt_dir, save_interval_steps=1)
    mgr.save(7, {"params": GPT.init(cfg, seed + 101, device=device, dtype=torch.float32)}, force=True)
    mgr.wait()
    version = mgr.weights_version(7)
    mgr.close()
    assert version is not None, "manifest missing after save barrier"
    shim = types.SimpleNamespace(model_config=cfg, param_dtype="float32")
    restored, step = restore_for_sampling(ckpt_dir, shim, device=device)
    return restored, step, version


def _run_hot_swap_chaos(fault_plan, *, seed, n_requests, trace_dir, device):
    """Blue/green flip mid-trace: fault-free passes on the OLD and the NEW
    (restored) weights, then the fault pass, each stream checked against the
    side of the flip that served it (`served_uids_at_flip`)."""
    cfg, params_old = _tiny_model(seed, device)
    root = trace_dir or tempfile.mkdtemp(prefix="midgpt_chaos_swap_")
    params_new, step, version = _verified_swap_weights(cfg, seed, root, device)
    trace = _trace(cfg, seed + 1, n_requests)

    ref_old = _reference_pass(cfg, params_old, trace, device)
    ref_new = _reference_pass(cfg, params_new, trace, device)
    # the flip writes into the engine's parameter tensors: give it its own
    eng, obs, armed = _armed_engine(cfg, {k: v.clone() for k, v in params_old.items()}, device, fault_plan)
    eng.swap_source = lambda: {"params": params_new, "version": version, "config": cfg}

    def body() -> tp.Dict[str, tp.Any]:
        uid_to_idx = _run_trickle(eng, trace)
        fired = faults.fired_counts()
        faults.clear()
        assert sum(fired.values()) >= min(1, len(armed)), "no armed fault fired"
        assert eng.hot_swaps == 1, f"swap never flipped ({eng.hot_swaps=})"
        assert eng.weights_version == version, f"weights_version {eng.weights_version!r} != {version!r}"
        _assert_drained_conserved(eng)

        swap = eng.swap_history[0]
        old_uids = set(swap["served_uids_at_flip"])
        statuses: tp.Dict[str, int] = {}
        parity = {"old": 0, "new": 0}
        for uid, idx in uid_to_idx.items():
            fr = eng.finished.get(uid)
            assert fr is not None, f"request {uid} dropped across the flip"
            statuses[fr.status] = statuses.get(fr.status, 0) + 1
            assert fr.status == "ok", f"request {uid} degraded to {fr.status!r} — a hot swap must drop zero streams"
            side = "old" if uid in old_uids else "new"
            want = (ref_old if side == "old" else ref_new)[idx]
            assert np.array_equal(np.asarray(fr.tokens), want), (
                f"greedy parity broke for request {uid} ({side}-weights side of the flip)"
            )
            parity[side] += 1
        assert parity["old"] and parity["new"], f"flip landed outside the trace ({parity}) — tune the fault round"
        return {
            "mode": "serve",
            "fault_plan": fault_plan,
            "faults_fired": fired,
            "n_requests": n_requests,
            "statuses": statuses,
            "weights_version": eng.weights_version,
            "checkpoint_step": step,
            "swap": {
                "staged_round": swap["staged_round"],
                "flip_round": swap["flip_round"],
                "in_flight_at_stage": len(swap["in_flight_at_stage"]),
                "swap_latency_s": swap["swap_latency_s"],
            },
            "parity_old_side": parity["old"],
            "parity_new_side": parity["new"],
            "dropped": 0,
            "pages_conserved": True,
        }

    return _run_scenario(obs, trace_dir, body)


def _run_pool_resize_chaos(fault_plan, *, seed, n_requests, trace_dir, device):
    """Grow-then-shrink mid-trace on an int8 pool (its scales migrate with
    their pages): conservation at every boundary and EVERY stream equal to
    the no-resize reference."""
    cfg, params = _tiny_model(seed, device)
    trace = _trace(cfg, seed + 1, n_requests)

    ref_tokens = _reference_pass(cfg, params, trace, device, cache_dtype=torch.int8)
    eng, obs, armed = _armed_engine(cfg, params, device, fault_plan, cache_dtype=torch.int8)
    eng.resize_plan = list(RESIZE_TARGETS)

    def body() -> tp.Dict[str, tp.Any]:
        # trickled arrivals: the trace must still be live at both fault rounds
        uid_to_idx = _run_trickle(eng, trace)
        fired = faults.fired_counts()
        faults.clear()
        n_fired = sum(fired.values())
        assert n_fired >= min(1, len(armed)), "no armed fault fired"
        assert eng.resizes == n_fired, f"{n_fired} pool_resize firings but {eng.resizes} resizes"
        _assert_drained_conserved(eng)
        assert eng.cache.quantized and eng.cache.k_scale is not None

        statuses: tp.Dict[str, int] = {}
        parity_ok = 0
        for uid, idx in uid_to_idx.items():
            fr = eng.finished.get(uid)
            assert fr is not None, f"request {uid} dropped across a resize"
            statuses[fr.status] = statuses.get(fr.status, 0) + 1
            assert np.array_equal(np.asarray(fr.tokens), ref_tokens[idx]), (
                f"greedy parity broke for request {uid} across a live resize"
            )
            parity_ok += 1
        return {
            "mode": "serve",
            "fault_plan": fault_plan,
            "faults_fired": fired,
            "n_requests": n_requests,
            "statuses": statuses,
            "cache_dtype": "int8",
            "resizes": eng.resize_history,
            "pages_migrated": sum(r["pages_migrated"] for r in eng.resize_history),
            "final_num_pages": eng.allocator.num_pages,
            "parity_checked": parity_ok,
            "parity_ok": parity_ok,
            "pages_conserved": True,
        }

    return _run_scenario(obs, trace_dir, body)


# -- entry point --------------------------------------------------------------------


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    """One scenario, one JSON line on stdout (everything else the scenario
    prints goes to stderr). A broken invariant (AssertionError) is reported
    as data with exit code 1."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fault", action="append", default=[], metavar="KIND[@STEP][*TIMES]",
                    help="fault to inject (repeatable) — robustness/faults.py")
    ap.add_argument("--seed", type=int, default=0, help="trace/model seed")
    ap.add_argument("--n-requests", type=int, default=5, help="requests in the seeded trace")
    ap.add_argument("--rundir", type=str, default=None, help="directory for the flight recorder")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not args.fault:
        ap.error("at least one --fault is required")
    for spec in args.fault:
        m = faults._PLAN_RE.match(spec.strip())
        kind = m.group("kind") if m else spec
        if m is None or kind not in faults.KINDS:
            ap.error(f"unknown fault spec {spec!r} (want KIND[@STEP][*TIMES]); kinds: {', '.join(faults.KINDS)}")
        if kind in faults.UNHOOKED:
            ap.error(f"fault kind {kind!r} is not ported yet ({faults.UNHOOKED[kind]} in ROADMAP.md)")
    dev = resolve_device(args.device)
    t0 = time.time()
    status, error, result = "ok", None, {}
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result = run_serving_chaos(",".join(args.fault), seed=args.seed, n_requests=args.n_requests,
                                       trace_dir=args.rundir, device=dev)
    except AssertionError as e:
        status, error = "failed", str(e)
    summary = {
        "tool": "chaos_run",
        "mode": "serve",
        "status": status,
        "wall_s": round(time.time() - t0, 3),
        "faults_requested": args.fault,
        "device": device_label(dev),
        **result,
    }
    if error is not None:
        summary["error"] = error
    print(json.dumps(summary))
    return 0 if status == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
