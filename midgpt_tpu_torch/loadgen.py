"""Arrival-process load harness for the serving front door: one JSON line
(the port's counterpart of tools/loadgen.py's single-engine path).

A seeded arrival process (Poisson or bursty) offers a prompt/output-length
mixture — short chat-like requests, a `--long-frac` tail of long-document
requests, optionally a `--template-frac` share of template-headed
system-prompt traffic — to the asyncio front door (sampling/server.py) at
each offered load, and the line reports what a client feels there:
time to first token (TTFT) and time per output token (TPOT) percentiles,
the shed and timeout fractions, and whether the point met its SLO:

    python -m midgpt_tpu_torch.loadgen --process poisson --rates 20,60 \\
        [--device cpu] [--prefix-cache --template-frac 0.5] [--overlap group:4] \\
        [--scheduler slo] [--ttl-s 2.0] [--slo-ttft-ms 500 --slo-tpot-ms 50] \\
        [--hot-swap] [--fleet N [--procs]] [--trace-out DIR]
    python -m torch.distributed.run --standalone --nproc_per_node 2 -m midgpt_tpu_torch.loadgen \\
        --tp 2 [--device cpu] [--backend gloo] ...

It runs on CUDA unless `--device cpu` is given. The pool is bf16 on CUDA
and f32 on the CPU, as JAX's harness has it (bf16 on the TPU); the random
weights (`--seed`) are made in the pool's dtype. For a seed, the request
stream and the arrival times are JAX's (`_mixture` and `_arrivals` are the
same code); the weights are not (torch draws them).

TTFT is measured from the client's submit attempt (admission retries and
queueing included), TPOT from the first to the last streamed token.
`shed_frac` counts requests refused after the bounded retry budget,
`timeout_frac` TTL expiries. A point is `slo_ok` when its p95s meet the
(optional) targets AND shed + timeout stays inside the error budget. Each
point also carries the round decomposition (`round_host_ms`,
`round_device_ms`: dispatch + token commit vs the wait for the device,
from a per-point Observability) and, with `--prefix-cache`,
`prefix_hit_rate` and `prefill_tokens_saved`.

Capture time is not a latency claim. JAX warms every program the workload
can reach before the first timed point; here that is every CUDA graph of
the decode group, one per (decode-chunk tail x page bucket) key
(`_warm_captures`), and each point reports the captures made inside it
(`captures`, 0 when the warm-up was complete). A capture belongs to its
engine's pool and weights, so every point runs on the one warmed engine,
returned to a fresh engine's state in between (`ServeEngine.reset`).
With `--hot-swap`, each point stages a verified checkpoint's weights
mid-arrival-window (training/checkpoint.py); the next point starts on the
inline weights again (one more flip, between points).

With `--fleet N` (N >= 2) the points are driven instead through N
in-process replicas behind a FleetRouter (sampling/fleet.py: prefix
affinity, failover, the shared host-RAM spill tier; the prefix cache is on)
by a synchronous loop whose step IS the clock, as JAX's harness does
(`_drive_fleet_point`). Every replica runs the capture warm-up before the
first timed point, and each point gets a fresh router over the reset
replicas; `assert_fleet_conserved` holds after each point, and the line
adds `fleet_size`, `failovers`, `spill_hits` and the fleet-wide
`prefix_hit_rate`; each point also counts the replica steps that raised
(`step_errors`: the router's health check absorbs them).

Adding `--procs` makes every replica a worker PROCESS behind the framed
socket transport (sampling/fleet_proc.py), spawned on `--device` with the
same weights (`--seed`, in the pool's dtype). The parent builds no engine
and launches no kernel; each worker is warmed over the wire before the
first point and serves every point (its trie stays warm, as JAX's does).
As in JAX, `--procs` needs `--fleet`, runs `fcfs` with `--overlap off`
and an unbounded backlog; points and the line add `rpc_p50_ms`,
`rpc_p95_ms` and `wire_bytes` (the hottest point's), and the point's
`prefix_hit_rate` is over its own drive.

With `--tp N` (N >= 2, under torchrun with at least N ranks) every
engine is tensor-parallel over the first N ranks, a (data 1, tp N) serving
mesh (parallel/serve_tp.py): the weights sharded by the Megatron rules,
the pool on its head axis. Rank 0 runs the points and prints the line,
which carries `tp` and `mesh`; the other ranks of the mesh follow its
engine (`ServeEngine.follow`). NCCL takes one rank per card; ranks that
share a card name `--backend gloo`; `--device cpu` runs the ranks on the
CPU over gloo. As in JAX, `--tp` needs `2 <= tp <= ranks` and `tp`
dividing `--n-head`, and `--fleet` refuses it; the engines run
`--overlap off` (a captured overlap mode is refused under tp). JAX's
`--cpu-devices` (a virtual device mesh in one process) is refused: the
port's ranks are processes (`torchrun ... --tp N --device cpu`).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import sys
import tempfile
import time
import types
import typing as tp

import numpy as np
import torch


def _percentile_ms(xs: tp.List[float], q: float) -> float:
    """Percentile of a list of seconds, in ms; 0.0 for an empty list (a
    degenerate point — visible as completed == 0, never NaN: the JSON
    contract rejects non-finite constants)."""
    if not xs:
        return 0.0
    return round(float(np.percentile(np.asarray(xs), q)) * 1e3, 3)


def _arrivals(process: str, rate: float, n: int, rng, burst_size: int):
    """Seeded arrival offsets (seconds from point start) at offered rate
    `rate` req/s: exponential inter-arrivals (poisson) or bursts of
    `burst_size` simultaneous arrivals with exponential gaps sized so the
    long-run offered rate matches (bursty)."""
    t, out = 0.0, []
    if process == "poisson":
        for _ in range(n):
            t += float(rng.exponential(1.0 / rate))
            out.append(t)
    else:  # bursty
        while len(out) < n:
            t += float(rng.exponential(burst_size / rate))
            out.extend([t] * min(burst_size, n - len(out)))
    return out


def _mixture(
    rng, n: int, block_size: int, vocab: int, long_frac: float,
    templates: tp.Sequence[np.ndarray] = (), template_frac: float = 0.0,
):
    """Prompt/output-length mixture: mostly short interactive requests, a
    `long_frac` tail of long-document prompts with bigger budgets. With
    `template_frac` > 0, that fraction of requests instead share one of
    `templates` as a common prompt head (system-prompt traffic) with a
    short unique tail — the workload the prefix cache exists for.
    Templates are built once per SEED, not per point, so every offered-load
    point measures the same shared heads."""
    reqs = []
    for _ in range(n):
        if templates and rng.random() < template_frac:
            head = templates[int(rng.integers(0, len(templates)))]
            tail = rng.integers(0, vocab, int(rng.integers(2, 8)), dtype=np.int64)
            prompt = np.concatenate([head, tail])
            m = min(int(rng.integers(6, 14)), block_size - len(prompt) - 1)
            reqs.append((prompt, m))
            continue
        if rng.random() < long_frac:
            if block_size >= 2048:
                # long-context regime: near-context document prompts with
                # bigger output budgets (the split-K bucket rule's territory)
                t0 = int(rng.integers(block_size // 2, block_size * 7 // 8))
                m = int(rng.integers(24, 48))
            else:
                t0 = int(rng.integers(block_size // 4, block_size // 2))
                m = int(rng.integers(12, 24))
        else:
            t0 = int(rng.integers(4, max(5, block_size // 8)))
            m = int(rng.integers(6, 14))
        m = min(m, block_size - t0 - 1)
        reqs.append((rng.integers(0, vocab, t0, dtype=np.int64), m))
    return reqs


def _warm_captures(engine, cfg, decode_chunk: int, page_size: int, seed: int) -> None:
    """Capture every decode-group graph the workload can reach: for each
    pow2 page bucket and each pow2 decode-chunk tail, one solo request
    whose prompt pins the bucket and whose budget pins the tail (JAX's
    `_warm_compile_grid`, the same requests)."""
    rng = np.random.default_rng(seed + 7919)
    S = cfg.block_size
    tails = []
    n = decode_chunk
    while n >= 1:
        tails.append(n)
        n //= 2
    b = 1
    while b <= engine.max_pages_per_slot:
        # mid-page prompt: the bucket stays at b while the tail decodes
        prompt_len = max(2, (b - 1) * page_size + 2)
        for tail in tails:
            if prompt_len + 1 + tail >= S:
                continue
            engine.submit(rng.integers(0, cfg.vocab_size, prompt_len, np.int64), tail + 1)
            engine.run()
        b *= 2


async def _drive_point(server, reqs, arrivals, ttl_s):
    """One offered-load point: a client task per request (sleep to its
    arrival, submit with the server's bounded backpressure retry, consume
    the stream). Returns per-request client-side records."""
    from midgpt_tpu_torch.sampling.serve import BackpressureError
    from midgpt_tpu_torch.sampling.server import ServerDraining

    t0 = time.perf_counter()
    records = []

    async def client(i, prompt, m, at):
        delay = at - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        rec = {"i": i, "status": "shed", "ttft_s": None, "tpot_s": None}
        records.append(rec)
        t_submit = time.perf_counter()
        try:
            uid = await server.submit(prompt, m, ttl_s=ttl_s)
        except (BackpressureError, ServerDraining):
            return
        times = []
        async for _tok in server.stream(uid):
            times.append(time.perf_counter())
        fr = server.result(uid)
        rec["status"] = fr.status if fr is not None else "lost"
        if times:
            rec["ttft_s"] = times[0] - t_submit
            if len(times) > 1:
                rec["tpot_s"] = (times[-1] - times[0]) / (len(times) - 1)

    await asyncio.gather(*(client(i, p, m, at) for i, ((p, m), at) in enumerate(zip(reqs, arrivals))))
    return records


def _drive_fleet_point(router, reqs, arrivals, ttl_s, submit_retries=8):
    """One offered-load point against a FleetRouter, driven synchronously:
    the router's step loop IS the clock (in-process replicas: an asyncio
    front door would add only scheduling noise). Arrivals submit when their
    offset passes, under a bounded per-request retry budget; a request still
    refused after `submit_retries` attempts stays a shed. TTFT runs from the
    FIRST submit attempt; token times ride the router's on_token relay, so a
    failed-over stream's replay counts in TPOT (at-least-once delivery)."""
    from midgpt_tpu_torch.sampling.serve import BackpressureError

    t0 = time.perf_counter()
    records = [{"i": i, "status": "shed", "ttft_s": None, "tpot_s": None} for i in range(len(reqs))]
    first_attempt: tp.Dict[int, float] = {}
    token_times: tp.Dict[int, tp.List[float]] = {}
    uid_to_i: tp.Dict[int, int] = {}

    def on_token(uid, tok, t):
        token_times.setdefault(uid, []).append(time.perf_counter())

    router.on_token = on_token
    order = sorted(range(len(reqs)), key=lambda i: arrivals[i])
    qi = 0
    waiting: tp.List[tp.List[int]] = []  # [request index, attempts so far]
    guard = 0
    while qi < len(order) or waiting or not router.idle:
        guard += 1
        if guard >= 1_000_000:
            raise SystemExit("fleet point did not converge")
        now = time.perf_counter() - t0
        while qi < len(order) and arrivals[order[qi]] <= now:
            waiting.append([order[qi], 0])
            qi += 1
        still: tp.List[tp.List[int]] = []
        for item in waiting:
            i = item[0]
            first_attempt.setdefault(i, time.perf_counter())
            try:
                uid = router.submit(reqs[i][0], reqs[i][1], ttl_s=ttl_s)
            except BackpressureError as e:
                item[1] += 1
                if item[1] < submit_retries and getattr(e, "retryable", False):
                    still.append(item)
                continue  # budget exhausted or terminal: stays "shed"
            uid_to_i[uid] = i
        waiting = still
        if qi < len(order) and router.idle and not waiting:
            # a quiet fleet and the next arrival in the future: sleep up to it
            delay = arrivals[order[qi]] - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            continue
        router.step()
    for uid, i in uid_to_i.items():
        fr = router.finished.get(uid)
        rec = records[i]
        rec["status"] = fr.status if fr is not None else "lost"
        times = token_times.get(uid, [])
        if times:
            rec["ttft_s"] = times[0] - first_attempt[i]
            if len(times) > 1:
                rec["tpot_s"] = (times[-1] - times[0]) / (len(times) - 1)
    return records


def _point_stats(rate, records, error_budget, slo_ttft_ms, slo_tpot_ms):
    n = len(records)
    shed = sum(1 for r in records if r["status"] == "shed")
    timeouts = sum(1 for r in records if r["status"] == "timeout")
    completed = sum(1 for r in records if r["status"] == "ok")
    ttfts = [r["ttft_s"] for r in records if r["ttft_s"] is not None]
    tpots = [r["tpot_s"] for r in records if r["tpot_s"] is not None]
    stats = {
        "offered_rps": rate,
        "n_offered": n,
        "completed": completed,
        "shed": shed,
        "timeouts": timeouts,
        "shed_frac": round(shed / max(n, 1), 4),
        "timeout_frac": round(timeouts / max(n, 1), 4),
        "ttft_p50_ms": _percentile_ms(ttfts, 50),
        "ttft_p95_ms": _percentile_ms(ttfts, 95),
        "tpot_p50_ms": _percentile_ms(tpots, 50),
        "tpot_p95_ms": _percentile_ms(tpots, 95),
    }
    ok = (shed + timeouts) / max(n, 1) <= error_budget
    if slo_ttft_ms:
        ok = ok and stats["ttft_p95_ms"] <= slo_ttft_ms
    if slo_tpot_ms:
        ok = ok and stats["tpot_p95_ms"] <= slo_tpot_ms
    stats["slo_ok"] = bool(ok and completed > 0)
    return stats


def _captures(engine) -> int:
    graphs = engine.stats()["decode_graphs"]
    return 0 if graphs is None else sum(graphs["captures_per_key"])


def _swap_candidate(cfg, seed: int, dtype: torch.dtype, device: torch.device):
    """(params, weights_version) of a verified checkpoint written from
    seed `seed` and restored as a sampler restores it."""
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.sampling.engine import restore_for_sampling
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager

    dtype_name = str(dtype).replace("torch.", "")
    with tempfile.TemporaryDirectory(prefix="midgpt_loadgen_swap_") as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        mgr = CheckpointManager(ckpt_dir, save_interval_steps=1)
        mgr.save(3, {"params": GPT.init(cfg, seed, device=device, dtype=dtype)}, force=True)
        mgr.wait()
        version = mgr.weights_version(3)
        mgr.close()
        shim = types.SimpleNamespace(model_config=cfg, param_dtype=dtype_name)
        params, _ = restore_for_sampling(ckpt_dir, shim, device=device)
    return params, version


# JAX's options the port refuses, with what takes their place
_REFUSED = {
    "cpu_devices": "--cpu-devices (a virtual device mesh in one process) has no counterpart: the port's tp ranks are "
                   "processes; run `python -m torch.distributed.run --standalone --nproc_per_node N -m "
                   "midgpt_tpu_torch.loadgen --tp N --device cpu` (module docstring)",
}


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--process", choices=("poisson", "bursty"), default="poisson")
    ap.add_argument("--rates", type=str, default="20,60",
                    help="comma-separated offered loads (req/s), one timed point each")
    ap.add_argument("--n-requests", type=int, default=8, help="requests offered per point")
    ap.add_argument("--burst-size", type=int, default=4, help="--process bursty: simultaneous arrivals per burst")
    ap.add_argument("--long-frac", type=float, default=0.25,
                    help="fraction of long-document requests in the mixture")
    ap.add_argument("--template-frac", type=float, default=0.0,
                    help="fraction of requests sharing a template prompt head (pair with --prefix-cache)")
    ap.add_argument("--n-templates", type=int, default=2, help="distinct shared prompt heads in the template mix")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="serve with the prefix cache (sampling/prefix_cache.py); points report prefix_hit_rate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", choices=("fcfs", "slo"), default="fcfs")
    ap.add_argument("--min-headroom-s", type=float, default=0.0,
                    help="--scheduler slo: shed requests whose deadline is nearer than this at submit")
    ap.add_argument("--ttl-s", type=float, default=0.0, help="per-request TTL (0 = none)")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0, help="p95 TTFT target (0 = unset)")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0, help="p95 TPOT target (0 = unset)")
    ap.add_argument("--error-budget", type=float, default=0.2,
                    help="max shed+timeout fraction for a point to be slo_ok")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="directory for one Chrome trace (+ .prom metrics) per offered-load point")
    ap.add_argument("--hot-swap", action="store_true",
                    help="stage a verified checkpoint's weights mid-arrival-window at each point")
    ap.add_argument("--overlap", type=str, default="off", help="'off', 'double' or 'group:k'")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    # engine/model shape (JAX's tiny defaults)
    ap.add_argument("--max-slots", type=int, default=3)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="0 = auto: 27 below block 2048, else every slot at its largest bucket")
    ap.add_argument("--max-backlog-pages", type=int, default=0, help="backpressure budget (0 = unbounded)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--vocab-size", type=int, default=96)
    ap.add_argument("--n-layer", type=int, default=2)
    ap.add_argument("--n-head", type=int, default=2)
    ap.add_argument("--n-embd", type=int, default=32)
    ap.add_argument("--n-kv-heads", type=int, default=0, help="GQA: K/V heads (0 = MHA)")
    ap.add_argument("--sliding-window", type=int, default=0, help="sliding-window attention (0 = full context)")
    ap.add_argument("--attn-sinks", type=int, default=0, help="with --sliding-window: positions kept visible")
    ap.add_argument("--fleet", type=int, default=0,
                    help="N >= 2: serve through N in-process replicas behind a FleetRouter (prefix cache on)")
    ap.add_argument("--procs", action="store_true",
                    help="with --fleet: the replicas are worker processes behind the socket transport")
    ap.add_argument("--tp", type=int, default=0,
                    help="> 0 runs every engine tensor-parallel on a (data=1, tp=N) serving mesh of ranks under "
                         "torchrun (module docstring); the line carries tp and mesh")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="--tp: the ranks' collective backend (default: NCCL on CUDA, gloo on the CPU; ranks that "
                         "share a card need gloo)")
    # refused (module docstring)
    ap.add_argument("--cpu-devices", type=int, default=0, help="refused: " + _REFUSED["cpu_devices"])
    args = ap.parse_args(argv)
    for name, why in _REFUSED.items():
        if getattr(args, name):
            ap.error(why)
    if args.fleet:
        if args.fleet < 2:
            ap.error("--fleet needs >= 2 replicas (one cannot fail over)")
        if args.hot_swap or args.tp:
            ap.error("--fleet is incompatible with --hot-swap and --tp")
        args.prefix_cache = True  # the router's affinity target
    if args.procs:
        if not args.fleet:
            ap.error("--procs requires --fleet N (it spawns the replicas)")
        if args.scheduler != "fcfs":
            ap.error("--procs workers run the default fcfs scheduler")
        if args.overlap != "off":
            ap.error("--procs workers run with --overlap off")
        if args.max_backlog_pages:
            ap.error("--procs workers run with an unbounded backlog")
    if not args.num_pages:
        pages_per_slot = -(-args.block_size // args.page_size)
        args.num_pages = 27 if args.block_size < 2048 else 1 + args.max_slots * pages_per_slot
    workers: tp.List[tp.Any] = []  # --procs: (Popen, port) of every worker spawned
    from midgpt_tpu_torch.parallel import dist

    joined = bool(args.tp) and not dist.initialized()  # --tp joins the process group unless the caller did
    try:
        return _run(args, workers)
    finally:
        if workers:
            from midgpt_tpu_torch.sampling.fleet_proc import kill_workers

            kill_workers(workers)
        if joined:
            dist.shutdown()


def _run(args, workers: tp.List[tp.Any]) -> int:
    """The points and the line (`main`, after its checks); spawned workers
    are appended to `workers`, which the caller kills."""
    rates = [float(r) for r in args.rates.split(",") if r.strip()]
    from midgpt_tpu_torch.device import device_label, resolve_device
    from midgpt_tpu_torch.models.gpt import GPT, GPTConfig
    from midgpt_tpu_torch.obs import Observability
    from midgpt_tpu_torch.sampling.fleet import FleetRouter, assert_fleet_conserved
    from midgpt_tpu_torch.sampling.scheduler import FCFSScheduler, SLOScheduler
    from midgpt_tpu_torch.sampling.serve import ServeEngine, parse_overlap
    from midgpt_tpu_torch.sampling.server import AsyncServeServer

    dev = resolve_device(args.device)
    overlap_mode, overlap_group = parse_overlap(args.overlap)
    mesh = None
    if args.tp:
        from midgpt_tpu_torch.parallel import dist
        from midgpt_tpu_torch.parallel.serve_tp import make_serve_mesh

        ranks = dist.world() if dist.initialized() else int(os.environ.get("WORLD_SIZE", 1))
        if args.tp < 2 or args.tp > ranks:
            raise SystemExit(f"--tp {args.tp} needs 2 <= tp <= {ranks} ranks")
        if args.n_head % args.tp:
            raise SystemExit(f"--tp {args.tp} must divide n_head {args.n_head}")
        dev = dist.init(args.device, args.backend)
        mesh = make_serve_mesh(tp_size=args.tp, device=dev)
        if not mesh.member:
            return 0
    cfg = GPTConfig(
        block_size=args.block_size,
        vocab_size=args.vocab_size,
        n_layer=args.n_layer,
        n_head=args.n_head,
        n_embd=args.n_embd,
        n_kv_heads=args.n_kv_heads or None,
        sliding_window=args.sliding_window,
        attn_sinks=args.attn_sinks,
    )
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    dtype_name = str(dtype).replace("torch.", "")
    if args.procs:
        # The parent builds no weights and no engine: each replica is a
        # worker process with the same seed's weights in the pool's dtype.
        from midgpt_tpu_torch.sampling.fleet_proc import connect_replica, parent_torch_config, spawn_workers

        spec = {
            "model": dataclasses.asdict(cfg),
            "seed": args.seed,
            "engine": {"max_slots": args.max_slots, "page_size": args.page_size, "num_pages": args.num_pages,
                       "prefill_chunk": args.prefill_chunk, "decode_chunk": args.decode_chunk,
                       "cache_dtype": dtype_name},
            "param_dtype": dtype_name,
            "device": dev.type,
            "torch_config": parent_torch_config(),
        }
        if dev.type == "cpu":
            spec["threads"] = 1
        workers.extend(spawn_workers(spec, args.fleet))
    else:
        params = GPT.init(cfg, args.seed, device=dev, dtype=dtype)

    def make_engine(obs_tid: str = "engine") -> ServeEngine:
        return ServeEngine(
            cfg,
            params,
            max_slots=args.max_slots,
            page_size=args.page_size,
            num_pages=args.num_pages,
            prefill_chunk=args.prefill_chunk,
            decode_chunk=args.decode_chunk,
            temperature=0.0,
            cache_dtype=dtype,
            max_backlog_pages=args.max_backlog_pages or None,
            scheduler=SLOScheduler(min_headroom_s=args.min_headroom_s) if args.scheduler == "slo" else FCFSScheduler(),
            prefix_cache=bool(args.prefix_cache),
            overlap=overlap_mode,
            round_group=overlap_group,
            obs_tid=obs_tid,
            device=dev,
            mesh=mesh,
        )

    if args.procs:
        engines = [connect_replica(port, retry_base_s=0.05) for _, port in workers]
    else:
        engines = [make_engine(f"replica{k}") for k in range(args.fleet)] if args.fleet else [make_engine()]
    engine = engines[0]
    if mesh is not None and not mesh.is_leader:
        engine.follow()  # every call the leader's points make, until it stops us
        return 0
    # Capture every decode-group graph the workload can reach, on every
    # engine the points run on (module docstring); a worker is warmed over
    # the wire, so the first point's percentiles time no first-use work.
    for eng in engines:
        _warm_captures(eng, cfg, args.decode_chunk, args.page_size, args.seed)
    warm_captures = sum(_captures(eng) for eng in engines)
    decode_steps = sum(eng.decode_steps for eng in engines)  # over the warm-up and every point

    # --hot-swap: one verified checkpoint restored once; every point stages
    # the same candidate. The flip writes into the engine's tensors, which
    # are `params`' own, so the inline weights are kept apart to restore.
    swap_payload = inline = None
    if args.hot_swap:
        swap_payload = _swap_candidate(cfg, args.seed + 101, dtype, dev)
        inline = {k: v.clone() for k, v in params.items()}

    # Shared prompt heads for the template mixture: ~3 pages each, built
    # once per seed.
    template_rng = np.random.default_rng(args.seed + 31)
    templates = [
        template_rng.integers(0, cfg.vocab_size, 3 * args.page_size, np.int64)
        for _ in range(args.n_templates)
    ] if args.template_frac > 0.0 else []

    S = cfg.block_size
    points = []
    for pi, rate in enumerate(rates):
        point_rng = np.random.default_rng(args.seed + 1000 * pi)
        reqs = _mixture(point_rng, args.n_requests, S, cfg.vocab_size, args.long_frac,
                        templates=templates, template_frac=args.template_frac)
        arrivals = _arrivals(args.process, rate, args.n_requests, point_rng, args.burst_size)
        if inline is not None and engine.weights_version != "inline":
            engine.hot_swap(inline, version="inline")  # idle: flips at once
        # One Observability per point: the round decomposition is a
        # per-offered-load number, and a dumped trace covers one point.
        obs = Observability()
        if not args.procs:
            for eng in engines:
                eng.reset(obs)
        # workers keep counting across points (their tries stay warm): this
        # point's numbers are deltas
        matched0 = [(eng._prefix_matched_tokens, eng._prefix_matchable_tokens) for eng in engines]
        captures_before = sum(_captures(eng) for eng in engines)
        t0 = time.perf_counter()
        if args.fleet:
            # a fresh router (its own counters and spill tier) over the reset replicas
            router = FleetRouter(engines)
            wire0 = router.transport_stats()["wire_bytes"] if args.procs else 0
            records = _drive_fleet_point(router, reqs, arrivals, args.ttl_s or None)
            assert_fleet_conserved(router, f"loadgen point {pi}")
        else:
            server = AsyncServeServer(engine, idle_poll_s=0.001)

            async def run_point():
                stepper = asyncio.create_task(server.run())
                swapper = None
                if swap_payload is not None:
                    # Stage at the median arrival: traffic lands on both sides
                    # of the flip.
                    async def do_swap():
                        await asyncio.sleep(arrivals[len(arrivals) // 2])
                        await server.hot_swap(swap_payload[0], version=swap_payload[1], config=cfg)

                    swapper = asyncio.create_task(do_swap())
                records = await _drive_point(server, reqs, arrivals, args.ttl_s or None)
                if swapper is not None:
                    await swapper
                await server.drain()
                await stepper
                return records

            records = asyncio.run(run_point())
        wall_s = time.perf_counter() - t0
        if not args.procs:  # reset each point
            decode_steps += sum(eng.decode_steps for eng in engines)
        stats = _point_stats(rate, records, args.error_budget, args.slo_ttft_ms, args.slo_tpot_ms)
        stats["wall_s"] = round(wall_s, 4)  # from the point's start to its drain
        stats["captures"] = sum(_captures(eng) for eng in engines) - captures_before
        if args.fleet:
            stats.update(fleet_size=args.fleet, failovers=router.failovers, spill_hits=router.spill.readopted,
                         step_errors=len(router.step_errors))
        if args.procs:
            transport = router.transport_stats()
            stats.update(rpc_p50_ms=transport["rpc_p50_ms"], rpc_p95_ms=transport["rpc_p95_ms"],
                         wire_bytes=transport["wire_bytes"] - wire0, proc_failovers=router.proc_failovers)
        if swap_payload is not None:
            stats["weights_version"] = engine.weights_version
            stats["hot_swaps"] = engine.hot_swaps
            stats["swap_flip_round"] = engine.swap_history[-1]["flip_round"] if engine.swap_history else None
        if args.prefix_cache:
            # fleet-wide under --fleet: matched over matchable tokens of every replica
            matched = sum(eng._prefix_matched_tokens - m0 for eng, (m0, _) in zip(engines, matched0))
            matchable = sum(eng._prefix_matchable_tokens - a0 for eng, (_, a0) in zip(engines, matched0))
            stats["prefix_hit_rate"] = round(matched / matchable if matchable else 0.0, 4)
            stats["prefill_tokens_saved"] = matched
        decomp = obs.round_decomp()
        stats["rounds"] = decomp["rounds"]
        stats["round_host_ms"] = {
            "p50": round(decomp["dispatch"]["p50_ms"] + decomp["host_post"]["p50_ms"], 3),
            "p95": round(decomp["dispatch"]["p95_ms"] + decomp["host_post"]["p95_ms"], 3),
        }
        stats["round_device_ms"] = {"p50": decomp["device_wait"]["p50_ms"], "p95": decomp["device_wait"]["p95_ms"]}
        stats["overlap_mode"] = "off" if args.procs else engine.overlap  # a worker's engine runs "off"
        stats["round_group"] = 1 if args.procs else engine.round_group
        stats["overlap_hidden_ms"] = {
            "p50": decomp["overlap_hidden"]["p50_ms"],
            "p95": decomp["overlap_hidden"]["p95_ms"],
        }
        if args.trace_out:
            obs.dump(args.trace_out, filename=f"loadgen_point{pi}_r{rate:g}.json")
        points.append(stats)

    if mesh is not None:
        engine.stop_followers()  # the tp leader's last edge: its followers return
    worst = points[-1]  # rates ascending by convention: report the hottest
    worker_stats = [eng.stats() for eng in engines]
    graphs = [st["decode_graphs"] for st in worker_stats]
    if args.procs:
        decode_steps = sum(st["decode_steps"] for st in worker_stats)
        for eng in engines:
            eng.close()
    device = device_label(dev)
    print(json.dumps({
        "bench": "serve_slo",
        "backend": dev.type,
        "device": device,
        "process": args.process,
        "scheduler": args.scheduler,
        "seed": args.seed,
        "n_requests": args.n_requests,
        "long_frac": args.long_frac,
        "template_frac": args.template_frac or None,
        "prefix_cache": bool(args.prefix_cache),
        "ttl_s": args.ttl_s or None,
        "error_budget": args.error_budget,
        "slo_ttft_ms": args.slo_ttft_ms or None,
        "slo_tpot_ms": args.slo_tpot_ms or None,
        "model": {
            "n_layer": cfg.n_layer,
            "n_head": cfg.n_head,
            "n_embd": cfg.n_embd,
            "block_size": S,
            "n_kv_heads": cfg.kv_heads,
            "kv_groups": cfg.kv_groups,
            "sliding_window": cfg.sliding_window,
            "attn_sinks": cfg.attn_sinks,
        },
        "max_slots": args.max_slots,
        "num_pages": args.num_pages,
        "cache_dtype": str(dtype).replace("torch.", ""),
        "tp": args.tp or None,
        "mesh": None if mesh is None else engine.mesh_shape(),
        "max_backlog_pages": args.max_backlog_pages or None,
        "warm_captures": warm_captures,
        # the device's decode steps: dispatched (a fused group's masked
        # steps included) and one warm-up step per capture
        "decode_steps": decode_steps,
        "capture_warmup_steps": sum(0 if g is None else g["warmup_steps"] for g in graphs),
        "points": points,
        # hottest-point headline numbers
        "ttft_p50_ms": worst["ttft_p50_ms"],
        "ttft_p95_ms": worst["ttft_p95_ms"],
        "tpot_p50_ms": worst["tpot_p50_ms"],
        "tpot_p95_ms": worst["tpot_p95_ms"],
        "shed_frac": worst["shed_frac"],
        "timeout_frac": worst["timeout_frac"],
        "round_host_ms": worst["round_host_ms"],
        "round_device_ms": worst["round_device_ms"],
        "overlap_mode": worst["overlap_mode"],
        "round_group": worst["round_group"],
        "overlap_hidden_ms": worst["overlap_hidden_ms"],
        "prefix_hit_rate": worst.get("prefix_hit_rate"),
        # --fleet: the hottest point's availability and affinity numbers
        # (prefix_hit_rate above is then the fleet-wide rate)
        "fleet_size": args.fleet or None,
        "failovers": worst.get("failovers") if args.fleet else None,
        "spill_hits": worst.get("spill_hits") if args.fleet else None,
        # --procs: the transport's numbers at the hottest point
        "procs": bool(args.procs),
        "rpc_p50_ms": worst.get("rpc_p50_ms") if args.procs else None,
        "rpc_p95_ms": worst.get("rpc_p95_ms") if args.procs else None,
        "wire_bytes": worst.get("wire_bytes") if args.procs else None,
        "weights_versions": ["inline", swap_payload[1]] if swap_payload else None,
        "weights_version": engine.weights_version,
        "hot_swaps": sum(p.get("hot_swaps", 0) for p in points) if swap_payload else None,
        "slo_ok": bool(all(p["slo_ok"] for p in points)),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
