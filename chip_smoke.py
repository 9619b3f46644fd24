#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (midgpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port still starts on the card. Phases, in
order; any failure ends the run with a non-zero exit (nothing is caught):

  1. require CUDA and the port's sources beside this script; print the
     card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from midgpt_tpu_torch/csrc
     (one nvcc per source, all started together; ptxas report printed);
  3. hold each kernel against its plain PyTorch version at the slice's
     shapes — 4 slots, 12 heads of 64, pages of 8, a 128-page bucket,
     counts [1024, 700, 300, 1] — in bf16 and f32, split 1 and 2;
  4. the main path: the port's ServeEngine at openwebtext width (GPT-2
     small, random weights from a seed, bf16) serves a mixed trace with
     max_slots=4 — short requests (split-1 rounds) and one longer than 512
     tokens (split-2 rounds). Launch counters are zeroed just before and
     read just after; every request must finish with its token budget,
     both splits must have launched, and launches must equal n_layer x
     decode steps;
  5. the same trace in f32 through the kernel and through the gather
     lowering: the greedy streams must be identical; then the device busy
     share of steady bf16 decode rounds under torch.profiler, with the
     kernels that took the most device time;
  6. timings at the phase-3 shapes: the kernel's device time (calls of its
     wrapper captured in a CUDA graph and replayed, the inputs cycled
     through copies larger than the L2 so each call starts cold, as in a
     decode step), the same call made eagerly (host included), its plain
     version, the least time the card could take (bytes of K/V and q/out
     over 3.35 TB/s, or the flops over the peak rate, whichever is
     larger), and as a yardstick one
     torch.nn.functional.scaled_dot_product_attention call over K/V
     gathered beforehand (timed here, never used by the port).

The last lines are the card's name and power limit as nvidia-smi prints
them, one JSON object with a "kernels" list, and the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / f32 non-tensor
SLOTS, HEADS, HEAD_DIM, PAGE, BUCKET = 4, 12, 64, 8, 128
COUNTS = [1024, 700, 300, 1]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
KERNEL_SOURCES = ("paged_attention",)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def decode_problem(dtype, seed=0):
    """Phase-3 inputs on the card: q, pools, a shuffled page table whose
    unused entries point at the sink page 0, and the counts."""
    g = torch.Generator().manual_seed(seed)
    need = [-(-c // PAGE) for c in COUNTS]
    num_pages = 1 + sum(need)
    perm = (torch.randperm(num_pages - 1, generator=g) + 1).tolist()
    table = torch.zeros(SLOTS, BUCKET, dtype=torch.int32)
    for b, n in enumerate(need):
        if COUNTS[b] > 1:  # the count-1 slot stands for an inactive one: sink only
            table[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
            perm = perm[n:]
    q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=g)
    k = torch.randn(HEADS, num_pages, PAGE, HEAD_DIM, generator=g)
    v = torch.randn(HEADS, num_pages, PAGE, HEAD_DIM, generator=g)
    counts = torch.tensor(COUNTS, dtype=torch.int32)
    dev = torch.device("cuda")
    return [t.to(dev, dtype) for t in (q, k, v)] + [table.to(dev), counts.to(dev)]


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(dtype):
    """(least ms the card could take at the phase-3 shapes, what bounds it)."""
    item = torch.empty((), dtype=dtype).element_size()
    keys = sum(COUNTS)  # what this run's data needs: visible keys only
    moved = (
        2 * keys * HEADS * HEAD_DIM * item  # K and V, each read once
        + 2 * SLOTS * HEADS * HEAD_DIM * item  # q in, out
        + SLOTS * BUCKET * 4 + SLOTS * 4  # page table, counts
    )
    flops = 4 * keys * HEADS * HEAD_DIM  # q.k and p.v multiply-adds
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(dtype, split_k):
    """Phase 3: kernel vs plain on the same inputs; returns max |err|."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    q, k, v, table, counts = decode_problem(dtype)
    got = tpl.paged_attention_template(q[:, :, None], k, v, table, counts[:, None], split_k)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, counts[:, None], split_k)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    print(f"kernel check {str(dtype)[6:]} split_k={split_k}: max_abs_err={err:.3e} (tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise SystemExit(f"paged decode kernel disagrees with its plain version ({dtype}, split {split_k})")
    return err


def graph_ms(fns, per_graph: int = 24, replays: int = 20) -> float:
    """Device time per call: `per_graph` calls, cycling through `fns` (each
    on its own copy of the inputs, together larger than the 50 MB L2, so
    every call finds its data cold, as the decode step does), captured in
    one CUDA graph and replayed — no host work inside the timed region."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fns[i % len(fns)]()
    return event_ms(graph.replay, replays, warmup=2) / per_graph


def time_kernel(dtype, split_k, copies: int = 12):
    """Phase 6 at the phase-3 shapes: device ms of the kernel's wrapper
    (graph replay, cold L2), the same call eagerly (host included), the
    plain version (eager) and the SDPA yardstick (graph replay, cold L2)."""
    import torch.nn.functional as F

    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.kernels.decode_attention import _gather_pages

    probs = [decode_problem(dtype, seed=1 + i) for i in range(copies)]

    def call(p):
        q, k, v, table, counts = p
        return lambda: tpl.paged_attention_template(q[:, :, None], k, v, table, counts[:, None], split_k)

    def sdpa(p):
        q, k, v, table, counts = p
        kg, vg = _gather_pages(k, table).contiguous(), _gather_pages(v, table).contiguous()
        mask = (torch.arange(kg.shape[2], device=q.device)[None, :] < counts[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask)

    before = tpl.LAUNCHES.count
    ms = graph_ms([call(p) for p in probs])
    eager_ms = event_ms(call(probs[0]), 200, 10)
    q, k, v, table, counts = probs[0]
    plain_ms = event_ms(
        lambda: tpl.paged_attention_template_plain(q[:, :, None], k, v, table, counts[:, None], split_k), 3, 1
    )
    lib_ms = graph_ms([sdpa(p) for p in probs[: copies // 2]])
    if tpl.LAUNCHES.count == before:
        raise SystemExit("timing loop never launched the kernel")
    return ms, eager_ms, plain_ms, lib_ms


def profile_decode(model_cfg, params, rounds: int = 3):
    """Device busy share of steady decode rounds (4 slots decoding) under
    torch.profiler: the sum of kernel times over the wall time of the
    window, and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from midgpt_tpu_torch.sampling.serve import ServeEngine

    eng = ServeEngine(model_cfg, params, max_slots=4, page_size=PAGE, prefill_chunk=256,
                      decode_chunk=8, cache_dtype=params["wte"].dtype, device="cuda")
    rng = np.random.default_rng(1)
    for _ in range(4):
        eng.submit(rng.integers(0, model_cfg.vocab_size, 64).astype(np.int32), 8 * (rounds + 3))
    for _ in range(2):  # prefill + first decode round: everyone decoding after
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return wall_us, by_name


def trace(vocab: int):
    """Six requests: four short ones first (split-1 rounds), then one whose
    span passes 512 tokens (split-2 rounds while it decodes), then one more
    short one."""
    rng = np.random.default_rng(0)
    shape = [(24, 48), (40, 40), (16, 64), (30, 32), (600, 48), (8, 24)]
    return [(rng.integers(0, vocab, n).astype(np.int32), m) for n, m in shape]


def serve(model_cfg, params, dtype, attn_impl="auto"):
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    eng = ServeEngine(
        model_cfg, params, max_slots=4, page_size=PAGE, prefill_chunk=256,
        decode_chunk=8, temperature=0.0, cache_dtype=dtype, attn_impl=attn_impl,
        device="cuda",
    )
    reqs = trace(model_cfg.vocab_size)
    uids = [eng.submit(p, m) for p, m in reqs]
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = []
    for (p, m), u in zip(reqs, uids):
        fr = done[u]
        if fr.status != "ok" or len(fr.tokens) != len(p) + m:
            raise SystemExit(f"request {u} ended {fr.status} with {len(fr.tokens) - len(p)}/{m} tokens")
        if not (0 <= fr.tokens.min() and fr.tokens.max() < model_cfg.vocab_size):
            raise SystemExit(f"request {u} produced out-of-vocabulary tokens")
        streams.append(fr.tokens)
    if eng.allocator.free_count != eng.allocator.num_pages - 1:
        raise SystemExit("pages leaked: the pool did not drain back to its free list")
    return eng.stats(), streams, wall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "midgpt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.kernels import build
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.utils.precision import cast_floating

    # parity runs: full f32 matmuls (the JAX tests run at 'highest')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    paths = build.build(KERNEL_SOURCES)
    print(f"built {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s: {[p.name for p in paths.values()]}")
    for src, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # 3. kernel vs plain at the slice's shapes
    errs = {(dt, s): check_kernel(dt, s) for dt in (torch.bfloat16, torch.float32) for s in (1, 2)}

    # 4. the main path, bf16: counters zeroed just before, read just after
    cfg = load_config("openwebtext").model_config
    params32 = GPT.init(cfg, 0, device="cuda")
    params16 = cast_floating(params32, torch.bfloat16)
    tpl.LAUNCHES.reset()
    stats16, _, wall16 = serve(cfg, params16, torch.bfloat16)
    launches = dict(tpl.LAUNCHES.by_variant)
    print(f"main path bf16: {json.dumps(stats16)} wall {wall16:.3f} s")
    print(f"kernel launches by split: {launches}; decode steps {stats16['decode_steps']} x {cfg.n_layer} layers")
    if set(launches) != {1, 2} or min(launches.values()) < 1:
        raise SystemExit(f"the main path must launch the kernel at split 1 and 2, got {launches}")
    if sum(launches.values()) != cfg.n_layer * stats16["decode_steps"]:
        raise SystemExit("kernel launches != n_layer x decode steps: a decode step bypassed the kernel")
    tok_s = stats16["decode_tokens"] / stats16["decode_seconds"]
    print(f"decode throughput bf16: {tok_s:.1f} tokens/s over {stats16['decode_tokens']} tokens "
          f"({stats16['decode_seconds']:.3f} s in decode rounds) on {card}")

    # 5. f32: kernel and gather streams identical
    _, kernel_streams, _ = serve(cfg, params32, torch.float32, attn_impl="auto")
    _, gather_streams, _ = serve(cfg, params32, torch.float32, attn_impl="gather")
    for i, (a, b) in enumerate(zip(kernel_streams, gather_streams)):
        if not np.array_equal(a, b):
            first = int(np.argmax(a != b))
            raise SystemExit(f"f32 request {i}: kernel and gather streams differ from token {first}")
    print(f"f32 greedy streams identical, kernel vs gather: {len(kernel_streams)} requests")

    # 5b. where a decode round's time goes: device busy share under the profiler
    wall_us, by_name = profile_decode(cfg, params16)
    busy_us = sum(by_name.values())
    if busy_us:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"decode rounds under torch.profiler: wall {wall_us / 1e3:.2f} ms, device busy "
              f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%, idle {100 - 100 * busy_us / wall_us:.1f}%) on {card}")
        for kname, us in top:
            print(f"  {us / 1e3:8.3f} ms  {kname[:110]}")
    else:
        print("decode device busy share: not measured (the profiler saw no device activity)")

    # 6. timings at the phase-3 shapes
    kernels = []
    for dt in (torch.bfloat16, torch.float32):
        for s in (1, 2):
            ms, eager_ms, plain_ms, lib_ms = time_kernel(dt, s)
            b_ms, b_by = bound_ms(dt)
            print(f"paged_attention_decode {str(dt)[6:]} split_k={s}: {ms:.4f} ms device (graph replay, cold L2; "
                  f"{eager_ms:.4f} ms per eager call with host) bound {b_ms:.4f} ms by {b_by}, "
                  f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms on {card}")
            if dt == torch.bfloat16:  # the main path's dtype: one entry per launch variant
                kernels.append({
                    "name": f"paged_attention_decode[bf16,split_k={s}]",
                    "route": "cuda",
                    "source": "midgpt_tpu_torch/csrc/paged_attention.cu",
                    "replaces": "midgpt_tpu/kernels/attention_template.py:95",
                    "launches": launches[s],
                    "max_abs_err": errs[(dt, s)],
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": lib_ms,
                })
    print(card)  # exactly as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
