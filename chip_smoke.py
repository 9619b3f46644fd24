#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (midgpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port still starts on the card. Phases, in
order; any failure ends the run with a non-zero exit (nothing is caught):

  1. require CUDA and the port's sources beside this script; print the
     card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from midgpt_tpu_torch/csrc (one
     nvcc per source, all started together; ptxas report printed);
  3. hold each kernel against its plain PyTorch version:
     a. paged decode at the serving shapes — 4 slots, 12 heads of 64, pages
        of 8, a 128-page bucket, counts [1024, 700, 300, 1] — in bf16 and
        f32, split 1 and 2, and an f32 query over bf16 pools;
     b. flash attention forward (out, lse) and backward (dq, dk, dv from
        one seeded upstream gradient) at the training main path's shape
        (B 16, H 12, T 1024, C 64, blocks (512, 1024)) in bf16 and f32, at
        llama7b_long's head shape (B 1, H 32, T 4096, C 128, blocks
        (512, 1024): the tiled dispatch) and at T 2048 with one KV block
        (blocks (512, 2048): the single-visit dQ with the tiled dK/dV);
  4. serving main path: the port's ServeEngine at openwebtext width (GPT-2
     small, random weights from a seed, bf16) serves a mixed trace with
     max_slots=4 — short requests (split-1 rounds) and one longer than 512
     tokens (split-2 rounds). Launch counters are zeroed just before and
     read just after; every request must finish with its token budget,
     both splits must have launched, and launches must equal n_layer x
     decode steps;
  5. the same trace in f32 through the kernel and through the gather
     lowering: the greedy streams must be identical; then the device busy
     share of steady bf16 decode rounds under torch.profiler;
  6. training main path: `python -m midgpt_tpu_torch.launch
     --config=local_text_124m` (its `main`, in this process) at full width
     — 12 x 768, 12 heads, T 1024, microbatch 16, vocab 50304, bf16
     compute over f32 master params — on a seeded synthetic uint16 stream
     written to a temporary directory, with the cuts printed as "reduced".
     Flash counters are zeroed just before and read just after: forward
     launches must equal n_layer x (microsteps + eval batches), each
     backward kernel's n_layer x microsteps; every loss must be finite;
  7. parity on the card: training steps through the flash kernels against
     the same steps through the dense (naive) attention, same params and
     batches — f32 at full width and 2 layers (losses and the parameter
     update), bf16 at full depth (the loss);
  8. the tiled dispatch through the trainer (attn_block_size 512, 2
     layers): all three kernels must launch as "tiled";
  9. torch.profiler over one training microstep at the main path's shape:
     the device's busy and idle share and the kernels with the most
     device time;
 10. timings: the paged decode kernel as before (CUDA-graph replay, cold
     L2), and each flash kernel in bf16 (CUDA events over repeated
     launches) at the main path's shape and at one shape per other
     dispatch (the main path at attn_block_size 512, and the two other
     shapes of phase 3b), beside its plain version, its bound (the larger
     of the bytes it must move over 3.35 TB/s and its causal FLOPs over
     the dense peak of the inputs' type) and, as a yardstick the port
     never calls, torch's scaled_dot_product_attention forward and
     backward. The "kernels" line carries the main path's numbers.

The last lines are the card's name and power limit as nvidia-smi prints
them, one JSON object with a "kernels" list, and the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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
KERNEL_SOURCES = ("paged_attention", "flash_attention")
# flash checks: (label, B, H, T, C, block_q, block_k, dtype)
FLASH_MAIN = ("main path", 16, 12, 1024, 64, 512, 1024)
FLASH_CHECKS = [
    (*FLASH_MAIN, torch.bfloat16),
    (*FLASH_MAIN, torch.float32),
    ("llama7b_long head", 1, 32, 4096, 128, 512, 1024, torch.bfloat16),
    ("T 2048, one KV block", 2, 12, 2048, 64, 512, 2048, torch.bfloat16),
]
# flash timings (bf16): the main path, then one shape per other dispatch
FLASH_TIMED = [
    FLASH_MAIN,
    ("main path at attn_block_size 512", 16, 12, 1024, 64, 512, 512),
    *(check[:7] for check in FLASH_CHECKS[2:]),
]
# training main path: the cuts of local_text_124m, printed as "reduced"
TRAIN_CUTS = {"g_accum_iters": 2, "max_steps": 4, "eval_steps": 1, "eval_interval": 1000}
# parity tolerances (printed): f32 losses relative, f32 update relative
# norm, bf16 loss relative (dense attention rounds its scores to bf16)
PARITY_TOL = {"f32_loss": 1e-5, "f32_update": 1e-3, "bf16_loss": 1e-2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def free_memory() -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- paged decode


def decode_problem(dtype, seed=0):
    """Phase-3a inputs on the card: q, pools, a shuffled page table whose
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
    """(least ms the card could take at the phase-3a shapes, what bounds it)."""
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


def check_kernel(dtype, split_k, kv_dtype=None):
    """Phase 3a: kernel vs plain on the same inputs; returns max |err|.
    kv_dtype: the pools' dtype when it differs from the query's."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    q, k, v, table, counts = decode_problem(dtype)
    if kv_dtype is not None:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    got = tpl.paged_attention_template(q[:, :, None], k, v, table, counts[:, None], split_k)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, counts[:, None], split_k)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) and got.dtype == dtype
    label = str(dtype)[6:] + ("" if kv_dtype is None else f" over {str(kv_dtype)[6:]} pools")
    print(f"kernel check paged decode {label} split_k={split_k}: max_abs_err={err:.3e} "
          f"(tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise SystemExit(f"paged decode kernel disagrees with its plain version ({label}, split {split_k})")
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
    """Phase 10 at the phase-3a shapes: device ms of the kernel's wrapper
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


def device_time_by_kernel(prof):
    """{kernel name: device us} over a torch.profiler run."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name


def profile_decode(model_cfg, params, rounds: int = 3):
    """Device busy share of steady decode rounds (4 slots decoding) under
    torch.profiler: the sum of kernel times over the wall time of the
    window, and the kernels that took the most device time."""
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
    return wall_us, device_time_by_kernel(prof)


def print_busy(what, wall_us, by_name, card, top=6):
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"{what} device busy share: not measured (the profiler saw no device activity)")
        return
    print(f"{what} under torch.profiler: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%) on {card}")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:8.3f} ms  {kname[:110]}")


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


# ---------------------------------------------------------------- flash attention


def flash_problem(B, H, T, C, dtype, seed=0):
    """q, k, v and an upstream gradient, (B*H, T, C) on the card."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B * H, T, C, generator=g).to("cuda", dtype) for _ in range(4)]


def check_flash(label, B, H, T, C, bq, bk, dtype):
    """Phase 3b: the three flash kernels vs the plain version on the same
    inputs (the backward from the kernel's own out and lse, on both
    sides). Tolerances: out as the paged kernel's; lse 1e-5 abs+rel;
    gradients tol * max|plain| absolute plus tol relative. Returns the
    max |err| of each output."""
    from midgpt_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = flash_problem(B, H, T, C, dtype)
    out, lse = fa.flash_forward(q, k, v, bq, bk)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, bq, bk)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_forward_plain(q, k, v, bq, bk)
    want_grads = fa.flash_backward_plain(q, k, v, out, lse, do, bq, bk)
    tol = TOL[dtype]
    errs, ok = {}, True
    pairs = [("out", out, want_out, tol, tol), ("lse", lse, want_lse, 1e-5, 1e-5)]
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), want_grads):
        pairs.append((name, got, want, tol * want.float().abs().max().item(), tol))
    for name, got, want, atol, rtol in pairs:
        got, want = got.float(), want.float()
        errs[name] = (got - want).abs().max().item()
        ok &= bool(torch.isfinite(got).all()) and torch.allclose(got, want, atol=atol, rtol=rtol)
    print(f"kernel check flash {label} B={B} H={H} T={T} C={C} blocks=({bq},{bk}) {str(dtype)[6:]}: "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tol out {tol:g}, lse 1e-5, grads {tol:g} x max|plain| + {tol:g} rel) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash kernels disagree with their plain version ({label}, {dtype})")
    return errs


def flash_counters():
    from midgpt_tpu_torch.kernels import flash_attention as fa

    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES}


def synthetic_stream(data_dir: Path, vocab: int, n_tokens: int = 2_000_000) -> None:
    """A seeded uniform uint16 token stream (no meta.pkl): train.bin, val.bin."""
    r = np.random.default_rng(0)
    stream = r.integers(0, vocab, n_tokens, dtype=np.uint16)
    stream[: n_tokens * 9 // 10].tofile(data_dir / "train.bin")
    stream[n_tokens * 9 // 10 :].tofile(data_dir / "val.bin")


def sets(d: dict):
    return [a for k, v in d.items() for a in ("--set", f"{k}={v}")]


def train_main_path(data_dir: Path, card: str):
    """Phase 6: the launcher at local_text_124m's full width, cut only in
    steps, accumulation and eval. Returns (launches by kernel, tokens/s,
    mfu, loss records)."""
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.config import load_config

    base = load_config("local_text_124m")
    mc = base.model_config
    print("reduced: " + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in TRAIN_CUTS.items())
          + f"; data: seeded synthetic uint16 stream (vocab {mc.vocab_size}) in a temporary directory")
    counters = flash_counters()
    with tempfile.TemporaryDirectory() as rundir:
        for c in counters.values():
            c.reset()
        launch.main(["--config=local_text_124m", f"--rundir={rundir}",
                     *sets({"data_dir": data_dir, "log_interval": 1, **TRAIN_CUTS})])
        torch.cuda.synchronize()
        launches = {n: dict(c.by_variant) for n, c in counters.items()}
        records = [json.loads(line) for line in Path(rundir, "metrics.jsonl").read_text().splitlines()]
        if not Path(rundir, "params.npz").exists():
            raise SystemExit("the launcher wrote no params.npz")
    G, steps = TRAIN_CUTS["g_accum_iters"], TRAIN_CUTS["max_steps"]
    micro = G * steps
    evals = 3 * TRAIN_CUTS["eval_steps"]  # train + val at step 0, val at the end
    print(f"flash launches on the training main path: {launches}; {mc.n_layer} layers x "
          f"({micro} microsteps + {evals} eval batches)")
    totals = {n: sum(v.values()) for n, v in launches.items()}
    if totals["flash_fwd"] != mc.n_layer * (micro + evals):
        raise SystemExit("forward launches != n_layer x (microsteps + eval batches)")
    for n in ("flash_bwd_dq", "flash_bwd_dkv"):
        if totals[n] != mc.n_layer * micro:
            raise SystemExit(f"{n} launches != n_layer x microsteps")
    if any(set(v) != {"single"} for v in launches.values()):
        raise SystemExit("T=1024 with blocks (512, 1024) must dispatch the single-visit bodies")
    steps_rec = [r for r in records if "loss/optimized" in r]
    losses = [r["loss/optimized"] for r in steps_rec]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise SystemExit(f"training losses not all finite: {losses}")
    evals_rec = [v for r in records for k, v in r.items() if k.startswith("loss/") and k != "loss/optimized"]
    if not all(np.isfinite(evals_rec)):
        raise SystemExit(f"eval losses not all finite: {evals_rec}")
    steady = steps_rec[1:]  # step 0 pays first-call set-up
    tok_s = float(np.mean([r["throughput/tokens_per_sec"] for r in steady]))
    mfu = float(np.mean([r["throughput/mfu"] for r in steady])) if "throughput/mfu" in steady[0] else None
    print(f"training losses by step: {[round(x, 4) for x in losses]} on {card}")
    print(f"training throughput (steps 1-{steps - 1}, G={G} x {base.batch_size} x {mc.block_size} tokens per step): "
          f"{tok_s:.1f} tokens/s, MFU {'not known for this card' if mfu is None else f'{100 * mfu:.2f}%'} on {card}")
    return launches, tok_s, mfu, losses


def parity_run(data_dir: Path, n_layer, compute_dtype, steps, impl):
    """Train steps of local_text_124m (n_layer layers, G=1, warmup 2) with
    one attention impl; returns (losses, params before, params after)."""
    import dataclasses

    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.data.dataset import TokenDataset
    from midgpt_tpu_torch.training.train import init_state, make_train_step

    base = load_config("local_text_124m")
    cfg = base.replace(
        data_dir=str(data_dir), compute_dtype=compute_dtype, g_accum_iters=1, warmup_steps=2,
        spec_layers=0, model_config=dataclasses.replace(base.model_config, n_layer=n_layer, attn_impl=impl),
    )
    params, state, opt = init_state(cfg, "cuda")
    before = {k: v.clone() for k, v in params.items()}
    step = make_train_step(cfg, opt)[0]
    ds = TokenDataset(str(data_dir), seed=cfg.data_seed)
    losses = []
    for i in range(steps):
        x, y = ds.batch("train", i, cfg.model_config.block_size, cfg.batch_size, 1)
        params, state, loss = step(params, state, torch.from_numpy(x).cuda().long(),
                                   torch.from_numpy(y).cuda().long())
        losses.append(loss.item())
    return losses, before, params


def train_parity(data_dir: Path, card: str):
    """Phase 7: flash kernels vs dense attention inside the train step."""
    kl, p0, pk = parity_run(data_dir, 2, "float32", 3, "flash")
    nl, _, pn = parity_run(data_dir, 2, "float32", 3, "naive")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(kl, nl))
    num = sum(((pk[k] - pn[k]).double() ** 2).sum() for k in p0).sqrt().item()
    den = sum(((pn[k] - p0[k]).double() ** 2).sum() for k in p0).sqrt().item()
    upd_err = num / den
    max_p = max((pk[k] - pn[k]).abs().max().item() for k in p0)
    del p0, pk, pn
    free_memory()
    print(f"parity f32, 2 layers at full width, 3 steps: losses flash {kl} vs dense {nl} "
          f"(max rel err {loss_err:.2e}, tol {PARITY_TOL['f32_loss']:g}); parameter update rel err "
          f"{upd_err:.2e} (tol {PARITY_TOL['f32_update']:g}), max |param diff| {max_p:.2e} on {card}")
    kb, *_ = parity_run(data_dir, 12, "bfloat16", 1, "flash")
    free_memory()
    nb, *_ = parity_run(data_dir, 12, "bfloat16", 1, "naive")
    free_memory()
    b_err = abs(kb[0] - nb[0]) / abs(nb[0])
    print(f"parity bf16, 12 layers: loss flash {kb[0]:.6f} vs dense {nb[0]:.6f} (rel err {b_err:.2e}, "
          f"tol {PARITY_TOL['bf16_loss']:g}) on {card}")
    if (loss_err > PARITY_TOL["f32_loss"] or upd_err > PARITY_TOL["f32_update"]
            or b_err > PARITY_TOL["bf16_loss"] or not np.isfinite(kb[0])):
        raise SystemExit("the train step through the flash kernels disagrees with dense attention")


def train_tiled(data_dir: Path):
    """Phase 8: attn_block_size 512 at T 1024 dispatches the tiled bodies."""
    from midgpt_tpu_torch import launch

    counters = flash_counters()
    for c in counters.values():
        c.reset()
    launch.main(["--config=local_text_124m", "--debug", *sets({
        "data_dir": data_dir, "model_config.attn_block_size": 512, "model_config.n_layer": 2,
        "spec_layers": 0, "max_steps": 2, "g_accum_iters": 1, "eval_interval": 1000, "log_interval": 1,
    })])
    torch.cuda.synchronize()
    launches = {n: dict(c.by_variant) for n, c in counters.items()}
    print(f"tiled dispatch through the trainer (attn_block_size 512, 2 layers, 2 steps): {launches}")
    if any(set(v) != {"tiled"} for v in launches.values()):
        raise SystemExit("attn_block_size 512 must launch every flash kernel as 'tiled'")


def profile_train(data_dir: Path, card: str):
    """Phase 9: one microstep (G=1) of the main path's shape under the
    profiler, after one warm step."""
    from torch.profiler import ProfilerActivity, profile

    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.data.dataset import TokenDataset
    from midgpt_tpu_torch.training.train import init_state, make_train_step

    cfg = load_config("local_text_124m").replace(data_dir=str(data_dir), g_accum_iters=1)
    params, state, opt = init_state(cfg, "cuda")
    step = make_train_step(cfg, opt)[0]
    T = cfg.model_config.block_size
    x, y = TokenDataset(str(data_dir), seed=cfg.data_seed).batch("train", 0, T, cfg.batch_size, 1)
    x, y = torch.from_numpy(x).cuda().long(), torch.from_numpy(y).cuda().long()
    params, state, loss = step(params, state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if not np.isfinite(loss.item()):
        raise SystemExit("profiled training step gave a non-finite loss")
    by_name = device_time_by_kernel(prof)
    print_busy("one training microstep (B 16 x T 1024, 12 layers, bf16)", wall_us, by_name, card, top=10)
    flash_us = {n: sum(us for k, us in by_name.items() if n in k)
                for n in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
    print("  flash kernels in that step: " + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in flash_us.items()))
    busy = sum(by_name.values())
    print("  device time by kind: " + ", ".join(
        f"{kind} {us / 1e3:.3f} ms ({100 * us / busy:.1f}%)" for kind, us in time_by_kind(by_name).items()))


# kernel-name markers of each kind, first match wins
KINDS = {
    "flash kernels": ("flash_",),
    "GEMMs": ("nvjet", "gemm", "cutlass", "xmma", "cublas"),
    "reductions": ("reduce_kernel",),
    "elementwise, copies and indexing": ("elementwise", "copy", "index", "gather", "scatter", "Cat"),
}


def time_by_kind(by_name):
    """{kind: device us} over a profile's {kernel name: device us}."""
    out = {kind: 0.0 for kind in (*KINDS, "other")}
    for kname, us in by_name.items():
        kind = next((k for k, marks in KINDS.items() if any(m in kname for m in marks)), "other")
        out[kind] += us
    return out


def flash_bounds(B, H, T, C, dtype):
    """{kernel: (least ms, what bounds it)} at one shape: each input read
    once and each output written once over 3.35 TB/s, against the causal
    products (T (T + 1) / 2 score pairs per head, 2 C flops per pair and
    product) over the dense peak of the inputs' type."""
    item = torch.empty((), dtype=dtype).element_size()
    N = B * H
    tensor, lse = N * T * C * item, N * T * 4
    product = N * T * (T + 1) // 2 * 2 * C
    work = {  # (bytes moved, flops)
        "flash_fwd": (4 * tensor + lse, 2 * product),  # q k v in, out + lse out; QK^T, PV
        "flash_bwd_dq": (6 * tensor + lse, 3 * product),  # q k v o dO lse in, dq out; QK^T, dO V^T, dS K
        "flash_bwd_dkv": (7 * tensor + lse, 4 * product),  # ... dk dv out; + P^T dO, dS^T Q
    }
    out = {}
    for name, (moved, flops) in work.items():
        t_b, t_o = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")
    return out


def time_flash(B, H, T, C, bq, bk, dtype=torch.bfloat16):
    """Phase 10 at one shape: device ms of each kernel (CUDA events over
    repeated launches), of the plain version, and of SDPA's forward and
    backward (one call each)."""
    import torch.nn.functional as F

    from midgpt_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = flash_problem(B, H, T, C, dtype, seed=3)
    out, lse = fa.flash_forward(q, k, v, bq, bk)
    args = fa._check_backward(q, k, v, out, lse, do)
    _, v_dq, v_dkv = fa._variants(T, fa._block_sizes(T, bq, bk)[1])
    before = [c.count for c in flash_counters().values()]
    ms = {
        "flash_fwd": event_ms(lambda: fa.flash_forward(q, k, v, bq, bk), 20),
        "flash_bwd_dq": event_ms(lambda: fa._launch_bwd_dq(*args, v_dq), 10),
        "flash_bwd_dkv": event_ms(lambda: fa._launch_bwd_dkv(*args, v_dkv), 10),
    }
    if any(c.count == b for c, b in zip(flash_counters().values(), before)):
        raise SystemExit("timing loop never launched the flash kernels")
    plain_fwd = event_ms(lambda: fa.flash_forward_plain(q, k, v, bq, bk), 3, 1)
    plain_bwd = event_ms(lambda: fa.flash_backward_plain(q, k, v, out, lse, do, bq, bk), 3, 1)
    q4, k4, v4, do4 = (t.view(B, H, T, C) for t in (q, k, v, do))
    sdpa_fwd = event_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = event_ms(lambda: torch.autograd.grad(o4, (qg, kg, vg), do4, retain_graph=True), 10)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}
    return ms, plain, library


FLASH_SOURCES = {  # the TPU body each kernel replaces on the main path (all: csrc header)
    "flash_fwd": "midgpt_tpu/kernels/flash_attention.py:126",
    "flash_bwd_dq": "midgpt_tpu/kernels/flash_attention.py:265",
    "flash_bwd_dkv": "midgpt_tpu/kernels/flash_attention.py:265",
}


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
    t_start = time.perf_counter()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    paths = build.build(KERNEL_SOURCES)
    print(f"built {len(paths)} kernel source(s) in {time.perf_counter() - t0:.1f} s: {[p.name for p in paths.values()]}")
    for src, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # 3. kernels vs plain
    errs = {(dt, s): check_kernel(dt, s) for dt in (torch.bfloat16, torch.float32) for s in (1, 2)}
    for s in (1, 2):
        check_kernel(torch.float32, s, kv_dtype=torch.bfloat16)
    flash_errs = {}
    for label, B, H, T, C, bq, bk, dt in FLASH_CHECKS:
        flash_errs[(label, dt)] = check_flash(label, B, H, T, C, bq, bk, dt)
        free_memory()

    # 4. the serving main path, bf16: counters zeroed just before, read just after
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

    # 5. f32: kernel and gather streams identical; decode busy share
    _, kernel_streams, _ = serve(cfg, params32, torch.float32, attn_impl="auto")
    _, gather_streams, _ = serve(cfg, params32, torch.float32, attn_impl="gather")
    for i, (a, b) in enumerate(zip(kernel_streams, gather_streams)):
        if not np.array_equal(a, b):
            first = int(np.argmax(a != b))
            raise SystemExit(f"f32 request {i}: kernel and gather streams differ from token {first}")
    print(f"f32 greedy streams identical, kernel vs gather: {len(kernel_streams)} requests")
    wall_us, by_name = profile_decode(cfg, params16)
    print_busy("decode rounds", wall_us, by_name, card)
    del params32, params16
    free_memory()

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp)
        synthetic_stream(data_dir, load_config("local_text_124m").model_config.vocab_size)
        # 6. the training main path: counters zeroed just before, read just after
        flash_launches, train_tok_s, train_mfu, _ = train_main_path(data_dir, card)
        free_memory()
        # 7-9. parity, the tiled dispatch, where a training step's time goes
        train_parity(data_dir, card)
        train_tiled(data_dir)
        free_memory()
        profile_train(data_dir, card)
        free_memory()

    # 10. timings
    kernels = []
    for dt in (torch.bfloat16, torch.float32):
        for s in (1, 2):
            ms, eager_ms, plain_ms, lib_ms = time_kernel(dt, s)
            b_ms, b_by = bound_ms(dt)
            print(f"paged_attention_decode {str(dt)[6:]} split_k={s}: {ms:.4f} ms device (graph replay, cold L2; "
                  f"{eager_ms:.4f} ms per eager call with host) bound {b_ms:.4f} ms by {b_by}, "
                  f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms on {card}")
            if dt == torch.bfloat16:  # the serving path's dtype: one entry per launch variant
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
    free_memory()
    from midgpt_tpu_torch.kernels import flash_attention as fa

    for label, B, H, T, C, bq, bk in FLASH_TIMED:  # the main path's shape first
        f_ms, f_plain, f_lib = time_flash(B, H, T, C, bq, bk)
        free_memory()
        bounds = flash_bounds(B, H, T, C, torch.bfloat16)
        variants = fa._variants(T, fa._block_sizes(T, bq, bk)[1])
        for kname, variant in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), variants):
            b_ms, b_by = bounds[kname]
            lib_what = "sdpa forward" if kname == "flash_fwd" else "sdpa backward (dq, dk and dv in one call)"
            print(f"{kname} [{variant}] {label} bf16 B={B} H={H} T={T} C={C} blocks=({bq},{bk}): "
                  f"{f_ms[kname]:.4f} ms device, bound {b_ms:.4f} ms by {b_by} ({f_ms[kname] / b_ms:.1f}x), "
                  f"plain {f_plain[kname]:.3f} ms, {lib_what} {f_lib[kname]:.4f} ms on {card}")
        if label == FLASH_MAIN[0]:
            main_ms, main_plain, main_lib, main_bounds = f_ms, f_plain, f_lib, bounds
    _, B, H, T, C, bq, bk = FLASH_MAIN
    print(f"main path: {cfg.n_layer} launches of each flash kernel per microstep, {cfg.n_layer * 16} per "
          f"local_text_124m step (G=16), plus {cfg.n_layer} forward launches per eval batch")
    main_errs = flash_errs[(FLASH_MAIN[0], torch.bfloat16)]
    err_of = {"flash_fwd": main_errs["out"], "flash_bwd_dq": main_errs["dq"],
              "flash_bwd_dkv": max(main_errs["dk"], main_errs["dv"])}
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        b_ms, b_by = main_bounds[kname]
        kernels.append({
            "name": f"{kname}[bf16,C={C}]",
            "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_SOURCES[kname],
            "launches": sum(flash_launches[kname].values()),
            "max_abs_err": err_of[kname],
            "ms": main_ms[kname],
            "plain_ms": main_plain[kname],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": main_lib[kname],
        })
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(card)  # exactly as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
