#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (midgpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port still starts on the card. Phases, in
order; any failure ends the run with a non-zero exit (nothing is caught):

  1. require CUDA and the port's sources beside this script; print the
     card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from midgpt_tpu_torch/csrc (one
     nvcc per source, all started together; ptxas report printed: each
     instantiation's registers and spills, the paged template's
     tensor-core, SIMT and merge kernels among them);
  3. hold each kernel against its plain PyTorch version:
     a. paged decode at the serving shapes — 4 slots, 12 heads of 64, pages
        of 8, a 128-page bucket, counts [1024, 700, 300, 1] — in bf16 and
        f32, split 1 and 2, and an f32 query over bf16 pools; the merge
        kernel against merge_partials + finalize on partials of that shape
        (every third partition neutral), bf16 and f32 outputs;
     b. flash attention forward (out, lse) and backward (dq, dk, dv from
        one seeded upstream gradient) at the training main path's shape
        (B 16, H 12, T 1024, C 64, blocks (512, 1024)) in bf16 and f32, at
        llama7b_long's head shape (B 1, H 32, T 4096, C 128, blocks
        (512, 1024): the tiled dispatch), at T 2048 with one KV block
        (blocks (512, 2048): the single-visit dQ with the tiled dK/dV), at
        a ragged T (T 200, blocks (64, 64): the KV block widens to T, rows
        past T zero-filled) and with chunks narrower than the kernel's
        64-column tile (T 96, C 128, blocks (32, 32)), those two in bf16
        and f32; then two launches of each kernel on the main path's bf16
        inputs, bit for bit (no atomics);
     c. the paged template's verify spec (R = 2, 5 and 9 rows per slot, the
        last row's count the phase-3a count, the count-1 slot inactive) and
        its int8 spec (int8 pools with f32 scales; decode and verify R = 5)
        at the phase-3a shape, bf16 and f32 queries, split 1 and 2, and one
        verify launch row by row against decode launches (bit for bit);
     d. the template's GQA fold and sliding window at the serving main
        path's GQA geometry (the phase-3a slots and counts, 12 query heads
        over 3 K/V heads of 64) and at llama7b_long's (32 query heads over 8
        K/V heads of 128, counts up to 4096 in a 512-page bucket): decode and
        verify (R 5 and 9, i.e. 20 and 36 folded rows per K/V head), with no
        window and with a 256-token window + 4 sinks, bf16 queries over bf16
        and int8 pools and f32 queries over f32, bf16 and int8 pools, split
        1 and 2, each launch counted under its spec; then, bit for bit, a window at least every count against
        no window, and every row of a GQA verify launch against the GQA
        decode launch at that row's count;
  4. serving main path: the port's ServeEngine at openwebtext width (GPT-2
     small, random weights from a seed, bf16) serves a mixed trace with
     max_slots=4 — short requests (split-1 rounds) and one longer than 512
     tokens (split-2 rounds). Launch counters are zeroed just before and
     read just after; every request must finish with its token budget,
     both splits must have launched, launches must equal n_layer x
     decode steps, and the merge kernel must have launched once per
     template call;
  5. the same trace in f32 through the kernel and through the gather
     lowering: the greedy streams must be identical; then the device busy
     share of steady bf16 decode rounds under torch.profiler;
  4b. (run after phase 5, whose f32 streams it is held to) the decode
     loop's overlap modes: phase 4's trace and engine in bf16 with
     overlap off (eager rounds), group:1, group:4 and double (CUDA-graph
     replays of the fused decode group, one graph per static key), each
     served twice on one engine — the first pass captures, the second
     only replays. Counters zeroed just before and read just after: every
     request finishes with its budget, every page comes home, template and
     merge launches equal n_layer x device steps (masked group steps and
     one masked warm-up step per captured graph included), no key is
     captured twice and the second pass captures nothing. Greedy bf16
     streams identical across the modes (a departure only at a top-2 gap
     under 1e-5 relative, as in 5b), f32 streams of every mode identical
     to phase 5's kernel and gather streams. Tokens/s per mode (in rounds
     and end to end, second pass; first pass end to end beside it) and
     the device busy share of steady group:4 rounds beside phase 5's
     eager rounds;
  5b. speculative serving at local_text_124m width (its default 4-layer
     self-draft on the target's pool, spec_k_max 4, adaptive k), the same
     trace and engine shape as phase 4, in bf16 and then on an int8 pool,
     plus the same engine without a draft for the throughput beside it.
     Counters zeroed just before each run and read just after: verify
     launches must equal n_layer x verify rounds, decode-spec launches
     4 x draft steps (+ n_layer x plain decode steps), the int8 run must
     launch only int8 specs; every request must finish with its budget.
     Then `python -m midgpt_tpu_torch.sample --config=local_text_124m`
     (its `main`, config defaults: the self-draft) must launch the verify
     spec. Greedy f32 streams: speculative through the kernel identical to
     speculative through the gather; speculative identical to plain decode
     through the kernel, and int8 speculative to int8 plain; then the
     target's own weights as a separate draft (its own pool), which must
     have nearly every proposal accepted and stream as plain decode. Where
     a stream departs from plain decode, the run prints the position and
     the top-2 logit gap there (dense f32 forward) and fails unless the gap
     is under 1e-5 relative (a last-bit difference of cuBLAS between the
     verify forward's k+1 rows per slot and decode's one);
  5c. the GQA and sliding-window slice: the launcher trains local_text_124m
     at full width as `gqa` (`--set model_config.n_kv_heads=3`, phase 6's
     cuts; flash launches counted as there) and as `gqa_window` (plus a
     256-token window, 4 sinks and blockwise attention; 2 steps), every
     loss finite, each run's final checkpoint step verified and its
     params.npz carrying wkv. `sample.main
     --ckpt_dir` serves each run (gqa: its config's self-draft, which must
     launch only the GQA verify and decode specs; gqa_window with
     --spec_layers 0: only the windowed GQA decode spec). The gqa run's
     weights serve phase 4's trace with the self-draft (verify launches =
     n_layer x rounds); the gqa_window run's weights serve it in bf16
     without a draft: launches = n_layer x decode steps, all of the
     windowed GQA decode spec at splits 1 and 2, pages reclaimed behind
     the window (> 0) and no slot ever holding more than sink pages +
     window pages + 2; the same in overlap="double" (CUDA-graph replays,
     reclamation a round late inside the settle) on the bf16 and the int8
     pool; then in f32 (kernel streams == gather streams), with the
     self-draft and on an int8 pool, each launching only its windowed GQA
     specs;
  6. training main path: `python -m midgpt_tpu_torch.launch
     --config=local_text_124m` (its `main`, in this process) at full width
     — 12 x 768, 12 heads, T 1024, microbatch 16, vocab 50304, bf16
     compute over f32 master params — on a seeded synthetic uint16 stream
     written to a temporary directory, with the cuts printed as "reduced".
     Flash counters are zeroed just before and read just after: forward
     launches must equal n_layer x (microsteps + eval batches), each
     backward kernel's n_layer x microsteps; every loss must be finite and
     the final step's checkpoint verified;
  6b. checkpoints and resume on that path (cuts: G 2, 6 steps, an eval and
     a save every 2 steps, one eval batch): a round trip (one step, a copy
     of the state on the card, a save, two more in-place steps, a restore
     that must equal the copy bit for bit: params, mu, nu, both counts);
     a straight launcher run (saves at 0, 2, 4 and the final 5); a second
     launcher as a subprocess into a fresh run directory, SIGKILLed as soon
     as step 4's save has begun (step 2 verified); a relaunch into that
     directory must resume from step 2, launch the flash kernels n_layer x
     (microsteps + eval batches) / n_layer x microsteps times for steps
     3-5, and equal the straight run bit for bit: logged losses, eval
     losses and the final checkpoint (else two straight runs set the
     spread it is held to); `sample.main --ckpt_dir` must restore its
     final step and launch the decode spec. Printed: bytes per
     checkpoint, the loop's stall per save, the background write and hash
     time, restore time, tokens/s of log intervals with and without a
     save. Every run directory but the straight run's is deleted;
  6c. the supervised trainer (robustness/), on 6b's cuts, each run held to
     6b's straight run, the launcher's flash launches counted per run:
     (d) an armed 60 s watchdog: losses and the final checkpoint bit for
     bit, tokens/s of steps 2-3 beside the unarmed run, the guarded syncs
     timed; (a) `fault_plan=nan_grad@3`: one rollback to step 2, window
     [3, 3] skipped, offset 1 (JAX's formula), a finite final loss, the
     ledger on disk, the rollback's seconds (the flight recorder's
     divergence instant to the next attempt's first step) and
     torch.cuda.memory_allocated before and after (the failed attempt's
     state must not outlive the run); (b) `hang_step@3` under a watchdog
     three times the longest sync of (d) (at least 2 s): hung_steps [3],
     offset 0, the flight recorder dumped, the replay bit for bit the
     straight run; (c) a launcher subprocess (saves at step 0 only,
     preempt_grace_s 30) sent SIGTERM once step 2 is logged: exit code 0,
     the newest verified step the boundary it printed, `train.preempt` in
     its dumped flight recorder, the seconds from SIGTERM to exit; the
     relaunch resumes there and is bit for bit the straight run. All run
     directories are deleted. The serving half, (e), runs after phase 5b
     on phase 4's weights and trace: `kill_mid_decode@3` ("off"),
     `kill_overlapped_round@3` ("double") and `poisoned_page@3` ("off"), in
     f32 (streams == the unfaulted run's but the poisoned slot's, a
     departure allowed only at a near-tie) and in bf16 (printed only: the
     re-prefill rounds its products otherwise than decode did); each fault
     fires once, pages conserved, launches == n_layer x device steps;
     `obs=Observability()` under group:4 (streams == phase 4b's, the round
     decomposition and tokens/s beside obs off); an armed 60 s watchdog
     under "double" (streams == phase 4b's, no expiry);
  7. parity on the card: training steps through the flash kernels against
     the same steps through the dense (naive) attention, same params and
     batches — f32 at full width and 2 layers (losses and the parameter
     update), bf16 at full depth (the loss);
  8. the tiled dispatch through the trainer (attn_block_size 512, 2
     layers): all three kernels must launch as "tiled";
  9. torch.profiler over one training microstep at the main path's shape:
     the device's busy and idle share, the kernels with the most device
     time, and the flash kernels' share beside the SIMT kernels' share;
 10. timings: the paged decode kernel as before (CUDA-graph replay, cold
     L2), and each flash kernel in bf16 (CUDA events over repeated
     launches) at the main path's shape and at one shape per other
     dispatch (the main path at attn_block_size 512, and the two other
     shapes of phase 3b with 2 KV blocks or more), beside its plain
     version, its bound (the larger of the bytes it must move over 3.35
     TB/s and its causal FLOPs over the dense peak of the inputs' type),
     the time of its earlier SIMT version, its achieved TFLOP/s (those
     causal FLOPs over its time) and, as a yardstick the port never
     calls, torch's scaled_dot_product_attention forward and backward
     (the factor: the forward over SDPA's forward, the backward pair over
     SDPA's backward); the verify (R 5) and int8 (decode, verify R 5) kernels as
     the decode kernel, beside their plain versions, their bounds and SDPA
     over pre-gathered K/V with an R-row mask; the GQA decode, GQA verify
     (R 5) and windowed GQA decode specs at the main path's GQA geometry
     the same way (bound: the K/V of the keys some row sees, at the K/V
     head count; SDPA over K/V gathered and repeated to the query heads,
     the window in its mask). Each paged spec's time is printed beside the
     earlier single-kernel version's (one block per K/V head and caller's
     partition) and, at split 1, against its limit (bf16: the larger of a
     third of the earlier time and SDPA's; f32 decode: the earlier time).
     Then the merge kernel alone at the decode shape (graph replay, cold
     L2), beside its plain version and its bound (the partials' bytes over
     3.35 TB/s). The "kernels" line carries the main paths' numbers.

The last lines are the card's name and power limit as nvidia-smi prints
them, one JSON object with a "kernels" list and phase 4b's "decode_modes"
(tokens/s and busy share per overlap mode), and the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
L2_BYTES = 50 * 2**20  # H100 SXM L2
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / f32 non-tensor
SLOTS, HEADS, HEAD_DIM, PAGE, BUCKET = 4, 12, 64, 8, 128
COUNTS = [1024, 700, 300, 1]
VERIFY_ROWS = (2, 5, 9)  # phase 3c: k+1 rows per slot (spec_k_max 4 here, 8 in llama7b_32k)
TIMED_ROWS = 5  # phase 10: the verify spec at spec_k_max 4
SPEC_DRAFT_LAYERS = 4  # local_text_124m's spec_layers
# phase 10: each paged spec's bf16 times of the earlier single-kernel
# version (one block per K/V head and caller's partition; PERF.md, table of
# TPU kernels), ms at split 1 and 2; f32 decode
PAGED_EARLIER_MS = {
    "decode": (0.0512, 0.0498), "f32 decode": (0.0496, 0.0528), "verify": (0.1753, 0.1195),
    "int8-decode": (0.0561, 0.0574), "int8-verify": (0.1831, 0.1234), "gqa-decode": (0.1393, 0.1000),
    "gqa-verify": (0.6092, 0.3415), "window-gqa-decode": (0.0421, 0.0703),
}
GAP_TOL = 1e-5  # relative top-2 logit gap below which a spec/plain departure is a near-tie
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
KERNEL_SOURCES = ("paged_attention", "flash_attention")
# flash checks: (label, B, H, T, C, block_q, block_k, dtype)
FLASH_MAIN = ("main path", 16, 12, 1024, 64, 512, 1024)
FLASH_CHECKS = [
    (*FLASH_MAIN, torch.bfloat16),
    (*FLASH_MAIN, torch.float32),
    ("llama7b_long head", 1, 32, 4096, 128, 512, 1024, torch.bfloat16),
    ("T 2048, one KV block", 2, 12, 2048, 64, 512, 2048, torch.bfloat16),
    *((label, 2, 12, T, C, bq, bk, dt)
      for label, T, C, bq, bk in (("ragged T", 200, 64, 64, 64), ("chunks narrower than a tile", 96, 128, 32, 32))
      for dt in (torch.bfloat16, torch.float32)),
]
# flash timings (bf16): the main path, then one shape per other dispatch
FLASH_TIMED = [
    FLASH_MAIN,
    ("main path at attn_block_size 512", 16, 12, 1024, 64, 512, 512),
    *(check[:7] for check in FLASH_CHECKS[2:4]),
]
# each FLASH_TIMED shape's bf16 times of the earlier SIMT kernels (f32 FMAs;
# PERF.md, table of TPU kernels), ms: forward, dQ, dK/dV
FLASH_SIMT_MS = dict(zip((shape[0] for shape in FLASH_TIMED), (
    (1.713, 1.799, 2.397), (1.711, 1.804, 2.375), (8.627, 10.959, 15.144), (0.842, 0.868, 1.144))))
# targets at the main path's shape: 4x faster than the SIMT kernels, ms
FLASH_TARGET_MS = {"flash_fwd": 0.43, "flash_bwd_dq": 0.45, "flash_bwd_dkv": 0.60}
# phase 9's microstep with the SIMT flash kernels (PERF.md §5): wall ms,
# flash share of the device time in %
SIMT_MICROSTEP = (168.7, 43.6)
# training main path: the cuts of local_text_124m, printed as "reduced"
TRAIN_CUTS = {"g_accum_iters": 2, "max_steps": 4, "eval_steps": 1, "eval_interval": 1000}
# phase 6b: the checkpoint and resume runs' cuts (saves at 0, 2, 4 and the final step 5)
RESUME_CUTS = {"g_accum_iters": 2, "max_steps": 6, "eval_steps": 1, "eval_interval": 2}
# parity tolerances (printed): f32 losses relative, f32 update relative
# norm, bf16 loss relative (dense attention rounds its scores to bf16)
PARITY_TOL = {"f32_loss": 1e-5, "f32_update": 1e-3, "bf16_loss": 1e-2}
# phase 3d: (slots, query heads, K/V heads, head_dim, bucket, counts) of the
# serving main path's GQA variant and of llama7b_long's attention
GQA_GEOMETRIES = {
    "main": (SLOTS, HEADS, 3, HEAD_DIM, BUCKET, COUNTS),
    "llama7b_long": (SLOTS, 32, 8, 128, 512, [4096, 2900, 1200, 1]),
}
GQA_ROWS = (1, 5, 9)  # decode, then verify at spec_k_max 4 and 8 (20 and 36 folded rows)
WINDOW, SINKS = 256, 4  # the gqa_window variant's sliding_window and attn_sinks
# phase 5c: the slice's two variants of local_text_124m, as launcher --set overrides
GQA_VARIANTS = {
    "gqa": {"model_config.n_kv_heads": 3},
    "gqa_window": {"model_config.n_kv_heads": 3, "model_config.sliding_window": WINDOW,
                   "model_config.attn_sinks": SINKS, "model_config.attn_impl": "blockwise"},
}


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
    got = tpl.paged_attention_template(q[:, :, None], k, v, table, counts[:, None], split_k=split_k)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, counts[:, None], split_k=split_k)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) and got.dtype == dtype
    label = str(dtype)[6:] + ("" if kv_dtype is None else f" over {str(kv_dtype)[6:]} pools")
    print(f"kernel check paged decode {label} split_k={split_k}: max_abs_err={err:.3e} "
          f"(tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise SystemExit(f"paged decode kernel disagrees with its plain version ({label}, split {split_k})")
    return err


def merge_problem(dtype, seed=0):
    """Phase-3a merge inputs: raw partials as the partition kernel writes
    them at the serving main path's decode shape (4 slots, 12 heads, 1 row,
    C 64, a 128-page bucket cut into partitions), every third partition
    neutral (M_INIT, 0, 0), as a partition past a slot's count is."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.ops.online_softmax import M_INIT

    n_parts = BUCKET // tpl.partition_pages(BUCKET, 1, PAGE, HEAD_DIM, dtype, dtype)
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(SLOTS, n_parts, HEADS, 1, generator=g) * 4
    l = torch.rand(SLOTS, n_parts, HEADS, 1, generator=g) * 8 + 0.5
    acc = torch.randn(SLOTS, n_parts, HEADS, 1, HEAD_DIM, generator=g)
    m[:, 2::3], l[:, 2::3], acc[:, 2::3] = M_INIT, 0.0, 0.0
    return [t.cuda() for t in (m, l, acc)]


def check_merge(dtype):
    """Phase 3a: the merge kernel vs merge_partials + finalize on the same
    partials; returns max |err|."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.ops.online_softmax import finalize, merge_partials

    m, l, acc = merge_problem(dtype)
    got = tpl.merge_partitions(m, l, acc, dtype)
    torch.cuda.synchronize()
    want, _ = finalize(*merge_partials(m, l, acc, axis=1))
    want = want.to(dtype)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) and got.dtype == dtype
    print(f"kernel check paged merge {str(dtype)[6:]} ({m.shape[1]} partitions, every third neutral): "
          f"max_abs_err={err:.3e} (tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"paged merge kernel disagrees with its plain version ({dtype})")
    return err


def time_merge(dtype=torch.bfloat16):
    """Phase 10: device ms of the merge kernel alone at the decode shape
    (graph replay, cold L2: one call per copy of the partials, the copies
    together 1.5x the L2, so each call reads its partials from memory, as
    the bound's memory rate assumes; on the main path they come from the
    partition kernel's writes and may still sit in the L2), its plain
    version (eager), and its bound: the partials read once and the output
    written once over 3.35 TB/s."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.ops.online_softmax import finalize, merge_partials

    base = merge_problem(dtype, seed=1)
    copies = -(-3 * L2_BYTES // (2 * sum(4 * t.numel() for t in base)))
    probs = [base] + [[t.clone() for t in base] for _ in range(copies - 1)]
    before = tpl.MERGE_LAUNCHES.count
    ms = graph_ms([lambda p=p: tpl.merge_partitions(*p, dtype) for p in probs], per_graph=copies)
    m, l, acc = probs[0]
    plain_ms = event_ms(lambda: finalize(*merge_partials(m, l, acc, axis=1))[0].to(dtype), 20, 3)
    if tpl.MERGE_LAUNCHES.count == before:
        raise SystemExit("timing loop never launched the merge kernel")
    item = torch.empty((), dtype=dtype).element_size()
    moved = 4 * (acc.numel() + m.numel() + l.numel()) + SLOTS * HEADS * HEAD_DIM * item
    return ms, plain_ms, moved / HBM_BYTES_PER_S * 1e3, m.shape[1]


def paged_vs_earlier(spec, split_k, ms, sdpa_ms):
    """The spec's time beside the earlier version's and, at split 1,
    against its limit: the larger of a third of the earlier time and SDPA's
    time in this call (f32 decode: the earlier time)."""
    earlier = PAGED_EARLIER_MS[spec][split_k - 1]
    text = f"earlier version {earlier:.4f} ms ({earlier / ms:.1f}x faster)"
    if split_k == 1:
        limit = earlier if spec.startswith("f32") else max(earlier / 3, sdpa_ms)
        text += f", limit {limit:.4f} ms {'met' if ms <= limit else 'MISSED'}"
    return text


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
        return lambda: tpl.paged_attention_template(q[:, :, None], k, v, table, counts[:, None], split_k=split_k)

    def sdpa(p):
        q, k, v, table, counts = p
        kg, vg = _gather_pages(k, None, table).contiguous(), _gather_pages(v, None, table).contiguous()
        mask = (torch.arange(kg.shape[2], device=q.device)[None, :] < counts[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask)

    before = tpl.LAUNCHES.count
    ms = graph_ms([call(p) for p in probs])
    eager_ms = event_ms(call(probs[0]), 200, 10)
    q, k, v, table, counts = probs[0]
    plain_ms = event_ms(
        lambda: tpl.paged_attention_template_plain(q[:, :, None], k, v, table, counts[:, None], split_k=split_k), 3, 1
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


def profile_decode(model_cfg, params, rounds: int = 3, warm: int = 2, **engine_kw):
    """Device busy share of steady decode rounds (4 slots decoding) under
    torch.profiler: the sum of kernel times over the wall time of the
    window, and the kernels that took the most device time. `warm` steps
    run first (prefill and the first decode rounds, with every CUDA-graph
    capture of an overlap mode: none may fall inside the window)."""
    from torch.profiler import ProfilerActivity, profile

    from midgpt_tpu_torch.sampling.serve import ServeEngine

    eng = ServeEngine(model_cfg, params, max_slots=4, page_size=PAGE, prefill_chunk=256,
                      decode_chunk=8, cache_dtype=params["wte"].dtype, device="cuda", **engine_kw)
    rng = np.random.default_rng(1)
    for _ in range(4):
        eng.submit(rng.integers(0, model_cfg.vocab_size, 64).astype(np.int32),
                   8 * eng.round_group * (rounds + 3))
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    captured = eng.stats()["decode_graphs"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if captured is not None and eng.stats()["decode_graphs"]["captured"] != captured["captured"]:
        raise SystemExit("a CUDA graph was captured inside the profiled window")
    return wall_us, device_time_by_kernel(prof)


def print_busy(what, wall_us, by_name, card, top=6):
    """Print the busy share and the top kernels; returns the busy share
    (None: not measured)."""
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"{what} device busy share: not measured (the profiler saw no device activity)")
        return None
    print(f"{what} under torch.profiler: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%) on {card}")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:8.3f} ms  {kname[:110]}")
    paged = {kind: sum(us for kname, us in by_name.items() if marker in kname)
             for kind, marker in (("partition", "paged_attention_tc"), ("SIMT partition", "paged_attention_simt"),
                                  ("merge", "paged_attention_merge"))}
    if any(paged.values()):
        print(f"  paged-attention kernels: {sum(paged.values()) / 1e3:.3f} ms of {busy_us / 1e3:.2f} ms device ("
              + ", ".join(f"{kind} {us / 1e3:.3f} ms" for kind, us in paged.items()) + ")")
    return busy_us / wall_us


def trace(vocab: int):
    """Six requests: four short ones first (split-1 rounds), then one whose
    span passes 512 tokens (split-2 rounds while it decodes), then one more
    short one."""
    rng = np.random.default_rng(0)
    shape = [(24, 48), (40, 40), (16, 64), (30, 32), (600, 48), (8, 24)]
    return [(rng.integers(0, vocab, n).astype(np.int32), m) for n, m in shape]


def serve(model_cfg, params, dtype, attn_impl="auto", watch=None, **engine_kw):
    """Serve the trace on a new engine; `watch(eng)`, if given, runs after
    every step. Returns the engine's stats, the streams and the wall time."""
    eng = new_engine(model_cfg, params, dtype, attn_impl, **engine_kw)
    streams, wall = serve_trace(eng, watch)
    return eng.stats(), streams, wall


def new_engine(model_cfg, params, dtype, attn_impl="auto", **engine_kw):
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    return ServeEngine(
        model_cfg, params, max_slots=4, page_size=PAGE, prefill_chunk=256,
        decode_chunk=8, temperature=0.0, cache_dtype=dtype, attn_impl=attn_impl,
        device="cuda", **engine_kw,
    )


def serve_trace(eng, watch=None):
    """Serve the trace once more on `eng`: every request must finish with
    its budget and every page come home. Returns (streams, wall s)."""
    model_cfg = eng.config
    reqs = trace(model_cfg.vocab_size)
    uids = [eng.submit(p, m) for p, m in reqs]
    t0 = time.perf_counter()
    while not eng.idle:
        eng.step()
        if watch is not None:
            watch(eng)
    done = eng.finished
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
    return streams, wall


# ---------------------------------------------------------------- overlap modes (CUDA-graph replays)

OVERLAP_MODES = ("off", "group:1", "group:4", "double")


def device_steps(stats):
    """Decode steps the device ran: the dispatched ones (a fused group's
    masked steps included) plus one masked warm-up step per captured
    CUDA graph."""
    graphs = stats["decode_graphs"]
    return stats["decode_steps"] + (0 if graphs is None else graphs["warmup_steps"])


def overlap_serving(card, cfg, params32, params16, kernel_streams, gather_streams):
    """Phase 4b. Returns {mode: (decode tokens/s, end-to-end tokens/s)} of
    the bf16 runs' second pass (every graph already captured), and the bf16
    streams by mode."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.sampling.serve import parse_overlap

    total = sum(m for _, m in trace(cfg.vocab_size))
    rates, streams16 = {}, {}
    for spec in OVERLAP_MODES:
        overlap, round_group = parse_overlap(spec)
        eng = new_engine(cfg, params16, torch.bfloat16, overlap=overlap, round_group=round_group)
        tpl.LAUNCHES.reset()
        tpl.MERGE_LAUNCHES.reset()
        streams16[spec], wall1 = serve_trace(eng)  # captures each key's graph at its first dispatch
        st1 = eng.stats()
        again, wall = serve_trace(eng)  # the same trace again: replays only
        st = eng.stats()
        launches, merges = tpl.LAUNCHES.count, tpl.MERGE_LAUNCHES.count
        steps, graphs = device_steps(st), st["decode_graphs"]
        tokens, seconds = (st[k] - st1[k] for k in ("decode_tokens", "decode_seconds"))
        rates[spec] = (tokens / seconds, total / wall)
        print(f"overlap {spec} bf16, second pass: decode {rates[spec][0]:.1f} tokens/s ({tokens} tokens, "
              f"{seconds:.3f} s from dispatch to settle), end to end {rates[spec][1]:.1f} tokens/s ({total} tokens "
              f"in {wall:.3f} s; first pass, captures included: {total / wall1:.1f} tokens/s in {wall1:.3f} s); "
              f"{st['rounds'] - st1['rounds']} rounds; both passes: device steps {steps} ({st['decode_steps']} "
              f"dispatched) x {cfg.n_layer} layers = {cfg.n_layer * steps}, template launches {launches}, merge "
              f"launches {merges}, splits {st['split_rounds']}; graphs {graphs} on {card}")
        if launches != cfg.n_layer * steps or merges != launches:
            raise SystemExit(f"overlap {spec}: launches != n_layer x device steps: a step bypassed the kernels")
        if (graphs is None) != (overlap == "off") or (graphs is not None and graphs["replays"] < 1):
            raise SystemExit(f"overlap {spec}: an overlap mode must replay CUDA graphs, 'off' must run eagerly")
        if graphs is not None and (set(graphs["captures_per_key"]) != {1}
                                   or graphs["captured"] != st1["decode_graphs"]["captured"]):
            raise SystemExit(f"overlap {spec}: a key was captured twice, or the second pass captured: {graphs}")
        compare_streams(f"bf16 overlap {spec}, second pass vs first", again, streams16[spec])
    for spec in OVERLAP_MODES[1:]:
        compare_streams(f"bf16 overlap {spec} vs off", streams16[spec], streams16["off"], cfg, params16)
    for spec in OVERLAP_MODES[1:]:
        overlap, round_group = parse_overlap(spec)
        _, streams, _ = serve(cfg, params32, torch.float32, overlap=overlap, round_group=round_group)
        compare_streams(f"f32 overlap {spec} vs off (kernel)", streams, kernel_streams)
        compare_streams(f"f32 overlap {spec} vs off (gather)", streams, gather_streams)
    return rates, streams16


# ---------------------------------------------------------------- verify and int8 specs


def verify_problem(qdtype, R, int8, seed=0):
    """Phase-3c inputs: the phase-3a problem with R query rows per slot —
    row t sees COUNTS - (R - 1) + t keys, so the last row's count is the
    phase-3a count, and the count-1 slot stays inactive (1 key on every
    row) — over pools of the query's dtype, or int8 codes with their
    (num_pages, H, page_size) f32 scales, quantized from the same values."""
    from midgpt_tpu_torch.ops.quant import quantize_q8

    _, k, v, table, counts = decode_problem(torch.float32, seed)
    q = torch.randn(SLOTS, HEADS, R, HEAD_DIM, generator=torch.Generator().manual_seed(seed + 100)).to("cuda", qdtype)
    t = torch.arange(R, device="cuda")
    rows = torch.where(counts[:, None] > 1, counts[:, None] - (R - 1) + t, 1).to(torch.int32)
    if int8:
        (k, ks), (v, vs) = (quantize_q8(x.transpose(0, 1)) for x in (k, v))  # per (page, head, position)
        return q, k.transpose(0, 1).contiguous(), v.transpose(0, 1).contiguous(), ks, vs, table, rows
    return q, k.to(qdtype), v.to(qdtype), None, None, table, rows


def spec_label(qdtype, R, int8):
    from midgpt_tpu_torch.kernels import attention_template as tpl

    pools = "int8" if int8 else str(qdtype)[6:]
    return f"{tpl.spec_name(R, int8)} R={R} {str(qdtype)[6:]} query over {pools} pools"


def check_spec_kernel(qdtype, R, int8, split_k):
    """Phase 3c: the verify / int8 spec of the kernel vs the plain version on
    the same inputs; returns max |err|."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    q, k, v, ks, vs, table, counts = verify_problem(qdtype, R, int8)
    got = tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q, k, v, table, counts, ks, vs, split_k=split_k)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[qdtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) and got.dtype == qdtype
    label = spec_label(qdtype, R, int8)
    print(f"kernel check paged {label} split_k={split_k}: max_abs_err={err:.3e} (tol {tol:g} abs+rel) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise SystemExit(f"paged {label} kernel disagrees with its plain version (split {split_k})")
    return err


def check_rows_bitwise(int8, split_k, R=9):
    """Phase 3c: one verify launch equals, row by row and bit for bit, the
    decode launches at each row's count — a row's arithmetic does not
    depend on R."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    q, k, v, ks, vs, table, counts = verify_problem(torch.bfloat16, R, int8, seed=7)
    rows = tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k)
    for t in range(R):
        one = tpl.paged_attention_template(q[:, :, t : t + 1].contiguous(), k, v, table,
                                           counts[:, t : t + 1].contiguous(), ks, vs, split_k=split_k)
        if not torch.equal(rows[:, :, t], one[:, :, 0]):
            raise SystemExit(f"verify row {t} differs from the decode launch at its count "
                             f"({'int8' if int8 else 'bf16'} pools, split {split_k})")
    print(f"kernel check verify R={R} rows == decode launches bit for bit "
          f"({'int8' if int8 else 'bf16'} pools, split_k={split_k}): ok")


def spec_bound_ms(qdtype, R, int8, counts):
    """(least ms the card could take for one launch at the phase-3c shape,
    what bounds it): K and V over the last row's count keys (each read once;
    int8 codes plus one f32 scale per key, head and tensor), q in and out
    over R rows, the table and counts; against 4 flops per (row, visible
    key, channel), plus the dequantizing multiply of each K/V value."""
    item_q = torch.empty((), dtype=qdtype).element_size()
    keys = int(counts[:, -1].sum())
    kv = 2 * keys * HEADS * (HEAD_DIM * (1 if int8 else item_q) + (4 if int8 else 0))
    moved = kv + 2 * SLOTS * HEADS * R * HEAD_DIM * item_q + SLOTS * BUCKET * 4 + SLOTS * R * 4
    flops = 4 * int(counts.sum()) * HEADS * HEAD_DIM + (2 * keys * HEADS * HEAD_DIM if int8 else 0)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[qdtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_spec_kernel(qdtype, R, int8, split_k):
    """Phase 10 at the phase-3c shape: device ms of the kernel's wrapper and
    of the SDPA yardstick (graph replay over copies that together exceed
    the L2, so every call finds its data cold), the plain version (eager),
    and the bound."""
    import torch.nn.functional as F

    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.kernels.decode_attention import _gather_pages

    copies = 24 if int8 else 12
    probs = [verify_problem(qdtype, R, int8, seed=1 + i) for i in range(copies)]

    def call(p):
        q, k, v, ks, vs, table, counts = p
        return lambda: tpl.paged_attention_template(q, k, v, table, counts, ks, vs, split_k=split_k)

    def sdpa(p):
        q, k, v, ks, vs, table, counts = p
        kg = _gather_pages(k, ks, table, qdtype).contiguous()  # dequantized to q's dtype for int8
        vg = _gather_pages(v, vs, table, qdtype).contiguous()
        mask = (torch.arange(kg.shape[2], device=q.device)[None, None, :] < counts[:, :, None])[:, None]
        return lambda: F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)

    before = tpl.LAUNCHES.count
    ms = graph_ms([call(p) for p in probs])
    q, k, v, ks, vs, table, counts = probs[0]
    plain_ms = event_ms(lambda: tpl.paged_attention_template_plain(q, k, v, table, counts, ks, vs,
                                                                   split_k=split_k), 3, 1)
    lib_ms = graph_ms([sdpa(p) for p in probs[: copies // 2]])
    if tpl.LAUNCHES.count == before:
        raise SystemExit("timing loop never launched the kernel")
    return ms, plain_ms, lib_ms, spec_bound_ms(qdtype, R, int8, counts)


# ---------------------------------------------------------------- speculative serving


def spec_engine_kw(model_cfg, params):
    """The speculative engine arguments `sample.main` gives local_text_124m:
    its spec_layers-layer self-draft on the target's pool and its k range."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.sampling.spec import self_draft

    base = load_config("local_text_124m")
    dcfg, dparams = self_draft(model_cfg, params, base.spec_layers)
    return dict(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True,
                spec_k_max=base.spec_k_max, spec_k_min=base.spec_k_min, spec_adapt=base.spec_adapt)


def spec_launches(label, stats, launches, n_layer, int8, want=None):
    """Phase 5b: every verify round launched the verify spec once per layer,
    every draft step the decode spec once per draft layer (and a plain
    decode step, if the engine fell back to one, once per layer); an int8
    pool launched only int8 specs (`want`, if given: exactly these specs)."""
    sp = stats["spec"]
    verify = sum(n for (spec, _), n in launches.items() if spec.endswith("verify"))
    decode = sum(n for (spec, _), n in launches.items() if spec.endswith("decode"))
    print(f"speculative {label}: launches {launches}; {sp['rounds']} verify rounds x {n_layer} layers, "
          f"{sp['draft_steps']} draft steps x {SPEC_DRAFT_LAYERS} layers, {stats['decode_steps']} plain decode steps")
    if verify != n_layer * sp["rounds"] or sp["rounds"] < 1:
        raise SystemExit(f"{label}: verify launches != n_layer x verify rounds: a verify forward bypassed the kernel")
    if decode != SPEC_DRAFT_LAYERS * sp["draft_steps"] + n_layer * stats["decode_steps"]:
        raise SystemExit(f"{label}: decode-spec launches != {SPEC_DRAFT_LAYERS} x draft steps (+ plain decode)")
    if want is None:
        want = {"int8-decode", "int8-verify"} if int8 else {"decode", "verify"}
    if {spec for spec, _ in launches} != want:
        raise SystemExit(f"{label}: launched specs {sorted({s for s, _ in launches})}, want {sorted(want)}")


def compare_streams(label, got, want, model_cfg=None, params=None):
    """Greedy streams must be identical. With `params` (speculative vs plain
    decode), a departure is allowed only at a near-tie: the run prints the
    first departing position and the top-2 logit gap there (a dense f32
    forward of the plain stream's prefix) and fails unless the gap is under
    GAP_TOL relative."""
    from midgpt_tpu_torch.models.gpt import GPT

    departed = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if np.array_equal(g, w):
            continue
        pos = int(np.argmax(g != w)) if len(g) == len(w) else min(len(g), len(w))
        if params is None:
            raise SystemExit(f"{label}: request {i} differs from token {pos}")
        with torch.no_grad():
            prefix = torch.as_tensor(w[:pos][None], device="cuda").long()
            logits = GPT.apply(model_cfg, params, prefix, inference=True)[0, -1].float()
        top = torch.topk(logits, 2).values
        gap = ((top[0] - top[1]) / top[0].abs()).item()
        print(f"{label}: request {i} departs at token {pos} of {len(w)}: top-2 logit gap {gap:.3e} relative "
              f"(tol {GAP_TOL:g})")
        if gap >= GAP_TOL:
            raise SystemExit(f"{label}: request {i} departs at token {pos} with no near-tie there")
        departed += 1
    print(f"{label}: {len(got) - departed} of {len(got)} greedy streams identical"
          + (f", {departed} departing at a near-tie" if departed else ""))


def spec_serving(card, params32, params16, plain32_streams):
    """Phase 5b. Returns the launches of the bf16 and int8 runs."""
    from midgpt_tpu_torch import sample
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.kernels import attention_template as tpl

    scfg = load_config("local_text_124m").model_config
    out, rates = {}, {}
    for label, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        kw = spec_engine_kw(scfg, params16)
        tpl.LAUNCHES.reset()
        st, _, _ = serve(scfg, params16, dtype, **kw)
        launches = dict(tpl.LAUNCHES.by_variant)
        spec_launches(label, st, launches, scfg.n_layer, dtype == torch.int8)
        out[label] = launches
        rates[label] = st["decode_tokens"] / st["decode_seconds"]
        sp = st["spec"]
        print(f"speculative {label} (bf16 compute, {label} pool): accept_rate {sp['accept_rate']:.4f}, "
              f"tokens/verify {sp['tokens_per_verify']:.4f}, decode {rates[label]:.1f} tokens/s over "
              f"{st['decode_tokens']} tokens ({st['decode_seconds']:.3f} s in rounds) on {card}")
    st, _, _ = serve(scfg, params16, torch.bfloat16)
    rates["plain"] = st["decode_tokens"] / st["decode_seconds"]
    print(f"decode without speculation (bf16, same trace and engine): {rates['plain']:.1f} tokens/s over "
          f"{st['decode_tokens']} tokens; with the self-draft {rates['bf16'] / rates['plain']:.3f}x (bf16 pool), "
          f"{rates['int8'] / rates['plain']:.3f}x (int8 pool) on {card}")

    # sample.main with the config's defaults: the 4-layer self-draft, bf16
    tpl.LAUNCHES.reset()
    sample.main(["--config=local_text_124m", "--start_ids=50,11,3", "--num_samples=2",
                 "--max_new_tokens=24", "--temperature=0"])
    torch.cuda.synchronize()
    specs = {spec for spec, _ in tpl.LAUNCHES.by_variant}
    print(f"sample.main --config=local_text_124m launches: {dict(tpl.LAUNCHES.by_variant)}")
    if specs != {"decode", "verify"}:
        raise SystemExit("sample.main --config=local_text_124m must serve with its self-draft (verify spec)")

    # greedy f32 streams: kernel vs gather (identical), spec vs plain (near-ties only)
    kw32 = spec_engine_kw(scfg, params32)
    _, spec_k, _ = serve(scfg, params32, torch.float32, **kw32)
    _, spec_g, _ = serve(scfg, params32, torch.float32, attn_impl="gather", **kw32)
    compare_streams("f32 speculative, kernel vs gather", spec_k, spec_g)
    compare_streams("f32 speculative vs plain decode (kernel)", spec_k, plain32_streams, scfg, params32)
    _, int8_spec, _ = serve(scfg, params32, torch.int8, **kw32)
    _, int8_plain, _ = serve(scfg, params32, torch.int8)
    compare_streams("int8 pool (f32 compute) speculative vs plain decode", int8_spec, int8_plain, scfg, params32)
    # Random weights leave the self-draft's proposals rejected; a draft that
    # agrees — the target's own weights as a separate draft model with its
    # own pool — runs the multi-token commit, the bonus token and the
    # separate draft's prefill through the kernels.
    same = dict(kw32, draft_params=params32, draft_config=scfg, draft_shares_cache=False)
    st, same_streams, _ = serve(scfg, params32, torch.float32, **same)
    sp = st["spec"]
    print(f"f32 speculative with the target as its own separate draft: accept_rate {sp['accept_rate']:.4f}, "
          f"tokens/verify {sp['tokens_per_verify']:.4f} over {sp['rounds']} verify rounds")
    if sp["accept_rate"] < 0.9:
        raise SystemExit("a draft with the target's weights must have nearly all its proposals accepted")
    compare_streams("f32 speculative (target as draft) vs plain decode (kernel)", same_streams, plain32_streams,
                    scfg, params32)
    return out


# ---------------------------------------------------------------- GQA fold and sliding window


def gqa_problem(geometry, qdtype, R, pool, seed=0):
    """Phase-3d inputs at one GQA_GEOMETRIES entry: q (B, H_q, R, C) over
    pools of dtype `pool` at H_kv heads (int8: codes with their (num_pages,
    H_kv, page_size) f32 scales, quantized from the same values), a shuffled
    page table whose unused entries point at the sink page 0, and R rows per
    slot ending at the geometry's counts (the count-1 slot inactive: 1 key
    on every row)."""
    from midgpt_tpu_torch.ops.quant import quantize_q8

    B, HQ, HKV, C, bucket, counts = GQA_GEOMETRIES[geometry]
    g = torch.Generator().manual_seed(seed)
    need = [-(-c // PAGE) for c in counts]
    num_pages = 1 + sum(need)
    perm = (torch.randperm(num_pages - 1, generator=g) + 1).tolist()
    table = torch.zeros(B, bucket, dtype=torch.int32)
    for b, n in enumerate(need):
        if counts[b] > 1:
            table[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
            perm = perm[n:]
    q = torch.randn(B, HQ, R, C, generator=g).to("cuda", qdtype)
    k = torch.randn(HKV, num_pages, PAGE, C, generator=g).cuda()
    v = torch.randn(HKV, num_pages, PAGE, C, generator=g).cuda()
    cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
    rows = torch.where(cnt[:, None] > 1, cnt[:, None] - (R - 1) + torch.arange(R, device="cuda"), 1)
    rows = rows.to(torch.int32)
    if pool == torch.int8:
        (k, ks), (v, vs) = (quantize_q8(x.transpose(0, 1)) for x in (k, v))  # per (page, head, position)
        return q, k.transpose(0, 1).contiguous(), v.transpose(0, 1).contiguous(), ks, vs, table.cuda(), rows
    return q, k.to(pool), v.to(pool), None, None, table.cuda(), rows


def window_kw(window):
    return dict(sliding_window=window, attn_sinks=SINKS if window else 0)


def check_gqa_kernels():
    """Phase 3d: the GQA and window specs of the kernel vs the plain version
    on the same inputs, each launch counted under its spec: bf16 queries
    over bf16 and int8 pools, f32 queries over f32, bf16 and int8 pools.
    The tolerance follows the rounding points: the bf16 one wherever the
    query or the pool is bf16 (p is rounded to the pool's dtype, so an f32
    query over bf16 pools has a bf16 rounding of p that an f32 sum taken
    in another order can move by one ulp), the f32 one otherwise (int8
    pools keep p in f32). Returns {(geometry, qdtype, R, pool, window,
    split): max |err|}."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    errs = {}
    pools = {torch.bfloat16: (torch.bfloat16, torch.int8), torch.float32: (torch.float32, torch.bfloat16, torch.int8)}
    for geometry, (B, HQ, HKV, C, bucket, counts) in GQA_GEOMETRIES.items():
        for qdt, qpools in pools.items():
            for R in GQA_ROWS:
                for pool in qpools:
                    int8 = pool == torch.int8
                    q, k, v, ks, vs, table, rows = gqa_problem(geometry, qdt, R, pool)
                    tol, cell = TOL[torch.bfloat16 if torch.bfloat16 in (qdt, pool) else torch.float32], []
                    for window in (0, WINDOW):
                        for s in (1, 2):
                            key = (tpl.spec_name(R, int8, HQ // HKV, window), s)
                            before = tpl.LAUNCHES.by_variant[key]
                            got = tpl.paged_attention_template(q, k, v, table, rows, ks, vs, split_k=s,
                                                               **window_kw(window))
                            torch.cuda.synchronize()
                            want = tpl.paged_attention_template_plain(q, k, v, table, rows, ks, vs, split_k=s,
                                                                      **window_kw(window))
                            err = (got.float() - want.float()).abs().max().item()
                            ok = (torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
                                  and got.dtype == qdt and got.shape == q.shape and bool(torch.isfinite(got).all())
                                  and tpl.LAUNCHES.by_variant[key] == before + 1)
                            errs[(geometry, qdt, R, pool, window, s)] = err
                            cell.append(f"{key[0]} split {s} {err:.3e}{'' if ok else ' FAIL'}")
                            if not ok:
                                print(f"kernel check paged GQA {geometry}: " + "; ".join(cell))
                                raise SystemExit(f"paged {key[0]} kernel disagrees with its plain version or was "
                                                 f"not counted ({geometry}, R {R}, {qdt}, split {s})")
                    print(f"kernel check paged GQA {geometry} ({HQ} query heads over {HKV} K/V heads of {C}, "
                          f"R={R}, {HQ // HKV * R} folded rows) {str(qdt)[6:]} query over {str(pool)[6:]} "
                          f"pools, window {WINDOW} + {SINKS} sinks or none: " + "; ".join(cell) + f" (tol {tol:g} "
                          "abs+rel) ok")
                    del q, k, v, ks, vs
            free_memory()
    return errs


def check_gqa_bitwise(geometry, split_k, R=9):
    """Phase 3d, bit for bit: a window at least every count gives exactly
    the windowless output; every row of a GQA verify launch (without and
    with the window) equals the GQA decode launch at that row's count."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    bucket = GQA_GEOMETRIES[geometry][4]
    q, k, v, _, _, table, rows = gqa_problem(geometry, torch.bfloat16, R, torch.bfloat16, seed=7)
    base = tpl.paged_attention_template(q, k, v, table, rows, split_k=split_k)
    wide = tpl.paged_attention_template(q, k, v, table, rows, split_k=split_k, sliding_window=bucket * PAGE,
                                        attn_sinks=SINKS)
    if not torch.equal(wide, base):
        raise SystemExit(f"{geometry}: a window past every count changed the output (split {split_k})")
    for window in (0, WINDOW):
        out = tpl.paged_attention_template(q, k, v, table, rows, split_k=split_k, **window_kw(window))
        for t in range(R):
            one = tpl.paged_attention_template(q[:, :, t : t + 1].contiguous(), k, v, table,
                                               rows[:, t : t + 1].contiguous(), split_k=split_k, **window_kw(window))
            if not torch.equal(out[:, :, t], one[:, :, 0]):
                raise SystemExit(f"{geometry}: GQA verify row {t} differs from the GQA decode launch at its count "
                                 f"(window {window}, split {split_k})")
    print(f"kernel check GQA {geometry} split_k={split_k}: window {bucket * PAGE} (past every count) == no window, "
          f"and GQA verify R={R} rows == GQA decode launches (no window, window {WINDOW} + {SINKS} sinks), "
          "bit for bit: ok")


def train_variant(data_dir: Path, rundir: Path, variant: str, card: str):
    """Phase 5c: the launcher trains local_text_124m's `variant`
    (GQA_VARIANTS) into `rundir` at full width, flash counters zeroed just
    before and read just after. gqa: phase 6's cuts and launch counts;
    gqa_window (blockwise attention: no flash launch) 2 steps. Every loss
    must be finite, and the final checkpoint step's params.npz must hold
    the GQA layout. Returns the flash launches."""
    from midgpt_tpu_torch import launch

    cuts = dict(TRAIN_CUTS, max_steps=2) if variant == "gqa_window" else TRAIN_CUTS
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    launch.main(["--config=local_text_124m", f"--rundir={rundir}",
                 *sets({"data_dir": data_dir, "log_interval": 1, **cuts, **GQA_VARIANTS[variant]})])
    torch.cuda.synchronize()
    totals = {n: c.count for n, c in counters.items()}
    mc = read_run(rundir, params=False)
    micro = cuts["g_accum_iters"] * cuts["max_steps"]
    evals = 3 * cuts["eval_steps"]  # train + val at step 0, val at the end
    flash = variant == "gqa"
    want = {"flash_fwd": mc.n_layer * (micro + evals) if flash else 0,
            "flash_bwd_dq": mc.n_layer * micro if flash else 0, "flash_bwd_dkv": mc.n_layer * micro if flash else 0}
    print(f"{variant} training ({' '.join(f'{k}={v}' for k, v in GQA_VARIANTS[variant].items())}; reduced: "
          f"{', '.join(f'{k} -> {v}' for k, v in cuts.items())}): flash launches {totals}, want {want}")
    if totals != want:
        raise SystemExit(f"{variant}: flash launches != n_layer x (microsteps + eval batches) / n_layer x microsteps")
    records = [json.loads(line) for line in Path(rundir, "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/optimized"] for r in records if "loss/optimized" in r]
    evals_rec = [v for r in records for k, v in r.items() if k.startswith("loss/") and k != "loss/optimized"]
    if len(losses) != cuts["max_steps"] or not all(np.isfinite(losses + evals_rec)):
        raise SystemExit(f"{variant}: training losses not all finite: {losses}, eval {evals_rec}")
    steady = [r["throughput/tokens_per_sec"] for r in records if "loss/optimized" in r][1:]  # step 0: set-up
    with np.load(final_step_dir(rundir, cuts["max_steps"]) / "params.npz") as f:
        wkv = f["blocks.attn.wkv"].shape
    if wkv != (mc.n_layer, 2, mc.kv_heads * mc.head_dim, mc.n_embd) or mc.kv_groups != 4:
        raise SystemExit(f"{variant}: params.npz wkv has shape {wkv}, config {mc}")
    print(f"{variant} training losses by step: {[round(x, 4) for x in losses]}, params.npz wkv {wkv}, "
          f"{np.mean(steady):.1f} tokens/s (steps 1-{len(losses) - 1}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {card}")
    return totals


def final_step_dir(rundir: Path, max_steps: int) -> Path:
    """The step directory of a launcher run's forced final save, which must
    be its newest verified checkpoint."""
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager

    newest = CheckpointManager(str(rundir)).latest_verified_step()
    if newest != max_steps - 1:
        raise SystemExit(f"{rundir}: newest verified checkpoint step {newest}, want the final step {max_steps - 1}")
    return Path(rundir, str(newest))


def read_run(rundir: Path, params: bool = True):
    """The model config of a launcher run directory (from its config.json)
    and, with `params`, the f32 parameters of its newest verified
    checkpoint step."""
    from midgpt_tpu_torch.config import from_json
    from midgpt_tpu_torch.sampling.engine import restore_for_sampling

    exp = from_json(Path(rundir, "config.json").read_text())
    if not params:
        return exp.model_config
    return exp.model_config, restore_for_sampling(str(rundir), exp, "cuda")[0]


def sample_specs(rundir: Path, *extra):
    """`sample.main --ckpt_dir` on a run, counters zeroed just before:
    returns the specs it launched."""
    from midgpt_tpu_torch import sample
    from midgpt_tpu_torch.kernels import attention_template as tpl

    tpl.LAUNCHES.reset()
    sample.main([f"--ckpt_dir={rundir}", "--start_ids=50,11,3", "--num_samples=2", "--max_new_tokens=24",
                 "--temperature=0", *extra])
    torch.cuda.synchronize()
    print(f"sample.main --ckpt_dir ({rundir.name}{' ' if extra else ''}{' '.join(extra)}) launches: "
          f"{dict(tpl.LAUNCHES.by_variant)}")
    return {spec for spec, _ in tpl.LAUNCHES.by_variant}


def gqa_serving(card, rundirs):
    """Phase 5c, serving the trained runs. Returns the launches of the gqa
    runs (speculative, then plain) and of the gqa_window plain run."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.utils.precision import cast_floating

    if sample_specs(rundirs["gqa"]) != {"gqa-decode", "gqa-verify"}:
        raise SystemExit("sample --ckpt_dir on the gqa run must serve with its self-draft: GQA verify + decode specs")
    cfg, p32 = read_run(rundirs["gqa"])
    if (cfg.n_kv_heads, cfg.kv_groups) != (3, 4):
        raise SystemExit(f"the gqa run's config.json did not round-trip n_kv_heads: {cfg}")
    p16 = cast_floating(p32, torch.bfloat16)
    tpl.LAUNCHES.reset()
    st, _, _ = serve(cfg, p16, torch.bfloat16, **spec_engine_kw(cfg, p16))
    gqa_launches = dict(tpl.LAUNCHES.by_variant)
    spec_launches("gqa bf16", st, gqa_launches, cfg.n_layer, False, want={"gqa-decode", "gqa-verify"})
    tpl.LAUNCHES.reset()
    st, _, _ = serve(cfg, p16, torch.bfloat16)
    launches = dict(tpl.LAUNCHES.by_variant)
    print(f"gqa bf16 without a draft: launches {launches}; decode steps {st['decode_steps']} x {cfg.n_layer} layers; "
          f"decode {st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s, rounds {st['split_rounds']} on {card}")
    if {s for s, _ in launches} != {"gqa-decode"} or sum(launches.values()) != cfg.n_layer * st["decode_steps"]:
        raise SystemExit(f"gqa bf16 without a draft must launch the GQA decode spec n_layer x decode steps: {launches}")
    gqa_launches.update(launches)  # the plain run's gqa-decode counts
    del p32, p16

    if sample_specs(rundirs["gqa_window"], "--spec_layers=0") != {"window-gqa-decode"}:
        raise SystemExit("sample --ckpt_dir --spec_layers 0 on the gqa_window run must launch the windowed GQA "
                         "decode spec only")
    cfg, p32 = read_run(rundirs["gqa_window"])
    if (cfg.n_kv_heads, cfg.sliding_window, cfg.attn_sinks) != (3, WINDOW, SINKS):
        raise SystemExit(f"the gqa_window run's config.json did not round-trip the variant: {cfg}")
    p16 = cast_floating(p32, torch.bfloat16)
    bound = -(-SINKS // PAGE) + -(-WINDOW // PAGE) + 2  # tests/test_attention_variants.py:271
    peak = [0]

    def watch(eng):
        live = [sum(p >= 0 for p in s.pages) for s in eng.slots if s is not None]
        peak[0] = max(peak[0], *live, 0)
        if eng.allocator.free_count + sum(live) != eng.allocator.num_pages - 1:
            raise SystemExit("window reclamation broke page conservation (free + live != num_pages - 1)")

    def plain_window_run(label, dtype, spec, overlap="off"):
        tpl.LAUNCHES.reset()
        peak[0] = 0
        st, _, _ = serve(cfg, p16, dtype, watch=watch, overlap=overlap)
        launches = dict(tpl.LAUNCHES.by_variant)
        rate = st["decode_tokens"] / st["decode_seconds"]
        print(f"gqa_window {label}, overlap {overlap}: launches {launches}; device steps {device_steps(st)} x "
              f"{cfg.n_layer} layers; window_reclaimed_pages {st['window_reclaimed_pages']}; most pages resident "
              f"in a slot {peak[0]} (bound {bound}); decode {rate:.1f} tokens/s, rounds {st['split_rounds']}; "
              f"graphs {st['decode_graphs']} on {card}")
        if {s for s, _ in launches} != {spec} or {k for _, k in launches} != {1, 2}:
            raise SystemExit(f"gqa_window {label} must launch only {spec}, at splits 1 and 2: {launches}")
        if sum(launches.values()) != cfg.n_layer * device_steps(st):
            raise SystemExit(f"gqa_window {label}: launches != n_layer x device steps")
        if st["window_reclaimed_pages"] < 1 or peak[0] > bound:
            raise SystemExit(f"gqa_window {label}: no page reclaimed, or a slot held more than {bound} pages")
        return launches

    window_launches = plain_window_run("bf16", torch.bfloat16, "window-gqa-decode")
    plain_window_run("int8 pool (bf16 compute)", torch.int8, "int8-window-gqa-decode")
    # the overlap mode that chains groups: reclamation runs in the settle, a round late
    plain_window_run("bf16", torch.bfloat16, "window-gqa-decode", overlap="double")
    plain_window_run("int8 pool (bf16 compute)", torch.int8, "int8-window-gqa-decode", overlap="double")
    tpl.LAUNCHES.reset()
    st, _, _ = serve(cfg, p16, torch.bfloat16, **spec_engine_kw(cfg, p16))
    spec_launches("gqa_window bf16", st, dict(tpl.LAUNCHES.by_variant), cfg.n_layer, False,
                  want={"window-gqa-decode", "window-gqa-verify"})
    _, kernel_streams, _ = serve(cfg, p32, torch.float32)
    _, gather_streams, _ = serve(cfg, p32, torch.float32, attn_impl="gather")
    compare_streams("gqa_window f32, kernel vs gather", kernel_streams, gather_streams)
    wall_us, by_name = profile_decode(cfg, p16)
    print_busy("gqa_window decode rounds", wall_us, by_name, card)
    return gqa_launches, window_launches


def gqa_bound_ms(R, window, rows):
    """(least ms the card could take for one bf16 launch at the main GQA
    geometry, what bounds it): K and V of the keys some row sees (under the
    window only its keys and the sinks) at the K/V head count, each read
    once, q in and out at the query heads, the table and counts; against 4
    flops per (row, visible key, channel) of every query head."""
    from midgpt_tpu_torch.ops.attention import visible_mask

    B, HQ, HKV, C, bucket, _ = GQA_GEOMETRIES["main"]
    cols = torch.arange(bucket * PAGE, device=rows.device)
    vis = visible_mask(cols[None, None, :], rows[:, :, None], **window_kw(window))  # (B, R, S)
    keys, pairs = int(vis.any(dim=1).sum()), int(vis.sum())
    moved = 2 * keys * HKV * C * 2 + 2 * B * HQ * R * C * 2 + B * bucket * 4 + B * R * 4
    flops = 4 * pairs * HQ * C
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.bfloat16]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), moved


def time_gqa_kernel(R, window, split_k):
    """Phase 10 at the main GQA geometry, bf16: device ms of the kernel's
    wrapper and of the SDPA yardstick (graph replay over copies that
    together exceed the L2 twice over), the plain version (eager), and the
    bound."""
    import torch.nn.functional as F

    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.kernels.decode_attention import _gather_pages
    from midgpt_tpu_torch.ops.attention import visible_mask

    groups = GQA_GEOMETRIES["main"][1] // GQA_GEOMETRIES["main"][2]
    b_ms, b_by, moved = gqa_bound_ms(R, window, gqa_problem("main", torch.bfloat16, R, torch.bfloat16)[-1])
    copies = max(12, -(-int(100e6) // moved))
    probs = [gqa_problem("main", torch.bfloat16, R, torch.bfloat16, seed=1 + i) for i in range(copies)]

    def call(p):
        q, k, v, _, _, table, rows = p
        return lambda: tpl.paged_attention_template(q, k, v, table, rows, split_k=split_k, **window_kw(window))

    def sdpa(p):
        q, k, v, _, _, table, rows = p
        kg, vg = (_gather_pages(x, None, table).repeat_interleave(groups, dim=1).contiguous() for x in (k, v))
        cols = torch.arange(kg.shape[2], device=q.device)
        mask = visible_mask(cols[None, None, :], rows[:, :, None], **window_kw(window))[:, None]
        return lambda: F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)

    before = tpl.LAUNCHES.count
    ms = graph_ms([call(p) for p in probs], per_graph=max(24, copies))
    q, k, v, _, _, table, rows = probs[0]
    plain_ms = event_ms(lambda: tpl.paged_attention_template_plain(q, k, v, table, rows, split_k=split_k,
                                                                   **window_kw(window)), 3, 1)
    lib_ms = graph_ms([sdpa(p) for p in probs[:16]])
    if tpl.LAUNCHES.count == before:
        raise SystemExit("timing loop never launched the kernel")
    return ms, plain_ms, lib_ms, (b_ms, b_by), copies


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


def check_flash_repeat(label, B, H, T, C, bq, bk):
    """Phase 3b: two launches of each flash kernel on the same bf16 inputs
    give the same bits of out, lse, dq, dk and dv (no atomics)."""
    from midgpt_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = flash_problem(B, H, T, C, torch.bfloat16, seed=5)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_forward(q, k, v, bq, bk)
        runs.append((out, lse, *fa.flash_backward(q, k, v, out, lse, do, bq, bk)))
    torch.cuda.synchronize()
    differ = [name for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs) if not torch.equal(a, b)]
    print(f"kernel check flash {label} bf16, two launches on the same inputs: "
          + ("bit for bit: ok" if not differ else f"{differ} differ: FAIL"))
    if differ:
        raise SystemExit(f"flash kernels are not the same from run to run ({label}: {differ})")


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
        final_step_dir(Path(rundir), TRAIN_CUTS["max_steps"])
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
    # step 0 pays first-call set-up; step 1's log interval holds the step-0 checkpoint save
    steady = steps_rec[2:]
    tok_s = float(np.mean([r["throughput/tokens_per_sec"] for r in steady]))
    mfu = float(np.mean([r["throughput/mfu"] for r in steady])) if "throughput/mfu" in steady[0] else None
    print(f"training losses by step: {[round(x, 4) for x in losses]} on {card}")
    print(f"training throughput (steps 2-{steps - 1}, G={G} x {base.batch_size} x {mc.block_size} tokens per step): "
          f"{tok_s:.1f} tokens/s, MFU {'not known for this card' if mfu is None else f'{100 * mfu:.2f}%'} on {card}")
    return launches, tok_s, mfu, losses


def logged(rundir: Path):
    """({step: loss/optimized}, {(step, key): eval loss}) of a run's
    metrics.jsonl, a resumed run's lines winning."""
    losses, evals = {}, {}
    for line in Path(rundir, "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "loss/optimized" in rec:
            losses[rec["step"]] = rec["loss/optimized"]
        for k in ("loss/train", "loss/val", "loss/val_final"):
            if k in rec:
                evals[(rec["step"], k)] = rec[k]
    return losses, evals


def state_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over the leaves of two restored checkpoint states
    (0.0 is bit for bit; counts compared exactly)."""
    pa, oa = a["params"], a["opt_state"]
    pb, ob = b["params"], b["opt_state"]
    if (oa.adam_count, oa.schedule_count) != (ob.adam_count, ob.schedule_count):
        return float("inf")
    pairs = [(pa[k], pb[k]) for k in pa] + [(oa.mu[k], ob.mu[k]) for k in pa] + [(oa.nu[k], ob.nu[k]) for k in pa]
    return max(0.0 if torch.equal(x, y) else (x - y).abs().max().item() for x, y in pairs)


def final_diff(a: Path, b: Path, step: int) -> float:
    """Largest |a - b| between two runs' checkpoints of `step`: 0.0 at once
    when their manifests hash the same bytes (a checkpoint's files are a
    function of its state), else from the restored states."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.training.checkpoint import MANIFEST_NAME, CheckpointManager
    from midgpt_tpu_torch.training.train import state_template

    files = [json.loads(Path(d, str(step), MANIFEST_NAME).read_text())["files"] for d in (a, b)]
    if files[0] == files[1]:
        return 0.0
    like = state_template(load_config("local_text_124m"))
    return state_diff(*(CheckpointManager(str(d)).restore(step, like, device="cuda") for d in (a, b)))


def savez_write(path: str, arrays) -> None:
    """The checkpoint writer's earlier file write, `np.savez`, which copies
    each 16 MiB chunk with the GIL held: timed beside the zero-copy one."""
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def checkpoint_round_trip(data_dir: Path, root: Path, card: str) -> dict:
    """Phase 6b, round trip: one full-width step, a copy of the state on
    the card, a save, two more steps (in place) while the writer thread
    runs, two without it, then the restore must equal the copy bit for
    bit. Then two steps beside a save written by `np.savez` (the earlier
    writer). Returns the save's record, the restore time and the step
    times."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.data.dataset import TokenDataset
    from midgpt_tpu_torch.training import checkpoint as ckpt
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager
    from midgpt_tpu_torch.training.optim import OptState
    from midgpt_tpu_torch.training.train import init_state, make_train_step, state_template

    cfg = load_config("local_text_124m").replace(data_dir=str(data_dir), **RESUME_CUTS)
    params, opt_state, opt = init_state(cfg, "cuda")
    step = make_train_step(cfg, opt)[0]
    ds = TokenDataset(str(data_dir), seed=cfg.data_seed)
    T, B, G = cfg.model_config.block_size, cfg.batch_size, cfg.g_accum_iters

    def train_step(i):
        nonlocal params, opt_state
        x, y = (torch.from_numpy(a).cuda().long() for a in ds.batch("train", i, T, B, G))
        params, opt_state, _ = step(params, opt_state, x, y)

    def step_ms(first, n=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(first, first + n):
            train_step(i)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    train_step(0)
    copy = {"params": {k: v.clone() for k, v in params.items()},
            "opt_state": OptState(opt_state.adam_count, {k: v.clone() for k, v in opt_state.mu.items()},
                                  {k: v.clone() for k, v in opt_state.nu.items()}, opt_state.schedule_count)}
    mngr = CheckpointManager(str(root / "round_trip"), save_interval_steps=1)
    mngr.save(0, {"params": params, "opt_state": opt_state})
    with_writer = step_ms(1)
    mngr.wait()
    without = step_ms(3)
    t0 = time.perf_counter()
    restored = mngr.restore(0, state_template(cfg), device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    zero_copy, ckpt._write_npz = ckpt._write_npz, savez_write
    try:
        mngr.save(5, {"params": params, "opt_state": opt_state})
        with_savez = step_ms(5)
        mngr.wait()
    finally:
        ckpt._write_npz = zero_copy
    mngr.close()
    diff = state_diff(restored, copy)
    moved = state_diff(copy, {"params": params, "opt_state": OptState(
        copy["opt_state"].adam_count, opt_state.mu, opt_state.nu, copy["opt_state"].schedule_count)})
    rec = mngr.history[0]
    print(f"checkpoint round trip at full width: restored step 0 after 4 more steps (which moved the state by "
          f"up to {moved:.3e}), max |restored - copy| {diff} over params, mu, nu; counts "
          f"{restored['opt_state'].adam_count}/{restored['opt_state'].schedule_count}")
    if diff != 0.0 or moved == 0.0:
        raise SystemExit("the checkpoint round trip is not bit for bit (or the later steps moved nothing)")
    print(f"checkpoint: {rec['bytes']} bytes per step ({rec['bytes'] / 1e9:.3f} GB: f32 params + mu + nu), "
          f"save stalls the loop {1e3 * rec['stall_s']:.1f} ms (copy to pinned host memory, one sync), "
          f"background write + sha256 {rec['write_s']:.2f} s, restore (verify + read + to the card) "
          f"{restore_s:.2f} s on {card}")
    old = mngr.history[-1]
    overlapped = [2e-3 * ms < r["write_s"] for ms, r in ((with_writer, rec), (with_savez, old))]  # writers outlived the steps
    print(f"a full-width step (G={G}) takes {with_writer:.1f} ms beside the writer thread ({100 * (with_writer / without - 1):+.1f}%; "
          f"it outlived both steps: {overlapped[0]}), {without:.1f} ms without it, {with_savez:.1f} ms beside the earlier "
          f"np.savez writer ({100 * (with_savez / without - 1):+.1f}%; outlived: {overlapped[1]}; its write + sha256 "
          f"{old['write_s']:.2f} s) — steps 1-2, 3-4, 5-6 of one call, on {card}")
    shutil.rmtree(root / "round_trip")
    return {**rec, "restore_s": restore_s, "step_ms_writer": with_writer, "step_ms": without, "step_ms_savez": with_savez}


def resume_args(data_dir: Path, rundir: Path, **extra):
    """The launcher's arguments of phase 6b's runs (and 6c's), with `extra`
    --set overrides."""
    return ["--config=local_text_124m", f"--rundir={rundir}",
            *sets({"data_dir": data_dir, "log_interval": 1, **RESUME_CUTS, **extra})]


def resume_main_path(data_dir: Path, card: str):
    """Phase 6b: checkpoints and resume on the training main path (see the
    module docstring). Returns the resumed run's flash launches, the round
    trip's record and the straight run's directory (kept for phase 6c
    under data_dir/resume, with nothing else)."""
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.training.checkpoint import MANIFEST_NAME

    t_phase = time.perf_counter()
    base = load_config("local_text_124m")
    mc = base.model_config
    root = data_dir / "resume"
    root.mkdir()
    print(f"phase 6b reduced: " + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in RESUME_CUTS.items())
          + f"; {shutil.disk_usage(root).free / 2**30:.0f} GiB free under the run directories")
    rt = checkpoint_round_trip(data_dir, root, card)
    free_memory()

    def args(rundir):
        return resume_args(data_dir, rundir)

    steps, every = RESUME_CUTS["max_steps"], RESUME_CUTS["eval_interval"]
    straight_dir, killed_dir = root / "straight", root / "killed"
    straight = launch.main(args(straight_dir))
    free_memory()
    saved = [r["step"] for r in straight["checkpoints"]]
    if saved != [*range(0, steps, every), steps - 1]:
        raise SystemExit(f"the straight run saved steps {saved}")

    # a second launcher, SIGKILLed once step `every` is verified and the next save has begun
    log = open(root / "killed.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "midgpt_tpu_torch.launch", *args(killed_dir)],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    nxt = killed_dir / str(2 * every)
    try:
        deadline = time.time() + 300
        while not nxt.exists():
            if proc.poll() is not None or time.time() > deadline:
                raise SystemExit(f"the launcher to be killed ended or stalled (rc {proc.returncode}):\n"
                                 + (root / "killed.log").read_text()[-3000:])
            time.sleep(0.002)
        verified_at_kill = (killed_dir / str(every) / MANIFEST_NAME).exists()
    finally:
        proc.kill()
        proc.wait()
        log.close()
    partial = not (nxt / MANIFEST_NAME).exists()
    left = sorted(int(p.name) for p in killed_dir.iterdir() if p.name.isdigit())
    print(f"SIGKILLed the second launcher: step {every} verified {verified_at_kill}, step directories left {left}, "
          f"step {2 * every} partly written: {partial}")
    if not verified_at_kill:
        raise SystemExit(f"step {every} was not verified when step {2 * every}'s save began")

    counters = flash_counters()
    for c in counters.values():
        c.reset()
    resumed = launch.main(args(killed_dir))
    torch.cuda.synchronize()
    launches = {n: c.count for n, c in counters.items()}
    first = resumed["resumed_from"] + 1 if resumed["resumed_from"] is not None else 0
    print(f"relaunched into the same run directory: resumed from step {resumed['resumed_from']} "
          f"(restored in {resumed['restore_s']:.2f} s), trained steps {first}-{steps - 1}")
    if resumed["resumed_from"] != every:
        raise SystemExit(f"the relaunch resumed from {resumed['resumed_from']}, want step {every} "
                         "(the newest verified step; a partial step is never restored)")
    G, E = RESUME_CUTS["g_accum_iters"], RESUME_CUTS["eval_steps"]
    micro = G * (steps - first)
    evals = E * (2 * sum(1 for i in range(first, steps) if i % every == 0) + 1)
    want = {"flash_fwd": mc.n_layer * (micro + evals), "flash_bwd_dq": mc.n_layer * micro,
            "flash_bwd_dkv": mc.n_layer * micro}
    print(f"flash launches over the resumed run: {launches}, want {want} ({mc.n_layer} layers x "
          f"({micro} microsteps + {evals} eval batches))")
    if launches != want:
        raise SystemExit("the resumed run's flash launches != n_layer x (microsteps + eval batches) / n_layer x microsteps")

    # the resumed run against the straight one: logged losses and the final checkpoint
    (sl, se), (rl, re_) = logged(straight_dir), logged(killed_dir)
    loss_diff = max(abs(sl[i] - rl[i]) for i in range(first, steps))
    eval_diff = max(abs(se[k] - re_[k]) for k in se if k[0] >= first)
    ckpt_diff = final_diff(straight_dir, killed_dir, steps - 1)
    free_memory()
    print(f"resumed vs straight: logged losses of steps {first}-{steps - 1} differ by at most {loss_diff}, "
          f"eval losses by {eval_diff}, the final checkpoints (step {steps - 1}: params, mu, nu) by {ckpt_diff}"
          + (" (the same bytes: equal manifests)" if ckpt_diff == 0.0 else ""))
    if max(loss_diff, eval_diff, ckpt_diff) > 0:
        # not bit for bit: hold it to the spread of two straight runs in this call
        again = launch.main(args(root / "straight2"))
        free_memory()
        (al, ae) = logged(root / "straight2")
        spread = max(max(abs(sl[i] - al[i]) for i in range(steps)), max(abs(se[k] - ae[k]) for k in se),
                     final_diff(straight_dir, root / "straight2", steps - 1))
        del again
        print(f"two straight runs differ by up to {spread}: the run is not deterministic on this card")
        if max(loss_diff, eval_diff, ckpt_diff) > spread:
            raise SystemExit("the resumed run departs from the straight run by more than two straight runs do")

    # serving the resumed run
    from contextlib import redirect_stdout
    import io

    out = io.StringIO()
    with redirect_stdout(out):
        specs = sample_specs(killed_dir, "--spec_layers=0")
    print(out.getvalue(), end="")
    if f"restored checkpoint step {steps - 1}" not in out.getvalue() or specs != {"decode"}:
        raise SystemExit("sample --ckpt_dir must restore the resumed run's final step and launch the decode spec")
    free_memory()

    # the loop's view: tokens/s of log intervals that hold a save and of ones that do not
    recs = {}
    for line in (straight_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "throughput/tokens_per_sec" in rec:
            recs[rec["step"]] = rec["throughput/tokens_per_sec"]
    # a save at step s lands in step s + 1's interval unless an eval opens that interval
    with_save = [recs[s + 1] for s in saved if 0 < s + 1 < steps and (s + 1) % every != 0]
    without = [recs[i] for i in range(1, steps) if i % every == 0]
    stalls = [1e3 * r["stall_s"] for r in straight["checkpoints"]]
    writes = [r["write_s"] for r in straight["checkpoints"]]
    print(f"straight run saves (steps {saved}): bytes {[r['bytes'] for r in straight['checkpoints']]}, loop "
          f"stalls {[round(x, 1) for x in stalls]} ms (each includes the barrier on the previous save), "
          f"write + sha256 {[round(x, 2) for x in writes]} s on {card}")
    print(f"tokens/s of log intervals holding a save (steps {[s + 1 for s in saved if 0 < s + 1 < steps and (s + 1) % every]}): "
          f"{[round(x, 1) for x in with_save]}; without one (steps {[i for i in range(1, steps) if i % every == 0]}): "
          f"{[round(x, 1) for x in without]} on {card}")
    for d in root.iterdir():
        if d != straight_dir:
            shutil.rmtree(d) if d.is_dir() else d.unlink()
    print(f"phase 6b took {time.perf_counter() - t_phase:.1f} s")
    return launches, rt, straight_dir


# ---------------------------------------------------------------- phase 6c: the supervised trainer


def flash_want(attempts, layers):
    """Flash launches of a run's attempts on RESUME_CUTS: each attempt is
    (first step, end step, final eval) — its steps' microsteps, the train
    and val eval batches at each eval step, the final val batch."""
    G, E, every = RESUME_CUTS["g_accum_iters"], RESUME_CUTS["eval_steps"], RESUME_CUTS["eval_interval"]
    micro = sum(G * (end - first) for first, end, _ in attempts)
    evals = sum(E * (2 * sum(1 for i in range(first, end) if i % every == 0) + final)
                for first, end, final in attempts)
    return {"flash_fwd": layers * (micro + evals), "flash_bwd_dq": layers * micro,
            "flash_bwd_dkv": layers * micro}


def recorded(name: str):
    """(time, duration, args) of the flight recorder's events called `name`."""
    from midgpt_tpu_torch.obs import flight_recorder

    return [(t, dur, args) for _, n, _, _, t, dur, _, args in flight_recorder().tracer.events() if n == name]


def logs_step(rundir: Path, step: int) -> bool:
    """Has a running launcher's metrics.jsonl logged `step`'s loss yet
    (complete lines only)?"""
    path = rundir / "metrics.jsonl"
    if not path.exists():
        return False
    for line in path.read_text().split("\n")[:-1]:
        rec = json.loads(line)
        if rec.get("step") == step and "loss/optimized" in rec:
            return True
    return False


def same_run(label: str, straight_dir: Path, rundir: Path, steps):
    """The logged losses of `steps` and the final checkpoint of `rundir`
    must equal the straight run's bit for bit."""
    final = RESUME_CUTS["max_steps"] - 1
    (sl, _), (rl, _) = logged(straight_dir), logged(rundir)
    loss_diff = max(abs(sl[i] - rl[i]) for i in steps)
    ckpt_diff = final_diff(straight_dir, rundir, final)
    print(f"{label} vs the straight run: logged losses of steps {list(steps)} differ by at most {loss_diff}, the "
          f"final checkpoints (step {final}: params, mu, nu) by {ckpt_diff}"
          + (" (the same bytes: equal manifests)" if ckpt_diff == 0.0 else ""))
    if loss_diff != 0.0 or ckpt_diff != 0.0:
        raise SystemExit(f"{label}: not bit for bit the straight run")


def supervised_main_path(data_dir: Path, straight_dir: Path, save_cost: dict, card: str):
    """Phase 6c, training: the supervised launcher on RESUME_CUTS (see the
    module docstring), each run held to phase 6b's straight run. Returns
    {run: flash launches}."""
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    layers = load_config("local_text_124m").model_config.n_layer
    steps = RESUME_CUTS["max_steps"]
    root = straight_dir.parent
    counters = flash_counters()
    launches = {}
    k = 3  # a fault at step 3: past the verified saves at 0 and 2

    def run(label, rundir, **extra):
        for c in counters.values():
            c.reset()
        result = launch.main(resume_args(data_dir, rundir, restart_backoff_sec=0, **extra))
        torch.cuda.synchronize()
        launches[label] = {n: c.count for n, c in counters.items()}
        return result

    def tok_s(rundir):
        recs = {}
        for line in Path(rundir, "metrics.jsonl").read_text().splitlines():
            rec = json.loads(line)
            if "throughput/tokens_per_sec" in rec:
                recs[rec["step"]] = rec["throughput/tokens_per_sec"]
        return [recs[2], recs[3]]

    # (d) an armed 60 s watchdog: bit for bit the unarmed straight run
    armed_dir = root / "armed"
    n_syncs = len(recorded("train.sync"))
    run("armed watchdog", armed_dir, watchdog_deadline_s=60)
    syncs = [dur for _, dur, _ in recorded("train.sync")[n_syncs:]]
    same_run("(d) armed watchdog (60 s)", straight_dir, armed_dir, range(steps))
    unarmed, armed = tok_s(straight_dir), tok_s(armed_dir)
    print(f"(d) tokens/s of steps 2-3: unarmed {[round(x, 1) for x in unarmed]} (phase 6b's straight run), armed "
          f"{[round(x, 1) for x in armed]}; {len(syncs)} guarded syncs, the longest {max(syncs):.3f} s, on {card}")
    if launches["armed watchdog"] != flash_want([(0, steps, 1)], layers):
        raise SystemExit(f"(d) flash launches {launches['armed watchdog']} != n_layer x (microsteps + evals)")
    shutil.rmtree(armed_dir)

    # (a) divergence at step k: rolled back to step 2 with the data window skipped
    div_dir = root / "diverged"
    free_memory()
    before = torch.cuda.memory_allocated()
    n_events = len(recorded("train.step"))
    result = run("divergence", div_dir, fault_plan=f"nan_grad@{k}")
    after = torch.cuda.memory_allocated()
    sup = result["supervisor"]
    loss_final = result["metrics"]["loss/final"]
    del result
    free_memory()
    released = torch.cuda.memory_allocated()
    raised = recorded("train.divergence")[-1][0]
    first_after = min(t for t, _, _ in recorded("train.step")[n_events:] if t > raised)
    ledger = json.loads((div_dir / "supervisor_state.json").read_text())
    last_good = 2  # JAX's supervisor: window [last_good + 1, k] + offset, offset += max(1, k - last_good)
    want = {"restarts": 1, "windows_skipped": [[last_good + 1, k]], "data_step_offset": max(1, k - last_good),
            "hung_steps": [], "faults_fired": {"nan_grad": 1}}
    got = {key: sup[key] for key in want}
    print(f"(a) nan_grad@{k}: supervisor {got}, ledger offset {ledger['data_step_offset']} windows "
          f"{ledger['windows_skipped']}; final loss {loss_final:.4f}; rollback {first_after - raised:.3f} s "
          f"from the raise to the next attempt's first step (restore included, backoff 0) on {card}")
    print(f"(a) torch.cuda.memory_allocated: {before} bytes before the supervised run, {after} after it returned "
          f"(its result holds the final state), {released} once the result was released "
          f"({released - before:+d} bytes against before) on {card}")
    if got != want or ledger["data_step_offset"] != want["data_step_offset"] or \
            ledger["windows_skipped"] != want["windows_skipped"] or not np.isfinite(loss_final):
        raise SystemExit("(a) the rollback does not match JAX's supervisor for these cuts")
    if released - before > 256 * 2**20:
        raise SystemExit("(a) the failed attempt's state outlived the supervised run")
    wanted = flash_want([(0, k + 1, 0), (last_good + 1, steps, 1)], layers)
    print(f"(a) flash launches over both attempts: {launches['divergence']}, want {wanted}")
    if launches["divergence"] != wanted:
        raise SystemExit("(a) flash launches != n_layer x (microsteps + eval batches) over both attempts")
    shutil.rmtree(div_dir)

    # (b) hang at step k: the watchdog ends the wait, the replay is the straight run
    deadline = max(2.0, round(3 * max(syncs), 1))
    hang_dir = root / "hung"
    result = run("hang", hang_dir, fault_plan=f"hang_step@{k}", watchdog_deadline_s=deadline)
    sup = result["supervisor"]
    del result
    free_memory()
    waited = recorded("supervisor.hung_restart")[-1][2]["waited_s"]
    print(f"(b) hang_step@{k}: hung_steps {sup['hung_steps']}, offset {sup['data_step_offset']}, restarts "
          f"{sup['restarts']}; waited {waited:.3f} s at expiry against a {deadline:g} s deadline (3x the longest "
          f"guarded sync of (d), at least 2 s) on {card}")
    if (sup["hung_steps"], sup["data_step_offset"], sup["restarts"]) != ([k], 0, 1):
        raise SystemExit("(b) the hang restart must mark the step hung and keep the offset")
    if not all((hang_dir / f"flight_recorder.{ext}").exists() for ext in ("json", "prom")):
        raise SystemExit("(b) the watchdog must dump flight_recorder.json and .prom")
    same_run(f"(b) hang restart", straight_dir, hang_dir, range(steps))
    wanted = flash_want([(0, k + 1, 0), (last_good + 1, steps, 1)], layers)
    if launches["hang"] != wanted:
        raise SystemExit(f"(b) flash launches {launches['hang']} != {wanted}")
    shutil.rmtree(hang_dir)

    # (c) a real SIGTERM to a launcher subprocess: emergency save, clean exit, exact relaunch
    sig_dir, grace = root / "sigterm", 30
    log = open(root / "sigterm.log", "w")
    # saves at step 0 only: the boundary's save is the emergency one
    argv = resume_args(data_dir, sig_dir, eval_interval=steps, preempt_grace_s=grace)
    proc = subprocess.Popen([sys.executable, "-m", "midgpt_tpu_torch.launch", *argv], cwd=ROOT,
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline_t = time.time() + 300
        while not logs_step(sig_dir, 2):
            if proc.poll() is not None or time.time() > deadline_t:
                raise SystemExit(f"the launcher to be preempted ended or stalled (rc {proc.returncode}):\n"
                                 + (root / "sigterm.log").read_text()[-3000:])
            time.sleep(0.002)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        to_exit = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    out = (root / "sigterm.log").read_text()
    said = [line for line in out.splitlines() if line.startswith("preemption: emergency checkpoint at step")]
    boundary = int(said[-1].split("step ")[1].split()[0]) if said else None
    newest = CheckpointManager(str(sig_dir)).latest_verified_step()
    dumped = json.loads((sig_dir / "flight_recorder.json").read_text())["traceEvents"] \
        if (sig_dir / "flight_recorder.json").exists() else []
    preempted = any(e["name"] == "train.preempt" for e in dumped)
    print(f"(c) SIGTERM after step 2 logged: exit code {rc} after {to_exit:.3f} s (preempt_grace_s {grace}; a save "
          f"here costs {1e3 * save_cost['stall_s']:.1f} ms of stall + {save_cost['write_s']:.2f} s of write and hash, "
          f"phase 6b), boundary step {boundary}, newest verified step {newest}, train.preempt in the dumped "
          f"flight recorder: {preempted} on {card}")
    if rc != 0 or boundary is None or newest != boundary or not preempted:
        raise SystemExit("(c) SIGTERM must end in a verified emergency save at the boundary and exit 0:\n" + out[-3000:])
    result = run("sigterm relaunch", sig_dir)
    del result
    free_memory()
    same_run(f"(c) relaunch after SIGTERM (resumed from {boundary})", straight_dir, sig_dir, range(steps))
    wanted = flash_want([(boundary + 1, steps, 1)], layers)
    if launches["sigterm relaunch"] != wanted:
        raise SystemExit(f"(c) the relaunch's flash launches {launches['sigterm relaunch']} != {wanted}")
    shutil.rmtree(root)
    print("flash launches on phase 6c's training paths: " + "; ".join(f"{k_}: {v}" for k_, v in launches.items()))
    print(f"phase 6c (training) took {time.perf_counter() - t_phase:.1f} s")
    return launches


def faulted_serving(card, cfg, params32, params16, streams16):
    """Phase 6c, serving: phase 4's trace under the serving faults, with obs
    on and with an armed watchdog. `streams16` are phase 4b's bf16 streams
    by overlap mode. Returns {run: paged launches}."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.obs import Observability
    from midgpt_tpu_torch.robustness import faults
    from midgpt_tpu_torch.robustness.watchdog import StepWatchdog
    from midgpt_tpu_torch.sampling.serve import parse_overlap

    t_phase = time.perf_counter()
    launches = {}

    def counted(label, params, dtype, spec, plan="", **kw):
        overlap, round_group = parse_overlap(spec)
        faults.clear()
        if plan:
            faults.activate_plan(plan)
        tpl.LAUNCHES.reset()
        tpl.MERGE_LAUNCHES.reset()
        st, streams, wall = serve(cfg, params, dtype, overlap=overlap, round_group=round_group, **kw)
        n, m = tpl.LAUNCHES.count, tpl.MERGE_LAUNCHES.count
        launches[label] = n
        fired = faults.fired_counts()
        faults.clear()
        if plan and fired != {plan.split("@")[0]: 1}:
            raise SystemExit(f"{label}: the fault did not fire once: {fired}")
        if n != cfg.n_layer * device_steps(st) or m != n:
            raise SystemExit(f"{label}: launches {n} / merges {m} != n_layer x device steps {device_steps(st)}")
        return st, streams, wall

    # The faults recompute-preempt (re-prefill) their slots: in f32 that
    # regenerates each stream (a departure only at a near-tie); bf16 rounds
    # the prefill's products otherwise than the decode's, so its streams are
    # printed, not held.
    for precision, params, dtype in (("f32", params32, torch.float32), ("bf16", params16, torch.bfloat16)):
        want = {}
        for spec in ("off", "double"):
            want[spec] = counted(f"{precision} {spec} unfaulted", params, dtype, spec)[1]
        for spec, plan in (("off", "kill_mid_decode@3"), ("double", "kill_overlapped_round@3"),
                           ("off", "poisoned_page@3")):
            label = f"{precision} {spec} {plan}"
            st, got, _ = counted(label, params, dtype, spec, plan)
            keep = [i for i in range(len(got)) if i not in st["poisoned_uids"]]
            print(f"{label}: preemptions {st['preemptions']}, decode_kills {st['decode_kills']}, overlap_kills "
                  f"{st['overlap_kills']}, poisoned uids {st['poisoned_uids']}, paged launches {launches[label]}, "
                  "every page back in the pool")
            if precision == "f32":
                compare_streams(f"{label} vs unfaulted", [got[i] for i in keep], [want[spec][i] for i in keep],
                                cfg, params)
            else:
                same = sum(np.array_equal(got[i], want[spec][i]) for i in keep)
                print(f"{label}: {same} of {len(keep)} streams equal the unfaulted bf16 run's (not held)")
            if "poisoned" in plan and len(st["poisoned_uids"]) != 1:
                raise SystemExit(f"{label}: one slot must be poisoned")
            if "poisoned" not in plan and st["preemptions"] < 1:
                raise SystemExit(f"{label}: the fault must recompute-preempt")

    # obs under group:4, bf16: identical streams; the decomposition and tokens/s beside obs off
    total = sum(m for _, m in trace(cfg.vocab_size))
    rates = {}
    for label, kw in (("obs off", {}), ("obs on", {"obs": Observability()})):
        eng = new_engine(cfg, params16, torch.bfloat16, overlap="group", round_group=4, **kw)
        serve_trace(eng)  # the first pass captures
        tpl.LAUNCHES.reset()
        streams, wall = serve_trace(eng)
        launches[f"group:4 {label}"] = tpl.LAUNCHES.count
        rates[label] = total / wall
        compare_streams(f"bf16 group:4 {label} vs phase 4b", streams, streams16["group:4"])
        if label == "obs on":
            snap = eng.stats()["obs"]
            print(f"group:4 obs on, round decomposition (both passes): {json.dumps(snap['round_decomp'])}; "
                  f"{snap['spans']} spans, {snap['spans_dropped']} dropped")
    print(f"group:4 bf16 second pass end to end: obs off {rates['obs off']:.1f} tokens/s, obs on "
          f"{rates['obs on']:.1f} tokens/s ({100 * (rates['obs on'] / rates['obs off'] - 1):+.1f}%) on {card}")

    # an armed watchdog on the engine, bf16, "double" (every settle in a worker thread)
    wd = StepWatchdog(60.0)
    st, streams, _ = counted("bf16 double watchdog", params16, torch.bfloat16, "double", watchdog=wd)
    compare_streams("bf16 double, armed watchdog (60 s) vs phase 4b", streams, streams16["double"])
    print(f"bf16 double, armed watchdog: {wd.syncs} guarded settles, {wd.expiries} expired")
    if wd.syncs < 1 or wd.expiries:
        raise SystemExit("the engine's watchdog must guard every settle and never expire here")
    print("paged launches on phase 6c's serving paths: " + "; ".join(f"{k}: {v}" for k, v in launches.items()))
    print(f"phase 6c (serving) took {time.perf_counter() - t_phase:.1f} s")
    return launches


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
    busy = sum(by_name.values())
    print("  flash kernels in that step: " + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in flash_us.items())
          + f"; together {sum(flash_us.values()) / 1e3:.3f} ms, {100 * sum(flash_us.values()) / busy:.1f}% of the "
          f"device time (SIMT kernels: wall {SIMT_MICROSTEP[0]} ms, flash {SIMT_MICROSTEP[1]}%)")
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


def flash_flops(B, H, T, C):
    """{kernel: flops of its causal products} at one shape: T (T + 1) / 2
    score pairs per head, 2 C flops per pair and product. The forward has 2
    products (QK^T, PV), dQ 3 (QK^T, dO V^T, dS K), dK/dV 4 (QK^T, dO V^T,
    P^T dO, dS^T Q); the recomputations the kernels add are not counted."""
    product = B * H * T * (T + 1) // 2 * 2 * C
    return {"flash_fwd": 2 * product, "flash_bwd_dq": 3 * product, "flash_bwd_dkv": 4 * product}


def flash_bounds(B, H, T, C, dtype):
    """{kernel: (least ms, what bounds it)} at one shape: each input read
    once and each output written once over 3.35 TB/s, against the causal
    products (flash_flops) over the dense peak of the inputs' type."""
    item = torch.empty((), dtype=dtype).element_size()
    tensor, lse = B * H * T * C * item, B * H * T * 4
    moved = {
        "flash_fwd": 4 * tensor + lse,  # q k v in, out + lse out
        "flash_bwd_dq": 6 * tensor + lse,  # q k v o dO lse in, dq out
        "flash_bwd_dkv": 7 * tensor + lse,  # ... dk dv out
    }
    out = {}
    for name, flops in flash_flops(B, H, T, C).items():
        t_b, t_o = moved[name] / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
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
            if "Compiling entry function" in line:  # the (mangled) kernel the next lines describe
                print(f"  ptxas {src}: {line.split(chr(39))[1][:120]}")
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}: {line.strip()}")
    spilled = [line.strip() for log in build.build_logs.values() for line in log.splitlines()
               if "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    print(f"ptxas: {len(spilled)} kernel instantiation(s) spill" + "".join(f"\n  {line}" for line in spilled))

    # 3. kernels vs plain
    errs = {(dt, s): check_kernel(dt, s) for dt in (torch.bfloat16, torch.float32) for s in (1, 2)}
    for s in (1, 2):
        check_kernel(torch.float32, s, kv_dtype=torch.bfloat16)
    merge_errs = {dt: check_merge(dt) for dt in (torch.bfloat16, torch.float32)}
    spec_errs = {}  # (qdtype, R, int8, split) -> max |err|
    for qdt in (torch.bfloat16, torch.float32):
        for s in (1, 2):
            for R, int8 in [(R, False) for R in VERIFY_ROWS] + [(1, True), (TIMED_ROWS, True)]:
                spec_errs[(qdt, R, int8, s)] = check_spec_kernel(qdt, R, int8, s)
    for int8 in (False, True):
        for s in (1, 2):
            check_rows_bitwise(int8, s)
    gqa_errs = check_gqa_kernels()
    for geometry in GQA_GEOMETRIES:
        for s in (1, 2):
            check_gqa_bitwise(geometry, s)
    free_memory()
    flash_errs = {}
    for label, B, H, T, C, bq, bk, dt in FLASH_CHECKS:
        flash_errs[(label, dt)] = check_flash(label, B, H, T, C, bq, bk, dt)
        free_memory()
    for label, B, H, T, C, bq, bk in FLASH_TIMED[::2]:  # single-visit C 64, tiled C 128
        check_flash_repeat(label, B, H, T, C, bq, bk)
    free_memory()

    # 4. the serving main path, bf16: counters zeroed just before, read just after
    cfg = load_config("openwebtext").model_config
    params32 = GPT.init(cfg, 0, device="cuda")
    params16 = cast_floating(params32, torch.bfloat16)
    tpl.LAUNCHES.reset()
    tpl.MERGE_LAUNCHES.reset()
    stats16, _, wall16 = serve(cfg, params16, torch.bfloat16)
    by_variant = dict(tpl.LAUNCHES.by_variant)
    merge_launches = tpl.MERGE_LAUNCHES.count
    print(f"main path bf16: {json.dumps(stats16)} wall {wall16:.3f} s")
    print(f"kernel launches by (spec, split): {by_variant}; decode steps {stats16['decode_steps']} x {cfg.n_layer} layers")
    launches = {split: n for (spec, split), n in by_variant.items()}
    if {spec for spec, _ in by_variant} != {"decode"} or set(launches) != {1, 2} or min(launches.values()) < 1:
        raise SystemExit(f"the main path must launch the decode spec at split 1 and 2, got {by_variant}")
    if sum(launches.values()) != cfg.n_layer * stats16["decode_steps"]:
        raise SystemExit("kernel launches != n_layer x decode steps: a decode step bypassed the kernel")
    print(f"merge kernel launches: {merge_launches} (one per template call)")
    if merge_launches != sum(launches.values()):
        raise SystemExit("merge launches != template launches: a call bypassed the merge kernel")
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
    busy = {"off": print_busy("decode rounds", wall_us, by_name, card)}
    # 4b. the overlap modes as CUDA-graph replays (after phase 5: its f32 streams are the reference)
    overlap_rates, streams16 = overlap_serving(card, cfg, params32, params16, kernel_streams, gather_streams)
    wall_us, by_name = profile_decode(cfg, params16, warm=3, overlap="group", round_group=4)
    busy["group:4"] = print_busy("group:4 decode rounds (CUDA-graph replays)", wall_us, by_name, card)
    print("decode by overlap mode, bf16 (" + card + "): " + "; ".join(
        f"{spec} {dec:.1f} tokens/s in rounds, {e2e:.1f} tokens/s end to end" for spec, (dec, e2e)
        in overlap_rates.items()) + "; device busy " + ", ".join(
        f"{spec} {'not measured' if b is None else f'{100 * b:.1f}%'}" for spec, b in busy.items()))
    # 5b. speculative serving, bf16 and int8: counters zeroed just before each run, read just after
    spec_launches_by_run = spec_serving(card, params32, params16, kernel_streams)
    # 6c(e). the serving faults, obs and the engine's watchdog on phase 4's trace
    faulted_serving(card, cfg, params32, params16, streams16)
    del params32, params16
    free_memory()

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp)
        synthetic_stream(data_dir, load_config("local_text_124m").model_config.vocab_size)
        # 5c. the GQA and window slice: train both variants, serve what they wrote
        rundirs = {variant: data_dir / variant for variant in GQA_VARIANTS}
        for variant, rundir in rundirs.items():
            train_variant(data_dir, rundir, variant, card)
            free_memory()
        gqa_launches, window_launches = gqa_serving(card, rundirs)
        for rundir in rundirs.values():
            shutil.rmtree(rundir)  # two checkpoint steps each
        free_memory()
        # 6. the training main path: counters zeroed just before, read just after
        flash_launches, train_tok_s, train_mfu, _ = train_main_path(data_dir, card)
        free_memory()
        # 6b. checkpoints and resume on the main path: counters zeroed just before the resumed run
        _, round_trip, straight_dir = resume_main_path(data_dir, card)
        free_memory()
        # 6c(a-d). the supervised trainer: rollback, hang restart, SIGTERM, the armed watchdog
        supervised_main_path(data_dir, straight_dir, round_trip, card)
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
            spec = "decode" if dt == torch.bfloat16 else "f32 decode"
            print(f"paged_attention_decode {str(dt)[6:]} split_k={s}: {ms:.4f} ms device (graph replay, cold L2; "
                  f"{eager_ms:.4f} ms per eager call with host) bound {b_ms:.4f} ms by {b_by}, "
                  f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms; {paged_vs_earlier(spec, s, ms, lib_ms)} on {card}")
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
    timed = [("paged_attention_verify", TIMED_ROWS, False, "bf16", "verify"),
             ("paged_attention_int8_decode", 1, True, "int8", "int8-decode"),
             ("paged_attention_int8_verify", TIMED_ROWS, True, "int8", "int8-verify")]
    for kname, R, int8, run, spec in timed:
        for s in (1, 2):
            ms, plain_ms, lib_ms, (b_ms, b_by) = time_spec_kernel(torch.bfloat16, R, int8, s)
            print(f"{kname} ({spec_label(torch.bfloat16, R, int8)}) split_k={s}: {ms:.4f} ms device (graph replay, "
                  f"cold L2) bound {b_ms:.4f} ms by {b_by} ({ms / b_ms:.1f}x), plain {plain_ms:.3f} ms, "
                  f"sdpa {lib_ms:.4f} ms; {paged_vs_earlier(spec, s, ms, lib_ms)} on {card}")
            kernels.append({
                "name": f"{kname}[bf16,R={R},split_k={s}]",
                "route": "cuda",
                "source": "midgpt_tpu_torch/csrc/paged_attention.cu",
                "replaces": "midgpt_tpu/kernels/attention_template.py:95",
                "launches": spec_launches_by_run[run].get((spec, s), 0),
                "max_abs_err": spec_errs[(torch.bfloat16, R, int8, s)],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": lib_ms,
            })
        free_memory()
    g_heads = GQA_GEOMETRIES["main"][1:3]
    timed_gqa = [("paged_attention_gqa_decode", 1, 0, gqa_launches, "gqa-decode", "attention_template.py:226"),
                 ("paged_attention_gqa_verify", TIMED_ROWS, 0, gqa_launches, "gqa-verify",
                  "attention_template.py:226"),
                 ("paged_attention_window_gqa_decode", 1, WINDOW, window_launches, "window-gqa-decode",
                  "attention_template.py:141")]
    for kname, R, window, run, spec, replaces in timed_gqa:
        for s in (1, 2):
            ms, plain_ms, lib_ms, (b_ms, b_by), copies = time_gqa_kernel(R, window, s)
            print(f"{kname} ({spec} R={R}, {g_heads[0]} query heads over {g_heads[1]} K/V heads"
                  f"{f', window {WINDOW} + {SINKS} sinks' if window else ''}, bf16) split_k={s}: {ms:.4f} ms device "
                  f"(graph replay over {copies} copies, cold L2) bound {b_ms:.4f} ms by {b_by} ({ms / b_ms:.1f}x), "
                  f"plain {plain_ms:.3f} ms, sdpa over K/V repeated to the query heads {lib_ms:.4f} ms; "
                  f"{paged_vs_earlier(spec, s, ms, lib_ms)} on {card}")
            kernels.append({
                "name": f"{kname}[bf16,R={R},split_k={s}]",
                "route": "cuda",
                "source": "midgpt_tpu_torch/csrc/paged_attention.cu",
                "replaces": f"midgpt_tpu/kernels/{replaces}",
                "launches": run.get((spec, s), 0),
                "max_abs_err": gqa_errs[("main", torch.bfloat16, R, torch.bfloat16, window, s)],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": lib_ms,
            })
            free_memory()
    ms, plain_ms, b_ms, n_parts = time_merge()
    print(f"paged_attention_merge bf16 ({SLOTS} slots, {n_parts} partitions, {HEADS} heads, 1 row, C {HEAD_DIM}): "
          f"{ms:.4f} ms device (graph replay, cold L2) bound {b_ms:.5f} ms by bytes ({ms / b_ms:.1f}x), "
          f"plain {plain_ms:.4f} ms on {card}")
    kernels.append({
        "name": f"paged_attention_merge[bf16,parts={n_parts}]",
        "route": "cuda",
        "source": "midgpt_tpu_torch/csrc/paged_attention.cu",
        "replaces": "midgpt_tpu/kernels/attention_template.py:314",
        "launches": merge_launches,
        "max_abs_err": merge_errs[torch.bfloat16],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": "bytes",
        "library_ms": None,
    })
    free_memory()
    from midgpt_tpu_torch.kernels import flash_attention as fa

    for label, B, H, T, C, bq, bk in FLASH_TIMED:  # the main path's shape first
        f_ms, f_plain, f_lib = time_flash(B, H, T, C, bq, bk)
        free_memory()
        bounds = flash_bounds(B, H, T, C, torch.bfloat16)
        variants = fa._variants(T, fa._block_sizes(T, bq, bk)[1])
        flops = flash_flops(B, H, T, C)
        for kname, variant, simt_ms in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), variants,
                                           FLASH_SIMT_MS[label]):
            b_ms, b_by = bounds[kname]
            lib_what = "sdpa forward" if kname == "flash_fwd" else "sdpa backward (dq, dk and dv in one call)"
            print(f"{kname} [{variant}] {label} bf16 B={B} H={H} T={T} C={C} blocks=({bq},{bk}): "
                  f"{f_ms[kname]:.4f} ms device ({flops[kname] / f_ms[kname] / 1e9:.1f} TFLOP/s), SIMT "
                  f"{simt_ms:.3f} ms ({simt_ms / f_ms[kname]:.1f}x faster), bound {b_ms:.4f} ms by {b_by} "
                  f"({f_ms[kname] / b_ms:.1f}x), plain {f_plain[kname]:.3f} ms, {lib_what} "
                  f"{f_lib[kname]:.4f} ms on {card}")
        bwd_ms = f_ms["flash_bwd_dq"] + f_ms["flash_bwd_dkv"]
        print(f"flash {label}: forward {f_ms['flash_fwd'] / f_lib['flash_fwd']:.2f}x sdpa's forward, backward "
              f"pair {bwd_ms:.4f} ms = {bwd_ms / f_lib['flash_bwd_dq']:.2f}x sdpa's backward on {card}")
        if label == FLASH_MAIN[0]:
            print("flash targets at the main path's shape (4x faster than the SIMT kernels): " + ", ".join(
                f"{kname} {f_ms[kname]:.4f} ms vs {target} ms {'met' if f_ms[kname] <= target else 'MISSED'}"
                for kname, target in FLASH_TARGET_MS.items()))
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
    decode_modes = {spec: {"decode_tokens_per_s": dec, "end_to_end_tokens_per_s": e2e,
                           "busy_share": busy.get(spec)} for spec, (dec, e2e) in overlap_rates.items()}
    print(json.dumps({"kernels": kernels, "decode_modes": decode_modes}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
