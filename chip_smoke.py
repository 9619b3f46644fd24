#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (midgpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port still starts on the card. Phases as
numbered below; any failure ends the run with a non-zero exit (nothing is
caught). They run in this order: 1-4 and 6 alone; then 5c-11c beside the
"serving" lane (11d, 12-15) and phase 20's ranks (phase 21's and 22's
runs in 20's groups, then their restores on one rank); then 17-19 and
20's and 21's verdicts beside the "decode" lane (5, 4b, 5b, 6c(e), 22c);
then 16 and 22's verdicts, and 10 alone. A lane is a process of its own
(`chip_smoke.py --lane NAME OUT`): serving holds the host most of the
time, training waits on the card, so the two share it; each phase's wall
seconds are printed, and every number a lane prints is taken beside the
training phases it ran with. The card's memory in use by every process
is sampled throughout (nvidia-smi) and printed, its most in each 10 s,
at the end, or after the error when a phase fails; each rank group
prints when its launches ran, in seconds of the script, and a failed
group prints its ranks' own errors last:

  1. require CUDA and the port's sources beside this script; print the
     card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from midgpt_tpu_torch/csrc (one
     nvcc per source, all started together; ptxas report printed: each
     instantiation's registers and spills, the paged template's
     tensor-core, SIMT and merge kernels among them, and each flash
     kernel's registers causal beside causal=False);
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
        inputs, bit for bit (no atomics); then the causal=False kernels
        (ring attention's off-diagonal pairs: no mask, dK/dV over every
        query tile) the same way at the main path's shape, at a C 128
        shape (B 1, H 32, T 2048, blocks (512, 1024): the tiled bodies)
        and at the ragged T, bf16 and f32, and two launches bit for bit
        at the first two;
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
     the final step's checkpoint verified; every token window must come
     from the native C batcher (midgpt_tpu_torch/native, built from the
     checkout's batcher.c with the system C compiler), none from numpy's
     gather;
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
     (a) `fault_plan=nan_grad@3` under an armed 60 s watchdog (its guarded
     syncs timed, step 2's tokens/s beside the unarmed run's; the armed
     run of its own, (d), was cut: (b) holds an armed run bit for bit to
     the straight one): one rollback to step 2, window
     [3, 3] skipped, offset 1 (JAX's formula), a finite final loss, the
     ledger on disk, the rollback's seconds (the flight recorder's
     divergence instant to the next attempt's first step) and
     torch.cuda.memory_allocated before and after (the failed attempt's
     state must not outlive the run); (b) `hang_step@3` under a watchdog
     three times the longest sync of (a) (at least 2 s): hung_steps [3],
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
     departure allowed only at a near-tie) and on the bf16 pool; each
     fault fires once, pages conserved, launches == n_layer x device steps;
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
 11. (run after phase 9) the six presets' slice, each number beside the
     card's name and power limit:
     a. `wide610m` through the launcher at full width and depth (8 x 2048,
        16 heads of 128, microbatch 12, T 1024, split RoPE, flash), cut
        only in steps and eval (printed), with no run directory: finite
        losses, tokens/s and MFU of the steady steps, peak memory, and
        flash launches (single-visit bodies only) == n_layer x
        (microsteps + eval batches) forward, n_layer x microsteps each
        backward;
     b. the same cut for 2 steps with remat off and under each remat
        policy: peak memory, tokens/s and flash_fwd launches per policy
        (n_layer x (2 microsteps + eval batches) under 'none' and 'dots',
        which recompute the forward; n_layer x (microsteps + eval batches)
        otherwise); losses and final parameters == the remat-off run's bit
        for bit, or within the train-step tolerances (printed);
     c. `openwebtext_xl` (24 x 2048) at microbatch XL_BATCH, 2 steps, its
        own remat policy ('dots') against remat off: peak memory, tokens/s,
        equal losses;
     d. (in the serving lane, first) `llama7b_long` served in bf16 at
        full width, its depth cut to
        LLAMA_LAYERS (4 of 32, the script's time), through
        `sample.main --config=llama7b_long --start_ids=...`: 4 greedy
        requests of one prompt (identical streams, each its budget), the
        weights' and the paged pool's bytes, init seconds, peak memory,
        decode tokens/s, and paged (and merge) launches == n_layer x
        decode steps;
     Every `sample.main` call of phases 5b, 5c, 6b and 11d passes
     `--engine=continuous` (the batch engine is the default, as in JAX);
 12. (in the serving lane, after 11d) the batch sampler (`sample --engine batch`,
     sampling/engine.py `generate`): the prompt is a 37-token text through
     data/local_text's HF BPE codec where `tokenizers` imports, else its
     ids (printed). a. `sample.main --config=local_text_124m --engine=batch
     --temperature=0` on random bf16 weights from seed 0, B 1 and 8, 256
     new tokens, and a 1000-token prompt with 40 new tokens that crosses
     the cache (15 windowed forwards); flash counters zeroed just before
     each run and read just after: flash_fwd launches == n_layer x (1 +
     overflow tokens), all single-visit; chunks == JAX's rule; one capture
     and a replay per decoded step; every row its budget, rows identical.
     Then on the same weights, decode tokens/s with the step replayed and
     eager (one `generate` call each, in turns, the eager one of
     EAGER_NEW tokens; tokens bit for bit sample.main's), the device
     busy share of a replayed chunk of 64 steps (torch.profiler), and the step's byte bound (weights and the whole
     cache over 3.35 TB/s); b. the same for wide610m (C 128), B 8, 128 new
     tokens; c. f32 on local_text_124m's weights: batch greedy streams of
     4 prompts == the continuous engine's (a departure only at a near-tie,
     as 5b), replayed == eager bit for bit, and the flash forward at each
     of the phase's prompt lengths (37, 1000, 1024) in bf16 and f32 ==
     its plain version (timed in phase 10, beside its bound, its plain
     version and SDPA's forward);
 13. (in the serving lane, after 12) the serving front door at GPT-2 small's full width
     (openwebtext's model, random weights from seed 0): a. the paged kernel
     on page tables that alias physical pages across slots, as prefix-cache
     hits make them, bf16 and f32, split 1 and 2, against its plain version;
     b. `loadgen.main` in process (Poisson, 24 requests at two offered
     loads, half of them template-headed, group:4, 4 slots, 513 pages of
     8, bf16 pool) with the prefix cache off (c's run is the cache on):
     TTFT and TPOT p50/p95, shed and timeout fractions, no capture inside a
     timed point, paged launches == n_layer x decode steps; then a template
     trace served directly with
     the cache on and off, f32 streams identical, bf16 ones identical or
     departing at a near-tie; c. the same loadgen trace with the prefix
     cache on and --hot-swap (prefix_hit_rate and the prefill tokens the
     trie saved per point, TTFT beside b's; each point flips once, with no
     capture), then in f32 two requests
     admitted after a flip under load == a fresh engine's on the new
     weights, bit for bit, with no capture after the flip; d. phase 4's
     trace under group:1 in f32 and on an int8 pool, grown at round 3 and shrunk at
     round 6 by the pool_resize fault: conservation at every round, streams
     == the run without a resize, each migration's ms, and device memory
     after the shrink within the new pool's size of the value before the
     grow; e. pool_hbm_bytes = 1 GiB gives JAX's num_pages for bf16, int8
     and GQA (3 K/V heads) pools;
 14. (in the serving lane, after 13) serving chaos, the fleet and disagg at GPT-2
     small's full width (random weights from seed 0; phase 13's template
     trace at seed 14, whose two heads hash to different replicas): a. two
     replicas behind a FleetRouter with the prefix cache on, group:4, f32
     and bf16: the placement by head, the fleet-wide prefix_hit_rate
     against one engine's, streams == one engine's (f32 bit for bit, bf16
     or a near-tie); every fleet run prints its failovers, crash log and
     the replica steps that raised, and fails on any failure outside its
     plan; b. f32 faults on the fleet: engine_crash at router
     round 4 (zero drops, failovers 1, every stream == one engine's,
     device memory before and after the crash), the staged spill with
     spill_corrupt and with handoff_stall (caught, ledger closed, no token
     mismatch), the ms per page of a spill and of a re-adoption and the
     host bytes a page (bf16, f32, int8), and an int8 pair whose re-adopted
     pages carry their scales (streams == the int8 engine's); c. a
     DisaggServe pair on one card (prefill role 2 slots, chunk 256; decode
     role 4 slots, group:4 and off, bf16 and f32): pages shipped, gather
     and adopt ms a page, no capture in the timed pass, streams == a
     monolithic engine's (f32 bit for bit under both modes; bf16 or a
     near-tie within GAP_TOL_BF16_RECHUNK, and the off run's bf16 streams
     == the group:4 run's exactly), one rebalance with conservation on both roles,
     one ModelOps re-role on a scripted backlog; d. the kernel at the tiny
     model's head_dim 16 against its plain version, then the 11 in-process
     chaos scenarios of JAX's tests/test_chaos_serve.py through
     `chaos_serve.main` (each line "status": "ok"); e. `loadgen --fleet 2`
     at half the rate a saturating fleet pass sustained (FLEET_SATURATED_RPS).
     Paged launches == n_layer x decode steps in every run of a-e (in d
     summed over the engines each scenario builds); the kernels line's
     paged entries take phases 13-14's bf16-pool launches only, and the
     f32, int8 and tiny-model ones are printed by pool beside it;
 15. (in the serving lane, after 14) the worker-process fleet (sampling/fleet_proc.py)
     at GPT-2 small's full width (random weights from seed 0 in every
     worker; phase 14's template trace at seed 14): eight workers spawned
     together (`python -m midgpt_tpu_torch.sampling.fleet_worker`, JAX's
     worker engine: overlap off, 4 slots, pages of 8), each one's
     spawn-to-PORT seconds printed. a. a fleet of two f32 workers and one of
     two bf16 workers, each against its own reference worker: f32 8/8 bit
     for bit, bf16 8/8 or a near-tie under GAP_TOL; RPC p50/p95; this
     process launches no kernel and captures no graph; every worker's paged
     and merge launches, read over its stats RPC, == n_layer x its decode
     steps; b. proc_kill9 at router round KILL_ROUND on the f32 fleet: one
     proc failover detected through the wire, streams failed over, f32 8/8,
     seconds from the kill to the failover, and the card's memory per
     process (nvidia-smi) and in use before and after the kill; c.
     conn_drop, wire_corrupt and wire_stall, one run each on the survivor
     and the reference worker: the kind's transport counter >= 1, no
     failover, f32 8/8; d. SIGTERM to a bf16 worker with four streams in
     flight: they finish, a new request is refused without retry, the
     worker exits 0 (seconds printed); e. two int8 workers: the first
     serves the trace, flushes its trie into its tier, the pages move to
     the second over the wire (wire bytes and ms a page each way), both
     ledgers close, and the second's streams on re-adopted pages equal the
     first's; f. chaos_serve's proc_kill9 worker-process scenario (tiny
     model, a subprocess started with the phase, beside a-e): its line
     "status": "ok"; g.
     `loadgen --procs --fleet 2` (bf16 workers, overlap off): a saturating
     point, then half PROC_SATURATED_RPS: TTFT, TPOT and RPC p50/p95, wire
     bytes, no failover. The workers' bf16-pool launches go to the kernels
     line's paged entries; f32 and int8 are printed by pool beside them;
 16. (run after phases 15 and 17-19) the routed MoE MLP at GPT-2 small's full width:
     local_text_124m with `--set model_config.n_experts=8 --set
     model_config.moe_top_k=2 --set moe_aux_coef=0.01`. a. the launcher on
     phase 6's cuts (no run directory), flash counters zeroed just before
     and read just after (n_layer per microstep and eval batch, single-visit
     bodies): finite losses, the aux term of every step (>= 1), tokens/s,
     MFU in JAX's active-expert accounting and the MFU of the executed
     (all-expert) FLOPs, peak memory and the remat setting; then one f32
     step (after one at lr 0), 2 layers at full width, through the flash
     kernels against dense attention at phase 7's limits. b. the trained
     weights served on phase 4's trace: bf16 group:4 twice (the first pass
     captures), paged launches == n_layer x device steps and a merge per
     template call, the passes equal, == the eager engine but at a
     near-tie under GAP_TOL; f32 kernel == gather streams; `generate` B 8
     (distinct prompts of phase 12's length, MOE_BATCH_NEW new; the eager
     calls EAGER_NEW) replayed == eager bit for bit, flash_fwd n_layer per
     prefill; decode tokens/s beside the dense model's of phases 4b and 12a. Its launches join the
     kernels line's flash (C 64), paged decode and merge entries;
 17. (run after phase 11c and the serving lane) data-parallel and FSDP
     training on
     torch.distributed (parallel/): ranks started by `python -m
     torch.distributed.run --standalone`, each this script with `--rank17`
     running `launch --multihost` and reporting its records, flash
     launches (checked per rank: n_layer per microstep and eval batch),
     peak memory and state bytes; any rank's failure fails the phase.
     a. one rank over NCCL on phase 6's run: its losses == phase 6's bit
     for bit. b. two ranks sharing the card over gloo on CUDA tensors
     (named explicitly: NCCL refuses two ranks of one communicator on one
     card): the f32 pair (local_text_124m at 2 layers of full width,
     attn_block_size 512: the tiled bodies, fsdp 2, warmed up in one step
     so that its updates move the weights) against the same run on one
     NCCL rank (after 17a's run, in its group), its losses and final eval
     at PAIR_TOL and its final params, mu and nu at STATE_TOL, then
     openwebtext_xl (fsdp 8 clamps to 2) at phase 11c's cut against 11c's
     single-device losses at XL_DP_TOL, each rank's peak memory beside
     11c's and its master weights and moments at most half (+1%) of the
     whole. 17a's group runs beside 17b's. c. `chaos_train` on 2 ranks
     over gloo, in f32 and warmed up in one step, with
     resume_reshard at data step 2 on phase 6's cuts (the restore onto
     more ranks is 19c's): mesh_history [2, 1],
     loss_parity, each step's loss the uninterrupted run's (on the final
     rank count) at its f32 PARITY_RTOL and the final states at STATE_TOL.
     The ranks' flash launches (a and b) join the kernels line's flash
     entries by head dim;
 18. (started before phase 17 and run beside it) tensor-parallel serving
     (parallel/serve_tp.py, ServeEngine(mesh=)): 4 ranks started by `python
     -m torch.distributed.run --standalone`, each this script with
     `--rank18`, sharing the card over gloo on CUDA tensors (NCCL refuses
     two ranks of one communicator on one card; each all-reduce stages
     through the host, so no time here is a speed of tensor parallelism).
     a. openwebtext at full width and depth (12 heads, 6 a rank), tp 2 on
     ranks 0-1, f32 on phase 4's trace: both ranks' streams == phase 5's
     single-device f32 streams but at a near-tie under GAP_TOL; the paged
     kernel == the gather on each rank's shard (its pool's 6 heads, split
     1 and 2); each rank's prefill logits against the whole weights at
     TP_LOGIT_RTOL; paged (and merge) launches per rank == n_layer x
     decode steps. b. (ranks 2-3, beside a) the bf16 pool (== phase 4b's
     bf16 off streams but at a near-tie under GAP_TOL_BF16_RECHUNK), a
     bf16 self-draft round (== the tp plain streams the same way; verify
     launches n_layer per round, draft launches 4 per draft step), the
     int8 pool (== a single-device int8 engine's the same way). c. DisaggServe on a (data 2, tp 2) mesh over
     the 4 ranks, f32: == phase 5's streams but at a near-tie, pages
     crossed from each prefill shard to its decode shard, no re-prefill,
     the decode row's launches == n_layer x its decode steps, the prefill
     row's none. d. `loadgen --tp 2 --backend gloo` at one low rate
     (TP_LOADGEN_ARGS: 2 layers of full width): the serve_slo line carries
     mesh {"data": 1, "tp": 2}, every request completes. Each rank's peak
     memory and per-shard pool bytes are printed; b's and d's launches
     join the kernels line's bf16 paged entries;
 19. (started when phase 18's ranks exit, beside phase 17) tensor-parallel
     training (parallel/tp.py TPTrain, the 2D specs of parallel/fsdp.py):
     `launch --multihost --set mesh.tp=2` on gloo ranks sharing the card
     (no time here is a speed of tensor parallelism), three groups side by
     side. a. 17b's f32 pair on (data 1, tp 2), tp_vocab on and off, held
     to 17a's one-rank run of it (losses at PAIR_TOL, final states at
     STATE_TOL). c. the pair on 4 ranks: (fsdp 2, tp 2) under gspmd, held
     the same way; and steps 0-2 on (data 2, tp 2), their checkpoint
     restored into (fsdp 2, tp 2) shards under shard_map for step 3 and
     the final eval, in the same group, held the same way. b.
     local_text_124m at full width and depth, bf16, tp 2, phase 6's cuts
     one step short: losses at TP_MAIN_TOL of phase 6's, each rank's peak
     memory and state bytes (at most half + 1%); its checkpoint restored
     on one device trains phase 6's last step, whose loss is held at
     TP_MAIN_TOL and whose moments leaf by leaf at TP_MOMENT_RTOL to phase
     6's. Flash launches per rank and launch == n_layer x (microsteps +
     eval batches) forward, n_layer x microsteps of each backward; they
     join the kernels line's flash entries;
 20. (its ranks beside phases 5c-11c, its verdicts after 17's, before 19's) sequence-parallel
     training (parallel/ring_attention.py, parallel/ulysses.py): `launch
     --multihost --set mesh.sp=N --set model_config.attn_impl=ring|ulysses`
     on gloo ranks sharing the card (each ring hop stages its K/V shard
     through the host: no time here is a speed of sequence parallelism).
     a. 17b's f32 pair with its sequence split over 2 and over 4 ranks,
     the ring and then Ulysses in each group, held to 17a's one-rank
     flash run of it: losses at PARITY_TOL's f32 loss bound, the
     parameter update at its update bound. b. llama7b_32k at its full
     width (n_embd 4096, 32 heads of 128, vocab 50,304, T 32,768) cut to
     2 layers and batch 1, bf16, 2 steps: the ring on sp 2 against one
     rank's flash run at T 32,768 on the same weights and batch, losses at
     LLAMA_SP_TOL. Each rank's causal launches as phase 19's; its
     causal=False launches n_layer x (sp - 1) per microstep and eval batch
     (forward) and per microstep (each backward), the same on every rank
     (Ulysses: none); each rank's peak memory and the ring's hop bytes
     printed. Its launches join the kernels line's flash entries, the
     causal=False ones its causal=False entries;
 21. (its 2-rank runs after phase 20a's sp 2 runs in their group, its
     4-rank runs before 20a's sp 4 runs in theirs, its restore on one rank
     after phase 20's ranks, all beside 5c-11c: no group of its own but
     the restore's, so no start-up and no memory beyond those groups'; its
     verdicts after 20's) pipeline training (parallel/pipeline.py): `launch --multihost
     --set mesh.pp=2 --set pipeline_schedule=gpipe|1f1b --set
     pipeline_microbatches=M` on gloo ranks sharing the card (each stage
     send stages its activation through the host: no time here is a speed
     of pipeline parallelism). a. 17b's f32 pair, one layer a stage, 4
     pipeline microbatches: GPipe and 1F1B on pp 2, 1F1B on (fsdp 2, pp
     2), GPipe on (tp 2, pp 2), held to 17a's one-rank run of it (losses
     at PP_PAIR_TOL, final states at STATE_TOL). b. local_text_124m at full
     width and depth, bf16, pp 2 (6 layers a stage), 4 pipeline
     microbatches of 4 rows, phase 6's cuts one step short: GPipe and
     1F1B, losses at TP_MAIN_TOL of phase 6's; GPipe's checkpoint restored
     on one device (this process, at the verdicts) trains phase 6's last
     step at TP_MAIN_TOL; 1F1B at 16 pipeline microbatches of the same
     rows, its microstep's peak per rank within PP_STASH_GROWTH of M 4's,
     the stash at most 2 pp. Each rank's
     tokens/s (the leader's), stage sends and bytes, stash high-water mark
     and peak memory printed; flash launches per rank == the stage's
     layers x pipeline microbatches x (microsteps + eval batches) forward,
     x microsteps each backward; they join the kernels line's flash
     entries. Phase 17b's openwebtext_xl ranks print their init's peak
     (sharded at birth) beside their shards plus one drawn piece, which
     it may not exceed, and the dense init's whole weights;
 22. (22a's one rank after 20b's one rank, its ep runs after 21's in
     20a's groups, beside 5c-11c, its verdicts in a thread beside 17's
     start; 22b's one device after 17a's runs, its ep 2 run after 19a's
     in 19a's group, its restore in this process after 19's verdicts, its
     verdicts after phase 16; 22c in the decode lane) expert-parallel MoE training
     (parallel/tp.py EPTrain):
     `launch --multihost --set mesh.ep=2` with phase 16's routed MLP (8
     experts, top-2, aux 0.01) on gloo ranks sharing the card (each f and
     g stages through the host: no time here is a speed of expert
     parallelism). a. 17b's f32 pair with the routed MLP (microbatch 4 x
     2, one step at lr 0) on one rank (its routing recorded), then on ep 2
     and on (fsdp 2, ep 2) with the one rank's routing pinned (a token
     whose own top-2 differs takes the pinned experts; its K/K+1 router
     logit gap must be under GAP_TOL): losses at PAIR_TOL of the one
     rank's, the Adam moments at STATE_TOL, the weights bit for bit. b.
     local_text_124m with the routed MLP at full width and depth, bf16,
     microbatch 2 x 16 (phase 16a's 32 windows a step): step 0 on ep 2,
     its checkpoint restored on one device (saving nothing: the machine
     takes 45 GiB of disk writes) for steps 1 and 2, both routed
     as one device on the same cuts routed (pinned; on that device's
     weights a token the pin overrode must sit within EP_BF16_GAP_TOL):
     losses at TP_MAIN_TOL of that device's (phase 16a's printed beside).
     Each rank's peak memory, its expert banks' bytes (== one device's
     over ep) and its ep all-reduces with their bytes printed; flash
     launches per rank == n_layer x (microsteps + eval batches) forward,
     x microsteps each backward; they join the kernels line's flash
     entries. c. (host only, in the decode lane) the native batcher built
     from the checkout's C: its windows == numpy's bit for bit at
     tools/bench_batcher.py's shapes over a seeded 200M token uint16
     stream, numpy and native ms printed;
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
     3.35 TB/s). The flash kernels also at wide610m's shape (B 12, H 16,
     T 1024, C 128), beside their bounds and SDPA, and the flash forward
     at phase 12's first five prefill shapes, beside its bound, its plain
     version and SDPA's forward. Then the causal=False kernels at a ring
     pair of llama7b_32k's heads (B 1, H 32, T 8192, C 128: the largest
     whose plain backward fits beside its inputs), beside their plain
     versions, their bounds (every (query, key) pair's products) and SDPA
     with is_causal=False, and at phase 20b's pair (T 16,384; kernels and
     SDPA). The "kernels" line carries the main paths' numbers, and phase
     11a's flash launches under the C 128 entries.

The last lines are the card's name and power limit as nvidia-smi prints
them, one JSON object with a "kernels" list (flash_fwd's launches include
phase 12's; the paged decode, int8 and merge entries include phases 13's
and 14's, and phase 15's launches made in its bf16 workers; the C 64
flash, paged decode and merge entries include phase 16's; the flash
entries include phase 17's, 19's, 20's, 21's and 22's ranks'; the causal=False flash
entries are phase 20's ranks'; the bf16 paged decode,
verify, int8 decode and merge entries include phase 18's ranks'), phase 4b's "decode_modes" (tokens/s and busy share per
overlap mode) and phase 12's "batch_decode" (replayed and eager tokens/s
and the replayed chunk's busy share per cell), and the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import types
import typing as tp
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
# 14c, bf16 only: the decode role prefills each prompt's partial last page
# and the first token in a chunk of its own through the gather lowering,
# where the monolithic engine wrote that tail in its prompt chunk and the
# first token's K/V in a decode step through the paged kernel, so those
# bf16 K/V round differently; a departure whose f32 top-2 gap is within 4
# bf16 ulps (2^-8 relative each) is a near-tie at that precision. The
# decode role's off run is held to its group:4 run exactly, and f32 to the
# monolithic engine bit for bit under both modes: adoption itself, with a
# round in flight or not, moves no token
GAP_TOL_BF16_RECHUNK = 2.0**-6
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
# phase 11a: wide610m's training shape (microbatch 12, 16 heads of 128)
FLASH_WIDE = ("wide610m", 12, 16, 1024, 128, 512, 1024)
FLASH_CHECKS.append((*FLASH_WIDE, torch.bfloat16))
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
# phase 11: the cuts of wide610m (a) and of the remat runs (b, c), printed
WIDE_CUTS = {"max_steps": 4, "eval_steps": 1, "eval_interval": 1000}
REMAT_CUTS = {"max_steps": 2, "eval_steps": 1, "eval_interval": 1000}
REMAT_POLICIES = (None, "none", "dots", "dots_attn", "flash")  # None: remat off
XL_BATCH = 8  # openwebtext_xl's microbatch (preset 1024) that fits with remat off and on
LLAMA_PROMPT = 64  # llama7b_long's prompt length; 4 requests of 32 new tokens
# phase 11d: llama7b_long's depth, cut from 32 layers to keep the script
# near its time budget once phase 15 was added (PERF.md, phase 11d), to 8,
# and to 4 once phase 18 was (PERF.md, section 4); the width, heads, vocab
# and context are the preset's
LLAMA_LAYERS = 4
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


class PhaseClock:
    """The wall seconds of each phase of `main`, in order: each mark closes
    the phase since the one before."""

    def __init__(self):
        self.t, self.spans = time.perf_counter(), []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.spans.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return "; ".join(f"{name} {secs:.1f} s" for name, secs in self.spans)


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


MEMORY_PERIOD_MS = 500  # the card's memory in use, sampled by nvidia-smi this often
MEMORY_BUCKET_S = 10  # the summary's time buckets


class MemoryWatch:
    """The card's memory in use by every process on it (ranks, lanes and
    this one), sampled by an `nvidia-smi --loop-ms` process of its own, so
    that nothing here touches this process's CUDA context or a graph
    capture. Times are seconds since `t0` (time.time(), the script's
    start), as `torchrun` prints its launches', so a peak can be placed
    beside the phases and rank launches that made it."""

    def __init__(self, t0: float):
        import threading

        self.t0, self.samples, self.total = t0, [], None
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader,nounits",
             f"--loop-ms={MEMORY_PERIOD_MS}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                used, total = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.total = total
            self.samples.append((time.time() - self.t0, used))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.thread.join(timeout=5)

    def line(self) -> str:
        """The most in use and when, then the most in each bucket (GiB)."""
        if not self.samples:
            return "card memory in use: no nvidia-smi sample"
        t_most, most = max(self.samples, key=lambda s: s[1])
        buckets = collections.defaultdict(float)
        for t, used in self.samples:
            buckets[int(t // MEMORY_BUCKET_S)] = max(buckets[int(t // MEMORY_BUCKET_S)], used)
        return (f"card memory in use (nvidia-smi every {MEMORY_PERIOD_MS} ms, every process): most {most:.0f} of "
                f"{self.total:.0f} MiB at {t_most:.1f} s; the most in each {MEMORY_BUCKET_S} s from the start (GiB): "
                + " ".join(f"{buckets.get(i, 0.0) / 1024:.1f}" for i in range(max(buckets) + 1)))


MEMORY: tp.Optional[MemoryWatch] = None  # the main process's, started by `main`
T_START = time.time()  # this process's start: rank launches and memory samples are placed against it


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


def compare_streams(label, got, want, model_cfg=None, params=None, gap_tol=GAP_TOL):
    """Greedy streams must be identical. With `params` (speculative vs plain
    decode), a departure is allowed only at a near-tie: the run prints the
    first departing position and the top-2 logit gap there (a dense f32
    forward of the plain stream's prefix) and fails unless the gap is under
    `gap_tol` relative."""
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
              f"(tol {gap_tol:g})")
        if gap >= gap_tol:
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
    sample.main(["--config=local_text_124m", "--engine=continuous", "--start_ids=50,11,3", "--num_samples=2",
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
    sample.main([f"--ckpt_dir={rundir}", "--engine=continuous", "--start_ids=50,11,3", "--num_samples=2",
                 "--max_new_tokens=24", "--temperature=0", *extra])
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


def check_flash(label, B, H, T, C, bq, bk, dtype, causal=True):
    """Phase 3b: the three flash kernels vs the plain version on the same
    inputs (the backward from the kernel's own out and lse, on both
    sides), causal or full (causal=False: ring attention's off-diagonal
    pairs). Tolerances: out as the paged kernel's; lse 1e-5 abs+rel;
    gradients tol * max|plain| absolute plus tol relative. Returns the
    max |err| of each output."""
    from midgpt_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = flash_problem(B, H, T, C, dtype)
    out, lse = fa.flash_forward(q, k, v, bq, bk, causal=causal)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, bq, bk, causal=causal)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_forward_plain(q, k, v, bq, bk, causal=causal)
    want_grads = fa.flash_backward_plain(q, k, v, out, lse, do, bq, bk, causal=causal)
    label = label if causal else f"{label}, causal=False"
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


def check_flash_repeat(label, B, H, T, C, bq, bk, causal=True):
    """Phase 3b: two launches of each flash kernel on the same bf16 inputs
    give the same bits of out, lse, dq, dk and dv (no atomics)."""
    from midgpt_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = flash_problem(B, H, T, C, torch.bfloat16, seed=5)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_forward(q, k, v, bq, bk, causal=causal)
        runs.append((out, lse, *fa.flash_backward(q, k, v, out, lse, do, bq, bk, causal=causal)))
    label = label if causal else f"{label}, causal=False"
    torch.cuda.synchronize()
    differ = [name for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs) if not torch.equal(a, b)]
    print(f"kernel check flash {label} bf16, two launches on the same inputs: "
          + ("bit for bit: ok" if not differ else f"{differ} differ: FAIL"))
    if differ:
        raise SystemExit(f"flash kernels are not the same from run to run ({label}: {differ})")


def flash_counters(causal=True):
    from midgpt_tpu_torch.kernels import flash_attention as fa

    return dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), fa._COUNTERS[causal]))


def synthetic_stream(data_dir: Path, vocab: int, n_tokens: int = 2_000_000) -> None:
    """A seeded uniform uint16 token stream (no meta.pkl): train.bin, val.bin."""
    r = np.random.default_rng(0)
    stream = r.integers(0, vocab, n_tokens, dtype=np.uint16)
    stream[: n_tokens * 9 // 10].tofile(data_dir / "train.bin")
    stream[n_tokens * 9 // 10 :].tofile(data_dir / "val.bin")


def sets(d: dict):
    return [a for k, v in d.items() for a in ("--set", f"{k}={v}")]


def train_main_path(data_dir: Path, card: str, rundir: Path):
    """Phase 6: the launcher at local_text_124m's full width, cut only in
    steps, accumulation and eval, into `rundir` (kept: phase 19b holds its
    final state). Returns (launches by kernel, tokens/s, mfu, loss
    records)."""
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.config import load_config

    base = load_config("local_text_124m")
    mc = base.model_config
    print("reduced: " + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in TRAIN_CUTS.items())
          + f"; data: seeded synthetic uint16 stream (vocab {mc.vocab_size}) in a temporary directory")
    counters = flash_counters()
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
        return recs[2]

    # (a) divergence at step k, with the watchdog armed (60 s): rolled back to step 2 with the data window
    # skipped. The armed run that (d) held bit for bit to the straight run was cut (PERF.md, section 4):
    # (b)'s run is armed too and held so, and this run gives (b) its guarded syncs
    div_dir = root / "diverged"
    free_memory()
    before = torch.cuda.memory_allocated()
    n_events = len(recorded("train.step"))
    n_syncs = len(recorded("train.sync"))
    result = run("divergence", div_dir, fault_plan=f"nan_grad@{k}", watchdog_deadline_s=60)
    syncs = [dur for _, dur, _ in recorded("train.sync")[n_syncs:]]
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
    print(f"(a) armed watchdog (60 s): {len(syncs)} guarded syncs, the longest {max(syncs):.3f} s; step 2's tokens/s "
          f"{tok_s(div_dir):.1f} armed vs {tok_s(straight_dir):.1f} unarmed (phase 6b's straight run) on {card}")
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
          f"guarded sync of (a), at least 2 s) on {card}")
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
    # regenerates each stream (a departure only at a near-tie), so the f32
    # streams are held against unfaulted runs; the bf16 pool's fault runs
    # hold the same checks but not their streams (bf16 rounds the prefill's
    # products otherwise than the decode's), so they need no unfaulted run.
    want = {}
    for spec in ("off", "double"):
        want[spec] = counted(f"f32 {spec} unfaulted", params32, torch.float32, spec)[1]
    for (name, params, dtype), (spec, plan) in itertools.product(
            (("f32", params32, torch.float32), ("bf16", params16, torch.bfloat16)),
            (("off", "kill_mid_decode@3"), ("double", "kill_overlapped_round@3"), ("off", "poisoned_page@3"))):
        label = f"{name} {spec} {plan}"
        st, got, _ = counted(label, params, dtype, spec, plan)
        keep = [i for i in range(len(got)) if i not in st["poisoned_uids"]]
        print(f"{label}: preemptions {st['preemptions']}, decode_kills {st['decode_kills']}, overlap_kills "
              f"{st['overlap_kills']}, poisoned uids {st['poisoned_uids']}, paged launches {launches[label]}, "
              "every page back in the pool")
        if name == "f32":
            compare_streams(f"{label} vs unfaulted", [got[i] for i in keep], [want[spec][i] for i in keep], cfg,
                            params32)
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


def parity_run(data_dir: Path, n_layer, compute_dtype, steps, impl, moe=False):
    """Train steps of local_text_124m (n_layer layers, G=1, warmup 2) with
    one attention impl, with phase 16's routed MLP and aux term if `moe`;
    returns (losses, params before, params after)."""
    import dataclasses

    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.data.dataset import TokenDataset
    from midgpt_tpu_torch.training.train import init_state, make_train_step

    base = load_config("local_text_124m")
    cfg = base.replace(
        data_dir=str(data_dir), compute_dtype=compute_dtype, g_accum_iters=1, warmup_steps=2,
        spec_layers=0, moe_aux_coef=MOE_SETS["moe_aux_coef"] if moe else 0.0,
        model_config=dataclasses.replace(base.model_config, n_layer=n_layer, attn_impl=impl,
                                         **(MOE_MODEL if moe else {})),
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


# ---------------------------------------------------------------- phase 11: the six presets' slice


def launch_logged(argv):
    """`launch.main(argv)` with its standard output echoed; returns
    (train's result, the logged records that carry a step)."""
    from midgpt_tpu_torch import launch

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = launch.main(argv)
    finally:
        sys.stdout.write(buf.getvalue())
    records = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith('{"step"')]
    return result, records


def gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def preset_run(data_dir: Path, preset: str, cuts: dict, **over):
    """Phase 11's training runs: the launcher on `preset` with no run
    directory (nothing saved), `cuts` and `over` as --set overrides, flash
    counters zeroed just before and peak memory reset. Returns (result,
    losses by step, steady tokens/s, steady MFU, peak bytes, launches by
    kernel and variant); steps after the first are the steady ones (no
    save, and the step-0 eval is outside the timed intervals)."""
    counters = flash_counters()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    result, records = launch_logged([f"--config={preset}", "--rundir=", *sets(
        {"data_dir": data_dir, "log_interval": 1, **cuts, **over})])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: dict(c.by_variant) for n, c in counters.items()}
    steps = [r for r in records if "loss/optimized" in r]
    losses = [r["loss/optimized"] for r in steps]
    evals = [v for r in records for k, v in r.items() if k.startswith("loss/") and k != "loss/optimized"]
    if len(losses) != cuts["max_steps"] or not all(np.isfinite(losses + evals)):
        raise SystemExit(f"{preset} {over}: losses not all finite: {losses}, evals {evals}")
    steady = steps[1:]
    tok_s = float(np.mean([r["throughput/tokens_per_sec"] for r in steady]))
    mfu = float(np.mean([r["throughput/mfu"] for r in steady])) if "throughput/mfu" in steady[0] else None
    return result, losses, tok_s, mfu, peak, launches


def flash_launch_check(label, launches, n_layer, micro, evals, fwd_visits=1):
    """Flash launches of a training run: single-visit bodies only, the
    forward n_layer x (fwd_visits x microsteps + eval batches), each
    backward n_layer x microsteps."""
    totals = {n: sum(v.values()) for n, v in launches.items()}
    want = {"flash_fwd": n_layer * (fwd_visits * micro + evals), "flash_bwd_dq": n_layer * micro,
            "flash_bwd_dkv": n_layer * micro}
    if totals != want or any(set(v) != {"single"} for v in launches.values()):
        raise SystemExit(f"{label}: flash launches {launches}, want {want} on the single-visit bodies")


def wide_main_path(data_dir: Path, card: str):
    """Phase 11a: wide610m through the launcher at full width and depth.
    Returns (launches by kernel, tokens/s, mfu, peak bytes)."""
    from midgpt_tpu_torch.config import load_config

    base = load_config("wide610m")
    mc = base.model_config
    print("phase 11a reduced: " + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in WIDE_CUTS.items())
          + f"; g_accum_iters {base.g_accum_iters} (kept); no run directory (no checkpoint); data: seeded synthetic "
          f"uint16 stream (vocab {mc.vocab_size})")
    result, losses, tok_s, mfu, peak, launches = preset_run(data_dir, "wide610m", WIDE_CUTS)
    del result
    micro, evals = WIDE_CUTS["max_steps"] * base.g_accum_iters, 3 * WIDE_CUTS["eval_steps"]
    flash_launch_check("wide610m", launches, mc.n_layer, micro, evals)
    print(f"wide610m ({mc.n_layer} x {mc.n_embd}, {mc.n_head} heads of {mc.head_dim}, microbatch {base.batch_size}, "
          f"T {mc.block_size}): losses {[round(x, 4) for x in losses]}; steps 1-{WIDE_CUTS['max_steps'] - 1}: "
          f"{tok_s:.1f} tokens/s, MFU {'not known for this card' if mfu is None else f'{100 * mfu:.2f}%'}; "
          f"peak memory {gib(peak)} ({peak:,} bytes); flash launches {launches} ({mc.n_layer} layers x ({micro} "
          f"microsteps + {evals} eval batches)) on {card}")
    return launches, tok_s, mfu, peak


def update_rel_err(params, ref, p0) -> float:
    """||(params - p0) - (ref - p0)|| / ||ref - p0|| over all leaves."""
    num = sum(((params[k].float() - ref[k].float()).double() ** 2).sum() for k in ref).sqrt().item()
    den = sum(((ref[k].float() - p0[k].float()).double() ** 2).sum() for k in ref).sqrt().item()
    return num / den


def same_as_off(label, losses, params, ref_losses, ref_params, init_params):
    """A remat run against remat off: bit for bit, or (printed) within the
    train-step tolerances of PERF.md §2 — bf16 losses 1e-2 relative, the
    parameter update 1e-3 relative."""
    if losses == ref_losses and all(torch.equal(params[k], ref_params[k]) for k in ref_params):
        return "bit for bit"
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    max_p = max((params[k].float() - ref_params[k].float()).abs().max().item() for k in ref_params)
    upd = update_rel_err(params, ref_params, init_params())
    verdict = (f"not bit for bit: losses rel err {loss_err:.2e} (tol {PARITY_TOL['bf16_loss']:g}), update rel err "
               f"{upd:.2e} (tol {PARITY_TOL['f32_update']:g}), max |param diff| {max_p:.2e}")
    if loss_err > PARITY_TOL["bf16_loss"] or upd > PARITY_TOL["f32_update"]:
        raise SystemExit(f"{label} disagrees with remat off: {verdict}")
    return verdict


def remat_policies(data_dir: Path, card: str):
    """Phase 11b: the wide610m cut for 2 steps with remat off and under
    each policy. Returns {policy: (peak bytes, tokens/s, flash_fwd
    launches)}."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT

    base = load_config("wide610m")
    mc = base.model_config
    micro, evals = REMAT_CUTS["max_steps"] * base.g_accum_iters, 3 * REMAT_CUTS["eval_steps"]
    print("phase 11b reduced: " + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in REMAT_CUTS.items()))
    out, ref = {}, None
    for policy in REMAT_POLICIES:
        over = {"model_config.remat": policy is not None}
        if policy is not None:
            over["model_config.remat_policy"] = policy
        result, losses, tok_s, _, peak, launches = preset_run(data_dir, "wide610m", REMAT_CUTS, **over)
        params = {k: v.cpu() for k, v in result["params"].items()}
        del result
        label = "remat off" if policy is None else f"remat {policy}"
        recomputes = policy in ("none", "dots")
        flash_launch_check(f"wide610m {label}", launches, mc.n_layer, micro, evals, 2 if recomputes else 1)
        if ref is None:
            ref, verdict = (losses, params), "the reference"
        else:
            verdict = same_as_off(label, losses, params, *ref,
                                  lambda: {k: v.cpu() for k, v in GPT.init(mc, base.seed, device="cuda").items()})
        fwd = sum(launches["flash_fwd"].values())
        print(f"wide610m {label}: peak memory {gib(peak)} ({peak:,} bytes), step 1 {tok_s:.1f} tokens/s, flash_fwd "
              f"launches {fwd} ({mc.n_layer} x ({'2 x ' if recomputes else ''}{micro} microsteps + {evals} eval "
              f"batches)); losses {losses}: {verdict} on {card}")
        out[label] = (peak, tok_s, fwd)
        del params
    return out


def xl_remat_pair(data_dir: Path, card: str):
    """Phase 11c: openwebtext_xl at microbatch XL_BATCH, its own remat
    policy against remat off. Returns {label: (peak bytes, tokens/s,
    losses)}."""
    from midgpt_tpu_torch.config import load_config

    base = load_config("openwebtext_xl")
    mc = base.model_config
    print(f"phase 11c reduced: batch_size {base.batch_size} -> {XL_BATCH} (one microbatch that fits with remat off), "
          + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in REMAT_CUTS.items()))
    out, ref = {}, None
    for remat_on in (True, False):
        label = f"remat {mc.remat_policy}" if remat_on else "remat off"
        result, losses, tok_s, mfu, peak, _ = preset_run(
            data_dir, "openwebtext_xl", REMAT_CUTS, batch_size=XL_BATCH, **{"model_config.remat": remat_on})
        del result
        if ref is None:
            ref, verdict = losses, "the reference"
        elif losses == ref:
            verdict = "equal bit for bit"
        else:
            err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            verdict = f"rel err {err:.2e} (tol {PARITY_TOL['bf16_loss']:g})"
            if err > PARITY_TOL["bf16_loss"]:
                raise SystemExit(f"openwebtext_xl: remat off disagrees with remat on: {verdict}")
        print(f"openwebtext_xl ({mc.n_layer} x {mc.n_embd}) {label}, microbatch {XL_BATCH}: peak memory {gib(peak)} "
              f"({peak:,} bytes), step 1 {tok_s:.1f} tokens/s, MFU "
              f"{'not known for this card' if mfu is None else f'{100 * mfu:.2f}%'}; losses {losses}: {verdict} "
              f"on {card}")
        out[label] = (peak, tok_s, losses)
    return out


def llama_serving(card: str):
    """Phase 11d: llama7b_long served in bf16 through `sample.main
    --config`, its depth cut to LLAMA_LAYERS. Returns (paged launches,
    decode tokens/s)."""
    from midgpt_tpu_torch import config as config_mod
    from midgpt_tpu_torch import sample
    from midgpt_tpu_torch.kernels import attention_template as tpl

    load_config = config_mod.load_config

    def load_cut(name):
        c = load_config(name)
        if name != "llama7b_long":
            return c
        return dataclasses.replace(c, model_config=dataclasses.replace(c.model_config, n_layer=LLAMA_LAYERS))

    mc = load_cut("llama7b_long").model_config
    print(f"phase 11d reduced: llama7b_long n_layer {load_config('llama7b_long').model_config.n_layer} -> "
          f"{mc.n_layer} (full width)")
    prompt = np.random.default_rng(0).integers(0, mc.vocab_size, LLAMA_PROMPT)
    new_tokens, n_req = 32, 4
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    tpl.LAUNCHES.reset()
    tpl.MERGE_LAUNCHES.reset()
    config_mod.load_config = load_cut  # sample.main reads the preset through it
    try:
        out = sample.main(["--config=llama7b_long", "--engine=continuous", f"--start_ids={','.join(map(str, prompt))}",
                           "--temperature=0", f"--num_samples={n_req}", f"--max_new_tokens={new_tokens}"])
    finally:
        config_mod.load_config = load_config
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    st, streams = out["stats"], out["streams"]
    by_variant = dict(tpl.LAUNCHES.by_variant)
    launches = sum(by_variant.values())
    steps = device_steps(st)
    if any(len(t) != LLAMA_PROMPT + new_tokens or not ((0 <= t) & (t < mc.vocab_size)).all() for t in streams):
        raise SystemExit(f"llama7b_long: a request did not finish with its {new_tokens} tokens in the vocabulary")
    if not all(np.array_equal(t, streams[0]) for t in streams):
        raise SystemExit("llama7b_long: greedy streams of one prompt differ between slots")
    if {spec for spec, _ in by_variant} != {"decode"} or launches != mc.n_layer * steps:
        raise SystemExit(f"llama7b_long: paged launches {by_variant} != {mc.n_layer} x {steps} decode steps")
    if tpl.MERGE_LAUNCHES.count != launches:
        raise SystemExit("llama7b_long: merge launches != template launches")
    tok_s = st["decode_tokens"] / st["decode_seconds"]
    print(f"llama7b_long served in bf16 ({mc.n_layer} x {mc.n_embd}, {mc.n_head} heads of {mc.head_dim}): "
          f"{n_req} greedy requests of a {LLAMA_PROMPT}-token prompt, {new_tokens} new tokens each (streams "
          f"identical); weights {out['weight_bytes']:,} bytes, paged pool {st['cache_hbm_bytes']:,} bytes, made in "
          f"{out['init_s']:.2f} s; peak memory {gib(peak)} ({peak:,} bytes); decode {tok_s:.1f} tokens/s "
          f"({st['decode_tokens']} tokens in {st['decode_seconds']:.3f} s of decode rounds, {out['wall_s']:.3f} s "
          f"wall); paged launches {by_variant} = {mc.n_layer} x {steps} decode steps, merge "
          f"{tpl.MERGE_LAUNCHES.count} on {card}")
    return launches, tok_s


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


def flash_flops(B, H, T, C, causal=True):
    """{kernel: flops of its products} at one shape: T (T + 1) / 2 score
    pairs per head when causal, T^2 when not, 2 C flops per pair and
    product. The forward has 2 products (QK^T, PV), dQ 3 (QK^T, dO V^T,
    dS K), dK/dV 4 (QK^T, dO V^T, P^T dO, dS^T Q); the recomputations the
    kernels add are not counted."""
    pairs = T * (T + 1) // 2 if causal else T * T
    product = B * H * pairs * 2 * C
    return {"flash_fwd": 2 * product, "flash_bwd_dq": 3 * product, "flash_bwd_dkv": 4 * product}


def flash_bounds(B, H, T, C, dtype, causal=True):
    """{kernel: (least ms, what bounds it)} at one shape: each input read
    once and each output written once over 3.35 TB/s, against the products
    (flash_flops, causal or full) over the dense peak of the inputs'
    type."""
    item = torch.empty((), dtype=dtype).element_size()
    tensor, lse = B * H * T * C * item, B * H * T * 4
    moved = {
        "flash_fwd": 4 * tensor + lse,  # q k v in, out + lse out
        "flash_bwd_dq": 6 * tensor + lse,  # q k v o dO lse in, dq out
        "flash_bwd_dkv": 7 * tensor + lse,  # ... dk dv out
    }
    out = {}
    for name, flops in flash_flops(B, H, T, C, causal).items():
        t_b, t_o = moved[name] / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")
    return out


def time_flash(B, H, T, C, bq, bk, dtype=torch.bfloat16, causal=True, with_plain=True):
    """Phase 10 at one shape: device ms of each kernel (CUDA events over
    repeated launches), of the plain version (None without `with_plain`:
    its full-attention backward holds 4 f32 (B*H, T, T) tensors), and of
    SDPA's forward and backward (one call each, is_causal=causal)."""
    import torch.nn.functional as F

    from midgpt_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = flash_problem(B, H, T, C, dtype, seed=3)
    out, lse = fa.flash_forward(q, k, v, bq, bk, causal=causal)
    args = fa._check_backward(q, k, v, out, lse, do)
    _, v_dq, v_dkv = fa._variants(T, fa._block_sizes(T, bq, bk)[1])
    before = [c.count for c in flash_counters(causal).values()]
    iters = 20 if T <= 4096 else 5
    ms = {
        "flash_fwd": event_ms(lambda: fa.flash_forward(q, k, v, bq, bk, causal=causal), iters),
        "flash_bwd_dq": event_ms(lambda: fa._launch_bwd_dq(*args, v_dq, causal), max(iters // 2, 3)),
        "flash_bwd_dkv": event_ms(lambda: fa._launch_bwd_dkv(*args, v_dkv, causal), max(iters // 2, 3)),
    }
    if any(c.count == b for c, b in zip(flash_counters(causal).values(), before)):
        raise SystemExit("timing loop never launched the flash kernels")
    plain_fwd = plain_bwd = None
    if with_plain:
        plain_fwd = event_ms(lambda: fa.flash_forward_plain(q, k, v, bq, bk, causal=causal), 3, 1)
        plain_bwd = event_ms(lambda: fa.flash_backward_plain(q, k, v, out, lse, do, bq, bk, causal=causal), 3, 1)
    q4, k4, v4, do4 = (t.view(B, H, T, C) for t in (q, k, v, do))
    sdpa_fwd = event_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), iters)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    o4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    sdpa_bwd = event_ms(lambda: torch.autograd.grad(o4, (qg, kg, vg), do4, retain_graph=True), max(iters // 2, 3))
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}
    return ms, plain, library


FLASH_SOURCES = {  # the TPU body each kernel replaces on the main path (all: csrc header)
    "flash_fwd": "midgpt_tpu/kernels/flash_attention.py:126",
    "flash_bwd_dq": "midgpt_tpu/kernels/flash_attention.py:265",
    "flash_bwd_dkv": "midgpt_tpu/kernels/flash_attention.py:265",
}


# causal=False (ring attention's off-diagonal pairs): phase 3b at the main path's shape, a C 128 shape and a
# ragged T, bf16 and f32, then two launches bit for bit; phase 10 times them at FLASH_FULL_TIMED (the largest
# ring pair the plain version's full (B*H, T, T) f32 backward holds beside its inputs on the card) and, kernels
# and SDPA only, at phase 20b's pair (T 16,384 a rank)
FLASH_FULL_CHECKS = [
    *((*FLASH_MAIN, dt) for dt in (torch.bfloat16, torch.float32)),
    *(("C 128", 1, 32, 2048, 128, 512, 1024, dt) for dt in (torch.bfloat16, torch.float32)),
    *(("ragged T", 2, 12, 200, 64, 64, 64, dt) for dt in (torch.bfloat16, torch.float32)),
]
FLASH_FULL_TIMED = ("a ring pair at llama7b_32k's heads", 1, 32, 8192, 128, 512, 1024)
FLASH_FULL_PAIR = ("phase 20b's ring pair", 1, 32, 16384, 128, 512, 1024)
FLASH_FULL_SOURCES = {  # the TPU body each causal=False kernel stands for at the tiled timing shapes
    "flash_fwd": "midgpt_tpu/kernels/flash_attention.py:160",
    "flash_bwd_dq": "midgpt_tpu/kernels/flash_attention.py:329",
    "flash_bwd_dkv": "midgpt_tpu/kernels/flash_attention.py:376",
}


def check_full_flash():
    """Phase 3b, causal=False: every FLASH_FULL_CHECKS shape, then the
    main path's and the C 128 shape's bf16 launches twice, bit for bit.
    Returns {(label, dtype): max |err| by output}."""
    errs = {}
    for label, B, H, T, C, bq, bk, dt in FLASH_FULL_CHECKS:
        errs[(label, dt)] = check_flash(label, B, H, T, C, bq, bk, dt, causal=False)
        free_memory()
    for label, B, H, T, C, bq, bk, _ in FLASH_FULL_CHECKS[:4:2]:
        check_flash_repeat(label, B, H, T, C, bq, bk, causal=False)
    free_memory()
    return errs


def full_flash_entries(card: str, errs, launches) -> tp.List[dict]:
    """Phase 10, causal=False: the three kernels at FLASH_FULL_TIMED beside
    their plain versions, bounds and SDPA (is_causal=False), then at
    FLASH_FULL_PAIR (kernels and SDPA); the kernels line's entries at
    FLASH_FULL_TIMED, `launches` ({kernel: n}) phase 20's."""
    label, B, H, T, C, bq, bk = FLASH_FULL_TIMED
    ms, plain, lib = time_flash(B, H, T, C, bq, bk, causal=False)
    free_memory()
    bounds, flops = flash_bounds(B, H, T, C, torch.bfloat16, causal=False), flash_flops(B, H, T, C, causal=False)
    err = errs[("C 128", torch.bfloat16)]
    err_of = {"flash_fwd": err["out"], "flash_bwd_dq": err["dq"], "flash_bwd_dkv": max(err["dk"], err["dv"])}
    entries = []
    variants = fa_variants(T, bq, bk)
    for kname, variant in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), variants):
        b_ms, b_by = bounds[kname]
        lib_what = "sdpa forward" if kname == "flash_fwd" else "sdpa backward (dq, dk and dv in one call)"
        print(f"{kname} [{variant}, causal=False] {label} bf16 B={B} H={H} T={T} C={C} blocks=({bq},{bk}): "
              f"{ms[kname]:.4f} ms device ({flops[kname] / ms[kname] / 1e9:.1f} TFLOP/s), bound {b_ms:.4f} ms by {b_by} "
              f"({ms[kname] / b_ms:.1f}x), plain {plain[kname]:.3f} ms, {lib_what} (is_causal=False) "
              f"{lib[kname]:.4f} ms on {card}")
        entries.append({
            "name": f"{kname}[bf16,C={C},causal=False]",
            "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_FULL_SOURCES[kname],
            "launches": launches[kname],
            "max_abs_err": err_of[kname],
            "ms": ms[kname],
            "plain_ms": plain[kname],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib[kname],
        })
    label, B, H, T, C, bq, bk = FLASH_FULL_PAIR
    ms, _, lib = time_flash(B, H, T, C, bq, bk, causal=False, with_plain=False)
    free_memory()
    bounds = flash_bounds(B, H, T, C, torch.bfloat16, causal=False)
    print(f"flash causal=False at {label} bf16 B={B} H={H} T={T} C={C} blocks=({bq},{bk}): " + ", ".join(
        f"{k} {ms[k]:.4f} ms (bound {bounds[k][0]:.4f} ms by {bounds[k][1]})" for k in ms)
        + f"; sdpa forward {lib['flash_fwd']:.4f} ms, backward {lib['flash_bwd_dq']:.4f} ms (is_causal=False) on {card}")
    return entries


def fa_variants(T, bq, bk):
    from midgpt_tpu_torch.kernels import flash_attention as fa

    return fa._variants(T, fa._block_sizes(T, bq, bk)[1])


# ---------------------------------------------------------------- phase 12: the batch sampler

# the phase's prompt: text through data/local_text's HF BPE codec, and its 37 ids
BATCH_TEXT = ("Once upon a time, in a quiet village at the edge of a great forest, there lived an old clockmaker "
              "who repaired every clock in town and never")
BATCH_IDS = (35545, 13946, 279, 1023, 12, 302, 279, 24270, 338, 13650, 637, 561, 308, 5428, 391, 279, 31875, 14230,
             266, 12, 2833, 1679, 1774, 396, 3759, 12994, 27972, 22025, 301, 42183, 5062, 12994, 302, 367, 3132, 466,
             8901)
BATCH_ROWS, BATCH_NEW = (1, 8), 256  # 12a: local_text_124m
# An eager generate call's new tokens (12a-b, 16b): a decode step does the same work whatever the call's length
# (the cache is block_size long), so its greedy tokens are a longer call's first EAGER_NEW, and its tokens/s
# the same host-bound rate; 64 instead of 256 (or 128) took ~15 s off the script (PERF.md, section 4)
EAGER_NEW = 64
OVERFLOW_PROMPT, OVERFLOW_NEW = 1000, 40  # 12a: 24 tokens decoded in the cache, 15 by windowed forwards
WIDE_ROWS, WIDE_NEW = 8, 128  # 12b: wide610m
PARITY_ROWS, PARITY_NEW = 4, 64  # 12c: f32 parity, distinct 37-token prompts
# the flash forward at each of the batch path's prompt lengths: checked in phase 12c, the first five timed in
# phase 10 (alone on the card: phase 12 runs beside the training phases)
PREFILL_SHAPES = [("12a prefill", 1, 12, len(BATCH_IDS), 64), ("12a prefill", 8, 12, len(BATCH_IDS), 64),
                  ("12a overflow prefill", 1, 12, OVERFLOW_PROMPT, 64), ("12a overflow window", 1, 12, 1024, 64),
                  ("12b prefill", WIDE_ROWS, 16, len(BATCH_IDS), 128),
                  ("12c prefill", PARITY_ROWS, 12, len(BATCH_IDS), 64)]
EARLIER_SMOKE_S = 499.9  # this script's wall time before phase 12 was added (PERF.md, earlier slices)


def jax_chunks(T0: int, new: int, S: int, chunk: int = 64):
    """(chunk lengths, overflow tokens) of JAX's `generate` for a prompt of
    T0 tokens, `new` new tokens and a cache of S: its rule
    (midgpt_tpu/sampling/engine.py), restated here, as this script imports
    no JAX (tests/test_torch_generate.py holds the port to JAX's own loop)."""
    T_ctx, produced, out = min(T0, S), 1, []
    while produced < new and T_ctx + produced <= S:
        budget = min(chunk, new - produced, S - T_ctx - produced + 1)
        n = 1 << (budget.bit_length() - 1)
        out.append(n)
        produced += n
    return out, new - produced


def batch_prompt_args():
    """The phase's prompt as `sample.main` arguments: the text where
    `tokenizers` imports (the BPE codec then encodes it), else its ids."""
    try:
        import tokenizers  # noqa: F401
    except ImportError:
        print("phase 12: `tokenizers` is not importable here: the prompt goes in as --start_ids (its 37 BPE ids), "
              "and rows are printed as ids")
        return [f"--start_ids={','.join(map(str, BATCH_IDS))}"]
    print(f"phase 12: the prompt goes in as --start text through data/local_text's HF BPE codec: {BATCH_TEXT!r}")
    return [f"--start={BATCH_TEXT}"]


def batch_main(preset: str, rows: int, new: int, prompt_args, label: str):
    """`sample.main --config=<preset> --engine=batch --temperature=0`, its
    flash counters zeroed just before and read just after. Every row must
    hold the prompt and `new` tokens in the vocabulary, all rows the same
    tokens; the chunks JAX's rule; one capture and a replay per decoded
    step; and flash_fwd launches n_layer x (1 + overflow tokens), all
    single-visit, with no backward launch. Returns (sample.main's result,
    flash_fwd launches)."""
    from midgpt_tpu_torch import sample
    from midgpt_tpu_torch.config import load_config

    mc = load_config(preset).model_config
    for counter in flash_counters().values():
        counter.reset()
    printed = io.StringIO()
    with contextlib.chdir(ROOT), contextlib.redirect_stdout(printed):  # the preset's data_dir is the repo's
        out = sample.main([f"--config={preset}", "--engine=batch", "--temperature=0", f"--num_samples={rows}",
                           f"--max_new_tokens={new}", *prompt_args])
    torch.cuda.synchronize()
    launches = {name: dict(c.by_variant) for name, c in flash_counters().items()}
    text = printed.getvalue()
    summary = next(line for line in text.splitlines() if "(batch engine)" in line)
    streams = out["streams"]
    T0 = len(streams[0]) - new
    chunks, overflow = jax_chunks(T0, new, mc.block_size)
    print(f"{label}: {summary}")
    print(f"  row 0 as printed: {text[:160]!r}")
    bad = []
    if out["engine"] != "batch":
        bad.append(f"engine {out['engine']}")
    if any(len(t) != T0 + new or not ((0 <= t) & (t < mc.vocab_size)).all() for t in streams) or len(streams) != rows:
        bad.append("a row is not the prompt and its new tokens in the vocabulary")
    if not all(np.array_equal(t, streams[0]) for t in streams):
        bad.append("greedy rows of one prompt differ")
    if out["chunks"] != chunks or out["overflow_tokens"] != overflow:
        bad.append(f"chunks {out['chunks']} + {out['overflow_tokens']} overflow, JAX's rule {chunks} + {overflow}")
    if (out["captures"], out["replays"]) != (1 if chunks else 0, sum(chunks)):
        bad.append(f"captures {out['captures']}, replays {out['replays']}")
    want = {"single": mc.n_layer * (1 + overflow)}
    if launches["flash_fwd"] != want or out["flash_launches"] != want or any(
            launches[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")):
        bad.append(f"flash launches {launches}, want flash_fwd {want} (n_layer x (1 prefill + {overflow} windows))")
    print(f"  prefill {1e3 * out['prefill_s']:.2f} ms ({T0} tokens x {rows} rows); flash_fwd launches "
          f"{launches['flash_fwd']} = {mc.n_layer} x (1 + {overflow}); chunks {out['chunks']} (JAX's rule "
          f"{chunks}); graphs captured {out['captures']}, replays {out['replays']}; "
          f"{'ok' if not bad else 'FAIL: ' + '; '.join(bad)}")
    if bad:
        raise SystemExit(f"{label}: " + "; ".join(bad))
    return out, sum(launches["flash_fwd"].values())


def batch_decode_rates(label: str, mc, params, rows: int, new: int, want_streams):
    """Decode tokens/s of `generate` with the step replayed and eager (the
    same loop, its private hook), in turns (replayed, eager, replayed)
    after one capturing call (one eager call of EAGER_NEW tokens: a second
    took ~13 s of the script and added a repeat, not a check); every
    call's greedy tokens must equal `want_streams` (sample.main's on the
    same weights) bit for bit, the eager call's their first EAGER_NEW.
    Returns {mode: [tokens/s, ...]} with the capturing call's beside."""
    from midgpt_tpu_torch.sampling import engine
    from midgpt_tpu_torch.sampling.graphs import StepGraphs

    prompt = np.tile(np.asarray(BATCH_IDS, np.int64), (rows, 1))
    graphs = StepGraphs(torch.device("cuda"))
    rates = {"capturing": [], "replayed": [], "eager": []}
    for mode in ("capturing", "replayed", "eager", "replayed"):
        st = {}
        kw = {"_eager": True} if mode == "eager" else {"graphs": graphs}
        n = min(new, EAGER_NEW) if mode == "eager" else new
        got = engine.generate(mc, params, prompt, n, temperature=0.0, device="cuda", stats=st, **kw)
        if not np.array_equal(got.numpy(), np.stack(want_streams)[:, :prompt.shape[1] + n]):
            raise SystemExit(f"{label}: {mode} greedy tokens differ from sample.main's")
        rates[mode].append(rows * (n - 1) / st["decode_s"])
    if graphs.captures != 1:
        raise SystemExit(f"{label}: {graphs.captures} captures for one key")
    return rates


def profile_replayed_chunk(mc, params, rows: int, steps: int = 64):
    """torch.profiler over one replayed decode chunk of `steps` steps (the
    captured step, as `generate` replays it) after a prefill of the phase's
    prompt and one chunk outside the window. Returns (wall us, {kernel:
    device us})."""
    from torch.profiler import ProfilerActivity, profile

    from midgpt_tpu_torch.sampling import engine
    from midgpt_tpu_torch.sampling.graphs import StepGraphs

    dev = torch.device("cuda")
    prompt = torch.tensor(BATCH_IDS, device=dev).repeat(rows, 1)
    T, dtype, knobs = prompt.shape[1], engine.tokens_dtype(params), (0.0, None, None)
    graphs = StepGraphs(dev)
    cap = graphs.get("profile", lambda: engine._new_batch(mc, rows, dtype, dev),
                     lambda state, gen: engine._decode_step(mc, params, *knobs, state, gen), None)
    first, _ = engine._prefill_and_first(mc, params, prompt, *knobs, None, cache=cap.state.cache)
    cap.state.seq[:, :T] = prompt
    cap.state.seq[:, T] = first
    graphs.replay(cap, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graphs.replay(cap, steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, device_time_by_kernel(prof)


def decode_bound_ms(mc, params, rows: int):
    """(least ms of one decode step by bytes, weight bytes, cache bytes): the
    weights it reads (all leaves but the embedding, of which it reads `rows`
    rows) and the whole cache, 2 x n_layer x B x H_kv x S x C, which the
    step attends over under a mask, over 3.35 TB/s. Its operations (~2
    flops a weight a row) bound it far below that."""
    item = params["wte"].element_size()
    weights = sum(t.numel() * t.element_size() for name, t in params.items() if name != "wte")
    weights += rows * mc.n_embd * item
    cache = 2 * mc.n_layer * rows * mc.kv_heads * mc.block_size * mc.head_dim * item
    return (weights + cache) / HBM_BYTES_PER_S * 1e3, weights, cache


def batch_speed(card: str, label: str, preset: str, rows: int, new: int, want_streams):
    """Replayed against eager decode, the busy share of a replayed chunk and
    the step's byte bound, on `preset`'s bf16 weights from seed 0
    (sample.main's)."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT

    mc = load_config(preset).model_config
    params = GPT.init(mc, 0, device="cuda", dtype=torch.bfloat16)
    rates = batch_decode_rates(label, mc, params, rows, new, want_streams)
    b_ms, w_bytes, c_bytes = decode_bound_ms(mc, params, rows)
    print(f"{label} decode, bf16 B={rows}, {new} new tokens: replayed {[round(r, 1) for r in rates['replayed']]} "
          f"tokens/s, eager {[round(r, 1) for r in rates['eager']]} tokens/s (one call each, in turns, the eager one "
          f"of {min(new, EAGER_NEW)} new), capturing "
          f"call {rates['capturing'][0]:.1f}; replayed / eager {np.mean(rates['replayed']) / np.mean(rates['eager']):.2f}x; "
          f"replayed step {1e3 * rows / np.mean(rates['replayed']):.4f} ms vs bound {b_ms:.4f} ms by bytes "
          f"(weights {w_bytes:,} + cache {c_bytes:,} bytes over 3.35 TB/s) on {card}")
    busy = print_busy(f"{label} B={rows} replayed chunk (64 steps)", *profile_replayed_chunk(mc, params, rows), card,
                      top=4)
    del params
    free_memory()
    return rates, busy


def check_flash_forward(label, B, H, T, C, dtype):
    """Phase 12: the flash forward at one prompt length of the batch path,
    at the blocks the prefill gives it, vs the plain version (out: TOL,
    lse: 1e-5 abs+rel); returns max |err| of out."""
    from midgpt_tpu_torch.kernels import flash_attention as fa
    from midgpt_tpu_torch.ops.attention import flash_block_sizes

    bq, bk = flash_block_sizes(T, 1024)
    q, k, v, _ = flash_problem(B, H, T, C, dtype, seed=T)
    out, lse = fa.flash_forward(q, k, v, bq, bk)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_forward_plain(q, k, v, bq, bk)
    tol = TOL[dtype]
    err = (out.float() - want_out.float()).abs().max().item()
    ok = (bool(torch.isfinite(out).all()) and torch.allclose(out.float(), want_out.float(), atol=tol, rtol=tol)
          and torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))
    print(f"kernel check flash forward {label} B={B} H={H} T={T} C={C} blocks=({bq},{bk}) {str(dtype)[6:]}: "
          f"out {err:.3e} lse {(lse - want_lse).abs().max().item():.3e} (tol {tol:g}, 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash forward disagrees with its plain version ({label}, T {T}, {dtype})")
    return err


def time_flash_forward(B, H, T, C, dtype=torch.bfloat16):
    """(device ms, plain ms, SDPA forward ms, (bound ms, by)) of the forward
    at one prefill shape (CUDA events over repeated launches)."""
    import torch.nn.functional as F

    from midgpt_tpu_torch.kernels import flash_attention as fa
    from midgpt_tpu_torch.ops.attention import flash_block_sizes

    bq, bk = flash_block_sizes(T, 1024)
    q, k, v, _ = flash_problem(B, H, T, C, dtype, seed=3)
    ms = event_ms(lambda: fa.flash_forward(q, k, v, bq, bk), 50)
    plain = event_ms(lambda: fa.flash_forward_plain(q, k, v, bq, bk), 5, 1)
    q4, k4, v4 = (t.view(B, H, T, C) for t in (q, k, v))
    sdpa = event_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 50)
    return ms, plain, sdpa, flash_bounds(B, H, T, C, dtype)["flash_fwd"]


def batch_parity(card: str):
    """Phase 12c, f32 on local_text_124m's weights from seed 0: batch greedy
    streams of distinct prompts == the continuous engine's (phase 5's f32
    engine; a departure only at a near-tie), replayed == eager bit for bit."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.sampling import engine

    mc = load_config("local_text_124m").model_config
    params = GPT.init(mc, 0, device="cuda")
    prompts = np.random.default_rng(12).integers(0, 50257, (PARITY_ROWS, len(BATCH_IDS)))
    replayed = engine.generate(mc, params, prompts, PARITY_NEW, temperature=0.0, device="cuda")
    eager = engine.generate(mc, params, prompts, PARITY_NEW, temperature=0.0, device="cuda", _eager=True)
    if not torch.equal(replayed, eager):
        raise SystemExit("12c: f32 replayed greedy tokens differ from eager")
    print(f"12c f32 batch, {PARITY_ROWS} prompts of {len(BATCH_IDS)} tokens, {PARITY_NEW} new: replayed == eager, "
          "bit for bit")
    eng = new_engine(mc, params, torch.float32)
    uids = [eng.submit(p.astype(np.int32), PARITY_NEW) for p in prompts]
    done = eng.run()
    compare_streams("12c f32 batch (flash prefill, contiguous cache) vs continuous engine (paged)",
                    list(replayed.numpy()), [done[u].tokens for u in uids], mc, params)
    del params
    free_memory()


def batch_sampler(card: str):
    """Phase 12. Returns the flash_fwd launches of the batch path's
    sample.main runs at C 64 (12a) and C 128 (12b)."""
    t_phase = time.perf_counter()
    args = batch_prompt_args()
    # 12a. local_text_124m through sample.main, B 1 and 8, then a prompt that crosses the cache
    launches64, outs = 0, {}
    for rows in BATCH_ROWS:
        outs[rows], n = batch_main("local_text_124m", rows, BATCH_NEW, args, f"12a local_text_124m B={rows}")
        launches64 += n
        if args[0].startswith("--start=") and outs[rows]["streams"][0][: len(BATCH_IDS)].tolist() != list(BATCH_IDS):
            raise SystemExit("12a: the BPE codec did not encode the prompt to its recorded ids")
    long_ids = np.random.default_rng(0).integers(0, 50257, OVERFLOW_PROMPT)
    _, n = batch_main("local_text_124m", 1, OVERFLOW_NEW, [f"--start_ids={','.join(map(str, long_ids))}"],
                      f"12a overflow: {OVERFLOW_PROMPT}-token prompt + {OVERFLOW_NEW} new")
    launches64 += n
    free_memory()
    print(f"12a sample.main runs took {time.perf_counter() - t_phase:.1f} s")
    speed = {}
    for rows in BATCH_ROWS:
        speed[("12a", rows)] = batch_speed(card, "12a local_text_124m", "local_text_124m", rows, BATCH_NEW,
                                           outs[rows]["streams"])
    print(f"12a took {time.perf_counter() - t_phase:.1f} s")
    # 12b. wide610m (C 128): the C 128 single-visit body on the prefill
    wide, launches128 = batch_main("wide610m", WIDE_ROWS, WIDE_NEW, args, f"12b wide610m B={WIDE_ROWS}")
    free_memory()
    speed[("12b", WIDE_ROWS)] = batch_speed(card, "12b wide610m", "wide610m", WIDE_ROWS, WIDE_NEW, wide["streams"])
    print(f"12a-b took {time.perf_counter() - t_phase:.1f} s")
    # 12c. parity: f32 batch vs continuous, replayed vs eager; the flash forward at each prompt length
    batch_parity(card)
    for label, B, H, T, C in PREFILL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            check_flash_forward(label, B, H, T, C, dtype)
    free_memory()
    took = time.perf_counter() - t_phase
    print(f"phase 12 took {took:.1f} s on {card}")
    return launches64, launches128, speed


# ---------------------------------------------------------------- phase 13: the serving front door

# 13b: the loadgen cell (GPT-2 small's full width, bf16 pool, random weights
# from seed 0). The two offered loads are ~25% and ~90% of the request rate a
# saturating warm pass sustained (PERF.md, phase 13's cell).
FRONT_DOOR_RATES = (7.0, 26.0)
FRONT_DOOR_ARGS = ["--process=poisson", "--n-requests=24", "--template-frac=0.5", "--overlap=group:4",
                   "--max-slots=4", "--num-pages=513", "--page-size=8", "--prefill-chunk=256", "--decode-chunk=4",
                   "--block-size=1024", "--vocab-size=50304", "--n-layer=12", "--n-head=12", "--n-embd=768",
                   "--seed=0"]
RESIZE_PLAN = (384, 200)  # 13d: grow at round 3, shrink at round 6 (the pool_resize fault)
BUDGET_BYTES = 2**30  # 13e
EARLIER_SMOKE_PHASE13_S = 507.5  # this script's wall time before phase 13 was added (PERF.md, PR 12)


def check_aliased_kernel(dtype, split_k):
    """13a: the phase-3a problem with page tables as prefix-cache hits make
    them: slots 0-2 map the same first 16 physical pages (a 128-token
    template), slots 0-1 a 17th too, then their own. Kernel vs plain;
    returns max |err|."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    q, k, v, table, counts = decode_problem(dtype)
    own = table[2, 16].clone()
    table[1:3, :17] = table[0, :17]
    table[2, 16] = own  # slot 2 shares 16 pages only
    assert len({tuple(r[:16].tolist()) for r in table[:3]}) == 1
    got = tpl.paged_attention_template(q[:, :, None], k, v, table, counts[:, None], split_k=split_k)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q[:, :, None], k, v, table, counts[:, None], split_k=split_k)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) and bool(torch.isfinite(got).all())
    print(f"13a paged decode on aliased page tables {str(dtype)[6:]} split_k={split_k}: max_abs_err={err:.3e} "
          f"(tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"13a: the paged kernel disagrees with its plain version on shared pages ({dtype}, {split_k})")
    return err


def run_loadgen(label: str, extra, card: str, n_layer: int, args=FRONT_DOOR_ARGS, rates=FRONT_DOOR_RATES):
    """One in-process loadgen run; counters zeroed just before, read just
    after. Checks: the serve_slo line parses, every point captured nothing,
    the decode-spec launches == n_layer x the device's decode steps.
    Returns (the line, launches by (spec, split))."""
    from midgpt_tpu_torch import loadgen

    argv = list(args) + [f"--rates={','.join(f'{r:g}' for r in rates)}"] + list(extra)
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        loadgen.main(argv)
    took = time.perf_counter() - t0
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    steps = rec["decode_steps"] + rec["capture_warmup_steps"]
    by_variant = check_launches(label, n_layer, steps)
    print(f"{label} loadgen {' '.join(extra)} ({took:.1f} s): {json.dumps(rec)}")
    print(f"{label} device: {rec['device']}; {rec['warm_captures']} graphs captured by the warm-up; paged launches "
          f"{dict(by_variant)} == {n_layer} layers x {steps} decode steps ({rec['decode_steps']} dispatched, "
          f"{rec['capture_warmup_steps']} capture warm-ups) on {card}")
    if {spec for spec, _ in by_variant} - {"decode", "merge"}:
        raise SystemExit(f"{label}: the bf16 pool must launch the decode spec only, got {dict(by_variant)}")
    for p in rec["points"]:
        hit = (f", prefix_hit_rate {p['prefix_hit_rate']}, prefill tokens the trie saved "
               f"{p['prefill_tokens_saved']}" if "prefix_hit_rate" in p else "")
        swap = (f", weights_version {p['weights_version']} (flip round {p['swap_flip_round']})"
                if "weights_version" in p else "")
        print(f"{label} {p['offered_rps']:g} req/s offered: TTFT p50 {p['ttft_p50_ms']} / p95 {p['ttft_p95_ms']} ms, "
              f"TPOT p50 {p['tpot_p50_ms']} / p95 {p['tpot_p95_ms']} ms, {p['completed']}/{p['n_offered']} completed "
              f"in {p['wall_s']} s ({p['completed'] / p['wall_s']:.2f} req/s), shed {p['shed_frac']}, timeout "
              f"{p['timeout_frac']}, round host p50 {p['round_host_ms']['p50']} ms, device p50 "
              f"{p['round_device_ms']['p50']} ms{hit}{swap}; captures inside the point {p['captures']} on {card}")
        if p["captures"] != 0:
            raise SystemExit(f"{label}: a graph was captured inside a timed point")
        if p["completed"] != p["n_offered"]:
            raise SystemExit(f"{label}: {p['n_offered'] - p['completed']} requests did not complete")
    return rec, by_variant


def template_trace(vocab: int, n: int = 8, head: int = 256, seed: int = 13):
    """Template traffic at full width: two 256-token heads, short tails."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, head).astype(np.int32) for _ in range(2)]
    return [(np.concatenate([heads[i % 2], rng.integers(0, vocab, int(rng.integers(3, 20))).astype(np.int32)]),
             int(rng.integers(16, 48))) for i in range(n)]


def serve_waves(eng, reqs, watch=None, submit=None):
    """Half the requests, two rounds, the rest (so the trie has content to
    match), then to the end; `watch(eng)` after every step. `eng` is an
    engine or a FleetRouter, and `submit(prompt, max_new_tokens)` its own
    submit unless given. Returns the streams; every request must finish
    with its budget."""
    submit = submit or eng.submit
    half = len(reqs) // 2
    uids = [submit(p, m) for p, m in reqs[:half]]
    for i in range(10**6):
        if i == 2:
            uids += [submit(p, m) for p, m in reqs[half:]]
        elif eng.idle:
            break
        eng.step()
        if watch is not None:
            watch(eng)
    torch.cuda.synchronize()
    return finished_streams(eng, reqs, uids)


def finished_streams(owner, reqs, uids):
    """The streams of `uids` (an engine's or a router's, in `reqs`' order);
    each must have ended "ok" with its whole budget."""
    streams = []
    for (p, m), u in zip(reqs, uids):
        fr = owner.finished[u]
        if fr.status != "ok" or len(fr.tokens) != len(p) + m:
            raise SystemExit(f"request {u} ended {fr.status} with {len(fr.tokens) - len(p)}/{m} tokens")
        streams.append(fr.tokens)
    return streams


def captures_of(eng) -> int:
    graphs = eng.stats()["decode_graphs"]
    return 0 if graphs is None else sum(graphs["captures_per_key"])


def reset_launches() -> None:
    from midgpt_tpu_torch.kernels import attention_template as tpl

    tpl.LAUNCHES.reset()
    tpl.MERGE_LAUNCHES.reset()


# The kernels line's paged entries are bf16 queries over bf16 pools at the
# timed shapes. Phases 13 and 14 count their runs' launches by pool (the
# keys below, and "tiny" for chaos_serve's 2-layer model) and the line
# takes the "bf16" ones; the rest are printed beside it.
POOL_OF = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8 pool, f32 queries"}


def check_launches(label: str, n_layer: int, steps: int) -> collections.Counter:
    """The paged launches by (spec, split) since `reset_launches`, and the
    merge kernel's under ("merge", None): n_layer x `steps` each (no decode
    step bypassed either kernel)."""
    from midgpt_tpu_torch.kernels import attention_template as tpl

    n = collections.Counter(tpl.LAUNCHES.by_variant)
    merges = tpl.MERGE_LAUNCHES.count
    if sum(n.values()) != n_layer * steps or merges != n_layer * steps:
        raise SystemExit(f"{label}: paged launches {dict(n)}, merge launches {merges} != {n_layer} layers x "
                         f"{steps} decode steps")
    n[("merge", None)] = merges
    return n


def front_door(card: str):
    """Phase 13. Returns the paged-kernel launches of its serving runs
    (counters zeroed just before each, read just after) by pool (POOL_OF)
    and (spec, split), and the aliased-table kernel errors."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT, PagedKVCache
    from midgpt_tpu_torch.robustness import faults
    from midgpt_tpu_torch.sampling.ops import assert_conserved
    from midgpt_tpu_torch.sampling.serve import ServeEngine
    from midgpt_tpu_torch.utils.precision import cast_floating

    t_phase = time.perf_counter()
    launches = collections.defaultdict(collections.Counter)
    # 13a. the kernel on shared pages
    alias_errs = {(dt, s): check_aliased_kernel(dt, s) for dt in (torch.bfloat16, torch.float32) for s in (1, 2)}
    cfg = load_config("openwebtext").model_config
    L = cfg.n_layer
    # 13b. loadgen, prefix cache off (13c's run, with the cache on, is the other side)
    off, n = run_loadgen("13b off", [], card, L)
    launches["bf16"] += n
    free_memory()
    # The cache is page-table indirection only: f32 streams equal with it on
    # and off, bf16 ones equal or part at a near-tie (the tail's prefill
    # chunks start at a page boundary instead of 0).
    params32 = GPT.init(cfg, 0, device="cuda")
    params16 = cast_floating(params32, torch.bfloat16)
    reqs = template_trace(cfg.vocab_size)
    for dt, params in ((torch.float32, params32), (torch.bfloat16, params16)):
        reset_launches()
        got, steps = {}, 0
        for prefix in (False, True):
            eng = new_engine(cfg, params, dt, overlap="group", round_group=4, prefix_cache=prefix)
            got[prefix] = serve_waves(eng, reqs)
            steps += device_steps(eng.stats())
            if prefix:
                assert_conserved(eng, "13b streams")
                ps = eng.prefix_stats()
                print(f"13b {str(dt)[6:]} template trace ({len(reqs)} requests, two 256-token heads), cache on: hit "
                      f"rate {ps['hit_rate']:.3f}, prefill tokens {ps['prefilled_tokens']} ({ps['matched_tokens']} "
                      f"matched), trie pages {ps['trie_pages']}")
        launches[POOL_OF[dt]] += check_launches(f"13b {dt}", L, steps)
        compare_streams(f"13b {str(dt)[6:]} group:4 cache on vs off", got[True], got[False],
                        *((cfg, params32) if dt == torch.bfloat16 else ()))
        free_memory()
    # 13c. hot swap under load
    rec, n = run_loadgen("13c", ["--prefix-cache", "--hot-swap"], card, L)
    launches["bf16"] += n
    print("13b-c TTFT p95 ms by offered load, cache off (13b) vs on (13c, one hot swap inside each point): " + "; ".join(
        f"{a['offered_rps']:g} req/s {a['ttft_p95_ms']} vs {b['ttft_p95_ms']} (TPOT p95 {a['tpot_p95_ms']} vs "
        f"{b['tpot_p95_ms']})" for a, b in zip(off["points"], rec["points"])) + f" on {card}")
    if not all(p["prefix_hit_rate"] > 0 for p in rec["points"]):
        raise SystemExit("13c: template traffic never hit the prefix cache")
    versions = [p["weights_version"] for p in rec["points"]]
    print(f"13c weights_version inline -> {versions} (flip rounds {[p['swap_flip_round'] for p in rec['points']]}); "
          f"captures inside each point, the flip included: {[p['captures'] for p in rec['points']]} on {card}")
    if rec["hot_swaps"] != len(rec["points"]) or len(set(versions)) != 1 or versions[0] == "inline":
        raise SystemExit(f"13c: every point must flip once to the checkpoint's weights, got {versions}")
    # f32: two requests admitted after a flip equal a fresh engine's on the
    # new weights, bit for bit; the keys they reach were captured on the old
    # weights first, so the flip adds no capture
    new32 = GPT.init(cfg, 101, device="cuda")
    after = template_trace(cfg.vocab_size, n=2, seed=17)
    long_req = template_trace(cfg.vocab_size, n=1, seed=19)[0][0], 200

    def serve_all(e, batch):
        uids = [e.submit(p, m) for p, m in batch]
        e.run()
        return [e.finished[u].tokens for u in uids]

    reset_launches()
    eng = new_engine(cfg, {k: v.clone() for k, v in params32.items()}, torch.float32, overlap="group", round_group=4)
    serve_all(eng, after)
    u0 = eng.submit(*long_req)
    for _ in range(3):
        eng.step()
    if eng.hot_swap(new32, version="new")["flipped"]:
        raise SystemExit("13c: the swap flipped with a live slot")
    uids = [eng.submit(p, m) for p, m in after]
    at_flip = None
    while not eng.idle:
        eng.step()
        if at_flip is None and eng.weights_version == "new":
            at_flip = captures_of(eng)
    captures = captures_of(eng)
    fresh = new_engine(cfg, new32, torch.float32, overlap="group", round_group=4)
    want = serve_all(fresh, after)
    launches["f32"] += check_launches("13c f32", L, device_steps(eng.stats()) + device_steps(fresh.stats()))
    flip = eng.swap_history[-1]
    print(f"13c f32 swap staged at round {flip['staged_round']} with uid {u0} in flight, flipped at round "
          f"{flip['flip_round']} ({flip['swap_latency_s'] * 1e3:.1f} ms later); graphs captured at the flip "
          f"{at_flip}, at the end {captures} on {card}")
    if at_flip != captures:
        raise SystemExit("13c: a graph was captured after the flip")
    compare_streams("13c f32 requests admitted after the flip vs a fresh engine on the new weights",
                    [eng.finished[u].tokens for u in uids], want)
    del eng, fresh, new32
    free_memory()
    # 13d. resize mid-trace: grow at round 3, shrink at round 6 (the
    # pool_resize fault), phase 4's trace under group:1 (14 rounds) in f32
    # and on an int8 pool
    for dt in (torch.float32, torch.int8):
        mem, runs, resized = {}, {}, None

        for plan in ((), RESIZE_PLAN):

            def watch(e):
                assert_conserved(e, f"round {e.rounds}")
                if e.rounds in (2, 6):
                    torch.cuda.synchronize()
                    mem[(plan, e.rounds)] = torch.cuda.memory_allocated()

            reset_launches()
            eng = new_engine(cfg, params32, dt, overlap="group", round_group=1)
            eng.resize_plan = list(plan)
            faults.clear()
            for r in (3, 6)[: len(plan)]:
                faults.activate("pool_resize", step=r)
            try:
                runs[plan], _ = serve_trace(eng, watch)
            finally:
                faults.clear()
            launches[POOL_OF[dt]] += check_launches(f"13d {dt}", L, device_steps(eng.stats()))
            if plan:
                resized = (eng.resize_history, eng.cache.nbytes, eng.stats()["dropped_graphs"])
            del eng
            free_memory()
        hist, new_bytes, dropped = resized
        mib = {k: v / 2**20 for k, v in mem.items()}
        print(f"13d {str(dt)[6:]} pool: " + "; ".join(
            f"{h['from_pages']} -> {h['to_pages']} pages at round {h['round']}: {h['pages_migrated']} migrated in "
            f"{h['migrate_s'] * 1e3:.2f} ms" for h in hist) + f"; {dropped} captures dropped and recaptured; "
            f"conservation held at every round; device memory after round 2 / round 6: {mib[(RESIZE_PLAN, 2)]:.1f} "
            f"/ {mib[(RESIZE_PLAN, 6)]:.1f} MiB resized, {mib[((), 2)]:.1f} / {mib[((), 6)]:.1f} MiB not (new pool "
            f"{new_bytes / 2**20:.1f} MiB) on {card}")
        # after the shrink the engine holds less than one new pool more than
        # before the grow: the old pools and their captures are gone
        if len(hist) != 2 or mem[(RESIZE_PLAN, 6)] - mem[(RESIZE_PLAN, 2)] >= new_bytes:
            raise SystemExit("13d: the resizes did not both land, or the old pools or their captures stayed")
        compare_streams(f"13d {str(dt)[6:]} pool, grow then shrink vs no resize", runs[RESIZE_PLAN], runs[()])
    del params32, params16
    free_memory()
    # 13e. the byte budget: JAX's num_pages = max(2, budget // page bytes)
    for label, dt, mc in (("bf16", torch.bfloat16, cfg), ("int8", torch.int8, cfg),
                          ("gqa bf16", torch.bfloat16, dataclasses.replace(cfg, n_kv_heads=3))):
        eng = ServeEngine(mc, {}, pool_hbm_bytes=BUDGET_BYTES, cache_dtype=dt, device="cuda")
        item = torch.empty((), dtype=dt).element_size()
        page = 2 * mc.n_layer * mc.kv_heads * mc.head_dim * PAGE * item
        want = max(2, BUDGET_BYTES // page)
        print(f"13e pool_hbm_bytes 1 GiB, {label}: {eng.allocator.num_pages} pages (JAX's formula {want}; "
              f"{page} bytes a page), {eng.allocator.num_pages * PAGE} tokens a GiB, cache_hbm_bytes "
              f"{eng.cache_hbm_bytes()} on {card}")
        if eng.allocator.num_pages != want or PagedKVCache.page_bytes(mc, PAGE, dt) != page:
            raise SystemExit(f"13e: {label} pool has {eng.allocator.num_pages} pages, JAX's formula gives {want}")
        del eng
        free_memory()
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, alias_errs


# ---------------------------------------------------------------- phase 14: serving chaos, the fleet, disagg

# 14b: the engine_crash round (one arrival per router round: streams are in
# flight on the busiest replica by then)
CRASH_ROUND = 4
# 14a-c: phase 13's template trace at the seed whose two heads hash to different replicas
FLEET_TRACE_SEED = 14
SPILL_COST_PAGES = 32  # 14b: pages per spill / re-adoption timing pass
# 14c: (dtype, the decode role's overlap, round_group) of each disagg pair
DISAGG_RUNS = ((torch.bfloat16, "group", 4), (torch.bfloat16, "off", 1), (torch.float32, "off", 1),
               (torch.float32, "group", 4))
# 14d: every in-process plan of JAX's tests/test_chaos_serve.py, as
# `chaos_serve --fault` arguments and --n-requests
CHAOS_PLANS = [(["kill_mid_decode@6"], 5), (["kill_overlapped_round@6"], 5), (["poisoned_page@3"], 5),
               (["slow_client@1"], 5), (["submit_storm@2"], 5), (["evict_shared_prefix@7"], 6),
               (["hot_swap_mid_decode@5"], 5), (["pool_resize@4", "pool_resize@8"], 5), (["engine_crash@6"], 5),
               (["handoff_stall"], 5), (["spill_corrupt"], 5)]
# 14e: loadgen --fleet 2 at GPT-2 small's full width, bf16 pools, group:4,
# template-headed mixture. FLEET_SATURATED_RPS is what a saturating pass
# (every request at t=0) sustained, completed / wall (PERF.md, phase 14's
# cell); the point is offered at half of it.
FLEET_ARGS = ["--process=poisson", "--n-requests=16", "--template-frac=0.5", "--overlap=group:4", "--max-slots=4",
              "--num-pages=513", "--page-size=8", "--prefill-chunk=256", "--decode-chunk=4", "--block-size=1024",
              "--vocab-size=50304", "--n-layer=12", "--n-head=12", "--n-embd=768", "--seed=0", "--fleet=2"]
FLEET_SATURATED_RPS = 29.6
FLEET_RATE = FLEET_SATURATED_RPS / 2
EARLIER_SMOKE_PHASE14_S = 616.8  # this script's wall time before phase 14 was added (PERF.md, the front door)


def fleet_drive(router, reqs, **kw):
    """chaos_serve.drive_fleet over `reqs` (one arrival a router round; kw:
    stage_spill, watch). Returns the streams in `reqs`' order."""
    from midgpt_tpu_torch.robustness.chaos_serve import drive_fleet

    uids = list(drive_fleet(router, reqs, **kw))
    torch.cuda.synchronize()
    return finished_streams(router, reqs, uids)


def fleet_health(label, router, card, crashes=0):
    """Print the router's failovers, crash log and the replica steps that
    raised. The router's health check turns a replica's exception into a
    failover and a survivor replays its streams, which would hide a failure
    on the card behind equal streams: fail unless no step raised and
    exactly `crashes` replicas died, each by the planned engine_crash."""
    print(f"{label}: failovers {router.failovers}, crash log {router.crash_log}, step errors "
          f"{router.step_errors} on {card}")
    if (router.step_errors or router.failovers != crashes or len(router.crash_log) != crashes
            or any(c["reason"] != "fault" for c in router.crash_log)):
        raise SystemExit(f"{label}: a replica failed outside the fault plan")


def fleet_steps(engines) -> int:
    return sum(device_steps(e.stats()) for e in engines)


def spill_cost(cfg, dt, n=SPILL_COST_PAGES):
    """ms per page of a spill (the page's blocks to the host plus their
    crc32) and of a re-adoption (crc check, stack, copy back in place,
    synchronized), and host bytes a page, at full width: the second of two
    passes over `n` pages; the re-adopted pages must come back byte for
    byte."""
    from midgpt_tpu_torch.models.gpt import PagedKVCache
    from midgpt_tpu_torch.sampling.disagg import adopt_pages, gather_pages
    from midgpt_tpu_torch.sampling.fleet import SpillTier

    cache = PagedKVCache.init(cfg, num_pages=n + 1, page_size=PAGE, dtype=dt, device="cuda")
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, device="cuda").mul(30).to(dt))
    if cache.quantized:
        cache.k_scale.uniform_()
        cache.v_scale.uniform_()
    before = gather_pages(cache, range(1, n + 1))
    prompt = list(range(n * PAGE + 1))
    for _ in range(2):
        tier = SpillTier()
        tier.set_page_size(PAGE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in range(n):
            tier.spill(cache, tuple(prompt[: (d + 1) * PAGE]), d + 1, "v")
        t1 = time.perf_counter()
        run = tier.take_run(prompt, 0, n, "v")
        blocks = {k: np.stack([b[k] for b in run], axis=1 if k.endswith("scale") else 2) for k in run[0]}
        adopt_pages(cache, list(range(1, n + 1)), blocks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    after = gather_pages(cache, range(1, n + 1))
    if any(before[k].tobytes() != after[k].tobytes() for k in before) or tier.readopted != n:
        raise SystemExit(f"14b {dt}: pages did not survive spill and re-adoption byte for byte")
    return (t1 - t0) * 1e3 / n, (t2 - t1) * 1e3 / n, tier.spilled_bytes // n


def handoff_ms(obs, since: int):
    """Summed ms of the handoff.gather and handoff.adopt spans recorded
    after the tracer's first `since` events."""
    tot = collections.Counter()
    for kind, name, _cat, _tid, _t, dur, _ident, _args in obs.tracer.events()[since:]:
        if name in ("handoff.gather", "handoff.adopt"):
            tot[name] += dur * 1e3
    return tot


def check_tiny_kernel(kv_dtype):
    """14d's scenarios run chaos_serve's tiny model (2 heads of 16) in f32:
    the kernel at that head width, f32 and int8 pools, against its plain
    version. Returns max |err|."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.ops.quant import quantize_q8

    g = torch.Generator().manual_seed(5)
    B, H, C, counts = 3, 2, 16, [0, 9, 37]
    table = torch.tensor([[0] * 8, [1, 2] + [0] * 6, [3, 4, 5, 6, 7] + [0] * 3], dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, 1, C, generator=g).cuda()
    k, v = (torch.randn(H, 8, PAGE, C, generator=g).cuda() for _ in range(2))
    cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")[:, None]
    kw = {}
    if kv_dtype == torch.int8:
        (k, ks), (v, vs) = (quantize_q8(x.transpose(0, 1)) for x in (k, v))  # per (page, head, position)
        k, v = k.transpose(0, 1).contiguous(), v.transpose(0, 1).contiguous()
        kw = dict(k_scale=ks, v_scale=vs)
    got = tpl.paged_attention_template(q, k, v, table, cnt, **kw)
    torch.cuda.synchronize()
    want = tpl.paged_attention_template_plain(q, k, v, table, cnt, **kw)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=1e-5, rtol=1e-5) or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"14d: the paged kernel at head_dim {C} ({kv_dtype}) disagrees with its plain version: {err}")
    return err


def fleet_chaos(card: str):
    """Phase 14. Returns the paged-kernel launches of its fleet, disagg,
    chaos and loadgen runs (counters zeroed just before each, read just
    after) by pool (POOL_OF, and "tiny" for the chaos scenarios) and
    (spec, split)."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.obs import Observability
    from midgpt_tpu_torch.robustness import chaos_serve, faults
    from midgpt_tpu_torch.sampling.disagg import DisaggServe
    from midgpt_tpu_torch.sampling.fleet import FleetRouter, assert_fleet_conserved
    from midgpt_tpu_torch.sampling.ops import ModelOps, assert_conserved
    from midgpt_tpu_torch.utils.precision import cast_floating

    t_phase = time.perf_counter()
    launches = collections.defaultdict(collections.Counter)
    cfg = load_config("openwebtext").model_config
    L = cfg.n_layer
    params32 = GPT.init(cfg, 0, device="cuda")
    params16 = cast_floating(params32, torch.bfloat16)
    reqs = template_trace(cfg.vocab_size, seed=FLEET_TRACE_SEED)
    grouped = dict(overlap="group", round_group=4, prefix_cache=True)

    def counted(label, dt, steps, what):
        """check_launches, printed: no decode step of `what` bypassed the kernel."""
        n = check_launches(label, L, steps)
        print(f"{label} paged launches {dict(n)} == {L} layers x {steps} decode steps ({what}) on {card}")
        launches[POOL_OF[dt]] += n

    # 14a. two replicas behind the router vs one engine, f32 and bf16
    want = {}
    for dt, params in ((torch.float32, params32), (torch.bfloat16, params16)):
        label = str(dt)[6:]
        reset_launches()
        single = new_engine(cfg, params, dt, **grouped)
        want[dt] = serve_waves(single, reqs)
        router = FleetRouter([new_engine(cfg, params, dt, obs_tid=f"replica{i}", **grouped) for i in range(2)])
        placed = {}

        def submit(p, m):
            u = router.submit(p, m)
            placed[u] = router._pending[u].replica
            return u

        got = serve_waves(router, reqs, submit=submit)
        fleet_health(f"14a {label}", router, card)
        assert_fleet_conserved(router, f"14a {label}")
        counted(f"14a {label}", dt, device_steps(single.stats()) + fleet_steps(router.engines),
                "one engine and the two replicas, capture warm-ups included")
        placed = list(placed.values())  # submission order is `reqs`' order
        heads = {h: sorted({placed[i] for i in range(len(reqs)) if i % 2 == h}) for h in (0, 1)}
        print(f"14a {label} placement by head: {heads}; fleet prefix_hit_rate {router.prefix_hit_rate():.3f} vs one "
              f"engine's {single.prefix_stats()['hit_rate']:.3f}; per replica "
              f"{[round(e.prefix_stats()['hit_rate'], 3) for e in router.engines]} on {card}")
        if any(len(r) != 1 for r in heads.values()):
            raise SystemExit(f"14a {label}: requests sharing a head landed on more than one replica: {heads}")
        compare_streams(f"14a {label} fleet of 2 vs one engine", got, want[dt],
                        *((cfg, params32) if dt == torch.bfloat16 else ()))
        del single, router, submit
        free_memory()

    # 14b. faults on the fleet, f32 (eager rounds: no captures to wait for)
    reset_launches()
    faults.clear()
    faults.activate("engine_crash", step=CRASH_ROUND)
    router = FleetRouter([new_engine(cfg, params32, torch.float32, prefix_cache=True) for _ in range(2)])
    mem = {}

    def watch(r):
        if r.rounds in (CRASH_ROUND - 1, CRASH_ROUND):
            torch.cuda.synchronize()
            mem[r.rounds] = torch.cuda.memory_allocated()

    try:
        got = fleet_drive(router, reqs, watch=watch)
    finally:
        faults.clear()
    torch.cuda.synchronize()
    mem["end"] = torch.cuda.memory_allocated()
    fleet_health("14b crash", router, card, crashes=1)
    assert_fleet_conserved(router, "14b crash")
    counted("14b crash", torch.float32, fleet_steps(router.engines), "both replicas, the dead one included")
    print(f"14b engine_crash@{CRASH_ROUND}: crash log {router.crash_log}, failovers {router.failovers}, failed-over "
          f"streams {router.failed_over_streams}, alive {sum(router.alive)}/2, dropped 0; device memory allocated "
          f"{mem[CRASH_ROUND - 1] / 2**20:.1f} MiB before the crash, {mem[CRASH_ROUND] / 2**20:.1f} MiB after it, "
          f"{mem['end'] / 2**20:.1f} MiB after the drain (the dead replica keeps its pool) on {card}")
    if router.crash_log[0]["round"] != CRASH_ROUND or router.failed_over_streams < 1:
        raise SystemExit("14b: the crash must kill one replica with streams in flight")
    compare_streams("14b f32 streams across the crash vs one engine", got, want[torch.float32])
    del router
    free_memory()
    for kind in ("spill_corrupt", "handoff_stall"):
        reset_launches()
        router = FleetRouter([new_engine(cfg, params32, torch.float32, prefix_cache=True) for _ in range(2)])
        faults.activate(kind)
        try:
            got = fleet_drive(router, reqs, stage_spill=True)
        finally:
            faults.clear()
        fleet_health(f"14b {kind}", router, card)
        assert_fleet_conserved(router, f"14b {kind}")
        counted(f"14b {kind}", torch.float32, fleet_steps(router.engines), "both replicas")
        sp = router.spill.stats()
        print(f"14b staged spill with {kind}: {json.dumps(sp)}; readopted pages per replica "
              f"{[e.spill_readopted_pages for e in router.engines]} on {card}")
        if (kind == "spill_corrupt" and sp["corrupt_discarded"] < 1) or (
                kind == "handoff_stall" and sp["stall_fallbacks"] < 1):
            raise SystemExit(f"14b: {kind} was never caught")
        compare_streams(f"14b f32 staged spill with {kind} vs one engine", got, want[torch.float32])
        del router
        free_memory()
    for dt in (torch.bfloat16, torch.float32, torch.int8):
        spill, readopt, nbytes = spill_cost(cfg, dt)
        print(f"14b spill tier, {str(dt)[6:]} pages of {PAGE} tokens x {L} layers: spill {spill:.3f} ms a page "
              f"(copy to the host + crc32), re-adoption {readopt:.3f} ms a page (crc32 check + copy back), "
              f"{nbytes} host bytes a page, on {card}")
    free_memory()
    # the int8 pair: the staged spill's pages carry their scales
    reset_launches()
    single = new_engine(cfg, params32, torch.int8, prefix_cache=True)
    want8 = serve_waves(single, reqs)
    router = FleetRouter([new_engine(cfg, params32, torch.int8, prefix_cache=True) for _ in range(2)])
    got = fleet_drive(router, reqs, stage_spill=True)
    fleet_health("14b int8", router, card)
    assert_fleet_conserved(router, "14b int8")
    counted("14b int8", torch.int8, device_steps(single.stats()) + fleet_steps(router.engines),
            "the int8 engine and both replicas")
    print(f"14b int8 pair, staged spill: {json.dumps(router.spill.stats())} on {card}")
    if router.spill.readopted < 1:
        raise SystemExit("14b int8: no page was re-adopted from the tier")
    compare_streams("14b int8 fleet with re-adopted pages vs the int8 engine", got, want8)
    del single, router
    free_memory()

    # 14c. disagg on one card, the decode role under group:4 and off in
    # both precisions: f32 holds both bit for bit against the monolithic
    # engine; in bf16 the off run is the witness that adopting while a
    # group:4 round is in flight changes no token (its streams must equal
    # the group:4 run's exactly), so a departure from the monolithic engine
    # comes from the roles' split of the work, not from the overlap
    disagg = {}
    for dt, mode, group in DISAGG_RUNS:
        params = params16 if dt == torch.bfloat16 else params32
        label = f"{str(dt)[6:]} decode role {mode}{f':{group}' if mode == 'group' else ''}"
        obs = Observability()
        reset_launches()
        d = DisaggServe(cfg, params, obs=obs, page_size=PAGE, prefill_chunk=256, decode_chunk=8, cache_dtype=dt,
                        device="cuda", prefill_kw=dict(max_slots=2), decode_kw=dict(max_slots=4, overlap=mode,
                                                                                      round_group=group))
        passes = []
        for _ in range(2):  # the first pass captures; the second is timed
            since, shipped0, caps0 = len(obs.tracer), d.queue.pages_copied, captures_of(d.decode)
            uids = [d.submit(p, m) for p, m in reqs]
            t0 = time.perf_counter()
            d.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            streams = [d.finished[u].tokens for u in uids]
            passes.append((streams, wall, d.queue.pages_copied - shipped0, captures_of(d.decode) - caps0,
                           handoff_ms(obs, since)))
        counted(f"14c {label}", dt, device_steps(d.decode.stats()) + device_steps(d.prefill.stats()),
                "both roles, both passes")
        streams, wall, shipped, caps, ms = passes[1]
        disagg[(dt, mode)] = streams
        print(f"14c {label}: {shipped} pages shipped in the timed pass ({wall:.3f} s), gather "
              f"{ms['handoff.gather'] / max(shipped, 1):.3f} ms a page, adopt {ms['handoff.adopt'] / max(shipped, 1):.3f} "
              f"ms a page, fallback_reprefills {d.fallback_reprefills}, captures on the decode role inside the timed "
              f"pass {caps} (warm-up pass {passes[0][3]}) on {card}")
        if caps != 0 or shipped < 1:
            raise SystemExit(f"14c {label}: {caps} captures inside the timed pass, {shipped} pages shipped")
        compare_streams(f"14c {label} timed pass vs its warm-up pass", streams, passes[0][0])
        if mode == "off" and (dt, "group") in disagg:
            compare_streams(f"14c {label} vs the decode role under group:4", streams, disagg[(dt, "group")])
        compare_streams(f"14c {label} vs a monolithic engine", streams, want[dt],
                        *((cfg, params32, GAP_TOL_BF16_RECHUNK) if dt == torch.bfloat16 else ()))
        if (dt, mode) == (torch.float32, "off"):
            move = d.rebalance(16)
            assert_conserved(d.prefill, "14c after rebalance")
            assert_conserved(d.decode, "14c after rebalance")
            print(f"14c rebalance of 16 pages: prefill {move['src_resize']['from_pages']} -> "
                  f"{move['src_resize']['to_pages']}, decode {move['dst_resize']['from_pages']} -> "
                  f"{move['dst_resize']['to_pages']} pages, conservation held on both roles, on {card}")
            for _ in range(5):
                d.queue.push(types.SimpleNamespace(uid=-1, n_pages=0, blocks={}))
            dec = ModelOps(d).tick()
            d.queue._q.clear()
            print(f"14c ModelOps on a scripted backlog of 5 handoffs: {dec.kind} ({dec.reason}) {dec.args}, applied "
                  f"{dec.applied}; pools now prefill {d.prefill.allocator.num_pages} / decode "
                  f"{d.decode.allocator.num_pages} pages, on {card}")
            if (dec.kind, dec.reason, dec.applied) != ("re_role", "handoff_backlog_deep", True):
                raise SystemExit("14c: the scripted backlog did not re-role pages to the decode role")
        del d
        free_memory()
    del params32, params16
    free_memory()

    # 14d. the chaos scenarios on the card (chaos_serve's tiny model, f32):
    # every engine a scenario builds is recorded, and its launches held
    # against n_layer x the device steps of all of them
    errs = {dt: check_tiny_kernel(dt) for dt in (torch.float32, torch.int8)}
    print(f"14d kernel at head_dim 16 vs plain: max |err| f32 pool {errs[torch.float32]:.2e}, int8 pool "
          f"{errs[torch.int8]:.2e} on {card}")
    built, make_engine = [], chaos_serve._engine

    def recorded_engine(*args, **kw):
        built.append(make_engine(*args, **kw))
        return built[-1]

    chaos_serve._engine = recorded_engine
    try:
        for plan, n in CHAOS_PLANS:
            built.clear()
            reset_launches()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = chaos_serve.main([a for f in plan for a in ("--fault", f)] + [f"--n-requests={n}"])
            line = out.getvalue().strip().splitlines()[-1]
            print(f"14d {line}")
            if rc != 0 or json.loads(line)["status"] != "ok":
                raise SystemExit(f"14d: chaos scenario {plan} failed")
            n_by = check_launches(f"14d {'+'.join(plan)}", chaos_serve._tiny_cfg().n_layer, fleet_steps(built))
            print(f"14d {'+'.join(plan)} paged launches {dict(n_by)} == 2 layers x {fleet_steps(built)} decode steps "
                  f"({len(built)} engines) on {card}")
            launches["tiny"] += n_by
    finally:
        chaos_serve._engine = make_engine
    del built
    free_memory()

    # 14e. loadgen --fleet 2 at half the saturating rate
    rec, n = run_loadgen("14e", [], card, L, args=FLEET_ARGS, rates=(FLEET_RATE,))
    launches["bf16"] += n
    p = rec["points"][0]
    print(f"14e loadgen --fleet 2 at {FLEET_RATE:g} req/s offered (half the saturating pass's "
          f"{FLEET_SATURATED_RPS:g} req/s): TTFT p50 {p['ttft_p50_ms']} / p95 {p['ttft_p95_ms']} ms, TPOT p50 "
          f"{p['tpot_p50_ms']} / p95 {p['tpot_p95_ms']} ms, failovers {p['failovers']}, step errors "
          f"{p['step_errors']}, spill_hits {p['spill_hits']}, fleet prefix_hit_rate {p['prefix_hit_rate']}, "
          f"captures inside the point {p['captures']} on {card}")
    if p["failovers"] != 0 or p["step_errors"] != 0:
        raise SystemExit("14e: a replica failed under plain load")
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


# ---------------------------------------------------------------- phase 15: the worker-process fleet

# 15b: the proc_kill9 round, after the eighth and last arrival (one a router
# round; as in JAX, a submit to a worker killed but not yet declared dead
# raises out of the router), with streams in flight; 15c: each wire kind's round
KILL_ROUND = 9
WIRE_ROUND = 3
# the workers' engine: phase 14's geometry with JAX's worker defaults
# (overlap off, fcfs, an unbounded backlog)
PROC_ENGINE = {"max_slots": 4, "page_size": PAGE, "prefill_chunk": 256, "decode_chunk": 8}
# 15f: chaos_serve's worker-process scenario (the first of JAX's tests/test_fleet_proc.py plans; the other
# three kinds, run here side by side before, are 15c's, so they were cut to keep the script in its time limit)
PROC_PLANS = ("proc_kill9@6",)
# 15g: loadgen --procs --fleet 2 at GPT-2 small's full width, bf16 workers,
# template-headed mixture: a saturating point (every request at once), then
# the timed point at half the rate a saturating pass sustained
# (PROC_SATURATED_RPS, PERF.md, phase 15's cell)
PROC_ARGS = ["--process=poisson", "--n-requests=16", "--template-frac=0.5", "--max-slots=4", "--num-pages=513",
             "--page-size=8", "--prefill-chunk=256", "--decode-chunk=8", "--block-size=1024", "--vocab-size=50304",
             "--n-layer=12", "--n-head=12", "--n-embd=768", "--seed=0", "--fleet=2", "--procs"]
PROC_SATURATED_RPS = 13.09
EARLIER_SMOKE_PHASE15_S = 729.0  # this script's wall time before phase 15 was added (PERF.md, earlier slices)


def proc_spec(cfg, pool: str, params: str = "float32"):
    from midgpt_tpu_torch.sampling.fleet_proc import parent_torch_config

    return {"model": dataclasses.asdict(cfg), "seed": 0, "engine": {**PROC_ENGINE, "cache_dtype": pool},
            "param_dtype": params, "device": "cuda", "torch_config": parent_torch_config()}


def gpu_apps():
    """Per-process device memory as nvidia-smi lists it, and the card's free
    memory as CUDA reports it (every process's allocations)."""
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    free, total = torch.cuda.mem_get_info()
    return apps, (total - free) / 2**20


def proc_fleet(card: str):
    """Phase 15. Returns the paged-kernel launches made in its workers (read
    over their stats RPC, each worker held to n_layer x its decode steps)
    by pool (POOL_OF)."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.robustness import faults
    from midgpt_tpu_torch.robustness.chaos_serve import drive_fleet
    from midgpt_tpu_torch.sampling import fleet_proc as fp
    from midgpt_tpu_torch.sampling.fleet import FleetRouter, assert_fleet_conserved
    from midgpt_tpu_torch.sampling.serve import BackpressureError

    t_phase = time.perf_counter()
    cfg = load_config("openwebtext").model_config
    L = cfg.n_layer
    reqs = template_trace(cfg.vocab_size, seed=FLEET_TRACE_SEED)
    launches = collections.defaultdict(collections.Counter)
    seen = {}  # worker pid -> its launches at the last harvest
    parent0 = fp.process_launch_counts()
    roles = {"ref32": ("float32", "float32"), "f32a": ("float32", "float32"), "f32b": ("float32", "float32"),
             "ref16": ("bfloat16", "bfloat16"), "b16a": ("bfloat16", "bfloat16"), "b16b": ("bfloat16", "bfloat16"),
             "i8a": ("int8", "float32"), "i8b": ("int8", "float32")}
    # 15f, started first: chaos_serve's worker-process scenario (its own tiny workers) runs beside 15a-e, which
    # its ~25 s of mostly start-up slow little (PERF.md, section 4); read after 15e
    t_chaos = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    chaos_runs = [subprocess.Popen([sys.executable, "-m", "midgpt_tpu_torch.robustness.chaos_serve", "--fault", plan,
                                    "--n-requests=4"], cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
                  for plan in PROC_PLANS]
    procs = []
    try:
        t0 = time.perf_counter()
        procs = fp.spawn_workers([proc_spec(cfg, pool, par) for pool, par in roles.values()])
        spawn_wall = time.perf_counter() - t0
        proc = dict(zip(roles, (p for p, _ in procs)))
        rep = {name: fp.connect_replica(port, retry_base_s=0.05) for name, (_, port) in zip(roles, procs)}
        print(f"15 spawned {len(procs)} workers together in {spawn_wall:.2f} s; spawn-to-PORT s per worker: "
              + ", ".join(f"{n} ({r.cache_dtype} pool, pid {r.pid}) {r.announced_at - proc[n].spawned_at:.2f}"
                          for n, r in rep.items()) + f" on {card}")

        def harvest(label, names):
            """Each worker's launches since its last harvest, by pool; every
            worker's totals == n_layer x its decode steps (eager rounds)."""
            for n in names:
                r = rep[n]
                counts, steps = r.launch_counts()["launches"], r.stats()["decode_steps"]
                paged, merges = counts["paged_attention"], sum(counts["paged_attention_merge"].values())
                if sum(paged.values()) != L * steps or merges != L * steps:
                    raise SystemExit(f"{label} worker {n}: paged launches {dict(paged)}, merge {merges} != {L} layers "
                                     f"x {steps} decode steps")
                total = collections.Counter(paged)
                total[("merge", None)] = merges
                launches[POOL_OF[{"float32": torch.float32, "bfloat16": torch.bfloat16,
                                  "int8": torch.int8}[r.cache_dtype]]] += total - seen.get(r.pid, collections.Counter())
                seen[r.pid] = total
                print(f"{label} worker {n} (pid {r.pid}, {r.cache_dtype} pool): paged launches {dict(paged)} == "
                      f"{L} layers x {steps} decode steps, in its own process, on {card}")

        def drive(label, names, **kw):
            router = FleetRouter([rep[n] for n in names])
            uids = list(drive_fleet(router, reqs, **kw))
            assert_fleet_conserved(router, label)
            return router, finished_streams(router, reqs, uids)

        def parent_check(label):
            if fp.process_launch_counts() != parent0:
                raise SystemExit(f"{label}: the router process launched a kernel or captured a graph")

        # 15a. f32 and bf16 process fleets against a reference worker each
        want, got = {}, {}
        for ref, pair, dt in (("ref32", ("f32a", "f32b"), torch.float32), ("ref16", ("b16a", "b16b"), torch.bfloat16)):
            label = f"15a {str(dt)[6:]}"
            # a worker serves one connection at a time: the reference pass
            # runs over this phase's own connection to the reference worker
            uids = [rep[ref].submit(p, m) for p, m in reqs]
            rep[ref].run()
            want[dt] = finished_streams(rep[ref], reqs, uids)
            t0 = time.perf_counter()
            router, got[dt] = drive(label, pair)
            wall = time.perf_counter() - t0
            fleet_health(label, router, card)
            parent_check(label)
            tr = router.transport_stats()
            print(f"{label} process fleet of 2: {len(reqs)} requests in {wall:.3f} s, transport {json.dumps(tr)}, "
                  f"RPC p50 {tr['rpc_p50_ms']} / p95 {tr['rpc_p95_ms']} ms, fleet prefix_hit_rate "
                  f"{router.prefix_hit_rate():.3f}; parent launches 0 on {card}")
        harvest("15a", ("ref32", "f32a", "f32b", "ref16", "b16a", "b16b"))
        compare_streams("15a f32 process fleet vs the reference worker", got[torch.float32], want[torch.float32])
        # a bf16 departure is allowed at a near-tie: the check's dense f32
        # forward runs in this process, after its launches were held to 0
        params32 = GPT.init(cfg, 0, device="cuda")
        compare_streams("15a bf16 process fleet vs the reference worker", got[torch.bfloat16], want[torch.bfloat16],
                        cfg, params32)
        del params32
        free_memory()
        parent0 = fp.process_launch_counts()

        # 15b. proc_kill9 mid-decode on the f32 pair
        killed, failed_over = {}, {}
        victim = {}
        for n in ("f32a", "f32b"):
            real = rep[n].kill9

            def kill9(n=n, real=real):
                victim["name"], killed["t"] = n, time.perf_counter()
                killed["before"] = gpu_apps()
                real()

            rep[n].kill9 = kill9

        def watch(router):
            if router.crash_log and "t" not in failed_over:
                failed_over["t"] = time.perf_counter()

        faults.clear()
        faults.activate("proc_kill9", step=KILL_ROUND)
        try:
            router, got = drive("15b", ("f32a", "f32b"), watch=watch)
        finally:
            faults.clear()
        parent_check("15b")
        dead = victim["name"]
        proc[dead].wait(timeout=30)
        after = gpu_apps()
        print(f"15b proc_kill9@{KILL_ROUND} on worker {dead} (pid {rep[dead].pid}): crash log {router.crash_log}, "
              f"failovers {router.failovers} (proc {router.proc_failovers}), failed-over streams "
              f"{router.failed_over_streams}, alive {sum(router.alive)}/2, dropped 0; kill to failover "
              f"{failed_over['t'] - killed['t']:.3f} s; step errors {len(router.step_errors)} (the dead worker's "
              f"failing RPCs) on {card}")
        print(f"15b device memory: before the kill {killed['before'][1]:.1f} MiB used on the card, per process "
              f"{killed['before'][0]}; after it {after[1]:.1f} MiB, per process {after[0]} on {card}")
        if (router.proc_failovers != 1 or router.failed_over_streams < 1 or len(router.crash_log) != 1
                or router.crash_log[0]["reason"] != "consecutive_failures"):
            raise SystemExit("15b: the kill must be detected through the wire, with streams failed over")
        compare_streams("15b f32 streams across the kill vs the reference worker", got, want[torch.float32])
        survivor = "f32b" if dead == "f32a" else "f32a"

        # 15c. the wire kinds on a fleet of the survivor and the reference worker
        counter_of = {"conn_drop": "reconnects", "wire_corrupt": "corrupt_frames", "wire_stall": "deadline_expiries"}
        for kind, counter in counter_of.items():
            faults.clear()
            faults.activate(kind, step=WIRE_ROUND)
            try:
                router, got = drive(f"15c {kind}", (survivor, "ref32"))
            finally:
                fired = faults.fired_counts()
                faults.clear()
            fleet_health(f"15c {kind}", router, card)
            tr = router.transport_stats()
            print(f"15c {kind}@{WIRE_ROUND}: fired {fired}, {counter} {tr[counter]}, transport {json.dumps(tr)} on "
                  f"{card}")
            if fired.get(kind) != 1 or tr[counter] < 1:
                raise SystemExit(f"15c: {kind} did not bite ({counter} {tr[counter]})")
            compare_streams(f"15c f32 streams under {kind} vs the reference worker", got, want[torch.float32])
        parent_check("15c")
        harvest("15c", (survivor, "ref32"))

        # 15d. SIGTERM to a bf16 worker with streams in flight
        r = rep["b16a"]
        uids = [r.submit(p, m) for p, m in reqs[:4]]
        r.step()
        t_term = time.perf_counter()
        os.kill(r.pid, signal.SIGTERM)
        r.step()  # the worker sees the flag between RPCs
        try:
            r.submit(*reqs[4])
            raise SystemExit("15d: a draining worker admitted a request")
        except BackpressureError as e:
            if e.retryable:
                raise SystemExit("15d: a draining worker's refusal must not be retryable")
        r.run()
        finished_streams(r, reqs[:4], uids)
        r.assert_conserved("15d after the drain")
        harvest("15d", ("b16a",))
        r.close()
        rc = proc["b16a"].wait(timeout=60)
        print(f"15d SIGTERM with 4 streams in flight: all finished with their budgets, a new request refused "
              f"(not retryable), rc {rc}, {time.perf_counter() - t_term:.3f} s from SIGTERM to exit on {card}")
        if rc != 0:
            raise SystemExit(f"15d: the drained worker exited with rc {rc}")

        # 15e. a spill transfer between two live int8 workers
        a, b = rep["i8a"], rep["i8b"]
        ua = [a.submit(p, m) for p, m in reqs]
        a.run()
        want8 = finished_streams(a, reqs, ua)
        flushed = a.flush_prefix_cache()
        wa, wb = a.transport.wire_bytes, b.transport.wire_bytes
        t0 = time.perf_counter()
        items = a.export_spill()
        t1 = time.perf_counter()
        imported = b.import_spill(items)
        t2 = time.perf_counter()
        n = len(items)
        a.assert_conserved("15e after the export")
        b.assert_conserved("15e after the import")
        ub = [b.submit(p, m) for p, m in reqs]
        b.run()
        got8 = finished_streams(b, reqs, ub)
        b.assert_conserved("15e after the re-adoption")
        la, lb = a.spill_ledger(), b.spill_ledger()
        print(f"15e int8 spill transfer: {flushed} trie pages flushed, {n} pages moved ({imported} imported), "
              f"export {(a.transport.wire_bytes - wa) / max(n, 1):.0f} wire bytes a page in {(t1 - t0) * 1e3 / max(n, 1):.3f} "
              f"ms a page, import {(b.transport.wire_bytes - wb) / max(n, 1):.0f} wire bytes a page in "
              f"{(t2 - t1) * 1e3 / max(n, 1):.3f} ms a page; ledgers {json.dumps(la)} / {json.dumps(lb)}; re-adopted "
              f"pages {b.spill_readopted_pages} on {card}")
        if n < 1 or imported != n or la["transferred"] != n or lb["received"] != n or b.spill_readopted_pages < 1:
            raise SystemExit("15e: the pages did not move and come back into a decode")
        compare_streams("15e int8 streams on re-adopted pages vs the int8 worker's", got8, want8)
        harvest("15e", ("i8a", "i8b"))
        parent_check("15e")
        for name, r in rep.items():
            if name not in (dead, "b16a"):
                r.close()
    finally:
        fp.kill_workers(procs)
        if sys.exc_info()[0] is not None:
            for p in chaos_runs:
                p.kill()

    # 15f. chaos_serve's worker-process scenario, started with the phase
    try:
        outs = [p.communicate(timeout=300)[0] for p in chaos_runs]
    finally:
        for p in chaos_runs:
            p.kill()
    for plan, p, out in zip(PROC_PLANS, chaos_runs, outs):
        line = out.strip().splitlines()[-1] if out.strip() else "{}"
        print(f"15f {line}")
        if p.returncode != 0 or json.loads(line).get("status") != "ok":
            raise SystemExit(f"15f: chaos scenario {plan} failed (rc {p.returncode})")
    print(f"15f {len(PROC_PLANS)} scenario(s) read {time.perf_counter() - t_chaos:.1f} s after their start, beside "
          f"15a-e, on {card}")

    # 15g. loadgen --procs --fleet 2: a saturating point, then half the saturating rate
    from midgpt_tpu_torch import loadgen

    rates = (1000.0, PROC_SATURATED_RPS / 2)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        loadgen.main(PROC_ARGS + [f"--rates={','.join(f'{x:g}' for x in rates)}"])
    parent_check("15g")
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"15g loadgen --procs ({time.perf_counter() - t0:.1f} s): {json.dumps(rec)}")
    sat, p = rec["points"]
    print(f"15g saturating point: {sat['completed']}/{sat['n_offered']} in {sat['wall_s']} s = "
          f"{sat['completed'] / sat['wall_s']:.2f} req/s (PROC_SATURATED_RPS {PROC_SATURATED_RPS:g}); at "
          f"{rates[1]:g} req/s offered: TTFT p50 {p['ttft_p50_ms']} / p95 {p['ttft_p95_ms']} ms, TPOT p50 "
          f"{p['tpot_p50_ms']} / p95 {p['tpot_p95_ms']} ms, RPC p50 {p['rpc_p50_ms']} / p95 {p['rpc_p95_ms']} ms, "
          f"{p['wire_bytes']} wire bytes, failovers {p['failovers']}, step errors {p['step_errors']}, fleet "
          f"prefix_hit_rate {p['prefix_hit_rate']} (workers' eager decode, overlap off) on {card}")
    for q in rec["points"]:
        if q["completed"] != q["n_offered"] or q["failovers"] or q["step_errors"] or q["wire_bytes"] < 1:
            raise SystemExit("15g: a point lost requests or a worker failed under plain load")
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


# ---------------------------------------------------------------- phase 16: the routed MoE MLP


EARLIER_SMOKE_PHASE16_S = 765.6  # this script's wall time before phase 16 was added (PERF.md, earlier slices)
# 16: local_text_124m with the routed MLP of docs/PARALLELISM.md (8 experts, top-2; no mesh.ep: one
# card) and Switch's load-balance coefficient, as launcher --set overrides
MOE_SETS = {"model_config.n_experts": 8, "model_config.moe_top_k": 2, "moe_aux_coef": 0.01}
MOE_MODEL = {"n_experts": 8, "moe_top_k": 2}
MOE_BATCH_ROWS, MOE_BATCH_NEW = 8, 128  # 16b: the batch sampler, 8 distinct prompts of phase 12's length


def moe_training(data_dir: Path, card: str):
    """Phase 16a: local_text_124m with the routed MLP through the launcher
    at full width on phase 6's cuts (no run directory: the trained weights
    come back in the launcher's result), flash counters zeroed just before
    and read just after, every training microstep's aux term recorded.
    Then one f32 step through the flash kernel against the plain path.
    Returns (the trained f32 params, the model config, flash launches by
    kernel and variant, training tokens/s, the losses by step)."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.training.metrics import device_peak_flops, flops_per_token

    t_phase = time.perf_counter()
    base = load_config("local_text_124m")
    mc = dataclasses.replace(base.model_config, **MOE_MODEL)
    print("phase 16a reduced: " + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in TRAIN_CUTS.items())
          + f"; {', '.join(f'{k}={v}' for k, v in MOE_SETS.items())}; remat {base.model_config.remat} (the preset's); "
          f"no run directory; data: seeded synthetic uint16 stream (vocab {mc.vocab_size})")
    auxes = []
    hidden = GPT.__dict__["hidden"]

    def recording(*args, **kw):  # the training loss's aux term of each microstep, read after the run
        out = hidden.__func__(*args, **kw)
        if kw.get("return_moe_aux"):
            auxes.append(out[1].detach())
        return out

    GPT.hidden = staticmethod(recording)
    try:
        result, losses, tok_s, mfu, peak, launches = preset_run(data_dir, "local_text_124m", TRAIN_CUTS, **MOE_SETS)
    finally:
        GPT.hidden = hidden
    params = result["params"]
    del result
    G, steps = TRAIN_CUTS["g_accum_iters"], TRAIN_CUTS["max_steps"]
    micro, evals = G * steps, 3 * TRAIN_CUTS["eval_steps"]
    flash_launch_check("16a MoE", launches, mc.n_layer, micro, evals)
    if len(auxes) != micro:
        raise SystemExit(f"16a: {len(auxes)} aux terms recorded, want one per microstep ({micro})")
    aux = torch.stack(auxes).float().reshape(steps, G).mean(1).tolist()
    if not all(np.isfinite(aux)) or min(aux) < 1.0 - 1e-4:  # E * sum P_e f_e >= 1 (Cauchy-Schwarz)
        raise SystemExit(f"16a: aux terms {aux} not finite or below 1")
    executed = flops_per_token(dataclasses.replace(mc, moe_top_k=mc.n_experts))  # every expert runs
    peak_flops = device_peak_flops()
    exec_mfu = None if peak_flops is None else tok_s * executed / peak_flops
    print(f"16a MoE local_text_124m ({mc.n_layer} x {mc.n_embd}, {mc.n_experts} experts, top-{mc.moe_top_k}, "
          f"aux coefficient {MOE_SETS['moe_aux_coef']}): losses {[round(x, 4) for x in losses]}, aux by step "
          f"{[round(x, 5) for x in aux]}; steps 1-{steps - 1}: {tok_s:.1f} tokens/s, MFU "
          f"{'not known for this card' if mfu is None else f'{100 * mfu:.2f}%'} (active experts, "
          f"{flops_per_token(mc) / 1e9:.3f} GFLOP a token), executed MFU "
          f"{'not known' if exec_mfu is None else f'{100 * exec_mfu:.2f}%'} (all {mc.n_experts} experts, "
          f"{executed / 1e9:.3f} GFLOP a token); peak memory {gib(peak)} ({peak:,} bytes) with remat "
          f"{'on (' + mc.remat_policy + ')' if mc.remat else 'off'}; flash launches {launches} ({mc.n_layer} layers x "
          f"({micro} microsteps + {evals} eval batches)) on {card}")
    free_memory()
    moe_parity(data_dir, mc, card)
    print(f"phase 16a took {time.perf_counter() - t_phase:.1f} s")
    return params, mc, launches, tok_s, losses


@contextlib.contextmanager
def routing(store: list, pin: tp.Optional[list] = None, flips: tp.Optional[list] = None):
    """GPT._moe_gates wrapped for phase 16a's and 22a's parity: every call
    appends (its selection (..., E) bool, its router logits f32) to
    `store`; with `pin` (another run's records, in call order) a call whose
    own selection differs routes with the pinned one instead (gates and aux
    recomputed from this run's logits), and `flips` gets [the call's index,
    the gap between this run's K-th and K+1-th logits relative to the
    larger] at each token the pin overrode; the calls after the pin's last
    route as they are. A rank of
    a mesh pins its batch position's rows of a one-rank record (data and
    fsdp are the mesh's slowest axes: the position is RANK over the ranks
    a position holds)."""
    from midgpt_tpu_torch.models.gpt import GPT

    raw = GPT.__dict__["_moe_gates"]
    pinned = iter(pin) if pin is not None else None

    def gates_fn(config, blk, h, with_aux=True, aux_reduce=None):
        gates, aux = raw.__func__(config, blk, h, with_aux, aux_reduce)
        logits = (h @ blk["mlp.router"].T).float()
        rec = next(pinned, None) if pinned is not None else None
        if rec is not None:
            sel = rec[0].to(logits.device)
            b = logits.shape[0]
            if sel.shape[0] != b:  # a mesh rank: its batch position's rows
                pos = int(os.environ["RANK"]) // (int(os.environ["WORLD_SIZE"]) // (sel.shape[0] // b))
                sel = sel[pos * b:(pos + 1) * b]
            own = gates > 0
            if not torch.equal(sel, own):
                K, tokens = config.moe_top_k, tuple(range(logits.dim() - 1))
                if flips is not None:
                    top, moved = torch.topk(logits, K + 1, dim=-1).values, (sel != own).any(-1)
                    kth, nxt = top[..., K - 1][moved], top[..., K][moved]
                    gap = (kth - nxt) / torch.maximum(kth.abs(), nxt.abs()).clamp_min(1e-30)
                    flips.extend([len(store), g] for g in gap.tolist())
                gates = torch.softmax(logits.masked_fill(~sel, float("-inf")), dim=-1).to(h.dtype)
                if with_aux:
                    mean_prob = torch.softmax(logits, dim=-1).mean(tokens)
                    aux = config.n_experts * (mean_prob * sel.float().mean(tokens) / K).sum()
        store.append(((gates > 0).detach(), logits.detach()))
        return gates, aux

    GPT._moe_gates = staticmethod(gates_fn)
    try:
        yield store
    finally:
        GPT._moe_gates = raw


def routing_flips(a: list, b: list, n_layer: int, K: int):
    """Tokens whose expert selection differs between two runs' routing
    records (`routing`), as (step, layer, row, position, relative gap
    between the K-th and K+1-th router logits of run a). A flip is primary
    unless its row flipped at an earlier layer of the same forward at or
    before its position (causal attention carries that change to it)."""
    primary, downstream = [], []
    for i, ((sa, la), (sb, _)) in enumerate(zip(a, b)):
        step, layer = divmod(i, n_layer)
        top = torch.topk(la, K + 1, dim=-1).values
        for row, pos in (sa != sb).any(-1).nonzero().tolist():
            kth, nxt = top[row, pos, K - 1].item(), top[row, pos, K].item()
            flip = (step, layer, row, pos, (kth - nxt) / max(abs(kth), 1e-30))
            earlier = any(f[0] == step and f[1] < layer and f[2] == row and f[3] <= pos for f in primary + downstream)
            (downstream if earlier else primary).append(flip)
    return primary, downstream


def moe_parity(data_dir: Path, mc, card: str):
    """Phase 16a's f32 parity: two steps (the first at lr 0) of the MoE
    model, 2 layers at full width, through the flash kernels and through
    dense attention. The losses are held at phase 7's limit. A token whose
    top-k selection flips between the two (their attention outputs differ
    in the last bits) changes its experts' Adam updates discretely, so
    every primary flip must sit at a near-tie (gap < GAP_TOL) and the
    update is held at phase 7's limit with the dense run routed as the
    flash run routed (`routing` pin): the attention paths alone."""
    K = mc.moe_top_k
    flash_rec, naive_rec, pinned_rec = [], [], []
    with routing(flash_rec):
        kl, p0, pk = parity_run(data_dir, 2, "float32", 2, "flash", moe=True)
    with routing(naive_rec):
        nl, _, pn = parity_run(data_dir, 2, "float32", 2, "naive", moe=True)
    free_memory()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(kl, nl))
    natural_upd = update_rel_err(pk, pn, p0)
    del pn
    with routing(pinned_rec, pin=flash_rec):
        pl, _, pp = parity_run(data_dir, 2, "float32", 2, "naive", moe=True)
    pin_loss_err = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    upd_err = update_rel_err(pk, pp, p0)
    del p0, pk, pp
    free_memory()
    primary, downstream = routing_flips(flash_rec, naive_rec, 2, K)
    leftover = sum(int((a[0] != b[0]).any(-1).sum()) for a, b in zip(flash_rec, pinned_rec))
    tokens = flash_rec[0][0].shape[0] * flash_rec[0][0].shape[1]
    print(f"16a parity f32, MoE, 2 layers at full width, 2 steps (the first at lr 0), {tokens} tokens a step: losses "
          f"flash {kl} vs dense {nl} (max rel err {loss_err:.2e}, tol {PARITY_TOL['f32_loss']:g}); routing flips "
          f"between them: {len(primary)} primary, {len(downstream)} downstream of one"
          + "".join(f"; step {st} layer {ly} row {r} position {ps}: K/K+1 router logit gap {g:.3e} relative"
                    for st, ly, r, ps, g in primary)
          + f" (tol {GAP_TOL:g}); parameter update rel err {natural_upd:.2e} as routed, {upd_err:.2e} with the dense "
          f"run routed as the flash run (tol {PARITY_TOL['f32_update']:g}; its losses {pl}, rel err "
          f"{pin_loss_err:.2e}; tokens routed apart after the pin {leftover}) on {card}")
    if loss_err > PARITY_TOL["f32_loss"] or pin_loss_err > PARITY_TOL["f32_loss"] or upd_err > PARITY_TOL["f32_update"]:
        raise SystemExit("16a: the MoE train step through the flash kernels disagrees with dense attention")
    if any(g >= GAP_TOL for *_, g in primary) or leftover:
        raise SystemExit("16a: a routing flip between the attention paths is not at a near-tie, or the pin failed")
    if not primary and natural_upd > PARITY_TOL["f32_update"]:
        raise SystemExit("16a: the update departs with no routing flip to explain it")


def moe_serving(card: str, mc, params32, dense_group4, dense_batch8):
    """Phase 16b: the trained MoE weights served. bf16 group:4 (CUDA-graph
    replays; the first pass captures): every request its budget, paged
    launches == n_layer x device steps, a merge per template call, the
    second pass == the first, and == the eager engine but at a near-tie;
    f32 through the kernel == the gather lowering; `generate` at B 8 in
    bf16, replayed == eager bit for bit, flash_fwd n_layer per prefill.
    Decode tokens/s beside the dense model's of phases 4b and 12a. Returns
    (paged launches by (spec, split), merge launches, flash_fwd launches)."""
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.kernels import flash_attention as fa
    from midgpt_tpu_torch.sampling import engine
    from midgpt_tpu_torch.sampling.graphs import StepGraphs
    from midgpt_tpu_torch.utils.precision import cast_floating

    t_phase = time.perf_counter()
    params16 = cast_floating(params32, torch.bfloat16)
    total = sum(m for _, m in trace(mc.vocab_size))
    eng = new_engine(mc, params16, torch.bfloat16, overlap="group", round_group=4)
    tpl.LAUNCHES.reset()
    tpl.MERGE_LAUNCHES.reset()
    first, wall1 = serve_trace(eng)  # captures each key's graph at its first dispatch
    st1 = eng.stats()
    again, wall = serve_trace(eng)  # replays only
    st = eng.stats()
    paged, merges = dict(tpl.LAUNCHES.by_variant), tpl.MERGE_LAUNCHES.count
    steps, graphs = device_steps(st), st["decode_graphs"]
    tokens, seconds = (st[k] - st1[k] for k in ("decode_tokens", "decode_seconds"))
    tok_s = tokens / seconds
    print(f"16b MoE bf16 group:4, second pass: decode {tok_s:.1f} tokens/s ({tokens} tokens in {seconds:.3f} s), end "
          f"to end {total / wall:.1f} tokens/s (first pass, captures included: {total / wall1:.1f}); dense GPT-2 small "
          f"group:4 (phase 4b, openwebtext, same trace): {dense_group4[0]:.1f} tokens/s in rounds, {dense_group4[1]:.1f} "
          f"end to end; both passes: device steps {steps} x {mc.n_layer} layers = {mc.n_layer * steps}, template "
          f"launches {paged}, merge launches {merges}; graphs {graphs} on {card}")
    if sum(paged.values()) != mc.n_layer * steps or merges != sum(paged.values()):
        raise SystemExit("16b: paged launches != n_layer x device steps, or a call bypassed the merge kernel")
    if graphs is None or graphs["replays"] < 1 or set(graphs["captures_per_key"]) != {1}:
        raise SystemExit(f"16b: group:4 must replay CUDA graphs, each key captured once: {graphs}")
    compare_streams("16b MoE bf16 group:4, second pass vs first", again, first)
    _, off16, _ = serve(mc, params16, torch.bfloat16)
    compare_streams("16b MoE bf16 group:4 vs off (eager)", first, off16, mc, params16)
    _, kernel32, _ = serve(mc, params32, torch.float32, attn_impl="auto")
    _, gather32, _ = serve(mc, params32, torch.float32, attn_impl="gather")
    compare_streams("16b MoE f32 kernel vs gather", kernel32, gather32)
    free_memory()
    # the batch sampler: replayed == eager bit for bit, in turns after one capturing call
    prompts = np.random.default_rng(16).integers(0, 50257, (MOE_BATCH_ROWS, len(BATCH_IDS)))
    graphs_b = StepGraphs(torch.device("cuda"))
    fa.FWD_LAUNCHES.reset()
    rates, want = {"replayed": [], "eager": []}, None
    modes = ("capturing", "eager", "replayed", "replayed", "eager")
    for mode in modes:
        st_b = {}
        kw = {"_eager": True} if mode == "eager" else {"graphs": graphs_b}
        n = EAGER_NEW if mode == "eager" else MOE_BATCH_NEW
        got = engine.generate(mc, params16, prompts, n, temperature=0.0, device="cuda", stats=st_b, **kw)
        if want is None:
            want = got
        elif not torch.equal(got, want[:, :prompts.shape[1] + n]):
            raise SystemExit(f"16b: batch generate, {mode} greedy tokens differ from the capturing call's")
        if mode != "capturing":
            rates[mode].append(MOE_BATCH_ROWS * (n - 1) / st_b["decode_s"])
    torch.cuda.synchronize()
    batch_fwd = fa.FWD_LAUNCHES.count
    if graphs_b.captures != 1 or batch_fwd != mc.n_layer * len(modes):
        raise SystemExit(f"16b: batch generate captured {graphs_b.captures} graphs, flash_fwd launched {batch_fwd} "
                         f"times (want 1 and {mc.n_layer} x {len(modes)} prefills)")
    print(f"16b MoE batch generate bf16 B={MOE_BATCH_ROWS}, {len(BATCH_IDS)}-token prompts, {MOE_BATCH_NEW} new "
          f"(the eager calls {EAGER_NEW}): replayed == eager bit for bit; replayed "
          f"{[round(r, 1) for r in rates['replayed']]} tokens/s, eager {[round(r, 1) for r in rates['eager']]} (in "
          f"turns); dense local_text_124m B=8 (phase 12a, {BATCH_NEW} new, eager {EAGER_NEW}): "
          f"replayed {[round(r, 1) for r in dense_batch8['replayed']]}, eager {[round(r, 1) for r in dense_batch8['eager']]}; "
          f"flash_fwd {batch_fwd} = {mc.n_layer} x {len(modes)} prefills on {card}")
    del params16
    free_memory()
    print(f"phase 16b took {time.perf_counter() - t_phase:.1f} s")
    return paged, merges, batch_fwd


def moe_path(card: str, dense_group4, dense_batch8):
    """Phase 16 (16a, then 16b on 16a's weights). Returns (flash launches
    by kernel, paged launches by (spec, split), merge launches, 16a's
    losses by step)."""
    from midgpt_tpu_torch.config import load_config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = Path(tmp)
        synthetic_stream(data_dir, load_config("local_text_124m").model_config.vocab_size)
        params32, mc, train_launches, _, losses = moe_training(data_dir, card)
    paged, merges, batch_fwd = moe_serving(card, mc, params32, dense_group4, dense_batch8)
    del params32
    free_memory()
    flash = {n: sum(v.values()) for n, v in train_launches.items()}
    flash["flash_fwd"] += batch_fwd
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s; launches: flash {flash}, paged {paged}, merge "
          f"{merges} on {card}")
    return flash, paged, merges, losses


# ---------------------------------------------------------------- phase 17: data-parallel and FSDP training

EARLIER_SMOKE_PHASE17_S = 806.6  # this script's wall time before phase 17 was added (PERF.md, phase 16)
# The f32 pair of 17b and 17c warm up in one step (warmup_steps 1: lr 0 at step 0, the preset's peak from
# step 1), so each update after the first moves the weights by ~lr and a wrong reduction or a wrong
# resharded restore shows in the losses and the states (under the presets' warmup, lr stays below 1e-5).
# 17b: the f32 pair, local_text_124m at 2 layers of full width over attn_block_size 512 (the tiled flash
# bodies), fsdp 2, on phase 6's other cuts; the 2-rank losses (each step's and the final eval's) are held
# to the one-rank run's at PAIR_TOL relative (PARITY_TOL's f32 loss bound), and the final states at
# STATE_TOL.
PAIR_SETS = {"model_config.n_layer": 2, "compute_dtype": "float32", "model_config.attn_block_size": 512,
             "mesh.fsdp": 2, "spec_layers": 0, "warmup_steps": 1}
PAIR_TOL = PARITY_TOL["f32_loss"]
# Final f32 states of two runs that differ only in rank count, absolute: the moments at
# tests/test_torch_parallel.py's limits for JAX's (data=2, fsdp=2) step (a wrong reduction moves them
# by their own size, ~1e-3 for mu); each weight within PARAM_TOL_LR x lr per update with lr > 0 (Adam
# moves a weight by up to ~lr a step, and where a gradient is small another summation order changes
# that step by a few % of lr; a wrong restore moves a weight by its own size, ~0.02)
STATE_TOL = {"mu": 1e-6, "nu": 1e-8}
PARAM_TOL_LR = 0.05
# 17b openwebtext_xl on 2 ranks at phase 11c's cut, held to 11c's single-device losses at XL_DP_TOL
# relative: ~10x the bf16 difference read on an H100 80GB HBM3 at 700 W (8.42e-8 in each of PR 17's
# whole-script runs, PERF.md). Under the preset's warmup lr stays below 4e-7 over these 2 steps, so this
# holds the forward through the gathered bf16 weights and a rank's memory, not the update: the f32 pair
# and 17c hold the update (a single-device xl run with the one-step warmup beside it would add ~35 s to a
# script that runs near its time limit)
XL_DP_TOL = 1e-6
# 17c: chaos_train on phase 6's cuts at 2 layers of full width in f32, to keep the phase's three launches
# short: 2 ranks to step 2, 1 rank for step 3 (the restore onto more ranks, a second reshard here before,
# is 19c's: PERF.md, section 4); the per-step losses held to an uninterrupted 1-rank run's at chaos_train's
# f32 PARITY_RTOL, the final states at STATE_TOL
CHAOS_CUTS = {**TRAIN_CUTS, "model_config.n_layer": 2, "spec_layers": 0, "warmup_steps": 1,
              "compute_dtype": "float32"}
CHAOS_FAULTS = ("resume_reshard@2",)


def rank17_main(argv) -> int:
    """One rank of phase 17 under torchrun: joins the process group (the
    backend the first launch names), runs `launch.main` on each
    `--then`-separated argument list in turn, and writes this rank's
    report per launch (its logged records, flash launches causal and
    full, the ring's hops, Ulysses' all-to-alls, the pipeline's stage
    sends and the ep groups' all-reduces with their bytes, 1F1B's stash
    high-water mark and a pipeline microstep's own peak memory, the init's
    peak memory beside its state and largest drawn piece, peak memory,
    state bytes and the expert banks' share of them, the routing flips a
    pin overrode, host clock) to <argv[0]>.<RANK>.json for the parent. An
    argument `--routing=record:PATH` (taken out before the launch) saves
    the launch's routing selections to PATH, `--routing=pin:PATH` pins
    them (`routing`), `--routing=pin:PATH:START:STOP` pins records
    [START, STOP) of them; `--wait-for=PATH` holds the launch until PATH
    exists (another group's record or mark, at most EP_WAIT_S);
    `--mark-done=PATH` writes PATH once the launch is done and its memory
    freed (another group's `--wait-for` starts then)."""
    t_enter = time.time()
    out, runs = argv[0], [[]]
    for a in argv[1:]:
        runs.append([]) if a == "--then" else runs[-1].append(a)
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.kernels import flash_attention as fa
    from midgpt_tpu_torch.models.gpt import param_shapes
    from midgpt_tpu_torch.parallel import dist, pipeline, ring_attention, ulysses
    from midgpt_tpu_torch.parallel import tp as tp_mod
    from midgpt_tpu_torch.sampling.fleet_proc import process_launch_counts
    from midgpt_tpu_torch.training import train as train_mod

    def counts():
        out = {k: collections.Counter({v: n for v, n in pairs})
               for k, pairs in process_launch_counts()["launches"].items() if k.startswith("flash")}
        out.update({c.name: collections.Counter(c.by_variant) for c in fa._COUNTERS[False]})
        return out

    def traffic():
        return collections.Counter({**{f"hop_{k}": n for k, n in ring_attention.HOPS.items()},
                                    **{f"a2a_{k}": n for k, n in ulysses.A2A.items()},
                                    **{f"pp_{k}": n for k, n in pipeline.SENDS.items()},
                                    **{f"ep_{k}": n for k, n in tp_mod.EP_TRAFFIC.items()}})

    init_state, inits = train_mod.init_state, []

    def measured_init(config, device=None, mesh=None):
        """init_state, with its peak memory (from zero: nothing else is on
        the card yet), the state it made and the largest piece it draws
        (a layer's slice of a block leaf, or the embedding, in f32)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = init_state(config, device, mesh)
        torch.cuda.synchronize()
        params, opt_state, _ = out
        state = [*params.values(), *opt_state.mu.values(), *opt_state.nu.values()]
        shapes = param_shapes(config.model_config)
        lead = {k: 2 if "experts" in k else 1 if k.startswith("blocks.") else 0 for k in shapes}
        inits.append({"peak": torch.cuda.max_memory_allocated() - base,
                      "state_bytes": sum(t.numel() * t.element_size() for t in state),
                      "piece": 4 * max(int(np.prod(s[lead[k]:])) for k, s in shapes.items()),
                      "dense": sum(int(np.prod(s)) for s in shapes.values())
                      * torch.finfo(getattr(torch, config.param_dtype)).bits // 8})
        return out

    train_mod.init_state = measured_init
    sched, loss_and_grad = {"peak": 0, "outer": 0}, pipeline.Pipeline.loss_and_grad

    def measured_schedule(self, *a, **k):
        """A pipeline microstep, with its own peak memory (no eval's); the
        launch's peak keeps what came before."""
        torch.cuda.synchronize()
        sched["outer"] = max(sched["outer"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = loss_and_grad(self, *a, **k)
        torch.cuda.synchronize()
        sched["peak"] = max(sched["peak"], torch.cuda.max_memory_allocated())
        return out

    pipeline.Pipeline.loss_and_grad = measured_schedule

    first = runs[0]
    dist.init(None, first[first.index("--backend") + 1] if "--backend" in first else None)
    reports = []
    try:
        for args in runs:
            before, moved_before = counts(), traffic()
            pipeline.STASH["high_water"] = 0
            inits.clear()
            sched.update(peak=0, outer=0)
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            hooks = [a.removeprefix("--routing=").split(":") for a in args if a.startswith("--routing=")]
            for wait in [a.removeprefix("--wait-for=") for a in args if a.startswith("--wait-for=")]:
                t_wait = time.time()
                while not Path(wait).exists():
                    if Path(f"{wait}.failed").exists():  # the group that records it failed: say why, now
                        raise SystemExit(f"rank {os.environ['RANK']}: {wait} will not appear: "
                                         f"{Path(f'{wait}.failed').read_text()}")
                    if time.time() - t_wait > EP_WAIT_S:
                        raise SystemExit(f"rank {os.environ['RANK']}: {wait} did not appear in {EP_WAIT_S} s")
                    time.sleep(1.0)
            t_launch = time.time()
            marks = [a.removeprefix("--mark-done=") for a in args if a.startswith("--mark-done=")]
            args = [a for a in args if not a.startswith(("--routing=", "--wait-for=", "--mark-done="))]
            store, flips = [], []
            try:
                with contextlib.ExitStack() as stack, contextlib.redirect_stdout(buf):
                    for mode, path, *span in hooks:
                        lo, hi = map(int, span) if span else (0, None)
                        pin = torch.load(path)[lo:hi] if mode == "pin" else None
                        stack.enter_context(routing(store, pin=None if pin is None else [(sel,) for sel in pin],
                                                    flips=flips))
                    result = launch.main(args)
            finally:
                sys.stdout.write(buf.getvalue())
            for mode, path, *_ in hooks:
                if mode == "record":  # published whole: a waiting group reads it once it exists
                    torch.save([sel.cpu() for sel, _ in store], f"{path}.tmp")
                    os.replace(f"{path}.tmp", path)
            del store
            torch.cuda.synchronize()
            after = counts()
            state = [*result["params"].values(), *result["opt_state"].mu.values(), *result["opt_state"].nu.values()]
            reports.append({
                "records": [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith('{"step"')],
                "launches": {k: sorted((after[k] - before[k]).items()) for k in after},
                "traffic": dict(traffic() - moved_before),
                "stash": pipeline.STASH["high_water"],
                "schedule_peak": sched["peak"],
                "init": inits[0] if inits else None,
                "peak": max(sched["outer"], torch.cuda.max_memory_allocated()),
                "state_bytes": sum(t.numel() * t.element_size() for t in state),
                "bank_bytes": sum(t.numel() * t.element_size() for tree in (result["params"], result["opt_state"].mu,
                                                                            result["opt_state"].nu)
                                  for k, t in tree.items() if "experts" in k),
                "routing_flips": flips,
                "clock": {"enter": t_enter, "launch": t_launch, "done": time.time()},
            })
            del result, state
            free_memory()
            for path in marks:  # each rank writes it whole; any rank's copy says the launch is done
                Path(f"{path}.{os.environ['RANK']}.tmp").write_text(str(time.time()))
                os.replace(f"{path}.{os.environ['RANK']}.tmp", path)
    except BaseException:
        # the parent prints this after torchrun's summary; a group waiting for a record this rank would have
        # written (`--wait-for`) fails at once with it
        import traceback

        err = (f"launch {len(reports) + 1} of {len(runs)}, {time.time() - T_START:.1f} s after this rank started:\n"
               f"{traceback.format_exc()}")
        Path(f"{out}.{os.environ['RANK']}.err").write_text(err)
        for args in runs[len(reports):]:
            for a in args:
                if a.startswith(("--routing=record:", "--mark-done=")):
                    path = a.split(":")[1] if a.startswith("--routing=") else a.removeprefix("--mark-done=")
                    Path(f"{path}.failed").write_text(f"rank {os.environ['RANK']} of its group, {err}")
        raise
    finally:
        dist.shutdown()
    Path(f"{out}.{os.environ['RANK']}.json").write_text(json.dumps(reports))
    return 0


def torchrun(label: str, nproc: int, launches, card: str, backend: tp.Optional[str] = None, timeout: float = 600,
             nice: int = 0):
    """`launch --multihost` on `nproc` ranks started by torch.distributed.run
    --standalone (at `nice`), each a `chip_smoke.py --rank17` process
    running the argument lists of `launches` in turn in one process group;
    any rank's failure fails the phase (`label` names it: "17a ...").
    Returns the reports as [launch][rank]."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "report"
        runs = [a for i, args in enumerate(launches)
                for a in (["--then"] if i else []) + ["--multihost", *(["--backend", backend] if backend else []),
                                                      *args]]
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}",
                str(ROOT / "chip_smoke.py"), "--rank17", str(out), *runs]
        t0 = time.time()
        p = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                           preexec_fn=(lambda: os.nice(nice)) if nice else None)
        t1 = time.time()
        if p.returncode != 0:  # the ranks' own errors and the phase's name last: a reader of the tail sees them
            for a in (a for args in launches for a in args):  # a group waiting on this one fails now, not in 600 s
                path = (a.split(":")[1] if a.startswith("--routing=record:")
                        else a.removeprefix("--mark-done=") if a.startswith("--mark-done=") else None)
                if path and not Path(path).exists() and not Path(f"{path}.failed").exists():
                    Path(f"{path}.failed").write_text(f"phase {label}: torchrun exit {p.returncode}")
            errs = [(r, Path(f"{out}.{r}.err")) for r in range(nproc)]
            raise SystemExit(f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}" + "".join(
                f"\n--- rank {r} of phase {label}: ---\n{e.read_text()[-2500:]}" for r, e in errs if e.exists())
                + f"\nphase {label}: torchrun exit {p.returncode} after {t1 - t0:.1f} s, started "
                f"{t0 - T_START:.1f} s into the script")
        said = [line for line in p.stdout.splitlines() if " rank(s), backend " in line]
        by_rank = [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(nproc)]
        enter = max(reps[0]["clock"]["enter"] for reps in by_rank)
        spans = [max(reps[i]["clock"]["done"] - reps[i]["clock"]["launch"] for reps in by_rank)
                 for i in range(len(launches))]
        at = [(min(reps[i]["clock"]["launch"] for reps in by_rank) - T_START,
               max(reps[i]["clock"]["done"] for reps in by_rank) - T_START) for i in range(len(launches))]
        print(f"phase {label}: {nproc} rank(s) in {t1 - t0:.1f} s on {card} (host clock: start-up to the ranks' "
              f"entry {enter - t0:.1f} s, launches {', '.join(f'{x:.1f}' for x in spans)} s, exit "
              f"{t1 - max(reps[-1]['clock']['done'] for reps in by_rank):.1f} s; launches at "
              f"{', '.join(f'{a:.0f}-{b:.0f}' for a, b in at)} s of the script); {said[0] if said else ''}")
        return [[reps[i] for reps in by_rank] for i in range(len(launches))]


def rank_flash(reports) -> tp.Dict[str, collections.Counter]:
    """The ranks' flash launches summed, {kernel: Counter(variant: n)}."""
    out = {k: collections.Counter() for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for rep in reports:
        for k, c in out.items():
            c.update(dict(rep["launches"][k]))
    return out


def per_rank_flash_check(label, reports, n_layer, micro, evals, exact=False):
    """Each rank: n_layer backward launches per microstep, and at least
    n_layer forward launches per microstep and eval batch (a remat policy
    may relaunch the forward in the recompute; `exact`: no more). `label`
    names the phase ("17a ...")."""
    for r, rep in enumerate(reports):
        got = rank_flash([rep])
        totals = {k: sum(c.values()) for k, c in got.items()}
        fwd = n_layer * (micro + evals)
        if (totals["flash_bwd_dq"] != n_layer * micro or totals["flash_bwd_dkv"] != n_layer * micro
                or totals["flash_fwd"] < fwd or (exact and totals["flash_fwd"] != fwd)):
            raise SystemExit(f"phase {label}: rank {r} flash launches {dict(got)}, want n_layer {n_layer} x "
                             f"{micro} microsteps (+ {evals} eval batches for the forward)")


def step_losses(records):
    return [r["loss/optimized"] for r in records if "loss/optimized" in r]


def run_losses(records):
    """Each step's loss, then the final eval's."""
    return step_losses(records) + [r["loss/val_final"] for r in records if "loss/val_final" in r]


def max_rel(got, want) -> float:
    if len(got) != len(want):
        return float("inf")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def restore_state(rundir: Path, step: int, cfg, device: str = "cuda") -> dict:
    """A run's checkpointed state at `step`, read into `cfg`'s template on
    `device` without re-hashing it: the run verified its save (the
    restores the launcher makes verify theirs)."""
    from midgpt_tpu_torch.training.checkpoint import unflatten_item
    from midgpt_tpu_torch.training.train import state_template

    out = {}
    for name, like in state_template(cfg).items():
        with np.load(Path(rundir, str(step), f"{name}.npz")) as f:
            out[name] = unflatten_item({k: f[k] for k in f.files}, like, device, None)
    return out


def state_errors(got: dict, want: dict, param_tol: float) -> tp.Dict[str, tp.Any]:
    """Largest |got - want| of two checkpointed states by kind ("params",
    "mu", "nu"), and "ok": equal step counts, the params within
    `param_tol`, the moments within STATE_TOL."""
    og, ow = got["opt_state"], want["opt_state"]
    out = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for k, p in want["params"].items():
        for key, a, b in (("params", got["params"][k], p), ("mu", og.mu[k], ow.mu[k]), ("nu", og.nu[k], ow.nu[k])):
            out[key] = max(out[key], (a - b).abs().max().item())
    out["ok"] = ((og.adam_count, og.schedule_count) == (ow.adam_count, ow.schedule_count)
                 and out["params"] <= param_tol and all(out[k] <= STATE_TOL[k] for k in STATE_TOL))
    return out


def param_tol(cfg) -> float:
    """STATE_TOL's bound on the weights of a run of `cfg` warmed up in one
    step (lr 0 at step 0)."""
    return PARAM_TOL_LR * cfg.learning_rate * (cfg.max_steps - 1)


def moved(a: dict, b: dict) -> float:
    """Largest |a - b| over two states' parameters."""
    return max((a["params"][k] - b["params"][k]).abs().max().item() for k in a["params"])


def fmt_errors(e: dict, tol: float) -> str:
    return (", ".join(f"{k} {e[k]:.2e}" for k in ("params", "mu", "nu"))
            + f" (tol params {tol:.2e}, mu {STATE_TOL['mu']:g}, nu {STATE_TOL['nu']:g})")


def data_parallel(data_dir: Path, card: str, main_losses, xl_single, keep: Path, then_a=(),
                  xl_done: tp.Optional[Path] = None):
    """Phase 17 (run after phase 11c: it holds phase 6's and 11c's runs).
    17a and 17c's chaos_train run beside 17b: their ranks share the card
    and the host, which the phase's times include. Returns the ranks'
    flash launches by head dim, the f32 pair's one-rank run (its losses,
    and its run directory, moved to `keep`: phase 19 holds its
    tensor-parallel runs to it), and the reports ([run][rank]) of the
    launches `then_a`, which 17a's one rank runs after its own (phase
    22b's one device); 17b's openwebtext_xl waits for the record of
    then_a's last launch, and writes `xl_done` once its ranks are done."""
    from concurrent.futures import ThreadPoolExecutor

    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.launch import apply_overrides
    from midgpt_tpu_torch.models.gpt import param_shapes
    from midgpt_tpu_torch.robustness.chaos_train import PARITY_RTOL

    def cut(preset, over):
        return apply_overrides(load_config(preset), [(k, str(v)) for k, v in over.items()])

    t_phase = time.perf_counter()
    flash = {64: {}, 128: {}}

    def add(C, reports):
        for k, c in rank_flash(reports).items():
            flash[C].setdefault(k, collections.Counter()).update(c)

    mc = load_config("local_text_124m").model_config
    micro, evals = TRAIN_CUTS["g_accum_iters"] * TRAIN_CUTS["max_steps"], 3
    chaos_dir = Path(tempfile.mkdtemp())
    rundir = chaos_dir / "run"
    # 17c: the elastic resume through chaos_train, started first
    with open(chaos_dir / "out", "w") as out, open(chaos_dir / "err", "w") as err:
        chaos = subprocess.Popen([sys.executable, "-m", "midgpt_tpu_torch.robustness.chaos_train",
                                  "--config=local_text_124m", f"--rundir={rundir}", "--nproc", "2", "--backend", "gloo",
                                  *[a for f in CHAOS_FAULTS for a in ("--fault", f)],
                                  *sets({"data_dir": data_dir, "log_interval": 1, **CHAOS_CUTS})],
                                 cwd=ROOT, stdout=out, stderr=err)
    try:
        pair_sets = {"data_dir": data_dir, "log_interval": 1, **TRAIN_CUTS, **PAIR_SETS}
        pair_cfg = cut("local_text_124m", pair_sets)
        pair_dirs = {n: chaos_dir / f"pair{n}" for n in (1, 2)}
        pair_args = {n: ["--config=local_text_124m", f"--rundir={d}", *sets(pair_sets)] for n, d in pair_dirs.items()}
        # xl (~20 GiB a rank) starts once 17a's last launch (22b's one device, ~16 GiB) has written its record, so
        # that the two never share the card beside 17c, 18's ranks and the decode lane
        gate = [a.replace("--routing=record:", "--wait-for=") for a in (then_a[-1] if then_a else [])
                if a.startswith("--routing=record:")]
        xl_args = [*gate, *([f"--mark-done={xl_done}"] if xl_done else []), "--config=openwebtext_xl", "--rundir=",
                   *sets({"data_dir": data_dir, "log_interval": 1, **REMAT_CUTS, "batch_size": XL_BATCH})]
        with ThreadPoolExecutor(1) as pool:
            # 17a: one rank over NCCL, phase 6's run (no saves: the losses are the run's), then the f32 pair's
            # one-rank run (fsdp clamps to 1), beside 17b
            a_reports = pool.submit(torchrun, "17a (phase 6's run, then the f32 pair's one rank"
                                    + (", then phase 22b's one device)" if then_a else ")"), 1, [
                ["--config=local_text_124m", "--rundir=", *sets({"data_dir": data_dir, "log_interval": 1, **TRAIN_CUTS})],
                pair_args[1], *then_a], card)
            # 17b: two ranks sharing the card over gloo (NCCL refuses two ranks of one communicator on one card)
            print("phase 17b: backend gloo on CUDA tensors, named explicitly: NCCL refuses two ranks of one "
                  "communicator on one card; gloo all-gathers, reduce-scatters and all-reduces the CUDA tensors as "
                  "they are")
            pair, xl_reports = torchrun("17b (the f32 pair, then openwebtext_xl)", 2, [pair_args[2], xl_args], card,
                                        backend="gloo")
            reports, one, *later_a = a_reports.result()
        losses = step_losses(reports[0]["records"])
        print(f"phase 17a: one NCCL rank, local_text_124m on phase 6's cuts: losses {losses} vs phase 6's single-device "
              f"{main_losses}: {'bit for bit' if losses == main_losses else 'DIFFER'} on {card}")
        if losses != main_losses:
            raise SystemExit("phase 17a: one rank over NCCL is not the single-device launcher bit for bit")
        per_rank_flash_check("17a", reports, mc.n_layer, micro, evals)
        add(64, reports)
        one_losses, two_losses = run_losses(one[0]["records"]), run_losses(pair[0]["records"])
        err = max_rel(two_losses, one_losses)
        last = TRAIN_CUTS["max_steps"] - 1
        tol = param_tol(pair_cfg)
        want = restore_state(pair_dirs[1], last, pair_cfg)
        errs = state_errors(restore_state(pair_dirs[2], last, pair_cfg), want, tol)
        travel = moved(want, restore_state(pair_dirs[1], 0, pair_cfg))
        print(f"phase 17b f32 pair (2 layers of {mc.n_embd}, fsdp 2, attn_block_size 512, warmup 1 step): losses "
              f"(steps, final eval) 2 ranks {two_losses} vs 1 rank {one_losses}: max rel err {err:.2e} (tol "
              f"{PAIR_TOL:g}); step {last} states, max |2 ranks - 1 rank|: {fmt_errors(errs, tol)}; the params "
              f"moved up to {travel:.2e} since step 0 on {card}")
        if err > PAIR_TOL or not errs["ok"]:
            raise SystemExit("phase 17b: the f32 2-rank run disagrees with the one-rank run")
        if travel < 10 * tol:
            raise SystemExit("phase 17b: the f32 pair's params barely moved: its state check cannot see a wrong update")
        shutil.move(str(pair_dirs[1]), str(keep))
        per_rank_flash_check("17b f32 pair", one + pair, 2, micro, evals)
        add(64, one + pair)
        xl = load_config("openwebtext_xl")
        xl_losses, xl_peak = xl_single
        losses = step_losses(xl_reports[0]["records"])
        err = max_rel(losses, xl_losses)
        full_state = 3 * 4 * sum(int(np.prod(s)) for s in param_shapes(xl.model_config).values())
        print(f"phase 17b openwebtext_xl ({xl.model_config.n_layer} x {xl.model_config.n_embd}; fsdp {xl.mesh.fsdp} "
              f"clamps to 2), batch {XL_BATCH} over 2 ranks, bf16 over f32: losses {losses} vs phase 11c's single "
              f"device {xl_losses}: max rel err {err:.2e} (tol {XL_DP_TOL:g}); peak memory per rank "
              f"{[gib(rep['peak']) for rep in xl_reports]} vs the single device's {gib(xl_peak)}; master weights and "
              f"moments per rank {[gib(rep['state_bytes']) for rep in xl_reports]} of {gib(full_state)} whole on {card}")
        if err > XL_DP_TOL:
            raise SystemExit("phase 17b: openwebtext_xl on 2 ranks disagrees with the single device")
        if any(rep["state_bytes"] > 0.51 * full_state for rep in xl_reports):
            raise SystemExit("phase 17b: a rank holds more than half of the master weights and moments")
        # the init, sharded at birth: a rank's peak is its shards and one drawn piece at most
        inits = [rep["init"] for rep in xl_reports]
        if any(i is None for i in inits):
            raise SystemExit("phase 17b: openwebtext_xl's ranks did not report their init")
        print(f"phase 17b openwebtext_xl init, sharded at birth: peak per rank {[gib(i['peak']) for i in inits]} vs "
              f"its shards (weights and moments) {[gib(i['state_bytes']) for i in inits]} + one drawn piece "
              f"{gib(inits[0]['piece'])} (the f32 embedding); the dense init held the whole weights "
              f"{gib(inits[0]['dense'])} beside a rank's shard of them {gib(inits[0]['state_bytes'] // 3)} at once on "
              f"{card}")
        if any(i["peak"] > i["state_bytes"] + i["piece"] for i in inits):
            raise SystemExit("phase 17b: a rank's init peaked above its shards and one drawn piece")
        per_rank_flash_check("17b openwebtext_xl", xl_reports, xl.model_config.n_layer, REMAT_CUTS["max_steps"], evals)
        add(128, xl_reports)
        # 17c's verdict
        chaos.wait(timeout=900)
        said = (chaos_dir / "out").read_text().strip().splitlines()
        if chaos.returncode != 0 or not said:
            raise SystemExit(f"phase 17c: chaos_train exit {chaos.returncode}\n{(chaos_dir / 'err').read_text()[-4000:]}")
        rec = json.loads(said[-1])
        history = [m["n_devices"] for m in rec["supervisor"]["mesh_history"]]
        ref_dir = Path(f"{rundir}_ref")
        (got, _), (want, _) = logged(rundir), logged(ref_dir)
        err = max(abs(got[s] - want[s]) / abs(want[s]) for s in want)
        chaos_cfg = cut("local_text_124m", CHAOS_CUTS)
        last = CHAOS_CUTS["max_steps"] - 1
        errs = state_errors(restore_state(rundir, last, chaos_cfg), restore_state(ref_dir, last, chaos_cfg),
                            param_tol(chaos_cfg))
        tol = PARITY_RTOL[chaos_cfg.compute_dtype]
        print(f"phase 17c: chaos_train {' '.join(CHAOS_FAULTS)} on 2 ranks (2 layers of {mc.n_embd}, f32, warmup 1 "
              f"step; beside 17a and 17b) in {rec['wall_s']} s: mesh_history {history}, restarts {rec['restarts']}, "
              f"detected at {rec['detected_at_ms']} ms, loss_final {rec['loss_final']} vs the uninterrupted 1-rank "
              f"run's {rec['loss_ref']}, loss_parity {rec['loss_parity']}; per-step losses "
              f"{[round(got[s], 6) for s in sorted(got)]} vs {[round(want[s], 6) for s in sorted(want)]}: max rel err "
              f"{err:.2e} (tol {tol:g}); step {last} states, max |resumed - uninterrupted|: "
              f"{fmt_errors(errs, param_tol(chaos_cfg))} on {card}")
        if (history != [2, 1] or not rec["loss_parity"] or sorted(got) != sorted(want) or err > tol
                or not errs["ok"]):
            raise SystemExit(f"phase 17c: the elastic resume failed: {rec}")
    finally:
        if chaos.poll() is None:
            chaos.kill()
            chaos.wait()
        shutil.rmtree(chaos_dir, ignore_errors=True)  # the run and its reference
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s; flash launches in its ranks by head dim: "
          + "; ".join(f"C {C}: {({k: dict(c) for k, c in v.items()})}" for C, v in flash.items()) + f" on {card}")
    return flash, one_losses, later_a


# ---------------------------------------------------------------- phase 18: tensor-parallel serving

EARLIER_SMOKE_PHASE18_S = 1101.7  # this script's wall time before phase 18 was added (PERF.md, section 6)
TP = 2
# each collective of phase 18's meshes: a rank that stops answering raises there (ranks 2 and 3 wait in
# 18c's first broadcast while 18a and 18b run on ranks 0 and 1)
TP_TIMEOUT_S = 600
# f32 logits through a rank's shard against the whole weights on the same card, max |diff| / max |logit|
TP_LOGIT_RTOL = 1e-5
# 18d: loadgen --tp 2's entry point at GPT-2 small's width, its depth cut to 2 layers and its context to 256
# (the warm-up serves a solo request per page bucket and decode tail), one low rate
TP_LOADGEN_ARGS = ["--tp=2", "--backend=gloo", "--process=poisson", "--n-requests=4", "--rates=2",
                   "--max-slots=4", "--num-pages=129", "--page-size=8", "--prefill-chunk=64", "--decode-chunk=8",
                   "--block-size=256", "--vocab-size=50304", "--n-layer=2", "--n-head=12", "--n-embd=768", "--seed=0"]


def rank18_main(argv) -> int:
    """One rank of phase 18 under torchrun (4 ranks sharing the card over
    gloo): runs 18a-18d and writes this rank's report to
    <argv[0]>.<RANK>.json for the parent."""
    t_enter = time.time()
    # these ranks run beside phase 17, whose chain of launches is the script's critical path there: they yield
    # the host's cores to it (this process's own priority; its time is not a measurement)
    os.nice(10)
    out = argv[0]
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from midgpt_tpu_torch.parallel import dist

    dev = dist.init(None, "gloo")  # NCCL refuses two ranks of one communicator on one card
    report: tp.Dict[str, tp.Any] = {}
    try:
        tp_rank_jobs(dev, report)
        torch.distributed.barrier()
    finally:
        report["clock"] = {"enter": t_enter, "done": time.time()}
        Path(f"{out}.{os.environ['RANK']}.json").write_text(json.dumps(report))
        dist.shutdown()
    return 0


def tp_rank_jobs(dev, report) -> None:
    """18a-18d on this rank (rank18_main): 18a on ranks 0-1 beside 18b on
    ranks 2-3, then 18c on all 4, then 18d on ranks 0-1. Every paged run's
    counts are zeroed just before it and read just after, in this process."""
    from midgpt_tpu_torch import loadgen
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.kernels.decode_attention import paged_attention
    from midgpt_tpu_torch.models.gpt import GPT, PagedKVCache
    from midgpt_tpu_torch.parallel.serve_tp import make_serve_mesh
    from midgpt_tpu_torch.sampling.disagg import DisaggServe
    from midgpt_tpu_torch.sampling.serve import ServeEngine
    from midgpt_tpu_torch.utils.precision import cast_floating

    cfg = load_config("openwebtext").model_config
    L = cfg.n_layer
    # every rank of the process group builds every mesh (collective): two rows of 2, then both as one mesh
    row_a = make_serve_mesh(TP, device=dev, timeout_s=TP_TIMEOUT_S)
    row_b = make_serve_mesh(TP, ranks=[2, 3], device=dev, timeout_s=TP_TIMEOUT_S)
    mesh4 = make_serve_mesh(TP, data=2, device=dev, timeout_s=TP_TIMEOUT_S)
    params32 = GPT.init(cfg, 0, device=dev)  # the whole weights on every rank; an engine keeps its shard
    params16 = cast_floating(params32, torch.bfloat16)
    reqs = trace(cfg.vocab_size)
    engine_kw = dict(max_slots=4, page_size=PAGE, prefill_chunk=256, decode_chunk=8, temperature=0.0, device=dev)

    def counted():
        return collections.Counter(tpl.LAUNCHES.by_variant), tpl.MERGE_LAUNCHES.count

    def tp_run(label, mesh, params, dtype, **kw):
        """The trace on a tp engine over `mesh`: the leader serves, the
        follower follows; each rank's launches, pool and memory."""
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(cfg, params, cache_dtype=dtype, mesh=mesh, **engine_kw, **kw)
        t0 = time.perf_counter()
        if mesh.is_leader:
            streams, _ = serve_trace(eng)
            eng.stop_followers()
        else:
            done = eng.follow()
            streams = [done[u].tokens for u in sorted(done)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, merges = counted()
        st = eng.stats()
        if eng.allocator.free_count != eng.allocator.num_pages - 1:
            raise SystemExit(f"{label}: rank {mesh.index}'s pages did not drain back to its free list")
        if st["spec"] is None:
            check_launches(f"{label} rank {mesh.index}", L, st["decode_steps"])
        else:
            spec_launches(f"{label} rank {mesh.index}", st, launches, L, eng.cache.quantized)
        report[label] = {"streams": [s.tolist() for s in streams], "wall": wall, "merges": merges,
                         "launches": [[list(k), n] for k, n in launches.items()], "decode_steps": st["decode_steps"],
                         "spec": st["spec"], "mesh": st["mesh"], "per_shard": st["cache_hbm_bytes_per_shard"],
                         "total": st["cache_hbm_bytes"], "pool": list(eng.cache.k.shape),
                         "peak": torch.cuda.max_memory_allocated()}
        return eng

    if row_a.member:
        # 18a: f32 at full width and depth, the paged kernel on each rank's 6 heads
        eng = tp_run("18a f32", row_a, params32, torch.float32)
        # f32 kernel == gather on this rank's shard: a decode call over its pool's layer 0 (6 heads)
        g = torch.Generator().manual_seed(18 + row_a.index)
        kp, vp = eng.cache.k[0], eng.cache.v[0]
        pages = (torch.randperm(kp.shape[1] - 2, generator=g)[:64] + 1).to(torch.int32).reshape(4, 16).to(dev)
        q = torch.randn(4, kp.shape[0], cfg.head_dim, generator=g).to(dev)
        counts = torch.tensor([128, 100, 37, 1], dtype=torch.int32, device=dev)
        errs = {}
        for s in (1, 2):
            got = paged_attention(q, kp, vp, pages, counts, impl="kernel", split_k=s)
            want = paged_attention(q, kp, vp, pages, counts, impl="gather", split_k=s)
            errs[s] = (got - want).abs().max().item()
            if not torch.allclose(got, want, atol=TOL[torch.float32], rtol=TOL[torch.float32]):
                raise SystemExit(f"18a: rank {row_a.index}'s f32 kernel disagrees with the gather on its shard "
                                 f"(split {s}: {errs[s]:.3e})")
        report["18a kernel_vs_gather"] = {"err": errs, "heads": kp.shape[0]}
        # the prefill logits of the first request through this rank's shard against the whole weights
        tok = torch.as_tensor(reqs[0][0][None], device=dev).long()
        table = torch.arange(1, 5, dtype=torch.int32, device=dev)[None]
        shard_pool = PagedKVCache.init(cfg, 5, PAGE, torch.float32, device=dev, tp_size=TP)
        whole_pool = PagedKVCache.init(cfg, 5, PAGE, torch.float32, device=dev)
        n = tok.shape[1]
        got, _ = GPT.prefill_paged_chunk(cfg, eng.params, tok, 0, n, shard_pool, table, tp_shard=eng._tp)
        want, _ = GPT.prefill_paged_chunk(cfg, params32, tok, 0, n, whole_pool, table)
        report["18a logit_err"] = ((got - want).abs().max() / want.abs().max()).item()
        del eng, shard_pool, whole_pool
    else:
        # 18b, beside 18a: the bf16 pool, a self-draft round, the int8 pool (bf16 queries: the kernels line's specs)
        tp_run("18b bf16", row_b, params16, torch.bfloat16)
        tp_run("18b bf16 self-draft", row_b, params16, torch.bfloat16, **spec_engine_kw(cfg, params16))
        tp_run("18b int8", row_b, params16, torch.int8)
        if row_b.is_leader:  # the single-device int8 engine on the same card (the follower waits in 18c's mesh)
            ref = ServeEngine(cfg, params16, cache_dtype=torch.int8, **engine_kw)
            report["18b int8 single device"] = [s.tolist() for s in serve_trace(ref)[0]]
            del ref
    free_memory()

    # 18c: DisaggServe on (data 2, tp 2) over the 4 ranks: row 0 prefills, row 1 decodes
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    dis = DisaggServe(cfg, params32, mesh=mesh4, cache_dtype=torch.float32, **engine_kw)
    if mesh4.is_leader:
        uids = [dis.submit(p, m) for p, m in reqs]
        done = dis.run()
        dis.stop_followers()
        st = dis.stats()
        report["18c"] = {"streams": [done[u].tokens.tolist() for u in uids], "queue": st["queue"],
                         "fallback": st["fallback_reprefills"], "meshes": [st["prefill"]["mesh"], st["decode"]["mesh"]],
                         "statuses": [done[u].status for u in uids]}
    else:
        dis.follow()
    torch.cuda.synchronize()
    role = dis.prefill if dis.prefill is not None else dis.decode
    launches, merges = counted()
    report["18c launches"] = {"role": "prefill" if dis.prefill is not None else "decode",
                              "launches": [[list(k), n] for k, n in launches.items()], "merges": merges,
                              "decode_steps": role.stats()["decode_steps"], "per_shard": role.cache_hbm_bytes_per_shard(), "peak": torch.cuda.max_memory_allocated()}
    del dis, role
    free_memory()

    # 18d: loadgen --tp 2 on every rank (ranks 2 and 3 are outside its mesh and return at once)
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = loadgen.main(TP_LOADGEN_ARGS)
    launches, merges = counted()
    report["18d"] = {"rc": rc, "stdout": buf.getvalue(), "wall": time.perf_counter() - t0,
                     "launches": [[list(k), n] for k, n in launches.items()], "merges": merges}


def start_tp_ranks(tmp: Path) -> tp.Tuple[subprocess.Popen, Path]:
    """Phase 18's 4 ranks under torch.distributed.run, started in the
    background (they run beside phase 17's); returns the process and the
    reports' stem (the host clock at the start is the stem's parent's
    `started` file)."""
    (tmp / "started").write_text(repr(time.time()))
    out = tmp / "tp_report"
    log = open(tmp / "tp_log", "w")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=4",
            str(ROOT / "chip_smoke.py"), "--rank18", str(out)]
    return subprocess.Popen(argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True), out


def tp_serving(card: str, proc: subprocess.Popen, out: Path, ref32, ref16):
    """Phase 18's verdicts from its ranks' reports (the parent's f32 and
    bf16 references are phase 5's and phase 4b's single-device streams on
    phase 4's trace). Returns the ranks' paged launches that join the
    kernels line: {(spec, split): n} over bf16 queries, merges under
    ("merge", None)."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.utils.precision import cast_floating

    try:
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t0 = float((out.parent / "started").read_text())
    log = (out.parent / "tp_log").read_text()
    if proc.returncode != 0:
        raise SystemExit(f"phase 18: torchrun exit {proc.returncode}\n{log[-6000:]}")
    ranks = [json.loads(Path(f"{out}.{r}.json").read_text()) for r in range(4)]
    enter = max(r["clock"]["enter"] for r in ranks) - t0
    done = max(r["clock"]["done"] for r in ranks) - t0
    cfg = load_config("openwebtext").model_config
    L = cfg.n_layer
    params32 = GPT.init(cfg, 0, device="cuda")  # for the top-2 gaps of a departure
    params16 = cast_floating(params32, torch.bfloat16)
    print(f"phase 18: tensor-parallel serving, openwebtext ({L} x {cfg.n_embd}, {cfg.n_head} heads -> "
          f"{cfg.n_head // TP} a rank), tp {TP} over gloo ranks sharing the card (NCCL refuses two ranks of one "
          f"communicator on one card; each all-reduce stages through the host, so no time here is a speed of "
          f"tensor parallelism); 18a on ranks 0-1 beside 18b on ranks 2-3; the 4 ranks entered {enter:.1f} s and finished "
          f"{done:.1f} s after their start (host clock), beside phase 17, on {card}")
    joined = collections.Counter()
    for label, row, ref, params, gap in (
            ("18a f32", (0, 1), ref32, params32, GAP_TOL),
            ("18b bf16", (2, 3), ref16, params16, GAP_TOL_BF16_RECHUNK),
            ("18b bf16 self-draft", (2, 3), ranks[2]["18b bf16"]["streams"], params16, GAP_TOL_BF16_RECHUNK),
            ("18b int8", (2, 3), ranks[2]["18b int8 single device"], params16, GAP_TOL_BF16_RECHUNK)):
        lead, follow = ranks[row[0]][label], ranks[row[1]][label]
        if lead["streams"] != follow["streams"]:
            raise SystemExit(f"phase {label}: the two ranks' streams differ")
        got = [np.asarray(s) for s in lead["streams"]]
        compare_streams(f"phase {label} tp {TP} vs one device", got, [np.asarray(s) for s in ref], cfg, params, gap)
        for r, rec in zip(row, (lead, follow)):
            launches = {tuple(k): n for k, n in rec["launches"]}
            print(f"phase {label} rank {r}: paged launches {launches}, merges {rec['merges']} ({L} layers x "
                  f"{rec['decode_steps']} decode steps{'' if rec['spec'] is None else ', plus the speculative rounds'}"
                  f"); pool {rec['pool']} (K/V heads {rec['pool'][1]} of {cfg.kv_heads}), per-shard pool bytes "
                  f"{rec['per_shard']:,} x {TP} == {rec['total']:,}, peak memory {gib(rec['peak'])}, {rec['wall']:.1f} "
                  f"s, mesh {rec['mesh']}")
            if rec["pool"][1] != cfg.kv_heads // TP or rec["per_shard"] * TP != rec["total"] or rec["mesh"] != {
                    "data": 1, "tp": TP}:
                raise SystemExit(f"phase {label}: rank {r}'s pool is not its shard of the heads")
            if label.startswith("18b"):
                for (spec, s), n in launches.items():
                    joined[(spec, s)] += n
                joined[("merge", None)] += rec["merges"]
    for r in (0, 1):
        kg = ranks[r]["18a kernel_vs_gather"]
        print(f"phase 18a rank {r}: f32 paged kernel == gather on its shard ({kg['heads']} heads): max_abs_err "
              + ", ".join(f"split {s} {e:.3e}" for s, e in kg["err"].items()) + f" (tol {TOL[torch.float32]:g})")
        err = ranks[r]["18a logit_err"]
        print(f"phase 18a rank {r}: f32 prefill logits through its shard vs the whole weights: max |diff| / max "
              f"|logit| {err:.3e} (tol {TP_LOGIT_RTOL:g}) on {card}")
        if err > TP_LOGIT_RTOL:
            raise SystemExit(f"phase 18a: rank {r}'s tp logits depart from the whole weights' by {err:.3e}")
    # 18c
    rec = ranks[0]["18c"]
    compare_streams("phase 18c disagg (data 2, tp 2) vs one device", [np.asarray(s) for s in rec["streams"]],
                    [np.asarray(s) for s in ref32], cfg, params32, GAP_TOL)
    print(f"phase 18c: DisaggServe on (data 2, tp 2): handoff {rec['queue']}, fallback re-prefills "
          f"{rec['fallback']}, role meshes {rec['meshes']}, statuses {sorted(set(rec['statuses']))}")
    if rec["queue"]["pages_copied"] < 1 or rec["fallback"] or rec["meshes"] != [{"data": 1, "tp": TP}] * 2:
        raise SystemExit("phase 18c: no page crossed between the rows, or a handoff re-prefilled")
    for r in range(4):
        c = ranks[r]["18c launches"]
        launches = {tuple(k): n for k, n in c["launches"]}
        want = L * c["decode_steps"]
        print(f"phase 18c rank {r} ({c['role']} row): paged launches {launches}, merges {c['merges']} == {L} "
              f"layers x {c['decode_steps']} decode steps; per-shard pool bytes {c['per_shard']:,}, peak memory "
              f"{gib(c['peak'])}")
        if sum(launches.values()) != want or c["merges"] != want or (c["role"] == "decode" and want < 1):
            raise SystemExit(f"phase 18c: rank {r}'s paged launches != n_layer x its decode steps")
    # 18d
    d = ranks[0]["18d"]
    line = json.loads(d["stdout"].strip().splitlines()[-1])
    steps = line["decode_steps"]
    for r in (0, 1):
        launches = {tuple(k): n for k, n in ranks[r]["18d"]["launches"]}
        if sum(launches.values()) != 2 * steps or ranks[r]["18d"]["merges"] != 2 * steps:
            raise SystemExit(f"phase 18d: rank {r}'s paged launches {launches} != 2 layers x {steps} decode steps")
        for k, n in launches.items():
            joined[k] += n
        joined[("merge", None)] += ranks[r]["18d"]["merges"]
    p = line["points"][0]
    print(f"phase 18d loadgen {' '.join(TP_LOADGEN_ARGS)} ({d['wall']:.1f} s): serve_slo tp {line['tp']}, mesh "
          f"{line['mesh']}, {p['completed']}/{p['n_offered']} completed at {p['offered_rps']:g} req/s, TTFT p50 "
          f"{p['ttft_p50_ms']} ms, TPOT p50 {p['tpot_p50_ms']} ms (gloo staging, not a speed of tp); paged launches "
          f"per rank == 2 layers x {steps} decode steps; ranks 2-3 printed {[ranks[r]['18d']['stdout'] for r in (2, 3)]}"
          f" on {card}")
    if line["mesh"] != {"data": 1, "tp": TP} or line["tp"] != TP or p["completed"] != p["n_offered"]:
        raise SystemExit(f"phase 18d: the serve_slo line {line}")
    print(f"phase 18 paged launches of its bf16-query runs (18b, 18d; they join the kernels line): {dict(joined)} on "
          f"{card}")
    return joined


# ---------------------------------------------------------------- phase 19: tensor-parallel training

EARLIER_SMOKE_PHASE19_S = 1027.9  # this script's wall time before phase 19 was added (PERF.md, section 6)
# 19a: 17b's f32 pair (2 layers of full width over attn_block_size 512, warmed up in one step, phase 6's other
# cuts) on a (data 1, tp 2) row: 6 heads and 25,152 vocab rows a rank, tp_vocab on and off; held to 17a's
# one-rank run of the pair at PAIR_TOL (losses) and STATE_TOL / PARAM_TOL_LR (the final states)
TP_PAIR_SETS = {**PAIR_SETS, "mesh.fsdp": 1, "mesh.tp": 2}
# 19c: the pair on (fsdp 2, tp 2) over 4 ranks, shard_model on, in both fsdp_modes; held to the same run.
# The gspmd run is straight. The shard_map run is resharded: steps 0-2 on (data 2, tp 2) (gspmd: with fsdp 1
# the modes are one), its final checkpoint (whole leaves) restored into the 2D (fsdp 2, tp 2) shards under
# shard_map for step 3 and the final eval, in the same process group: the one multi-rank restore on the card
# (the leader verifies, the verdict goes out through `agree`, each rank cuts its shard of every leaf)
TP_FSDP_SETS = {**PAIR_SETS, "mesh.fsdp": 2, "mesh.tp": 2, "shard_model": True}
TP_RESHARD_FIRST = {**TP_FSDP_SETS, "mesh.fsdp": 1, "fsdp_mode": "gspmd", "max_steps": TRAIN_CUTS["max_steps"] - 1}
# 19b: local_text_124m at full width and depth, bf16 over f32, microbatch 16, tp 2, on phase 6's cuts one
# step short, its final checkpoint (step 2) restored on one device, which trains phase 6's last step. Under
# the preset's warmup lr stays below 1e-5 over these steps, so the losses hold the forward: they and the
# restored run's next loss are held to phase 6's at TP_MAIN_TOL relative, ~10x the readings on an H100 80GB
# HBM3 at 700 W (8.34e-6 and 5.90e-7, PERF.md section 6). The backward shows in the moments: the restored
# run's step 3 mu and nu (0.9 x and 0.95 x what the tp steps accumulated) are held leaf by leaf to phase
# 6's at TP_MOMENT_RTOL of the leaf's norm, ~5x the readings (2.03e-2 and 1.57e-2, the same card); a
# doubled or a halved gradient in the tp steps moves them by ~0.3-0.7
TP_MAIN_CUTS = {**TRAIN_CUTS, "max_steps": TRAIN_CUTS["max_steps"] - 1, "mesh.fsdp": 1, "mesh.tp": 2}
TP_MAIN_TOL = 1e-4
TP_MOMENT_RTOL = 0.1


def tp_training_ranks(data_dir: Path, root: Path, card: str, after: subprocess.Popen, then=(),
                      wait: tp.Optional[Path] = None):
    """Phase 19's ranks, started once phase 18's have exited (beside phase
    17, at nice 10), their first launches held until `wait` exists (17b's
    xl done: 19's eight ranks peak at ~57 GiB together, xl's two at ~40),
    in three gloo groups side by side: 2 ranks run 19a's two runs and then
    the launches `then` (phase 22b's ep 2 run, once 19b's ranks are done:
    19a's group ends first, so it runs beside the least of 19), 2 more
    19b's, 4 more 19c's gspmd run and its resharded run's two legs.
    Returns ({"a": [run][rank], "b": [rank], "c": [run][rank], "then":
    [run][rank]} reports, the wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    after.wait(timeout=900)
    t0 = time.perf_counter()

    def args(name, over):
        return ["--config=local_text_124m", f"--rundir={root / name}",
                *sets({"data_dir": data_dir, "log_interval": 1, **over})]

    pair = {**TRAIN_CUTS, **TP_PAIR_SETS}
    a_runs = [args("a_tp_vocab", pair), args("a_tp_vocab_off", {**pair, "tp_vocab": False})]
    c_runs = [args("c_gspmd", {**TRAIN_CUTS, **TP_FSDP_SETS, "fsdp_mode": "gspmd"}),
              args("c_shard_map", {**TRAIN_CUTS, **TP_RESHARD_FIRST}),
              args("c_shard_map", {**TRAIN_CUTS, **TP_FSDP_SETS, "fsdp_mode": "shard_map"})]
    held, b_done = [f"--wait-for={wait}"] if wait else [], root / "b_done"
    a_runs[0], c_runs[0] = [*held, *a_runs[0]], [*held, *c_runs[0]]
    b_runs = [[*held, f"--mark-done={b_done}", *args("b", TP_MAIN_CUTS)]]
    then = [[f"--wait-for={b_done}", *t] for t in then]
    with ThreadPoolExecutor(2) as pool:
        c = pool.submit(torchrun, "19c (fsdp 2 x tp 2: gspmd; (data 2, tp 2) resharded into shard_map)", 4, c_runs,
                        card, "gloo", 600, 10)
        b = pool.submit(torchrun, "19b (tp 2: the main path)", 2, b_runs, card, "gloo", 600, 10)
        a = torchrun("19a (tp 2: the f32 pair, tp_vocab on and off" + (", then phase 22b's ep 2 run)" if then else ")"),
                     2, a_runs + then, card, "gloo", 600, 10)
        b, c = b.result()[0], c.result()
    return {"a": a[:len(a_runs)], "b": b, "c": c, "then": a[len(a_runs):]}, time.perf_counter() - t0


def n_evals(records) -> int:
    """The eval batches of a launch's logged records: the eval records'
    losses (a step's record repeats the last eval's)."""
    return sum(k in r for r in records if "loss/optimized" not in r
               for k in ("loss/train", "loss/val", "loss/val_final")) * TRAIN_CUTS["eval_steps"]


def moment_errors(got: dict, want: dict) -> tp.Dict[str, float]:
    """Largest ||got - want|| / ||want|| over the leaves of two
    checkpointed states' moments, by kind ("mu", "nu")."""
    og, ow = got["opt_state"], want["opt_state"]
    return {key: max(((getattr(og, key)[k] - b).norm() / b.norm().clamp_min(1e-30)).item()
                     for k, b in getattr(ow, key).items()) for key in ("mu", "nu")}


def tp_training(card: str, ranks, root: Path, pair_losses, main_losses, main_dir: Path):
    """Phase 19's verdicts from its ranks' reports (`ranks`:
    `tp_training_ranks`), then 19b's checkpoint restored on one device.
    `pair_losses` are 17a's one-rank run of the f32 pair (its directory
    root / "pair1"), `main_losses` phase 6's (its directory `main_dir`).
    Returns the ranks' flash launches, {kernel: Counter(variant: n)}."""
    from midgpt_tpu_torch import launch
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.launch import apply_overrides
    from midgpt_tpu_torch.models.gpt import param_shapes

    reports, wall = ranks
    t_phase = time.perf_counter()
    print("phase 19: tensor-parallel training on gloo ranks sharing the card (NCCL refuses two ranks of one "
          "communicator on one card): every all-reduce stages through the host, so no time here is a speed of "
          "tensor parallelism")
    mc = load_config("local_text_124m").model_config
    micro, evals = TRAIN_CUTS["g_accum_iters"] * TRAIN_CUTS["max_steps"], 3
    last = TRAIN_CUTS["max_steps"] - 1
    flash = {k: collections.Counter() for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    def add(reps):
        for k, c in rank_flash(reps).items():
            flash[k].update(c)

    pair_cfg = apply_overrides(load_config("local_text_124m"),
                               [(k, str(v)) for k, v in {**TRAIN_CUTS, **PAIR_SETS}.items()])
    tol = param_tol(pair_cfg)
    want = restore_state(root / "pair1", last, pair_cfg)
    reshard = "19c (data 2, tp 2) gspmd steps 0-2, resharded into (fsdp 2, tp 2) shard_map"
    runs = [("19a tp_vocab on", "a_tp_vocab", [reports["a"][0]]),
            ("19a tp_vocab off", "a_tp_vocab_off", [reports["a"][1]]),
            ("19c gspmd", "c_gspmd", [reports["c"][0]]), (reshard, "c_shard_map", reports["c"][1:])]
    for label, name, legs in runs:
        losses = [x for leg in legs[:-1] for x in step_losses(leg[0]["records"])] + run_losses(legs[-1][0]["records"])
        err = max_rel(losses, pair_losses)
        errs = state_errors(restore_state(root / name, last, pair_cfg), want, tol)
        resumed = [r["step"] for r in legs[-1][0]["records"] if "loss/optimized" in r] if len(legs) > 1 else None
        print(f"phase {label} ({len(legs[-1])} ranks, 2 layers of {mc.n_embd}, f32, warmup 1 step): losses (steps, "
              f"final eval) {losses} vs 17a's one rank {pair_losses}: max rel err {err:.2e} (tol {PAIR_TOL:g}); "
              + ("" if resumed is None else f"the resumed leg trained steps {resumed}; ")
              + f"step {last} states, max |tp - one rank|: {fmt_errors(errs, tol)}; peak memory per rank "
              f"{[gib(rep['peak']) for rep in legs[-1]]} on {card}")
        if err > PAIR_TOL or not errs["ok"] or resumed not in (None, [last]):
            raise SystemExit(f"phase {label}: the tensor-parallel run disagrees with the one-rank run")
        for i, leg in enumerate(legs):
            steps_i = sum("loss/optimized" in r for r in leg[0]["records"])
            per_rank_flash_check(f"{label} (launch {i + 1})", leg, 2, TRAIN_CUTS["g_accum_iters"] * steps_i,
                                 n_evals(leg[0]["records"]), exact=True)
            add(leg)
        shutil.rmtree(root / name)
    # 19b: the main path at full width and depth
    b = reports["b"]
    steps = TP_MAIN_CUTS["max_steps"]
    losses = step_losses(b[0]["records"])
    err = max_rel(losses, main_losses[:steps])
    full = 3 * 4 * sum(int(np.prod(sh)) for sh in param_shapes(mc).values())
    print(f"phase 19b local_text_124m ({mc.n_layer} x {mc.n_embd}, {mc.n_head // 2} heads and "
          f"{mc.vocab_size // 2:,} vocab rows a rank), bf16 over f32, microbatch 16, tp 2: losses {losses} vs phase "
          f"6's single device {main_losses[:steps]}: max rel err {err:.2e} (tol {TP_MAIN_TOL:g}); peak "
          f"memory per rank {[gib(rep['peak']) for rep in b]}; master weights and moments per rank "
          f"{[gib(rep['state_bytes']) for rep in b]} of {gib(full)} whole on {card}")
    if len(losses) != steps or not all(np.isfinite(losses)) or err > TP_MAIN_TOL:
        raise SystemExit("phase 19b: the tensor-parallel main path disagrees with phase 6's single device")
    if any(rep["state_bytes"] > 0.51 * full for rep in b):
        raise SystemExit("phase 19b: a rank holds more than half of the master weights and moments")
    per_rank_flash_check("19b", b, mc.n_layer, TRAIN_CUTS["g_accum_iters"] * steps, evals, exact=True)
    add(b)
    # its final checkpoint (whole leaves) restores on one device, which trains phase 6's last step
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.main(["--config=local_text_124m", f"--rundir={root / 'b'}",
                     *sets({"data_dir": root.parent, "log_interval": 1, **TRAIN_CUTS, "on_resume_mesh": "any"})])
    resumed = [line for line in buf.getvalue().splitlines() if line.startswith("resumed from checkpoint step")]
    records, _ = logged(root / "b")
    nxt = records.get(last)
    if not resumed or f"step {steps - 1} " not in resumed[0] or nxt is None:
        raise SystemExit(f"phase 19b: the tp checkpoint did not restore on one device ({resumed}, step {last}'s "
                         f"loss {nxt})")
    main_cfg = apply_overrides(load_config("local_text_124m"), [(k, str(v)) for k, v in TRAIN_CUTS.items()])
    got, ref = restore_state(root / "b", last, main_cfg), restore_state(main_dir, last, main_cfg)
    merr = moment_errors(got, ref)
    counts = (got["opt_state"].adam_count, got["opt_state"].schedule_count)
    same_counts = counts == (ref["opt_state"].adam_count, ref["opt_state"].schedule_count)
    del got, ref
    rel = abs(nxt - main_losses[last]) / main_losses[last]
    print(f"phase 19b restore on one device: {resumed[0]}; step {last}'s loss {nxt} vs phase 6's {main_losses[last]} "
          f"(rel err {rel:.2e}, tol {TP_MAIN_TOL:g}); step {last} moments, max over leaves ||restored - phase 6|| / "
          f"||phase 6||: mu {merr['mu']:.2e}, nu {merr['nu']:.2e} (tol {TP_MOMENT_RTOL:g}), step counts {counts} on "
          f"{card}")
    if rel > TP_MAIN_TOL or max(merr.values()) > TP_MOMENT_RTOL or not same_counts:
        raise SystemExit("phase 19b: the tp checkpoint did not restore on one device into phase 6's trajectory")
    shutil.rmtree(main_dir)
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 19 took {wall:.1f} s in its ranks (beside phase 17) and {time.perf_counter() - t_phase:.1f} s of "
          f"verdicts and 19b's restore; flash launches in its ranks: "
          f"{({k: dict(c) for k, c in flash.items()})} on {card}")
    return flash


# ---------------------------------------------------------------- phase 20: sequence-parallel training

EARLIER_SMOKE_PHASE20_S = 727.0  # this script's wall time before phase 20 was added (PERF.md, section 6)
# 20a: 17b's f32 pair (2 layers of full width, attn_block_size 512, warmed up in one step, phase 6's other cuts)
# with its sequence split over sp ranks: the ring and Ulysses on sp 2 (T 512 a rank: the ring's pairs the
# single-visit bodies, its off-diagonal pair causal=False) and sp 4 (T 256 a rank), held to 17a's one-rank flash
# run of the pair at PARITY_TOL's f32 bounds: each step's loss and the final eval's at "f32_loss" relative, the
# parameter update over the 4 steps at "f32_update" relative (update_rel_err)
SP_PAIR_SETS = {**PAIR_SETS, "mesh.fsdp": 1}
SP_SCHEDULES = ("ring", "ulysses")
SP_SIZES = (2, 4)
# 20b: llama7b_32k at its full width (n_embd 4096, 32 heads of 128, vocab 50,304, T 32,768) cut to 2 of its 32
# layers and batch 1, bf16 over f32, its remat ("dots": the backward recomputes each block's forward, the ring's
# hops included), warmed up in one step, 2 steps: the ring on sp 2 (T 16,384 a rank: its off-diagonal pair the
# tiled causal=False bodies) against one rank's flash run at T 32,768 on the same weights (the seed) and batch,
# every loss (the steps' and the evals') at LLAMA_SP_TOL relative: ~10x the reading on an H100 80GB HBM3 at
# 700 W (2.86e-6, the phase run alone, PERF.md section 6)
LLAMA_SP_CUTS = {"model_config.n_layer": 2, "batch_size": 1, "g_accum_iters": 1, "max_steps": 2, "eval_steps": 1,
                 "eval_interval": 1000, "spec_layers": 0, "warmup_steps": 1, "mesh.fsdp": 1}
LLAMA_SP_TOL = 2.5e-5


def sequence_parallel_ranks(data_dir: Path, root: Path, card: str, nice: int = 10, then=None):
    """Phase 20's ranks (gloo, sharing the card, at `nice`): 20b's one-rank
    flash run and its sp 2 ring run, one after the other (each holds a
    7B-width layer pair's state: ~24 and 2 x ~20 GiB); then 20a's sp 2 and
    sp 4 groups side by side, each running the ring and then Ulysses into
    root / "a_<schedule>_<sp>", and the launches of `then` ({"sp2": [...],
    "sp4": [...]}: phase 21's, with no start-up of their own): the sp 4
    group's before its own (its f32 4-rank runs then sit beside the sp 2
    group's ring, not beside phase 21's 2-rank runs, which follow the sp 2
    group's own). Returns ({"a": {sp: [run][rank]}, "b": (one rank's
    reports, the sp 2 ranks'), "then": {"sp2": [run][rank], "sp4":
    [run][rank]}}, the wall seconds). `then["one"]` (phase 22's one-rank
    reference) runs after 20b's one rank, in its process, before the
    groups: their runs pin its routing; its reports come back as
    "then"["one"]."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    then = then or {}

    def pair(n, schedule):
        over = {"data_dir": data_dir, "log_interval": 1, **TRAIN_CUTS, **SP_PAIR_SETS, "mesh.sp": n,
                "model_config.attn_impl": schedule}
        return ["--config=local_text_124m", f"--rundir={root / f'a_{schedule}_{n}'}", *sets(over)]

    def llama(n, impl):
        over = {"data_dir": data_dir, "log_interval": 1, **LLAMA_SP_CUTS, "mesh.sp": n, "model_config.attn_impl": impl}
        return ["--config=llama7b_32k", "--rundir=", *sets(over)]

    ones = torchrun("20b one rank (flash at T 32,768)" + (", then phase 22's one-rank reference" if then.get("one")
                                                           else ""), 1, [llama(1, "flash")] + then.get("one", []),
                    card, None, 600, nice)
    one = ones[0]
    two = torchrun("20b sp 2 (the ring at T 16,384 a rank)", 2, [llama(2, "ring")], card, "gloo", 600, nice)[0]
    with ThreadPoolExecutor(1) as pool:
        lead = then.get("sp4", [])
        wide = pool.submit(torchrun, ("phase 21's 4-rank runs, then " if lead else "") + "20a sp 4 (the ring, then Ulysses)",
                           4, lead + [pair(4, s) for s in SP_SCHEDULES], card, "gloo", 600, nice)
        two_runs = torchrun("20a sp 2 (the ring, then Ulysses)" + (", then phase 21's 2-rank runs" if then.get("sp2") else ""),
                            2, [pair(2, s) for s in SP_SCHEDULES] + then.get("sp2", []), card, "gloo", 600, nice)
        four_runs = wide.result()
    k = len(SP_SCHEDULES)
    return ({"a": {2: two_runs[:k], 4: four_runs[len(lead):]}, "b": (one, two),
             "then": {"sp2": two_runs[k:], "sp4": four_runs[:len(lead)], "one": ones[1:]}}, time.perf_counter() - t0)


def rank_full(rep) -> tp.Dict[str, int]:
    """A rank report's causal=False flash launches, {kernel: n}."""
    return {k: sum(n for _, n in rep["launches"][f"{k}_full"]) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def full_launch_check(label, reports, n_layer, n, micro, evals, recompute=False):
    """Each rank of an sp group of n running the ring: n_layer x (n - 1)
    off-diagonal pairs per microstep and eval batch forward (twice per
    microstep when a remat policy recomputes the ring's forward), per
    microstep of each backward (every rank runs every pair: the masked
    ones too); the same on every rank. Returns the ranks' sum."""
    want = {"flash_fwd": n_layer * (n - 1) * ((2 if recompute else 1) * micro + evals),
            "flash_bwd_dq": n_layer * (n - 1) * micro, "flash_bwd_dkv": n_layer * (n - 1) * micro}
    got = [rank_full(rep) for rep in reports]
    if any(g != want for g in got):
        raise SystemExit(f"phase {label}: causal=False launches per rank {got}, want {want} on each")
    return {k: v * len(got) for k, v in want.items()}


def traffic_line(reports) -> str:
    """The ring's hops and Ulysses' all-to-alls of each rank, with bytes."""
    out = []
    for r, rep in enumerate(reports):
        t = rep.get("traffic", {})
        hops = t.get("hop_fwd", 0) + t.get("hop_bwd", 0)
        fwd_hop = t.get("hop_fwd_bytes", 0) / max(t.get("hop_fwd", 0), 1) / 2**20
        out.append(f"rank {r}: {hops} hops sent {gib(t.get('hop_fwd_bytes', 0) + t.get('hop_bwd_bytes', 0))} "
                   f"({fwd_hop:.1f} MiB a forward hop: its K/V shard), {t.get('a2a_calls', 0)} all-to-alls sent "
                   f"{gib(t.get('a2a_bytes', 0))}")
    return "; ".join(out)


def sequence_parallel(card: str, ranks, root: Path, pair_dir: Path, pair_losses):
    """Phase 20's verdicts from its ranks' reports (`ranks`:
    `sequence_parallel_ranks` into `root`). `pair_losses` are 17a's
    one-rank run of the f32 pair (its directory `pair_dir`). Returns the
    ranks' flash launches ({C: {kernel: Counter(variant: n)}} causal,
    {kernel: n} causal=False)."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.launch import apply_overrides

    reports, wall = ranks
    t_phase = time.perf_counter()
    print("phase 20: sequence-parallel training on gloo ranks sharing the card (NCCL refuses two ranks of one "
          "communicator on one card): each ring hop stages its K/V shard through the host, so no time here is a "
          "speed of sequence parallelism")
    mc = load_config("local_text_124m").model_config
    micro = TRAIN_CUTS["g_accum_iters"] * TRAIN_CUTS["max_steps"]
    last = TRAIN_CUTS["max_steps"] - 1
    flash = {C: {k: collections.Counter() for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} for C in (64, 128)}
    full = collections.Counter()
    pair_cfg = apply_overrides(load_config("local_text_124m"),
                               [(k, str(v)) for k, v in {**TRAIN_CUTS, **PAIR_SETS}.items()])
    want = restore_state(pair_dir, last, pair_cfg)["params"]
    p0 = restore_state(pair_dir, 0, pair_cfg)["params"]  # warmed up in one step: step 0 leaves the init
    for n in SP_SIZES:
        for schedule, reps in zip(SP_SCHEDULES, reports["a"][n]):
            label = f"20a {schedule} sp {n}"
            records = reps[0]["records"]
            losses = run_losses(records)
            err = max_rel(losses, pair_losses)
            got = restore_state(root / f"a_{schedule}_{n}", last, pair_cfg)["params"]
            upd = update_rel_err(got, want, p0)
            del got
            evals = n_evals(records)
            per_rank_flash_check(label, reps, 2, micro, evals, exact=True)
            if schedule == "ring":
                full.update(full_launch_check(label, reps, 2, n, micro, evals))
            elif any(any(rank_full(rep).values()) for rep in reps):
                raise SystemExit(f"phase {label}: Ulysses launched a causal=False kernel")
            for rep in reps:
                for k, c in rank_flash([rep]).items():
                    flash[64][k].update(c)
            print(f"phase {label} (2 layers of {mc.n_embd}, f32, T {mc.block_size} over {n} ranks, warmup 1 step): "
                  f"losses (steps, final eval) {losses} vs 17a's one flash rank {pair_losses}: max rel err {err:.2e} "
                  f"(tol {PARITY_TOL['f32_loss']:g}); parameter update rel err {upd:.2e} (tol "
                  f"{PARITY_TOL['f32_update']:g}); causal=False launches per rank {rank_full(reps[0])}; "
                  f"{traffic_line(reps)}; peak memory per rank {[gib(rep['peak']) for rep in reps]} on {card}")
            if err > PARITY_TOL["f32_loss"] or upd > PARITY_TOL["f32_update"]:
                raise SystemExit(f"phase {label}: the sequence-parallel run disagrees with one rank's flash run")
            shutil.rmtree(root / f"a_{schedule}_{n}")
    # 20b: llama7b_32k's width at T 32,768
    one, two = reports["b"]
    lc = load_config("llama7b_32k").model_config
    losses_one, losses_two = run_losses(one[0]["records"]), run_losses(two[0]["records"])
    err = max_rel(losses_two, losses_one)
    steps, evals = LLAMA_SP_CUTS["max_steps"], n_evals(one[0]["records"])
    print(f"phase 20b llama7b_32k ({LLAMA_SP_CUTS['model_config.n_layer']} of {lc.n_layer} layers of {lc.n_embd}, "
          f"{lc.n_head} heads of {lc.head_dim}, vocab {lc.vocab_size:,}, T {lc.block_size:,}, batch 1), bf16 over "
          f"f32, warmup 1 step: losses (steps, evals) the ring on sp 2 {losses_two} vs one flash rank {losses_one}: "
          f"max rel err {err:.2e} (tol {LLAMA_SP_TOL:g}); peak memory one rank {gib(one[0]['peak'])}, sp 2 per rank "
          f"{[gib(rep['peak']) for rep in two]}; state per rank {[gib(rep['state_bytes']) for rep in two]}; "
          f"{traffic_line(two)}; causal=False launches per rank {rank_full(two[0])} (remat "
          f"{lc.remat_policy if lc.remat else 'off'}) on {card}")
    if len(losses_two) != len(losses_one) or not all(np.isfinite(losses_two)) or err > LLAMA_SP_TOL:
        raise SystemExit("phase 20b: the ring on sp 2 disagrees with one rank's flash run at llama7b_32k's width")
    layers = LLAMA_SP_CUTS["model_config.n_layer"]
    recompute = lc.remat and lc.remat_policy in ("none", "dots")  # the forward runs again in the backward
    for label, reps in (("20b one rank", one), ("20b sp 2", two)):
        per_rank_flash_check(label, reps, layers, steps, evals, exact=not recompute)
    full.update(full_launch_check("20b sp 2", two, layers, 2, steps, evals, recompute))
    for rep in one + two:
        for k, c in rank_flash([rep]).items():
            flash[128][k].update(c)
    print(f"phase 20 took {wall:.1f} s in its ranks and {time.perf_counter() - t_phase:.1f} s of verdicts; flash "
          f"launches in its ranks: causal {({C: {k: dict(c) for k, c in v.items()} for C, v in flash.items()})}, "
          f"causal=False {dict(full)} on {card}")
    return flash, full


# ---------------------------------------------------------------- phase 21: pipeline training

EARLIER_SMOKE_PHASE21_S = 716.1  # this script's wall time before phase 21 was added (PERF.md, section 6)
# 21a: 17b's f32 pair (2 layers of full width over attn_block_size 512, warmed up in one step, phase 6's other
# cuts) on pp 2, one layer a stage, 4 pipeline microbatches a microstep: GPipe and 1F1B on 2 ranks, (fsdp 2, pp 2)
# under 1F1B and (tp 2, pp 2) under GPipe on 4; held to 17a's one-rank run of the pair: each step's loss and the
# final eval's at PP_PAIR_TOL relative, the final states at STATE_TOL and PARAM_TOL_LR (19a's)
PP_PAIR_SETS = {**PAIR_SETS, "mesh.fsdp": 1, "mesh.pp": 2, "pipeline_microbatches": 4}
PP_PAIR_RUNS = {  # name: (the group whose ranks run it, sets)
    "gpipe": ("sp2", {"pipeline_schedule": "gpipe"}),
    "1f1b": ("sp2", {"pipeline_schedule": "1f1b"}),
    "fsdp2_1f1b": ("sp4", {"pipeline_schedule": "1f1b", "mesh.fsdp": 2, "shard_model": True}),
    "tp2_gpipe": ("sp4", {"pipeline_schedule": "gpipe", "mesh.tp": 2}),
}
PP_PAIR_TOL = 2e-5
# 21b: local_text_124m at full width and depth (6 layers a stage), bf16 over f32, microbatch 16 in 4 pipeline
# microbatches of 4 rows, pp 2, on phase 6's cuts one step short: GPipe (its final checkpoint restored on one
# device, which trains phase 6's last step) and 1F1B, each loss held to phase 6's at TP_MAIN_TOL (19b's bf16
# limit); then 1F1B at 16 pipeline microbatches of the same 4 rows (batch 64, one step), whose microstep's peak
# memory a rank (the schedule alone, no eval) is held to M 4's within PP_STASH_GROWTH: JAX's pin on 1F1B's temp
# memory over the same growth (tests/test_pipeline.py test_1f1b_activation_stash_is_m_independent)
PP_MAIN_CUTS = {**TRAIN_CUTS, "max_steps": TRAIN_CUTS["max_steps"] - 1, "mesh.fsdp": 1, "mesh.pp": 2,
                "pipeline_microbatches": 4}
PP_M16_SETS = {"pipeline_schedule": "1f1b", "pipeline_microbatches": 16, "batch_size": 64, "g_accum_iters": 1,
               "max_steps": 1}
PP_STASH_GROWTH = 1.5


def pipeline_launches(data_dir: Path, root: Path) -> tp.Dict[str, tp.List[tp.List[str]]]:
    """Phase 21's launches by the group of phase 20a whose ranks run them
    (gloo ranks sharing the card; no group of its own: no start-up, no
    memory beyond the group's, `sequence_parallel_ranks`): "sp2" the sp 2
    group (21a's pp 2 runs, then 21b's: GPipe into root / "b", 1F1B, 1F1B at
    M 16), "sp4" the sp 4 group (21a's (fsdp 2, pp 2) and (tp 2, pp 2)
    runs), and "restore": 21b's GPipe checkpoint on one rank, which trains
    phase 6's last step. Each 21a run writes root / "a_<name>"."""

    def pair(name):
        over = {"data_dir": data_dir, "log_interval": 1, **TRAIN_CUTS, **PP_PAIR_SETS, **PP_PAIR_RUNS[name][1]}
        return ["--config=local_text_124m", f"--rundir={root / f'a_{name}'}", *sets(over)]

    def main_path(rundir, over):
        return ["--config=local_text_124m", f"--rundir={rundir}",
                *sets({"data_dir": data_dir, "log_interval": 1, **PP_MAIN_CUTS, **over})]

    out = {group: [pair(name) for name, (g, _) in PP_PAIR_RUNS.items() if g == group] for group in ("sp2", "sp4")}
    out["sp2"] += [main_path(root / "b", {"pipeline_schedule": "gpipe"}), main_path("", {"pipeline_schedule": "1f1b"}),
                   main_path("", PP_M16_SETS)]
    out["restore"] = [["--config=local_text_124m", f"--rundir={root / 'b'}",
                       *sets({"data_dir": data_dir, "log_interval": 1, **TRAIN_CUTS, "on_resume_mesh": "any"})]]
    return out


def pipeline_reports(by_group: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """Phase 21's reports from its launches ({group: [run][rank]},
    `pipeline_launches` order): {"a": {name: [rank]}, "b": 21b's
    [run][rank], "restored": the one rank's [rank]}."""
    out = {"a": {}}
    for group, reports in by_group.items():
        names = [name for name, (g, _) in PP_PAIR_RUNS.items() if g == group]
        out["a"].update(zip(names, reports[:len(names)]))
        if group == "sp2":
            out["b"] = reports[len(names):]
        if group == "restore":
            out["restored"] = reports[0]
    return out


def pp_flash_check(label, reports, layers, M, micro, evals) -> None:
    """Each rank of a pipeline: its `layers` (L/pp) launches of each
    backward kernel per pipeline microbatch of each microstep, and of the
    forward per pipeline microbatch of each microstep and eval batch (no
    remat: exactly so)."""
    want = {"flash_fwd": layers * M * (micro + evals), "flash_bwd_dq": layers * M * micro,
            "flash_bwd_dkv": layers * M * micro}
    for r, rep in enumerate(reports):
        got = {k: sum(c.values()) for k, c in rank_flash([rep]).items()}
        if got != want:
            raise SystemExit(f"phase {label}: rank {r} flash launches {got}, want {want} ({layers} layers a stage x "
                             f"{M} pipeline microbatches x ({micro} microsteps + {evals} eval batches))")


def pp_traffic(reports) -> str:
    """Each rank's stage sends by kind, with bytes, and 1F1B's stash."""
    out = []
    for r, rep in enumerate(reports):
        t = rep.get("traffic", {})
        kinds = ", ".join(f"{k} {t.get(f'pp_{k}', 0)} ({gib(t.get(f'pp_{k}_bytes', 0))})" for k in ("fwd", "bwd", "ce"))
        out.append(f"rank {r}: sends {kinds}, stash high-water {rep.get('stash', 0)}")
    return "; ".join(out)


def pipeline_training(card: str, reports, root: Path, pair_dir: Path, pair_losses, main_losses):
    """Phase 21's verdicts on its reports (`pipeline_reports`, runs into
    `root`): 21a's runs, 21b's, and 21b's checkpoint restored on one rank.
    `pair_losses` are 17a's one-rank run of
    the f32 pair (its directory `pair_dir`), `main_losses` phase 6's.
    Returns the ranks' flash launches, {kernel: Counter(variant: n)}."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.launch import apply_overrides

    t_phase = time.perf_counter()
    launched = [*reports["a"].values(), *reports["b"], reports["restored"]]
    wall = sum(max(rep["clock"]["done"] - rep["clock"]["launch"] for rep in reps) for reps in launched)
    print("phase 21: pipeline training on gloo ranks sharing the card (NCCL refuses two ranks of one communicator on "
          "one card): each stage send stages its activation through the host, so no time here is a speed of "
          "pipeline parallelism")
    mc = load_config("local_text_124m").model_config
    G, last = TRAIN_CUTS["g_accum_iters"], TRAIN_CUTS["max_steps"] - 1
    flash = {k: collections.Counter() for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    def add(reps):
        for k, c in rank_flash(reps).items():
            flash[k].update(c)

    pair_cfg = apply_overrides(load_config("local_text_124m"),
                               [(k, str(v)) for k, v in {**TRAIN_CUTS, **PAIR_SETS}.items()])
    tol = param_tol(pair_cfg)
    want = restore_state(pair_dir, last, pair_cfg)
    M = PP_PAIR_SETS["pipeline_microbatches"]
    for name, reps in reports["a"].items():
        label = f"21a {name}"
        records = reps[0]["records"]
        losses = run_losses(records)
        err = max_rel(losses, pair_losses)
        errs = state_errors(restore_state(root / f"a_{name}", last, pair_cfg), want, tol)
        print(f"phase {label} ({len(reps)} ranks, 2 layers of {mc.n_embd} over pp 2, f32, {M} pipeline microbatches "
              f"a microstep, warmup 1 step): losses (steps, final eval) {losses} vs 17a's one rank {pair_losses}: max "
              f"rel err {err:.2e} (tol {PP_PAIR_TOL:g}); step {last} states, max |pp - one rank|: {fmt_errors(errs, tol)}; "
              f"{pp_traffic(reps)}; peak memory per rank {[gib(rep['peak']) for rep in reps]} on {card}")
        if err > PP_PAIR_TOL or not errs["ok"]:
            raise SystemExit(f"phase {label}: the pipeline run disagrees with the one-rank run")
        pp_flash_check(label, reps, 1, M, G * TRAIN_CUTS["max_steps"], n_evals(records))
        add(reps)
        shutil.rmtree(root / f"a_{name}")
    # 21b: the main path at full width and depth; the M 16 run (other rows: batch 64) is held to finite losses
    steps = PP_MAIN_CUTS["max_steps"]
    layers = mc.n_layer // 2
    runs = (("GPipe", PP_MAIN_CUTS["pipeline_microbatches"], G * steps),
            ("1F1B", PP_MAIN_CUTS["pipeline_microbatches"], G * steps),
            ("1F1B at M 16", PP_M16_SETS["pipeline_microbatches"], PP_M16_SETS["max_steps"]))
    for (name, m, micro), reps in zip(runs, reports["b"]):
        records = reps[0]["records"]
        losses = step_losses(records)
        held = name != "1F1B at M 16"
        ref = main_losses[:len(losses)]
        err = max_rel(losses, ref)
        tok = [r["throughput/tokens_per_sec"] for r in records if "loss/optimized" in r][1:]
        spans = [rep["clock"]["done"] - rep["clock"]["launch"] for rep in reps]
        print(f"phase 21b {name} local_text_124m ({mc.n_layer} x {mc.n_embd}, {layers} layers a stage), bf16 over f32, "
              f"{m} pipeline microbatches of 4 rows: losses {losses}"
              + (f" vs phase 6's single device {ref}: max rel err {err:.2e} (tol {TP_MAIN_TOL:g})" if held else "")
              + f"; tokens/s (the leader's, after step 0) {tok}; launch wall per rank {[round(x, 1) for x in spans]} s; "
              f"{pp_traffic(reps)}; peak memory per rank {[gib(rep['peak']) for rep in reps]}; state per rank "
              f"{[gib(rep['state_bytes']) for rep in reps]} on {card}")
        if not losses or not all(np.isfinite(losses)) or (held and (len(losses) != steps or err > TP_MAIN_TOL)):
            raise SystemExit(f"phase 21b {name}: the pipeline disagrees with phase 6's single device")
        if "1F1B" in name and any(rep["stash"] > 2 * 2 for rep in reps):
            raise SystemExit(f"phase 21b {name}: a stage stashed more than 2 pp microbatches")
        pp_flash_check(f"21b {name}", reps, layers, m, micro, n_evals(records))
        add(reps)
    growth = [a["schedule_peak"] / b["schedule_peak"] for a, b in zip(reports["b"][2], reports["b"][1])]
    print(f"phase 21b 1F1B microstep peak memory per rank, M 4 {[gib(r['schedule_peak']) for r in reports['b'][1]]}, "
          f"M 16 {[gib(r['schedule_peak']) for r in reports['b'][2]]} (4-row microbatches): M 16 over M 4 "
          f"{[round(g, 3) for g in growth]} (limit {PP_STASH_GROWTH:g}) on {card}")
    if max(growth) > PP_STASH_GROWTH:
        raise SystemExit("phase 21b: 1F1B's memory grew with the microbatch count")
    # its final checkpoint (whole leaves), restored on one rank, trains phase 6's last step
    restored = reports["restored"]
    rec = [r for r in restored[0]["records"] if "loss/optimized" in r]
    nxt = rec[0]["loss/optimized"] if len(rec) == 1 and rec[0]["step"] == last else None
    rel = abs(nxt - main_losses[last]) / main_losses[last] if nxt is not None else float("inf")
    print(f"phase 21b restore on one device: steps trained {[r['step'] for r in rec]}; step {last}'s loss {nxt} vs "
          f"phase 6's {main_losses[last]} (rel err {rel:.2e}, tol {TP_MAIN_TOL:g}) on {card}")
    if rel > TP_MAIN_TOL:
        raise SystemExit("phase 21b: the pp 2 checkpoint did not restore on one device into phase 6's trajectory")
    per_rank_flash_check("21b restored", restored, mc.n_layer, G, n_evals(restored[0]["records"]), exact=True)
    add(restored)
    shutil.rmtree(root / "b")
    print(f"phase 21 took {wall:.1f} s in its ranks' launches (beside 5c-11c) and "
          f"{time.perf_counter() - t_phase:.1f} s of verdicts; flash launches in its ranks: "
          f"{({k: dict(c) for k, c in flash.items()})} on {card}")
    return flash


# ---------------------------------------------------------------- phase 22: expert-parallel MoE training

# 22a: 17b's f32 pair with phase 16's routed MLP (8 experts, top-2, aux 0.01) on microbatches of 4 rows, one step
# (lr 0: its Adam moments hold the step's gradient, the weights stay the init): one rank (its routing recorded),
# then ep 2 and (fsdp 2, ep 2) pinned to that routing, each held to the one rank at PAIR_TOL (losses) and STATE_TOL
# (the moments; the weights bit for bit); a token the pin overrode must sit at a near-tie (gap < GAP_TOL). At 16
# rows the f32 (N, E/ep, 4D) buffers would take ~4x a rank's memory beside 20a's groups, the main phases and the
# serving lane (at 4 rows a one rank peaked at 8.07 GiB, an ep 2 rank at 6.24 on an H100 80GB HBM3, PERF.md)
EP_PAIR_SETS = {**PAIR_SETS, **MOE_SETS, "batch_size": 4, "mesh.fsdp": 1, "max_steps": 1}
EP_PAIR_RUNS = {"ep2": {"mesh.ep": 2}, "fsdp2_ep2": {"mesh.fsdp": 2, "mesh.ep": 2, "shard_model": True}}
# 22b: local_text_124m with the routed MLP at full width and depth, bf16 over f32, on phase 6's cuts with the
# microbatch cut from 16 rows x 2 to 2 x 16 (phase 16a's 32 windows a step; at 4 rows an ep 2 rank peaked at 13.12
# GiB and ran the card out of memory beside phase 11 and the lane, PERF.md section 6): step 0 on ep 2 (lr 0:
# its Adam moments hold the step's gradient), its checkpoint restored on one device (this process, after phase 16,
# saving nothing: a second 6.7 GB checkpoint beside 17-19's ran past the machine's 45 GiB of disk writes, PERF.md section 6)
# for steps 1 and 2, whose update reads those moments. Held at TP_MAIN_TOL (19b's bf16 limit) to one device on the
# same cuts, 3 steps; phase 16a's losses (16 rows x 2) are printed beside: the aux term's means are a microbatch's,
# so the cut alone moves the loss (1.05e-4 relative at 4 x 8 on an H100 80GB HBM3, PERF.md). Both 22b runs are pinned
# to that device's routing (`routing`). Until the first update with lr > 0 (step 1's) they hold the same weights as
# it and differ only in the combine's bf16 partial sums; a bf16 router logit rounds to 2^-8 relative, so a token
# whose own top-2 the pin overrode there is a near-tie when its K/K+1 gap is within 4 ulps. After it the weights
# part by the gradients' bf16 rounding through Adam's normalised update (13,440 tokens overridden after it at 4 x 8,
# up to 1.97 relative, PERF.md section 6): those are counted, not bounded
EP_BF16_GAP_TOL = 2.0**-6
EP_MAIN_ROWS = 2
EP_MAIN_CUTS = {**TRAIN_CUTS, "max_steps": 1, "batch_size": EP_MAIN_ROWS,
                "g_accum_iters": TRAIN_CUTS["g_accum_iters"] * 16 // EP_MAIN_ROWS,  # local_text_124m's microbatch: 16
                "mesh.fsdp": 1, "mesh.ep": 2}
EP_MAIN_STEPS = 3  # the one device's, and the restore's last step + 1
EP_WAIT_S = 600  # the most 22b's ep run waits for its reference's routing
# 22c: tools/bench_batcher.py's shapes (B, T) over a seeded uint16 stream of its length
BATCHER_SHAPES = ((256, 1024), (2048, 1024), (512, 4096))
BATCHER_STREAM = 200_000_000


def expert_parallel_launches(data_dir: Path, root: Path) -> tp.Dict[str, tp.List[str]]:
    """Phase 22's launches by name (each rides a group of another phase,
    `main`): "a_one" 22a's one-rank reference into root / "a_one",
    recording its routing (root / "a_routing.pt"), then "a_ep2" and
    "a_fsdp2_ep2" pinned to it; "b_one" 22b's cuts on one device (no run
    directory), recording its routing (root / "b_routing.pt"), then "b_ep"
    22b's ep 2 run into root / "b" pinned to its first step, waiting for
    that record (another group runs "b_one"; its restore: `ep_restore`)."""
    def pair(name, over, hook):
        return ["--config=local_text_124m", f"--rundir={root / f'a_{name}'}",
                f"--routing={hook}:{root / 'a_routing.pt'}",
                *sets({"data_dir": data_dir, "log_interval": 1, **TRAIN_CUTS, **EP_PAIR_SETS, **over})]

    def main_path(rundir, hook, over):
        return ["--config=local_text_124m", f"--rundir={rundir}", f"--routing={hook}",
                *sets({"data_dir": data_dir, "log_interval": 1, **EP_MAIN_CUTS, **MOE_SETS, **over})]

    pin = root / "b_routing.pt"
    return {"a_one": pair("one", {}, "record"),
            **{f"a_{name}": pair(name, over, "pin") for name, over in EP_PAIR_RUNS.items()},
            "b_one": main_path("", f"record:{pin}", {"mesh.ep": 1, "max_steps": EP_MAIN_STEPS}),
            "b_ep": [f"--wait-for={pin}", *main_path(root / "b", f"pin:{pin}:0:{ep_pinned_calls()}", {})]}


def ep_pinned_calls() -> int:
    """22b's gates calls up to its checkpoint's step (the step-0 evals,
    then its steps' microsteps, a call a layer each)."""
    from midgpt_tpu_torch.config import load_config

    n_layer = load_config("local_text_124m").model_config.n_layer
    return n_layer * (2 * EP_MAIN_CUTS["eval_steps"] + EP_MAIN_CUTS["max_steps"] * EP_MAIN_CUTS["g_accum_iters"])


def ep_traffic(reports) -> str:
    """Each rank's all-reduces over its ep group, with bytes."""
    return "; ".join(f"rank {r}: {rep['traffic'].get('ep_calls', 0)} ep all-reduces of "
                     f"{gib(rep['traffic'].get('ep_bytes', 0))}" for r, rep in enumerate(reports))


def _ep_flash(*launches) -> tp.Dict[str, collections.Counter]:
    """The flash launches of phase 22's launches' ranks, summed."""
    flash = {k: collections.Counter() for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for reps in launches:
        for k, c in rank_flash(reps).items():
            flash[k].update(c)
    return flash


def expert_parallel_pair(card: str, reports, root: Path):
    """Phase 22a's verdicts on its reports ({launch name: [rank]},
    `expert_parallel_launches`' names, runs into `root`); its run
    directories are removed. Returns its ranks' flash launches, {kernel:
    Counter(variant: n)}."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.launch import apply_overrides

    t_phase = time.perf_counter()
    print("phase 22: expert-parallel training on gloo ranks sharing the card (NCCL refuses two ranks of one "
          "communicator on one card): each ep all-reduce stages through the host, so no time here is a speed of "
          "expert parallelism")
    mc = dataclasses.replace(load_config("local_text_124m").model_config, **MOE_MODEL)
    G, steps = TRAIN_CUTS["g_accum_iters"], EP_PAIR_SETS["max_steps"]
    last = steps - 1

    pair_cfg = apply_overrides(load_config("local_text_124m"),
                               [(k, str(v)) for k, v in {**TRAIN_CUTS, **EP_PAIR_SETS}.items()])
    tol = param_tol(pair_cfg)
    one = reports["a_one"]
    ref_losses = run_losses(one[0]["records"])
    want = restore_state(root / "a_one", last, pair_cfg, "cpu")  # beside 17's start: the card's memory is theirs
    per_rank_flash_check("22a one rank", one, 2, G * steps, n_evals(one[0]["records"]), exact=True)
    print(f"phase 22a one rank (2 layers of {mc.n_embd}, {mc.n_experts} experts, top-{mc.moe_top_k}, f32, "
          f"microbatch {EP_PAIR_SETS['batch_size']} x {G}, {steps} step at lr 0): losses (steps, final eval) "
          f"{ref_losses}; peak memory "
          f"{gib(one[0]['peak'])}; expert banks "
          f"{gib(one[0]['bank_bytes'])} of its state {gib(one[0]['state_bytes'])} on {card}")
    runs = {name: reports[f"a_{name}"] for name in EP_PAIR_RUNS}
    for name, reps in runs.items():
        label = f"22a {name}"
        losses = run_losses(reps[0]["records"])
        err = max_rel(losses, ref_losses)
        errs = state_errors(restore_state(root / f"a_{name}", last, pair_cfg, "cpu"), want, tol)
        gaps = [g for rep in reps for _, g in rep["routing_flips"]]
        print(f"phase {label} ({len(reps)} ranks, the one rank's routing pinned): losses (steps, final eval) {losses} "
              f"vs the one rank {ref_losses}: max rel err {err:.2e} (tol {PAIR_TOL:g}); step {last} states, max "
              f"|ep - one rank|: {fmt_errors(errs, tol)}; tokens whose own top-{mc.moe_top_k} the pin overrode, per "
              f"rank "
              f"{[len(rep['routing_flips']) for rep in reps]}, K/K+1 router logit gaps "
              f"{[f'{g:.3e}' for g in gaps[:8]]}{' ...' if len(gaps) > 8 else ''} (tol {GAP_TOL:g}); "
              f"{ep_traffic(reps)}; "
              f"expert banks per rank {[gib(rep['bank_bytes']) for rep in reps]} of the one rank's "
              f"{gib(one[0]['bank_bytes'])}; peak memory per rank {[gib(rep['peak']) for rep in reps]} on {card}")
        if err > PAIR_TOL or not errs["ok"]:
            raise SystemExit(f"phase {label}: the expert-parallel run disagrees with the one-rank run")
        if any(abs(g) >= GAP_TOL for g in gaps):
            raise SystemExit(f"phase {label}: a token's routing departed from the one rank's away from a near-tie")
        shards = 2 * (2 if "fsdp" in name else 1)  # ep, and fsdp on the banks' last axis
        if any(rep["bank_bytes"] * shards != one[0]["bank_bytes"] for rep in reps):
            raise SystemExit(f"phase {label}: a rank does not hold its share of the expert banks")
        if any(rep["traffic"].get("ep_calls", 0) == 0 for rep in reps):
            raise SystemExit(f"phase {label}: a rank issued no ep all-reduce")
        per_rank_flash_check(label, reps, 2, G * steps, n_evals(reps[0]["records"]), exact=True)
    for name in ("one", *runs):
        shutil.rmtree(root / f"a_{name}")
    launched = [one, *runs.values()]
    wall = sum(max(rep["clock"]["done"] - rep["clock"]["launch"] for rep in r) for r in launched)
    flash = _ep_flash(*launched)
    print(f"phase 22a took {wall:.1f} s in its ranks' launches (beside 5c-11c) and "
          f"{time.perf_counter() - t_phase:.1f} s of verdicts; flash launches in its ranks: "
          f"{({k: dict(c) for k, c in flash.items()})} on {card}")
    return flash


def ep_restore(root: Path, data_dir: Path):
    """22b's checkpoint (root / "b") restored on this device, verified, and
    trained on for steps max_steps .. EP_MAIN_STEPS - 1 of its cuts on the
    stream in `data_dir`, with its routing pinned to its reference's
    (root / "b_routing.pt"), as `train` resumes (its positional batches)
    but saving nothing; the checkpoint is removed. Returns {"step": the
    restored step, "losses": the steps', "flips": [call, gap] of each token
    the pin overrode, "launches": flash launches by kernel and variant,
    "seconds"}."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.data.dataset import TokenDataset
    from midgpt_tpu_torch.launch import apply_overrides
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager
    from midgpt_tpu_torch.training.optim import make_optimizer
    from midgpt_tpu_torch.training.train import make_train_step, state_template

    t0 = time.perf_counter()
    cfg = apply_overrides(load_config("local_text_124m"), [(k, str(v)) for k, v in {
        **EP_MAIN_CUTS, **MOE_SETS, "mesh.ep": 1, "data_dir": data_dir}.items()])
    pin = [(sel,) for sel in torch.load(root / "b_routing.pt")[ep_pinned_calls():]]
    flips: list = []
    mngr = CheckpointManager(str(root / "b"))
    step = mngr.latest_verified_step()
    state = mngr.restore(step, state_template(cfg), device="cuda")
    mngr.close()
    params, opt_state = state["params"], state["opt_state"]
    optimizer, _ = make_optimizer(cfg)
    train_step = make_train_step(cfg, optimizer)[0]
    ds = TokenDataset(str(data_dir), seed=cfg.data_seed)
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    losses, carrier = [], 0.0
    with routing([], pin=pin, flips=flips):
        for itr in range(step + 1, EP_MAIN_STEPS):
            x, y = ds.batch("train", itr, cfg.model_config.block_size, cfg.batch_size, cfg.g_accum_iters)
            params, opt_state, carrier = train_step(params, opt_state, torch.from_numpy(x).cuda().long(),
                                                    torch.from_numpy(y).cuda().long(), None, carrier)
            losses.append(carrier.item())
    torch.cuda.synchronize()
    launches = {n: dict(c.by_variant) for n, c in counters.items()}
    del params, opt_state, state
    free_memory()
    shutil.rmtree(root / "b")  # 6.7 GB: the machine takes 45 GiB of disk writes
    return {"step": step, "losses": losses, "flips": flips, "launches": launches,
            "seconds": time.perf_counter() - t0}


def expert_parallel_main(card: str, reports, restore, root: Path, moe_losses):
    """Phase 22b's verdicts on its ranks' reports and its restore on this
    device (`ep_restore`'s result) against one device on its cuts, with
    phase 16a's one-device losses `moe_losses` beside; `root` is removed.
    Returns the flash launches of its ranks and its restore, {kernel:
    Counter(variant: n)}."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import param_shapes

    t_phase = time.perf_counter()
    base = load_config("local_text_124m")
    mc = dataclasses.replace(base.model_config, **MOE_MODEL)
    G, steps = EP_MAIN_CUTS["g_accum_iters"], EP_MAIN_CUTS["max_steps"]
    reps, one = reports["b_ep"], reports["b_one"]
    at, resumed, restore_flips, restore_launches = (restore[k] for k in ("step", "losses", "flips", "launches"))
    records = reps[0]["records"]
    losses, one_losses = step_losses(records), step_losses(one[0]["records"])
    err, cut = max_rel(losses, one_losses[:steps]), max_rel(one_losses, moe_losses[:len(one_losses)])
    rel = max_rel(resumed, one_losses[steps:]) if at == steps - 1 else float("inf")
    banks = 3 * 4 * sum(int(np.prod(v)) for k, v in param_shapes(mc).items() if "experts" in k)
    print("phase 22b reduced: " + ", ".join(f"{k} {getattr(base, k)} -> {v}" for k, v in EP_MAIN_CUTS.items()
                                              if k in ("batch_size", "g_accum_iters", "max_steps", "eval_steps"))
          + f"; microbatch rows 16 -> {EP_MAIN_ROWS} with g_accum 2 -> {G}: phase 16a's 32 windows a step, in other "
          f"microbatches (the aux term's means are a microbatch's); step 0 on ep 2, steps 1-{EP_MAIN_STEPS - 1} "
          "restored on one device")
    print(f"phase 22b one device on these cuts: losses {one_losses} vs phase 16a's (16 rows x 2) {moe_losses}: max "
          f"rel err {cut:.2e} (the cut's own, not bounded); peak memory {gib(one[0]['peak'])} on {card}")
    print(f"phase 22b local_text_124m ({mc.n_layer} x {mc.n_embd}, {mc.n_experts} experts, top-{mc.moe_top_k}, aux "
          f"{MOE_SETS['moe_aux_coef']}), bf16 over f32, ep 2: step 0's loss {losses} vs one device on these cuts "
          f"{one_losses[:steps]}: rel err {err:.2e} (tol {TP_MAIN_TOL:g}); its checkpoint (step {at}) restored on "
          f"the main process's device in {restore['seconds']:.1f} s (after 19's verdicts), steps "
          f"{steps}-{EP_MAIN_STEPS - 1}: {resumed} vs {one_losses[steps:]}: "
          f"max rel err {rel:.2e} (tol {TP_MAIN_TOL:g}); {ep_traffic(reps)}; expert banks and their moments per "
          f"rank {[gib(rep['bank_bytes']) for rep in reps]} of one device's {gib(banks)}; state per rank "
          f"{[gib(rep['state_bytes']) for rep in reps]}; peak memory per rank {[gib(rep['peak']) for rep in reps]} "
          f"on {card}")
    # the ep run and the restore's first step hold the one device's weights (lr 0 at step 0); the next follows an
    # update
    still = mc.n_layer * G
    early = [g for rep in reps for _, g in rep["routing_flips"]] + [g for i, g in restore_flips if i < still]
    later = [g for i, g in restore_flips if i >= still]
    print(f"phase 22b routing pinned to the one device's: tokens whose own top-2 the pin overrode on its weights (ep "
          f"2's step 0, the restore's step {steps}) {len(early)}, largest K/K+1 router logit gap "
          f"{max(map(abs, early), default=0.0):.3e} (tol {EP_BF16_GAP_TOL:g}); after the first update (step "
          f"{steps + 1}) {len(later)}, gaps at the quartiles "
          f"{np.quantile(later, (0.25, 0.5, 0.75)).round(5).tolist() if later else []}, largest "
          f"{max(map(abs, later), default=0.0):.3e} on {card}")
    if len(losses) != steps or not all(np.isfinite(losses)) or err > TP_MAIN_TOL:
        raise SystemExit("phase 22b: the expert-parallel run disagrees with one device on its cuts")
    if rel > TP_MAIN_TOL:
        raise SystemExit("phase 22b: the ep 2 checkpoint did not restore on one device into its trajectory")
    if any(abs(g) > EP_BF16_GAP_TOL for g in early):
        raise SystemExit("phase 22b: on the one device's weights a token's routing departed from its routing away "
                         "from a near-tie")
    if any(rep["bank_bytes"] * 2 != banks for rep in reps):
        raise SystemExit("phase 22b: a rank does not hold half of the expert banks")
    per_rank_flash_check("22b", reps, mc.n_layer, G * steps, n_evals(records), exact=True)
    per_rank_flash_check("22b one device", one, mc.n_layer, G * EP_MAIN_STEPS, n_evals(one[0]["records"]),
                         exact=True)
    flash_launch_check("phase 22b restored", restore_launches, mc.n_layer, G * (EP_MAIN_STEPS - steps), 0)
    shutil.rmtree(root)
    wall = sum(max(rep["clock"]["done"] - rep["clock"]["launch"] for rep in r) for r in (reps, one))
    flash = _ep_flash(reps, one)
    for k, c in restore_launches.items():
        flash[k].update(c)
    print(f"phase 22b took {wall:.1f} s in its ranks' launches (its one device in 17a's group, its ep 2 run in "
          f"19a's), "
          f"{restore['seconds']:.1f} s in its restore and {time.perf_counter() - t_phase:.1f} s of verdicts; flash "
          f"launches: "
          f"{({k: dict(c) for k, c in flash.items()})} on {card}")
    return flash


def batcher_host(card: str):
    """Phase 22c (host only, in the decode lane): the native batcher built
    from the checkout's batcher.c against numpy's gather, bit for bit, at
    tools/bench_batcher.py's shapes over a seeded uint16 stream; each
    path's ms (5 calls, after a warm one) on the card's host, beside the
    lane's other phases."""
    from midgpt_tpu_torch import native

    if not native.native_available():
        raise SystemExit(f"phase 22c: the native batcher did not build on the card's machine: {native.build_error()}")
    data = np.random.default_rng(0).integers(0, 50304, BATCHER_STREAM, dtype=np.uint16)
    rows = []
    for B, T in BATCHER_SHAPES:
        starts = np.random.default_rng(1).integers(0, len(data) - T - 1, size=B)
        offsets = np.arange(T)
        t0 = time.perf_counter()
        for _ in range(5):
            x = data[starts[:, None] + offsets].astype(np.int32)
            y = data[starts[:, None] + offsets + 1].astype(np.int32)
        np_ms = (time.perf_counter() - t0) / 5 * 1e3
        native.sample_windows(data, starts, T)
        t0 = time.perf_counter()
        for _ in range(5):
            xn, yn = native.sample_windows(data, starts, T)
        c_ms = (time.perf_counter() - t0) / 5 * 1e3
        if not (np.array_equal(x, xn) and np.array_equal(y, yn)):
            raise SystemExit(f"phase 22c: the native windows differ from numpy's at B={B} T={T}")
        rows.append([B, T, np_ms, c_ms])
        print(f"phase 22c batcher B={B} T={T} over {BATCHER_STREAM:,} uint16 tokens: numpy {np_ms:.3f} ms, native "
              f"{c_ms:.3f} ms ({np_ms / c_ms:.1f}x), windows bit for bit; {native.library_path().name} built from the "
              f"checkout's C; the host of {card}, beside the decode lane's phases")
    return rows


# ---------------------------------------------------------------- the lanes: serving beside training

# Serving phases hold the host most of the time (a decode round is 3-54% busy on the card, PERF.md section 5);
# training phases wait on the card, or on their ranks' host-staged collectives. So two serving lanes, each a
# process of its own (`chip_smoke.py --lane NAME OUT`), run beside training in `main`:
#   "decode"  phases 5, 4b, 5b and 6c(e), beside phases 17-19 (joined before phase 18's verdicts, which hold
#             its streams);
#   "serving" phases 11d and 12-15, beside phases 5c-11c (joined before phase 17, whose ranks need the card's
#             memory: this lane holds up to ~16 GB in phase 15, the other ~3 GB).
# The serving main path (phase 4), the training main path (phase 6) and the timings (phase 10) run alone. A
# lane's launch counters are zeroed and read in its own process, as its phases always did; its results come
# back in OUT as JSON, its output is printed when it is joined.
LANE_TIMEOUT_S = 900
LANE_PHASES = {"decode": "5, 4b, 5b, 6c(e), 22c", "serving": "11d, 12-15"}


def decode_lane(card: str) -> dict:
    """Phases 5, 4b, 5b and 6c(e) on phase 4's model (openwebtext, seed 0)."""
    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.utils.precision import cast_floating

    clock = PhaseClock()
    cfg = load_config("openwebtext").model_config
    params32 = GPT.init(cfg, 0, device="cuda")
    params16 = cast_floating(params32, torch.bfloat16)
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
    clock.mark("5 f32 streams, busy share")
    # 4b. the overlap modes as CUDA-graph replays (after phase 5: its f32 streams are the reference)
    overlap_rates, streams16 = overlap_serving(card, cfg, params32, params16, kernel_streams, gather_streams)
    wall_us, by_name = profile_decode(cfg, params16, warm=3, overlap="group", round_group=4)
    busy["group:4"] = print_busy("group:4 decode rounds (CUDA-graph replays)", wall_us, by_name, card)
    print("decode by overlap mode, bf16 (" + card + "): " + "; ".join(
        f"{spec} {dec:.1f} tokens/s in rounds, {e2e:.1f} tokens/s end to end" for spec, (dec, e2e)
        in overlap_rates.items()) + "; device busy " + ", ".join(
        f"{spec} {'not measured' if b is None else f'{100 * b:.1f}%'}" for spec, b in busy.items()))
    clock.mark("4b overlap modes")
    # 5b. speculative serving, bf16 and int8: counters zeroed just before each run, read just after
    spec_launches_by_run = spec_serving(card, params32, params16, kernel_streams)
    clock.mark("5b speculative")
    # 6c(e). the serving faults, obs and the engine's watchdog on phase 4's trace
    faulted_serving(card, cfg, params32, params16, streams16)
    clock.mark("6c(e) serving faults")
    # 22c. the native batcher on the card's host
    batcher_host(card)
    clock.mark("22c batcher")
    print(f"decode lane phase wall seconds on {card}: {clock.line()}")
    return {"kernel_streams": [np.asarray(t).tolist() for t in kernel_streams],
            "bf16_off_streams": [np.asarray(t).tolist() for t in streams16["off"]],
            "overlap_rates": overlap_rates, "busy": busy,
            "spec_launches": {run: [[list(key), n] for key, n in c.items()] for run, c in spec_launches_by_run.items()}}


def serving_lane(card: str) -> dict:
    """Phases 11d and 12-15."""
    clock = PhaseClock()
    llama_serving(card)
    free_memory()
    clock.mark("11d llama7b_long")
    launches64, launches128, speeds = batch_sampler(card)
    clock.mark("12 batch sampler")
    by_pool, alias_errs = front_door(card)
    clock.mark("13 front door")
    for pool, n in fleet_chaos(card).items():
        by_pool[pool] += n
    clock.mark("14 chaos, fleet, disagg")
    for pool, n in proc_fleet(card).items():
        by_pool[pool] += n
    clock.mark("15 process fleet")
    print(f"serving lane phase wall seconds on {card}: {clock.line()}")
    return {"batch_launches": [launches64, launches128],
            "batch_speeds": [[phase, rows, rates, busy] for (phase, rows), (rates, busy) in speeds.items()],
            "by_pool": {pool: [[list(key), n] for key, n in c.items()] for pool, c in by_pool.items()},
            "alias_errs": [[str(dt).removeprefix("torch."), s, err] for (dt, s), err in alias_errs.items()]}


def lane_main(argv) -> int:
    """`chip_smoke.py --lane NAME OUT`: lane NAME's phases, their results to
    OUT as JSON."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, out = argv
    result = {"decode": decode_lane, "serving": serving_lane}[name](card_line())
    Path(out).write_text(json.dumps(result, default=lambda x: x.item()))  # numpy scalars as numbers
    return 0


def start_lane(name: str, tmp: Path) -> subprocess.Popen:
    """Lane `name` in the background, its output to tmp/<name>.log."""
    with open(tmp / f"{name}.log", "w") as log:
        return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--lane", name,
                                 str(tmp / f"{name}.json")], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)


def join_lane(name: str, proc: subprocess.Popen, tmp: Path, beside: str) -> dict:
    """Waits for lane `name` (run beside phases `beside`), prints its
    output, fails if it failed; returns its results."""
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=LANE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"--- the {name} lane (phases {LANE_PHASES[name]}; beside phases {beside}; joined after a wait of "
          f"{time.perf_counter() - t0:.1f} s) ---")
    print((tmp / f"{name}.log").read_text(), end="")
    print(f"--- end of the {name} lane ---")
    if proc.returncode != 0:
        raise SystemExit(f"the {name} lane (phases {LANE_PHASES[name]}) failed with exit {proc.returncode}")
    return json.loads((tmp / f"{name}.json").read_text())


def counters_of(rows) -> collections.Counter:
    """A lane's [[key, n], ...] back into Counter({tuple(key): n})."""
    return collections.Counter({tuple(key): n for key, n in rows})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "midgpt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank17"]:
        return rank17_main(sys.argv[2:])
    if sys.argv[1:2] == ["--rank18"]:
        return rank18_main(sys.argv[2:])
    if sys.argv[1:2] == ["--lane"]:
        return lane_main(sys.argv[2:])
    sys.path.insert(0, str(ROOT))
    from concurrent.futures import ThreadPoolExecutor

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
    clock = PhaseClock()
    global MEMORY
    MEMORY = MemoryWatch(T_START)
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
    regs = collections.defaultdict(dict)  # (kernel, C): {causal: registers}
    for row in build.ptxas_report(build.build_logs.get("flash_attention", "")):
        kern = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel(?:_mma)?)I", row["kernel"])
        if kern and row["causal"] is not None:
            regs[(kern.group(1), row["C"])][row["causal"]] = row.get("registers")
    print("ptxas flash registers, causal / causal=False: " + ", ".join(
        f"{kern} C {C} {r.get(True)} / {r.get(False)}" for (kern, C), r in sorted(regs.items())))

    clock.mark("2 build")
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
    full_errs = check_full_flash()  # causal=False: ring attention's off-diagonal pairs

    clock.mark("3 kernels vs plain")
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

    del params32, params16
    free_memory()
    clock.mark("4 serving bf16")

    lanes_dir = Path(tempfile.mkdtemp())
    lanes = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data_dir = Path(tmp)
            synthetic_stream(data_dir, load_config("local_text_124m").model_config.vocab_size)
            # 6. the training main path, alone on the card: counters zeroed just before, read just after
            main_dir = data_dir / "main"
            main_dir.mkdir()
            from midgpt_tpu_torch import native

            native.PATHS.clear()
            flash_launches, train_tok_s, train_mfu, main_losses = train_main_path(data_dir, card, main_dir)
            print(f"phase 6 token windows by path: {dict(native.PATHS)} ({native.library_path()}, built from the "
                  f"checkout's batcher.c)")
            if native.PATHS["numpy"] or not native.PATHS["native"]:
                raise SystemExit(f"phase 6: the main path's windows did not all come from the native batcher "
                                 f"({native.build_error()})")
            free_memory()
            clock.mark("6 training")
            # 11d and 12-15: the serving lane, beside phases 5c-11c
            lanes["serving"] = start_lane("serving", lanes_dir)
            # 20. sequence-parallel training: its ranks beside phases 5c-11c and the serving lane (the 17-19 block
            # holds no room on the card for 20b's ~40 GiB); its verdicts after phase 17, whose one-rank pair 20a
            # is held to
            sp_root = data_dir / "sp_train"
            sp_root.mkdir()
            # 21. pipeline training: its launches ride 20a's groups (no start-up of their own, and no more memory at
            # once than those groups'), its restore on one rank after 20's ranks; its verdicts after 20's
            pp_root = data_dir / "pp_train"
            pp_root.mkdir()
            pp_launches = pipeline_launches(data_dir, pp_root)
            # 22. expert-parallel training, riding other phases' groups: 22a's one rank after 20b's, its ep runs
            # after 21's in 20a's groups, its verdicts after those groups; 22b's one device after 17a's runs (17b's
            # xl waits for it), its ep 2 run after 19a's in 19a's group (19's groups peak at ~57 GiB together, so
            # not beside them: after 17b's xl it met 19's ranks and ran the card out of memory, and in 20a's groups
            # it met phase 7; PERF.md section 6), its restore in this process after 19's verdicts, its verdicts
            # after phase 16
            ep_root = Path(tempfile.mkdtemp())  # outside the data directory: 22b's verdicts come after phase 16
            ep = expert_parallel_launches(data_dir, ep_root)
            n21 = {g: len(pp_launches[g]) for g in ("sp2", "sp4")}
            sp_pool = ThreadPoolExecutor(1)
            sp_ranks = sp_pool.submit(sequence_parallel_ranks, data_dir, sp_root, card, 10,
                                      {"one": [ep["a_one"]], "sp2": pp_launches["sp2"] + [ep["a_ep2"]],
                                       "sp4": pp_launches["sp4"] + [ep["a_fsdp2_ep2"]]})
            pp_restored = sp_pool.submit(torchrun, "21b's pp 2 checkpoint restored on one rank", 1,
                                         pp_launches["restore"], card, None, 600, 10)
            # 5c. the GQA and window slice: train both variants, serve what they wrote
            rundirs = {variant: data_dir / variant for variant in GQA_VARIANTS}
            for variant, rundir in rundirs.items():
                train_variant(data_dir, rundir, variant, card)
                free_memory()
            gqa_launches, window_launches = gqa_serving(card, rundirs)
            for rundir in rundirs.values():
                shutil.rmtree(rundir)  # two checkpoint steps each
            free_memory()
            clock.mark("5c GQA and window")
            # 6b. checkpoints and resume on the main path: counters zeroed just before the resumed run
            _, round_trip, straight_dir = resume_main_path(data_dir, card)
            free_memory()
            clock.mark("6b checkpoints")
            # 6c(a-d). the supervised trainer: rollback, hang restart, SIGTERM, the armed watchdog
            supervised_main_path(data_dir, straight_dir, round_trip, card)
            free_memory()
            clock.mark("6c(a-d) supervised trainer")
            # 7-9. parity, the tiled dispatch, where a training step's time goes
            train_parity(data_dir, card)
            train_tiled(data_dir)
            free_memory()
            profile_train(data_dir, card)
            free_memory()
            clock.mark("7-9 parity, tiled, profile")
            # 11. the six presets' slice: wide610m, the remat policies, openwebtext_xl
            t_phase = time.perf_counter()
            wide_launches, *_ = wide_main_path(data_dir, card)
            remat_policies(data_dir, card)
            xl_peak, _, xl_losses = xl_remat_pair(data_dir, card)[
                f"remat {load_config('openwebtext_xl').model_config.remat_policy}"]
            print(f"phase 11a-c took {time.perf_counter() - t_phase:.1f} s")
            free_memory()
            clock.mark("11a-c presets")
            lane = join_lane("serving", lanes["serving"], lanes_dir, "5c-11c")
            batch_launches64, batch_launches128 = lane["batch_launches"]
            batch_speeds = {(phase, rows): (rates, busy) for phase, rows, rates, busy in lane["batch_speeds"]}
            by_pool = collections.defaultdict(collections.Counter,
                                              {pool: counters_of(rows) for pool, rows in lane["by_pool"].items()})
            alias_errs = {(getattr(torch, dt), s): err for dt, s, err in lane["alias_errs"]}
            clock.mark("the serving lane's rest (11d, 12-15)")
            sp_reports = sp_ranks.result()  # before 17's ranks need the card's memory
            then = sp_reports[0]["then"]
            pp_reports = pipeline_reports({**{g: then[g][:n21[g]] for g in ("sp2", "sp4")},
                                           "restore": pp_restored.result()})
            ep_reports = {"a_one": then["one"][0], "a_ep2": then["sp2"][n21["sp2"]],
                          "a_fsdp2_ep2": then["sp4"][n21["sp4"]]}
            sp_pool.shutdown()
            # 22a's verdicts, in a thread beside 17's start (this thread waits on 17's ranks there): its run
            # directories are removed before 17-19 write most of theirs
            pair_pool = ThreadPoolExecutor(1)
            pair_verdicts = pair_pool.submit(expert_parallel_pair, card, ep_reports, ep_root)
            clock.mark("phase 20's ranks' rest, 21's and 22's runs among them (beside 5c-11c)")
            # 5, 4b, 5b and 6c(e): the decode lane, beside phases 17-19
            lanes["decode"] = start_lane("decode", lanes_dir)
            # 18. tensor-parallel serving: 4 ranks under torchrun, started here to run beside phase 17
            tp_dir = Path(tempfile.mkdtemp())
            tp_proc, tp_out = start_tp_ranks(tp_dir)
            # 19. tensor-parallel training: its ranks start once 18's have exited, beside phase 17
            tt_root = data_dir / "tp_train"
            tt_root.mkdir()
            with ThreadPoolExecutor(1) as pool19:
                tt_ranks = pool19.submit(tp_training_ranks, data_dir, tt_root, card, tp_proc, [ep["b_ep"]],
                                         tt_root / "xl_done")
                try:
                    # 17. data-parallel and FSDP training: ranks under torchrun (their flash launches join the
                    # kernels line's)
                    dp_flash, pair_losses, (ep_reports["b_one"],) = data_parallel(
                        data_dir, card, main_losses, (xl_losses, xl_peak), tt_root / "pair1", [ep["b_one"]],
                        tt_root / "xl_done")
                    ep_flash = pair_verdicts.result()
                    pair_pool.shutdown()
                    lane = join_lane("decode", lanes["decode"], lanes_dir, "17-19")
                    overlap_rates = {spec: tuple(r) for spec, r in lane["overlap_rates"].items()}
                    busy = lane["busy"]
                    spec_launches_by_run = {run: counters_of(rows) for run, rows in lane["spec_launches"].items()}
                    # 18's verdicts, on phase 5's f32 and 4b's bf16 streams: its ranks' paged launches of bf16
                    # queries join the kernels line's
                    tp_joined = tp_serving(card, tp_proc, tp_out, lane["kernel_streams"], lane["bf16_off_streams"])
                    # 20's verdicts (before 19's, which remove 17a's one-rank pair run): its ranks' flash launches,
                    # causal and full, join the kernels line's
                    sp_flash, sp_full = sequence_parallel(card, sp_reports, sp_root, tt_root / "pair1", pair_losses)
                    # 21's verdicts (also before 19's): its flash launches join the kernels line's
                    pp_flash = pipeline_training(card, pp_reports, pp_root, tt_root / "pair1", pair_losses, main_losses)
                    # 19's verdicts: its ranks' flash launches join the kernels line's
                    tt_reports = tt_ranks.result()
                    (ep_reports["b_ep"],) = tt_reports[0].pop("then")
                    tt_flash = tp_training(card, tt_reports, tt_root, pair_losses, main_losses, main_dir)
                    # 22b's restore on this device, once 19a's group has run 22b's ep 2 run (its verdicts after
                    # phase 16)
                    ep_restored = ep_restore(ep_root, data_dir)
                finally:
                    if tp_proc.poll() is None:
                        tp_proc.kill()
                        tp_proc.wait()
                    shutil.rmtree(tp_dir, ignore_errors=True)
    finally:
        for proc in lanes.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(lanes_dir, ignore_errors=True)
    clock.mark("17-19 ranks (18 and 19 beside 17), 20's, 21's and 22a's verdicts, 22b's restore, the decode lane "
               "beside them")
    # 16. the routed MoE MLP: trained through the launcher, then served (its launches join the kernels line's)
    moe_flash, moe_paged, moe_merges, moe_losses = moe_path(card, overlap_rates["group:4"],
                                                             batch_speeds[("12a", 8)][0])
    print("paged launches of phases 13-15 by pool (the kernels line's paged entries take the bf16 pool's): "
          + "; ".join(f"{pool}: {dict(n)}" for pool, n in by_pool.items()) + f" on {card}")
    front_launches = by_pool["bf16"]

    clock.mark("16 MoE")
    # 22b's restore on one device and its verdicts: phase 16a's losses beside
    for k, c in expert_parallel_main(card, ep_reports, ep_restored, ep_root, moe_losses).items():
        ep_flash[k].update(c)
    clock.mark("22b verdicts")
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
                    "launches": (launches[s] + front_launches[("decode", s)] + moe_paged.get(("decode", s), 0)
                                 + tp_joined[("decode", s)]),
                    "max_abs_err": max(errs[(dt, s)], alias_errs[(dt, s)]),
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
                "launches": spec_launches_by_run[run].get((spec, s), 0) + tp_joined[(spec, s)],
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
        "launches": merge_launches + front_launches[("merge", None)] + moe_merges + tp_joined[("merge", None)],
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
    # wide610m's shape (phase 11a): the C 128 single-visit bodies
    w_label, B, H, T, C, bq, bk = FLASH_WIDE
    wide_ms, wide_plain, wide_lib = time_flash(B, H, T, C, bq, bk)
    free_memory()
    wide_bounds, wide_flops = flash_bounds(B, H, T, C, torch.bfloat16), flash_flops(B, H, T, C)
    wide_errs = flash_errs[(w_label, torch.bfloat16)]
    wide_err = {"flash_fwd": wide_errs["out"], "flash_bwd_dq": wide_errs["dq"],
                "flash_bwd_dkv": max(wide_errs["dk"], wide_errs["dv"])}
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        b_ms, b_by = wide_bounds[kname]
        lib_what = "sdpa forward" if kname == "flash_fwd" else "sdpa backward (dq, dk and dv in one call)"
        print(f"{kname} [single] {w_label} bf16 B={B} H={H} T={T} C={C} blocks=({bq},{bk}): {wide_ms[kname]:.4f} ms "
              f"device ({wide_flops[kname] / wide_ms[kname] / 1e9:.1f} TFLOP/s), bound {b_ms:.4f} ms by {b_by} "
              f"({wide_ms[kname] / b_ms:.1f}x), plain {wide_plain[kname]:.3f} ms, {lib_what} {wide_lib[kname]:.4f} ms "
              f"on {card}")
        kernels.append({
            "name": f"{kname}[bf16,C={C}]",
            "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_SOURCES[kname],
            "launches": (sum(wide_launches[kname].values()) + (batch_launches128 if kname == "flash_fwd" else 0)
                         + sum(dp_flash[128][kname].values()) + sum(sp_flash[128][kname].values())),
            "max_abs_err": wide_err[kname],
            "ms": wide_ms[kname],
            "plain_ms": wide_plain[kname],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": wide_lib[kname],
        })
    for label, B, H, T, C in PREFILL_SHAPES[:5]:  # the batch path's prefills (phase 12)
        ms, plain, sdpa, (b_ms, b_by) = time_flash_forward(B, H, T, C)
        print(f"flash_fwd [single] {label} bf16 B={B} H={H} T={T} C={C}: {ms:.4f} ms device, bound {b_ms:.5f} ms by "
              f"{b_by} ({ms / b_ms:.1f}x), plain {plain:.3f} ms, sdpa forward {sdpa:.4f} ms on {card}")
    free_memory()
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
            "launches": (sum(flash_launches[kname].values()) + (batch_launches64 if kname == "flash_fwd" else 0)
                         + moe_flash[kname] + sum(dp_flash[64][kname].values()) + sum(tt_flash[kname].values())
                         + sum(sp_flash[64][kname].values()) + sum(pp_flash[kname].values())
                         + sum(ep_flash[kname].values())),
            "max_abs_err": err_of[kname],
            "ms": main_ms[kname],
            "plain_ms": main_plain[kname],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": main_lib[kname],
        })
    kernels += full_flash_entries(card, full_errs, sp_full)
    free_memory()
    clock.mark("10 timings")
    print(f"phase wall seconds on {card}: {clock.line()}")
    print(f"{MEMORY.line()} on {card}")
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s (before phase 12: {EARLIER_SMOKE_S} s, before "
          f"phase 13: {EARLIER_SMOKE_PHASE13_S} s, before phase 14: {EARLIER_SMOKE_PHASE14_S} s, before phase 15: "
          f"{EARLIER_SMOKE_PHASE15_S} s, before phase 16: {EARLIER_SMOKE_PHASE16_S} s, before phase 17: "
          f"{EARLIER_SMOKE_PHASE17_S} s, before phase 18: {EARLIER_SMOKE_PHASE18_S} s, before phase 19: "
          f"{EARLIER_SMOKE_PHASE19_S} s, before phase 20: {EARLIER_SMOKE_PHASE20_S} s, before phase 21: "
          f"{EARLIER_SMOKE_PHASE21_S} s) on {card}")
    print(card)  # exactly as nvidia-smi gives it: name, power limit
    decode_modes = {spec: {"decode_tokens_per_s": dec, "end_to_end_tokens_per_s": e2e,
                           "busy_share": busy.get(spec)} for spec, (dec, e2e) in overlap_rates.items()}
    batch_decode = {f"{phase} B={rows}": {"replayed_tokens_per_s": rates["replayed"], "eager_tokens_per_s": rates["eager"],
                                           "replayed_busy_share": busy}
                    for (phase, rows), (rates, busy) in batch_speeds.items()}
    print(json.dumps({"kernels": kernels, "decode_modes": decode_modes, "batch_decode": batch_decode}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException as e:
        if isinstance(e, SystemExit) and e.code in (None, 0):
            raise
        code = e.code if isinstance(e, SystemExit) and isinstance(e.code, int) else 1
        # the failure, then the card's memory beside it, last: a reader of the tail sees both
        if isinstance(e, SystemExit):
            if not isinstance(e.code, int):
                print(e.code, file=sys.stderr)
        else:
            import traceback

            traceback.print_exc()
        if MEMORY is not None:
            print(f"{MEMORY.line()} (the failure at {time.time() - T_START:.1f} s)", file=sys.stderr)
    finally:
        if MEMORY is not None:
            MEMORY.stop()
    sys.exit(code)
