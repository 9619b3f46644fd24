"""Training runtime: the train step and the host-side experiment loop
(counterpart of midgpt_tpu/training/train.py, single device).

Step semantics follow the JAX step (reference train.py:69-97):
  * f32 master parameters, cast to the compute dtype (bf16) once per step;
    gradients are taken with respect to that cast copy;
  * G = g_accum_iters microbatches: each microgradient is cast to f32,
    scaled by 1/G and added to an f32 accumulator (G == 1: cast only);
    the reported loss is the mean of the microlosses;
  * the optimizer chain (training/optim.py) updates the master parameters
    in place, and the loss is folded with the sticky `health_flag`.
PyTorch runs eagerly: the step is a Python function, not one compiled
program. Eval runs `eval_steps` seeded batches at the compute dtype with
dropout off. With `model_config.remat` each block of the training forward
is checkpointed under `remat_policy` (models/gpt.py `GPT.hidden`). Under
`debug`, the first step after the first is traced with torch.profiler
(training/metrics.py `Profiler`), as JAX traces it.

`train` checkpoints and resumes as JAX's does (midgpt_tpu/training/train.py:497-849):
a run with a `rundir` (and not `debug`) resumes from the newest verified
step (training/checkpoint.py), checks the restored state is finite, saves
in the background every `eval_interval` steps after one host check of the
sticky loss, and force-saves the final step. Data and dropout are
positional (`data_step_offset`, `_generators`), so a resumed run continues
the straight run's trajectory.

The robustness hooks sit where JAX puts them (train.py:581-816), and
`robustness/supervisor.py` runs `train` under its restart policy:

  * the loop records `train.eval`, `train.step` and `train.sync` spans and
    lifecycle instants into the process-global flight recorder (obs/).
    CUDA launches are asynchronous, so the step span covers the host's
    enqueue of the step, not its device time, which lands in the next
    `train.sync`;
  * both loss syncs (the log interval's and the check before a save) go
    through `_sync`, which the hung-step watchdog bounds when
    `watchdog_deadline_s > 0` (robustness/watchdog.py);
  * the `nan_grad`, `preempt` and `hang_step` faults (robustness/faults.py)
    strike at their data step;
  * a divergence records a `train.divergence` instant, then raises
    DivergenceError naming the newest verified step;
  * every `preempt_check_interval` steps a requested preemption (SIGTERM,
    SIGINT, the `preempt` fault) makes one emergency save at this step
    boundary — unless the `preempt_grace_s` budget is already spent, when
    the save is skipped loudly — then the loop ends: no final eval, no
    final save, `metrics["preempted"] = True`.
"""

from __future__ import annotations

import threading
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.config import ExperimentConfig
from midgpt_tpu_torch.data.dataset import TokenDataset
from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import GPT, Params, param_shapes
from midgpt_tpu_torch.obs import dump_flight_recorder, flight_recorder
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy
from midgpt_tpu_torch.robustness import faults, preempt
from midgpt_tpu_torch.robustness.errors import DivergenceError
from midgpt_tpu_torch.robustness.watchdog import StepWatchdog
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.metrics import MetricLogger, Profiler, mfu
from midgpt_tpu_torch.training.optim import Optimizer, OptState, make_optimizer

Tensor = torch.Tensor


def health_flag(grads: Params, loss: Tensor, prev_loss: Tensor) -> Tensor:
    """Sticky post-update health, folded into the reported loss: `loss`
    when this step's gradient leaves and loss AND the previous reported
    loss are finite, else NaN. Leaf-wise finiteness (not the global norm,
    which overflows for large finite gradients that clipping handles);
    sticky because the caller threads the previous reported loss back in.
    Stays on the device: no host sync."""
    grads_ok = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
    healthy = grads_ok & torch.isfinite(loss) & torch.isfinite(prev_loss)
    return torch.where(healthy, loss, torch.full_like(loss, float("nan")))


def _generators(config: ExperimentConfig, data_step: int, n: int, device) -> tp.List[tp.Optional[torch.Generator]]:
    """One dropout generator per microstep, a function of (seed, data step,
    microstep) so a replayed step draws the same masks; none without
    dropout."""
    if config.model_config.dropout == 0.0:
        return [None] * n
    seed = (config.seed * 1_000_003 + data_step) * 64
    return [torch.Generator(device=device).manual_seed(seed + g) for g in range(n)]


def make_train_step(
    config: ExperimentConfig, optimizer: Optimizer
) -> tp.Tuple[tp.Callable, tp.Callable]:
    """(step, eval_loss_many).

    step(params, opt_state, x_GBT, y_GBT, generators=None, prev_loss=0.0)
    -> (params, opt_state, loss): one optimizer step over G microbatches of
    int token tensors on the params' device; params are updated in place."""
    model_cfg = config.model_config
    compute_dtype = getattr(torch, config.compute_dtype)
    G = config.g_accum_iters

    # the router's load-balance term (JAX's gate): CE + moe_aux_coef * aux;
    # at a coefficient of 0 the term is never computed and the loss is CE
    use_moe_aux = config.moe_aux_coef != 0.0 and model_cfg.n_experts > 0

    def loss_fn(params_c: Params, x: Tensor, y: Tensor, generator) -> Tensor:
        h = GPT.hidden(model_cfg, params_c, x, generator=generator, inference=False, return_moe_aux=use_moe_aux)
        if use_moe_aux:
            h, aux = h
        ce = fused_linear_cross_entropy(
            h, params_c["lm_head"], y, config.loss_chunk_tokens, config.loss_remat_chunks
        )
        return ce + config.moe_aux_coef * aux if use_moe_aux else ce

    def value_and_grad(params_c: Params, x, y, generator) -> tp.Tuple[Tensor, tp.List[Tensor]]:
        loss = loss_fn(params_c, x, y, generator)
        return loss.detach(), torch.autograd.grad(loss, list(params_c.values()))

    def step(params: Params, opt_state: OptState, x_GBT: Tensor, y_GBT: Tensor,
             generators=None, prev_loss=0.0):
        generators = generators or [None] * G
        names = list(params)
        # the compute-dtype copy: a new leaf (an alias of the master when
        # the compute dtype is the master's own)
        params_c = {k: v.detach().to(compute_dtype).requires_grad_() for k, v in params.items()}
        if G == 1:
            loss, grads = value_and_grad(params_c, x_GBT[0], y_GBT[0], generators[0])
            grad = {k: g.to(params[k].dtype) for k, g in zip(names, grads)}
        else:
            inv_G = 1.0 / G
            grad = {k: torch.zeros_like(v) for k, v in params.items()}
            losses = []
            for g in range(G):
                loss_g, grads = value_and_grad(params_c, x_GBT[g], y_GBT[g], generators[g])
                for k, gr in zip(names, grads):
                    grad[k].add_(gr.to(grad[k].dtype) * inv_G)
                losses.append(loss_g)
            loss = torch.stack(losses).mean()
        opt_state = optimizer.update(grad, opt_state, params)
        prev = torch.as_tensor(prev_loss, dtype=torch.float32, device=loss.device)
        return params, opt_state, health_flag(grad, loss, prev)

    @torch.no_grad()
    def eval_loss(params: Params, x: Tensor, y: Tensor) -> Tensor:
        params_c = {k: v.to(compute_dtype) for k, v in params.items()}
        h = GPT.hidden(model_cfg, params_c, x, inference=True)
        return fused_linear_cross_entropy(
            h, params_c["lm_head"], y, config.loss_chunk_tokens, config.loss_remat_chunks
        )

    @torch.no_grad()
    def eval_loss_many(params: Params, x_NBT: Tensor, y_NBT: Tensor) -> Tensor:
        """SUMMED loss over a stacked (N, B, T) eval set (one division at the
        end of `evaluate`, as in JAX)."""
        total = torch.zeros((), dtype=torch.float32, device=x_NBT.device)
        for x, y in zip(x_NBT, y_NBT):
            total = total + eval_loss(params, x, y)
        return total

    return step, eval_loss_many


def init_state(
    config: ExperimentConfig, device: DeviceLike = None
) -> tp.Tuple[Params, OptState, Optimizer]:
    """Master parameters (GPT.init from config.seed, in param_dtype) and the
    optimizer's zero state. Returns (params, opt_state, optimizer)."""
    dev = resolve_device(device)
    optimizer, _ = make_optimizer(config)
    params = GPT.init(config.model_config, config.seed, device=dev,
                      dtype=getattr(torch, config.param_dtype))
    return params, optimizer.init(params), optimizer


def _tokens(a: np.ndarray, device) -> Tensor:
    return torch.from_numpy(a).to(device=device, dtype=torch.long)


def evaluate(
    config: ExperimentConfig,
    eval_loss_many: tp.Callable,
    params: Params,
    dataset: TokenDataset,
    split: str,
    step_idx: int,
) -> float:
    """Mean eval loss over `eval_steps` batches (1 under debug), drawn in
    chunks of `eval_host_chunk` batches from the same windows a monolithic
    draw would give; one host sync at the end."""
    device = next(iter(params.values())).device
    n = 1 if config.debug else config.eval_steps
    chunk = max(1, min(n, config.eval_host_chunk))
    total = None
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        x, y = dataset.batch(
            split,
            1_000_000_000 + step_idx,  # decorrelated from train batches
            config.model_config.block_size,
            config.batch_size,
            g_accum_iters=n,
            accum_slice=(lo, m),
        )
        part = eval_loss_many(params, _tokens(x, device), _tokens(y, device))
        total = part if total is None else total + part
    return float(total) / n


def state_template(config: ExperimentConfig) -> tp.Dict[str, tp.Any]:
    """The saved state's restore template: the master parameters' and
    Adam moments' shapes and dtype on the `meta` device (no memory)."""
    dtype = getattr(torch, config.param_dtype)
    shapes = param_shapes(config.model_config)
    like = {k: torch.empty(s, dtype=dtype, device="meta") for k, s in shapes.items()}
    return {"params": like, "opt_state": OptState(0, like, like, 0)}


def _all_finite(params: Params, opt_state: OptState) -> bool:
    """One device-side finiteness sweep of params and moments, one sync."""
    leaves = [*params.values(), *opt_state.mu.values(), *opt_state.nu.values()]
    return bool(torch.stack([torch.isfinite(t).all() for t in leaves]).all())


def train(config: ExperimentConfig, *, device: DeviceLike = None) -> dict:
    """Run the experiment on one device (CUDA unless told otherwise);
    returns {"params", "opt_state", "metrics", "resumed_from", "restore_s",
    "checkpoints"} (the resume step or None, the restore's seconds, one
    record per save: CheckpointManager.history)."""
    dev = resolve_device(device)
    dataset = TokenDataset(config.data_dir, seed=config.data_seed)
    optimizer, schedule = make_optimizer(config)
    step, eval_loss_many = make_train_step(config, optimizer)

    mngr = None
    first_step, resume_step, restore_s = 0, None, None
    params = opt_state = None
    if not config.debug and config.rundir:
        mngr = CheckpointManager(
            config.rundir,
            max_to_keep=config.ckpt_max_to_keep,
            save_interval_steps=config.eval_interval,
            write_retries=config.ckpt_write_retries,
            retry_backoff_sec=config.ckpt_retry_backoff_sec,
        )
        resume_step = mngr.latest_verified_step()
        if resume_step is not None:
            t0 = time.perf_counter()
            state = mngr.restore(resume_step, state_template(config), device=dev)
            params, opt_state = state["params"], state["opt_state"]
            restore_s = time.perf_counter() - t0
            # The manifest guards the bytes; this guards the VALUES (a state
            # saved non-finite by other code): once, at resume.
            if not _all_finite(params, opt_state):
                raise FloatingPointError(
                    f"checkpoint step {resume_step} in {config.rundir} restored non-finite "
                    "values — it is corrupt; do not resume from it."
                )
            first_step = resume_step + 1
            print(f"resumed from checkpoint step {resume_step} in {config.rundir} "
                  f"(restored in {restore_s:.2f} s); training from step {first_step}")
    if params is None:
        params, opt_state, _ = init_state(config, dev)
    print(f"Model has {GPT.count_params(params):,} parameters.")

    logger = MetricLogger("" if config.debug else config.rundir)
    profiler = Profiler(config.rundir, enabled=config.debug)
    T, G = config.model_config.block_size, config.g_accum_iters
    metrics: tp.Dict[str, tp.Any] = {}
    loss = torch.zeros((), dtype=torch.float32, device=dev)  # sticky health carrier
    t_last, tokens_since = time.time(), 0
    tr = flight_recorder().tracer
    wd = (
        StepWatchdog(config.watchdog_deadline_s, escalate=config.watchdog_escalate, rundir=config.rundir)
        if config.watchdog_deadline_s > 0
        else None
    )

    def _sync(t: Tensor, itr: int, data_itr: int) -> float:
        """The loop's host<->device force, watchdog-bounded when armed. The
        `hang_step` fault wedges the force itself (an event nothing sets),
        so only the watchdog's worker-thread inversion ends the wait."""
        hang = faults.should_fire("hang_step", step=data_itr)

        def force() -> float:
            if hang:
                threading.Event().wait()
            return float(t)

        with tr.span("train.sync", "train", "train"):
            return force() if wd is None else wd.sync(force, step=itr, label="train.loss_sync")

    def _last_good(itr: int) -> tp.Optional[int]:
        """The newest verified step, recorded with a divergence instant."""
        last_good = mngr.latest_verified_step() if mngr is not None else None
        tr.instant("train.divergence", "train", "train", args={"step": itr, "last_good": last_good})
        return last_good

    saved_at = None  # the step of the newest save this run started
    try:
        for itr in range(first_step, config.max_steps):
            if itr % config.eval_interval == 0:
                with tr.span("train.eval", "train", "train"):
                    metrics["loss/train"] = evaluate(config, eval_loss_many, params, dataset, "train", itr)
                    metrics["loss/val"] = evaluate(config, eval_loss_many, params, dataset, "val", itr)
                logger.log(itr, {k: metrics[k] for k in ("loss/train", "loss/val")})
                t_last, tokens_since = time.time(), 0  # eval pauses don't count

            data_itr = itr + config.data_step_offset
            x, y = dataset.batch("train", data_itr, T, config.batch_size, G)
            profiler.maybe_start(itr, at_step=first_step + 1)
            with tr.span("train.step", "train", "train"):
                params, opt_state, loss = step(
                    params, opt_state, _tokens(x, dev), _tokens(y, dev),
                    _generators(config, data_itr, G, dev), loss,
                )
            profiler.maybe_stop(wait_for=loss)
            if faults.should_fire("nan_grad", step=data_itr):
                # poison the carrier as a NaN gradient would; no sync
                loss = torch.full((), float("nan"), dtype=torch.float32, device=dev)
            if faults.should_fire("preempt", step=data_itr):
                preempt.request()
            tokens_since += config.batch_size * G * T
            if itr % config.log_interval == 0:
                loss_f = _sync(loss, itr, data_itr)  # the one host sync per log interval
                if not np.isfinite(loss_f):
                    last_good = _last_good(itr)
                    raise DivergenceError(
                        f"non-finite loss ({loss_f}) at step {itr} — training has diverged. "
                        "Last good checkpoint: "
                        + (f"step {last_good} in {config.rundir}" if last_good is not None
                           else "none was saved")
                        + ". Lower learning_rate or raise warmup_steps and resume.",
                        step=itr,
                        last_good_step=last_good,
                        rundir=config.rundir,
                    )
                dt = time.time() - t_last
                tok_s = tokens_since / dt if dt > 0 else 0.0
                t_last, tokens_since = time.time(), 0
                metrics.update({
                    "loss/optimized": loss_f,
                    "lr": schedule(itr),
                    "throughput/tokens_per_sec": tok_s,
                })
                m = mfu(tok_s, config.model_config, dev)
                if m is not None:
                    metrics["throughput/mfu"] = m
                logger.log(itr, dict(metrics))
            if mngr is not None and mngr.should_save(itr):
                # One host sync per SAVE interval: never let a poisoned
                # state overwrite the rolling checkpoints.
                if not np.isfinite(_sync(loss, itr, data_itr)):
                    last_good = _last_good(itr)
                    raise DivergenceError(
                        f"non-finite training state at step {itr} — refusing to overwrite the rolling "
                        f"checkpoint. Last good checkpoint: step {last_good} in {config.rundir}. Lower "
                        "learning_rate or raise warmup_steps and resume.",
                        step=itr,
                        last_good_step=last_good,
                        rundir=config.rundir,
                    )
                mngr.save(itr, {"params": params, "opt_state": opt_state})
                saved_at = itr
            if itr % config.preempt_check_interval == 0 and preempt.any_host_requested():
                grace = config.preempt_grace_s
                req_at = preempt.requested_at()
                save_late = bool(grace > 0 and req_at is not None and time.monotonic() - req_at > grace)
                if save_late:
                    # The grace budget was spent before the save could START:
                    # a multi-second write now risks a kill mid-write. Skip
                    # it loudly; resume falls back to the newest verified step.
                    tr.instant("train.preempt_save_skipped", "train", "train",
                               args={"step": itr, "grace_s": grace})
                    if config.rundir:
                        from midgpt_tpu_torch.robustness import supervisor

                        supervisor.append_note(
                            config.rundir, {"event": "preempt_save_skipped", "step": itr, "grace_s": grace}
                        )
                    print(f"preemption: grace budget ({grace:g}s) already spent at step {itr} — skipping "
                          "the emergency save; resume falls back to the last verified checkpoint")
                elif mngr is not None and saved_at != itr and np.isfinite(_sync(loss, itr, data_itr)):
                    mngr.save(itr, {"params": params, "opt_state": opt_state}, force=True)
                if mngr is not None and not save_late:
                    mngr.wait()  # barrier + manifest: verified before the process exits
                metrics["preempted"] = True
                tr.instant("train.preempt", "train", "train", args={"step": itr})
                if config.rundir:
                    dump_flight_recorder(config.rundir)
                if not save_late:
                    print(f"preemption: emergency checkpoint at step {itr} in "
                          f"{config.rundir or '(no rundir)'}; exiting")
                break

        if not metrics.get("preempted"):
            metrics["loss/final"] = evaluate(config, eval_loss_many, params, dataset, "val", config.max_steps)
            logger.log(config.max_steps, {"loss/val_final": metrics["loss/final"]})
            if mngr is not None and first_step < config.max_steps:
                # Force-persist the final state unless the loop's save did, and
                # not if it is poisoned: the sticky loss gates too, since a
                # transient poisoning may leave NaN only in the moments.
                mngr.wait()
                if (
                    mngr.latest_verified_step() != config.max_steps - 1
                    and np.isfinite(metrics["loss/final"])
                    and np.isfinite(float(loss))
                ):
                    mngr.save(config.max_steps - 1, {"params": params, "opt_state": opt_state}, force=True)
    finally:
        # Never abandon an in-flight save: close() joins the writer,
        # raises its error, and garbage-collects.
        logger.close()
        if mngr is not None:
            mngr.close()
    return {
        "params": params, "opt_state": opt_state, "metrics": metrics, "resumed_from": resume_step,
        "restore_s": restore_s, "checkpoints": mngr.history if mngr is not None else [],
    }
