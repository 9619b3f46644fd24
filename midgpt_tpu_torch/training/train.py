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
dropout off. Periodic checkpoints, resume, the supervisor, preemption, the
watchdog and the flight recorder are not ported (ROADMAP.md).
"""

from __future__ import annotations

import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.config import ExperimentConfig
from midgpt_tpu_torch.data.dataset import TokenDataset
from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import GPT, Params
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy
from midgpt_tpu_torch.robustness.errors import DivergenceError
from midgpt_tpu_torch.training.metrics import MetricLogger, mfu
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

    def loss_fn(params_c: Params, x: Tensor, y: Tensor, generator) -> Tensor:
        h = GPT.hidden(model_cfg, params_c, x, generator=generator, inference=False)
        return fused_linear_cross_entropy(
            h, params_c["lm_head"], y, config.loss_chunk_tokens, config.loss_remat_chunks
        )

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


def train(config: ExperimentConfig, *, device: DeviceLike = None) -> dict:
    """Run the experiment on one device (CUDA unless told otherwise);
    returns {"params", "opt_state", "metrics"}."""
    dev = resolve_device(device)
    dataset = TokenDataset(config.data_dir, seed=config.data_seed)
    params, opt_state, optimizer = init_state(config, dev)
    schedule = optimizer.schedule
    step, eval_loss_many = make_train_step(config, optimizer)
    print(f"Model has {GPT.count_params(params):,} parameters.")

    logger = MetricLogger("" if config.debug else config.rundir)
    T, G = config.model_config.block_size, config.g_accum_iters
    metrics: tp.Dict[str, float] = {}
    loss = torch.zeros((), dtype=torch.float32, device=dev)  # sticky health carrier
    t_last, tokens_since = time.time(), 0
    try:
        for itr in range(config.max_steps):
            if itr % config.eval_interval == 0:
                metrics["loss/train"] = evaluate(config, eval_loss_many, params, dataset, "train", itr)
                metrics["loss/val"] = evaluate(config, eval_loss_many, params, dataset, "val", itr)
                logger.log(itr, {k: metrics[k] for k in ("loss/train", "loss/val")})
                t_last, tokens_since = time.time(), 0  # eval pauses don't count

            data_itr = itr + config.data_step_offset
            x, y = dataset.batch("train", data_itr, T, config.batch_size, G)
            params, opt_state, loss = step(
                params, opt_state, _tokens(x, dev), _tokens(y, dev),
                _generators(config, data_itr, G, dev), loss,
            )
            tokens_since += config.batch_size * G * T
            if itr % config.log_interval == 0:
                loss_f = float(loss)  # the one host sync per log interval
                if not np.isfinite(loss_f):
                    raise DivergenceError(
                        f"non-finite loss ({loss_f}) at step {itr} — training has "
                        "diverged. No checkpoint was saved (the port keeps none "
                        "during a run). Lower learning_rate or raise warmup_steps.",
                        step=itr,
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

        metrics["loss/final"] = evaluate(config, eval_loss_many, params, dataset, "val", config.max_steps)
        logger.log(config.max_steps, {"loss/val_final": metrics["loss/final"]})
    finally:
        logger.close()
    return {"params": params, "opt_state": opt_state, "metrics": metrics}
