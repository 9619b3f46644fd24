"""Optimizer: AdamW with *independent* (LR-decoupled) weight decay, the
optax chain of midgpt_tpu/training/optim.py written out in PyTorch
(not torch.optim.AdamW, whose decay and bias correction differ):

    clip_by_global_norm(1.0) -> scale_by_adam(b1=0.9, b2, eps=1e-8,
    eps_root=0) -> add_decayed_weights(weight_decay / learning_rate) ->
    scale_by_schedule(warmup_cosine_decay) -> scale(-1)

What optax does, kept here:
  * clipping is `where(norm < 1, g, g / norm)` with the global norm over
    every leaf (over FSDP shards: `global_norm`, one all-reduce);
  * Adam's moments are updated, then bias-corrected with the INCREMENTED
    count (count + 1), `m_hat / (sqrt(v_hat) + eps)`;
  * the schedule is read at the schedule state's count BEFORE it is
    incremented, and `warmup_cosine_decay_schedule(init_value=0)` gives 0
    at count 0: the first step moves no parameter, weight decay included;
  * `decay_steps` counts the warmup (the cosine runs for decay - warmup).
Decay applies to every parameter, as in the reference. Moments and the
update are f32 like the master parameters, updated in place.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch

from midgpt_tpu_torch.parallel.fsdp import ep_axis, fsdp_axis, pp_axis, tp_axis

Tensor = torch.Tensor
Params = tp.Dict[str, Tensor]


def make_schedule(config) -> tp.Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=lr,
    warmup_steps, decay_steps=lr_decay_steps, end_value=min_lr)."""
    peak, warmup = config.learning_rate, config.warmup_steps
    decay = config.lr_decay_steps - warmup
    alpha = 0.0 if peak == 0.0 else config.min_lr / peak
    if decay <= 0:
        raise ValueError(
            f"lr_decay_steps={config.lr_decay_steps} must exceed warmup_steps={warmup} "
            "(the cosine_decay_schedule requires positive decay_steps)"
        )

    def schedule(count: int) -> float:
        if count < warmup:  # linear_schedule(0 -> peak over warmup steps)
            return peak * (count / warmup) if warmup > 0 else 0.0
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class OptState:
    """The chain's state: Adam's (count, mu, nu) and the schedule's count
    (optax's ScaleByAdamState and ScaleByScheduleState)."""

    adam_count: int
    mu: Params
    nu: Params
    schedule_count: int


def global_norm(grads: Params, specs=None, mesh=None) -> Tensor:
    """optax.global_norm: the f32 square root of the sum of every leaf's
    squares. Over a mesh's shards (`specs` on `mesh`, parallel/fsdp.py:
    the sharded axis, or a spec with 'tp', 'fsdp', 'pp' and 'ep') each
    distinct part of a leaf counts once: a rank adds the squares of a leaf
    it shards over fsdp, tp, pp or ep, and of one it holds whole only at
    fsdp, tp, pp and ep index 0 (at data and sp index 0: the reduced
    gradient is the same there); one all-reduce over the mesh then gives
    every rank the norm of the whole gradient, bit for bit the same. Under
    the pipeline every stage's block shards count (its own layers), under
    ep every rank's experts, the leaves every stage or ep rank holds whole
    once."""
    sq = lambda g: (g.float() ** 2).sum()  # noqa: E731
    if mesh is None or mesh.size == 1 or (mesh.fsdp == 1 and mesh.tp == 1 and mesh.pp == 1 and mesh.ep == 1):
        return torch.sqrt(sum(sq(g) for g in grads.values()))

    def counts(k: str) -> bool:
        on = lambda axis, n: axis(specs[k]) is not None and n > 1  # noqa: E731
        return ((on(tp_axis, mesh.tp) or mesh.tp_index == 0) and (on(fsdp_axis, mesh.fsdp) or mesh.fsdp_index == 0)
                and (on(pp_axis, mesh.pp) or mesh.pp_index == 0) and (on(ep_axis, mesh.ep) or mesh.ep_index == 0))

    total = sum(sq(g) for k, g in grads.items() if counts(k))
    total = torch.as_tensor(total, dtype=torch.float32, device=next(iter(grads.values())).device)
    if mesh.data_index != 0 or mesh.sp_index != 0:
        total = torch.zeros_like(total)
    return torch.sqrt(mesh.all_reduce_(total, mesh.group))


class Optimizer:
    """The chain as one object: `init(params)` and an in-place
    `update(grads, state, params)` that applies the step to `params`."""

    def __init__(self, config):
        self.b1, self.b2, self.eps = 0.9, config.beta2, 1e-8
        self.decay = config.weight_decay / config.learning_rate
        self.schedule = make_schedule(config)

    def init(self, params: Params) -> OptState:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        return OptState(adam_count=0, mu=zeros(), nu=zeros(), schedule_count=0)

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params, norm: tp.Optional[Tensor] = None) -> OptState:
        """One step of the chain; `params` and the state's moments are
        updated in place. Returns the new state. `norm` is the gradients'
        global norm when they are shards (`global_norm`); by default it is
        taken over `grads`."""
        if norm is None:
            norm = global_norm(grads)
        keep = norm < 1.0
        count = state.adam_count + 1
        bc1, bc2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        lr = self.schedule(state.schedule_count)
        for name, p in params.items():
            g = torch.where(keep, grads[name], grads[name] / norm)
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)  # (1 - b1) g + b1 mu
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.decay * p
            p.sub_(lr * update)
        return OptState(count, state.mu, state.nu, state.schedule_count + 1)


def make_optimizer(config) -> tp.Tuple[Optimizer, tp.Callable[[int], float]]:
    opt = Optimizer(config)
    return opt, opt.schedule


def opt_step_count(opt_state: OptState) -> int:
    """The schedule step of a chain state (the JAX package reads the
    ScaleByScheduleState's count)."""
    return opt_state.schedule_count
