"""Logit warping, token sampling and the sampler's checkpoint restore
(counterpart of those functions of midgpt_tpu/sampling/engine.py; the
contiguous-cache `generate` loop is still to be ported, ROADMAP.md).

torch's generators are not JAX's keys: a seed gives a different stream, so
stochastic sampling matches the JAX package in distribution only. Greedy
(temperature 0) is the first-index argmax in both, token for token.
"""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor


def warp_logits(
    logits: Tensor,  # (..., V) float32
    temperature: float,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
) -> Tensor:
    """Temperature scaling + top-k / nucleus filtering on f32 logits. The
    warped logits DEFINE the sampling distribution. Requires temperature > 0."""
    logits = logits / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        # nucleus: keep the smallest prefix of descending-prob tokens whose
        # cumulative mass reaches top_p (the first token is always kept —
        # its exclusive prefix mass is 0)
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        exclusive_cum = torch.cumsum(probs, dim=-1) - probs
        keep = exclusive_cum < top_p
        threshold = torch.where(keep, sorted_desc, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, float("-inf"), logits)
    return logits


def sample_logits(
    logits: Tensor,  # (B, V) float
    temperature: float = 1.0,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
    generator: tp.Optional[torch.Generator] = None,
) -> Tensor:
    """Temperature + optional top-k / nucleus sampling; 0 = greedy (the
    first index of the maximum). Returns (B,) int64.

    The draw is torch.multinomial's one-sample draw spelled out — the first
    index of the maximum of p / E, E ~ Exp(1) from `generator` (the same
    tokens from the same generator state) — so it has no data-dependent
    check and can be captured in a CUDA graph (sampling/graphs.py)."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1)


def restore_for_sampling(ckpt_dir: str, config, device=None) -> tp.Tuple[tp.Dict[str, Tensor], int]:
    """Restore only the "params" item of the newest verified checkpoint
    step under `ckpt_dir` (training/checkpoint.py) onto `device` (CUDA
    unless told otherwise), in the config's param_dtype. `config` is the
    run's ExperimentConfig. Returns (params, step); prints the step. Raises
    CheckpointCorruptError, naming each step's problems, when steps exist
    but none verifies, and FileNotFoundError when there is no step."""
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.robustness.errors import CheckpointCorruptError
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager
    from midgpt_tpu_torch.training.train import state_template

    mngr = CheckpointManager(ckpt_dir)
    try:
        step = mngr.latest_verified_step()
        if step is None:
            steps = mngr.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoint step under {ckpt_dir}")
            problems = [f"step {s}: {p}" for s in steps for p in mngr.verify(s)]
            raise CheckpointCorruptError(
                f"no verified checkpoint under {ckpt_dir}; refusing to serve any of steps {steps}:\n  "
                + "\n  ".join(problems),
                step=steps[-1],
                problems=problems,
            )
        like = {"params": state_template(config)["params"]}
        params = mngr.restore(step, like, device=resolve_device(device))["params"]
    finally:
        mngr.close()
    print(f"restored checkpoint step {step}")
    return params, step
