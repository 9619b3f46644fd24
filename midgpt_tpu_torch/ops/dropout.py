"""Dropout from an explicit generator (counterpart of
midgpt_tpu/ops/dropout.py).

JAX draws the keep mask from a threefry key; here it comes from a
`torch.Generator` on the tensor's device that the caller threads through
the model. The two give different bits for the same seed, so the port
matches JAX in distribution only (keep probability 1 - rate, kept values
scaled by 1 / (1 - rate))."""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor


def dropout(
    x: Tensor, rate: float, generator: tp.Optional[torch.Generator], inference: bool = False
) -> Tensor:
    if inference or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout(rate>0, inference=False) requires a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
