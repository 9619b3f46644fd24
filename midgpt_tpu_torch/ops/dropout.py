"""Dropout from an explicit generator (counterpart of
midgpt_tpu/ops/dropout.py).

JAX draws the keep mask from a threefry key; here it comes from a
`torch.Generator` on the tensor's device that the caller threads through
the model. The two give different bits for the same seed, so the port
matches JAX in distribution only (keep probability 1 - rate, kept values
scaled by 1 / (1 - rate)).

`shard=(dim, i, n)` draws the mask of the whole tensor, `n` times x's
size on `dim`, and keeps its i-th slice there: a tensor-parallel rank
holding shard i of n draws the bits one device would draw for that part,
and its generator advances as the other ranks' do (parallel/tp.py)."""

from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor


def dropout(
    x: Tensor, rate: float, generator: tp.Optional[torch.Generator], inference: bool = False,
    shard: tp.Optional[tp.Tuple[int, int, int]] = None,
) -> Tensor:
    if inference or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout(rate>0, inference=False) requires a generator")
    keep = 1.0 - rate
    shape = list(x.shape)
    if shard is not None:
        dim, i, n = shard
        shape[dim] *= n
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(dim, i * x.shape[dim], x.shape[dim])
    return torch.where(mask, x / keep, torch.zeros_like(x))
