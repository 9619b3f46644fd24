"""Mixed-precision helpers (counterpart of midgpt_tpu/utils/precision.py):
f32 master parameters are cast to the compute dtype for serving; integer
tensors pass through untouched."""

from __future__ import annotations

import typing as tp

import torch


def cast_floating(params: tp.Mapping[str, torch.Tensor], dtype: torch.dtype) -> tp.Dict[str, torch.Tensor]:
    """Cast every floating-point tensor of a parameter dict to `dtype`."""
    return {
        k: v.to(dtype) if torch.is_floating_point(v) else v
        for k, v in params.items()
    }
