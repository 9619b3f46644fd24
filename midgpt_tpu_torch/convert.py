"""Weight conversion between the JAX package's parameters and the port's.

The JAX `GPTParams` pytree, flattened to `{path: numpy array}` (paths as
`jax.tree_util.keystr` prints them, with or without the leading dot:
"wte", "blocks.attn.wqkv", ...), maps onto the port's parameter dict by
NAME ONLY: the port keeps JAX's leaf names, layouts and stacked leading
layer axis (models/gpt.py PARAM_NAMES), so nothing is transposed or
permuted. This module needs no JAX — the JAX side does the flattening.

`params.npz` in a run directory holds the same mapping (written with
`np.savez(path, **flat)`); `load_npz` reads it for
`python -m midgpt_tpu_torch.sample --ckpt_dir`.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import PARAM_NAMES, Params


def _key(path: str) -> str:
    return path[1:] if path.startswith(".") else path


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """A copy: the source may be a read-only view of another framework's buffer."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(
    flat: tp.Mapping[str, np.ndarray],
    *,
    device: DeviceLike = None,
    dtype: tp.Optional[torch.dtype] = None,
) -> Params:
    """{JAX path: array} -> the port's parameter dict (optionally cast)."""
    named = {_key(k): v for k, v in flat.items()}
    extra = sorted(set(named) - set(PARAM_NAMES))
    missing = sorted(set(PARAM_NAMES) - set(named))
    if extra:
        raise NotImplementedError(
            f"parameters {extra} belong to variants not ported yet (GQA's "
            "wkv, MoE experts: ROADMAP.md port queue)"
        )
    if missing:
        raise ValueError(f"missing parameters {missing}")
    dev = resolve_device(device)
    out = {}
    for name in PARAM_NAMES:
        t = _to_tensor(np.asarray(named[name]))
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def params_to_numpy(params: Params) -> tp.Dict[str, np.ndarray]:
    """The port's parameter dict -> {path: numpy array} in the JAX layout.
    bf16 tensors come back as float32 (an exact widening: numpy has no
    bfloat16 of its own)."""
    out = {}
    for name in PARAM_NAMES:
        t = params[name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy()
    return out


def load_npz(
    path: str, *, device: DeviceLike = None, dtype: tp.Optional[torch.dtype] = None
) -> Params:
    with np.load(path) as f:
        return params_from_numpy({k: f[k] for k in f.files}, device=device, dtype=dtype)
