"""Weight conversion between the JAX package's parameters and the port's.

The JAX `GPTParams` pytree, flattened to `{path: numpy array}` (paths as
`jax.tree_util.keystr` prints them, with or without the leading dot:
"wte", "blocks.attn.wqkv", ...), maps onto the port's parameter dict by
NAME ONLY: the port keeps JAX's leaf names, layouts and stacked leading
layer axis (models/gpt.py `param_names`: the GQA layout adds
"blocks.attn.wkv"), so nothing is transposed or permuted. This module needs
no JAX — the JAX side does the flattening.

`params.npz` in a run directory holds the same mapping (written with
`np.savez(path, **flat)`); `load_npz` reads it for
`python -m midgpt_tpu_torch.sample --ckpt_dir`.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import GQA_PARAM_NAMES, PARAM_NAMES, WKV, GPTConfig, Params, param_names


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
    config: tp.Optional[GPTConfig] = None,
    device: DeviceLike = None,
    dtype: tp.Optional[torch.dtype] = None,
) -> Params:
    """{JAX path: array} -> the port's parameter dict (optionally cast).
    The leaf set is `config`'s (`param_names`); without a config, the GQA
    layout is read off the presence of wkv. Leaves of variants the port
    does not compute (the MoE experts) are refused."""
    named = {_key(k): v for k, v in flat.items()}
    if config is not None:
        names = param_names(config)
    else:
        names = GQA_PARAM_NAMES if WKV in named else PARAM_NAMES
    extra = sorted(set(named) - set(names))
    missing = sorted(set(names) - set(named))
    moe = [n for n in extra if n.startswith("blocks.mlp.")]
    if moe:
        raise NotImplementedError(
            f"parameters {moe} belong to the routed MoE MLP, a variant not ported "
            "yet (ROADMAP.md port queue)"
        )
    if extra or missing:
        raise ValueError(f"parameters do not fit the config's layout: extra {extra}, missing {missing}")
    dev = resolve_device(device)
    out = {}
    for name in names:
        t = _to_tensor(np.asarray(named[name]))
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def params_to_numpy(params: Params) -> tp.Dict[str, np.ndarray]:
    """The port's parameter dict -> {path: numpy array} in the JAX layout.
    bf16 tensors come back as float32 (an exact widening: numpy has no
    bfloat16 of its own)."""
    out = {}
    for name in params:
        t = params[name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy()
    return out


def load_npz(
    path: str,
    *,
    config: tp.Optional[GPTConfig] = None,
    device: DeviceLike = None,
    dtype: tp.Optional[torch.dtype] = None,
) -> Params:
    with np.load(path) as f:
        return params_from_numpy({k: f[k] for k in f.files}, config=config, device=device, dtype=dtype)
