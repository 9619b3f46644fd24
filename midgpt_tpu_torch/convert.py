"""Weight conversion between the JAX package's parameters and the port's.

The JAX `GPTParams` pytree, flattened to `{path: numpy array}` (paths as
`jax.tree_util.keystr` prints them, with or without the leading dot:
"wte", "blocks.attn.wqkv", ...), maps onto the port's parameter dict by
NAME ONLY: the port keeps JAX's leaf names, layouts and stacked leading
layer axis (models/gpt.py `param_names`: the GQA layout adds
"blocks.attn.wkv"), so nothing is transposed or permuted. This module needs
no JAX — the JAX side does the flattening.

The optimizer state travels the same way: `opt_state_to_numpy` /
`opt_state_from_numpy` map the port's `OptState` to `{"mu.<leaf>",
"nu.<leaf>", "adam_count", "schedule_count"}`, and `opt_state_from_optax`
reads the JAX optax chain's state (flattened by the caller as the params
are: "[1].count", "[1].mu.wte", ..., "[3].count"). A checkpoint step
directory of the port (training/checkpoint.py) holds `params.npz` and
`opt_state.npz` in these layouts; `write_step` writes one from numpy, which
is how a JAX run's state reaches the port (README.md).
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import GQA_PARAM_NAMES, PARAM_NAMES, WKV, GPTConfig, Params, param_names
from midgpt_tpu_torch.training.optim import OptState


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


def opt_state_to_numpy(state: OptState) -> tp.Dict[str, np.ndarray]:
    """The port's OptState -> {"mu.<leaf>", "nu.<leaf>": array,
    "adam_count", "schedule_count": 0-d int64}."""
    out = {f"mu.{k}": v for k, v in params_to_numpy(state.mu).items()}
    out.update({f"nu.{k}": v for k, v in params_to_numpy(state.nu).items()})
    out["adam_count"] = np.asarray(state.adam_count, np.int64)
    out["schedule_count"] = np.asarray(state.schedule_count, np.int64)
    return out


def opt_state_from_numpy(
    flat: tp.Mapping[str, np.ndarray],
    *,
    config: tp.Optional[GPTConfig] = None,
    device: DeviceLike = None,
    dtype: tp.Optional[torch.dtype] = None,
) -> OptState:
    """Inverse of `opt_state_to_numpy`; the moments' leaf set is checked as
    `params_from_numpy` checks the parameters'."""
    moments = {
        m: params_from_numpy(
            {k[len(m) + 1:]: v for k, v in flat.items() if k.startswith(m + ".")},
            config=config, device=device, dtype=dtype,
        )
        for m in ("mu", "nu")
    }
    return OptState(int(flat["adam_count"]), moments["mu"], moments["nu"], int(flat["schedule_count"]))


_OPTAX_PATH = re.compile(r"^\[(\d+)\]\.(count|mu|nu)(?:\.(.+))?$")


def opt_state_from_optax(
    flat: tp.Mapping[str, np.ndarray],
    *,
    config: tp.Optional[GPTConfig] = None,
    device: DeviceLike = None,
    dtype: tp.Optional[torch.dtype] = None,
) -> OptState:
    """The JAX chain's state (midgpt_tpu/training/optim.py: clip, Adam,
    decay, schedule, scale), flattened to {keystr path: array}, -> the
    port's OptState. The chain is a tuple whose Adam entry holds (count, mu,
    nu) and whose schedule entry holds a count; the others are empty.
    Entries are told apart by content, so the chain's positions may move."""
    entries: tp.Dict[int, tp.Dict[str, tp.Any]] = {}
    for path, value in flat.items():
        m = _OPTAX_PATH.match(path)
        if m is None:
            raise ValueError(f"{path!r} is not a leaf of the optax chain's state")
        index, field, leaf = int(m.group(1)), m.group(2), m.group(3)
        entry = entries.setdefault(index, {"mu": {}, "nu": {}})
        if field == "count":
            entry["count"] = int(np.asarray(value))
        else:
            entry[field][leaf] = value
    adam = [e for e in entries.values() if e["mu"]]
    schedule = [e for e in entries.values() if not e["mu"] and "count" in e]
    if len(adam) != 1 or len(schedule) != 1:
        raise ValueError(
            f"expected one Adam state and one schedule state, got entries {sorted(entries)}"
        )
    (a,), (sc,) = adam, schedule
    mu, nu = (params_from_numpy(a[m], config=config, device=device, dtype=dtype) for m in ("mu", "nu"))
    return OptState(a["count"], mu, nu, sc["count"])


def write_step(
    rundir: str,
    step: int,
    params: tp.Mapping[str, np.ndarray],
    opt_state: tp.Optional[OptState] = None,
) -> str:
    """Write a verified step directory `rundir/<step>/` of the port's
    checkpoint layout (training/checkpoint.py) from {path: array}
    parameters and, optionally, an OptState; returns its path. The port's
    launcher resumes from it, `sample --ckpt_dir` serves it."""
    from midgpt_tpu_torch.training.checkpoint import write_step_dir

    items = {"params": {_key(k): np.asarray(v) for k, v in params.items()}}
    if opt_state is not None:
        items["opt_state"] = opt_state_to_numpy(opt_state)
    return write_step_dir(rundir, step, items)
