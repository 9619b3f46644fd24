"""Tensor parallelism: the Megatron leaf rule (counterpart of
midgpt_tpu/parallel/tp.py, copied).

The GPT block has four projections, and Megatron's schedule falls out of
sharding them over the mesh's 'tp' axis:

  column-parallel (the OUTPUT features shard):
    wqkv  (L, 3 or 1, D, D)  -> (None, None, 'tp', 'fsdp')  whole heads of
        q, k and v each (the explicit leading q/k/v axis)
    wkv   (L, 2, H_kv*C, D)  -> (None, None, 'tp', 'fsdp')  whole K/V heads
    w_up  (L, 4D, D)         -> (None, 'tp', 'fsdp')
  row-parallel (the INPUT features shard; the product is a partial sum):
    wo     (L, D, D)   -> (None, 'fsdp', 'tp')
    w_down (L, D, 4D)  -> (None, 'fsdp', 'tp')

With `vocab_parallel` wte and lm_head shard their vocab axis too; the
routed MLP's expert banks shard their expert axis over 'ep'. FSDP
composes on the leaf's other feature axis. Every other leaf follows the
FSDP rule (parallel/fsdp.py `fsdp_leaf_spec`).

A spec here is a tuple with one entry per axis of the leaf: 'tp',
'fsdp', 'ep' or None (JAX's PartitionSpec, written out to the leaf's
rank). The serving engine reads which leaves are row-parallel to place
its two all-reduces per block (models/gpt.py); the specs are keyed by the
port's flat leaf names (models/gpt.py `param_names`), whose last
component is JAX's field name.
"""

from __future__ import annotations

import math
import typing as tp

from midgpt_tpu_torch.parallel.fsdp import fsdp_leaf_spec

Spec = tp.Tuple[tp.Optional[str], ...]

# leaf field name -> axis (from the end) that shards over 'tp'
_COLUMN_PARALLEL = {"wqkv": 2, "wkv": 2, "w_up": 2}  # output features = axis -2
_ROW_PARALLEL = {"wo": 1, "w_down": 1}  # input features = axis -1
_VOCAB_PARALLEL = {"wte": 2, "lm_head": 2}  # vocab axis = axis -2 of (V, D)
# the routed MLP's banks: the E axis after the stacked layer axis, over 'ep'
_EXPERT_PARALLEL = ("experts_up", "experts_down")


def leaf_name(path: str) -> str:
    """JAX's field name of a flat leaf path ('blocks.attn.wo' -> 'wo')."""
    return path.rsplit(".", 1)[-1]


def megatron_leaf_axes(name: str, shape: tp.Sequence[int], n_tp: int) -> tp.Optional[tp.Tuple[int, int]]:
    """(tp_ax, fsdp_ax) for a Megatron-shardable leaf, or None (not a tp
    leaf, or its tp axis does not divide): tp on the column- or
    row-parallel axis, fsdp on the leaf's other trailing feature axis."""
    off = _COLUMN_PARALLEL.get(name) or _ROW_PARALLEL.get(name)
    ndim = len(shape)
    if off is None or ndim < 2:
        return None
    tp_ax = ndim - off
    if shape[tp_ax] % n_tp != 0:
        return None
    fsdp_ax = ndim - 1 if tp_ax == ndim - 2 else ndim - 2
    return tp_ax, fsdp_ax


def _fsdp_spec(shape, n_fsdp, shard_model, min_size) -> Spec:
    return tuple(fsdp_leaf_spec(shape, n_fsdp, shard_model, min_size))


def tp_leaf_spec(
    path: str,
    shape: tp.Sequence[int],
    axes: tp.Mapping[str, int],
    shard_model: bool = True,
    min_size: int = 2**18,
    vocab_parallel: bool = True,
) -> Spec:
    """JAX's `tp_param_specs` rule for one leaf of the mesh `axes` (sizes
    of 'tp', 'fsdp' and 'ep'); with tp 1 and ep 1 it is the FSDP rule."""
    shape = tuple(shape)
    n_tp, n_fsdp, n_ep = axes["tp"], axes["fsdp"], axes["ep"]
    base = _fsdp_spec(shape, n_fsdp, shard_model, min_size)
    if n_tp == 1 and n_ep == 1:
        return base
    name, ndim, size = leaf_name(path), len(shape), math.prod(shape)
    if n_ep > 1 and name in _EXPERT_PARALLEL:
        if ndim >= 3 and shape[1] % n_ep == 0:
            spec: tp.List[tp.Optional[str]] = [None] * ndim
            spec[1] = "ep"
            if shard_model and n_fsdp > 1 and size > min_size and shape[-1] % n_fsdp == 0:
                spec[-1] = "fsdp"
            return tuple(spec)
        return base
    if n_tp == 1:
        return base
    found = megatron_leaf_axes(name, shape, n_tp)
    if found is None:
        if not (vocab_parallel and name in _VOCAB_PARALLEL):
            return base
        tp_ax = ndim - _VOCAB_PARALLEL[name]
        if ndim < 2 or shape[tp_ax] % n_tp != 0:
            return base
        fsdp_ax = ndim - 1 if tp_ax == ndim - 2 else ndim - 2
    else:
        tp_ax, fsdp_ax = found
    spec = [None] * ndim
    spec[tp_ax] = "tp"
    if shard_model and n_fsdp > 1 and size > min_size and shape[fsdp_ax] % n_fsdp == 0:
        spec[fsdp_ax] = "fsdp"
    return tuple(spec)


def tp_param_specs(
    shapes: tp.Mapping[str, tp.Sequence[int]],
    axes: tp.Mapping[str, int],
    shard_model: bool = True,
    min_size: int = 2**18,
    vocab_parallel: bool = True,
) -> tp.Dict[str, Spec]:
    """{leaf: spec} for a dict of leaf shapes (module docstring)."""
    return {k: tp_leaf_spec(k, s, axes, shard_model, min_size, vocab_parallel) for k, s in shapes.items()}


def tp_axis(spec: Spec) -> tp.Optional[int]:
    """The axis a spec shards over 'tp', or None."""
    return spec.index("tp") if "tp" in spec else None
