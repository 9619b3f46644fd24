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
component is JAX's field name. The training state's specs are this rule
at the config's shard_model, fsdp_min_size and tp_vocab
(training/train.py `state_specs`).

Training (`TPTrain`) writes down the collectives GSPMD places for JAX.
Megatron's pair, both out of place so that autograd can save what they
return:

  f (`copy`)    identity forward, all-reduce of the gradient over the tp
                row backward: before each column-parallel product (the
                QKV and w_up products read the replicated stream);
  g (`reduce`)  all-reduce forward, identity backward: after each
                row-parallel product (wo, w_down), whose outputs are
                partial sums.

With tp_vocab the embedding is a masked local gather of the rank's V/tp
rows followed by g (`embed`: each token's row is on one rank, the others
add zeros), and the loss is the vocab-parallel fused CE
(ops/loss.py `fused_linear_cross_entropy` on the row's group). Every tp rank then holds the
residual stream whole and identical; the routed MLP's banks are not tp
leaves and run whole on every rank. The gradient of a leaf the row holds
whole is whole on every rank, except for the QK-norm scales
(`HEAD_REGION_LEAVES`), which act on the rank's heads only: their
gradients are summed over the row (parallel/fsdp.py `reduce_grads`).

Expert parallelism (`EPTrain`) is what GSPMD makes of JAX's masked-dense
routed MLP when its banks shard their expert axis over 'ep'
(midgpt_tpu/models/gpt.py MoEParams): each rank of an ep group holds
n_experts/ep experts and runs them on every token of its rows, with the
gates of its experts; the combine's contraction over the experts becomes
a sum over the group. The router runs whole on every ep rank, so the
gates and the load-balance term are the same on each. The same pair of
collectives, over the ep group:

  f (`copy`)    on the normed stream h and on the gates, before the
                rank takes its experts' columns: each rank's backward
                sees only its experts' share of the gradient into h and
                into the gates, and f sums the shares over the group, so
                the router and everything upstream get their whole
                gradient on every ep rank, once;
  g (`reduce`)  on the combine, before the residual add.

Every ep rank then holds the same residual stream, loss and aux term:
the loss is counted once per ep group (training/train.py), and no
gradient is summed over ep again (parallel/fsdp.py `reduce_grads`).
`EP_TRAFFIC` counts this process's all-reduces over ep groups ("calls")
and their bytes ("bytes").
"""

from __future__ import annotations

import collections
import math
import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.parallel.fsdp import fsdp_leaf_spec, tp_axis

Spec = tp.Tuple[tp.Optional[str], ...]

# leaf field name -> axis (from the end) that shards over 'tp'
_COLUMN_PARALLEL = {"wqkv": 2, "wkv": 2, "w_up": 2}  # output features = axis -2
_ROW_PARALLEL = {"wo": 1, "w_down": 1}  # input features = axis -1
_VOCAB_PARALLEL = {"wte": 2, "lm_head": 2}  # vocab axis = axis -2 of (V, D)
# the routed MLP's banks: the E axis after the stacked layer axis, over 'ep'
_EXPERT_PARALLEL = ("experts_up", "experts_down")
_TRAIN_EP_LEAVES = ("blocks.mlp.experts_up", "blocks.mlp.experts_down")
EP_TRAFFIC: tp.Counter[str] = collections.Counter()  # all-reduces over ep groups and their bytes, this process's


def _count(traffic: tp.Optional[tp.Counter[str]], t: torch.Tensor) -> None:
    if traffic is not None:
        traffic["calls"] += 1
        traffic["bytes"] += t.numel() * t.element_size()
# leaves a tp row holds whole but applies to its own heads only: each
# rank's gradient is its heads' share (module docstring)
HEAD_REGION_LEAVES = ("blocks.attn.q_scale", "blocks.attn.k_scale")
# the block leaves a training tp row must shard (Megatron's four products)
_TRAIN_TP_LEAVES = ("blocks.attn.wqkv", "blocks.attn.wkv", "blocks.attn.wo", "blocks.mlp.w_up",
                    "blocks.mlp.w_down")


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


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the tp row
    (or an ep group; `traffic` counts the all-reduce)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, traffic=None) -> torch.Tensor:
        ctx.group, ctx.traffic = group, traffic
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        _count(ctx.traffic, g)
        return g, None, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: the partial sums summed over the tp row (or an ep
    group; `traffic` counts the all-reduce) into a new tensor, identity
    backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, traffic=None) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, group=group)
        _count(traffic, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None


class TPTrain:
    """What the training forward needs of a rank's tp row (module
    docstring): its group, size and place, whether the vocab is sharded
    (read from the specs), and Megatron's collectives. The checks are JAX's
    layout read from the specs: the four block products shard over tp."""

    def __init__(self, mesh, specs: tp.Mapping[str, Spec]):
        self.group, self.size, self.index = mesh.tp_group, mesh.tp, mesh.tp_index
        for name in _TRAIN_TP_LEAVES:
            if name in specs and tp_axis(specs[name]) is None:
                raise ValueError(f"tp={self.size}: {name} does not shard over tp (spec {specs[name]}); the "
                                 "training forward needs all four Megatron products sharded")
        self.vocab = tp_axis(specs["wte"]) is not None
        if self.vocab != (tp_axis(specs["lm_head"]) is not None):
            raise ValueError(f"tp layout: wte and lm_head must shard together (specs {specs['wte']}, "
                             f"{specs['lm_head']})")

    @property
    def heads(self) -> tp.Tuple[int, int]:
        """(this rank's place, the row's size): the shard of the heads it
        holds (attention-probability dropout draws the row's masks)."""
        return self.index, self.size

    @property
    def vocab_row(self) -> tp.Tuple[tp.Any, int]:
        """(group, index) of the fused CE (ops/loss.py): the row when the
        vocab is sharded, else (None, 0) (the whole head)."""
        return (self.group, self.index) if self.vocab else (None, 0)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """f: before a column-parallel product."""
        return _CopyToTP.apply(x, self.group)

    def reduce(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """g: after the row-parallel product of leaf `name` (every
        row-parallel leaf shards in training, as `__init__` checks; the
        serving TPShard has the same interface)."""
        return _ReduceFromTP.apply(x, self.group)

    def embed(self, wte: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding from this rank's V/tp rows of wte: each
        token's row where this rank holds it, zeros elsewhere, summed over
        the row (exact: one term is not zero)."""
        rows = wte.shape[0]
        local = tokens - self.index * rows
        inside = (local >= 0) & (local < rows)
        e = wte[local.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0.0)
        return _ReduceFromTP.apply(e, self.group)


class EPTrain:
    """What the training forward needs of a rank's ep group (module
    docstring): its group, size and place, and the f/g pair over it. The
    check is JAX's layout read from the specs: both banks shard their
    expert axis over ep."""

    def __init__(self, mesh, specs: tp.Mapping[str, Spec]):
        self.group, self.size, self.index = mesh.ep_group, mesh.ep, mesh.ep_index
        for name in _TRAIN_EP_LEAVES:
            spec = specs.get(name)
            if spec is None or len(spec) < 2 or spec[1] != "ep":
                raise ValueError(f"ep={self.size}: {name} does not shard its expert axis over ep (spec {spec}); the "
                                 "expert-parallel forward needs both banks sharded")

    def experts(self, n_local: int) -> slice:
        """This rank's columns of the (..., n_experts) gates, for its
        `n_local` experts."""
        return slice(self.index * n_local, (self.index + 1) * n_local)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """f: before the rank's experts read `x` (the stream, the gates)."""
        return _CopyToTP.apply(x, self.group, EP_TRAFFIC)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """g: the rank's partial combine summed over the group."""
        return _ReduceFromTP.apply(x, self.group, EP_TRAFFIC)
