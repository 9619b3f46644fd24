"""Mesh sharding rules for the SERVING engine: tensor-parallel paged decode
over a (data, tp) rank mesh, and the per-role submeshes of disaggregated
prefill/decode (counterpart of midgpt_tpu/parallel/serve_tp.py).

Serving reuses the Megatron leaf rule (parallel/tp.py) with vocab
parallelism off, so wte and lm_head stay whole and every rank computes the
same full-vocab logits, and adds the paged pool: (L, H_kv, P, ps, C) per
tensor, sharded on its K/V-head axis, so each rank of a tp row holds
H_kv/tp heads of every page (under GQA they serve its n_head/tp query
heads, whole query groups). The int8 scales (L, P, H_kv, ps) shard the
same heads at axis 2. Attention is pointwise in heads, so the only
collectives of a decode step are Megatron's two all-reduces a layer,
after the row-parallel wo and w_down (models/gpt.py).

JAX runs a tp engine from one controller: the page table, lengths and
tokens are replicated inputs, and the trie, the allocator and the
scheduler never learn that the mesh exists. The port runs one process
per rank, so every rank of a tp row builds the same ServeEngine and
keeps the same host state; the row's first rank (the leader) takes the
submissions and broadcasts them, with the clock its decisions read, at
every step edge (sampling/serve.py). A rank keeps only its own shard of
the weights (`shard_params`) and of the pool.

`make_serve_mesh` lays `data x tp` ranks out as JAX lays out devices:
row r (ranks [r*tp, (r+1)*tp)) is a role of a disaggregated deployment
(`role_submeshes`, sampling/disagg.py: row 0 prefills, row 1 decodes),
and each row is one tp group. The collectives are torch.distributed's:
NCCL with one rank per card, gloo for ranks that share a card or run on
the CPU (parallel/dist.py).
"""

from __future__ import annotations

import datetime
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.parallel import dist as pdist
from midgpt_tpu_torch.parallel.mesh import Mesh
from midgpt_tpu_torch.parallel.tp import Spec, tp_axis, tp_param_specs

Tensor = torch.Tensor

# PagedKVCache pool layout (L, H_kv, P, ps, C): K/V heads at axis 1.
POOL_SPEC: Spec = (None, "tp", None, None, None)
# int8 scale side buffers (L, P, H_kv, ps): K/V heads at axis 2.
SCALE_SPEC: Spec = (None, None, "tp", None)
# The leaves whose product is a partial sum under tp (row-parallel): the
# all-reduce follows each.
ROW_PARALLEL_LEAVES = ("blocks.attn.wo", "blocks.mlp.w_down")
# Each row-parallel leaf's column-parallel partner: both shard, or neither.
_PARTNERS = {"blocks.attn.wo": ("blocks.attn.wqkv", "blocks.attn.wkv"), "blocks.mlp.w_down": ("blocks.mlp.w_up",)}


class TPDivergenceError(RuntimeError):
    """The ranks of a tp row took different host decisions (their round
    digests differ): raised on every rank of the row in the same round."""


def make_serve_mesh(tp_size: int = 1, data: int = 1, *, ranks: tp.Optional[tp.Sequence[int]] = None,
                    device=None, timeout_s: tp.Optional[float] = None) -> Mesh:
    """A (data, tp) serving mesh over the first data*tp ranks of the
    process group (or `ranks`). Collective: every rank of the process
    group calls it, members or not. `timeout_s` bounds each collective of
    the mesh (a rank that stops answering raises there instead of
    hanging its row)."""
    n = data * tp_size
    pool = sorted(ranks if ranks is not None else range(pdist.world()))
    if n > len(pool):
        raise ValueError(f"serve mesh data={data} x tp={tp_size} needs {n} ranks, have {len(pool)}")
    shape = {"data": data, "fsdp": 1, "sp": 1, "tp": tp_size, "pp": 1, "ep": 1}
    timeout = None if timeout_s is None else datetime.timedelta(seconds=timeout_s)
    return Mesh(shape, pool[:n], torch.device(device) if device is not None else pdist.rank_device(), timeout)


def role_submeshes(mesh: Mesh) -> tp.List[Mesh]:
    """One (data 1, tp) mesh per data row of `mesh`: the role meshes of a
    disaggregated deployment, row 0 the prefill role (sampling/disagg.py)."""
    return [mesh.row(r) for r in range(mesh.data)]


def serve_param_specs(shapes: tp.Mapping[str, tp.Sequence[int]], tp_size: int) -> tp.Dict[str, Spec]:
    """Megatron tp specs for a serving engine's leaves: the training rule
    with vocab_parallel off and no size gate, as JAX's."""
    axes = {"tp": tp_size, "fsdp": 1, "ep": 1}
    return tp_param_specs(shapes, axes, shard_model=True, min_size=0, vocab_parallel=False)


def serve_cache_specs(quantized: bool) -> tp.Dict[str, Spec]:
    """The pool's specs, keyed as PagedKVCache's tensors (int8 pools:
    the scales too)."""
    specs = {"k": POOL_SPEC, "v": POOL_SPEC}
    if quantized:
        specs.update(k_scale=SCALE_SPEC, v_scale=SCALE_SPEC)
    return specs


def mesh_shape(mesh: tp.Optional[Mesh]) -> tp.Optional[tp.Dict[str, int]]:
    """{'data': d, 'tp': t} for stats()/JSON reporting, None unsharded."""
    if mesh is None:
        return None
    return {"data": int(mesh.shape["data"]), "tp": int(mesh.shape["tp"])}


def shard_leaf(t: tp.Union[Tensor, np.ndarray], spec: Spec, tp_size: int, tp_index: int) -> Tensor:
    """Shard `tp_index` of a whole leaf (a torch tensor, or a numpy array
    as convert.py's JAX-layout dicts hold them): the contiguous slice on
    the spec's tp axis, a copy; the leaf itself when it is replicated (a
    numpy leaf is always copied: the engine writes its weights in place)."""
    t = torch.tensor(t) if isinstance(t, np.ndarray) else t
    ax = tp_axis(spec)
    if ax is None or tp_size == 1:
        return t
    return t.chunk(tp_size, dim=ax)[tp_index].clone()


def shard_params(params: tp.Mapping[str, tp.Union[Tensor, np.ndarray]], tp_size: int, tp_index: int,
                 specs: tp.Optional[tp.Mapping[str, Spec]] = None) -> tp.Dict[str, Tensor]:
    """This rank's shard of every leaf of whole parameters (torch tensors,
    or the numpy arrays of JAX-layout parameters, convert.py)."""
    specs = specs or serve_param_specs({k: tuple(v.shape) for k, v in params.items()}, tp_size)
    return {k: shard_leaf(v, specs[k], tp_size, tp_index) for k, v in params.items()}


class TPShard:
    """What the model's paged forwards need of a tp row: which products
    are partial sums (the row-parallel leaves the specs shard) and the
    all-reduce over the row. The checks are JAX's layout rules read from
    the specs: a row-parallel leaf shards iff its column partner does, so
    a block never sums a replicated product or mixes local and whole
    heads. The routed MLP's banks are not tp leaves: its output is whole on
    every rank and is not summed."""

    def __init__(self, mesh: Mesh, specs: tp.Mapping[str, Spec]):
        self.mesh = mesh
        self.size = mesh.tp
        self.specs = dict(specs)
        self.reduced = frozenset(k for k in ROW_PARALLEL_LEAVES if k in specs and tp_axis(specs[k]) is not None)
        for row, partners in _PARTNERS.items():
            if row not in specs:
                continue
            for col in partners:
                if col in specs and (tp_axis(specs[col]) is not None) != (row in self.reduced):
                    raise ValueError(f"tp layout: {col} and {row} must shard together (specs {specs[col]}, "
                                     f"{specs[row]})")

    def copy(self, x: Tensor) -> Tensor:
        """Megatron's f before a column-parallel product: the identity,
        since the serving forwards record no gradient (the interface of
        parallel/tp.py TPTrain, so that a block takes either)."""
        return x

    def reduce(self, name: str, t: Tensor) -> Tensor:
        """Sum the partial product of leaf `name` over the row, in place
        (nothing saves it for a backward), when the leaf is row-parallel;
        else `t` as it is."""
        return self.mesh.psum_tp(t) if name in self.reduced else t

    def shard(self, params: tp.Mapping[str, tp.Union[Tensor, np.ndarray]]) -> tp.Dict[str, Tensor]:
        """This rank's shard of whole parameters of the same layout."""
        return shard_params(params, self.size, self.mesh.tp_index, self.specs)

    def whole(self, shards: tp.Mapping[str, Tensor]) -> tp.Dict[str, Tensor]:
        """Meta tensors of the whole leaves' shapes and dtypes (a hot
        swap's candidate is checked against these before it is cut)."""
        out = {}
        for k, t in shards.items():
            shape, ax = list(t.shape), tp_axis(self.specs[k])
            if ax is not None:
                shape[ax] *= self.size
            out[k] = torch.empty(shape, dtype=t.dtype, device="meta")
        return out
