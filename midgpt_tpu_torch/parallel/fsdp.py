"""FSDP parameter sharding (counterpart of midgpt_tpu/parallel/fsdp.py:28-93).

The rule is JAX's, copied: every leaf with size > min_size is sharded
along one axis over the mesh's fsdp ranks, everything else (the QK-norm
scales) is replicated. The axis is the last one if the shard count
divides it, else the largest one it divides, and a stacked block leaf
never shards its leading layer axis while another qualifies. The port's
leaves have JAX's shapes (convert.py is a rename), so each leaf shards
on JAX's axis.

A spec here is the sharded axis, or None for a replicated leaf.
`shard` keeps this rank's contiguous slice; `gather` all-gathers it back
along that axis inside autograd, with the reduce-scatter of the gradient
as its backward: the port's form of "the transpose of all_gather is
psum_scatter" (shard_map_fsdp.py:16-19). `reduce_grads` then sums the
gradients over the rest of the mesh: a sharded leaf's over its data
column, a replicated leaf's over every rank.

The collectives are torch.distributed's; none of them stands for a TPU
kernel.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor
Spec = tp.Optional[int]


def _choose_axis(shape: tp.Tuple[int, ...], n_shards: int, skip_leading: bool) -> tp.Optional[int]:
    """Pick the axis to shard: prefer the last, then the largest divisible."""
    ndim = len(shape)
    candidates = [ax for ax in range(ndim - 1, -1, -1) if shape[ax] % n_shards == 0]
    if skip_leading and ndim > 1:
        candidates = [ax for ax in candidates if ax != 0] or candidates
    if not candidates:
        return None
    # Last axis if it qualifies, else the largest.
    if candidates[0] == ndim - 1:
        return ndim - 1
    return max(candidates, key=lambda ax: shape[ax])


def fsdp_leaf_spec(
    shape: tp.Sequence[int],
    n_shards: int,
    shard_model: bool = True,
    min_size: int = 2**18,
    reserved_leading: int = 0,
) -> tp.List[tp.Any]:
    """JAX's per-leaf rule on a leaf's shape: the size gate, then the axis
    choice over the non-reserved axes. Returns the spec list ("fsdp" at
    the sharded axis, None elsewhere)."""
    shape = tuple(shape)
    spec: tp.List[tp.Any] = [None] * len(shape)
    if shard_model and n_shards > 1 and math.prod(shape) > min_size:
        ax = _choose_axis(shape[reserved_leading:], n_shards, skip_leading=reserved_leading == 0)
        if ax is not None:
            spec[ax + reserved_leading] = "fsdp"
    return spec


def param_specs(
    shapes: tp.Mapping[str, tp.Sequence[int]], n_shards: int, shard_model: bool = True, min_size: int = 2**18
) -> tp.Dict[str, Spec]:
    """{leaf: sharded axis or None} for a dict of leaf shapes."""
    out = {}
    for name, shape in shapes.items():
        spec = fsdp_leaf_spec(shape, n_shards, shard_model, min_size)
        out[name] = spec.index("fsdp") if "fsdp" in spec else None
    return out


def shard(t: Tensor, axis: Spec, mesh: Mesh) -> Tensor:
    """This rank's contiguous slice of the full leaf `t` (a copy), or `t`
    itself when the leaf is replicated."""
    if axis is None or mesh.fsdp == 1:
        return t
    return t.chunk(mesh.fsdp, dim=axis)[mesh.fsdp_index].clone()


def _all_gather(t: Tensor, axis: int, mesh: Mesh) -> Tensor:
    """The fsdp row's shards of `t`, concatenated along `axis`."""
    n = mesh.fsdp
    # the shards stacked along a new leading axis, passed flat along dim 0
    # (the layout every backend takes)
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.fsdp_group)
    full = list(t.shape)
    full[axis] *= n
    return out.view(n, *t.shape).movedim(0, axis).reshape(full)


def _reduce_scatter(g: Tensor, axis: int, mesh: Mesh) -> Tensor:
    """Sum of the full gradients `g` over the fsdp row, this rank's slice."""
    n = mesh.fsdp
    shape = list(g.shape)
    shape[axis] //= n
    parts = g.reshape(*g.shape[:axis], n, shape[axis], *g.shape[axis + 1:]).movedim(axis, 0).contiguous()
    out = torch.empty(shape, dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, parts.view(n * shape[0], *shape[1:]), group=mesh.fsdp_group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor, axis: int, mesh: Mesh) -> Tensor:
        ctx.axis, ctx.mesh = axis, mesh
        return _all_gather(t, axis, mesh)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _reduce_scatter(g, ctx.axis, ctx.mesh), None, None


def gather(t: Tensor, axis: Spec, mesh: Mesh) -> Tensor:
    """The full leaf from this rank's shard, differentiable: the backward
    reduce-scatters the full gradient (sum over the fsdp row) into the
    shard's. A replicated leaf passes through."""
    if axis is None or mesh.fsdp == 1:
        return t
    return _Gather.apply(t, axis, mesh)


def reduce_grads(grads: tp.Mapping[str, Tensor], specs: tp.Mapping[str, Spec], mesh: Mesh) -> None:
    """In place: a sharded leaf's gradient (already summed over its fsdp
    row by `gather`'s backward) summed over its data column; a replicated
    leaf's summed over every rank."""
    for name, g in grads.items():
        sharded = specs[name] is not None and mesh.fsdp > 1
        mesh.all_reduce_(g, mesh.data_group if sharded else mesh.group)


def shard_tree(tree: tp.Mapping[str, Tensor], specs: tp.Mapping[str, Spec], mesh: Mesh) -> tp.Dict[str, Tensor]:
    """Every full leaf of `tree` cut to this rank's shard."""
    return {k: shard(v, specs[k], mesh) for k, v in tree.items()}


@torch.no_grad()
def gather_tree(tree: tp.Mapping[str, Tensor], specs: tp.Mapping[str, Spec], mesh: Mesh) -> tp.Dict[str, Tensor]:
    """Every leaf of `tree` whole again (collective over the fsdp row)."""
    return {k: gather(v, specs[k], mesh) for k, v in tree.items()}
