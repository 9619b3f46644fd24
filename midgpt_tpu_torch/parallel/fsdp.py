"""FSDP parameter sharding (counterpart of midgpt_tpu/parallel/fsdp.py:28-93).

The rule is JAX's, copied: every leaf with size > min_size is sharded
along one axis over the mesh's fsdp ranks, everything else (the QK-norm
scales) is replicated. The axis is the last one if the shard count
divides it, else the largest one it divides, and a stacked block leaf
never shards its leading layer axis while another qualifies. The port's
leaves have JAX's shapes (convert.py is a rename), so each leaf shards
on JAX's axis.

A spec here is the sharded axis or None (`param_specs`, the FSDP rule
alone), or a tuple with one entry per axis of the leaf, 'fsdp', 'tp',
'pp', 'ep' or None (the training state's specs, parallel/tp.py
`tp_leaf_spec`: a leaf may carry tp on one axis and fsdp on another, as
wqkv's (None, None, 'tp', 'fsdp'), and the routed MLP's banks their
expert axis over 'ep', as experts_up's (None, 'ep', None, 'fsdp'); under
the pipeline a block leaf's layer axis is 'pp', parallel/pipeline.py
`pipeline_param_specs`). `shard` keeps this rank's contiguous slice on
every sharded axis;
`gather` all-gathers the fsdp axis back inside autograd, with the
reduce-scatter of the gradient as its backward: the port's form of "the
transpose of all_gather is psum_scatter" (shard_map_fsdp.py:16-19). The
tp shard stays on its rank through the step (the model's forward is
written for it); `gather_tp` gathers it (`whole_tree`: both axes), for
checkpoints and tests, `gather_pp` the layer axis over the stages and
`gather_ep` the expert axis over the ep group (`whole_tree`: every
axis). The ep shard, like the tp shard, stays on its rank through the
step (parallel/tp.py `EPTrain`).
`reduce_grads` then sums each gradient over the ranks that saw other
batch rows or other sequence shards (and, for the leaves a tp row applies
to its own heads only, over the row; for the leaves every stage holds
whole, over the stages; never over ep).

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
Spec = tp.Union[None, int, tp.Tuple[tp.Optional[str], ...]]


def fsdp_axis(spec: Spec) -> tp.Optional[int]:
    """The axis a spec shards over fsdp, or None."""
    if isinstance(spec, tuple):
        return spec.index("fsdp") if "fsdp" in spec else None
    return spec


def tp_axis(spec: Spec) -> tp.Optional[int]:
    """The axis a spec shards over tp, or None."""
    return spec.index("tp") if isinstance(spec, tuple) and "tp" in spec else None


def pp_axis(spec: Spec) -> tp.Optional[int]:
    """The axis a spec shards over pp (a block leaf's layer axis), or None."""
    return spec.index("pp") if isinstance(spec, tuple) and "pp" in spec else None


def ep_axis(spec: Spec) -> tp.Optional[int]:
    """The axis a spec shards over ep (a bank's expert axis), or None."""
    return spec.index("ep") if isinstance(spec, tuple) and "ep" in spec else None


def shard_extent(spec: Spec, mesh) -> tp.Dict[int, tp.Tuple[int, int]]:
    """{axis: (shard count, this rank's place)} for each axis `spec` shards
    on `mesh` (reads only the mesh's axis sizes and indices; a mesh
    without an ep axis has ep 1)."""
    out = {}
    for ax, n, i in ((pp_axis(spec), mesh.pp, mesh.pp_index), (tp_axis(spec), mesh.tp, mesh.tp_index),
                     (fsdp_axis(spec), mesh.fsdp, mesh.fsdp_index),
                     (ep_axis(spec), getattr(mesh, "ep", 1), getattr(mesh, "ep_index", 0))):
        if ax is not None and n > 1:
            out[ax] = (n, i)
    return out


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


def shard(t: Tensor, spec: Spec, mesh: Mesh) -> Tensor:
    """This rank's contiguous slice of the full leaf `t` on its pp, tp,
    fsdp and ep axes (a copy), or `t` itself when the leaf is replicated."""
    cut = t
    for ax, (n, i) in shard_extent(spec, mesh).items():
        cut = cut.chunk(n, dim=ax)[i]
    return t if cut is t else cut.clone()


def _all_gather(t: Tensor, axis: int, n: int, group) -> Tensor:
    """The `n` shards of `t` over `group`, concatenated along `axis`."""
    # the shards stacked along a new leading axis, passed flat along dim 0
    # (the layout every backend takes)
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
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
        return _all_gather(t, axis, mesh.fsdp, mesh.fsdp_group)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _reduce_scatter(g, ctx.axis, ctx.mesh), None, None


def gather(t: Tensor, spec: Spec, mesh: Mesh) -> Tensor:
    """The leaf whole on its fsdp axis from this rank's shard (its tp
    shard, under tp), differentiable: the backward reduce-scatters the
    gradient (sum over the fsdp row) into the shard's. A leaf not sharded
    over fsdp passes through."""
    axis = fsdp_axis(spec)
    if axis is None or mesh.fsdp == 1:
        return t
    return _Gather.apply(t, axis, mesh)


@torch.no_grad()
def gather_tp(t: Tensor, spec: Spec, mesh: Mesh) -> Tensor:
    """The leaf whole on its tp axis from the tp row's shards (collective
    over the row); a leaf not sharded over tp passes through."""
    axis = tp_axis(spec)
    if axis is None or mesh.tp == 1:
        return t
    return _all_gather(t, axis, mesh.tp, mesh.tp_group)


@torch.no_grad()
def gather_pp(t: Tensor, spec: Spec, mesh: Mesh) -> Tensor:
    """The leaf whole on its layer axis from the stages' shards (collective
    over the pp group); a leaf not sharded over pp passes through."""
    axis = pp_axis(spec)
    if axis is None or mesh.pp == 1:
        return t
    return _all_gather(t, axis, mesh.pp, mesh.pp_group)


@torch.no_grad()
def gather_ep(t: Tensor, spec: Spec, mesh: Mesh) -> Tensor:
    """The leaf whole on its expert axis from the ep group's shards
    (collective over the group); a leaf not sharded over ep passes
    through."""
    axis = ep_axis(spec)
    if axis is None or mesh.ep == 1:
        return t
    return _all_gather(t, axis, mesh.ep, mesh.ep_group)


def reduce_grads(grads: tp.Mapping[str, Tensor], specs: tp.Mapping[str, Spec], mesh: Mesh,
                 tp_partial: tp.Collection[str] = ()) -> None:
    """In place, each gradient summed over the ranks whose tokens it has
    not seen (other batch rows, other sequence shards: every leaf is
    replicated over sp): a leaf sharded over fsdp (its gradient already
    summed over the fsdp row by `gather`'s backward) over its replica group
    (data x sp), any other leaf over the batch group (the ranks of its tp
    index; a leaf the tp row holds whole has its whole gradient on every
    rank of the row, which must not be summed again). A leaf of
    `tp_partial` holds only its rank's heads' share, so it is summed over
    the tp row as well. Every group is one stage's: a block leaf's layers
    are its stage's own. Under the pipeline a leaf every stage holds whole
    (wte, lm_head: not sharded over pp) is then summed over the stages
    too, each stage's share being its part of the schedule (stage 0 the
    embedding's, every stage its CE rows' head gradient), as the psum
    JAX's shard_map transpose inserts over 'pp'.

    Under ep every group above is one ep index's. A bank sharded over ep
    holds the gradient of the rank's experts for the rank's tokens, so it
    is summed as any other leaf over the ranks of its ep index that saw
    other tokens: its replica group when fsdp-sharded, else its batch
    group. A leaf replicated over ep (the router and every non-MLP leaf)
    already holds its whole gradient on each ep rank (EPTrain's f sums the
    experts' shares into the stream's gradient once, inside the step), so
    it is summed over the batch positions of one ep index and never over
    ep: the ep ranks' copies are identical, as the stream they hold is."""
    for name, g in grads.items():
        on_fsdp = fsdp_axis(specs[name]) is not None and mesh.fsdp > 1
        partial = name in tp_partial and mesh.tp > 1
        if partial and not on_fsdp:
            mesh.all_reduce_(g, mesh.stage_group)
        else:
            mesh.all_reduce_(g, mesh.replica_group if on_fsdp else mesh.batch_group)
            if partial:
                mesh.all_reduce_(g, mesh.tp_group)
        if mesh.pp > 1 and pp_axis(specs[name]) is None:
            mesh.all_reduce_(g, mesh.pp_group)


def shard_tree(tree: tp.Mapping[str, Tensor], specs: tp.Mapping[str, Spec], mesh: Mesh) -> tp.Dict[str, Tensor]:
    """Every full leaf of `tree` cut to this rank's shard."""
    return {k: shard(v, specs[k], mesh) for k, v in tree.items()}


@torch.no_grad()
def gather_tree(tree: tp.Mapping[str, Tensor], specs: tp.Mapping[str, Spec], mesh: Mesh) -> tp.Dict[str, Tensor]:
    """Every leaf of `tree` whole on its fsdp axis (collective over the
    fsdp row): the tp shards, under tp."""
    return {k: gather(v, specs[k], mesh) for k, v in tree.items()}


@torch.no_grad()
def whole_tree(tree: tp.Mapping[str, Tensor], specs: tp.Mapping[str, Spec], mesh: Mesh) -> tp.Dict[str, Tensor]:
    """Every leaf of `tree` whole (collective over the fsdp row, then the
    tp row, then the pp group, then the ep group)."""
    out = {}
    for k, v in tree.items():
        v = gather_pp(gather_tp(gather(v, specs[k], mesh), specs[k], mesh), specs[k], mesh)
        out[k] = gather_ep(v, specs[k], mesh)
    return out


class ShardedInit:
    """A mesh rank's layout for `GPT.init(shard=)`: each leaf of `shapes`
    allocated at its shard's shape under `specs`, and of each drawn piece
    (a leaf's leading indices fixed: a layer, or a layer's expert) only
    this rank's slice kept, as `shard` would cut it from the whole leaf.
    Reads only the mesh's axis sizes and indices."""

    def __init__(self, specs: tp.Mapping[str, Spec], mesh, shapes: tp.Mapping[str, tp.Sequence[int]]):
        self._extent = {k: shard_extent(spec, mesh) for k, spec in specs.items()}
        self._full = {k: tuple(v) for k, v in shapes.items()}

    def shape(self, name: str, shape: tp.Tuple[int, ...]) -> tp.Tuple[int, ...]:
        out = list(shape)
        for ax, (n, _) in self._extent[name].items():
            out[ax] //= n
        return tuple(out)

    def place(self, name: str, index: tp.Tuple[int, ...]) -> tp.Optional[tp.Tuple[int, ...]]:
        """Where piece `index` sits in this rank's shard, or None when the
        rank keeps none of it (a layer of another stage)."""
        local = list(index)
        for ax, (n, i) in self._extent[name].items():
            if ax < len(index):
                size = self._full[name][ax] // n
                if index[ax] // size != i:
                    return None
                local[ax] = index[ax] - i * size
        return tuple(local)

    def cut(self, name: str, piece: Tensor, lead: int) -> Tensor:
        """This rank's slice of `piece`, the leaf at `lead` fixed indices."""
        for ax, (n, i) in self._extent[name].items():
            if ax >= lead:
                piece = piece.chunk(n, dim=ax - lead)[i]
        return piece
