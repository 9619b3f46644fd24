"""The rank mesh (counterpart of midgpt_tpu/parallel/mesh.py:33-74).

JAX names a 6D device mesh ('data', 'fsdp', 'sp', 'tp', 'pp', 'ep'); the
port lays its ranks out on the same axes with JAX's arithmetic
(`mesh_shape`: the -1 inference, the divisor clamp on fsdp, the same
error texts). Training runs on every axis. Serving meshes
(parallel/serve_tp.py `make_serve_mesh`) are (data, tp) meshes of the
same class.

Ranks fill (data, fsdp, sp, tp, pp, ep) in JAX's axis order, the last
axis fastest: rank index i sits at data i // (fsdp * sp * tp * pp * ep),
fsdp (i // (sp * tp * pp * ep)) % fsdp, sp (i // (tp * pp * ep)) % sp, tp
(i // (pp * ep)) % tp, pp (i // ep) % pp, ep i % ep. At pp 1 and ep 1 a tp
row is consecutive ranks (on one node under torchrun), and
i // (sp * tp * pp * ep) is the rank's *batch position*: the flattened
(data, fsdp) order in which JAX's batch_spec shards the batch rows over
both axes (the ranks of a tp row, the sp ranks of a position, the stages
of a pipeline and the ep ranks of a position read the same rows; the sp
index picks the rank's contiguous T/sp columns, as
batch_spec(shard_seq=True) shards the sequence). The ranks of one pp and
ep index are a *stage*: every group below but `pp_group`, `ep_group` and
`group` lies inside one stage, so a sum over one of them never adds the
identical values of a leaf's ep replicas. The process groups:

  tp_group      the tp row (same data, fsdp, sp, pp and ep index): the
                ranks that together hold one copy of the stage's
                tp-sharded leaves;
  fsdp_group    the ranks with the same data, sp, tp, pp and ep index;
  data_group    the ranks with the same fsdp, sp, tp, pp and ep index;
  sp_group      the ranks with the same data, fsdp, tp, pp and ep index:
                one sequence's shards, the ring's and Ulysses' group;
  replica_group the ranks with the same fsdp, tp, pp and ep index (data x
                sp): over which the gradient of an fsdp-sharded leaf is
                summed (the data_group at sp 1);
  batch_group   the ranks with this rank's tp, pp and ep index: one per
                (batch position, sequence shard), over which losses and the
                gradients of leaves the tp row holds whole are summed
                (the whole stage, at tp 1);
  stage_group   the ranks with this rank's pp and ep index (every member,
                at pp 1 and ep 1);
  pp_group      the ranks with the same data, fsdp, sp, tp and ep index:
                the stages of one pipeline, which pass activations from
                `prev_stage` to `next_stage` (global ranks, None at either
                end);
  ep_group      the ranks with the same data, fsdp, sp, tp and pp index:
                the ranks that each hold n_experts/ep of the routed MLP's
                experts for the same tokens, over which the combine is
                summed (parallel/tp.py `EPTrain`);
  group         every member.

A mesh takes an explicit rank list (JAX's `devices=`), so one process
group can hold meshes of several sizes; every rank of the process group
builds every mesh, members or not, because creating a process group is
collective. A group of one rank is None.

A mesh of one rank creates no group and issues no collective: training
on it is the single-device trainer, bit for bit.
"""

from __future__ import annotations

import dataclasses
import datetime
import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.parallel import dist as pdist

AXES = ("data", "fsdp", "sp", "tp", "pp", "ep")


def mesh_shape(cfg, n: int) -> tp.Dict[str, int]:
    """The axis sizes JAX's make_mesh gives `n` devices under MeshConfig
    `cfg`, with its errors (every axis, the unported ones included)."""
    fsdp = cfg.fsdp if cfg.fsdp != -1 else 1
    sp = cfg.sp if cfg.sp != -1 else 1
    tp_ = cfg.tp if cfg.tp != -1 else 1
    pp = cfg.pp if cfg.pp != -1 else 1
    ep = cfg.ep if cfg.ep != -1 else 1
    rest_axes = sp * tp_ * pp * ep
    if n % (fsdp * rest_axes) != 0:
        # Degrade gracefully on small device counts: clamp fsdp to the
        # largest divisor of n // (sp * tp * pp * ep).
        if n % rest_axes != 0:
            raise ValueError(f"{n} devices not divisible by sp={sp} * tp={tp_} * pp={pp} * ep={ep}")
        rest = n // rest_axes
        fsdp = max(d for d in range(1, rest + 1) if rest % d == 0 and d <= fsdp)
    data = cfg.data if cfg.data != -1 else n // (fsdp * rest_axes)
    if data * fsdp * rest_axes != n:
        raise ValueError(f"mesh {data}x{fsdp}x{sp}x{tp_}x{pp}x{ep} != {n} devices")
    return dict(zip(AXES, (data, fsdp, sp, tp_, pp, ep)))


class _AllReduceSum(torch.autograd.Function):
    """psum: the sum over a group, whose transpose is the sum of the
    incoming gradients over the same group."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class Mesh:
    """Axis sizes, the member ranks in mesh order, this rank's place, and
    the process groups of the module docstring. `row_groups` holds every
    tp row's group, row by row (a serving mesh's roles). `timeout` bounds
    every collective over the mesh's groups (default: the process group's,
    parallel/dist.py)."""

    def __init__(self, shape: tp.Dict[str, int], ranks: tp.Sequence[int], device: torch.device,
                 timeout: tp.Optional[datetime.timedelta] = None):
        self.shape = dict(shape)
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.data, self.fsdp, self.tp = shape["data"], shape["fsdp"], shape["tp"]
        self.sp, self.pp, self.ep = shape.get("sp", 1), shape.get("pp", 1), shape.get("ep", 1)
        me = pdist.rank()
        self.index = self.ranks.index(me) if me in self.ranks else None
        self.device = device
        self.group = self.data_group = self.fsdp_group = self.tp_group = self.batch_group = None
        self.sp_group = self.replica_group = self.stage_group = self.pp_group = self.ep_group = None
        self.prev_stage = self.next_stage = None
        self.row_groups: tp.List[tp.Any] = []
        kw = {} if timeout is None else {"timeout": timeout}
        if self.size > 1:
            # every rank of the process group creates every group, in one order
            self.group = dist.new_group(self.ranks, **kw)
            D, F, S, T, P, E = self.data, self.fsdp, self.sp, self.tp, self.pp, self.ep
            at = lambda d, f, s, t, p, e: self.ranks[((((d * F + f) * S + s) * T + t) * P + p) * E + e]  # noqa: E731

            def make(members: tp.List[tp.List[int]]) -> tp.Tuple[tp.List[tp.Any], tp.Any]:
                """A group per member list (the whole group when there is
                one list) and this rank's, or None outside them all."""
                made = [self.group if len(members) == 1 else dist.new_group(m, **kw) for m in members]
                return made, next((g for m, g in zip(members, made) if me in m), None)

            # the stages: each (pp index, ep index), in this order
            stages = [(p, e) for p in range(P) for e in range(E)]

            def per_stage(lists: tp.Callable[[int, int], tp.List[tp.List[int]]]) -> tp.Any:
                """This rank's group of those `lists(p, e)` gives for each stage."""
                return make([m for p, e in stages for m in lists(p, e)])[1]

            cells = [(d, f, s) for d in range(D) for f in range(F) for s in range(S)]
            rows = {(p, e): [[at(d, f, s, t, p, e) for t in range(T)] for d, f, s in cells] for p, e in stages}
            if T > 1:
                self.row_groups, self.tp_group = make([row for pe in stages for row in rows[pe]])
            if F > 1:
                self.fsdp_group = per_stage(lambda p, e: [[at(d, f, s, t, p, e) for f in range(F)]
                                                          for d in range(D) for s in range(S) for t in range(T)])
            if D > 1:
                self.data_group = per_stage(lambda p, e: [[at(d, f, s, t, p, e) for d in range(D)]
                                                          for f in range(F) for s in range(S) for t in range(T)])
            if S > 1:
                self.sp_group = per_stage(lambda p, e: [[at(d, f, s, t, p, e) for s in range(S)]
                                                        for d in range(D) for f in range(F) for t in range(T)])
            if D > 1 and S > 1:
                self.replica_group = per_stage(lambda p, e: [[at(d, f, s, t, p, e) for d in range(D) for s in range(S)]
                                                             for f in range(F) for t in range(T)])
            else:
                self.replica_group = self.data_group if D > 1 else self.sp_group
            if P * E == 1:
                self.stage_group = self.group
            elif D * F * S * T > 1:
                self.stage_group = per_stage(lambda p, e: [[r for row in rows[(p, e)] for r in row]])
            if T == 1:
                self.batch_group = self.stage_group
            elif D * F * S > 1:
                self.batch_group = per_stage(lambda p, e: [[row[t] for row in rows[(p, e)]] for t in range(T)])
            if P > 1:
                self.pp_group = make([[at(d, f, s, t, p, e) for p in range(P)]
                                      for d, f, s in cells for t in range(T) for e in range(E)])[1]
                if self.index is not None:  # the neighbours are E ranks apart (only ep is faster than pp)
                    if self.pp_index > 0:
                        self.prev_stage = self.ranks[self.index - E]
                    if self.pp_index < P - 1:
                        self.next_stage = self.ranks[self.index + E]
            if E > 1:
                self.ep_group = make([[at(d, f, s, t, p, e) for e in range(E)]
                                      for d, f, s in cells for t in range(T) for p in range(P)])[1]
        # host values travel on the backend's own device type
        self._host_dev = device if pdist.backend() == "nccl" else torch.device("cpu")

    def row(self, r: int) -> "Mesh":
        """Tp row `r` of a serving mesh (fsdp 1) as a (data 1, tp) mesh of
        its own, over the group this mesh already holds (no collective)."""
        view = object.__new__(Mesh)
        view.__dict__.update(self.__dict__)
        view.shape = {**self.shape, "data": 1}
        view.data = 1
        view.ranks = self.ranks[r * self.tp:(r + 1) * self.tp]
        view.size = len(view.ranks)
        me = pdist.rank()
        view.index = view.ranks.index(me) if me in view.ranks else None
        g = self.row_groups[r] if self.row_groups else None
        view.group = view.tp_group = g
        view.data_group = view.fsdp_group = view.batch_group = view.sp_group = view.replica_group = None
        view.ep_group = None
        view.stage_group = g
        view.row_groups = [g] if g is not None else []
        return view

    @property
    def member(self) -> bool:
        return self.index is not None

    @property
    def is_leader(self) -> bool:
        """The first member: it writes the checkpoints, the ledger and the
        metrics (JAX's process_index() == 0)."""
        return self.index == 0

    @property
    def data_index(self) -> int:
        return self.index // (self.fsdp * self.sp * self.tp * self.pp * self.ep)

    @property
    def tp_index(self) -> int:
        """This rank's place in its tp row (its shard of the tp leaves)."""
        return (self.index // (self.pp * self.ep)) % self.tp

    @property
    def sp_index(self) -> int:
        """This rank's sequence shard: columns [sp_index * T/sp, ...)."""
        return (self.index // (self.tp * self.pp * self.ep)) % self.sp

    @property
    def fsdp_index(self) -> int:
        return (self.index // (self.sp * self.tp * self.pp * self.ep)) % self.fsdp

    @property
    def pp_index(self) -> int:
        """This rank's pipeline stage: layers [pp_index * L/pp, ...)."""
        return (self.index // self.ep) % self.pp

    @property
    def ep_index(self) -> int:
        """This rank's expert shard: experts [ep_index * E/ep, ...)."""
        return self.index % self.ep

    @property
    def batch_index(self) -> int:
        """This rank's batch position: its place in the flattened (data,
        fsdp) order, shared by the ranks of its tp row, its sp group, its
        pp group and its ep group."""
        return self.index // (self.sp * self.tp * self.pp * self.ep)

    @property
    def batch_size(self) -> int:
        """The batch positions: data x fsdp (the row blocks of a batch)."""
        return self.data * self.fsdp

    @property
    def token_shards(self) -> int:
        """The (batch position, sequence shard) pairs, data x fsdp x sp: the
        equal token shards over which a loss is a mean."""
        return self.data * self.fsdp * self.sp

    def geometry(self) -> tp.Dict[str, tp.Any]:
        """What the supervisor's ledger records of the mesh."""
        return {"n_devices": self.size, "axes": dict(self.shape)}

    def all_reduce_(self, t: torch.Tensor, group) -> torch.Tensor:
        """In-place sum over `group` (nothing for a group of one)."""
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over every member (`t` itself on one rank)."""
        return t if self.group is None else _AllReduceSum.apply(t, self.group)

    def psum_batch(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the batch group: one term per token
        shard (`psum` at tp 1)."""
        return t if self.batch_group is None else _AllReduceSum.apply(t, self.batch_group)

    def psum_tp(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over this rank's tp row (nothing for a row of one):
        Megatron's all-reduce after a row-parallel product in the serving
        forwards, which record no gradient (training takes the out-of-place
        pair of parallel/tp.py)."""
        if self.tp_group is not None:
            dist.all_reduce(t, group=self.tp_group)
        return t

    def all_same(self, value: int) -> bool:
        """Whether every member holds the same host integer (collective;
        the same answer on every member)."""
        if self.group is None:
            return True
        t = torch.tensor([value], dtype=torch.int64, device=self._host_dev)
        out = torch.empty(self.size, dtype=torch.int64, device=self._host_dev)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return bool((out == out[0]).all().item())

    def agree(self, value: int) -> int:
        """The leader's host integer, on every member."""
        if self.group is None:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self._host_dev)
        dist.broadcast(t, src=self.ranks[0], group=self.group)
        return int(t.item())

    def any(self, flag: bool) -> bool:
        """True on every member when `flag` is true on any."""
        if self.group is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int64, device=self._host_dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def broadcast_object(self, obj: tp.Any, src: tp.Optional[int] = None) -> tp.Any:
        """The leader's picklable object (or member rank `src`'s), on every
        member."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0] if src is None else src, group=self.group,
                                   device=self._host_dev)
        return box[0]

    def send_object(self, obj: tp.Any, dst: int) -> None:
        """A picklable object to rank `dst` (point to point)."""
        dist.send_object_list([obj], dst=dst, device=self._host_dev)

    def recv_object(self, src: int) -> tp.Any:
        box = [None]
        dist.recv_object_list(box, src=src, device=self._host_dev)
        return box[0]

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def run_mesh(config, device=None) -> Mesh:
    """The mesh a run trains on: every rank of the process group (or this
    process alone) laid out on the config's axes. Under
    on_resume_mesh="any" only the data axis is re-derived for the ranks
    there are, as JAX's launcher re-derives it for the devices (launch.py):
    sp, tp, pp and ep stay the config's."""
    cfg = config.mesh
    if config.on_resume_mesh == "any":
        cfg = dataclasses.replace(cfg, data=-1)
    return make_mesh(cfg, device=device)


def make_mesh(cfg=None, *, ranks: tp.Optional[tp.Sequence[int]] = None, device=None) -> Mesh:
    """The mesh of MeshConfig `cfg` over `ranks` (default: every rank of
    the process group, or this process alone without one). Collective:
    every rank of the process group calls it with the same arguments.
    `device` is this rank's device (default: `dist.rank_device`)."""
    from midgpt_tpu_torch.config import MeshConfig

    cfg = cfg or MeshConfig()
    # sorted: a process group numbers its ranks in ascending order
    ranks = sorted(ranks if ranks is not None else range(pdist.world()))
    return Mesh(mesh_shape(cfg, len(ranks)), ranks, torch.device(device) if device is not None else pdist.rank_device())
