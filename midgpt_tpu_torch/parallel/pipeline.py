"""Pipeline parallelism over the mesh's pp axis: GPipe and 1F1B
(counterpart of midgpt_tpu/parallel/pipeline.py).

The block leaves are stacked along a leading layer axis, so a stage is
that axis sharded over pp: stage s holds layers [s L/pp, (s+1) L/pp) of
every block leaf (`pipeline_param_specs`), the embedding and lm_head
whole. A batch position's pp ranks read the same rows (parallel/data.py);
stage 0 embeds, each stage runs its layers (models/gpt.py `GPT.stage`)
and hands its output to the next.

JAX runs every stage through the same program every tick (a `lax.scan`
with neighbour `ppermute`s, bubble ticks computing on zeros). Here each
rank runs eagerly and does the work of a tick only where it has some: a
bubble tick computes nothing and sends nothing. The results are JAX's
(tests/test_torch_pipeline.py holds them to its functions on gloo ranks).

  * **GPipe** (`Pipeline.loss_and_grad` under 'gpipe', and `Pipeline.loss`,
    the eval of both schedules): the batch is split into M =
    pipeline_microbatches (or pp) microbatches. The forward runs every
    microbatch through the stages, each keeping its autograd graphs;
    the last stage's outputs are scattered over the stages (stage s
    receives rows [s B/pp, (s+1) B/pp), JAX's `psum_scatter`), and every
    stage runs the final RMSNorm and the fused CE on its B/pp rows (the
    v2 loss: the CE volume is 1x, not pp x). The CE's row gradients go
    back to the last stage (JAX's all_gather, the scatter's transpose),
    and the backward runs the microbatches in reverse, stage to stage.
  * **1F1B** (`Pipeline.loss_and_grad` under '1f1b'): JAX's tick timing
    (pipeline.py:310-535), F of microbatch m at stage s on tick m+s, the
    CE of m when its last-stage F is done (tick m+pp-1, Bm/pp rows a
    stage), B of m at stage s on tick m+2pp-1-s. JAX recomputes each
    stage from its stashed input in a 2 pp-slot ring; here the stash
    keeps the forward's autograd graph instead (no recompute) and a tick
    runs B before F, so a stage holds at most 2 pp - 1 live graphs,
    whatever M is (`STASH["high_water"]`). Stage 0 embeds one microbatch
    a tick; the grads accumulate in f32 as the loop goes.
  * The loss a rank returns is its stage's CE share divided by pp: summed
    over the stages (and over the batch positions, divided by their
    count, training/train.py `health_flag`) it is JAX's pmean. Its
    gradient is with respect to the rank's own leaves: the stage's block
    shards, and its contribution to wte (stage 0 only) and lm_head (its
    CE rows), which parallel/fsdp.py `reduce_grads` sums over the stages
    as JAX's shard_map transpose psums them over 'pp'.
  * Under fsdp each layer's weights are gathered inside the stage
    (parallel/fsdp.py `gather` in `GPT.stage`'s layer_transform, as JAX's
    ZeRO-3 streaming), so the gather's backward is the per-layer
    reduce-scatter; wte and lm_head are gathered once a call. Under tp
    (GPipe only, as config.py checks) the stage's layers run Megatron's
    collectives on the stage's tp row (parallel/tp.py `TPTrain`); wte and
    lm_head stay whole on the row (no vocab-parallel under pp).

Stage sends are `dist.batch_isend_irecv` between the pp group's
neighbours; under gloo a CUDA tensor is staged through host memory, as
the ring's hops are (parallel/ring_attention.py `_hop`). `SENDS` counts
the messages and their bytes by kind ('fwd' activations, 'bwd' their
gradients, 'ce' the CE rows and their gradients).
"""

from __future__ import annotations

import collections
import math
import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.models.gpt import GPT, Params
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy
from midgpt_tpu_torch.ops.norms import rms_norm
from midgpt_tpu_torch.ops.rope import rope_table
from midgpt_tpu_torch.parallel import fsdp
from midgpt_tpu_torch.parallel.fsdp import fsdp_leaf_spec
from midgpt_tpu_torch.parallel.tp import leaf_name, megatron_leaf_axes

Tensor = torch.Tensor

SENDS: tp.Counter[str] = collections.Counter()  # messages and bytes by kind, this process's
STASH = {"high_water": 0}  # 1F1B: the most live stashed microbatches of the last call
_TAG = {"fwd": 0, "bwd": 1, "ce": 2, "ce_grad": 3}


def pipeline_param_specs(
    shapes: tp.Mapping[str, tp.Sequence[int]],
    axes: tp.Mapping[str, int],
    shard_model: bool = True,
    min_size: int = 2**18,
) -> tp.Dict[str, tp.Tuple[tp.Optional[str], ...]]:
    """JAX's `pipeline_param_specs` (pipeline.py:83-134) for a dict of leaf
    shapes on a mesh of `axes` ('fsdp', 'tp' sizes): a block leaf shards
    its layer axis over 'pp' and, with fsdp, one other axis over 'fsdp'
    (the FSDP rule with the layer axis reserved); with tp the Megatron
    axis shards over 'tp' and fsdp takes the other feature axis. wte and
    lm_head follow the FSDP rule (tp-replicated: no vocab-parallel under
    pp)."""
    n_fsdp, n_tp = axes["fsdp"], axes["tp"]
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        if name.startswith("blocks."):
            found = megatron_leaf_axes(leaf_name(name), shape, n_tp) if n_tp > 1 else None
            if found is not None and 0 not in found:
                tp_ax, fsdp_ax = found
                spec: tp.List[tp.Optional[str]] = [None] * len(shape)
                spec[tp_ax] = "tp"
                if shard_model and n_fsdp > 1 and math.prod(shape) > min_size and shape[fsdp_ax] % n_fsdp == 0:
                    spec[fsdp_ax] = "fsdp"
            else:
                spec = fsdp_leaf_spec(shape, n_fsdp, shard_model, min_size, reserved_leading=1)
            spec[0] = "pp"
            out[name] = tuple(spec)
        else:
            out[name] = tuple(fsdp_leaf_spec(shape, n_fsdp, shard_model, min_size))
    return out


class Pipeline:
    """One rank's side of the pipeline schedule (module docstring), built
    once per train step from the config, the mesh, the state's specs and
    the stage's tp row (parallel/tp.py `TPTrain`, or None)."""

    def __init__(self, config, mesh, specs: tp.Mapping[str, fsdp.Spec], tp_train=None):
        self.mc = config.model_config
        self.chunk, self.remat_chunks = config.loss_chunk_tokens, config.loss_remat_chunks
        self.schedule = config.pipeline_schedule
        self.mesh, self.specs, self.tp_train = mesh, dict(specs), tp_train
        self.P, self.s = mesh.pp, mesh.pp_index
        self.M = config.pipeline_microbatches or self.P
        self.layers = range(self.mc.n_layer // self.P)
        self.blocks = [k for k in self.specs if k.startswith("blocks.")]
        # a layer's slice of a block leaf loses the layer axis
        self.layer_specs = {k.split(".", 1)[1]: tuple(v[1:]) for k, v in self.specs.items() if k in self.blocks}
        self.gathered = mesh.fsdp > 1 and any(fsdp.fsdp_axis(v) is not None for v in self.layer_specs.values())
        self.first, self.last = self.s == 0, self.s == self.P - 1
        group = mesh.pp_group
        self.stage_ranks = [dist.get_global_rank(group, i) for i in range(self.P)]

    # ---------------------------------------------------------------- plumbing

    def _exchange(self, sends: tp.Sequence[tp.Tuple[str, Tensor, int]],
                  recvs: tp.Sequence[tp.Tuple[str, tp.Tuple[int, ...], torch.dtype, int]],
                  device: torch.device) -> tp.List[Tensor]:
        """One batch of neighbour messages: each (kind, tensor, stage) of
        `sends` to that stage, and each (kind, shape, dtype, stage) of
        `recvs` received from it (returned on `device`)."""
        group = self.mesh.pp_group
        host = device.type == "cuda" and dist.get_backend(group) == "gloo"
        ops, got = [], []
        for kind, t, stage in sends:
            buf = t.detach().to("cpu") if host else t.detach().contiguous()
            ops.append(dist.P2POp(dist.isend, buf, self.stage_ranks[stage], group, _TAG[kind]))
            SENDS[kind.split("_")[0]] += 1
            SENDS[f"{kind.split('_')[0]}_bytes"] += buf.numel() * buf.element_size()
        for kind, shape, dtype, stage in recvs:
            buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
            ops.append(dist.P2POp(dist.irecv, buf, self.stage_ranks[stage], group, _TAG[kind]))
            got.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(device) if host else b for b in got]

    def _gather_block(self, blk: Params) -> Params:
        return {k: fsdp.gather(t, self.layer_specs[k], self.mesh) for k, t in blk.items()}

    def _check(self, B: int) -> int:
        M, P = self.M, self.P
        if self.schedule == "1f1b":
            if B % M != 0 or B % P != 0 or (B // M) % P != 0:
                raise ValueError(
                    f"per-data-shard batch {B} must be divisible by pipeline_microbatches={M} (and each "
                    f"microbatch by pp={P} for the scattered CE) — lower them or raise batch_size"
                )
        elif B % M != 0 or B % P != 0:
            raise ValueError(
                f"per-data-shard batch {B} must be divisible by both pipeline_microbatches={M} and pp={P} — "
                "lower them or raise batch_size (config-time validation can only check the global batch; this "
                "is the per-shard constraint)"
            )
        return B // M

    def _stage(self, params: Params, inp: Tensor, rope, inference: bool) -> Tensor:
        return GPT.stage(self.mc, params, inp, self.layers, *rope, inference=inference,
                         layer_transform=self._gather_block if self.gathered else None, tp_train=self.tp_train)

    def _ce(self, shard: Tensor, head: Tensor, y: Tensor) -> Tensor:
        return fused_linear_cross_entropy(rms_norm(shard, eps=1e-5), head, y, self.chunk, self.remat_chunks)

    def _whole(self, params: Params, name: str) -> Tensor:
        return fsdp.gather(params[name], self.specs[name], self.mesh)

    # ---------------------------------------------------------------- GPipe

    def _gpipe_forward(self, params: Params, x: Tensor, wte: tp.Optional[Tensor], rope, inference: bool):
        """Every microbatch through this stage in order: [(input, output)]."""
        Bm, T = self._check(x.shape[0]), x.shape[1]
        shape, dtype = (Bm, T, self.mc.n_embd), params[self.blocks[0]].dtype
        kept = []
        for m in range(self.M):
            if self.first:
                inp = wte[x[m * Bm:(m + 1) * Bm]]
            else:
                (inp,) = self._exchange([], [("fwd", shape, dtype, self.s - 1)], x.device)
                inp.requires_grad_(not inference)
            out = self._stage(params, inp, rope, inference)
            if not self.last:
                self._exchange([("fwd", out, self.s + 1)], [], x.device)
            kept.append((inp, out))
        return kept

    def _scatter_rows(self, outs: tp.Optional[tp.List[Tensor]], shape, dtype, device) -> Tensor:
        """The last stage's (B, T, D) outputs (a list of row blocks) split
        over the stages: this stage's B/pp rows."""
        if self.last:
            parts = torch.cat([o.detach() for o in outs]).chunk(self.P)
            self._exchange([("ce", parts[j], j) for j in range(self.P - 1)], [], device)
            return parts[-1].clone()
        return self._exchange([], [("ce", shape, dtype, self.P - 1)], device)[0]

    def _gather_rows(self, dshard: Tensor) -> tp.Optional[Tensor]:
        """Each stage's CE row gradients back on the last stage, in row
        order (None elsewhere)."""
        if not self.last:
            self._exchange([("ce_grad", dshard, self.P - 1)], [], dshard.device)
            return None
        got = self._exchange([], [("ce_grad", dshard.shape, dshard.dtype, j) for j in range(self.P - 1)],
                             dshard.device)
        return torch.cat([*got, dshard])

    @torch.no_grad()
    def loss(self, params: Params, x: Tensor, y: Tensor) -> Tensor:
        """The GPipe forward (eval under both schedules): this rank's share
        of the batch's mean loss, its stage's CE over B/pp rows over pp."""
        rope = rope_table(self.mc.head_dim, x.shape[1], device=x.device)
        wte = self._whole(params, "wte") if self.first else None
        kept = self._gpipe_forward(params, x, wte, rope, inference=True)
        Bp, T = x.shape[0] // self.P, x.shape[1]
        shard = self._scatter_rows([o for _, o in kept] if self.last else None, (Bp, T, self.mc.n_embd),
                                   params[self.blocks[0]].dtype, x.device)
        y_s = y[self.s * Bp:(self.s + 1) * Bp]
        return self._ce(shard, self._whole(params, "lm_head"), y_s).float() / self.P

    def loss_and_grad(self, params: Params, x: Tensor, y: Tensor, scale: float = 1.0
                      ) -> tp.Tuple[Tensor, tp.List[Tensor]]:
        """This rank's loss share (`loss`) and the gradient of `scale` x the
        shares' sum with respect to each leaf of `params` (in its order; f32),
        under the config's schedule."""
        if self.schedule == "1f1b":
            return self._one_f_one_b(params, x, y, scale)
        return self._gpipe(params, x, y, scale)

    def _heads(self, params: Params) -> tp.Tuple[tp.Optional[Tensor], tp.Optional[Tensor], Tensor, Tensor]:
        """(wte whole, its detached leaf, lm_head whole, its leaf): the
        schedules take gradients to the leaves, then through the gathers
        once (`_finish`). wte only on stage 0."""
        wte = self._whole(params, "wte") if self.first else None
        head = self._whole(params, "lm_head")
        return (wte, None if wte is None else wte.detach().requires_grad_(), head,
                head.detach().requires_grad_())

    def _finish(self, params: Params, acc: tp.Dict[str, Tensor], wte, wte_g, head, head_g) -> tp.List[Tensor]:
        """The accumulated gradients as the leaves', through the wte and
        lm_head gathers (their reduce-scatters under fsdp)."""
        for name, whole, g in (("wte", wte, wte_g), ("lm_head", head, head_g)):
            if whole is None:
                acc[name] = torch.zeros(params[name].shape, dtype=torch.float32, device=params[name].device)
            elif whole is params[name]:
                acc[name] = g
            else:
                (acc[name],) = torch.autograd.grad(whole, params[name], g.to(whole.dtype))
        return [acc[k].float() for k in params]

    def _gpipe(self, params: Params, x: Tensor, y: Tensor, scale: float):
        rope = rope_table(self.mc.head_dim, x.shape[1], device=x.device)
        wte, wte_leaf, head, head_leaf = self._heads(params)
        kept = self._gpipe_forward(params, x, wte_leaf, rope, inference=False)
        Bp, T = x.shape[0] // self.P, x.shape[1]
        Bm = x.shape[0] // self.M
        shard = self._scatter_rows([o for _, o in kept] if self.last else None, (Bp, T, self.mc.n_embd),
                                   params[self.blocks[0]].dtype, x.device).requires_grad_()
        loss = self._ce(shard, head_leaf, y[self.s * Bp:(self.s + 1) * Bp])
        dshard, head_g = torch.autograd.grad(loss, [shard, head_leaf], torch.full_like(loss, scale / self.P))
        d_rows = self._gather_rows(dshard)
        acc = {k: torch.zeros(params[k].shape, dtype=torch.float32, device=x.device) for k in self.blocks}
        wte_g = None if wte is None else torch.zeros(wte.shape, dtype=torch.float32, device=x.device)
        shape = (Bm, T, self.mc.n_embd)
        for m in reversed(range(self.M)):
            inp, out = kept[m]
            kept[m] = None  # the graph goes with this microbatch's backward
            if self.last:
                g = d_rows[m * Bm:(m + 1) * Bm]
            else:
                (g,) = self._exchange([], [("bwd", shape, out.dtype, self.s + 1)], x.device)
            src = wte_leaf if self.first else inp
            grads = torch.autograd.grad(out, [src, *(params[k] for k in self.blocks)], g.to(out.dtype))
            for k, gr in zip(self.blocks, grads[1:]):
                acc[k] += gr.float()
            if self.first:
                wte_g += grads[0].float()
            else:
                self._exchange([("bwd", grads[0], self.s - 1)], [], x.device)
        return loss.detach().float() / self.P, self._finish(params, acc, wte, wte_g, head, head_g.float())

    # ---------------------------------------------------------------- 1F1B

    def _one_f_one_b(self, params: Params, x: Tensor, y: Tensor, scale: float):
        P, M, s = self.P, self.M, self.s
        Bm, T = self._check(x.shape[0]), x.shape[1]
        Bmp, D = Bm // P, self.mc.n_embd
        dtype, dev = params[self.blocks[0]].dtype, x.device
        rope = rope_table(self.mc.head_dim, T, device=dev)
        wte, wte_leaf, head, head_leaf = self._heads(params)
        acc = {k: torch.zeros(params[k].shape, dtype=torch.float32, device=dev) for k in self.blocks}
        wte_g = None if wte is None else torch.zeros(wte.shape, dtype=torch.float32, device=dev)
        head_g = torch.zeros(head.shape, dtype=torch.float32, device=dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        stash: tp.Dict[int, tp.Tuple[Tensor, Tensor]] = {}  # microbatch -> (input, output), its graph live
        dh_pend: tp.Dict[int, Tensor] = {}  # the last stage's output gradients, from the CE
        fwd_in = bwd_in = None
        high = 0
        valid = lambda m: 0 <= m < M  # noqa: E731
        for t in range(M + 2 * P - 1):
            # B of microbatch t - 2P + 1 + s
            mb = t - 2 * P + 1 + s
            dinp = None
            if valid(mb):
                g = dh_pend.pop(mb) if self.last else bwd_in
                inp, out = stash.pop(mb)
                src = wte_leaf if self.first else inp
                grads = torch.autograd.grad(out, [src, *(params[k] for k in self.blocks)], g.to(out.dtype))
                for k, gr in zip(self.blocks, grads[1:]):
                    acc[k] += gr.float()
                if self.first:
                    wte_g += grads[0].float()
                else:
                    dinp = grads[0]
            # F of microbatch t - s
            mf = t - s
            out = None
            if valid(mf):
                inp = wte_leaf[x[mf * Bm:(mf + 1) * Bm]] if self.first else fwd_in.requires_grad_()
                out = self._stage(params, inp, rope, inference=False)
                stash[mf] = (inp, out)
                high = max(high, len(stash))
            # the CE of microbatch t - P + 1, whose last-stage F just ran
            mc = t - P + 1
            if valid(mc):
                shard = self._scatter_rows([out] if self.last else None, (Bmp, T, D), dtype, dev).requires_grad_()
                ce = self._ce(shard, head_leaf, y[mc * Bm + s * Bmp:mc * Bm + (s + 1) * Bmp])
                dshard, dhead = torch.autograd.grad(ce, [shard, head_leaf], torch.full_like(ce, scale / (P * M)))
                loss += ce.detach().float()
                head_g += dhead.float()
                rows = self._gather_rows(dshard)
                if self.last:
                    dh_pend[mc] = rows
            # this tick's sends, and what the next tick's F and B receive
            sends = []
            if out is not None and not self.last:
                sends.append(("fwd", out, s + 1))
            if dinp is not None:
                sends.append(("bwd", dinp, s - 1))
            recvs = []
            if valid(t + 1 - s) and not self.first:
                recvs.append(("fwd", (Bm, T, D), dtype, s - 1))
            if valid(t + 1 - 2 * P + 1 + s) and not self.last:
                recvs.append(("bwd", (Bm, T, D), dtype, s + 1))
            got = self._exchange(sends, recvs, dev)
            fwd_in = got.pop(0) if recvs and recvs[0][0] == "fwd" else None
            bwd_in = got.pop(0) if got else None
        STASH["high_water"] = high
        return loss / (P * M), self._finish(params, acc, wte, wte_g, head, head_g)
