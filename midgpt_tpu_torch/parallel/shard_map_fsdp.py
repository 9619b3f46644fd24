"""The ZeRO-3 schedule, `fsdp_mode="shard_map"` (counterpart of
midgpt_tpu/parallel/shard_map_fsdp.py): the collectives are written down
instead of left to the step.

  * The loss takes the compute-dtype SHARDS of the parameters.
  * The embedding and lm_head are all-gathered once per call.
  * Each block's leaves are all-gathered inside GPT.hidden's layer loop
    (the `layer_transform` hook), so at any moment one layer's full
    weights exist besides the ones autograd keeps. Under the per-block
    remat the gather runs inside the checkpoint, and the recompute
    gathers again instead of keeping the gathered weights alive.
  * The gradients need no extra collective: `fsdp.gather`'s backward is
    the per-layer reduce-scatter ZeRO-3 prescribes. The step then sums
    them over the data column and takes the loss's mean over (data,
    fsdp), as for the GSPMD mode (training/train.py).

Under tensor parallelism the shards are 2D (parallel/tp.py): each gather
takes the leaf's fsdp axis and leaves its tp axis on the rank, and the
tp row's collectives ride inside the same layer loop (GPT.hidden's
`tp_train`), as JAX composes its r5 schedule with 'tp' as a GSPMD axis
inside the shard_map body (midgpt_tpu/parallel/shard_map_fsdp.py:153-165).

`sequence_parallel` ('ring' | 'ulysses' | None, JAX's :85-152): the
batch's T axis is sharded over the mesh's sp axis as well, and the named
schedule runs the attention inside the same layer loop, the fsdp gathers
and the sp group's hops or all-to-alls side by side. The ring runs at its
default block of 1024, as JAX's shard_map body calls it; Ulysses' dense
attention at the attn_block_size. The positions are the rank's shard's
(training/train.py `sequence_parallel`), and the step's mean is over
data x fsdp x sp. Under tp the config refuses sp here, as JAX's does.

The routed MLP's aux term is not folded in here (config.py refuses
moe_aux_coef with this mode, as JAX's does).
"""

from __future__ import annotations

import typing as tp

import torch

from midgpt_tpu_torch.models.gpt import GPT, Params
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy
from midgpt_tpu_torch.parallel import fsdp
from midgpt_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def make_shard_map_loss(config, mesh: Mesh, specs: tp.Mapping[str, fsdp.Spec], tp_train=None,
                        sequence_parallel: tp.Optional[str] = None) -> tp.Callable:
    """loss_fn(shards, x, y, generator) -> this rank's mean loss over its
    tokens, differentiable with respect to the shards; `tp_train` is the tp
    row's (parallel/tp.py TPTrain) under tensor parallelism,
    `sequence_parallel` the schedule under sp (module docstring)."""
    from midgpt_tpu_torch.training.train import sequence_parallel as sp_binding

    if sequence_parallel not in (None, "ring", "ulysses"):
        raise ValueError(f"unknown sequence_parallel {sequence_parallel!r}")
    sp_hooks = sp_binding(config.model_config, mesh, ring_block=1024) if sequence_parallel else (lambda x: {})
    block_specs = {}
    for name, spec in specs.items():
        ax = fsdp.fsdp_axis(spec)
        if name.startswith("blocks."):
            if ax == 0 and mesh.fsdp > 1:
                raise NotImplementedError(
                    f"{name} shards its layer axis (no other axis divides by fsdp={mesh.fsdp}); the per-layer "
                    "gather needs each layer's slice on every rank: use fsdp_mode='gspmd'"
                )
            block_specs[name.split(".", 1)[1]] = None if ax is None else ax - 1
    vocab_row = tp_train.vocab_row if tp_train is not None else (None, 0)

    def gather_block(blk: Params) -> Params:
        return {k: fsdp.gather(t, block_specs[k], mesh) for k, t in blk.items()}

    def loss_fn(shards: Params, x: Tensor, y: Tensor, generator) -> Tensor:
        head = fsdp.gather(shards["lm_head"], specs["lm_head"], mesh)
        gathered = {**shards, "wte": fsdp.gather(shards["wte"], specs["wte"], mesh), "lm_head": head}
        h = GPT.hidden(config.model_config, gathered, x, generator=generator, inference=False,
                       layer_transform=gather_block, tp_train=tp_train, **sp_hooks(x))
        return fused_linear_cross_entropy(h, head, y, config.loss_chunk_tokens, config.loss_remat_chunks,
                                          *vocab_row)

    return loss_fn
