"""Data-parallel and FSDP training over torch.distributed (counterpart of
midgpt_tpu/parallel, its `data` and `fsdp` axes): `dist` starts the
process group, `mesh` lays the ranks out as JAX lays out devices, `fsdp`
shards the parameter leaves by JAX's rule and gathers them with the
reduce-scatter as its backward, `data` gives each rank its rows of the
global batch, and `shard_map_fsdp` is the ZeRO-3 per-layer schedule.

The sp, tp, pp and ep axes are later slices of the port (ROADMAP.md Queue
1 item 7); a mesh that asks for one of them above 1 raises."""
