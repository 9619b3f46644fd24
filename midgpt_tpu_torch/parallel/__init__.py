"""Data-parallel and FSDP training and tensor-parallel serving over
torch.distributed (counterpart of midgpt_tpu/parallel, its `data`, `fsdp`
and serving `tp` axes): `dist` starts the process group, `mesh` lays the
ranks out as JAX lays out devices, `fsdp` shards the parameter leaves by
JAX's rule and gathers them with the reduce-scatter as its backward,
`data` gives each rank its rows of the global batch, `shard_map_fsdp` is
the ZeRO-3 per-layer schedule, `tp` is JAX's Megatron leaf rule, and
`serve_tp` builds the (data, tp) serving meshes and cuts a rank's shard
of the weights and the pool.

Training on the sp, tp, pp and ep axes is a later slice of the port
(ROADMAP.md Queue 1 item 7); a training mesh that asks for one of them
above 1 raises."""
