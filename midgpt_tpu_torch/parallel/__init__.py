"""Data, FSDP, tensor, sequence, pipeline and expert parallelism on
torch.distributed, and tensor-parallel serving (counterpart of
midgpt_tpu/parallel): `dist` starts the process group, `mesh` lays the
ranks out as JAX lays out devices (data, fsdp, sp, tp, pp, ep), `fsdp`
shards the parameter leaves by JAX's rule and gathers them with the
reduce-scatter as its backward, `data` gives each rank its rows of the
global batch, `shard_map_fsdp` is the ZeRO-3 per-layer schedule, `tp` is
JAX's Megatron leaf rule and the training collectives (the tp row's and
the ep group's), `ring_attention` and `ulysses` the sequence-parallel
attentions, `pipeline` GPipe and 1F1B over the stages, and `serve_tp`
builds the (data, tp) serving meshes and cuts a rank's shard of the
weights and the pool."""
