"""7B Llama shape at 32K context (the same values as
midgpt_tpu/configs/llama7b_32k.py): ring attention over an 8-wide
sequence-parallel axis in JAX, and a self-draft of the first 8 of 32
layers for serving (spec_k_max 8). The port trains it on a mesh of ranks
(`launch --multihost`: the ring over mesh.sp, parallel/ring_attention.py);
serving runs on one device, where 'ring' computes the unsharded blockwise
math (ops/attention.py). Its whole training state (f32 Adam state for 7B
is ~108 GB) waits for the sharded 7B init (ROADMAP.md Queue 1 item 7).
`decode_layer_scan` is a JAX lowering knob and changes nothing here."""

from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.models.gpt import GPTConfig

config = ExperimentConfig(
    rundir="",
    data_dir="/mnt/disks/persist/openwebtext",
    learning_rate=3e-4,
    batch_size=32,
    warmup_steps=2000,
    min_lr=3e-5,
    lr_decay_steps=50_000,
    max_steps=50_000,
    beta2=0.95,
    weight_decay=1e-4,
    eval_interval=1000,
    compute_dtype="bfloat16",
    param_dtype="float32",
    g_accum_iters=8,
    shard_model=True,
    mesh=MeshConfig(data=-1, fsdp=8, sp=8),
    spec_layers=8,
    spec_k_max=8,
    model_config=GPTConfig(
        block_size=32768,
        vocab_size=50304,
        n_layer=32,
        n_head=32,
        n_embd=4096,
        dropout=0.0,
        attn_impl="ring",
        rope_style="split",
        decode_layer_scan=True,
    ),
)
