"""7B Llama shape at sequence 4096 (the same values as
midgpt_tpu/configs/llama7b_long.py): 32 layers of 4096, 32 heads of 128,
flash attention, split RoPE, G=4. The port serves it in bf16 (`python -m
midgpt_tpu_torch.sample --config=llama7b_long --start_ids=...`, ~13.5 GB
of weights); training it waits for parallelism (ROADMAP.md Queue 1 item
7): f32 master params, grads and Adam state alone are ~108 GB, past one
card, and the 16-way FSDP mesh is a pod's. `decode_layer_scan` is a JAX
lowering knob and changes nothing here."""

from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.models.gpt import GPTConfig

config = ExperimentConfig(
    rundir="",
    data_dir="/mnt/disks/persist/openwebtext",
    learning_rate=3e-4,
    batch_size=256,
    warmup_steps=2000,
    min_lr=3e-5,
    lr_decay_steps=100_000,
    max_steps=100_000,
    beta2=0.95,
    weight_decay=1e-4,
    eval_interval=1000,
    compute_dtype="bfloat16",
    param_dtype="float32",
    g_accum_iters=4,
    shard_model=True,
    mesh=MeshConfig(data=-1, fsdp=16, sp=1),
    model_config=GPTConfig(
        block_size=4096,
        vocab_size=50304,
        n_layer=32,
        n_head=32,
        n_embd=4096,
        dropout=0.0,
        attn_impl="flash",
        rope_style="split",
        decode_layer_scan=True,
    ),
)
