"""124M GPT-2-small shape, multihost data parallel (the same values as
midgpt_tpu/configs/openwebtext_mh.py). The global batch of 2048 and the
8-way mesh are several hosts'; on one card cut the batch with `--set
batch_size=...` (the launcher names the mesh it leaves unused)."""

from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.models.gpt import GPTConfig

config = ExperimentConfig(
    rundir="",
    data_dir="/mnt/disks/persist/openwebtext",
    learning_rate=1e-3,
    batch_size=2048,
    warmup_steps=5_000,
    min_lr=1e-5,
    lr_decay_steps=60_000,
    max_steps=60_000,
    beta2=0.95,
    weight_decay=1e-4,
    eval_interval=1000,
    compute_dtype="bfloat16",
    param_dtype="float32",
    g_accum_iters=1,
    shard_model=False,
    mesh=MeshConfig(data=-1, fsdp=8, sp=1),
    model_config=GPTConfig(
        block_size=1024, vocab_size=50304, n_layer=12, n_head=12, n_embd=768,
        dropout=0.0,
        rope_style="split",
    ),
)
