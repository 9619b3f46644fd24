"""1.5B GPT-2-XL-ish shape (the same values as
midgpt_tpu/configs/openwebtext_xl.py): 24 layers of 2048, 16 heads of 128,
flash attention, per-block remat with the `dots` policy (GPTConfig's
defaults). The preset's global batch of 1024 and its 8-way FSDP mesh are
a pod's; the port trains on one device, so on one card cut the batch with
`--set batch_size=...` (the launcher names the mesh it leaves unused)."""

from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.models.gpt import GPTConfig

config = ExperimentConfig(
    rundir="",
    data_dir="/mnt/disks/persist/openwebtext",
    learning_rate=1e-3,
    batch_size=1024,
    warmup_steps=2500,
    min_lr=1e-5,
    lr_decay_steps=25_000,
    max_steps=25_000,
    beta2=0.95,
    weight_decay=1e-4,
    eval_interval=1000,
    compute_dtype="bfloat16",
    param_dtype="float32",
    g_accum_iters=1,
    shard_model=True,
    mesh=MeshConfig(data=-1, fsdp=8, sp=1),
    model_config=GPTConfig(
        block_size=1024,
        vocab_size=50304,
        n_layer=24,
        n_head=16,
        n_embd=2048,
        dropout=0.0,
        attn_impl="flash",
    ),
)
