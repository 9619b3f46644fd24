"""610M wide-head (C=128) shape (the same values as
midgpt_tpu/configs/wide610m.py): GPT-2-XL width (n_embd 2048, 16 heads of
128) at 8 layers, microbatch 12, G=1, remat off, flash attention, split
RoPE; the optimizer and schedule of the 124M recipe. f32 master params,
grads and Adam state plus remat-free activations fit one 80 GB card.
`scan_unroll` and `attn_layout` are the JAX package's lowering knobs and
change nothing here (models/gpt.py GPTConfig). Data comes from
data/local_text/prepare.py."""

from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.models.gpt import GPTConfig

config = ExperimentConfig(
    rundir="",
    data_dir="data/local_text",
    learning_rate=1e-3,
    batch_size=12,
    warmup_steps=300,
    min_lr=1e-5,
    lr_decay_steps=3000,
    max_steps=3000,
    beta2=0.95,
    weight_decay=1e-4,
    eval_interval=250,
    eval_steps=50,
    compute_dtype="bfloat16",
    param_dtype="float32",
    g_accum_iters=1,
    shard_model=False,
    mesh=MeshConfig(data=-1, fsdp=1, sp=1),
    model_config=GPTConfig(
        block_size=1024,
        vocab_size=50304,
        n_layer=8,
        n_head=16,
        n_embd=2048,
        dropout=0.0,
        attn_impl="flash",
        remat=False,
        remat_policy="flash",
        scan_unroll=8,
        rope_style="split",
        attn_layout="head",
    ),
)
