"""124M GPT-2-small shape trained through the flash-attention path (the
same values as midgpt_tpu/configs/local_text_124m.py): lr 1e-3 cosine to
1e-5 over 3000 steps with 300 of warmup, beta2 0.95, wd 1e-4 decoupled from
the lr, microbatch 16 x G=16 accumulation, bf16 compute over f32 master
params, remat off. Data comes from data/local_text/prepare.py.
`scan_unroll` is the JAX package's lowering knob and changes nothing here
(models/gpt.py GPTConfig)."""

from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
from midgpt_tpu_torch.models.gpt import GPTConfig

config = ExperimentConfig(
    rundir="",
    data_dir="data/local_text",
    learning_rate=1e-3,
    batch_size=16,
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
    g_accum_iters=16,  # effective batch 256
    shard_model=False,
    mesh=MeshConfig(data=-1, fsdp=1, sp=1),
    spec_layers=4,
    model_config=GPTConfig(
        block_size=1024,
        vocab_size=50304,
        n_layer=12,
        n_head=12,
        n_embd=768,
        dropout=0.0,
        attn_impl="flash",
        remat=False,
        remat_policy="flash",
        scan_unroll=12,
        rope_style="split",
    ),
)
