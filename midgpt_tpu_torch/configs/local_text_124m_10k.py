"""The 124M local_text recipe over a 10,000-step horizon (the same values
as midgpt_tpu/configs/local_text_124m_10k.py): local_text_124m with its
warmup, decay and eval schedule scaled to 10k steps."""

from midgpt_tpu_torch.configs.local_text_124m import config as _base

config = _base.replace(
    warmup_steps=300,
    lr_decay_steps=10_000,
    max_steps=10_000,
    eval_interval=500,
    eval_steps=50,
)
