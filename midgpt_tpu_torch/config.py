"""Experiment configuration (counterpart of midgpt_tpu/config.py).

The same plain frozen dataclasses and field names, so a `config.json`
written by the JAX package's run directory loads here (`from_json`), and
named presets live in `midgpt_tpu_torch/configs/*.py` as modules exposing a
module-level `config` (`load_config`); `to_json` writes the run
directory's `config.json`, which either package reads back. Validation
covers the fields the port reads and the checkpoint, supervisor,
preemption, watchdog and fault knobs, as JAX checks them at the same
place; the parallelism knobs are carried for the round trip and are inert
until parallelism is ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import typing as tp

from midgpt_tpu_torch.models.gpt import GPTConfig


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh of the JAX package (data, fsdp, sp, tp, pp, ep);
    carried for config round trips — the port runs on one device."""

    data: int = -1
    fsdp: int = 8
    sp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    rundir: str
    data_dir: str
    learning_rate: float
    batch_size: int  # GLOBAL batch size across all devices
    warmup_steps: int
    min_lr: float
    lr_decay_steps: int
    max_steps: int
    beta2: float
    weight_decay: float
    eval_interval: int
    param_dtype: str  # 'float32'
    compute_dtype: str  # 'bfloat16'
    g_accum_iters: int
    shard_model: bool
    model_config: GPTConfig
    mesh: MeshConfig = MeshConfig()
    eval_steps: int = 200
    eval_host_chunk: int = 25
    log_interval: int = 20
    seed: int = 0
    data_seed: int = 1337
    fsdp_min_size: int = 2**18
    loss_chunk_tokens: int = 8192
    loss_remat_chunks: tp.Optional[bool] = None
    fsdp_mode: str = "gspmd"
    moe_aux_coef: float = 0.0
    tp_vocab: bool = True
    pipeline_microbatches: int = 0
    pipeline_schedule: str = "gpipe"
    data_step_offset: int = 0
    max_restarts: int = 2
    restart_backoff_sec: float = 1.0
    ckpt_max_to_keep: int = 2
    ckpt_write_retries: int = 3
    ckpt_retry_backoff_sec: float = 0.5
    preempt_check_interval: int = 1
    fault_plan: str = ""
    watchdog_deadline_s: float = 0.0
    watchdog_escalate: str = "raise"
    on_resume_mesh: str = "same"
    preempt_grace_s: float = 0.0
    spec_layers: int = 0
    spec_k_max: int = 4
    spec_k_min: int = 1
    spec_adapt: bool = True
    kv_cache_dtype: str = "bf16"
    debug: bool = False

    def __post_init__(self):
        mc = self.model_config
        if not (0.0 < self.beta2 < 1.0):
            raise ValueError(f"beta2={self.beta2} must be in (0, 1)")
        if mc.qkv_proj not in ("fused", "split3"):
            raise ValueError(f"unknown qkv_proj {mc.qkv_proj!r} ('fused' or 'split3')")
        if mc.rope_style == "split" and mc.head_dim % 2 != 0:
            raise ValueError("rope_style='split' needs an even head_dim")
        if mc.attn_layout not in ("seq", "head"):
            raise ValueError(f"unknown attn_layout {mc.attn_layout!r} ('seq' or 'head')")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if not 0 <= self.spec_layers < mc.n_layer:
            raise ValueError(
                f"spec_layers={self.spec_layers} must be in [0, n_layer={mc.n_layer})"
            )
        for k_name, k_val in (("spec_k_max", self.spec_k_max), ("spec_k_min", self.spec_k_min)):
            if k_val < 1 or k_val & (k_val - 1):
                raise ValueError(f"{k_name}={k_val} must be a power of two")
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"unknown kv_cache_dtype {self.kv_cache_dtype!r} ('bf16' or 'int8')"
            )
        if self.data_step_offset < 0:
            raise ValueError(f"data_step_offset={self.data_step_offset} must be >= 0")
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts={self.max_restarts} must be >= 0")
        if self.ckpt_max_to_keep < 1:
            raise ValueError(f"ckpt_max_to_keep={self.ckpt_max_to_keep} must be >= 1")
        if self.ckpt_write_retries < 1:
            raise ValueError(f"ckpt_write_retries={self.ckpt_write_retries} must be >= 1")
        if self.preempt_check_interval < 1:
            raise ValueError(
                f"preempt_check_interval={self.preempt_check_interval} must be >= 1"
            )
        if self.restart_backoff_sec < 0 or self.ckpt_retry_backoff_sec < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.watchdog_deadline_s < 0:
            # negative would expire before the first poll; 0 is the off switch
            raise ValueError(
                f"watchdog_deadline_s={self.watchdog_deadline_s} must be >= 0 (0 disables the watchdog)"
            )
        if self.watchdog_escalate not in ("raise", "exit"):
            raise ValueError(f"unknown watchdog_escalate {self.watchdog_escalate!r} ('raise' or 'exit')")
        if self.on_resume_mesh not in ("same", "any"):
            raise ValueError(f"unknown on_resume_mesh {self.on_resume_mesh!r} ('same' or 'any')")
        if self.preempt_grace_s < 0:
            raise ValueError(f"preempt_grace_s={self.preempt_grace_s} must be >= 0 (0 = unbounded)")

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def to_json(config: ExperimentConfig) -> str:
    return json.dumps(dataclasses.asdict(config), indent=2)


_NESTED: tp.Dict[str, type] = {"model_config": GPTConfig, "mesh": MeshConfig}


def from_json(text: str) -> ExperimentConfig:
    raw = json.loads(text)
    for name, cls in _NESTED.items():
        if name in raw and isinstance(raw[name], dict):
            known = {f.name for f in dataclasses.fields(cls)}
            raw[name] = cls(**{k: v for k, v in raw[name].items() if k in known})
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(**{k: v for k, v in raw.items() if k in known})


def load_config(name: str) -> ExperimentConfig:
    """Load a named preset from midgpt_tpu_torch.configs (e.g. 'openwebtext')."""
    module = importlib.import_module(f"midgpt_tpu_torch.configs.{name}")
    return module.config
