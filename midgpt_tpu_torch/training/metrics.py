"""Training metrics: FLOPs per token, MFU against the card's own peak, and
a jsonl + stdout logger (counterpart of midgpt_tpu/training/metrics.py;
wandb, the progress bar and the profiler hook are not ported)."""

from __future__ import annotations

import json
import os
import time
import typing as tp

import torch

from midgpt_tpu_torch.models.gpt import GPTConfig


def flops_per_token(cfg: GPTConfig, seq_len: tp.Optional[int] = None) -> float:
    """Training FLOPs/token: 6N for the matmuls (fwd 2N + bwd 4N) plus the
    12*L*D*T attention-scores term (PaLM appendix B accounting), the tied
    embedding counted once."""
    T = seq_len or cfg.block_size
    D, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    n_params = V * D + L * (4 * D * D + 8 * D * D + 2 * cfg.head_dim)
    return 6.0 * n_params + 12.0 * L * D * T


# Dense bf16 tensor-core peak by card name (NVIDIA's data sheets).
_PEAK_FLOPS = {"H100": 989e12}


def device_peak_flops(device: tp.Optional[torch.device] = None) -> tp.Optional[float]:
    """The card's dense bf16 peak, or None for a device this table does not
    know (the CPU included)."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, flops in _PEAK_FLOPS.items():
        if key in name:
            return flops
    return None


def mfu(
    tokens_per_sec: float, cfg: GPTConfig, device: tp.Optional[torch.device] = None
) -> tp.Optional[float]:
    peak = device_peak_flops(device)
    if peak is None:
        return None
    return tokens_per_sec * flops_per_token(cfg) / peak


class MetricLogger:
    """One json line per log call to `rundir/metrics.jsonl` (when the run
    has a directory) and to stdout."""

    def __init__(self, rundir: str = ""):
        self._file = None
        if rundir:
            os.makedirs(rundir, exist_ok=True)
            self._file = open(os.path.join(rundir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: tp.Dict[str, float]) -> None:
        line = json.dumps({"step": step, "time": time.time(), **metrics})
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        print(line, flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
