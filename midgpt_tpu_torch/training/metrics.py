"""Training metrics: FLOPs per token, MFU against the card's own peak, a
jsonl + stdout logger and the `--debug` one-step trace (counterpart of
midgpt_tpu/training/metrics.py; wandb and the progress bar are not
ported)."""

from __future__ import annotations

import json
import os
import tempfile
import time
import typing as tp

import torch

from midgpt_tpu_torch.models.gpt import GPTConfig


def flops_per_token(cfg: GPTConfig, seq_len: tp.Optional[int] = None) -> float:
    """Training FLOPs/token: 6N for the matmuls (fwd 2N + bwd 4N) plus the
    12*L*D*T attention-scores term (PaLM appendix B accounting), the tied
    embedding counted once. A routed MLP counts its ACTIVE experts (top_k
    expert MLPs and the router per token), as JAX does: the masked-dense
    lowering executes all E, so MFU counts E/top_k fewer MLP FLOPs than run."""
    T = seq_len or cfg.block_size
    D, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    if cfg.n_experts > 0:
        mlp = min(cfg.moe_top_k, cfg.n_experts) * 8 * D * D + cfg.n_experts * D
    else:
        mlp = 8 * D * D
    n_params = V * D + L * (4 * D * D + mlp + 2 * cfg.head_dim)
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
    tokens_per_sec: float, cfg: GPTConfig, device: tp.Optional[torch.device] = None, n_devices: int = 1
) -> tp.Optional[float]:
    """Model FLOPs utilization of `n_devices` such cards at a global
    `tokens_per_sec` (JAX's mfu over jax.device_count())."""
    peak = device_peak_flops(device)
    if peak is None:
        return None
    return tokens_per_sec * flops_per_token(cfg) / (peak * n_devices)


class MetricLogger:
    """One json line per log call to `rundir/metrics.jsonl` (when the run
    has a directory) and to stdout; nothing at all unless `enabled` (a
    mesh's other ranks: only its leader logs, as JAX's process 0 does)."""

    def __init__(self, rundir: str = "", enabled: bool = True):
        self._file = None
        self.enabled = enabled
        if rundir and enabled:
            os.makedirs(rundir, exist_ok=True)
            self._file = open(os.path.join(rundir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: tp.Dict[str, float]) -> None:
        if not self.enabled:
            return
        line = json.dumps({"step": step, "time": time.time(), **metrics})
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        print(line, flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class Profiler:
    """One-shot `torch.profiler` trace of one step (JAX's Profiler,
    midgpt_tpu/training/metrics.py:183): `train` starts it before the
    first step after the first and stops it after that step, under
    `debug` only. The Chrome trace goes to the run directory, or to
    `<tempdir>/midgpt_trace` when there is none, as
    `trace_step<N>.json`."""

    def __init__(self, rundir: str, enabled: bool):
        self.rundir, self.enabled = rundir, enabled
        self._prof: tp.Optional[torch.profiler.profile] = None
        self._step = -1

    def maybe_start(self, step: int, at_step: int = 0) -> None:
        if self.enabled and step == at_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._step = step

    def maybe_stop(self, wait_for: tp.Optional[torch.Tensor] = None) -> None:
        """Stop an active trace once `wait_for` is computed and export it."""
        if self._prof is None:
            return
        if wait_for is not None and wait_for.is_cuda:
            torch.cuda.synchronize(wait_for.device)
        self._prof.stop()
        out_dir = self.rundir or os.path.join(tempfile.gettempdir(), "midgpt_trace")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace_step{self._step}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"profiler: step {self._step} traced to {path}")
