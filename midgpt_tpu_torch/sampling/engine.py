"""The batch sampler: logit warping, token sampling, the checkpoint restore
and the contiguous-cache `generate` loop (counterpart of
midgpt_tpu/sampling/engine.py).

`generate` runs one prefill over the prompt (the flash forward kernel once
per layer for flash configs), then decodes against the (n_layer, B, H_kv,
S, C) cache in chunks of DECODE_CHUNK tokens, a partial tail in
power-of-two chunks, as JAX dispatches its `_decode_chunk` programs. On
CUDA a chunk of n steps is n replays of one captured decode step
(sampling/graphs.py `StepGraphs`), with no host sync inside it; on the
CPU the same step runs eagerly. Past the cache (block_size) decoding falls
back to a windowed full forward per token, as in JAX.

torch's generators are not JAX's keys: a seed gives a different stream, so
stochastic sampling matches the JAX package in distribution only. Greedy
(temperature 0) is the first-index argmax in both, token for token.
"""

from __future__ import annotations

import dataclasses
import time
import typing as tp

import torch

from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, KVCache, Params
from midgpt_tpu_torch.sampling.graphs import StepGraphs

Tensor = torch.Tensor


def warp_logits(
    logits: Tensor,  # (..., V) float32
    temperature: float,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
) -> Tensor:
    """Temperature scaling + top-k / nucleus filtering on f32 logits. The
    warped logits DEFINE the sampling distribution. Requires temperature > 0."""
    logits = logits / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        # nucleus: keep the smallest prefix of descending-prob tokens whose
        # cumulative mass reaches top_p (the first token is always kept —
        # its exclusive prefix mass is 0)
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        exclusive_cum = torch.cumsum(probs, dim=-1) - probs
        keep = exclusive_cum < top_p
        threshold = torch.where(keep, sorted_desc, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, float("-inf"), logits)
    return logits


def sample_logits(
    logits: Tensor,  # (B, V) float
    temperature: float = 1.0,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
    generator: tp.Optional[torch.Generator] = None,
) -> Tensor:
    """Temperature + optional top-k / nucleus sampling; 0 = greedy (the
    first index of the maximum). Returns (B,) int64.

    The draw is torch.multinomial's one-sample draw spelled out — the first
    index of the maximum of p / E, E ~ Exp(1) from `generator` (the same
    tokens from the same generator state) — so it has no data-dependent
    check and can be captured in a CUDA graph (sampling/graphs.py)."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1)


def restore_for_sampling(ckpt_dir: str, config, device=None) -> tp.Tuple[tp.Dict[str, Tensor], int]:
    """Restore only the "params" item of the newest verified checkpoint
    step under `ckpt_dir` (training/checkpoint.py) onto `device` (CUDA
    unless told otherwise), in the config's param_dtype. `config` is the
    run's ExperimentConfig. Returns (params, step); prints the step. Raises
    CheckpointCorruptError, naming each step's problems, when steps exist
    but none verifies, and FileNotFoundError when there is no step."""
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.robustness.errors import CheckpointCorruptError
    from midgpt_tpu_torch.training.checkpoint import CheckpointManager
    from midgpt_tpu_torch.training.train import state_template

    mngr = CheckpointManager(ckpt_dir)
    try:
        step = mngr.latest_verified_step()
        if step is None:
            steps = mngr.all_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoint step under {ckpt_dir}")
            problems = [f"step {s}: {p}" for s in steps for p in mngr.verify(s)]
            raise CheckpointCorruptError(
                f"no verified checkpoint under {ckpt_dir}; refusing to serve any of steps {steps}:\n  "
                + "\n  ".join(problems),
                step=steps[-1],
                problems=problems,
            )
        like = {"params": state_template(config)["params"]}
        params = mngr.restore(step, like, device=resolve_device(device))["params"]
    finally:
        mngr.close()
    print(f"restored checkpoint step {step}")
    return params, step


# ----------------------------------------------------------------------
# the batch sampler
# ----------------------------------------------------------------------

# Tokens decoded per chunk. A partial tail is decomposed into power-of-two
# chunks, JAX's rule, so both packages dispatch the same chunk lengths.
DECODE_CHUNK = 64


def tokens_dtype(params: Params) -> torch.dtype:
    """The cache's dtype: the params' floating dtype."""
    return params["wte"].dtype


def _prefill_and_first(
    config: GPTConfig,
    params: Params,
    tokens: Tensor,  # (B, T) int64, T <= block_size
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    generator: tp.Optional[torch.Generator],
    cache: tp.Optional[KVCache] = None,
) -> tp.Tuple[Tensor, KVCache]:
    """Prefill `cache` (a new one if None) and sample the first token from
    the last position's logits — the only position projected onto the
    vocabulary (JAX's jit drops the other rows' logits; eager PyTorch
    would make all B x T x V of them)."""
    if cache is None:
        cache = KVCache.init(config, tokens.shape[0], tokens_dtype(params), device=tokens.device)
    x, cache = GPT.prefill_hidden(config, params, tokens, cache)
    logits = x[:, -1] @ params["lm_head"].T
    return sample_logits(logits, temperature, top_k, top_p, generator), cache


def _decode_and_sample(
    config: GPTConfig,
    params: Params,
    token: Tensor,  # (B,) the newest tokens
    cache: KVCache,
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    generator: tp.Optional[torch.Generator],
) -> tp.Tuple[Tensor, KVCache]:
    logits, cache = GPT.decode_step(config, params, token, cache)
    return sample_logits(logits, temperature, top_k, top_p, generator), cache


def _window_forward(config: GPTConfig, params: Params, window: Tensor) -> Tensor:
    """Full forward on a (B, S) window -> the last position's logits (B, V)."""
    return GPT.hidden(config, params, window, inference=True)[:, -1] @ params["lm_head"].T


@dataclasses.dataclass
class _Batch:
    """The buffers a decode step reads and writes: the cache, and the
    context's tokens by position, (B, S + 1) — the step at position p reads
    seq[:, p] and writes the token it samples to seq[:, p + 1]."""

    cache: KVCache
    seq: Tensor


def _new_batch(config: GPTConfig, batch_size: int, dtype: torch.dtype, device: torch.device) -> _Batch:
    seq = torch.zeros(batch_size, config.block_size + 1, dtype=torch.int64, device=device)
    return _Batch(KVCache.init(config, batch_size, dtype, device=device), seq)


def _decode_step(
    config: GPTConfig,
    params: Params,
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    batch: _Batch,
    generator: tp.Optional[torch.Generator],
) -> None:
    """One `_decode_and_sample` step on `batch`, in place, at the cache's
    device-side length: no host sync, so it can be captured."""
    pos = batch.cache.length.reshape(1).clone()
    token = batch.seq.index_select(1, pos)[:, 0]
    nxt, _ = _decode_and_sample(config, params, token, batch.cache, temperature, top_k, top_p, generator)
    batch.seq.index_copy_(1, pos + 1, nxt[:, None])


def _decode_chunk(
    config: GPTConfig,
    params: Params,
    batch: _Batch,
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    n_steps: int,
    generator: tp.Optional[torch.Generator],
) -> None:
    """n_steps sequential decode+sample steps on `batch`, eagerly. On CUDA
    `generate` replays the captured step n_steps times instead."""
    for _ in range(n_steps):
        _decode_step(config, params, temperature, top_k, top_p, batch, generator)


@torch.no_grad()
def generate(
    config: GPTConfig,
    params: Params,
    prompt,  # (B, T0) int: a tensor or an array
    max_new_tokens: int,
    *,
    temperature: float = 1.0,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
    generator: tp.Optional[torch.Generator] = None,
    device: DeviceLike = None,
    stats: tp.Optional[dict] = None,
    graphs: tp.Optional[StepGraphs] = None,
    _eager: bool = False,
) -> Tensor:
    """Returns (B, T0 + max_new_tokens) int64 on the host, the prompt
    included. A prompt longer than block_size S is cropped to its last S
    tokens for the model (the returned sequence keeps all of it).

    Runs on `device` (CUDA unless the caller names another), where the
    params must lie. `generator` (a seeded one on that device; None: seed
    0) drives sampling at temperature > 0. On CUDA the decode chunks are
    replays of a step captured in `graphs` (a fresh StepGraphs if None;
    pass one to reuse its captures across calls). `stats`, if given, is
    filled with the chunk lengths dispatched, the captures and replays of
    this call, the overflow tokens, and the prefill and decode seconds
    (syncs bound the prefill only when stats are asked for; a capture
    falls in neither). `_eager` runs
    the same step eagerly on CUDA too (a test hook)."""
    dev, where = resolve_device(device), params["wte"].device
    if where.type != dev.type or dev.index not in (None, where.index):
        raise ValueError(f"params lie on {where}, generate runs on {dev}")
    dev = where  # "cuda" names the current card
    prompt = torch.as_tensor(prompt).long().to(dev)
    B, T0 = prompt.shape
    S = config.block_size
    prompt_ctx = prompt[:, -S:]
    T_ctx = prompt_ctx.shape[1]
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    knobs = (temperature, top_k, top_p)
    captured = None
    captures = replays = 0
    if dev.type == "cuda" and not _eager and max_new_tokens > 1 and T_ctx < S:
        graphs = graphs if graphs is not None else StepGraphs(dev)
        captures, replays = graphs.captures, graphs.replays
        sampled = generator if temperature != 0.0 else None
        key = (B, config, tokens_dtype(params), knobs, tuple(t.data_ptr() for t in params.values()), sampled)
        captured = graphs.get(
            key,
            lambda: _new_batch(config, B, tokens_dtype(params), dev),
            lambda state, gen: _decode_step(config, params, *knobs, state, gen),
            sampled,
        )
        batch = captured.state
    else:
        batch = _new_batch(config, B, tokens_dtype(params), dev)

    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the prefill's time excludes a capture
    t_start = time.perf_counter()
    first, _ = _prefill_and_first(config, params, prompt_ctx, *knobs, generator, cache=batch.cache)
    batch.seq[:, :T_ctx] = prompt_ctx
    batch.seq[:, T_ctx] = first
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter()
    # the new tokens on the host: one copy per chunk, waited for at the end
    new = torch.empty(max_new_tokens, B, dtype=torch.int64, pin_memory=dev.type == "cuda")
    new[:1].copy_(first[None], non_blocking=True)
    produced = 1
    chunks = []

    # Incremental decode while the write position fits the cache: a chunk of
    # n steps starting after `produced` tokens last writes position T_ctx +
    # produced + n - 2, which must stay <= S - 1 (JAX's rule).
    while produced < max_new_tokens and T_ctx + produced <= S:
        budget = min(DECODE_CHUNK, max_new_tokens - produced, S - T_ctx - produced + 1)
        n = 1 << (budget.bit_length() - 1)  # the largest power of two <= budget
        if captured is not None:
            graphs.replay(captured, n)
        else:
            _decode_chunk(config, params, batch, *knobs, n, generator)
        at = T_ctx + produced
        new[produced : produced + n].copy_(batch.seq[:, at : at + n].T, non_blocking=True)
        produced += n
        chunks.append(n)

    overflow = max_new_tokens - produced
    if overflow:
        # Windowed full forward per token (the reference scheme) on the
        # last S tokens of the whole sequence.
        seq = torch.cat((prompt, batch.seq[:, T_ctx : T_ctx + produced]), dim=1)
        for _ in range(overflow):
            logits = _window_forward(config, params, seq[:, -S:])
            nxt = sample_logits(logits, temperature, top_k, top_p, generator)
            seq = torch.cat((seq, nxt[:, None]), dim=1)
        new[produced:].copy_(seq[:, T0 + produced :].T, non_blocking=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the host copies of the chunks
    out = torch.cat((prompt.cpu(), new.T), dim=1)
    if stats is not None:
        stats.update(
            chunks=chunks,
            captures=graphs.captures - captures if captured is not None else 0,
            replays=graphs.replays - replays if captured is not None else 0,
            overflow_tokens=overflow,
            prefill_s=t_prefill - t_start,
            decode_s=time.perf_counter() - t_prefill,
        )
    return out
