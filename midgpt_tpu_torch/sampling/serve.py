"""Continuous-batching serving engine over the paged KV cache (counterpart
of midgpt_tpu/sampling/serve.py, core scheduling path).

Requests are admitted into decode slots the moment one frees, long prompts
prefill in bounded chunks interleaved with the running batch's decode
steps, and K/V live in a shared paged pool (models/gpt.py PagedKVCache)
sized to the expected working set. Scheduling is host-side and runs every
round (`ServeEngine.step`):

  1. **Expire** — requests past their deadline finish with "timeout".
  2. **Admit** — waiting requests claim free slots (the scheduler policy's
     order, FCFS by default); pages are allocated lazily.
  3. **Prefill** — every mid-prompt slot advances by at most
     `prefill_chunk` tokens (GPT.prefill_paged_chunk).
  4. **Decode** — all generating slots step together for a power-of-two
     number of steps (`_serve_decode_chunk`) over a page table cut to the
     round's pow2 page bucket, with the split-K factor from the "auto" rule
     (`_split_bucket`). On CUDA each layer's attention is the hand-written
     paged-attention kernel (kernels/attention_template.py).

Round overlap (`overlap`, `round_group`, as in the JAX engine): "off" is
the loop above, one eager `_serve_decode_chunk` per round. "group" fuses
`round_group` decode rounds into one program (`_serve_decode_group`,
settled at the group's edge within the step; finished slots are masked on
the device); "double" also keeps one group in flight while the previous
round's host work runs (`_step_overlapped`: dispatch first, then settle
the previous group, then expire/admit/prefill), so scheduler decisions
reach the device one round late. On CUDA each group is the replay of a
captured CUDA graph, one per static program key (sampling/graphs.py); on
the CPU the same body runs eagerly. `dispatch_log` records which requests
each decode dispatch carried.

With a draft model configured, step 4 is a SPECULATIVE round instead
(`_spec_round`): the draft proposes k tokens per slot with k paged decode
steps (`_spec_draft_chunk`), the target scores all k+1 positions in one
batched verify forward and the rejection sampler keeps the longest valid
prefix plus one corrected or bonus token (`_spec_verify_chunk`,
sampling/spec.py) — exactly the target's distribution at any acceptance
rate. k adapts per slot from an acceptance EMA over the pow2 range
[spec_k_min, spec_k_max]; rejected tail positions roll back page-aligned
(length counters reset, tail pages freed, the pool never rewritten). A
layer-prefix self-draft (`draft_shares_cache=True`) runs on the target's
own pool; a separate draft model keeps its own pool, prefilled beside the
target's, under the same page table.

When the pool runs dry the scheduler EVICTS a younger running slot (frees
its pages and re-queues the request at the front with its generated tokens
folded into the prompt — recompute-style preemption), so the oldest
requests always make progress. Greedy serving is token-for-token identical
to the JAX engine on the same weights (tests/test_torch_serve.py).

Pools are bf16, f32 or int8 (`cache_dtype`; ops/quant.py scales ride
beside int8 pages), at the model's K/V head count (GQA shrinks them). Under
a sliding window (`config.sliding_window`) a plain-decoding engine frees,
mid-request, every page no future row can see (`_reclaim_window`), so a
long windowed request holds O(window) pages.

Observability (`obs=`, obs/): spans of the round's phases
(`engine.expire/admit/prefill/round`, `prefill.chunk`,
`prefill.first_token`), lifecycle and fault instants, and the round
decomposition (`Observability.record_round`), on `stats()["obs"]`. Off, the
engine holds NULL_TRACER and reads no extra clock; tokens are the same
either way. The watchdog (`watchdog=`, robustness/watchdog.py) bounds the
round's one host<->device force (`_force`). The serving faults
(robustness/faults.py) strike in `step()` and `_step_overlapped` in JAX's
order, keyed on the round counter: `poisoned_page` corrupts one live
slot's first page, `kill_mid_decode` recompute-preempts every decode-ready
slot, `kill_overlapped_round` drops the in-flight group unforced and
recompute-preempts its slots; the in-flight group is settled before a
pool-mutating fault. Not ported yet (ROADMAP.md): the prefix cache and
spill tier, the byte-budgeted pool, the token and finish hooks, hot-swap/
resize and weight versions, and mesh-sharded serving. Their constructor
arguments raise NotImplementedError when set.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache, Params
from midgpt_tpu_torch.obs import DISABLED_SNAPSHOT, NULL_TRACER
from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.sampling.engine import sample_logits, warp_logits
from midgpt_tpu_torch.sampling.graphs import DecodeGraphs, GroupResult
from midgpt_tpu_torch.sampling.scheduler import FCFSScheduler, Scheduler
from midgpt_tpu_torch.sampling.spec import speculative_accept

Tensor = torch.Tensor

_CACHE_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "f32": torch.float32,
    "float32": torch.float32,
}


def normalize_cache_dtype(dtype) -> torch.dtype:
    """'bf16' | 'int8' | 'float32' | a torch dtype -> the torch dtype."""
    if isinstance(dtype, str):
        if dtype not in _CACHE_DTYPES:
            raise ValueError(f"unknown cache dtype {dtype!r} (one of {sorted(_CACHE_DTYPES)})")
        return _CACHE_DTYPES[dtype]
    return dtype


def _serve_decode_chunk(
    config: GPTConfig,
    params: Params,
    token: Tensor,  # (B,) int64
    cache: PagedKVCache,  # updated in place
    page_table: Tensor,  # (B, bucket) int32
    lengths: Tensor,  # (B,) int32
    active: Tensor,  # (B,) bool
    n_steps: int,
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    attn_impl: str,
    generator: tp.Optional[torch.Generator] = None,
    split_k: int = 1,
) -> tp.Tuple[PagedKVCache, Tensor]:
    """n_steps decode+sample steps for the whole slot batch, on the device
    with no host sync between steps. Inactive slots hold their token and
    length (they write nothing). Returns (cache, tokens (n_steps, B))."""
    toks = []
    for _ in range(n_steps):
        logits, cache = GPT.decode_step_paged(
            config, params, token, cache, page_table, lengths, active,
            attn_impl=attn_impl, split_k=split_k,
        )
        if temperature == 0.0:
            nxt = torch.argmax(logits.float(), dim=-1)
        else:
            nxt = sample_logits(logits, temperature, top_k, top_p, generator)
        token = torch.where(active, nxt.to(token.dtype), token)
        lengths = lengths + active.to(lengths.dtype)
        toks.append(token)
    return cache, torch.stack(toks)


# Cap on the fused multi-round group size: k rounds per dispatch trade
# scheduling granularity (admissions and evictions land only at group edges)
# for dispatch amortization, and past ~8 the granularity cost dominates.
_ROUND_GROUP_CAP = 8


def _round_group_bucket(group: int) -> int:
    """Clamp a requested multi-round group size to [1, _ROUND_GROUP_CAP]
    and floor it to a power of two — the ladder every other static program
    knob rides (decode chunk, page bucket, split_k), so the set of captured
    programs stays logarithmic."""
    group = max(1, min(int(group), _ROUND_GROUP_CAP))
    return 1 << (group.bit_length() - 1)


def parse_overlap(spec: str) -> tp.Tuple[str, int]:
    """Parse the `--overlap {off,double,group:k}` form into the engine's
    (overlap, round_group) arguments. Strict: anything else raises, so a
    mistyped A/B flag fails instead of silently measuring 'off'."""
    if spec in ("off", "double"):
        return spec, 1
    if spec.startswith("group:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            k = 0
        if k >= 1:
            return "group", k
    raise ValueError(f"bad overlap spec {spec!r} (want 'off', 'double', or 'group:k' with k >= 1)")


def _serve_decode_group(
    config: GPTConfig,
    params: Params,
    token: Tensor,  # (B,) int64 — host view of each slot's pending token
    cache: PagedKVCache,  # updated in place
    page_table: Tensor,  # (B, bucket) int32
    lengths: Tensor,  # (B,) int32 — host view of committed lengths
    active: Tensor,  # (B,) bool — batch membership at dispatch
    eos: Tensor,  # (B,) int64 — per-slot EOS id, -1 when the request has none
    max_len: Tensor,  # (B,) int32 — absolute settle bound per slot
    chain_mask: Tensor,  # (B,) bool — slots continuing from an unsettled group
    chain_token: Tensor,  # (B,) int64 — device-side pending token for chained slots
    chain_len: Tensor,  # (B,) int32 — device-side lengths for chained slots
    n_steps: int,
    round_group: int,
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    attn_impl: str,
    generator: tp.Optional[torch.Generator] = None,
    split_k: int = 1,
) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """`n_steps * round_group` decode+sample steps as ONE program — the
    fused multi-round group of the overlap modes (the body of a captured
    CUDA graph on CUDA, sampling/graphs.py). Differences from
    `_serve_decode_chunk`, all serving the settle-at-the-boundary rule:

      * Device-side finish masking: a slot stops stepping once its length
        reaches `max_len` (its generation budget or provisioned pages,
        whichever binds first) or it emits its EOS token. `step_active`
        masks the K/V write, the emit and the length advance, so a finished
        slot never writes past the pages it was provisioned at dispatch.
        The emitted mask tells the host exactly which tokens a sequence of
        classic rounds would have committed.
      * Chained carry-in: under overlap="double" the previous group is
        still in flight at dispatch, so the host's token/length view of its
        slots is one round stale; the true values ride in on `chain_token`
        / `chain_len` (the previous group's device outputs) and are merged
        under `chain_mask` inside the program.

    Every step runs all B slots with fixed shapes and no host sync.
    Returns (toks (T, B), emitted (T, B) bool, tok_fin (B,), len_fin (B,))
    with T = n_steps * round_group; tok_fin / len_fin seed the next group's
    chain without settling this one."""
    token = torch.where(chain_mask, chain_token, token)
    lengths = torch.where(chain_mask, chain_len, lengths)
    toks, emitted = [], []
    for _ in range(n_steps * round_group):
        # Pre-step mask: this step writes at `lengths`, so it is gated before
        # the step runs.
        step_active = active & (lengths < max_len)
        logits, cache = GPT.decode_step_paged(
            config, params, token, cache, page_table, lengths, step_active,
            attn_impl=attn_impl, split_k=split_k,
        )
        nxt = sample_logits(logits, temperature, top_k, top_p, generator)
        token = torch.where(step_active, nxt.to(token.dtype), token)
        lengths = lengths + step_active.to(lengths.dtype)
        active = active & ~(step_active & (eos >= 0) & (token == eos))
        toks.append(token)
        emitted.append(step_active)
    return torch.stack(toks), torch.stack(emitted), token, lengths


def _pack_group_inputs(token, lengths, active, eos, max_len, chain_mask, table) -> np.ndarray:
    """The group program's host inputs as ONE int64 array (one upload per
    dispatch): six (B,) rows, then the (B, bucket) page table."""
    rows = np.stack([token, lengths, active, eos, max_len, chain_mask]).astype(np.int64)
    return np.concatenate([rows.reshape(-1), table.astype(np.int64).reshape(-1)])


def _unpack_group_inputs(packed: Tensor, slots: int) -> tp.Tuple[Tensor, ...]:
    """(token, lengths, active, eos, max_len, chain_mask, page_table) of
    `_serve_decode_group`, in its dtypes, from `_pack_group_inputs`' array."""
    token, lengths, active, eos, max_len, chain_mask = packed[: 6 * slots].view(6, slots)
    table = packed[6 * slots :].view(slots, -1).to(torch.int32)
    return (token, lengths.to(torch.int32), active.bool(), eos, max_len.to(torch.int32),
            chain_mask.bool(), table)


def _spec_draft_chunk(
    config: GPTConfig,  # the DRAFT model's config
    params: Params,  # the DRAFT model's params
    token: Tensor,  # (B,) int64 — each slot's pending token
    cache: PagedKVCache,  # draft pool (the target's for a self-draft), in place
    page_table: Tensor,  # (B, bucket) int32 — shared with the target pool
    lengths: Tensor,  # (B,) int32
    active: Tensor,  # (B,) bool
    k_steps: int,
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    attn_impl: str,
    generator: tp.Optional[torch.Generator] = None,
    split_k: int = 1,
) -> tp.Tuple[Tensor, tp.Optional[Tensor]]:
    """k_steps autoregressive draft proposals for the whole slot batch,
    writing the draft pool in place, with no host sync between steps.
    Returns (drafts (k, B), probs (k, B, V) f32 or None): probs[i] is the
    warped draft distribution proposal i was drawn from — the q_i the
    rejection sampler needs — and is None for greedy, whose sampler
    compares argmaxes only."""
    toks, probs = [], []
    for _ in range(k_steps):
        logits, cache = GPT.decode_step_paged(
            config, params, token, cache, page_table, lengths, active,
            attn_impl=attn_impl, split_k=split_k,
        )
        lf = logits.float()
        if temperature == 0.0:
            nxt = torch.argmax(lf, dim=-1)
        else:
            p = torch.softmax(warp_logits(lf, temperature, top_k, top_p), dim=-1)
            nxt = torch.multinomial(p, 1, generator=generator)[:, 0]
            probs.append(p)
        token = torch.where(active, nxt.to(token.dtype), token)
        lengths = lengths + active.to(lengths.dtype)
        toks.append(token)
    return torch.stack(toks), (torch.stack(probs) if probs else None)


def _spec_verify_chunk(
    config: GPTConfig,
    params: Params,
    token: Tensor,  # (B,) int64 — each slot's pending token
    drafts: Tensor,  # (k, B) — _spec_draft_chunk's proposals, still on the device
    draft_probs: tp.Optional[Tensor],  # (k, B, V) f32, or None for greedy
    cache: PagedKVCache,  # target pool, in place
    page_table: Tensor,
    lengths: Tensor,
    active: Tensor,
    temperature: float,
    top_k: tp.Optional[int],
    top_p: tp.Optional[float],
    attn_impl: str,
    generator: tp.Optional[torch.Generator] = None,
    split_k: int = 1,
) -> tp.Tuple[PagedKVCache, Tensor, Tensor]:
    """One batched paged verify forward over [pending, d_1..d_k] plus the
    rejection sampler (sampling/spec.py): returns (cache, n_accept (B,),
    out (B, k+1)) — the host emits out[b, :n_accept[b] + 1] per active
    slot."""
    tokens = torch.cat([token[:, None], drafts.T.to(token.dtype)], dim=1)  # (B, k+1)
    logits, cache = GPT.verify_step_paged(
        config, params, tokens, cache, page_table, lengths, active,
        attn_impl=attn_impl, split_k=split_k,
    )
    n_accept, out = speculative_accept(
        logits, None if draft_probs is None else draft_probs.transpose(0, 1),
        drafts.T, generator, temperature, top_k, top_p,
    )
    return cache, torch.where(active, n_accept, 0), out


class PageAllocator:
    """Free-list allocator over the pool's pages. Page 0 is the SINK
    (models/gpt.py PagedKVCache) and is never handed out."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields 1, 2, ...

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> tp.Optional[tp.List[int]]:
        """n pages, or None (allocator unchanged) if the pool is short."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: tp.Iterable[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} is not an allocatable page of this pool")
            self._free.append(p)


class BackpressureError(RuntimeError):
    """Admission was refused — the caller should shed load or (when
    `retryable`) retry later. Structured fields: `needed_pages`,
    `backlog_pages`, `budget_pages`, `retryable` and the derived
    `retry_after_pages`."""

    def __init__(
        self,
        message: str,
        *,
        needed_pages: tp.Optional[int] = None,
        backlog_pages: tp.Optional[int] = None,
        budget_pages: tp.Optional[int] = None,
        retryable: bool = True,
    ):
        super().__init__(message)
        self.needed_pages = needed_pages
        self.backlog_pages = backlog_pages
        self.budget_pages = budget_pages
        self.retryable = retryable

    @property
    def retry_after_pages(self) -> tp.Optional[int]:
        if None in (self.needed_pages, self.backlog_pages, self.budget_pages):
            return None
        return max(0, self.backlog_pages + self.needed_pages - self.budget_pages)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (T0,) int32
    max_new_tokens: int
    eos_id: tp.Optional[int] = None
    deadline: tp.Optional[float] = None  # absolute clock() expiry


@dataclasses.dataclass
class _Slot:
    request: Request
    admit_order: int
    pages: tp.List[int] = dataclasses.field(default_factory=list)
    length: int = 0  # tokens in the paged cache
    prompt_pos: int = 0  # prompt tokens prefilled so far
    generated: tp.List[int] = dataclasses.field(default_factory=list)
    token_times: tp.List[float] = dataclasses.field(default_factory=list)
    # speculative decoding (draft engines only): the slot's current draft
    # length and the acceptance EMA that adapts it. The EMA starts
    # optimistic (1.0) so the first round cannot halve k before any evidence.
    spec_k: int = 1
    accept_ema: float = 1.0

    @property
    def prefilling(self) -> bool:
        return self.prompt_pos < len(self.request.prompt)

    @property
    def remaining(self) -> int:
        return self.request.max_new_tokens - len(self.generated)


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    tokens: np.ndarray  # prompt + generated
    token_times: tp.List[float]  # clock() completion time per new token
    status: str = "ok"  # "ok" | "timeout" | "cancelled"


@dataclasses.dataclass
class _InflightRound:
    """A dispatched-but-unsettled decode group (overlap modes).

    Holds the group's outputs on their way to the host (`result`) plus the
    host-side identity snapshot needed to settle it later: `slots` pins the
    exact _Slot objects that were in the batch, so a settle after an
    eviction, cancel or timeout skips any index whose slot object changed —
    the in-flight tokens of a departed slot are discarded (recompute
    preemption regenerates them; greedy streams do not depend on the
    batch's composition). `worst_len` is the worst-case post-settle length
    per slot — what the NEXT dispatch must assume for a chained slot whose
    true device-side length (`result.len_fin`) it merges in the program."""

    result: GroupResult
    n_steps: int  # T = n * round_group
    active_idx: tp.List[int]
    slots: tp.List[_Slot]
    worst_len: np.ndarray  # (max_slots,) int32
    t0: float  # host clock at dispatch
    t1: float = 0.0  # host clock when the dispatch returned (obs only)


class ServeEngine:
    """Host-side continuous-batching scheduler (module docstring)."""

    def __init__(
        self,
        config: GPTConfig,
        params: Params,
        *,
        max_slots: int = 4,
        num_pages: tp.Optional[int] = None,
        page_size: int = 8,
        prefill_chunk: int = 16,
        decode_chunk: int = 8,
        temperature: float = 0.0,
        top_k: tp.Optional[int] = None,
        top_p: tp.Optional[float] = None,
        seed: int = 0,
        cache_dtype=torch.bfloat16,
        attn_impl: str = "auto",
        split_k="auto",  # "auto" | int — key partitions per attention call
        max_backlog_pages: tp.Optional[int] = None,
        scheduler: tp.Optional[Scheduler] = None,
        clock: tp.Callable[[], float] = time.perf_counter,
        device: DeviceLike = None,
        draft_params: tp.Optional[Params] = None,
        draft_config: tp.Optional[GPTConfig] = None,
        draft_shares_cache: bool = False,
        spec_k_max: int = 4,
        spec_k_min: int = 1,
        spec_adapt: bool = True,
        overlap: str = "off",  # "off" | "double" | "group" (module docstring)
        round_group: int = 1,  # fused rounds per dispatch (pow2-bucketed)
        obs=None,  # obs.Observability, or None: no tracing
        watchdog=None,  # robustness.watchdog.StepWatchdog bounding the round's force
        # Not ported yet (ROADMAP.md): setting any of these raises.
        pool_hbm_bytes: tp.Optional[int] = None,
        prefix_cache: bool = False,
        on_token: tp.Optional[tp.Callable[[int, int, float], None]] = None,
        on_finish: tp.Optional[tp.Callable[["FinishedRequest"], None]] = None,
        mesh=None,
        weights_version: str = "inline",
    ):
        unported = {
            "pool_hbm_bytes": pool_hbm_bytes is not None,
            "prefix_cache": bool(prefix_cache),
            "on_token": on_token is not None,
            "on_finish": on_finish is not None,
            "mesh": mesh is not None,
            "weights_version": weights_version != "inline",
        }
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet (ROADMAP.md "
                    "port queue: serving periphery)"
                )
        if decode_chunk < 1 or decode_chunk & (decode_chunk - 1):
            raise ValueError(f"decode_chunk={decode_chunk} must be a power of two")
        if split_k != "auto" and (not isinstance(split_k, int) or split_k < 1):
            raise ValueError(f"split_k must be 'auto' or a positive int, got {split_k!r}")
        if attn_impl not in ("auto", "kernel", "gather"):
            raise ValueError(f"unknown attn_impl {attn_impl!r} ('auto', 'kernel' or 'gather')")
        if overlap not in ("off", "double", "group"):
            raise ValueError(f"overlap must be 'off', 'double' or 'group', got {overlap!r}")
        # A draft model turns every decode round into draft-k-then-verify
        # (module docstring). Both pools share the page table and allocator:
        # one logical page maps to the same physical index in each.
        if (draft_params is None) != (draft_config is None):
            raise ValueError("draft_params and draft_config come together")
        if draft_config is not None:
            if draft_config.block_size != config.block_size:
                raise ValueError(
                    f"draft block_size {draft_config.block_size} != target "
                    f"{config.block_size} — the shared page table assumes equal position spaces"
                )
            for k_name, k_val in (("spec_k_max", spec_k_max), ("spec_k_min", spec_k_min)):
                if k_val < 1 or k_val & (k_val - 1):
                    raise ValueError(f"{k_name}={k_val} must be a power of two")
            if spec_k_min > spec_k_max:
                raise ValueError(f"spec_k_min={spec_k_min} > spec_k_max={spec_k_max}")
            if draft_shares_cache and (
                draft_config.n_head != config.n_head
                or draft_config.head_dim != config.head_dim
                or draft_config.n_layer >= config.n_layer
            ):
                raise ValueError(
                    "draft_shares_cache requires a layer-prefix draft: same "
                    "n_head/head_dim, fewer layers (sampling/spec.py self_draft)"
                )
        self.device = resolve_device(device)
        self.config = config
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.scheduler = scheduler if scheduler is not None else FCFSScheduler()
        self._clock = clock
        # Host-side instrumentation (module docstring): without obs every
        # site calls NULL_TRACER and reads no extra clock.
        self.obs = obs
        self._trace = obs.tracer if obs is not None else NULL_TRACER
        self._obs_tid = "engine"  # the trace's lane
        self.watchdog = watchdog
        self.page_size = page_size
        self.max_slots = max_slots
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        self.attn_impl = attn_impl
        # "auto" picks a per-round pow2 split from the page bucket
        # (_split_bucket); an int forces that split for every round.
        self.split_k = split_k
        self.max_pages_per_slot = -(-config.block_size // page_size)
        self.cache_dtype = normalize_cache_dtype(cache_dtype)
        if num_pages is None:
            # Half of what dedicated full-length caches would take (+ the
            # sink): the continuous-batching bet that the sum of used
            # lengths stays well under n_slots * block_size.
            num_pages = 1 + max_slots * self.max_pages_per_slot // 2
        self.max_backlog_pages = max_backlog_pages
        self.allocator = PageAllocator(num_pages)
        self.cache = PagedKVCache.init(
            config, num_pages=num_pages, page_size=page_size,
            dtype=self.cache_dtype, device=self.device,
        )
        self.draft_config = draft_config
        self.draft_params = (
            None if draft_params is None else {k: v.to(self.device) for k, v in draft_params.items()}
        )
        self.draft_shares_cache = draft_shares_cache
        self.spec_k_max, self.spec_k_min, self.spec_adapt = spec_k_max, spec_k_min, spec_adapt
        # A layer-prefix self-draft needs no pool of its own: its layer i IS
        # the target's layer i, so the committed K/V it attends to already
        # sit in the target pool (it runs against the WHOLE pool and touches
        # only its first n_layer layers), and its speculative writes there
        # are the values the verify forward rewrites before reading them.
        # It also skips prompt prefill. A separate draft gets its own pool.
        self.draft_cache = (
            None
            if draft_config is None or draft_shares_cache
            else PagedKVCache.init(
                draft_config, num_pages=num_pages, page_size=page_size,
                dtype=self.cache_dtype, device=self.device,
            )
        )
        self.slots: tp.List[tp.Optional[_Slot]] = [None] * max_slots
        self.queue: tp.List[Request] = []
        self.finished: tp.Dict[int, FinishedRequest] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # Round overlap (module docstring). Speculative engines keep their
        # draft-then-verify rounds in every mode, as in JAX: overlapping them
        # would re-order the rollback against the next draft.
        self.overlap = overlap
        self.round_group = _round_group_bucket(round_group)
        self._inflight: tp.Optional[_InflightRound] = None
        # Killed in-flight groups (kill_overlapped_round) and killed decode
        # rounds (kill_mid_decode); uids whose pages poisoned_page corrupted.
        self.overlap_kills = 0
        self.decode_kills = 0
        self.poisoned_uids: tp.List[int] = []
        self._poisoned_pages: tp.Set[int] = set()  # corrupted, scrubbed when freed
        # (round, (uid, ...)) per decode dispatch: a request admitted or
        # evicted during round N's host work first appears in (disappears
        # from) dispatch N+1, or N+2 under "double".
        self.dispatch_log: tp.Deque[tp.Tuple[int, tp.Tuple[int, ...]]] = collections.deque(maxlen=256)
        # On CUDA every group is a CUDA-graph replay; never eager there.
        self._graphs = (
            DecodeGraphs(self.device, max_slots, self._gen)
            if self.device.type == "cuda" and overlap != "off" and draft_config is None
            else None
        )
        self._uid = 0
        self._admitted = 0
        # Counters (stats()): recompute-style preemptions, scheduling
        # rounds, deadline timeouts, admission sheds, cancellations, decode
        # dispatches per split-K factor, decode steps dispatched (each one
        # forward of the slot batch; a group's masked steps included), and
        # decode tokens / seconds (host clock from a dispatch to the end of
        # its settle, which waits for that dispatch alone).
        self.preemptions = 0
        self.rounds = 0
        self.timeouts = 0
        self.shed = 0
        self.cancelled = 0
        self.split_rounds: tp.Counter[int] = collections.Counter()
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        # Speculative counters (spec_stats()): verify forwards, (slot, round)
        # pairs verified, draft decode steps, drafted and accepted tokens.
        # decode_tokens / decode_seconds cover speculative rounds too.
        self._spec_rounds = 0
        self._spec_verifies = 0
        self._spec_draft_steps = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        # Sliding-window page reclamation (config.sliding_window > 0, no
        # draft): pages freed mid-request behind every future row's window.
        self.window_reclaimed_pages = 0

    # -- public surface ------------------------------------------------

    def submit(
        self,
        prompt: tp.Sequence[int],
        max_new_tokens: int,
        eos_id: tp.Optional[int] = None,
        ttl_s: tp.Optional[float] = None,
    ) -> int:
        """Queue a request. `ttl_s` bounds its total residence time. Raises
        BackpressureError when the scheduler policy sheds the request."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        S = self.config.block_size
        if len(prompt) + max_new_tokens > S:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds block_size ({S})"
            )
        need = -(-(len(prompt) + max_new_tokens) // self.page_size)
        if need > self.allocator.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.allocator.num_pages - 1} allocatable"
            )
        now = self._clock()
        deadline = None if ttl_s is None else now + ttl_s
        shed = self.scheduler.shed_reason(need, deadline, self, now)
        if shed is not None:
            message, retryable = shed
            self.shed += 1
            self._trace.instant(
                "shed", "lifecycle", self._obs_tid, args={"needed_pages": need, "retryable": retryable}
            )
            raise BackpressureError(
                message,
                needed_pages=need,
                backlog_pages=self._backlog_pages(),
                budget_pages=self.max_backlog_pages,
                retryable=retryable,
            )
        uid = self._uid
        self._uid += 1
        self.queue.append(Request(uid, prompt, max_new_tokens, eos_id, deadline))
        return uid

    def _backlog_pages(self) -> int:
        """Worst-case page demand (prompt + whole generation budget) of
        every live request, queued or running."""

        def worst(req: Request) -> int:
            return -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)

        return sum(worst(r) for r in self.queue) + sum(
            worst(s.request) for s in self.slots if s is not None
        )

    @property
    def idle(self) -> bool:
        # An unsettled in-flight group is pending work: its tokens are not
        # committed until the next step settles it.
        return not self.queue and all(s is None for s in self.slots) and self._inflight is None

    def run(self) -> tp.Dict[int, FinishedRequest]:
        """Drive step() until everything submitted so far has finished."""
        while not self.idle:
            self.step()
        return self.finished

    def cancel(self, uid: int, status: str = "cancelled") -> bool:
        """Finish a queued or running request NOW: its pages return to the
        pool and its partial tokens are recorded under `status`; no other
        slot is touched. False if `uid` is unknown or already finished."""
        for qi, req in enumerate(self.queue):
            if req.uid == uid:
                self.queue.pop(qi)
                self.cancelled += 1
                self._finish(FinishedRequest(uid=uid, tokens=req.prompt, token_times=[], status=status))
                return True
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.uid == uid:
                self.cancelled += 1
                self._finish(self._finished_from(slot, status))
                self._release_slot(slot)
                self.slots[i] = None
                return True
        return False

    def cache_hbm_bytes(self) -> int:
        """Device bytes of the paged pools (K and V, int8 scales included,
        and a separate draft's pool)."""
        return self.cache.nbytes + (0 if self.draft_cache is None else self.draft_cache.nbytes)

    def stats(self) -> tp.Dict[str, tp.Any]:
        """Deployment-shape + counter snapshot."""
        return {
            "device": str(self.device),
            "cache_dtype": str(self.cache_dtype).replace("torch.", ""),
            "cache_hbm_bytes": self.cache_hbm_bytes(),
            "num_pages": self.allocator.num_pages,
            "rounds": self.rounds,
            "preemptions": self.preemptions,
            "timeouts": self.timeouts,
            "shed": self.shed,
            "cancelled": self.cancelled,
            "split_rounds": dict(sorted(self.split_rounds.items())),
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_seconds": self.decode_seconds,
            "window_reclaimed_pages": self.window_reclaimed_pages,
            "overlap_mode": self.overlap,
            "round_group": self.round_group,
            "overlap_kills": self.overlap_kills,
            "decode_kills": self.decode_kills,
            "poisoned_uids": list(self.poisoned_uids),
            "decode_graphs": None if self._graphs is None else self._graphs.stats(),
            "spec": self.spec_stats() if self.draft_config is not None else None,
            # {"enabled": False} without an Observability: consumers key on the flag
            "obs": DISABLED_SNAPSHOT if self.obs is None else self.obs.snapshot(),
        }

    def spec_stats(self) -> tp.Dict[str, float]:
        """Speculative counters since construction: verify rounds, draft
        decode steps, acceptance rate (accepted drafts / drafted) and tokens
        emitted per verify forward per slot (1.0 means speculation never
        pays: every verify also yields its correction or bonus token)."""
        return {
            "rounds": self._spec_rounds,
            "draft_steps": self._spec_draft_steps,
            "accept_rate": self._spec_accepted / max(self._spec_drafted, 1),
            "tokens_per_verify": (self._spec_accepted + self._spec_verifies) / max(self._spec_verifies, 1),
        }

    # -- scheduling round ----------------------------------------------

    def step(self) -> None:
        """One round: expire -> admit -> prefill chunks -> one decode chunk
        (or one draft-then-verify speculative round). overlap="group" keeps
        this order and fuses round_group decode rounds into the one dispatch;
        overlap="double" (no draft) runs `_step_overlapped`'s order.

        The serving faults fire here, keyed on the round counter, so a
        seeded trace makes every firing deterministic (`kill_mid_decode@7`
        strikes round 7)."""
        if self.overlap == "double" and self.draft_config is None:
            self._step_overlapped()
            return
        self.rounds += 1
        tr = self._trace
        t_round = 0.0 if self.obs is None else self._clock()
        if faults.should_fire("poisoned_page", step=self.rounds):
            tr.instant("fault.poisoned_page", "fault", self._obs_tid)
            self._poison_page()
        self._host_phases()
        if faults.should_fire("kill_mid_decode", step=self.rounds):
            tr.instant("fault.kill_mid_decode", "fault", self._obs_tid)
            self._kill_decode_round()
        elif self.draft_config is not None:
            self._spec_round()
        elif self.overlap == "group":
            self._decode_round_grouped()
        else:
            self._decode_round()
        self._round_span(t_round)

    def _step_overlapped(self) -> None:
        """One double-buffered round: dispatch round k's group FIRST —
        chaining the device-side token/length state of the unsettled round
        k-1 — then settle round k-1 (which waits for round k-1 alone) and run
        the host phases (expire, admit, prefill) while round k computes. A
        request admitted or evicted during them first appears in (disappears
        from) dispatch k+2, never mid-flight. A fault that mutates the pool
        assumes a settled round boundary, so the in-flight group is settled
        before it strikes."""
        self.rounds += 1
        tr = self._trace
        t_round = 0.0 if self.obs is None else self._clock()
        if self._inflight is not None and self._fault_needs_drain():
            self._settle_inflight()
        if self._inflight is not None and faults.should_fire("kill_overlapped_round", step=self.rounds):
            tr.instant("fault.kill_overlapped_round", "fault", self._obs_tid)
            self._kill_overlapped_round()
        if faults.should_fire("poisoned_page", step=self.rounds):
            tr.instant("fault.poisoned_page", "fault", self._obs_tid)
            self._poison_page()
        if faults.should_fire("kill_mid_decode", step=self.rounds):
            # This round's dispatch dies: settle the previous group (its
            # tokens landed before the failure), then recompute-preempt the
            # decode-ready slots as the classic path does.
            tr.instant("fault.kill_mid_decode", "fault", self._obs_tid)
            self._settle_inflight()
            self._kill_decode_round()
            handle = None
        else:
            handle = self._dispatch_decode(self._inflight)
        prev, self._inflight = self._inflight, handle
        if prev is not None:
            self._settle_round(prev)
        self._host_phases()
        self._round_span(t_round)

    def _host_phases(self) -> None:
        tr = self._trace
        with tr.span("engine.expire", "phase", self._obs_tid):
            self._expire_round()
        with tr.span("engine.admit", "phase", self._obs_tid):
            self._admit()
        with tr.span("engine.prefill", "phase", self._obs_tid):
            self._prefill_round()

    def _round_span(self, t_round: float) -> None:
        if self.obs is not None:
            self._trace.complete("engine.round", "round", self._obs_tid, t_round, self._clock() - t_round,
                                 args={"round": self.rounds})

    # -- faults and the watchdog (robustness/) ---------------------------

    def _evict_youngest_first(self, victims: tp.List[_Slot]) -> None:
        """Recompute-preempt `victims`, youngest first: each _evict inserts
        at the queue FRONT, so the queue ends oldest-first."""
        for s in sorted(victims, key=lambda s: s.admit_order, reverse=True):
            self._evict(s)

    def _kill_decode_round(self) -> None:
        """The `kill_mid_decode` fault: this round's decode dispatch died and
        its tokens never landed. Every decode-ready slot is
        recompute-preempted (pages freed, generated tokens folded into the
        prompt, re-queued oldest-first), so the requests re-prefill and
        continue; greedy streams come out as an unfaulted run's.
        Mid-prefill slots are untouched: their chunks already landed."""
        self._evict_youngest_first(
            [s for s in self.slots if s is not None and not s.prefilling and s.remaining > 0]
        )
        self.decode_kills += 1

    # Faults that mutate the pool mid-round and so assume a settled round
    # boundary (JAX also drains for evict_shared_prefix, hot_swap_mid_decode
    # and pool_resize, which arrive with the serving periphery).
    _DRAIN_FAULTS = ("poisoned_page",)

    def _fault_needs_drain(self) -> bool:
        """Peek, without consuming, whether a boundary-assuming fault can
        fire this round; `should_fire` later in the step consumes it."""
        return any(
            f.kind in self._DRAIN_FAULTS and f.times > 0 and (f.step is None or f.step == self.rounds)
            for f in faults.active()
        )

    def _force(self, fn: tp.Callable[[], tp.Any], label: str) -> tp.Any:
        """The one funnel every decode-path host<->device force takes:
        through the watchdog when one is armed."""
        if self.watchdog is not None:
            return self.watchdog.sync(fn, label=label)
        return fn()

    def _settle_inflight(self) -> None:
        """Settle the in-flight group now, if any (the drain point)."""
        h, self._inflight = self._inflight, None
        if h is not None:
            self._settle_round(h)

    def _kill_overlapped_round(self) -> None:
        """The `kill_overlapped_round` fault: the in-flight group died while
        the previous round's host work ran. Its tokens never land — the
        handle is dropped without forcing (on CUDA its replay still runs, in
        stream order before anything that reuses the pages freed here) — and
        every slot of the killed batch still present is recompute-preempted,
        as under kill_mid_decode. Other slots are untouched."""
        h, self._inflight = self._inflight, None
        if h is None:
            return
        self.overlap_kills += 1
        self._evict_youngest_first(
            [s for idx, s in zip(h.active_idx, h.slots) if self.slots[idx] is s and s.remaining > 0]
        )

    def _poison_page(self) -> None:
        """The `poisoned_page` fault: corrupt the first live page of the
        youngest running slot in place (NaN in a float pool, 127 in an int8
        one), modelling memory damage to committed K/V. Nothing recovers it:
        page tables never alias live pages, so every OTHER slot's stream
        stays as an unfaulted run's and the pool stays conserved; the page
        is scrubbed when it is freed (`_free_pages`). The slots mapping the
        page land in `poisoned_uids`."""
        victim = max(
            (s for s in self.slots if s is not None and any(p >= 0 for p in s.pages)),
            key=lambda s: s.admit_order,
            default=None,
        )
        if victim is None:
            return
        page = next(p for p in victim.pages if p >= 0)
        bad = float("nan") if self.cache.k.dtype.is_floating_point else 127
        self.cache.k[:, :, page] = bad
        self.cache.v[:, :, page] = bad
        self._poisoned_pages.add(page)
        for s in self.slots:
            if s is not None and page in s.pages and s.request.uid not in self.poisoned_uids:
                self.poisoned_uids.append(s.request.uid)

    def _expire_round(self) -> None:
        """Finish every deadline-expired request with a `timeout` status:
        queued ones leave the queue, running ones free their pages now.
        Tokens generated before the deadline are returned."""
        now = self._clock()

        def expired(req: Request) -> bool:
            return req.deadline is not None and now > req.deadline

        still_queued = []
        for req in self.queue:
            if expired(req):
                self.timeouts += 1
                self._finish(FinishedRequest(uid=req.uid, tokens=req.prompt, token_times=[], status="timeout"))
            else:
                still_queued.append(req)
        self.queue[:] = still_queued
        for i, slot in enumerate(self.slots):
            if slot is not None and expired(slot.request):
                self.timeouts += 1
                self._finish(self._finished_from(slot, "timeout"))
                self._release_slot(slot)
                self.slots[i] = None

    def _admit(self) -> None:
        now = self._clock()
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                # Admission ORDER is the scheduler's call.
                qi = self.scheduler.select_admit(self.queue, now)
                if qi is None:
                    break
                req = self.queue.pop(qi)
                # a preempted request restarts its k adaptation like a fresh one
                self.slots[i] = _Slot(req, self._admitted, spec_k=self.spec_k_max)
                self._admitted += 1
                self._trace.instant("admitted", "lifecycle", self._obs_tid, args={"uid": req.uid, "slot": i})

    def _ensure_pages(self, slot: _Slot, upto_tokens: int) -> bool:
        """Grow slot's page list to cover positions [0, upto_tokens); True
        on success. On pool exhaustion the scheduler picks a preemption
        victim among the STRICTLY YOUNGER running slots (so the oldest
        request always makes progress) and the allocation retries; False
        only when no younger victim exists or the policy defers."""
        need = -(-upto_tokens // self.page_size) - len(slot.pages)
        while need > 0:
            got = self.allocator.alloc(need)
            if got is not None:
                slot.pages.extend(got)
                return True
            candidates = [
                s for s in self.slots if s is not None and s.admit_order > slot.admit_order
            ]
            if not candidates:
                return False
            victim = self.scheduler.select_victim(slot, candidates, self._clock())
            if victim is None:
                return False
            if not any(victim is c for c in candidates):
                raise RuntimeError(
                    f"scheduler {self.scheduler.name!r} returned a "
                    "non-candidate victim — preemption must pick from the "
                    "strictly-younger running slots it was offered"
                )
            self._evict(victim)
        return True

    def _evict(self, victim: _Slot) -> None:
        """Recompute-style preemption: fold generated tokens into the
        prompt, free the pages, and re-queue at the FRONT so the request
        resumes (by re-prefilling) as soon as the pool breathes."""
        i = self.slots.index(victim)
        req = victim.request
        new_prompt = np.concatenate([req.prompt, np.asarray(victim.generated, np.int32)])
        self.queue.insert(
            0,
            Request(
                req.uid,
                new_prompt,
                req.max_new_tokens - len(victim.generated),
                req.eos_id,
                req.deadline,  # the clock keeps running across preemptions
            ),
        )
        self._release_slot(victim)
        self.slots[i] = None
        self.preemptions += 1
        self._trace.instant("preempt", "lifecycle", self._obs_tid, args={"uid": req.uid})

    def _release_slot(self, slot: _Slot) -> None:
        """The ONE funnel a departing slot's pages go through (finish,
        cancel, timeout, preemption). -1 entries are window-reclaimed
        placeholders, already freed."""
        self._free_pages([p for p in slot.pages if p >= 0])

    def _free_pages(self, pages: tp.List[int]) -> None:
        """Return pages to the pool, scrubbing any that `poisoned_page`
        corrupted first: a recycled page keeps its old contents in the
        columns its next owner has not written yet, and the attention's
        masked columns weigh those by 0 — 0 * NaN would reach the new
        owner's stream. (The JAX engine returns the page as is.)"""
        bad = [p for p in pages if p in self._poisoned_pages]
        if bad:
            idx = torch.as_tensor(bad, device=self.device)
            self.cache.k[:, :, idx] = 0
            self.cache.v[:, :, idx] = 0
            self._poisoned_pages.difference_update(bad)
        self.allocator.free(pages)

    def _page_table(self, n_pages: tp.Optional[int] = None) -> np.ndarray:
        """(max_slots, n_pages) int32 host table; unallocated entries point
        at the sink page 0, and so do window-reclaimed ones (-1 in
        slot.pages): the kernel's sweep skips them and the mask hides their
        columns, but every entry must name a real page — a -1 reaching the
        kernel would be an out-of-bounds read."""
        table = np.zeros((self.max_slots, n_pages or self.max_pages_per_slot), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                pages = s.pages[: table.shape[1]]
                table[i, : len(pages)] = pages
        np.maximum(table, 0, out=table)
        return table

    def _reclaim_window(self, slot: _Slot) -> None:
        """Free this slot's pages that no FUTURE attention row can see.

        Page j (positions [j*ps, (j+1)*ps)) is dead once the oldest visible
        position has moved past it — counts only grow, so (j+1)*ps <=
        length - sliding_window is permanent — unless it holds sink tokens.
        Freed entries become -1 placeholders, so the page list keeps its
        logical length (position -> table column stays the identity) and
        `_page_table` parks them on the sink page. Off with a draft model
        (a verify rollback re-reads recent history). Conservation becomes
        free + live non-placeholder pages == num_pages - 1."""
        W = self.config.sliding_window
        if not W or self.draft_config is not None:
            return
        ps = self.page_size
        first_live = max(0, slot.length - W) // ps  # pages below are dead
        sink_pages = -(-self.config.attn_sinks // ps)  # keep the sink prefix
        dead = [j for j in range(sink_pages, first_live) if slot.pages[j] >= 0]
        if not dead:
            return
        self._free_pages([slot.pages[j] for j in dead])
        for j in dead:
            slot.pages[j] = -1
        self.window_reclaimed_pages += len(dead)

    def _page_bucket(self, max_tokens: int) -> int:
        """Smallest power-of-two page count covering `max_tokens` positions
        (capped at the per-slot maximum): attention is O(bucket) per slot,
        i.e. O(longest active request), not O(block_size)."""
        need = -(-max_tokens // self.page_size)
        b = 1
        while b < need:
            b *= 2
        return min(b, self.max_pages_per_slot)

    def _split_bucket(self, max_tokens: int) -> int:
        """Split-K factor for a round whose widest slot spans `max_tokens`
        positions: double the split for every page-bucket doubling past 512
        tokens (so each partition sweeps >= 512 tokens), capped at 8.
        Traffic at or under 512 tokens resolves to 1. A forced int skips
        the rule (the kernels normalize it to a pow2 divisor of the
        round's table width)."""
        if self.split_k != "auto":
            return self.split_k
        tokens = self._page_bucket(max_tokens) * self.page_size
        split = 1
        while split < 8 and tokens // (2 * split) >= 512:
            split *= 2
        return split

    def _prefill_round(self) -> None:
        """Advance every mid-prompt slot by one (padded) chunk."""
        for slot_i, slot in enumerate(self.slots):
            if slot is not None and slot.prefilling:
                self._prefill_one(slot_i, slot)

    def _prefill_one(self, slot_i: int, slot: _Slot) -> None:
        prompt = slot.request.prompt
        n_valid = min(self.prefill_chunk, len(prompt) - slot.prompt_pos)
        if not self._ensure_pages(slot, slot.prompt_pos + n_valid):
            return  # pool fully ours and still short — wait for finishes
        if self.slots[slot_i] is not slot:
            return
        chunk = np.zeros((1, self.prefill_chunk), np.int64)
        chunk[0, :n_valid] = prompt[slot.prompt_pos : slot.prompt_pos + n_valid]
        bucket = self._page_bucket(slot.prompt_pos + n_valid)
        row = torch.as_tensor(self._page_table(bucket)[slot_i : slot_i + 1], device=self.device)
        chunk_t = torch.as_tensor(chunk, device=self.device)
        # the span covers the enqueue only: nothing here waits for the device
        with self._trace.span("prefill.chunk", "prefill", self._obs_tid):
            logits, self.cache = GPT.prefill_paged_chunk(
                self.config, self.params, chunk_t, slot.prompt_pos, n_valid, self.cache, row,
            )
            if self.draft_cache is not None:
                # A separate draft's pool must hold the same positions as the
                # target's; its logits are discarded (the pending token is the
                # target's). A self-draft's layers were just filled above.
                _, self.draft_cache = GPT.prefill_paged_chunk(
                    self.draft_config, self.draft_params, chunk_t, slot.prompt_pos, n_valid,
                    self.draft_cache, row,
                )
        slot.prompt_pos += n_valid
        slot.length = slot.prompt_pos
        self._reclaim_window(slot)  # long prompts free behind-window pages
        if not slot.prefilling:
            # Prompt complete: the first generated token comes from the last
            # valid prompt position's logits (greedy: first-index argmax).
            # the int() is the sync: the span holds the last chunk's device time
            with self._trace.span("prefill.first_token", "prefill", self._obs_tid):
                last = logits[0, n_valid - 1]
                if self.temperature == 0.0:
                    tok = int(torch.argmax(last.float()))
                else:
                    tok = int(sample_logits(last[None], self.temperature, self.top_k, self.top_p, self._gen)[0])
            self._append_token(slot_i, slot, tok, self._clock())

    def _ready_slots(self) -> tp.List[int]:
        """Indices of the slots that generate this round."""
        return [
            i
            for i, s in enumerate(self.slots)
            if s is not None and not s.prefilling and s.remaining > 0
        ]

    def _grow_for_round(self, active_idx: tp.List[int], n_new: int) -> tp.List[int]:
        """Give every ready slot pages for `n_new` more positions; returns
        the slots that got them (an older slot's growth may evict a younger
        one, and a slot whose pages are held by older ones waits)."""
        for i in list(active_idx):
            slot = self.slots[i]
            if slot is None:
                # An older slot's _ensure_pages earlier in this loop evicted
                # this one; it is already re-queued.
                active_idx.remove(i)
                continue
            if not self._ensure_pages(slot, slot.length + n_new):
                # The pool is held by slots at least as old as this one:
                # defer the slot to a later round.
                active_idx.remove(i)
        return [i for i in active_idx if self.slots[i] is not None]

    def _round_inputs(self, active_idx: tp.List[int]) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(pending token, length, active) per slot, host arrays."""
        token = np.zeros((self.max_slots,), np.int64)
        lengths = np.zeros((self.max_slots,), np.int32)
        active = np.zeros((self.max_slots,), bool)
        for i in active_idx:
            s = self.slots[i]
            token[i] = s.generated[-1] if s.generated else s.request.prompt[-1]
            lengths[i] = s.length
            active[i] = True
        return token, lengths, active

    def _decode_round(self) -> None:
        active_idx = self._ready_slots()
        if not active_idx:
            return
        S = self.config.block_size
        budget = min(
            self.decode_chunk,
            min(self.slots[i].remaining for i in active_idx),
            min(S - self.slots[i].length for i in active_idx),
        )
        n = 1 << (budget.bit_length() - 1)  # largest power of two <= budget
        active_idx = self._grow_for_round(active_idx, n)
        if not active_idx:
            return

        t0 = self._clock()
        token, lengths, active = self._round_inputs(active_idx)
        round_span = max(self.slots[i].length for i in active_idx) + n
        bucket = self._page_bucket(round_span)
        split = self._split_bucket(round_span)
        dev = self.device
        self.cache, toks = _serve_decode_chunk(
            self.config,
            self.params,
            torch.as_tensor(token, device=dev),
            self.cache,
            # the table cut to the bucket width, so the kernel's split-K
            # normalization sees the same max_pages as the JAX engine
            torch.as_tensor(self._page_table(bucket), device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(active, device=dev),
            n,
            self.temperature,
            self.top_k,
            self.top_p,
            self.attn_impl,
            self._gen,
            split,
        )
        t1 = 0.0 if self.obs is None else self._clock()
        self.dispatch_log.append((self.rounds, tuple(self.slots[i].request.uid for i in active_idx)))
        out = toks
        toks = self._force(lambda: out.cpu().numpy(), "serve.decode_sync")  # the round's one device sync
        t_done = self._clock()
        self.split_rounds[split] += 1
        self.decode_steps += n
        self.decode_seconds += t_done - t0
        for i in active_idx:
            slot = self.slots[i]
            if slot is None:
                continue
            for j in range(n):
                slot.length += 1
                self.decode_tokens += 1
                if self._append_token(i, slot, int(toks[j, i]), t_done):
                    break  # finished (max_new or EOS); rest of chunk discarded
        if self.obs is not None:
            self.obs.record_round("decode", self._obs_tid, t0, t1, t_done, self._clock())

    def _decode_round_grouped(self) -> None:
        """overlap="group": one fused multi-round dispatch, settled at the
        group's edge within the same step (no in-flight carry-over)."""
        h = self._dispatch_decode(None)
        if h is not None:
            self._settle_round(h)

    def _dispatch_decode(self, prev: tp.Optional[_InflightRound]) -> tp.Optional[_InflightRound]:
        """Assemble and ENQUEUE one multi-round decode group without waiting
        for it; returns the in-flight handle (None when nothing can decode).
        `prev` is the still-unsettled previous group under "double": its
        slots are CHAINED — their true token/length state rides in on its
        device outputs and is merged in the program under `chain_mask`, so
        the host's one-round-stale view never reaches the device. A chained
        slot's pages are provisioned from its WORST-CASE post-settle length
        (prev.worst_len); if the pool cannot cover a full group the slot
        falls back to one sub-round, and failing that it rides along masked
        (chained: the device takes zero steps for it) or defers to a later
        round (fresh)."""
        chained: tp.Set[int] = set()
        if prev is not None:
            chained = {idx for idx, s in zip(prev.active_idx, prev.slots) if self.slots[idx] is s}
        S = self.config.block_size
        ps = self.page_size

        def _want(s: _Slot) -> int:
            # The settle bound: at length P + max_new - 1 the request has
            # committed its whole generation budget (_append_token's count).
            req = s.request
            return min(len(req.prompt) + req.max_new_tokens - 1, S)

        def _base(i: int, s: _Slot) -> int:
            return int(prev.worst_len[i]) if i in chained else s.length

        cand = []
        for i, s in enumerate(self.slots):
            if s is None or s.prefilling:
                continue
            if i not in chained and s.remaining <= 0:
                continue
            if _base(i, s) < _want(s):
                cand.append((i, s))
        if not cand:
            return None
        need = min(self.decode_chunk, max(_want(s) - _base(i, s) for i, s in cand))
        n = 1 << (need.bit_length() - 1)  # largest power of two <= need
        T = n * self.round_group
        for i, slot in list(cand):
            if self.slots[i] is not slot:
                continue  # evicted by an older slot's growth in this loop
            upto = min(_want(slot), _base(i, slot) + T)
            if not self._ensure_pages(slot, upto):
                fallback = min(_want(slot), _base(i, slot) + n)
                if not self._ensure_pages(slot, fallback) and i not in chained:
                    # Pool held by slots at least as old: defer (as
                    # _decode_round does). A chained slot keeps riding: its
                    # pages already cover worst_len, so max_len clamps it to
                    # zero steps, never to an overrun.
                    cand = [(j, t) for j, t in cand if j != i]
        cand = [(i, s) for i, s in cand if self.slots[i] is s]
        if not cand:
            return None

        t0 = self._clock()
        B = self.max_slots
        token = np.zeros((B,), np.int64)
        lengths = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        eos = np.full((B,), -1, np.int64)
        max_len = np.zeros((B,), np.int32)
        chain_mask = np.zeros((B,), bool)
        worst = np.zeros((B,), np.int32)
        for i, s in cand:
            token[i] = s.generated[-1] if s.generated else s.request.prompt[-1]
            lengths[i] = s.length
            active[i] = True
            if s.request.eos_id is not None:
                eos[i] = s.request.eos_id
            max_len[i] = min(_want(s), len(s.pages) * ps)
            chain_mask[i] = i in chained
            worst[i] = min(_base(i, s) + T, max_len[i])
        round_span = int(worst.max())
        bucket = self._page_bucket(round_span)
        split = self._split_bucket(round_span)
        packed = _pack_group_inputs(token, lengths, active, eos, max_len, chain_mask, self._page_table(bucket))
        chain = None if prev is None else (prev.result.tok_fin, prev.result.len_fin)
        body = self._group_body(n, split)
        if self._graphs is not None:
            key = (n, self.round_group, bucket, split, self.temperature, self.top_k, self.top_p,
                   self.attn_impl, self.cache_dtype, self.config)
            result = self._graphs.dispatch(key, body, packed, chain)
        else:
            dev = self.device
            if chain is None:  # no slot chains: zero fillers of the chain's shapes
                chain = (torch.zeros(B, dtype=torch.int64, device=dev), torch.zeros(B, dtype=torch.int32, device=dev))
            result = GroupResult(*body(torch.as_tensor(packed, device=dev), *chain, False))
        t1 = 0.0 if self.obs is None else self._clock()
        self.split_rounds[split] += 1
        self.decode_steps += T
        self.dispatch_log.append((self.rounds, tuple(s.request.uid for _, s in cand)))
        return _InflightRound(
            result=result,
            n_steps=T,
            active_idx=[i for i, _ in cand],
            slots=[s for _, s in cand],
            worst_len=worst,
            t0=t0,
            t1=t1,
        )

    def _group_body(self, n: int, split: int):
        """The group program over the packed inputs (graphs.Body): n decode
        steps per round, self.round_group rounds, or one step for a warm-up."""
        B = self.max_slots

        def body(packed: Tensor, chain_token: Tensor, chain_len: Tensor, warmup: bool):
            token, lengths, active, eos, max_len, chain_mask, table = _unpack_group_inputs(packed, B)
            steps, group = (1, 1) if warmup else (n, self.round_group)
            toks, emitted, tok_fin, len_fin = _serve_decode_group(
                self.config, self.params, token, self.cache, table, lengths, active, eos, max_len,
                chain_mask, chain_token, chain_len, steps, group, self.temperature, self.top_k,
                self.top_p, self.attn_impl, self._gen, split,
            )
            return torch.cat([toks, emitted.to(toks.dtype)]), tok_fin, len_fin

        return body

    def _settle_round(self, h: _InflightRound) -> None:
        """Wait for a dispatched group and commit its tokens. Indices whose
        slot object changed since dispatch (finished, evicted, cancelled,
        timed out) are SKIPPED — their in-flight tokens are discarded, and
        recompute preemption regenerates them. Under "double" the host work
        between the dispatch's return (h.t1) and this force is what the
        overlap hid: `overlap_hidden` in the round decomposition."""
        t_force = 0.0 if self.obs is None else self._clock()
        toks, emitted = self._force(h.result.host, "serve.overlap_sync")  # waits for this group alone
        t_done = self._clock()
        self.decode_seconds += t_done - h.t0
        for idx, s in zip(h.active_idx, h.slots):
            if self.slots[idx] is not s:
                continue
            for j in range(h.n_steps):
                if not emitted[j, idx]:
                    continue
                s.length += 1
                self.decode_tokens += 1
                if self._append_token(idx, s, int(toks[j, idx]), t_done):
                    break  # finished (max_new or EOS); rest discarded
        if self.obs is not None:
            self.obs.record_round("decode", self._obs_tid, h.t0, h.t1, t_done, self._clock(),
                                  hidden_s=max(0.0, t_force - h.t1))

    def _spec_round(self) -> None:
        """One speculative round: k draft proposals per active slot, one
        batched k+1-token verify forward plus the rejection sampler, then
        host-side commit and page-aligned rollback.

        Rollback never touches device memory: a slot that accepted j of k
        drafts sets length = old + 1 + j and frees the tail pages past
        ceil(length / page_size) — the rejected columns stay in the pool,
        masked by every later read until the slot grows back over them
        (write before read; GPT.verify_step_paged). k for the round is the
        pow2 floor of the active slots' smallest adaptive spec_k."""
        active_idx = self._ready_slots()
        if not active_idx:
            return
        S = self.config.block_size
        # submit() caps prompt + max_new at S, so an unfinished slot has
        # length <= S - 2 and k_cap >= 1; the fallback is defensive.
        k_cap = min(S - 1 - self.slots[i].length for i in active_idx)
        budget = min([k_cap] + [self.slots[i].spec_k for i in active_idx])
        if budget < 1:
            self._decode_round()
            return
        k = 1 << (budget.bit_length() - 1)  # largest power of two <= budget
        active_idx = self._grow_for_round(active_idx, k + 1)
        if not active_idx:
            return

        t0 = self._clock()
        token, lengths, active = self._round_inputs(active_idx)
        round_span = max(self.slots[i].length for i in active_idx) + k + 1
        split = self._split_bucket(round_span)
        dev = self.device
        table = torch.as_tensor(self._page_table(self._page_bucket(round_span)), device=dev)
        token_t = torch.as_tensor(token, device=dev)
        lengths_t = torch.as_tensor(lengths, device=dev)
        active_t = torch.as_tensor(active, device=dev)
        # A self-draft runs on the target pool (constructor comment).
        draft_cache = self.cache if self.draft_shares_cache else self.draft_cache
        drafts, draft_probs = _spec_draft_chunk(
            self.draft_config, self.draft_params, token_t, draft_cache, table, lengths_t,
            active_t, k, self.temperature, self.top_k, self.top_p, self.attn_impl, self._gen, split,
        )
        t_draft = 0.0 if self.obs is None else self._clock()
        self.cache, n_accept, out = _spec_verify_chunk(
            self.config, self.params, token_t, drafts, draft_probs, self.cache, table,
            lengths_t, active_t, self.temperature, self.top_k, self.top_p, self.attn_impl,
            self._gen, split,
        )
        t1 = 0.0 if self.obs is None else self._clock()
        n_accept = n_accept.cpu().numpy()  # the round's device sync
        out = out.cpu().numpy()
        t_done = self._clock()
        self.split_rounds[split] += 1
        self.decode_seconds += t_done - t0
        self._spec_rounds += 1
        self._spec_draft_steps += k
        for i in active_idx:
            slot = self.slots[i]
            if slot is None:
                continue
            j = int(n_accept[i])
            slot.length += 1 + j  # pending + accepted drafts are now cached
            self._spec_verifies += 1
            self._spec_drafted += k
            self._spec_accepted += j
            slot.accept_ema = 0.5 * slot.accept_ema + 0.5 * (j / k)
            if self.spec_adapt:
                if slot.accept_ema > 0.75 and slot.spec_k * 2 <= self.spec_k_max:
                    slot.spec_k *= 2
                elif slot.accept_ema < 0.4 and slot.spec_k // 2 >= self.spec_k_min:
                    slot.spec_k //= 2
            finished = False
            for t in range(j + 1):
                self.decode_tokens += 1
                if self._append_token(i, slot, int(out[i, t]), t_done):
                    finished = True  # EOS/budget; rest of the round discarded
                    break
            if finished:
                continue
            # page-aligned rollback: drop tail pages past the committed
            # length; the partial last page keeps its stale (masked)
            # columns. An int8 pool's scales are indexed by physical page,
            # so the same free orphans them too.
            keep = -(-slot.length // self.page_size)
            if len(slot.pages) > keep:
                tail = slot.pages[keep:]
                del slot.pages[keep:]
                self._free_pages(tail)
        if self.obs is not None:
            self.obs.record_round("spec", self._obs_tid, t0, t1, t_done, self._clock())
            self._trace.complete("spec.draft_enqueue", "spec", self._obs_tid, t0, t_draft - t0)
            self._trace.complete("spec.verify_enqueue", "spec", self._obs_tid, t_draft, t1 - t_draft)

    def _finished_from(self, slot: _Slot, status: str = "ok") -> FinishedRequest:
        req = slot.request
        return FinishedRequest(
            uid=req.uid,
            tokens=np.concatenate([req.prompt, np.asarray(slot.generated, np.int32)]),
            token_times=slot.token_times,
            status=status,
        )

    def _finish(self, fr: FinishedRequest) -> None:
        """Record a terminal transition (ok/EOS/timeout/cancelled) — the
        ONE funnel every path to `finished` goes through."""
        self.finished[fr.uid] = fr
        self._trace.instant("finish", "lifecycle", self._obs_tid, args={"uid": fr.uid, "status": fr.status})

    def _append_token(self, slot_i: int, slot: _Slot, tok: int, t: float) -> bool:
        """Record one generated token; returns True if the request finished
        (and the slot was freed)."""
        self._reclaim_window(slot)  # no-op unless config.sliding_window
        slot.generated.append(tok)
        slot.token_times.append(t)
        req = slot.request
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(slot.generated) >= req.max_new_tokens:
            self._finish(self._finished_from(slot))
            self._release_slot(slot)
            self.slots[slot_i] = None
            return True
        return False
