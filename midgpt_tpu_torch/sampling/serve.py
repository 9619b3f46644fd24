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
beside int8 pages). Not ported yet (ROADMAP.md): the overlap modes, the
prefix cache and spill tier, hot-swap/resize, fault hooks, observability,
the watchdog, mesh-sharded serving and sliding-window page reclamation.
Their constructor arguments raise NotImplementedError when set.
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
from midgpt_tpu_torch.sampling.engine import sample_logits, warp_logits
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
        # Not ported yet (ROADMAP.md): setting any of these raises.
        overlap: str = "off",
        round_group: int = 1,
        prefix_cache: bool = False,
        mesh=None,
        obs=None,
        watchdog=None,
    ):
        unported = {
            "overlap": overlap != "off",
            "round_group": round_group != 1,
            "prefix_cache": bool(prefix_cache),
            "mesh": mesh is not None,
            "obs": obs is not None,
            "watchdog": watchdog is not None,
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
        self._uid = 0
        self._admitted = 0
        # Counters (stats()): recompute-style preemptions, scheduling
        # rounds, deadline timeouts, admission sheds, cancellations, decode
        # rounds per split-K factor, decode steps (each one forward of the
        # slot batch), and decode tokens / seconds (host clock around each
        # decode round, which ends in its one sync).
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
        return not self.queue and all(s is None for s in self.slots)

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
            "spec": self.spec_stats() if self.draft_config is not None else None,
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
        (or one draft-then-verify speculative round)."""
        self.rounds += 1
        self._expire_round()
        self._admit()
        self._prefill_round()
        if self.draft_config is not None:
            self._spec_round()
        else:
            self._decode_round()

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

    def _release_slot(self, slot: _Slot) -> None:
        """The ONE funnel a departing slot's pages go through (finish,
        cancel, timeout, preemption)."""
        self.allocator.free(slot.pages)

    def _page_table(self, n_pages: tp.Optional[int] = None) -> np.ndarray:
        """(max_slots, n_pages) int32 host table; unallocated entries point
        at the sink page 0."""
        table = np.zeros((self.max_slots, n_pages or self.max_pages_per_slot), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                pages = s.pages[: table.shape[1]]
                table[i, : len(pages)] = pages
        return table

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
        if not slot.prefilling:
            # Prompt complete: the first generated token comes from the last
            # valid prompt position's logits (greedy: first-index argmax).
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
        toks = toks.cpu().numpy()  # the round's one device sync
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
        self.cache, n_accept, out = _spec_verify_chunk(
            self.config, self.params, token_t, drafts, draft_probs, self.cache, table,
            lengths_t, active_t, self.temperature, self.top_k, self.top_p, self.attn_impl,
            self._gen, split,
        )
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
                self.allocator.free(tail)

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

    def _append_token(self, slot_i: int, slot: _Slot, tok: int, t: float) -> bool:
        """Record one generated token; returns True if the request finished
        (and the slot was freed)."""
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
