"""Zero-downtime model ops on one engine: blue/green weight hot swap,
live KV pool resize, and the SLO-driven policy controller (the port's
counterpart of midgpt_tpu/sampling/ops.py).

  * **Hot swap** (`stage_hot_swap` / `maybe_flip_swap`) is blue/green at
    round granularity: the new params are checked against the live ones
    (keys, shapes, dtypes, config) and staged on the engine's device (on a
    tp rank: the whole candidate is checked, then cut to the rank's shard
    before the flip). While
    a swap is staged, admissions pause; in-flight streams finish on the old
    weights; the flip happens at the first round boundary with no live
    slot. JAX's flip is a pointer exchange that compiles nothing, because
    params are traced arguments of its programs. The port's captured CUDA
    graphs instead read the parameter tensors by address, so the flip
    copies the staged weights INTO the live tensors, in stream order after
    every replay already enqueued: each capture stays valid and none is
    added. The KV pool and the prefix trie survive as in JAX (post-flip
    trie hits replay old-weight K/V, JAX's staleness contract).
  * **Resize** (`resize_pool`) moves the resident working set — live slot
    pages plus every referenced trie page — into a new pool through the
    page-transport funnel (sampling/disagg.py `adopt_pages`, as JAX's
    resize adopts through `_adopt_pages`; int8 scales move with their
    pages), then remaps slot page lists, trie entries and the poisoned-page
    set onto the new ids. It is the funnel's one caller that allocates a
    pool. JAX pads the destination ids to a power of two with out-of-range
    ids that XLA's scatter drops; torch drops nothing, so the port copies
    the real pages only. The new pool's spare page (models/gpt.py PagedKVCache) is its
    own, at the new `num_pages`, and no page is adopted into it. A shrink
    below the resident working set refuses with a retryable
    `PoolResizeError`; unreferenced trie pages are LRU-evicted to fit.
    Every captured graph read the old pool, so all are dropped (counted in
    `engine.dropped_graphs`) and recaptured at their next dispatch
    (sampling/graphs.py `DecodeGraphs.drop`): a replay against a freed pool
    would read freed memory. On a tp rank the new pool holds the rank's
    heads, as JAX's resize places its pool on the mesh. Page conservation
    (free + trie + live-only == num_pages - 1) is asserted on both sides.
  * **ModelOps** is a clock-injected controller over the signals the
    engine already surfaces — free-page fraction, backlog pages, shed
    fraction, the handoff queue's depth, and a p95 TTFT the caller measured
    (midgpt_tpu_torch/loadgen.py) — that emits grow / shrink /
    shed-threshold decisions for an engine and re-role decisions for a
    disaggregated pair (sampling/disagg.py `DisaggServe.rebalance`), as
    `ops.decision` tracer instants and `ops_*` gauges.
"""

from __future__ import annotations

import dataclasses
import math
import time
import typing as tp

import torch

from midgpt_tpu_torch.models.gpt import PagedKVCache
from midgpt_tpu_torch.sampling.scheduler import set_backlog_budget
from midgpt_tpu_torch.sampling.serve import PageAllocator, ServeEngine


class HotSwapError(RuntimeError):
    """A staged weight swap was rejected BEFORE touching the live engine.

    Structured fields (callers never string-parse):

      reason     "tree_structure" | "shape" | "dtype" | "config" |
                 "draft_unexpected" | "swap_pending"
      path       offending parameter name ("" when not leaf-specific)
      expected   live engine's value for the mismatched property
      got        candidate's value
    """

    def __init__(self, message: str, *, reason: str, path: str = "", expected: tp.Any = None, got: tp.Any = None):
        super().__init__(message)
        self.reason = reason
        self.path = path
        self.expected = expected
        self.got = got


class PoolResizeError(RuntimeError):
    """A live pool resize was refused — shrinking below the resident
    working set would drop referenced pages, which is the caller's call
    (finish or evict streams), not the resizer's.

    Structured fields (the BackpressureError discipline, serve.py):

      requested_pages   the num_pages the caller asked for
      resident_pages    distinct pages that MUST survive (live slots +
                        referenced trie entries); the floor is
                        resident_pages + 1 (the sink)
      num_pages         the pool's current num_pages
      requested_slots / live_slots   set for slot-count refusals
      retryable         True — retry after streams drain or evictions
    """

    def __init__(
        self,
        message: str,
        *,
        requested_pages: int,
        resident_pages: int,
        num_pages: int,
        requested_slots: tp.Optional[int] = None,
        live_slots: tp.Optional[int] = None,
        retryable: bool = True,
    ):
        super().__init__(message)
        self.requested_pages = requested_pages
        self.resident_pages = resident_pages
        self.num_pages = num_pages
        self.requested_slots = requested_slots
        self.live_slots = live_slots
        self.retryable = retryable


# ---------------------------------------------------------------------------
# Blue/green weight hot swap
# ---------------------------------------------------------------------------


def _dtype_of(x) -> torch.dtype:
    return x.dtype if isinstance(x, torch.Tensor) else torch.as_tensor(x).dtype


def _validate_swap_tree(old: tp.Mapping[str, torch.Tensor], new, *, what: str) -> None:
    if not isinstance(new, tp.Mapping) or set(old) != set(new):
        got = sorted(new) if isinstance(new, tp.Mapping) else type(new).__name__
        raise HotSwapError(
            f"hot-swap rejected: {what} names differ from the live engine's (different model family?)",
            reason="tree_structure",
            expected=sorted(old),
            got=got,
        )
    for path, o in old.items():
        n = new[path]
        if tuple(o.shape) != tuple(n.shape):
            raise HotSwapError(
                f"hot-swap rejected: {what} leaf {path} has shape {tuple(n.shape)}, live engine has "
                f"{tuple(o.shape)} — same-shape swaps only (a different architecture is a new engine, not a swap)",
                reason="shape",
                path=path,
                expected=tuple(o.shape),
                got=tuple(n.shape),
            )
        if _dtype_of(n) != o.dtype:
            raise HotSwapError(
                f"hot-swap rejected: {what} leaf {path} has dtype {_dtype_of(n)}, live engine has {o.dtype} — "
                "a dtype change is a new engine, not a zero-downtime swap",
                reason="dtype",
                path=path,
                expected=str(o.dtype),
                got=str(_dtype_of(n)),
            )


def _stage(live: tp.Mapping[str, torch.Tensor], new) -> tp.Dict[str, torch.Tensor]:
    """The engine's own copy of `new` on its device and stream."""
    return {k: torch.empty_like(t).copy_(torch.as_tensor(new[k])) for k, t in live.items()}


def stage_hot_swap(engine: ServeEngine, params, *, draft_params=None, version: str = "inline",
                   config=None) -> tp.Dict[str, tp.Any]:
    """Validate and stage a blue/green weight swap on `engine`.

    Rejections raise `HotSwapError` without perturbing the engine. On
    success the candidate is copied onto the engine's device and staged;
    `maybe_flip_swap` flips at the first round boundary with no live slot
    (at once, for an idle engine). While staged, admission pauses so queued
    arrivals take the NEW weights."""
    if engine._staged_swap is not None:
        raise HotSwapError(
            f"hot-swap rejected: a swap is already staged (version {engine._staged_swap['version']!r}) and has "
            "not flipped yet",
            reason="swap_pending",
            expected=None,
            got=version,
        )
    if config is not None and config != engine.config:
        raise HotSwapError(
            "hot-swap rejected: model config differs from the live engine's — a config change is a new engine, "
            "not a swap",
            reason="config",
            expected=engine.config,
            got=config,
        )
    if engine._tp is not None:
        # a tp rank checks the whole candidate, then stages its own shard
        _validate_swap_tree(engine._tp.whole(engine.params), params, what="params")
        params = engine._tp.shard(params)
    _validate_swap_tree(engine.params, params, what="params")
    if draft_params is not None and engine.draft_params is None:
        raise HotSwapError(
            "hot-swap rejected: draft params offered but the live engine has no draft model configured",
            reason="draft_unexpected",
        )
    # A target-only swap on a speculative engine is legal: the draft only
    # proposes, and the rejection sampler commits the (new) target's tokens.
    if draft_params is not None:
        if engine._draft_tp is not None:
            _validate_swap_tree(engine._draft_tp.whole(engine.draft_params), draft_params, what="draft_params")
            draft_params = engine._draft_tp.shard(draft_params)
        _validate_swap_tree(engine.draft_params, draft_params, what="draft_params")
    engine._staged_swap = {
        "params": _stage(engine.params, params),
        "draft_params": None if draft_params is None else _stage(engine.draft_params, draft_params),
        "version": version,
        "staged_round": engine.rounds,
        "staged_at": engine._clock(),
        "in_flight_at_stage": sorted(s.request.uid for s in engine.slots if s is not None),
    }
    engine._trace.instant(
        "ops.hot_swap_staged", "ops", engine._obs_tid,
        args={"version": version, "in_flight": len(engine._staged_swap["in_flight_at_stage"])},
    )
    summary = {
        "staged": True,
        "version": version,
        "staged_round": engine.rounds,
        "in_flight_at_stage": list(engine._staged_swap["in_flight_at_stage"]),
    }
    summary["flipped"] = maybe_flip_swap(engine)  # an idle engine flips at once
    return summary


def _shares_storage(params: tp.Mapping[str, torch.Tensor], other: tp.Mapping[str, torch.Tensor]) -> bool:
    ptrs = {t.untyped_storage().data_ptr() for t in other.values()}
    return any(t.untyped_storage().data_ptr() in ptrs for t in params.values())


def maybe_flip_swap(engine: ServeEngine) -> bool:
    """Flip a staged swap iff no old-side stream remains in flight: no live
    slot AND no recompute-preempted stream waiting in the queue (its
    committed tokens came from the old weights). Called by the engine's
    step between expiry and admission; returns True when the flip happened.

    The flip copies the staged weights into the live tensors in place
    (module docstring). A layer-prefix self-draft's tensors are views of
    the target's (sampling/spec.py self_draft); a target-only swap leaves
    JAX's draft on the old weights, so the draft first gets its own copy of
    them."""
    st = engine._staged_swap
    if st is None:
        return False
    if any(s is not None for s in engine.slots):
        return False
    if any(q.uid in engine._resumed_uids for q in engine.queue):
        return False
    old_version = engine.weights_version
    with torch.no_grad():
        if st["draft_params"] is not None:
            engine.draft_params = st["draft_params"]  # no capture reads the draft's tensors
        elif engine.draft_params is not None and _shares_storage(engine.draft_params, engine.params):
            engine.draft_params = {k: t.clone() for k, t in engine.draft_params.items()}
        for k, t in engine.params.items():
            t.copy_(st["params"][k])
    engine.weights_version = st["version"]
    engine._staged_swap = None
    engine.hot_swaps += 1
    record = {
        "staged_round": st["staged_round"],
        "flip_round": engine.rounds,
        "swap_latency_s": engine._clock() - st["staged_at"],
        "in_flight_at_stage": st["in_flight_at_stage"],
        "served_uids_at_flip": sorted(engine.finished),
        "from_version": old_version,
        "version": st["version"],
    }
    engine.swap_history.append(record)
    engine._trace.instant(
        "ops.hot_swap", "ops", engine._obs_tid,
        args={"version": st["version"], "from_version": old_version, "flip_round": engine.rounds},
    )
    if engine.obs is not None:
        engine.obs.metrics.counter("ops_hot_swaps", "completed blue/green weight flips").inc()
    return True


# ---------------------------------------------------------------------------
# Live pool resize
# ---------------------------------------------------------------------------


def assert_conserved(engine: ServeEngine, where: str) -> None:
    """The serving-wide page conservation law: free + trie-held +
    live-slot-only == num_pages - 1 (page 0 is the sink; the spare page is
    outside the allocator's range). Resize asserts it on both sides."""
    pc = engine.prefix_cache
    held = set() if pc is None else pc.pages_held()
    # -1 entries are window-reclaimed placeholders, already on the free list
    live = {p for s in engine.slots if s is not None for p in s.pages if p >= 0}
    total = engine.allocator.free_count + len(held) + len(live - held)
    assert total == engine.allocator.num_pages - 1, (
        f"page conservation violated {where}: free={engine.allocator.free_count} trie={len(held)} "
        f"live_only={len(live - held)} != num_pages-1={engine.allocator.num_pages - 1}"
    )


def _migrate_cache(engine: ServeEngine, cache: PagedKVCache, old_ids, new_ids, num_pages: int, config) -> PagedKVCache:
    """A new `num_pages` pool holding `cache`'s pages `old_ids` at
    `new_ids` (int8 scales with them), written through the adoption funnel
    from a gather on the device; every other page is zero."""
    from midgpt_tpu_torch.sampling.disagg import adopt_pages

    new = PagedKVCache.init(config, num_pages=num_pages, page_size=engine.page_size, dtype=engine.cache_dtype,
                            device=engine.device, tp_size=engine.tp_size)  # a tp rank's pool: its heads
    if old_ids:
        src = torch.as_tensor(old_ids, device=engine.device)
        blocks = {"k": cache.k[:, :, src], "v": cache.v[:, :, src]}
        if cache.quantized:
            blocks.update(k_scale=cache.k_scale[:, src], v_scale=cache.v_scale[:, src])
        adopt_pages(new, new_ids, blocks)
    return new


def resize_pool(engine: ServeEngine, num_pages: tp.Optional[int] = None, *,
                max_slots: tp.Optional[int] = None) -> tp.Dict[str, tp.Any]:
    """Grow or shrink the live pool to `num_pages` (and/or the slot count
    to `max_slots`) by migrating the resident working set into a new pool.
    Runs between rounds with nothing in flight (`ServeEngine.resize`).

      1. Refuse (PoolResizeError, retryable) if the resident working set —
         live slot pages + referenced trie pages — cannot fit, or if live
         slots exceed the requested slot count.
      2. LRU-evict unreferenced trie pages that no longer fit.
      3. Copy the resident pages into the new pool, remap slot page lists,
         trie entries and poisoned pages to the new ids.
      4. Install pool and allocator, drop the old pool's captures;
         conservation asserted on both sides.

    The record's `migrate_s` is the engine clock across steps 3-4, the
    device's copies included (on CUDA the stream is synchronized on both
    sides)."""
    old_total = engine.allocator.num_pages
    if num_pages is None:
        num_pages = old_total
    if num_pages < 2:
        raise ValueError(f"num_pages must be >= 2 (sink + 1), got {num_pages}")
    live_slots = [s for s in engine.slots if s is not None]
    if max_slots is not None and max_slots < 1:
        raise ValueError(f"max_slots must be >= 1, got {max_slots}")
    if max_slots is not None and len(live_slots) > max_slots:
        raise PoolResizeError(
            f"resize refused: {len(live_slots)} live slots exceed the requested max_slots={max_slots} — drain or "
            "cancel streams first (retryable)",
            requested_pages=num_pages,
            resident_pages=0,
            num_pages=old_total,
            requested_slots=max_slots,
            live_slots=len(live_slots),
        )
    pc = engine.prefix_cache
    live = {p for s in live_slots for p in s.pages if p >= 0}
    referenced = set() if pc is None else pc.referenced_pages()
    resident = live | referenced
    if num_pages - 1 < len(resident):
        raise PoolResizeError(
            f"resize refused: requested num_pages={num_pages} holds {num_pages - 1} pages but the resident working "
            f"set is {len(resident)} pages (live slots + referenced trie entries) — shrinking would drop live data; "
            "drain streams or evict first (retryable)",
            requested_pages=num_pages,
            resident_pages=len(resident),
            num_pages=old_total,
        )
    assert_conserved(engine, "before resize")

    trie_evicted = 0
    if pc is not None:
        overflow = len(live | pc.pages_held()) - (num_pages - 1)
        if overflow > 0:
            # Only unreferenced entries are evictable; the resident check
            # above guarantees there are at least `overflow` of them.
            freed = pc.evict(overflow)
            engine._free_pages(freed)
            trie_evicted = len(freed)
            assert trie_evicted == overflow, f"resize eviction shortfall: wanted {overflow}, evicted {trie_evicted}"

    if engine.device.type == "cuda":
        torch.cuda.current_stream(engine.device).synchronize()  # time the migration alone
    t0 = engine._clock()
    held = set() if pc is None else pc.pages_held()
    old_ids = sorted(live | held)
    allocator = PageAllocator(num_pages)
    new_ids = allocator.alloc(len(old_ids)) if old_ids else []
    mapping = dict(zip(old_ids, new_ids))
    engine.cache = _migrate_cache(engine, engine.cache, old_ids, new_ids, num_pages, engine.config)
    if engine.draft_cache is not None:
        engine.draft_cache = _migrate_cache(engine, engine.draft_cache, old_ids, new_ids, num_pages,
                                            engine.draft_config)
    for s in live_slots:
        s.pages[:] = [mapping[p] if p >= 0 else -1 for p in s.pages]
    if pc is not None:
        pc.remap_pages(mapping)
    # a poisoned page is live or in the trie (freeing scrubs it), so mapped
    engine._poisoned_pages = {mapping[p] for p in engine._poisoned_pages}
    engine.allocator = allocator
    if max_slots is not None and max_slots != engine.max_slots:
        # Live slots keep their _Slot objects; the page table is rebuilt
        # from engine.slots every round.
        engine.slots = live_slots + [None] * (max_slots - len(live_slots))
        engine.max_slots = max_slots
    if engine._graphs is not None:
        engine.dropped_graphs += engine._graphs.drop(engine.max_slots)
    if engine.device.type == "cuda":
        torch.cuda.current_stream(engine.device).synchronize()
    migrate_s = engine._clock() - t0
    assert_conserved(engine, "after resize")

    engine.resizes += 1
    record = {
        "round": engine.rounds,
        "from_pages": old_total,
        "to_pages": num_pages,
        "pages_migrated": len(old_ids),
        "trie_pages_evicted": trie_evicted,
        "max_slots": engine.max_slots,
        "migrate_s": migrate_s,
    }
    engine.resize_history.append(record)
    engine._trace.instant("ops.resize", "ops", engine._obs_tid, args=dict(record))
    if engine.obs is not None:
        engine.obs.metrics.counter("ops_resizes", "completed live pool resizes").inc()
        engine.obs.metrics.gauge("ops_pool_pages", "current pool num_pages").set(float(num_pages))
    return record


# ---------------------------------------------------------------------------
# SLO-driven policy controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpsDecision:
    """One controller tick's outcome. kind is one of "none" | "grow" |
    "shrink" | "shed_threshold" | "re_role"; `applied` is False when the target refused
    (a PoolResizeError on a shrink — recorded in `error`, retryable next
    tick) or when the controller runs advisory (`apply=False`)."""

    kind: str
    reason: str
    args: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)
    applied: bool = False
    error: tp.Optional[str] = None


class ModelOps:
    """Clock-injected SLO policy loop over a ServeEngine or a DisaggServe.
    Consumes only signals the target already exposes (free-page fraction,
    backlog pages, shed fraction, handoff queue depth) plus an optional
    caller-measured `ttft_p95_ms`, and emits at most ONE decision per tick:

      grow            free pages below `low_free_frac`, or TTFT over budget
                      -> resize the pool up by `grow_frac`.
      shed_threshold  shed fraction over budget with a backlog budget set
                      -> loosen `max_backlog_pages` by half.
      shrink          free pages above `high_free_frac` with an empty
                      backlog -> resize down by `shrink_frac` (refusals are
                      recorded, not raised — retryable next tick).
      re_role         disagg targets: a handoff backlog deeper than
                      `handoff_backlog_high` -> move `rebalance_pages` of
                      pool prefill->decode (DisaggServe.rebalance); a
                      starved prefill pool with an idle queue and a roomy
                      decode pool -> the reverse.

    A "none" tick touches no device state. Decisions surface as `ops.decision` tracer instants and `ops_*`
    metrics."""

    def __init__(
        self,
        target,
        *,
        clock: tp.Callable[[], float] = time.perf_counter,
        obs=None,
        low_free_frac: float = 0.15,
        high_free_frac: float = 0.85,
        grow_frac: float = 0.5,
        shrink_frac: float = 0.25,
        min_interval_s: float = 0.0,
        ttft_budget_ms: tp.Optional[float] = None,
        shed_budget_frac: float = 0.25,
        handoff_backlog_high: int = 4,
        rebalance_pages: int = 4,
        apply: bool = True,
    ):
        self.target = target
        self._disagg = hasattr(target, "prefill") and hasattr(target, "decode")
        self._clock = clock
        self.obs = obs if obs is not None else getattr(target, "obs", None)
        self.low_free_frac = low_free_frac
        self.high_free_frac = high_free_frac
        self.grow_frac = grow_frac
        self.shrink_frac = shrink_frac
        self.min_interval_s = min_interval_s
        self.ttft_budget_ms = ttft_budget_ms
        self.shed_budget_frac = shed_budget_frac
        self.handoff_backlog_high = handoff_backlog_high
        self.rebalance_pages = rebalance_pages
        self.apply = apply
        self._last_tick: tp.Optional[float] = None
        self.decisions: tp.List[OpsDecision] = []

    # -- signal helpers --------------------------------------------------

    @staticmethod
    def _free_frac(eng) -> float:
        return eng.allocator.free_count / max(1, eng.allocator.num_pages - 1)

    @staticmethod
    def _shed_frac(eng) -> float:
        return eng.shed / max(1, eng.shed + eng._uid)

    def _gauges(self, prefix: str, eng) -> None:
        if self.obs is None:
            return
        m = self.obs.metrics
        m.gauge(f"ops_{prefix}free_page_frac", "free pages / allocatable pages").set(self._free_frac(eng))
        m.gauge(f"ops_{prefix}backlog_pages", "worst-case page demand of live work").set(
            float(eng._backlog_pages()))
        m.gauge(f"ops_{prefix}shed_frac", "shed submits / total submits").set(self._shed_frac(eng))

    def _record(self, decision: OpsDecision) -> OpsDecision:
        self.decisions.append(decision)
        if self.obs is not None and decision.kind != "none":
            self.obs.tracer.instant(
                "ops.decision", "ops", "ops",
                args={
                    "kind": decision.kind,
                    "reason": decision.reason,
                    "applied": decision.applied,
                    **{k: v for k, v in decision.args.items() if isinstance(v, (int, float, str, bool))},
                },
            )
            self.obs.metrics.counter(f"ops_decisions_{decision.kind}", f"controller '{decision.kind}' decisions").inc()
        return decision

    # -- tick ------------------------------------------------------------

    def tick(self, *, ttft_p95_ms: tp.Optional[float] = None) -> OpsDecision:
        now = self._clock()
        if self._last_tick is not None and now - self._last_tick < self.min_interval_s:
            return self._record(OpsDecision(kind="none", reason="interval"))
        self._last_tick = now
        if self._disagg:
            return self._tick_disagg()
        return self._tick_engine(self.target, ttft_p95_ms)

    def _tick_engine(self, eng, ttft_p95_ms: tp.Optional[float]) -> OpsDecision:
        self._gauges("", eng)
        cap = eng.allocator.num_pages - 1
        free_frac = self._free_frac(eng)
        shed_frac = self._shed_frac(eng)
        ttft_over = self.ttft_budget_ms is not None and ttft_p95_ms is not None and ttft_p95_ms > self.ttft_budget_ms
        if free_frac < self.low_free_frac or ttft_over:
            new_pages = 1 + int(math.ceil(cap * (1.0 + self.grow_frac)))
            d = OpsDecision(
                kind="grow", reason="ttft_over_budget" if ttft_over else "free_pages_low",
                args={"from_pages": cap + 1, "to_pages": new_pages, "free_frac": free_frac},
            )
            if self.apply:
                eng.resize(new_pages)
                d.applied = True
            return self._record(d)
        if shed_frac > self.shed_budget_frac and eng.max_backlog_pages is not None:
            new_budget = int(eng.max_backlog_pages * 1.5) + 1
            d = OpsDecision(
                kind="shed_threshold", reason="shed_frac_over_budget",
                args={"from_budget": eng.max_backlog_pages, "to_budget": new_budget, "shed_frac": shed_frac},
            )
            if self.apply:
                set_backlog_budget(eng, new_budget)
                d.applied = True
            return self._record(d)
        if free_frac > self.high_free_frac and eng._backlog_pages() == 0:
            new_pages = 1 + max(1, int(math.ceil(cap * (1.0 - self.shrink_frac))))
            if new_pages < cap + 1:
                d = OpsDecision(
                    kind="shrink", reason="free_pages_high",
                    args={"from_pages": cap + 1, "to_pages": new_pages, "free_frac": free_frac},
                )
                if self.apply:
                    try:
                        eng.resize(new_pages)
                        d.applied = True
                    except PoolResizeError as e:
                        d.error = str(e)
                return self._record(d)
        return self._record(OpsDecision(kind="none", reason="in_band"))

    def _re_role(self, reason: str, src: str, dst: str, depth: int) -> OpsDecision:
        dec = OpsDecision(kind="re_role", reason=reason,
                          args={"src": src, "dst": dst, "pages": self.rebalance_pages, "depth": depth})
        if self.apply:
            try:
                self.target.rebalance(self.rebalance_pages, src=src, dst=dst)
                dec.applied = True
            except PoolResizeError as e:
                dec.error = str(e)
        return self._record(dec)

    def _tick_disagg(self) -> OpsDecision:
        d = self.target
        self._gauges("prefill_", d.prefill)
        self._gauges("decode_", d.decode)
        depth = d.queue.stats()["depth"]
        if self.obs is not None:
            self.obs.metrics.gauge("ops_handoff_depth", "prefill->decode handoff queue depth").set(float(depth))
        if depth > self.handoff_backlog_high:
            return self._re_role("handoff_backlog_deep", "prefill", "decode", depth)
        if (depth == 0 and self._free_frac(d.prefill) < self.low_free_frac
                and self._free_frac(d.decode) > self.high_free_frac):
            return self._re_role("prefill_starved", "decode", "prefill", depth)
        return self._record(OpsDecision(kind="none", reason="in_band"))
