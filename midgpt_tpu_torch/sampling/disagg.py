"""Disaggregated prefill/decode serving: two ServeEngine roles bridged by a
page-handoff queue (the port's counterpart of midgpt_tpu/sampling/disagg.py).

Prefill is compute-bound batch work (long chunks, few slots); decode is
memory-bound latency work (many slots, short chunks). A monolithic engine
time-slices both and each hurts the other's SLO. Disaggregation runs a
prefill-heavy engine and a decode-heavy one and moves each request between
them once, at the prefill/decode boundary:

  * `max_new_tokens=1` makes "prefill + first token" a complete request on
    the prefill role, so it needs no new scheduler states;
  * the prefix-cache trie already says "these pages hold tokens 0..n": at
    prefill finish the request's complete prompt pages sit in the prefill
    trie, `match` hands them (referenced) to the handoff, and on the decode
    side `release(..., n_shared=0)` donates the adopted copies to the DECODE
    trie, so the decode engine's ordinary admission matches them and skips
    the prompt's prefill;
  * page content crosses as host blocks (`gather_pages`, on the source
    engine's stream) and lands through `adopt_pages`.

`adopt_pages` is the port's one page-transport funnel: the handoff, the
spill tier's re-adoption (sampling/serve.py `_readopt_from_spill`) and the
live pool resize (sampling/ops.py `resize_pool`) all write pages through
it. JAX's `_adopt_pages` returns a new pool (its callers reassign
`engine.cache`) and pads the destination ids to a power of two with
`num_pages`, whose writes XLA's scatter drops. The port's captured decode
graphs (sampling/graphs.py) read the pool by address, so the funnel is an
in-place index copy into the live `k`/`v` (and `k_scale`/`v_scale`)
tensors, which are never rebound; and index `num_pages` is the pool's
spare page (models/gpt.py PagedKVCache), which the sync-free decode writes
use, so only the real pages are written and a spare or sink id raises.

Stream order: every copy runs on the engine's own stream (`_on_stream`),
after the prefill that wrote a page and before the replay that reads it,
also when the decode role has an overlapped round in flight. A host copy
(`.cpu()`, or an upload from pageable memory) waits for that stream.

On a serving mesh (`mesh=`, data >= 2 rows of tp ranks, JAX's layout:
parallel/serve_tp.py `role_submeshes`) row 0 is the prefill role and
row 1 the decode role, each engine tensor-parallel across its row, and
each rank builds its own role's engine only. JAX drives both roles from
one controller and moves a page within one array; the port's ranks run
the pipeline in lockstep, every rank of the mesh one tick at a time
(`step` on the mesh's first rank, the leader, which takes the
submissions; `follow()` on the others). Each tick the leader broadcasts
its submissions and the tick's clock; the prefill row steps and hands
off, and its first rank broadcasts the handoff records and finishes;
shard i of the prefill row sends its blocks of the handed-off pages to
shard i of the decode row (point to point); the decode row adopts,
steps and collects, and its first rank broadcasts its finishes. So the
pipeline's host state is the same on every rank, and each engine's
(sampling/serve.py, lockstep mode) the same on both ranks of its row.

Greedy parity: the decode role's prompt is `prompt + [first_token]`; its
prefill recomputes the positions the handoff did not ship and its first
argmax is the monolithic engine's second token, so a disaggregated greedy
stream is the monolithic stream token for token. A handoff that cannot get
decode-pool pages falls back to a plain re-prefill on the decode role
(`fallback_reprefills`, correct and slower), and a timed-out request keeps
its timeout status.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.models.gpt import GPTConfig, PagedKVCache, Params
from midgpt_tpu_torch.obs import DISABLED_SNAPSHOT, NULL_TRACER
from midgpt_tpu_torch.robustness.backoff import backoff_delays
from midgpt_tpu_torch.sampling.serve import BackpressureError, FinishedRequest, ServeEngine

Block = tp.Union[np.ndarray, torch.Tensor]

# the page axis of each block key: k/v (L, H, n, ps, C), scales (L, n, H, ps)
_PAGE_AXIS = {"k": 2, "v": 2, "k_scale": 1, "v_scale": 1}


def host_block(t: torch.Tensor) -> np.ndarray:
    """A device tensor's bytes on the host: numpy has no bfloat16, so a bf16
    tensor arrives as its raw 16-bit words (a uint16 array), and a checksum
    over the array covers exactly the bytes that go back. Always a copy
    (also of a CPU tensor: a block must not alias the pool); on CUDA it
    waits for the current stream."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def _device_block(b: Block, like: torch.Tensor) -> torch.Tensor:
    """A block on `like`'s device in `like`'s dtype: host uint16 words go
    back as bf16 bits unchanged; device tensors (a resize's gather) pass."""
    if isinstance(b, torch.Tensor):
        return b.to(like.device, like.dtype)
    if like.dtype == torch.bfloat16:
        if b.dtype != np.uint16:
            raise ValueError(f"a bf16 pool adopts raw uint16 words, got {b.dtype}")
        return torch.from_numpy(np.ascontiguousarray(b).view(np.int16)).to(like.device).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(b)).to(like.device, like.dtype)


def gather_pages(cache: PagedKVCache, pages: tp.Sequence[int]) -> tp.Dict[str, np.ndarray]:
    """The content of `pages` as host blocks, keyed as `adopt_pages` takes
    them (int8 pools: the scales ride along). Called on the owning engine's
    stream; the host copy waits for it."""
    idx = torch.as_tensor(list(pages), device=cache.k.device)
    blocks = {"k": host_block(cache.k[:, :, idx]), "v": host_block(cache.v[:, :, idx])}
    if cache.quantized:
        blocks["k_scale"] = host_block(cache.k_scale[:, idx])
        blocks["v_scale"] = host_block(cache.v_scale[:, idx])
    return blocks


def adopt_pages(cache: PagedKVCache, dst: tp.Sequence[int], blocks: tp.Mapping[str, Block]) -> None:
    """Write page blocks into `cache` at physical pages `dst`, IN PLACE (the
    module docstring's funnel). `blocks` carries 'k'/'v' (L, H, n, ps, C)
    and, for an int8 pool, 'k_scale'/'v_scale' (L, n, H, ps), as host
    arrays or device tensors. `dst` holds real pages only: the sink page 0
    and the spare page `num_pages` are refused, and so is a block set that
    does not match the pool's (scales without an int8 pool, or the
    reverse). Runs on the caller's current stream (the engine's)."""
    dst = [int(p) for p in dst]
    if not dst:
        return
    bad = [p for p in dst if not 0 < p < cache.num_pages]
    if bad:
        raise ValueError(f"adopt_pages: pages {bad} are not allocatable pages of a {cache.num_pages}-page pool")
    if len(set(dst)) != len(dst):
        raise ValueError(f"adopt_pages: duplicate destination pages {dst}")
    want = {"k", "v", "k_scale", "v_scale"} if cache.quantized else {"k", "v"}
    if set(blocks) != want:
        raise ValueError(f"adopt_pages: blocks {sorted(blocks)} do not match the pool's {sorted(want)}")
    idx = torch.as_tensor(dst, device=cache.k.device)
    with torch.no_grad():
        for key, b in blocks.items():
            pool = getattr(cache, key)
            if b.shape[_PAGE_AXIS[key]] != len(dst):
                raise ValueError(f"adopt_pages: block {key} holds {b.shape[_PAGE_AXIS[key]]} pages for {len(dst)}")
            src = _device_block(b, pool)
            if _PAGE_AXIS[key] == 2:
                pool[:, :, idx] = src
            else:
                pool[:, idx] = src


@dataclasses.dataclass
class HandoffItem:
    """One request crossing the prefill->decode boundary: identity and
    budget, the prefill role's first token (with its time, so TTFT survives
    the handoff), and the host blocks of its complete prompt pages."""

    uid: int  # DisaggServe uid
    prompt: np.ndarray  # (T0,) int32
    first_token: int
    first_time: float
    max_new_tokens: int  # the ORIGINAL budget (the decode role gets it minus 1)
    eos_id: tp.Optional[int]
    deadline: tp.Optional[float]
    blocks: tp.Dict[str, np.ndarray]  # page content, keyed as adopt_pages
    n_pages: int


class HandoffRetryExhausted(RuntimeError):
    """A queued page-transport item was refused by its destination more
    times than the queue's bounded retry budget allows. `uid` names the
    stream and `attempts` the spent budget, so a caller turns it into a
    terminal shed instead of retrying forever."""

    def __init__(self, message: str, *, uid: int, attempts: int):
        super().__init__(message)
        self.uid = uid
        self.attempts = attempts


class PageHandoffQueue:
    """FIFO of page-transport items with transfer accounting and a bounded
    retry-with-backoff schedule: disagg's prefill->decode handoff and the
    fleet router's failover resubmission (sampling/fleet.py) both ride it.

    Items are duck-typed (`uid`, `n_pages`, `blocks`). Retry state lives on
    the item (`_handoff_attempts`, `_not_before`): `requeue` puts a refused
    item back at the FRONT with the next delay of the shared schedule
    (robustness/backoff.py: base_s * 2**attempt), and raises
    HandoffRetryExhausted once the item has been refused `retries` times."""

    def __init__(self, *, retries: int = 32, base_s: float = 0.0,
                 clock: tp.Callable[[], float] = time.perf_counter):
        if retries < 1:
            raise ValueError(f"retries must be >= 1, got {retries}")
        self._q: tp.Deque[tp.Any] = collections.deque()
        self.retries = retries
        self.base_s = base_s
        self._clock = clock
        self.enqueued = 0
        self.dequeued = 0
        self.pages_copied = 0
        self.bytes_copied = 0
        self.retry_exhausted = 0

    def __len__(self) -> int:
        return len(self._q)

    def push(self, item) -> None:
        self.enqueued += 1
        self.pages_copied += item.n_pages
        self.bytes_copied += sum(b.nbytes for b in item.blocks.values())
        item._handoff_attempts = 0
        item._not_before = 0.0
        self._q.append(item)

    def pop(self, now: tp.Optional[float] = None):
        """The next ready item, or None when the queue is empty or its head
        is still inside a backoff window (a backed-off head shields the
        items behind it: FIFO order is kept)."""
        if not self._q:
            return None
        if getattr(self._q[0], "_not_before", 0.0) > (self._clock() if now is None else now):
            return None
        self.dequeued += 1
        return self._q.popleft()

    def requeue(self, item) -> None:
        """Return a refused item to the FRONT with the next exponential
        delay stamped on it; raises HandoffRetryExhausted once it has been
        refused `retries` times (the caller owns the terminal outcome)."""
        self.dequeued -= 1
        attempts = getattr(item, "_handoff_attempts", 0) + 1
        item._handoff_attempts = attempts
        if attempts >= self.retries:
            self.retry_exhausted += 1
            raise HandoffRetryExhausted(
                f"handoff uid={item.uid} refused {attempts} times (budget {self.retries})",
                uid=item.uid, attempts=attempts,
            )
        # the attempts-th delay of the shared schedule: base_s * 2**(attempts-1)
        delay = next(itertools.islice(backoff_delays(self.retries, self.base_s), attempts - 1, None), 0.0)
        item._not_before = self._clock() + delay
        self._q.appendleft(item)

    def stats(self) -> tp.Dict[str, int]:
        return {
            "depth": len(self._q),
            "enqueued": self.enqueued,
            "dequeued": self.dequeued,
            "pages_copied": self.pages_copied,
            "bytes_copied": self.bytes_copied,
            "retry_exhausted": self.retry_exhausted,
        }


class DisaggServe:
    """A prefill-role ServeEngine and a decode-role ServeEngine joined by a
    PageHandoffQueue (module docstring). Without `mesh` both roles run
    unsharded side by side on one device; with it, each on its row of the
    mesh (module docstring: row 0 prefill, row 1 decode, data >= 2).
    `engine_kw` is shared, `prefill_kw`/`decode_kw` override per role (e.g.
    a long prefill_chunk on the prefill role, more slots and an overlap
    mode on the decode role). Greedy only: the handoff carries no RNG
    stream, and parity with a monolithic engine is the contract. One
    shared Observability gives both roles' spans lanes of their own
    ("prefill", "decode") and the handoff spans a "disagg" lane."""

    def __init__(
        self,
        config: GPTConfig,
        params: Params,
        *,
        mesh=None,
        prefill_kw: tp.Optional[tp.Dict[str, tp.Any]] = None,
        decode_kw: tp.Optional[tp.Dict[str, tp.Any]] = None,
        clock: tp.Callable[[], float] = time.perf_counter,
        obs=None,
        **engine_kw,
    ):
        if engine_kw.get("temperature", 0.0) != 0.0:
            raise ValueError("DisaggServe is greedy-only (module docstring)")
        if engine_kw.pop("prefix_cache", True) is not True:
            raise ValueError("DisaggServe requires the prefix cache: the trie IS the handoff's page-ownership ledger")
        self.mesh = mesh
        self._role: tp.Optional[int] = None  # on a mesh: 0 (a prefill rank) or 1 (a decode rank)
        roles: tp.List[tp.Any] = [None, None]
        if mesh is not None:
            from midgpt_tpu_torch.parallel.serve_tp import role_submeshes

            roles = role_submeshes(mesh)
            if len(roles) < 2:
                raise ValueError(f"disaggregation needs a mesh with data >= 2 (one row per role); got data={mesh.data}")
            self._role = next((r for r in (0, 1) if roles[r].member), None)
            if self._role is None:
                raise ValueError("this rank is in neither role's row of the mesh")
            # shard i of one role's row trades pages with shard i of the other's
            me = roles[self._role].index
            self._peer = roles[1 - self._role].ranks[me]
            self._leads = (roles[0].ranks[0], roles[1].ranks[0])
            obs = obs if mesh.is_leader else None
        self._clock = clock
        self.obs = obs
        self._trace = obs.tracer if obs is not None else NULL_TRACER
        self.prefill = self.decode = None
        if self._role in (None, 0):
            self.prefill = ServeEngine(config, params, prefix_cache=True, clock=clock, obs=obs, obs_tid="prefill",
                                       mesh=roles[0], **{**engine_kw, **(prefill_kw or {})})
        if self._role in (None, 1):
            self.decode = ServeEngine(config, params, prefix_cache=True, clock=clock, obs=obs, obs_tid="decode",
                                      mesh=roles[1], **{**engine_kw, **(decode_kw or {})})
        for eng in (self.prefill, self.decode):
            if eng is not None and mesh is not None:
                eng._lockstep = True  # the pipeline makes the same calls on every rank of the row
        # Bounded transport: a decode role that refuses the same item 512
        # ticks in a row is wedged; the exhaustion turns the stream into a
        # terminal shed (base_s=0: the pipeline tick is the pacing). On a
        # mesh it reads the tick's clock, the same on every rank.
        self._tick_now = 0.0
        self.queue = PageHandoffQueue(retries=512, base_s=0.0, clock=clock if mesh is None else self._now)
        # On a mesh: the leader's submissions since the last tick, the
        # tick's finishes (broadcast by the role that made them), and the
        # other role's state as its row last reported it.
        self._journal: tp.List[tp.Tuple[tp.Any, ...]] = []
        self._tick_done: tp.List[FinishedRequest] = []
        self._remote: tp.Dict[str, tp.Any] = {"prefill_idle": True, "decode_idle": True, "queue": self.queue.stats(),
                                              "decode_stats": None, "prefill_stats": None}
        self.finished: tp.Dict[int, FinishedRequest] = {}
        # prefill-role uid -> (uid, prompt, max_new, eos, deadline)
        self._pf_pending: tp.Dict[int, tp.Tuple[int, np.ndarray, int, tp.Optional[int], tp.Optional[float]]] = {}
        self._dec_pending: tp.Dict[int, HandoffItem] = {}
        self._uid = 0
        # handoffs that could not get decode-pool pages and re-prefilled there
        self.fallback_reprefills = 0
        # prefill<->decode pool-capacity moves (ModelOps re-role decisions)
        self.re_roles = 0

    # -- public surface ------------------------------------------------

    def submit(self, prompt: tp.Sequence[int], max_new_tokens: int, eos_id: tp.Optional[int] = None,
               ttl_s: tp.Optional[float] = None) -> int:
        """Queue a request on the PREFILL role (budget 1: prefill + first
        token is a complete request there). Backpressure propagates. On a
        mesh only the leader takes submissions; they reach the other ranks
        at the next tick."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.mesh is None:
            deadline = None if ttl_s is None else self._clock() + ttl_s
            pf_uid = self.prefill.submit(prompt, 1, eos_id=None, ttl_s=ttl_s)
            return self._pending(pf_uid, prompt, max_new_tokens, eos_id, deadline)
        if not self.mesh.is_leader:
            raise RuntimeError("submit() on a mesh goes to its leader; the other ranks follow()")
        now = self._clock()
        try:
            pf_uid = self.prefill._op_submit(prompt, 1, None, ttl_s, now)
        except Exception as e:
            self._journal.append((prompt, max_new_tokens, eos_id, ttl_s, now, ("raise", type(e).__name__)))
            raise
        self._journal.append((prompt, max_new_tokens, eos_id, ttl_s, now, ("ok", pf_uid)))
        return self._pending(pf_uid, prompt, max_new_tokens, eos_id, None if ttl_s is None else now + ttl_s)

    def _pending(self, pf_uid, prompt, max_new_tokens, eos_id, deadline) -> int:
        uid = self._uid
        self._uid += 1
        self._pf_pending[pf_uid] = (uid, prompt, max_new_tokens, eos_id, deadline)
        return uid

    @property
    def idle(self) -> bool:
        if self.mesh is not None:
            return not self._pf_pending and self._remote["prefill_idle"] and self._remote["decode_idle"]
        return (not self._pf_pending and not self._dec_pending and not len(self.queue)
                and self.prefill.idle and self.decode.idle)

    def run(self) -> tp.Dict[int, FinishedRequest]:
        while not self.idle:
            self.step()
        return self.finished

    def step(self) -> None:
        """One pipeline tick: advance prefill, hand its finishes to the
        queue, adopt queued handoffs into the decode role, advance decode,
        collect its finishes. On a mesh the leader's tick, which every
        other rank takes in `follow()` (module docstring)."""
        if self.mesh is not None:
            if not self.mesh.is_leader:
                raise RuntimeError("a follower rank of a disaggregated mesh ticks in follow()")
            packet = {"kind": "tick", "submits": self._journal, "now": self._clock()}
            self._journal = []
            self._tick(self.mesh.broadcast_object(packet))
            return
        if not self.prefill.idle:
            self.prefill.step()
        self._drain_prefill()
        self._drain_queue()
        if not self.decode.idle:
            self.decode.step()
        self._drain_decode()

    def follow(self) -> None:
        """A follower rank's loop: take each tick the leader broadcasts,
        until its `stop_followers()`."""
        if self.mesh is None or self.mesh.is_leader:
            raise RuntimeError("follow() runs on the follower ranks of a disaggregated mesh")
        while True:
            packet = self.mesh.broadcast_object(None)
            if packet["kind"] == "stop":
                self._apply_submits(packet["submits"])
                return
            self._tick(packet)

    def stop_followers(self) -> None:
        """The leader's last broadcast: `follow()` returns on every other
        rank. Nothing without a mesh."""
        if self.mesh is not None and self.mesh.is_leader:
            self.mesh.broadcast_object({"kind": "stop", "submits": self._journal})
            self._journal = []

    def _now(self) -> float:
        return self._tick_now

    def _apply_submits(self, submits) -> None:
        """A follower's copy of the leader's submissions, in order: the
        prefill row submits them to its engine at the leader's clock (and
        must reach the leader's outcome), every rank records the pending
        request."""
        for prompt, max_new, eos_id, ttl_s, now, want in submits:
            if self._role == 0:
                try:
                    got = ("ok", self.prefill._op_submit(prompt, 1, None, ttl_s, now))
                except Exception as e:  # the leader's submit may have raised too: compared below
                    got = ("raise", type(e).__name__)
                if got != want:
                    self.prefill._diverged = f"disagg submit: the leader's outcome {want}, this rank's {got}"
            if want[0] == "ok":
                self._pending(want[1], prompt, max_new, eos_id, None if ttl_s is None else now + ttl_s)

    def _tick(self, packet) -> None:
        """One lockstep tick of a mesh rank (module docstring)."""
        self._tick_now = packet["now"]
        if not self.mesh.is_leader:
            self._apply_submits(packet["submits"])
        news, blocks, decode_news = None, [], None
        self._tick_done = []
        if self._role == 0:
            if not self.prefill.idle:
                self.prefill.step()
            items = self._handoffs()
            blocks = [it.blocks for it in items]  # this rank's shard of each item's pages
            news = {"items": [dataclasses.replace(it, blocks={}) for it in items], "done": self._tick_done,
                    "idle": self.prefill.idle, "stats": self.prefill.stats() if self.mesh.is_leader else None}
        news = self.mesh.broadcast_object(news, src=self._leads[0])
        if any(it.n_pages for it in news["items"]):
            if self._role == 0:
                self.mesh.send_object(blocks, self._peer)
            else:
                blocks = self.mesh.recv_object(self._peer)
        elif self._role == 1:
            blocks = [{} for _ in news["items"]]  # no item holds a complete page
        if self._role == 1:
            for fr in news["done"]:
                self.finished[fr.uid] = fr
            self._tick_done = []
            for it, b in zip(news["items"], blocks):
                self.queue.push(dataclasses.replace(it, blocks=b))
            self._drain_queue()
            if not self.decode.idle:
                self.decode.step()
            self._drain_decode()
            decode_news = {"done": self._tick_done, "fallback": self.fallback_reprefills, "queue": self.queue.stats(),
                           "idle": not self._dec_pending and not len(self.queue) and self.decode.idle,
                           "stats": self.decode.stats() if self.decode.mesh.is_leader else None}
        decode_news = self.mesh.broadcast_object(decode_news, src=self._leads[1])
        if self._role == 0:
            for fr in decode_news["done"]:
                self.finished[fr.uid] = fr
        self.fallback_reprefills = decode_news["fallback"]
        self._remote = {"prefill_idle": news["idle"], "decode_idle": decode_news["idle"],
                        "queue": decode_news["queue"], "prefill_stats": news["stats"],
                        "decode_stats": decode_news["stats"]}

    def stats(self) -> tp.Dict[str, tp.Any]:
        """The pipeline's counters and each role's stats (on a mesh: the
        queue and the decode role's as its row last reported them)."""
        if self.mesh is not None:
            return {
                "queue": self._remote["queue"],
                "fallback_reprefills": self.fallback_reprefills,
                "re_roles": self.re_roles,
                "prefill": self.prefill.stats() if self.prefill is not None else self._remote["prefill_stats"],
                "decode": self.decode.stats() if self.decode is not None else self._remote["decode_stats"],
                "obs": DISABLED_SNAPSHOT if self.obs is None else self.obs.snapshot(),
            }
        return {
            "queue": self.queue.stats(),
            "fallback_reprefills": self.fallback_reprefills,
            "re_roles": self.re_roles,
            "prefill": self.prefill.stats(),
            "decode": self.decode.stats(),
            "obs": DISABLED_SNAPSHOT if self.obs is None else self.obs.snapshot(),
        }

    def rebalance(self, n_pages: int, *, src: str = "prefill", dst: str = "decode") -> tp.Dict[str, tp.Any]:
        """Move `n_pages` of pool capacity from the `src` role to the `dst`
        role with two live resizes (sampling/ops.py resize_pool), shrink
        first: a refused shrink raises the retryable PoolResizeError before
        anything changed, and the grow that follows cannot fail. Re-roling
        moves page BUDGET; pages in flight still cross on the handoff."""
        roles = {"prefill": self.prefill, "decode": self.decode}
        if src not in roles or dst not in roles or src == dst:
            raise ValueError(f"rebalance src/dst must be distinct roles from {sorted(roles)}, got {src!r}->{dst!r}")
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if self.mesh is not None:
            raise NotImplementedError("rebalance on a mesh resizes both rows' engines in one tick: not ported yet "
                                      "(ROADMAP.md Queue 1 item 7, re-roling and the spill tier under tp)")
        shrink = roles[src].resize(roles[src].allocator.num_pages - n_pages)
        grow = roles[dst].resize(roles[dst].allocator.num_pages + n_pages)
        self.re_roles += 1
        self._trace.instant("ops.re_role", "ops", "disagg", args={"src": src, "dst": dst, "pages": n_pages})
        return {"src": src, "dst": dst, "pages": n_pages, "src_resize": shrink, "dst_resize": grow}

    # -- internals -----------------------------------------------------

    def _finish(self, fr: FinishedRequest) -> None:
        self.finished[fr.uid] = fr
        if self.mesh is not None:
            self._tick_done.append(fr)  # its role's first rank broadcasts the tick's finishes

    def _drain_prefill(self) -> None:
        for item in self._handoffs():
            self.queue.push(item)

    def _handoffs(self) -> tp.List[HandoffItem]:
        """Finish the prefill role's completed requests that end there, and
        gather the others' pages: their handoff items, in order."""
        items = []
        for pf_uid in [u for u in self._pf_pending if u in self.prefill.finished]:
            uid, prompt, max_new, eos_id, deadline = self._pf_pending.pop(pf_uid)
            fr = self.prefill.finished[pf_uid]
            if fr.status != "ok":
                self._finish(FinishedRequest(uid, fr.tokens, fr.token_times, fr.status))
                continue
            first = int(fr.tokens[len(prompt)])
            first_time = fr.token_times[0]
            if max_new == 1 or (eos_id is not None and first == eos_id):
                self._finish(FinishedRequest(uid, np.append(prompt, np.int32(first)), [first_time], "ok"))
                continue
            item = self._gather_pages(uid, prompt, first, first_time, max_new, eos_id, deadline)
            items.append(item)
            self._trace.instant("handoff.push", "disagg", "disagg",
                                args={"uid": uid, "n_pages": item.n_pages, "bytes": sum(b.nbytes for b in item.blocks.values())})
        return items

    def _gather_pages(self, uid, prompt, first, first_time, max_new, eos_id, deadline) -> HandoffItem:
        """Reference the request's complete prompt pages in the prefill
        trie, copy their content to the host on the prefill role's stream,
        and drop the references through the prefill engine's own free path
        (the entries stay in the PREFILL trie for later template hits: the
        handoff copies, it does not steal)."""
        eng = self.prefill
        with self._trace.span("handoff.gather", "disagg", "disagg"):
            pc = eng.prefix_cache
            mr = pc.match(prompt, max_tokens=len(prompt) - 1)
            n = len(mr.pages)
            blocks: tp.Dict[str, np.ndarray] = {}
            if n:
                with eng._on_stream():
                    blocks = gather_pages(eng.cache, mr.pages)
                    eng._free_pages(pc.release(prompt[: n * eng.page_size], mr.pages, n))
        return HandoffItem(uid=uid, prompt=prompt, first_token=first, first_time=first_time,
                           max_new_tokens=max_new, eos_id=eos_id, deadline=deadline, blocks=blocks, n_pages=n)

    def _drain_queue(self) -> None:
        while True:
            item = self.queue.pop()
            if item is None:
                break
            head = np.append(item.prompt, np.int32(item.first_token))
            remaining = None
            if item.deadline is not None:
                remaining = item.deadline - (self._clock() if self.mesh is None else self._tick_now)
                if remaining <= 0:
                    self._finish(FinishedRequest(item.uid, head, [item.first_time], "timeout"))
                    continue
            try:
                if self.mesh is None:
                    dec_uid = self.decode.submit(head, item.max_new_tokens - 1, item.eos_id, ttl_s=remaining)
                else:  # both ranks of the decode row, at the tick's clock
                    dec_uid = self.decode._op_submit(head, item.max_new_tokens - 1, item.eos_id, remaining,
                                                     self._tick_now)
            except BackpressureError:
                try:
                    self.queue.requeue(item)
                except HandoffRetryExhausted:
                    # a wedged decode role: terminal shed, never a spin
                    self._finish(FinishedRequest(item.uid, head, [item.first_time], "shed"))
                break  # the decode role is full; retry next tick
            with self._trace.span("handoff.adopt", "disagg", "disagg"):
                self._adopt(item)
            self._dec_pending[dec_uid] = item

    def _adopt(self, item: HandoffItem) -> None:
        """Allocate decode-pool pages, write the handed-off content into
        them in place, and donate them to the DECODE trie at refcount 0: the
        decode engine's admission then matches them and skips the prompt's
        prefill. When the pool cannot free enough pages (after reclaiming
        unreferenced trie pages once) the request re-prefills instead."""
        n = item.n_pages
        if n == 0:
            return
        eng = self.decode
        with eng._on_stream():
            dst = eng.allocator.alloc(n)
            if dst is None:
                # the engine's own pressure valve, then one retry
                eng._free_pages(eng.prefix_cache.evict(n - eng.allocator.free_count))
                dst = eng.allocator.alloc(n)
            if dst is None:
                self.fallback_reprefills += 1
                self._trace.instant("handoff.fallback_reprefill", "disagg", "disagg", args={"uid": item.uid})
                return
            adopt_pages(eng.cache, dst, item.blocks)
            eng._free_pages(eng.prefix_cache.release(item.prompt[: n * eng.page_size], dst, 0))

    def _drain_decode(self) -> None:
        for dec_uid in [u for u in self._dec_pending if u in self.decode.finished]:
            item = self._dec_pending.pop(dec_uid)
            fr = self.decode.finished[dec_uid]
            # (prompt + first) + the decode role's generation: the monolithic stream
            self._finish(FinishedRequest(item.uid, fr.tokens, [item.first_time] + list(fr.token_times), fr.status))
