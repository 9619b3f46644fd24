"""Fleet serving: N ServeEngine replicas behind a prefix-affinity router,
with health-checked failover and a verified host-RAM KV spill tier (the
port's counterpart of midgpt_tpu/sampling/fleet.py, in-process replicas).

  * `FleetRouter` places arrivals by TRIE AFFINITY: the first page_size
    tokens of the prompt rendezvous-hash over the alive replicas
    (`_affinity`: crc32 of the page's int64 bytes plus the replica index,
    JAX's bytes exactly, so a worker process and the router agree), so
    requests sharing a system prompt land on the replica holding its pages.
    Only a dead replica's keys move when it dies.
  * Health-checked FAILOVER: each replica steps inside a try/except with
    clock-injected heartbeats; one that raises `max_consecutive_failures`
    times in a row, or whose heartbeat goes stale past
    `heartbeat_timeout_s`, is marked dead; each caught exception is kept,
    with its replica and round, in `step_errors`. Its finished results are
    harvested, and its accepted-but-unfinished streams are resubmitted to
    the survivors through the bounded `PageHandoffQueue` retry path
    (sampling/disagg.py) with the ORIGINAL prompt and FULL budget: greedy
    streams do not depend on the batch's composition, so a failed-over
    stream reproduces the tokens the dead replica would have served.
    `on_token` delivery is therefore at-least-once across a failover;
    `finished` is exactly-once. A dead replica keeps its engine in
    `engines`, its pool and its captured graphs included, as in JAX.
  * `SpillTier`: a host-RAM tier under every replica's trie. A refcount-0
    page spills its content to the host on eviction (int8 pages with their
    scales; bf16 pages as raw 16-bit words) instead of being discarded,
    keyed by its FULL token prefix, with a crc32 over its blocks (JAX's
    `_blocks_crc`, byte for byte) checked on take and the weights_version
    it was computed under: a corrupt or stale page is discarded and its
    tokens re-prefill. Re-adoption writes through the one page-transport
    funnel (disagg.adopt_pages). The tier is shared fleet-wide: KV depends
    on tokens and weights only, not on the replica that computed it.

Graceful degradation: when every survivor sheds an admission the router
raises one aggregated, retryable BackpressureError (`submit_retry` wraps
it in the shared bounded backoff), and a failover the survivors refuse
past the queue's budget finishes "shed". `assert_fleet_conserved` checks
every alive replica's pool law and the tier's ledger (resident + readopted
+ corrupt_discarded + capacity_dropped + stale_discarded == total_spilled).

A replica may also be a worker PROCESS (sampling/fleet_proc.py
`ProcReplica`, `is_proc`): the same engine surface over a crc32-framed
socket transport. The router then fires the wire fault kinds against the
busiest alive worker (`proc_kill9`, `conn_drop`, `wire_corrupt`,
`wire_stall`), a SIGKILLed worker is detected by the same consecutive-failure
health check through its failing RPCs (`proc_failovers`), and
`transport_stats` rolls up the workers' transports.
"""

from __future__ import annotations

import dataclasses
import time
import typing as tp
import weakref
import zlib

import numpy as np

from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.robustness.backoff import retry_with_backoff
from midgpt_tpu_torch.sampling.disagg import HandoffRetryExhausted, PageHandoffQueue, host_block
from midgpt_tpu_torch.sampling.serve import BackpressureError, FinishedRequest, ServeEngine


class _SpillEntry:
    """One spilled page: single-page host blocks ('k'/'v' (L, H, ps, C)
    and, int8 pools, 'k_scale'/'v_scale' (L, H, ps)), the crc32 of their
    bytes, the weights_version the KV was computed under, an LRU stamp."""

    __slots__ = ("blocks", "checksum", "weights_version", "stamp", "nbytes")

    def __init__(self, blocks, checksum, weights_version, stamp):
        self.blocks = blocks
        self.checksum = checksum
        self.weights_version = weights_version
        self.stamp = stamp
        self.nbytes = sum(b.nbytes for b in blocks.values())


def _blocks_crc(blocks: tp.Dict[str, np.ndarray]) -> int:
    crc = 0
    for key in sorted(blocks):
        crc = zlib.crc32(blocks[key].tobytes(), crc)
    return crc


@dataclasses.dataclass
class SpillTransferItem:
    """One spilled page crossing a process boundary (`export_entries` /
    `import_entries`): its key, host blocks, spill-time checksum and
    weights_version, unverified in transit."""

    key: tp.Tuple[int, ...]
    blocks: tp.Dict[str, np.ndarray]
    checksum: int
    weights_version: str


class SpillTier:
    """Host-RAM spill tier for evicted trie pages (module docstring).

    Entries key on the page's full token prefix, so `peek_run`/`take_run`
    walk exactly the pages an admission's trie match stopped short of.
    Checksums are verified at TAKE (the moment the bytes would enter a
    decode), never at peek: a corrupt entry truncates the run, counts
    `corrupt_discarded`, and its tokens re-prefill.

    Chaos hooks (robustness/faults.py): `arm_stall` makes the NEXT consult
    that would return pages refuse (`stall_fallbacks`; the caller
    re-prefills); `corrupt_one` flips a byte of the newest resident entry
    so the checksum is exercised end to end."""

    def __init__(self, *, capacity_bytes: tp.Optional[int] = None,
                 clock: tp.Callable[[], float] = time.perf_counter):
        self._entries: tp.Dict[tp.Tuple[int, ...], _SpillEntry] = {}
        self.capacity_bytes = capacity_bytes
        self._clock = clock
        self._tick = 0
        self._stall_armed = False
        # page_size is bound once, at the first attach (ServeEngine.attach_spill):
        # keys are multiples of it, and replicas sharing the tier must agree
        self._ps = 0
        # ledger counters (every spilled page ends in exactly one bucket)
        self.total_spilled = 0
        self.readopted = 0
        self.corrupt_discarded = 0
        self.capacity_dropped = 0
        self.stale_discarded = 0
        # cross-process transfer buckets: pages that entered/left this tier
        # over the wire rather than by spill/take
        self.received = 0
        self.transferred = 0
        # visibility counters outside the ledger
        self.duplicate_skips = 0
        self.stall_fallbacks = 0
        self.spilled_bytes = 0
        self.readopted_bytes = 0

    # -- spill side (PrefixCache.on_evict, through ServeEngine) ---------

    def spill(self, cache, prefix: tp.Sequence[int], page: int, weights_version: str) -> bool:
        """Land `page`'s pool content on the host under `prefix` (the
        page's full token prefix). Called while the page's device bytes are
        intact (eviction frees the page after the hook returns), on the
        owning engine's stream; the host copy waits for it."""
        key = tuple(int(t) for t in prefix)
        existing = self._entries.get(key)
        if existing is not None:
            if existing.weights_version == weights_version:
                # same tokens + same weights => same KV; keep the resident
                self.duplicate_skips += 1
                return False
            # a stale duplicate from before a hot swap: replace it
            del self._entries[key]
            self.stale_discarded += 1
        blocks = {"k": host_block(cache.k[:, :, page]), "v": host_block(cache.v[:, :, page])}
        if cache.k_scale is not None:
            blocks["k_scale"] = host_block(cache.k_scale[:, page])
            blocks["v_scale"] = host_block(cache.v_scale[:, page])
        self._tick += 1
        entry = _SpillEntry(blocks, _blocks_crc(blocks), weights_version, self._tick)
        self._entries[key] = entry
        self.total_spilled += 1
        self.spilled_bytes += entry.nbytes
        self._enforce_capacity()
        return True

    def _enforce_capacity(self) -> None:
        if self.capacity_bytes is None:
            return
        while len(self._entries) > 1 and sum(e.nbytes for e in self._entries.values()) > self.capacity_bytes:
            key = min(self._entries, key=lambda k: self._entries[k].stamp)
            del self._entries[key]
            self.capacity_dropped += 1

    # -- re-adopt side (ServeEngine._readopt_from_spill) ----------------

    def peek_run(self, prompt, start_page: int, limit: int, weights_version: str) -> int:
        """How many consecutive pages from page depth `start_page` of
        `prompt` are resident under `weights_version` (checksums are not
        verified here). An armed stall refuses the first consult that would
        return pages, then clears."""
        ps = self._require_ps()
        n = 0
        for j in range(limit):
            e = self._entries.get(tuple(int(t) for t in prompt[: (start_page + j + 1) * ps]))
            if e is None or e.weights_version != weights_version:
                break
            n += 1
        if n and self._stall_armed:
            self._stall_armed = False
            self.stall_fallbacks += 1
            return 0
        return n

    def take_run(self, prompt, start_page: int, n: int, weights_version: str) -> tp.List[tp.Dict[str, np.ndarray]]:
        """Move up to `n` consecutive pages out of the tier (the caller owns
        them; a later eviction re-spills). Each page's crc32 is verified
        here: a mismatch discards THAT entry, truncates the run and counts
        `corrupt_discarded`."""
        ps = self._require_ps()
        out: tp.List[tp.Dict[str, np.ndarray]] = []
        for j in range(n):
            e = self._entries.pop(tuple(int(t) for t in prompt[: (start_page + j + 1) * ps]), None)
            if e is None:
                break
            if e.weights_version != weights_version:
                self.stale_discarded += 1
                break
            if _blocks_crc(e.blocks) != e.checksum:
                self.corrupt_discarded += 1
                break
            self.readopted += 1
            self.readopted_bytes += e.nbytes
            out.append(e.blocks)
        return out

    def set_page_size(self, ps: int) -> None:
        if self._ps and self._ps != ps:
            raise ValueError(f"spill tier already bound to page_size={self._ps}, got {ps}")
        self._ps = ps

    def _require_ps(self) -> int:
        if not self._ps:
            raise RuntimeError("spill tier consulted before any engine attached it "
                               "(ServeEngine.attach_spill binds page_size)")
        return self._ps

    # -- chaos hooks ------------------------------------------------------

    def arm_stall(self) -> None:
        self._stall_armed = True

    def corrupt_one(self) -> bool:
        """Flip a byte of the newest resident entry's K block WITHOUT
        updating its checksum. False when nothing is resident."""
        if not self._entries:
            return False
        e = self._entries[max(self._entries, key=lambda k: self._entries[k].stamp)]
        k = e.blocks["k"].copy()
        k.view(np.uint8).reshape(-1)[0] ^= 0xFF
        e.blocks["k"] = k
        return True

    # -- cross-process transfer -------------------------------------------

    def export_entries(self) -> tp.List[SpillTransferItem]:
        """Move every resident entry out (oldest first), through the
        `transferred` bucket. Checksums travel unverified and unchanged: the
        receiver's take-side check covers transit and residence at once."""
        items = [
            SpillTransferItem(key=key, blocks=e.blocks, checksum=e.checksum, weights_version=e.weights_version)
            for key, e in sorted(self._entries.items(), key=lambda kv: kv[1].stamp)
        ]
        self._entries.clear()
        self.transferred += len(items)
        return items

    def import_entries(self, items) -> int:
        """Land transferred entries with their ORIGINAL checksums (through
        the `received` bucket). A resident duplicate under the same
        weights_version wins (`duplicate_skips`, and the incoming page is
        `stale_discarded`); a stale resident one is replaced."""
        imported = 0
        for it in items:
            key = tuple(int(t) for t in it.key)
            self.received += 1
            imported += 1
            existing = self._entries.get(key)
            if existing is not None:
                if existing.weights_version == it.weights_version:
                    self.duplicate_skips += 1
                    self.stale_discarded += 1
                    continue
                del self._entries[key]
                self.stale_discarded += 1
            self._tick += 1
            self._entries[key] = _SpillEntry(dict(it.blocks), int(it.checksum), it.weights_version, self._tick)
        self._enforce_capacity()
        return imported

    # -- accounting ---------------------------------------------------------

    def resident_count(self) -> int:
        return len(self._entries)

    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def ledger(self) -> tp.Dict[str, int]:
        return {
            "total_spilled": self.total_spilled,
            "resident": len(self._entries),
            "readopted": self.readopted,
            "corrupt_discarded": self.corrupt_discarded,
            "capacity_dropped": self.capacity_dropped,
            "stale_discarded": self.stale_discarded,
            "received": self.received,
            "transferred": self.transferred,
        }

    def assert_ledger(self, where: str = "") -> None:
        """Pages in (spilled + received) == pages accounted for (resident,
        readopted, a discard bucket, or transferred)."""
        led = self.ledger()
        total = (led["resident"] + led["readopted"] + led["corrupt_discarded"] + led["capacity_dropped"]
                 + led["stale_discarded"] + led["transferred"])
        assert total == led["total_spilled"] + led["received"], (
            f"spill ledger violated {where}: {led} (buckets sum to {total})"
        )

    def stats(self) -> tp.Dict[str, int]:
        return {
            **self.ledger(),
            "resident_bytes": self.resident_bytes(),
            "spilled_bytes": self.spilled_bytes,
            "readopted_bytes": self.readopted_bytes,
            "duplicate_skips": self.duplicate_skips,
            "stall_fallbacks": self.stall_fallbacks,
        }


@dataclasses.dataclass
class FailoverItem:
    """One accepted stream crossing replicas after a crash: the ORIGINAL
    prompt and FULL budget. Rides PageHandoffQueue with empty blocks: the
    pages re-prefill at the destination (from its trie or the shared spill
    tier), nothing is gathered from the dead replica."""

    uid: int  # fleet uid
    prompt: np.ndarray  # (T0,) int32
    max_new_tokens: int
    eos_id: tp.Optional[int]
    deadline: tp.Optional[float]
    blocks: tp.Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    n_pages: int = 0


@dataclasses.dataclass
class _Stream:
    """The router's record of an accepted stream: what a replay needs."""

    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: tp.Optional[int]
    deadline: tp.Optional[float]
    replica: int
    replica_uid: int


class FleetRouter:
    """N ServeEngine replicas behind prefix-affinity routing with
    health-checked failover (module docstring). The router OWNS its
    engines: it overwrites their `on_token` hooks (replica uid -> fleet
    uid) and attaches the shared spill tier to each. Engines must be greedy,
    prefix-cached, and agree on page_size."""

    def __init__(
        self,
        engines: tp.Sequence[ServeEngine],
        *,
        clock: tp.Callable[[], float] = time.perf_counter,
        spill: tp.Optional[SpillTier] = None,
        heartbeat_timeout_s: tp.Optional[float] = None,
        max_consecutive_failures: int = 3,
        failover_retries: int = 512,
        on_token: tp.Optional[tp.Callable[[int, int, float], None]] = None,
        on_finish: tp.Optional[tp.Callable[[FinishedRequest], None]] = None,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError("a fleet needs at least one replica")
        for i, eng in enumerate(engines):
            if eng.prefix_cache is None:
                raise ValueError(f"replica {i} has no prefix cache — the trie is the router's affinity target "
                                 "and the spill tier's source")
            if eng.temperature != 0.0:
                raise ValueError("FleetRouter is greedy-only: failover replays a stream on a survivor and "
                                 "bit-parity is the contract")
        ps = engines[0].page_size
        if any(e.page_size != ps for e in engines):
            raise ValueError("replicas must agree on page_size")
        self.engines = engines
        self.page_size = ps
        self.alive = [True] * len(engines)
        self._clock = clock
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_consecutive_failures = max_consecutive_failures
        self.on_token = on_token
        self.on_finish = on_finish
        self.spill = spill if spill is not None else SpillTier(clock=clock)
        for i, eng in enumerate(engines):
            eng.attach_spill(self.spill)
            eng.on_token = self._make_token_relay(i)
        # failover transport: disagg's bounded-retry queue with empty blocks
        # (base_s=0: the router tick is the pacing)
        self.failover_queue = PageHandoffQueue(retries=failover_retries, base_s=0.0, clock=clock)
        self.finished: tp.Dict[int, FinishedRequest] = {}
        self._pending: tp.Dict[int, _Stream] = {}
        self._by_replica: tp.Dict[tp.Tuple[int, int], int] = {}
        self._uid = 0
        self.rounds = 0
        now = clock()
        self._heartbeat = [now] * len(engines)
        self._failures = [0] * len(engines)
        self.failovers = 0  # replica deaths
        self.failed_over_streams = 0
        self.router_shed = 0  # submit-time refusals by every replica
        self.shed_streams = 0  # failovers terminally shed past the budget
        self.crash_log: tp.List[tp.Dict[str, tp.Any]] = []
        # every exception a replica's step raised: {"replica", "round", "error" (its repr)}
        self.step_errors: tp.List[tp.Dict[str, tp.Any]] = []
        # worker-process replicas (sampling/fleet_proc.py) mark themselves
        self._proc_idx = [i for i, eng in enumerate(engines) if getattr(eng, "is_proc", False)]
        self.proc_failovers = 0

    # -- admission -----------------------------------------------------------

    def submit(self, prompt: tp.Sequence[int], max_new_tokens: int, eos_id: tp.Optional[int] = None,
               ttl_s: tp.Optional[float] = None) -> int:
        """Place a request on its affinity replica, spilling over to the
        other survivors least-loaded first; raises one aggregated
        BackpressureError (retryable iff any replica's shed was) when every
        survivor sheds."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        deadline = None if ttl_s is None else self._clock() + ttl_s
        uid = self._uid
        self._place(uid, prompt, max_new_tokens, eos_id, deadline)
        self._uid += 1
        return uid

    def submit_retry(self, prompt: tp.Sequence[int], max_new_tokens: int, eos_id: tp.Optional[int] = None,
                     ttl_s: tp.Optional[float] = None, *, retries: int = 8, base_s: float = 0.0) -> int:
        """`submit` under the shared bounded backoff schedule; the "sleep"
        between attempts steps the fleet once (capacity frees as replicas
        finish work). Non-retryable sheds propagate at once."""
        return retry_with_backoff(
            lambda: self.submit(prompt, max_new_tokens, eos_id, ttl_s),
            retries=retries,
            base_s=base_s,
            retry_on=(BackpressureError,),
            sleep=lambda _delay: self.step(),
            should_retry=lambda e: getattr(e, "retryable", False),
        )

    def _place(self, uid, prompt, max_new_tokens, eos_id, deadline) -> None:
        ttl = None if deadline is None else max(deadline - self._clock(), 0.0)
        errs: tp.List[BackpressureError] = []
        for i in self._route_order(prompt):
            try:
                ruid = self.engines[i].submit(prompt, max_new_tokens, eos_id, ttl_s=ttl)
            except BackpressureError as e:
                errs.append(e)
                continue
            self._pending[uid] = _Stream(uid, prompt, max_new_tokens, eos_id, deadline, i, ruid)
            self._by_replica[(i, ruid)] = uid
            return
        self.router_shed += 1
        first = errs[0] if errs else None
        raise BackpressureError(
            f"all {sum(self.alive)} surviving replicas shed the request"
            + (f" (affinity replica: {first})" if first is not None else ""),
            needed_pages=getattr(first, "needed_pages", None),
            backlog_pages=getattr(first, "backlog_pages", None),
            budget_pages=getattr(first, "budget_pages", None),
            retryable=any(e.retryable for e in errs),
        )

    def _load(self, candidates: tp.Iterable[int]) -> tp.Dict[int, int]:
        load = {i: 0 for i in candidates}
        for st in self._pending.values():
            if st.replica in load:
                load[st.replica] += 1
        return load

    def _route_order(self, prompt) -> tp.List[int]:
        """The affinity replica first, then the other survivors least loaded
        first. A prompt without a full shareable page has no affinity."""
        alive = [i for i, a in enumerate(self.alive) if a]
        if not alive:
            raise RuntimeError("no alive replicas in the fleet")
        load = self._load(alive)
        rest = sorted(alive, key=lambda i: (load[i], i))
        aff = self._affinity(prompt, alive)
        if aff is None:
            return rest
        return [aff] + [i for i in rest if i != aff]

    def _affinity(self, prompt, alive: tp.List[int]) -> tp.Optional[int]:
        """Rendezvous (highest-random-weight) hash of the first page: the
        crc32 of its int64 bytes and the replica index's 4 little-endian
        bytes, JAX's exactly."""
        ps = self.page_size
        if len(prompt) < ps + 1:  # a match caps at len(prompt) - 1 tokens
            return None
        key = np.asarray(prompt[:ps], np.int64).tobytes()
        return max(alive, key=lambda i: zlib.crc32(key + i.to_bytes(4, "little")))

    # -- the fleet round -------------------------------------------------------

    @property
    def idle(self) -> bool:
        return (not self._pending and not len(self.failover_queue)
                and all(eng.idle for i, eng in enumerate(self.engines) if self.alive[i]))

    def run(self, max_rounds: int = 100_000) -> tp.Dict[int, FinishedRequest]:
        start = self.rounds
        while not self.idle:
            if self.rounds - start >= max_rounds:
                raise RuntimeError(f"fleet failed to drain within {max_rounds} rounds")
            self.step()
        return self.finished

    def step(self) -> None:
        """One fleet round: fire the fleet faults, step every alive replica
        under the health checks, harvest finishes, drain the failover queue
        onto the survivors."""
        self.rounds += 1
        if sum(self.alive) > 1 and faults.should_fire("engine_crash", step=self.rounds):
            self._crash(self._crash_victim(), reason="fault")
        if faults.should_fire("handoff_stall", step=self.rounds):
            self.spill.arm_stall()
        if self.spill.resident_count() > 0 and faults.should_fire("spill_corrupt", step=self.rounds):
            self.spill.corrupt_one()
        self._fire_proc_faults()
        for i, eng in enumerate(self.engines):
            if not self.alive[i]:
                continue
            now = self._clock()
            if eng.idle:
                self._heartbeat[i] = now
                continue
            try:
                eng.step()
            except Exception as e:  # a replica's failure is the health check's input, never the fleet's
                self.step_errors.append({"replica": i, "round": self.rounds, "error": repr(e)})
                self._failures[i] += 1
                if self._failures[i] >= self.max_consecutive_failures:
                    self._crash(i, reason="consecutive_failures")
                continue
            self._heartbeat[i] = now
            self._failures[i] = 0
            if self.heartbeat_timeout_s is not None and self._clock() - self._heartbeat[i] > self.heartbeat_timeout_s:
                self._crash(i, reason="heartbeat_stale")
        self._harvest()
        self._drain_failover()

    def _fire_proc_faults(self) -> None:
        """The wire fault kinds, against the busiest alive worker-process
        replica, so the fault lands under traffic. `proc_kill9` SIGKILLs the
        worker and does NOT mark it dead: detection flows through the health
        checks, as its step RPCs fail with ReplicaGoneError until the
        consecutive-failure threshold crashes it. The other three arm
        transport-level faults the RPC retries must absorb."""
        procs = [i for i in self._proc_idx if self.alive[i]]
        if not procs:
            return
        victim = self._busiest(procs)
        if sum(self.alive) > 1 and faults.should_fire("proc_kill9", step=self.rounds):
            self.engines[victim].kill9()
        if faults.should_fire("conn_drop", step=self.rounds):
            self.engines[victim].drop_conn()
        if faults.should_fire("wire_corrupt", step=self.rounds):
            self.engines[victim].arm_wire_corrupt()
        if faults.should_fire("wire_stall", step=self.rounds):
            self.engines[victim].arm_wire_stall()

    def _busiest(self, candidates: tp.List[int]) -> int:
        load = self._load(candidates)
        return max(sorted(load), key=lambda i: load[i])

    def _crash_victim(self) -> int:
        """engine_crash's target: the alive replica holding the most
        accepted streams (low index on a tie)."""
        return self._busiest([i for i, a in enumerate(self.alive) if a])

    def _crash(self, i: int, *, reason: str) -> None:
        """Mark replica `i` dead and fail its streams over: harvest what it
        finished, push every accepted-but-unfinished stream onto the
        failover queue. Its engine stays in `engines` with its memory; its
        spilled pages live on in the shared tier."""
        if not self.alive[i]:
            return
        self.alive[i] = False
        self.failovers += 1
        if getattr(self.engines[i], "is_proc", False):
            self.proc_failovers += 1
        self.crash_log.append({"replica": i, "round": self.rounds, "reason": reason})
        closer = getattr(self.engines[i], "on_router_crash", None)
        if closer is not None:
            closer()
        self._harvest_engine(i)
        for st in sorted((st for st in self._pending.values() if st.replica == i), key=lambda st: st.uid):
            del self._pending[st.uid]
            del self._by_replica[(i, st.replica_uid)]
            self.failover_queue.push(FailoverItem(uid=st.uid, prompt=st.prompt, max_new_tokens=st.max_new_tokens,
                                                  eos_id=st.eos_id, deadline=st.deadline))
            self.failed_over_streams += 1

    def _harvest(self) -> None:
        for i in range(len(self.engines)):
            if self.alive[i]:
                self._harvest_engine(i)

    def _harvest_engine(self, i: int) -> None:
        eng = self.engines[i]
        for st in [st for st in self._pending.values() if st.replica == i and st.replica_uid in eng.finished]:
            fr = eng.finished[st.replica_uid]
            out = FinishedRequest(st.uid, fr.tokens, fr.token_times, fr.status)
            self.finished[st.uid] = out
            del self._pending[st.uid]
            del self._by_replica[(i, st.replica_uid)]
            if self.on_finish is not None:
                self.on_finish(out)

    def _drain_failover(self) -> None:
        while True:
            item = self.failover_queue.pop()
            if item is None:
                break
            if item.deadline is not None and item.deadline - self._clock() <= 0:
                self._terminal(item, "timeout")
                continue
            try:
                self._place(item.uid, item.prompt, item.max_new_tokens, item.eos_id, item.deadline)
            except BackpressureError:
                try:
                    self.failover_queue.requeue(item)
                except HandoffRetryExhausted:
                    # survivors refused past the budget: a terminal shed
                    self._terminal(item, "shed")
                    self.shed_streams += 1
                break

    def _terminal(self, item: FailoverItem, status: str) -> None:
        out = FinishedRequest(item.uid, item.prompt, [], status)
        self.finished[item.uid] = out
        if self.on_finish is not None:
            self.on_finish(out)

    def _make_token_relay(self, i: int):
        # the engine holds its relay and the router its engines: a weak
        # reference keeps that from being a cycle, so a dropped router and
        # its engines are freed at once, never by a later collection
        router = weakref.ref(self)

        def relay(ruid: int, tok: int, t: float) -> None:
            r = router()
            uid = None if r is None else r._by_replica.get((i, ruid))
            if uid is not None and r.on_token is not None:
                r.on_token(uid, tok, t)

        return relay

    # -- reporting ---------------------------------------------------------------

    def prefix_hit_rate(self) -> float:
        """Fleet-wide trie hit rate: matched over matchable tokens summed
        over EVERY replica (dead ones served traffic before dying)."""
        matched = sum(e._prefix_matched_tokens for e in self.engines)
        matchable = sum(e._prefix_matchable_tokens for e in self.engines)
        return matched / matchable if matchable else 0.0

    def transport_stats(self) -> tp.Optional[tp.Dict[str, tp.Any]]:
        """The wire rollup over the worker-process replicas (None for an
        in-process fleet): the volume and recovery counters summed, the mean
        p50 and the worst p95 RPC latency."""
        if not self._proc_idx:
            return None
        per = [self.engines[i].transport.stats() for i in self._proc_idx]
        out: tp.Dict[str, tp.Any] = {
            k: sum(s[k] for s in per)
            for k in ("rpc_count", "wire_bytes", "connects", "reconnects", "retries", "corrupt_frames",
                      "deadline_expiries", "forced_drops")
        }
        out["rpc_p50_ms"] = round(sum(s["rpc_p50_ms"] for s in per) / len(per), 3)
        out["rpc_p95_ms"] = max(s["rpc_p95_ms"] for s in per)
        return out

    def stats(self) -> tp.Dict[str, tp.Any]:
        return {
            "fleet_size": len(self.engines),
            "alive": sum(self.alive),
            "rounds": self.rounds,
            "failovers": self.failovers,
            "proc_failovers": self.proc_failovers,
            "failed_over_streams": self.failed_over_streams,
            "router_shed": self.router_shed,
            "shed_streams": self.shed_streams,
            "prefix_hit_rate": self.prefix_hit_rate(),
            "failover_queue": self.failover_queue.stats(),
            "spill": self.spill.stats(),
            "transport": self.transport_stats(),
            "crash_log": list(self.crash_log),
            "replicas": [
                {
                    "alive": self.alive[i],
                    "rounds": eng.rounds,
                    "preemptions": eng.preemptions,
                    "shed": eng.shed,
                    "spill_readopted_pages": eng.spill_readopted_pages,
                    "prefix_hit_rate": eng.prefix_stats()["hit_rate"],
                }
                for i, eng in enumerate(self.engines)
            ],
        }


def assert_fleet_conserved(router: FleetRouter, where: str = "") -> None:
    """The cross-tier conservation law: every ALIVE replica obeys the
    single-engine pool law (ops.assert_conserved; a dead replica's pool
    serves nobody), and the shared spill tier's ledger closes. A worker
    process runs the pool law and its own tier's ledger in the worker
    (`ProcReplica.assert_conserved`, over the `conserve` RPC)."""
    from midgpt_tpu_torch.sampling import ops

    for i, eng in enumerate(router.engines):
        if not router.alive[i]:
            continue
        if getattr(eng, "is_proc", False):
            eng.assert_conserved(f"{where} fleet replica {i}")
        else:
            ops.assert_conserved(eng, f"{where} fleet replica {i}")
    router.spill.assert_ledger(where)
