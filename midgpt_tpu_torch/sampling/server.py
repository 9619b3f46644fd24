"""Asyncio streaming front door over the continuous-batching engine (the
port's counterpart of midgpt_tpu/sampling/server.py).

`ServeEngine` is deliberately synchronous host code: one thread owns the
scheduler state and drives one device program at a time (sampling/serve.py).
Production traffic is the opposite shape — many concurrent clients, each
wanting tokens AS THEY LAND, some disconnecting mid-stream, all under a
process that must drain cleanly on SIGTERM. This module bridges the two
with one rule: **every touch of the engine happens on the driver loop.**
Client coroutines never call the engine directly; they enqueue commands
(submit / cancel) that the driver applies between rounds, and they consume
per-request asyncio queues that the engine's `on_token`/`on_finish` hooks
feed. The engine stays single-threaded, the event loop stays unblocked
(`engine.step` runs in a worker thread via `asyncio.to_thread`), and no
lock ever guards scheduler state. Successive steps may land on different
worker threads; the engine enters the CUDA stream it was built on in every
step (sampling/serve.py), so stream order holds whichever thread steps.

    engine = ServeEngine(config, params, max_slots=8)
    server = AsyncServeServer(engine)
    driver = asyncio.create_task(server.run())
    uid = await server.submit(prompt, max_new_tokens=128, ttl_s=30.0)
    async for tok in server.stream(uid):   # tokens stream as rounds land
        ...
    await server.drain()                   # or SIGTERM: same path
    await driver

Robustness behaviors:

  * **Cancellation** — a client that stops consuming its stream (generator
    closed, task cancelled) enqueues `engine.cancel(uid)`: pages return to
    the pool at the next round boundary and co-resident requests are
    untouched (tests/test_torch_server.py).
  * **Deadline propagation** — `submit(ttl_s=...)` rides the engine's TTL
    machinery unchanged; a timed-out request ends its stream with the
    `timeout` status visible in `result(uid)`.
  * **Backpressure retry** — a retryable BackpressureError is retried a
    bounded number of times on the shared exponential-backoff schedule
    (robustness/backoff.py — the same discipline as the checkpoint
    write retry), using the exception's structured fields instead of
    string-parsing; non-retryable sheds (SLOScheduler deadline
    infeasibility) surface immediately.
  * **Slow clients** — each stream has a bounded server-side token buffer
    (`max_buffered_tokens`); a client that stops draining is shed with
    status "slow_client" instead of wedging pool pages behind a dead
    socket. The `slow_client` fault (robustness/faults.py, step key =
    request uid) forces exactly this condition deterministically.
  * **Graceful drain** — `drain()` (or SIGTERM/SIGINT through the
    one-shot preemption flag, robustness/preempt.py: the driver polls
    `preempt.requested()` each round) stops admission — further submits
    raise `ServerDraining` — finishes every in-flight request, then lets
    `run()` return.

Round-overlap dispatch changes nothing structurally here, and that is the point: tokens only ever reach
the `on_token` hooks from SETTLED rounds — the engine's step() commits a
round's tokens after its force lands, and under overlap="double" that is
one step later than the dispatch. A client therefore never streams a
token the engine could still discard (an in-flight round killed by
`kill_overlapped_round` drops un-settled tokens and recompute-preempts;
anything already streamed was settled and stays bit-final). The driver
loop's `engine.idle` check also covers the in-flight handle, so drain
waits for the last overlapped round to settle before `run()` returns.

On a tensor-parallel row (`ServeEngine(mesh=...)`) the server runs on the
row's leader rank, whose engine journals every call the driver applies
and broadcasts it at the next step edge; the other ranks of the row run
the follower loop, `engine.follow()`, and the leader's
`engine.stop_followers()` ends it once the server has drained
(midgpt_tpu_torch/loadgen.py `--tp`). `stats()["mesh"]` names the row.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import typing as tp

from midgpt_tpu_torch.obs import DISABLED_SNAPSHOT, NULL_TRACER
from midgpt_tpu_torch.robustness import faults, preempt
from midgpt_tpu_torch.robustness.backoff import backoff_delays
from midgpt_tpu_torch.sampling.serve import BackpressureError, FinishedRequest, ServeEngine

_END = object()  # stream terminator sentinel


class ServerDraining(RuntimeError):
    """submit() after drain began — the process is shutting down; clients
    should fail over to another replica, not queue behind a drain."""


@dataclasses.dataclass
class _Stream:
    """Per-request delivery state. `queue` is consumed by the client
    coroutine; `buffered` counts tokens handed to the stream but not yet
    consumed (the slow-client bound); `stalled` marks a client the
    slow_client fault wedged — its tokens accrue in the buffer but never
    reach the queue, exactly like a dead socket."""

    queue: asyncio.Queue
    buffered: int = 0
    stalled: bool = False
    finished: tp.Optional[FinishedRequest] = None
    first_token_seen: bool = False  # TTFT instant fired (obs lifecycle)


class AsyncServeServer:
    """Streaming asyncio front end over one `ServeEngine` (module
    docstring). Construct, schedule `run()` as a task, then `submit` /
    `stream` / `result` from any number of client coroutines."""

    def __init__(
        self,
        engine: ServeEngine,
        *,
        submit_retries: int = 4,
        retry_backoff_s: float = 0.05,
        max_buffered_tokens: int = 512,
        idle_poll_s: float = 0.005,
        honor_preempt_flag: bool = True,
    ):
        # max_buffered_tokens sizes the per-client shed bound; tokens land
        # in per-ROUND bursts (up to decode_chunk, or spec_k+1 per slot),
        # so keep it a healthy multiple of the engine's chunk size or brief
        # consumer lag reads as a dead client.
        if engine.on_token is not None or engine.on_finish is not None:
            raise ValueError("engine already has streaming hooks installed")
        self.engine = engine
        self.submit_retries = submit_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_buffered_tokens = max_buffered_tokens
        self.idle_poll_s = idle_poll_s
        self.honor_preempt_flag = honor_preempt_flag
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish
        # Request-lifecycle tracing rides the ENGINE's observability (the
        # server claims on_token/on_finish exclusively — obs must not —
        # so the lifecycle events are emitted from these hook bodies).
        # NULL_TRACER when the engine runs obs-off: every site is free.
        self._trace = (
            engine.obs.tracer if engine.obs is not None else NULL_TRACER
        )
        self._streams: tp.Dict[int, _Stream] = {}
        # Commands are (fn, future-or-None); appended from the event loop
        # (submit/cancel) or the driver's worker thread (slow-client sheds
        # noticed mid-step) — deque append/popleft are atomic under the GIL
        # and the driver only APPLIES commands on the loop thread while no
        # step is in flight, so engine state stays single-threaded.
        self._cmds: tp.Deque[
            tp.Tuple[tp.Callable[[], tp.Any], tp.Optional[asyncio.Future]]
        ] = collections.deque()
        self._wake = asyncio.Event()
        self._draining = False
        self._running = False
        self._stopped = False  # run() returned; no command will ever apply
        self._loop: tp.Optional[asyncio.AbstractEventLoop] = None

    # -- driver --------------------------------------------------------

    async def run(self) -> None:
        """The driver loop: apply queued commands, step the engine in a
        worker thread while there is work, exit once draining AND idle.
        Exactly one run() may be active; it owns all engine access."""
        if self._running or self._stopped:
            raise RuntimeError("run() is already active or finished")
        self._running = True
        self._loop = asyncio.get_running_loop()
        try:
            while True:
                if (
                    self.honor_preempt_flag
                    and preempt.requested()
                    and not self._draining
                ):
                    # SIGTERM/SIGINT landed (one-shot flag handler,
                    # robustness/preempt.py): stop admission, finish
                    # in-flight work, exit — the serving twin of the train
                    # loop's emergency-save-and-exit.
                    self._trace.instant("drain.sigterm", "lifecycle", "server")
                    self._draining = True
                self._apply_commands()
                if not self.engine.idle:
                    await asyncio.to_thread(self.engine.step)
                elif self._draining and not self._cmds:
                    return
                else:
                    # Idle: park until a submit wakes us (or poll the
                    # preempt flag / drain request at a bounded interval).
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(
                            self._wake.wait(), timeout=self.idle_poll_s
                        )
                    except asyncio.TimeoutError:
                        pass
        finally:
            self._running = False
            self._stopped = True
            # Fail any command that raced the shutdown instead of hanging
            # its awaiter forever.
            while self._cmds:
                _, fut = self._cmds.popleft()
                if fut is not None and not fut.done():
                    fut.set_exception(
                        ServerDraining("server stopped before command ran")
                    )

    def _apply_commands(self) -> None:
        while self._cmds:
            fn, fut = self._cmds.popleft()
            try:
                result = fn()
            except Exception as e:
                if fut is None:
                    raise
                if not fut.done():
                    fut.set_exception(e)
            else:
                if fut is not None and not fut.done():
                    fut.set_result(result)

    async def _call(self, fn: tp.Callable[[], tp.Any]) -> tp.Any:
        """Run `fn` on the driver loop between engine rounds. Commands may
        be enqueued before run() is first scheduled (they apply on its
        first iteration); after run() returned they fail fast."""
        if self._stopped:
            raise ServerDraining("server driver has stopped")
        fut = asyncio.get_running_loop().create_future()
        self._cmds.append((fn, fut))
        self._wake.set()
        return await fut

    # -- client surface ------------------------------------------------

    async def submit(
        self,
        prompt: tp.Sequence[int],
        max_new_tokens: int,
        *,
        eos_id: tp.Optional[int] = None,
        ttl_s: tp.Optional[float] = None,
    ) -> int:
        """Queue a request; returns its uid once admitted. A retryable
        BackpressureError is absorbed up to `submit_retries` attempts on
        the shared exponential-backoff schedule; a non-retryable shed (or
        budget exhaustion) re-raises to the caller."""

        def do_submit() -> int:
            if self._draining:
                raise ServerDraining("server is draining; submit refused")
            uid = self.engine.submit(
                prompt, max_new_tokens, eos_id=eos_id, ttl_s=ttl_s
            )
            self._streams[uid] = _Stream(queue=asyncio.Queue())
            # Async span: one Perfetto track per request from accepted
            # submit to terminal status (_on_finish closes it). Shed
            # attempts never reach here — the engine emits their instant.
            self._trace.async_begin(
                "request", str(uid), "lifecycle", "server",
                args={
                    "uid": uid,
                    "prompt_len": len(prompt),
                    "max_new_tokens": max_new_tokens,
                },
            )
            return uid

        delays = backoff_delays(self.submit_retries, self.retry_backoff_s)
        while True:
            try:
                return await self._call(do_submit)
            except BackpressureError as e:
                delay = next(delays, None)
                if delay is None or not e.retryable:
                    raise
                await asyncio.sleep(delay)

    async def stream(self, uid: int) -> tp.AsyncIterator[int]:
        """Yield `uid`'s generated tokens as the engine lands them; returns
        on any terminal status (ok/EOS/timeout/cancelled). Abandoning the
        iterator (client disconnect, task cancellation) cancels the request
        at the next round boundary and frees its pages
        (tests/test_torch_server.py)."""
        st = self._streams[uid]
        try:
            while True:
                item = await st.queue.get()
                if item is _END:
                    return
                st.buffered -= 1
                yield item
        finally:
            if st.finished is None:
                # Enqueue-only (no await allowed in a generator finally
                # during GeneratorExit): the driver applies it next round.
                self._cmds.append(
                    (lambda: self.engine.cancel(uid, status="cancelled"), None)
                )
                self._wake.set()

    def result(self, uid: int) -> tp.Optional[FinishedRequest]:
        """The terminal record (tokens + status), once the stream ended."""
        st = self._streams.get(uid)
        return None if st is None else st.finished

    def stats(self) -> tp.Dict[str, tp.Any]:
        """Engine observability snapshot for metrics scrapes (used by
        midgpt_tpu_torch/loadgen.py). Counters are plain ints mutated only inside
        `engine.step` on the driver's worker thread, so a read from the
        event loop is at worst one round stale, never torn."""
        eng = self.engine
        return {
            "rounds": eng.rounds,
            "shed": eng.shed,
            "timeouts": eng.timeouts,
            "cancelled": eng.cancelled,
            "preemptions": eng.preemptions,
            "decode_kills": eng.decode_kills,
            "prefilled_tokens": eng.prefilled_tokens,
            "free_pages": eng.allocator.free_count,
            "prefix": eng.prefix_stats(),
            "mesh": eng.mesh_shape(),
            "weights_version": eng.weights_version,
            "hot_swaps": eng.hot_swaps,
            "resizes": eng.resizes,
            "swap_pending": eng._staged_swap is not None,
            # same schema as ServeEngine.stats()["obs"]: round
            # decomposition + metrics
            "obs": (
                DISABLED_SNAPSHOT if eng.obs is None else eng.obs.snapshot()
            ),
        }

    async def hot_swap(
        self,
        params,
        *,
        draft_params=None,
        version: str = "inline",
        config=None,
    ) -> tp.Dict[str, tp.Any]:
        """Stage a blue/green weight swap on the driver loop (the same
        command funnel as submit/cancel, so the stage lands between engine
        rounds, never mid-round). Returns the stage summary; the flip
        itself happens at the first slot-free round boundary and shows up
        on stats() as the new `weights_version`. Structured HotSwapError
        on a shape, dtype or config mismatch (sampling/ops.py)."""

        def do_swap() -> tp.Dict[str, tp.Any]:
            return self.engine.hot_swap(
                params, draft_params=draft_params, version=version,
                config=config,
            )

        return await self._call(do_swap)

    async def resize(
        self,
        num_pages: tp.Optional[int] = None,
        *,
        max_slots: tp.Optional[int] = None,
    ) -> tp.Dict[str, tp.Any]:
        """Live pool resize on the driver loop; retryable PoolResizeError
        when shrinking below the resident working set (sampling/ops.py)."""

        def do_resize() -> tp.Dict[str, tp.Any]:
            return self.engine.resize(num_pages, max_slots=max_slots)

        return await self._call(do_resize)

    async def drain(self) -> None:
        """Stop admission and wait for every in-flight request to finish.
        `run()` returns once the engine is idle. Idempotent."""
        self._draining = True
        self._wake.set()
        while not self._stopped and not (self.engine.idle and not self._cmds):
            await asyncio.sleep(self.idle_poll_s)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- engine hooks (called inside engine.step, driver worker thread) --

    def _on_token(self, uid: int, tok: int, t: float) -> None:
        st = self._streams.get(uid)
        if st is None:
            return
        # The slow_client fault (step key = uid) wedges this stream: from
        # now on its tokens pile into the buffer like writes into a dead
        # socket, and the bound below sheds it.
        if faults.should_fire("slow_client", step=uid):
            st.stalled = True
        if not st.first_token_seen:
            st.first_token_seen = True
            self._trace.instant(
                "first_token", "lifecycle", "server", args={"uid": uid}
            )
        st.buffered += 1
        if not st.stalled:
            self._loop.call_soon_threadsafe(st.queue.put_nowait, tok)
        if st.buffered > self.max_buffered_tokens and st.finished is None:
            # Bounded-buffer shed: the client is not draining; cancel at
            # the next round boundary instead of holding pool pages behind
            # a dead consumer.
            self._trace.instant(
                "slow_client_shed", "lifecycle", "server", args={"uid": uid}
            )
            self._cmds.append(
                (lambda: self.engine.cancel(uid, status="slow_client"), None)
            )

    def _on_finish(self, fr: FinishedRequest) -> None:
        st = self._streams.get(fr.uid)
        if st is None:
            return
        st.finished = fr
        self._trace.async_end(
            "request", str(fr.uid), "lifecycle", "server",
            args={"status": fr.status},
        )
        self._loop.call_soon_threadsafe(st.queue.put_nowait, _END)
