"""CUDA-graph replays of the decode loops: the port's counterpart of the
one XLA program per static key that the JAX engine compiles and dispatches
for `_serve_decode_group` (midgpt_tpu/sampling/serve.py), and of the batch
sampler's `_decode_chunk` (`StepGraphs`, at the end of this module).

`DecodeGraphs` holds one `torch.cuda.CUDAGraph` per static program key —
(n_steps, round_group, page bucket, split, temperature, top_k, top_p,
attn_impl, cache dtype, model config), the JAX program's static arguments
— captured at the key's first dispatch and replayed for every later one.
A graph reads one packed int64 input buffer (the host's per-slot view and
the page table, uploaded per dispatch) and two chain buffers (the previous
group's device-side tokens and lengths), and writes the tokens, the
emitted mask, and the final tokens and lengths. A dispatch enqueues the
upload, the replay and the copies of the outputs out of the graph's
memory, and never waits for the device; `GroupResult.host()` waits for
one dispatch's copy only.

Everything runs in stream order on the engine's current stream: uploads,
replays, prefill chunks and the page reuse that follows an eviction, a
cancel or a window reclaim. That order is what makes a page freed under an
in-flight group safe to hand to a later prefill (JAX gets the same order
from the donated cache). The warm-up and the capture use a side stream,
fenced to the engine's stream on both sides.

Captures use the thread-local capture mode: only the capturing thread's
own unsafe CUDA calls (a sync, an allocation outside the pool) invalidate
its capture. An armed watchdog (robustness/watchdog.py) forces each settle
in a worker thread, and a worker abandoned by an expired deadline may still
sit in an event's `synchronize()`; under the default global mode that call
would break every later capture on the main thread.

No cyclic garbage collection runs during a capture (`_gc_paused`): an
engine caught in a reference cycle (one a caller's hooks make; the fleet
router's token relays and the spill hook hold their targets weakly) is
freed by the collector, whenever it runs, and destroying its graphs while
another one captures is an operation the capture may not see; it
invalidates that capture. Pauses nest across threads: the collector comes
back on when the last capture in flight ends.

CPU tensors never get here: the engine runs the same body eagerly
(sampling/serve.py). A failed capture raises; nothing falls back to eager
execution on CUDA.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import threading
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.kernels.build import CaptureTally

Tensor = torch.Tensor

# body(packed, chain_token, chain_len, warmup) -> (toks_emitted (2T, B),
# tok_fin (B,), len_fin (B,)); warmup=True runs one step instead of T.
Body = tp.Callable[[Tensor, Tensor, Tensor, bool], tp.Tuple[Tensor, Tensor, Tensor]]


# Captures made in this process, by kind ("decode_group", "batch_step"):
# what a fleet worker reports over the wire, and what the router process of
# a worker-process fleet must leave unchanged (sampling/fleet_proc.py
# `process_launch_counts`).
PROCESS_CAPTURES: tp.Counter[str] = collections.Counter()

_gc_lock = threading.Lock()
_gc_holds = 0  # captures in flight, all threads
_gc_was_enabled = False  # the collector's state when the first of them began


@contextlib.contextmanager
def _gc_paused() -> tp.Iterator[None]:
    """Hold off the cyclic garbage collector (module docstring)."""
    global _gc_holds, _gc_was_enabled
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


@dataclasses.dataclass
class GroupResult:
    """One dispatched group's outputs: the tokens over the emitted mask,
    on the host (pinned memory filled by a copy that `ready` marks) or on
    the CPU, and the final tokens and lengths on the device, where they
    chain the next group without a sync."""

    toks_emitted: Tensor  # (2T, B) int64: T rows of tokens, then T rows of the emitted mask
    tok_fin: Tensor  # (B,) int64 — the next group's chain_token
    len_fin: Tensor  # (B,) int32 — the next group's chain_len
    ready: tp.Optional[torch.cuda.Event] = None

    def host(self) -> tp.Tuple[np.ndarray, np.ndarray]:
        """(toks (T, B), emitted (T, B) bool), waiting for this group's copy
        to the host only — never for the whole device."""
        if self.ready is not None:
            self.ready.synchronize()
        both = self.toks_emitted.numpy()
        T = both.shape[0] // 2
        return both[:T], both[T:].astype(bool)


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    packed: Tensor  # the input buffer the graph reads
    chain_token: Tensor
    chain_len: Tensor
    out: tp.Tuple[Tensor, Tensor, Tensor]  # the graph's outputs, in its memory
    tally: CaptureTally  # the kernel launches one replay makes


class DecodeGraphs:
    """One captured CUDA graph per static program key (module docstring),
    with its counters: captures per key, replays, warm-up steps."""

    def __init__(self, device: torch.device, slots: int, generator: torch.Generator):
        self.device = device
        self.slots = slots
        self.generator = generator
        self._graphs: tp.Dict[tp.Hashable, _Captured] = {}
        self.captures: tp.Counter[tp.Hashable] = collections.Counter()
        self.replays = 0
        self.warmup_steps = 0  # device decode steps run by warm-ups (every slot masked)
        self._pool = torch.cuda.graph_pool_handle()  # one memory pool for all the engine's graphs
        self._stream = torch.cuda.Stream(device)  # warm-up and capture

    def dispatch(self, key: tp.Hashable, body: Body, packed: np.ndarray,
                 chain: tp.Optional[tp.Tuple[Tensor, Tensor]]) -> GroupResult:
        """Enqueue one group: upload `packed`, take the chain from the
        previous group's device outputs (None: no slot chains, and the
        chain buffers are ignored), replay the key's graph (capturing it
        first if new), copy the outputs out. Returns without waiting."""
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(key, body, packed.shape)
        # Inputs from host memory: a fresh pinned buffer per dispatch, copied
        # without waiting. The host allocator hands that buffer out again only
        # after its copy ran, so no later dispatch overwrites inputs the device
        # has not read; the copy into the graph's buffer is stream-ordered after
        # the previous replay that read it.
        cap.packed.copy_(torch.from_numpy(packed).pin_memory(), non_blocking=True)
        if chain is not None:
            cap.chain_token.copy_(chain[0])
            cap.chain_len.copy_(chain[1])
        # On the engine's current stream, like everything else it enqueues.
        cap.graph.replay()
        cap.tally.replayed()
        self.replays += 1
        # The outputs live in the graph's memory, which the next replay of this
        # key — or of another graph sharing the pool — overwrites, and under
        # overlap="double" that replay is enqueued before this group settles.
        # So they are copied out now, before any later replay is enqueued: the
        # tokens to pinned host memory, with an event the settle waits on, and
        # the chain values to device tensors of their own.
        toks_emitted, tok_fin, len_fin = cap.out
        host = torch.empty(toks_emitted.shape, dtype=toks_emitted.dtype, pin_memory=True)
        host.copy_(toks_emitted, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return GroupResult(host, tok_fin.clone(), len_fin.clone(), ready)

    def _capture(self, key: tp.Hashable, body: Body, shape: tp.Tuple[int, ...]) -> _Captured:
        dev, B = self.device, self.slots
        # All-zero inputs: every slot inactive (active, chain_mask and max_len
        # 0), the page table on the sink page.
        packed = torch.zeros(shape, dtype=torch.int64, device=dev)
        chain_token = torch.zeros(B, dtype=torch.int64, device=dev)
        chain_len = torch.zeros(B, dtype=torch.int32, device=dev)
        stream, current = self._stream, torch.cuda.current_stream(dev)
        # Warm-up: torch needs the step run once, outside a capture, before it
        # is captured (lazy kernel loads, library handles for the capture
        # stream, the model's cached index tensors). It really runs, so it
        # writes the pool: with every slot inactive each write goes to the
        # spare page (models/gpt.py PagedKVCache), which nothing reads.
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body(packed, chain_token, chain_len, True)
        current.wait_stream(stream)
        self.warmup_steps += 1
        graph = torch.cuda.CUDAGraph()
        # each replay draws fresh numbers from the engine's generator
        graph.register_generator_state(self.generator)
        tally = CaptureTally()
        # The capture executes nothing; the wrappers' launches land in `tally`.
        with _gc_paused(), tally, torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                                   capture_error_mode="thread_local"):
            out = body(packed, chain_token, chain_len, False)
        self.captures[key] += 1
        PROCESS_CAPTURES["decode_group"] += 1
        return _Captured(graph, packed, chain_token, chain_len, out, tally)

    def drop(self, slots: int) -> int:
        """Drop every capture (each reads the pool it was captured against,
        and a live resize replaces that pool) for `slots` slots from now on;
        returns how many were dropped. Each key captures anew at its next
        dispatch, on the same side stream and memory pool: a new stream
        would bring cuBLAS a new workspace, which it keeps for the
        process's life. The counters keep counting."""
        n = len(self._graphs)
        self._graphs.clear()
        self.slots = slots
        return n

    def stats(self) -> tp.Dict[str, tp.Any]:
        return {
            "captured": len(self._graphs),
            "captures_per_key": sorted(self.captures.values()),
            "replays": self.replays,
            "warmup_steps": self.warmup_steps,
        }


@dataclasses.dataclass
class CapturedStep:
    """One key's captured step and the buffers it reads and writes."""

    graph: torch.cuda.CUDAGraph
    state: tp.Any  # the caller's buffers, made once per key and reused by every later call


class StepGraphs:
    """CUDA-graph replays of the batch sampler's decode step
    (sampling/engine.py `generate`): the port's counterpart of the
    `_decode_chunk` program JAX compiles per static key.

    One decode+sample step is captured per static key — batch size, model
    config, dtype, sampling knobs, the weights' addresses, the generator —
    and a chunk of n steps is n replays, with no host work between them.
    Capturing a whole chunk instead would put n copies of the step's
    kernels into one graph, for each of the chunk lengths. The step reads and writes only buffers the key owns (`state`:
    the contiguous cache with its device-side length, and the token
    sequence), so one replay follows the previous one through device memory
    alone, and the same capture serves every later call of its key.

    The warm-up and the capture run on a side stream, fenced to the current
    stream on both sides; the warm-up draws from a scratch generator, so
    the caller's generator advances by the replays only. With temperature
    > 0 the caller's generator is registered with the graph: each replay
    draws fresh numbers from it. A failed capture raises; nothing falls
    back to eager execution. CPU tensors never get here (the sampler runs
    the same step eagerly)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: tp.Dict[tp.Hashable, CapturedStep] = {}
        self.captures = 0
        self.replays = 0
        self._pool = torch.cuda.graph_pool_handle()  # one memory pool for all keys' graphs
        self._stream = torch.cuda.Stream(device)

    def get(
        self,
        key: tp.Hashable,
        make_state: tp.Callable[[], tp.Any],
        step: tp.Callable[[tp.Any, tp.Optional[torch.Generator]], None],
        generator: tp.Optional[torch.Generator],
    ) -> CapturedStep:
        """The key's captured step, capturing it first if the key is new:
        `make_state()` makes the buffers, `step(state, generator)` runs one
        step on them in place (the warm-up runs it once for real, so the
        caller fills the buffers afterwards)."""
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(make_state, step, generator)
        return cap

    def replay(self, cap: CapturedStep, n: int) -> None:
        """n steps: n replays on the current stream, without waiting."""
        for _ in range(n):
            cap.graph.replay()
        self.replays += n

    def _capture(self, make_state, step, generator) -> CapturedStep:
        state = make_state()
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        scratch = None if generator is None else torch.Generator(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            step(state, scratch)
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with _gc_paused(), torch.cuda.graph(graph, pool=self._pool, stream=stream, capture_error_mode="thread_local"):
            step(state, generator)
        current.wait_stream(stream)
        self.captures += 1
        PROCESS_CAPTURES["batch_step"] += 1
        return CapturedStep(graph, state)
