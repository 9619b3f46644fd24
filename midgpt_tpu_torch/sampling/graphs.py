"""CUDA-graph replays of the fused decode group: the port's counterpart of
the one XLA program per static key that the JAX engine compiles and
dispatches for `_serve_decode_group` (midgpt_tpu/sampling/serve.py).

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

CPU tensors never get here: the engine runs the same body eagerly
(sampling/serve.py). A failed capture raises; nothing falls back to eager
execution on CUDA.
"""

from __future__ import annotations

import collections
import dataclasses
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.kernels.build import CaptureTally

Tensor = torch.Tensor

# body(packed, chain_token, chain_len, warmup) -> (toks_emitted (2T, B),
# tok_fin (B,), len_fin (B,)); warmup=True runs one step instead of T.
Body = tp.Callable[[Tensor, Tensor, Tensor, bool], tp.Tuple[Tensor, Tensor, Tensor]]


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
        with tally, torch.cuda.graph(graph, pool=self._pool, stream=stream, capture_error_mode="thread_local"):
            out = body(packed, chain_token, chain_len, False)
        self.captures[key] += 1
        return _Captured(graph, packed, chain_token, chain_len, out, tally)

    def stats(self) -> tp.Dict[str, tp.Any]:
        return {
            "captured": len(self._graphs),
            "captures_per_key": sorted(self.captures.values()),
            "replays": self.replays,
            "warmup_steps": self.warmup_steps,
        }
