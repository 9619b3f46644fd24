"""Worker-process fleet serving: the replica socket transport and the worker
protocol (the port's counterpart of midgpt_tpu/sampling/fleet_proc.py).

Each replica is a worker PROCESS hosting one ServeEngine (its own CUDA
context, kernel libraries, pool and host-RAM SpillTier) started by
`spawn_worker` (`python -m midgpt_tpu_torch.sampling.fleet_worker`, a fresh
interpreter: never a fork of a process holding a CUDA context). The
FleetRouter (sampling/fleet.py) drives it through `ProcReplica`, which has
the duck-typed engine surface the router already speaks (`submit` / `step`
/ `idle` / `finished` / counter attributes), so an in-process fleet and a
worker-process fleet differ only in the replica objects. No
`torch.distributed`: replicas share no tensors and no collectives;
everything that crosses the boundary is plain host data over a socket.

Wire format, JAX's byte for byte (length-prefixed, crc32-framed JSON and
binary blobs):

    header:  magic "MGW1" | u32 payload_len | u32 crc32(payload)
    payload: u32 json_len | JSON bytes | blob bytes (concatenated)

numpy arrays anywhere in a message tree become ``{"__blob__": i}``
descriptors (dtype and shape in the JSON head) and travel as raw bytes:
never pickled, never a torch.Tensor (the codec refuses one; a worker turns
tensors into Python scalars or numpy arrays where it reads them). bf16 KV
pages travel as the uint16 words the SpillTier keeps. Magic, length and
crc32 are verified BEFORE the JSON is parsed: a truncated or bit-flipped
frame raises `WireFrameError` and its connection is dropped, so a bad frame
costs a retried RPC (harvest marks make retries idempotent), never a
decode.

`ReplicaTransport` carries the robustness: per-RPC deadlines (a socket
timeout becomes a structured `TransportError`), connect and call retries on
the shared `robustness/backoff.py` schedule, a wire heartbeat (`last_ok` on
the injected clock), and the chaos hooks `arm_wire_corrupt` /
`arm_wire_stall` / `drop_conn` of the `wire_corrupt` / `wire_stall` /
`conn_drop` fault kinds. A worker unreachable past the retry budget raises
`ReplicaGoneError`; the router's consecutive-failure health check turns
that into the same failover an in-process replica's death takes, so a
`kill -9` of a worker (`proc_kill9`) is detected through the wire alone.

Retry idempotence, per verb: `submit` carries the router-side `seq` the
worker dedups on (a retried admit never admits twice); `harvest` is a
high-water-mark read (`events_from` + `known_uids`); a retried `step` runs
one more engine round, which greedy streams do not notice; `stats` and
`conserve` are reads. SIGTERM drains through the preemption flag
(robustness/preempt.py): the handler only sets the flag, the worker loop
sees it between RPCs, refuses new admissions with a non-retryable
backpressure reply, finishes its streams, and exits once idle and
disconnected. Spilled KV survives a drain: `spill_export` / `spill_import`
move `SpillTransferItem`s (their spill-time checksums with them), and the
tier's `received` / `transferred` buckets keep its ledger closing across
the boundary.

JAX's workers report their compile counts; here a worker reports its
kernel launches by counter and variant and its CUDA-graph captures
(`process_launch_counts`), which is how a launch made in another process is
counted, and how a router process is held to launching nothing.

This module imports no engine at module scope: the codec, the errors and
the transport need only numpy, torch and sockets.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import typing as tp
import zlib
from pathlib import Path

import numpy as np
import torch

from midgpt_tpu_torch.robustness.backoff import retry_with_backoff

# -- structured errors (JAX's error contracts: these classes and fields) ----------


class TransportError(ConnectionError):
    """One RPC attempt failed at the transport layer: connect refused, a
    send or receive error, or no response inside the per-RPC deadline.
    Retryable: `ReplicaTransport.call` absorbs these on the backoff schedule
    and raises `ReplicaGoneError` once the budget is spent."""

    def __init__(self, message: str, *, host: str, port: int, rpc: str, deadline_s: tp.Optional[float] = None):
        super().__init__(message)
        self.host = host
        self.port = port
        self.rpc = rpc
        self.deadline_s = deadline_s


class WireFrameError(ValueError):
    """A frame failed validation before its JSON was decoded: bad magic, a
    truncated read, a length past the bound, or a crc32 mismatch. The
    connection is dropped and the RPC retries on a fresh one. `reason` is
    one of "truncated", "bad_magic", "length", "checksum"."""

    def __init__(self, message: str, *, reason: str, nbytes: int = 0):
        super().__init__(message)
        self.reason = reason
        self.nbytes = nbytes


class ReplicaGoneError(ConnectionError):
    """The worker stayed unreachable past the transport's whole retry
    budget: the wire's verdict that the replica is dead, which the router's
    health check turns into a failover."""

    def __init__(self, message: str, *, host: str, port: int, rpc: str, attempts: int):
        super().__init__(message)
        self.host = host
        self.port = port
        self.rpc = rpc
        self.attempts = attempts


# -- frame codec -----------------------------------------------------------------

_MAGIC = b"MGW1"
_HEADER = struct.Struct("<4sII")  # magic | payload_len | crc32(payload)
_JLEN = struct.Struct("<I")
# A sanity bound, not a budget: a length field past it is a desynced or
# corrupt stream (a full-width KV page is ~0.6 MB).
MAX_FRAME_BYTES = 1 << 28


def _pack_tree(obj: tp.Any, blobs: tp.List[np.ndarray]) -> tp.Any:
    """JSON-ify a message tree, lifting numpy arrays out as indexed blobs."""
    if isinstance(obj, np.ndarray):
        # reshape back: ascontiguousarray makes a 0-d array 1-d
        blobs.append(np.ascontiguousarray(obj).reshape(obj.shape))
        return {"__blob__": len(blobs) - 1}
    if isinstance(obj, dict):
        return {str(k): _pack_tree(v, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack_tree(v, blobs) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, torch.Tensor):
        raise TypeError("a torch.Tensor cannot cross the wire: convert it to a Python scalar or a numpy array "
                        f"where it is read (got {tuple(obj.shape)} {obj.dtype} on {obj.device})")
    return obj


def _unpack_tree(obj: tp.Any, blobs: tp.List[np.ndarray]) -> tp.Any:
    if isinstance(obj, dict):
        if set(obj) == {"__blob__"}:
            return blobs[obj["__blob__"]]
        return {k: _unpack_tree(v, blobs) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack_tree(v, blobs) for v in obj]
    return obj


def encode_frame(obj: tp.Any) -> bytes:
    """Message tree -> one framed byte string (module docstring layout)."""
    blobs: tp.List[np.ndarray] = []
    tree = _pack_tree(obj, blobs)
    head = json.dumps(
        {"tree": tree, "blobs": [{"dtype": str(b.dtype), "shape": list(b.shape)} for b in blobs]},
        separators=(",", ":"),
    ).encode("utf-8")
    payload = b"".join([_JLEN.pack(len(head)), head] + [b.tobytes() for b in blobs])
    return _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload)) + payload


def decode_frame(data: bytes) -> tp.Any:
    """One framed byte string -> message tree. Magic, length and crc32 are
    verified before a byte of JSON is parsed."""
    if len(data) < _HEADER.size:
        raise WireFrameError(f"frame truncated at {len(data)} bytes (header is {_HEADER.size})",
                             reason="truncated", nbytes=len(data))
    magic, plen, crc = _HEADER.unpack_from(data)
    if magic != _MAGIC:
        raise WireFrameError(f"bad frame magic {magic!r}", reason="bad_magic", nbytes=len(data))
    if plen > MAX_FRAME_BYTES:
        raise WireFrameError(f"frame length {plen} exceeds {MAX_FRAME_BYTES}: a desynced or corrupt stream",
                             reason="length", nbytes=len(data))
    payload = data[_HEADER.size:]
    if len(payload) != plen:
        raise WireFrameError(f"frame payload truncated: {len(payload)} of {plen} bytes",
                             reason="truncated", nbytes=len(data))
    if zlib.crc32(payload) != crc:
        raise WireFrameError("frame checksum mismatch: rejected before decode", reason="checksum", nbytes=len(data))
    (jlen,) = _JLEN.unpack_from(payload)
    if _JLEN.size + jlen > plen:
        raise WireFrameError(f"frame JSON head overruns the payload ({jlen} bytes declared)",
                             reason="length", nbytes=len(data))
    head = json.loads(payload[_JLEN.size:_JLEN.size + jlen])
    blobs: tp.List[np.ndarray] = []
    off = _JLEN.size + jlen
    for desc in head.get("blobs", ()):
        dt = np.dtype(desc["dtype"])
        shape = tuple(int(s) for s in desc["shape"])
        count = int(np.prod(shape)) if shape else 1
        end = off + count * dt.itemsize
        if end > plen:
            raise WireFrameError("frame blob section truncated", reason="truncated", nbytes=len(data))
        # copy(): frombuffer views are read-only, and a landed entry may be
        # written later (SpillTier.corrupt_one)
        blobs.append(np.frombuffer(payload, dt, count, off).reshape(shape).copy())
        off = end
    return _unpack_tree(head["tree"], blobs)


def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    """Read exactly n bytes. EOF before the header's first byte is a clean
    peer close (ConnectionError); EOF mid-read is a truncated frame."""
    chunks: tp.List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0 and what == "header":
                raise ConnectionError("peer closed the connection")
            raise WireFrameError(f"connection closed mid-{what}: {got} of {n} bytes", reason="truncated", nbytes=got)
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame_bytes(sock: socket.socket) -> bytes:
    """One raw frame off the socket (the header checked enough to size the
    read; `decode_frame` verifies the rest)."""
    head = _recv_exact(sock, _HEADER.size, "header")
    magic, plen, _ = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise WireFrameError(f"bad frame magic {magic!r}", reason="bad_magic", nbytes=len(head))
    if plen > MAX_FRAME_BYTES:
        raise WireFrameError(f"frame length {plen} exceeds {MAX_FRAME_BYTES}", reason="length", nbytes=len(head))
    return head + _recv_exact(sock, plen, "payload")


def read_frame(sock: socket.socket) -> tp.Any:
    return decode_frame(read_frame_bytes(sock))


def write_frame(sock: socket.socket, obj: tp.Any) -> int:
    data = encode_frame(obj)
    sock.sendall(data)
    return len(data)


# -- launch accounting (the counterpart of JAX's compile counts) -------------------


def process_launch_counts() -> tp.Dict[str, tp.Any]:
    """This process's kernel launches, {counter name: [[variant, n], ...]}
    (a tuple variant as a list), and its CUDA-graph captures by kind, in the
    codec's tree shape. A worker answers its `stats` RPC with it; a router
    process snapshots it to show it launched nothing."""
    from midgpt_tpu_torch.kernels import attention_template, flash_attention
    from midgpt_tpu_torch.sampling import graphs

    counters = (attention_template.LAUNCHES, attention_template.MERGE_LAUNCHES, flash_attention.FWD_LAUNCHES,
                flash_attention.BWD_DQ_LAUNCHES, flash_attention.BWD_DKV_LAUNCHES)
    return {
        "launches": {
            c.name: [[list(v) if isinstance(v, tuple) else v, int(n)]
                     for v, n in sorted(c.by_variant.items(), key=repr)]
            for c in counters
        },
        "captures": {k: int(n) for k, n in sorted(graphs.PROCESS_CAPTURES.items())},
    }


def launches_from_wire(counts: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Counter]:
    """`process_launch_counts()["launches"]` -> {counter name: Counter over
    variants}, list variants back to tuples (the LaunchCounter's keys)."""
    return {
        name: collections.Counter({tuple(v) if isinstance(v, list) else v: n for v, n in pairs})
        for name, pairs in counts.items()
    }


# -- router-side transport -----------------------------------------------------------


class ReplicaTransport:
    """One worker's socket endpoint: framed request/response RPCs with
    per-call deadlines, bounded reconnect and retry on the shared backoff
    schedule, a wire heartbeat, and the wire-level chaos hooks (module
    docstring)."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        rpc_deadline_s: float = 120.0,
        call_retries: int = 3,
        retry_base_s: float = 0.05,
        clock: tp.Callable[[], float] = time.perf_counter,
        sleep: tp.Callable[[float], None] = time.sleep,
        obs=None,
        obs_tid: str = "transport",
    ):
        if call_retries < 1:
            raise ValueError(f"call_retries must be >= 1, got {call_retries}")
        self.host = host
        self.port = port
        self.rpc_deadline_s = rpc_deadline_s
        self.call_retries = call_retries
        self.retry_base_s = retry_base_s
        self._clock = clock
        self._sleep = sleep
        self._sock: tp.Optional[socket.socket] = None
        self._seq = 0
        # the wire heartbeat: injected-clock stamp of the last successful RPC
        self.last_ok: tp.Optional[float] = None
        self.rpc_count = 0
        self.wire_bytes = 0
        self.connects = 0
        self.retries = 0
        self.corrupt_frames = 0
        self.deadline_expiries = 0
        self.forced_drops = 0
        self._lat_s: tp.List[float] = []
        # chaos arms (wire_corrupt / wire_stall)
        self._corrupt_next = False
        self._stall_next = False
        self._obs = obs
        self._obs_tid = obs_tid
        self._h_rpc = None if obs is None else obs.metrics.histogram(
            "transport_rpc_s", "round-trip latency per fleet-transport RPC")

    # -- connection lifecycle ----------------------------------------------------

    def _ensure_conn(self, rpc: str, deadline_s: float) -> socket.socket:
        if self._sock is not None:
            return self._sock
        try:
            sock = socket.create_connection((self.host, self.port), timeout=deadline_s)
        except OSError as e:
            raise TransportError(f"connect to {self.host}:{self.port} failed for rpc {rpc!r}: {e}",
                                 host=self.host, port=self.port, rpc=rpc, deadline_s=deadline_s) from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self.connects += 1
        return sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
            self._sock = None

    def close(self) -> None:
        self._drop_sock()

    @property
    def reconnects(self) -> int:
        return max(self.connects - 1, 0)

    # -- chaos hooks (robustness/faults.py kinds) ----------------------------------

    def drop_conn(self) -> None:
        """`conn_drop`: close the live connection; the next RPC reconnects
        (counted in `reconnects`)."""
        self.forced_drops += 1
        self._drop_sock()

    def arm_wire_corrupt(self) -> None:
        """`wire_corrupt`: flip a byte of the NEXT received frame before it
        is verified; the checksum rejects it and the RPC retries on a fresh
        connection."""
        self._corrupt_next = True

    def arm_wire_stall(self) -> None:
        """`wire_stall`: the NEXT RPC's response misses its deadline (the
        request is sent, the read abandoned and the connection dropped, as a
        deadline expiry leaves it)."""
        self._stall_next = True

    # -- the RPC ---------------------------------------------------------------------

    def call(self, op: str, payload: tp.Optional[tp.Dict[str, tp.Any]] = None, *,
             deadline_s: tp.Optional[float] = None, retries: tp.Optional[int] = None) -> tp.Dict[str, tp.Any]:
        """One request/response RPC. Transport failures retry on the shared
        backoff schedule; the `seq` given here stays the same across those
        retries, so side-effecting verbs dedup in the worker. A spent budget
        raises `ReplicaGoneError`."""
        dl = self.rpc_deadline_s if deadline_s is None else deadline_s
        budget = self.call_retries if retries is None else retries
        self._seq += 1
        seq = self._seq
        self.rpc_count += 1
        t_start = self._clock()

        def attempt() -> tp.Dict[str, tp.Any]:
            sock = self._ensure_conn(op, dl)
            sock.settimeout(dl)
            req = dict(payload or {})
            req["op"] = op
            req["seq"] = seq
            try:
                self.wire_bytes += write_frame(sock, req)
                if self._stall_next:
                    self._stall_next = False
                    self.deadline_expiries += 1
                    self._drop_sock()
                    raise TransportError(f"rpc {op!r} response did not land within {dl}s (wire stall)",
                                         host=self.host, port=self.port, rpc=op, deadline_s=dl)
                raw = read_frame_bytes(sock)
            except socket.timeout as e:
                self.deadline_expiries += 1
                self._drop_sock()
                raise TransportError(f"rpc {op!r} exceeded its {dl}s deadline",
                                     host=self.host, port=self.port, rpc=op, deadline_s=dl) from e
            except WireFrameError:
                self.corrupt_frames += 1
                self._drop_sock()
                raise
            except OSError as e:
                self._drop_sock()
                raise TransportError(f"rpc {op!r} transport failure: {e}",
                                     host=self.host, port=self.port, rpc=op, deadline_s=dl) from e
            self.wire_bytes += len(raw)
            if self._corrupt_next:
                self._corrupt_next = False
                flipped = bytearray(raw)
                flipped[-1] ^= 0xFF
                raw = bytes(flipped)
            try:
                return decode_frame(raw)
            except WireFrameError:
                # rejected after a full read: the stream itself is suspect
                self.corrupt_frames += 1
                self._drop_sock()
                raise

        def on_backoff(delay: float) -> None:
            self.retries += 1
            self._sleep(delay)

        try:
            reply = retry_with_backoff(attempt, retries=budget, base_s=self.retry_base_s,
                                       retry_on=(TransportError, WireFrameError), sleep=on_backoff)
        except (TransportError, WireFrameError) as e:
            raise ReplicaGoneError(f"replica {self.host}:{self.port} unreachable after {budget} attempt(s) on rpc "
                                   f"{op!r}: {e}", host=self.host, port=self.port, rpc=op, attempts=budget) from e
        now = self._clock()
        self.last_ok = now
        self._lat_s.append(now - t_start)
        if self._h_rpc is not None:
            self._h_rpc.observe(now - t_start)
            self._obs.tracer.complete(f"transport.{op}", "rpc", self._obs_tid, t_start, now - t_start)
        return reply

    # -- heartbeat and reporting -----------------------------------------------------

    def heartbeat_age(self, now: float) -> tp.Optional[float]:
        """Seconds since the last successful RPC on the injected clock (None
        before the first)."""
        return None if self.last_ok is None else now - self.last_ok

    def _lat_pct(self, q: float) -> float:
        if not self._lat_s:
            return 0.0
        return float(np.percentile(np.asarray(self._lat_s), q))

    def stats(self) -> tp.Dict[str, tp.Any]:
        return {
            "rpc_count": self.rpc_count,
            "wire_bytes": self.wire_bytes,
            "connects": self.connects,
            "reconnects": self.reconnects,
            "retries": self.retries,
            "corrupt_frames": self.corrupt_frames,
            "deadline_expiries": self.deadline_expiries,
            "forced_drops": self.forced_drops,
            "rpc_p50_ms": round(self._lat_pct(50) * 1e3, 3),
            "rpc_p95_ms": round(self._lat_pct(95) * 1e3, 3),
        }


# -- router-side replica proxy --------------------------------------------------------


def _item_to_wire(it) -> tp.Dict[str, tp.Any]:
    return {"key": list(it.key), "blocks": it.blocks, "checksum": it.checksum, "weights_version": it.weights_version}


def _item_from_wire(d: tp.Mapping[str, tp.Any]):
    from midgpt_tpu_torch.sampling.fleet import SpillTransferItem

    return SpillTransferItem(key=tuple(int(t) for t in d["key"]),
                             blocks={k: np.asarray(v) for k, v in d["blocks"].items()},
                             checksum=int(d["checksum"]), weights_version=str(d["weights_version"]))


class ProcReplica:
    """FleetRouter-facing proxy for one worker process: the engine surface
    the router drives (submit / step / idle / finished / counters), so
    `FleetRouter([ProcReplica(...), ...])` is the in-process fleet with the
    object boundary made a process boundary.

    `step()` is one worker engine round plus a harvest: the worker's token
    events replay through the router's `on_token` relay and its finishes
    land in `finished`, both under high-water marks so a retried RPC
    duplicates neither. RPC failures propagate as exceptions, which the
    router's consecutive-failure health check counts: kill -9 detection is
    that health check, fed by the wire."""

    is_proc = True

    def __init__(self, transport: ReplicaTransport):
        self.transport = transport
        hello = transport.call("hello")
        self.pid = int(hello["pid"])
        self.page_size = int(hello["page_size"])
        self.max_pages_per_slot = int(hello.get("max_pages_per_slot", 0))
        self.temperature = float(hello.get("temperature", 0.0))
        self.weights_version = str(hello.get("weights_version", "inline"))
        self.device = str(hello.get("device", ""))
        self.cache_dtype = str(hello.get("cache_dtype", ""))
        # the worker's wall-clock time when it announced its port
        self.announced_at = hello.get("announced_at")
        # a truthy sentinel iff the worker's engine runs its prefix trie (the
        # router checks `prefix_cache is None`, never dereferences it)
        self.prefix_cache = True if hello.get("prefix_cache") else None
        self.on_token: tp.Optional[tp.Callable[[int, int, float], None]] = None
        self.finished: tp.Dict[int, tp.Any] = {}
        self._idle = True
        self._events_seen = 0
        # counters mirrored from the worker at every harvest (the router's
        # stats and the chaos summaries read these names off engines)
        self.rounds = 0
        self.preemptions = 0
        self.shed = 0
        self.timeouts = 0
        self.cancelled = 0
        self.decode_kills = 0
        self.prefix_evictions = 0
        self.spill_readopted_pages = 0
        self.decode_steps = 0
        self._prefix_matched_tokens = 0
        self._prefix_matchable_tokens = 0
        self._hit_rate = 0.0
        self._spill_ledger: tp.Dict[str, int] = {}

    # -- the engine surface the router drives ------------------------------------

    def attach_spill(self, tier) -> None:
        """The worker owns its own tier (host RAM is per process); the
        router's tier only binds page_size here, so replicas keep agreeing
        on the spill granule."""
        tier.set_page_size(self.page_size)

    def submit(self, prompt, max_new_tokens: int, eos_id: tp.Optional[int] = None,
               ttl_s: tp.Optional[float] = None) -> int:
        reply = self.transport.call("submit", {
            "prompt": np.asarray(prompt, np.int32).reshape(-1),
            "max_new_tokens": int(max_new_tokens),
            "eos_id": None if eos_id is None else int(eos_id),
            "ttl_s": None if ttl_s is None else float(ttl_s),
        })
        if reply.get("error") == "backpressure":
            from midgpt_tpu_torch.sampling.serve import BackpressureError

            raise BackpressureError(
                str(reply.get("message", "replica shed the request")),
                needed_pages=reply.get("needed_pages"),
                backlog_pages=reply.get("backlog_pages"),
                budget_pages=reply.get("budget_pages"),
                retryable=bool(reply.get("retryable", False)),
            )
        self._raise_remote(reply, "submit")
        self._idle = False
        return int(reply["uid"])

    @property
    def idle(self) -> bool:
        return self._idle

    def step(self) -> None:
        reply = self.transport.call("step")
        self._raise_remote(reply, "step")
        self._apply_counters(reply)
        self._harvest()

    def run(self) -> tp.Dict[int, tp.Any]:
        """Drive the worker to idle and return `finished` (ServeEngine.run's
        shape), for warm-ups and reference passes outside a FleetRouter."""
        r = 0
        while not self.idle:
            self.step()
            r += 1
            if r >= 100_000:
                raise RuntimeError("proc replica run() did not converge")
        return self.finished

    def _harvest(self) -> None:
        reply = self.transport.call("harvest", {"events_from": self._events_seen, "known_uids": list(self.finished)})
        self._raise_remote(reply, "harvest")
        for ruid, tok, t in reply.get("events", ()):
            self._events_seen += 1
            if self.on_token is not None:
                self.on_token(int(ruid), int(tok), float(t))
        if reply.get("finished"):
            from midgpt_tpu_torch.sampling.serve import FinishedRequest

            for fin in reply["finished"]:
                uid = int(fin["uid"])
                self.finished[uid] = FinishedRequest(uid, np.asarray(fin["tokens"]),
                                                     [float(t) for t in fin.get("token_times", ())],
                                                     str(fin["status"]))
        self._apply_counters(reply)

    def _apply_counters(self, reply: tp.Dict[str, tp.Any]) -> None:
        if "idle" in reply:
            self._idle = bool(reply["idle"])
        c = reply.get("counters")
        if not c:
            return
        for name in ("rounds", "preemptions", "shed", "timeouts", "cancelled", "decode_kills", "prefix_evictions",
                     "spill_readopted_pages", "decode_steps"):
            setattr(self, name, int(c.get(name, getattr(self, name))))
        self._prefix_matched_tokens = int(c.get("prefix_matched", self._prefix_matched_tokens))
        self._prefix_matchable_tokens = int(c.get("prefix_matchable", self._prefix_matchable_tokens))
        self._hit_rate = float(c.get("hit_rate", self._hit_rate))
        if "spill_ledger" in c:
            self._spill_ledger = dict(c["spill_ledger"])

    def prefix_stats(self) -> tp.Dict[str, float]:
        return {"hit_rate": self._hit_rate}

    def _raise_remote(self, reply: tp.Dict[str, tp.Any], op: str) -> None:
        if reply.get("error"):
            raise RuntimeError(f"worker pid {self.pid} rpc {op!r} failed remotely: "
                               f"{reply.get('message', reply['error'])}")

    # -- conservation across the boundary ------------------------------------------

    def assert_conserved(self, where: str = "") -> None:
        """Run the engine's pool law and the worker tier's ledger check IN
        the worker (the pool lives there); a violation surfaces as the
        AssertionError the in-process path raises."""
        reply = self.transport.call("conserve", {"where": where})
        if not reply.get("ok"):
            raise AssertionError(f"worker pid {self.pid} conservation failed {where}: "
                                 f"{reply.get('error', 'unknown')}")
        self._spill_ledger = dict(reply.get("spill_ledger", {}))

    def spill_ledger(self) -> tp.Dict[str, int]:
        return dict(self._spill_ledger)

    # -- spill-page transfer -----------------------------------------------------------

    def export_spill(self) -> list:
        """Every resident spilled page out of the worker's tier (its
        `transferred` bucket), as `SpillTransferItem`s; typically after a
        drain, so survivors can re-adopt KV the drained worker prefilled."""
        reply = self.transport.call("spill_export")
        self._raise_remote(reply, "spill_export")
        return [_item_from_wire(d) for d in reply.get("items", ())]

    def import_spill(self, items: tp.Sequence[tp.Any]) -> int:
        reply = self.transport.call("spill_import", {"items": [_item_to_wire(it) for it in items]})
        self._raise_remote(reply, "spill_import")
        return int(reply.get("imported", 0))

    # -- lifecycle and chaos --------------------------------------------------------------

    def drain(self) -> tp.Dict[str, tp.Any]:
        """Graceful drain: the worker stops admitting (non-retryable
        backpressure), keeps serving step and harvest until its streams
        finish, and exits once idle after the router disconnects (the
        SIGTERM path, driven explicitly)."""
        return self.transport.call("drain")

    def kill9(self) -> None:
        """`proc_kill9`: SIGKILL the worker (no drain, no goodbye).
        Detection and failover come from the health checks riding the wire."""
        os.kill(self.pid, signal.SIGKILL)

    def drop_conn(self) -> None:
        self.transport.drop_conn()

    def arm_wire_corrupt(self) -> None:
        self.transport.arm_wire_corrupt()

    def arm_wire_stall(self) -> None:
        self.transport.arm_wire_stall()

    def flush_prefix_cache(self) -> int:
        """The worker's operator flush (`ServeEngine.flush_prefix_cache`):
        every unreferenced trie page spills to its tier. Returns the pages
        freed."""
        reply = self.transport.call("evict_prefix")
        self._raise_remote(reply, "evict_prefix")
        return int(reply.get("freed", 0))

    def stats(self) -> tp.Dict[str, tp.Any]:
        reply = self.transport.call("stats")
        self._raise_remote(reply, "stats")
        out = dict(reply.get("stats", {}))
        out["spill"] = reply.get("spill", {})
        out["launch_counts"] = reply.get("launch_counts", {})
        out["transport"] = self.transport.stats()
        return out

    def launch_counts(self) -> tp.Dict[str, tp.Any]:
        """The worker process's kernel launches ({counter name: Counter over
        variants}) and CUDA-graph captures by kind, over the `stats` RPC: the
        counterpart of JAX's `compile_counts`."""
        reply = self.transport.call("stats")
        self._raise_remote(reply, "stats")
        counts = reply.get("launch_counts", {})
        return {"launches": launches_from_wire(counts.get("launches", {})), "captures": dict(counts.get("captures", {}))}

    def close(self, kill: bool = False) -> None:
        with contextlib.suppress(ReplicaGoneError, OSError):
            self.transport.call("bye", retries=1, deadline_s=5.0)
        self.transport.close()
        if kill:
            with contextlib.suppress(OSError):
                os.kill(self.pid, signal.SIGKILL)

    def on_router_crash(self) -> None:
        """FleetRouter._crash hook: a replica the health checks declared dead
        has its transport torn down and its process SIGKILLed, so a
        half-alive worker cannot go on serving a router that already failed
        its streams over."""
        self.transport.close()
        with contextlib.suppress(OSError):
            os.kill(self.pid, signal.SIGKILL)


# -- worker side ------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def parent_torch_config() -> tp.Dict[str, tp.Any]:
    """The numeric knobs of this process that a worker must share for greedy
    parity across the boundary (the counterpart of JAX's
    `parent_jax_config`): f32 matmul precision and the TF32 switches."""
    return {
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "cuda_matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
    }


def apply_torch_config(knobs: tp.Mapping[str, tp.Any]) -> None:
    """Set `parent_torch_config()`'s knobs in this process."""
    if "float32_matmul_precision" in knobs:
        torch.set_float32_matmul_precision(knobs["float32_matmul_precision"])
    if "cuda_matmul_allow_tf32" in knobs:
        torch.backends.cuda.matmul.allow_tf32 = bool(knobs["cuda_matmul_allow_tf32"])
    if "cudnn_allow_tf32" in knobs:
        torch.backends.cudnn.allow_tf32 = bool(knobs["cudnn_allow_tf32"])


def build_worker_engine(spec: tp.Mapping[str, tp.Any]):
    """Spec -> (ServeEngine, SpillTier): greedy, prefix-cached, the spec's
    pool dtype, its own tier attached. The weights are `GPT.init` at the
    spec's seed in `param_dtype` (default float32), so same-seed workers on
    one device hold the same weights; `params_npz` loads a parameter file
    (convert.load_npz) instead. The device goes through `resolve_device`:
    CUDA unless the spec says "cpu", and no fallback."""
    from midgpt_tpu_torch.convert import load_npz
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.models.gpt import GPT, GPTConfig
    from midgpt_tpu_torch.sampling.fleet import SpillTier
    from midgpt_tpu_torch.sampling.serve import ServeEngine

    dev = resolve_device(spec.get("device"))
    cfg = GPTConfig(**spec["model"])
    dtype = _DTYPES[spec.get("param_dtype", "float32")]
    if spec.get("params_npz"):
        params = load_npz(spec["params_npz"], config=cfg, device=dev, dtype=dtype)
    else:
        params = GPT.init(cfg, int(spec.get("seed", 0)), device=dev, dtype=dtype)
    kw = dict(spec.get("engine", {}))
    cache_dtype = _DTYPES[kw.pop("cache_dtype", "float32")]
    eng = ServeEngine(cfg, params, temperature=0.0, prefix_cache=True, cache_dtype=cache_dtype, device=dev, **kw)
    tier = SpillTier()
    eng.attach_spill(tier)
    return eng, tier


def _jsonable(obj: tp.Any) -> tp.Any:
    """An engine's stats() tree in the codec's shape: numpy scalars to
    Python, anything else that is not plain data to its text. A tensor is
    refused: it must be read as a number where it is produced."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, torch.Tensor):
        raise TypeError(f"a torch.Tensor in a worker reply ({tuple(obj.shape)} {obj.dtype}): convert it at the source")
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


class _WorkerState:
    """Everything one worker process serves RPCs against."""

    def __init__(self, eng, tier, announced_at: tp.Optional[float] = None):
        self.eng = eng
        self.tier = tier
        self.announced_at = announced_at
        self.events: tp.List[tp.Tuple[int, int, float]] = []
        self.submit_replies: tp.Dict[int, tp.Dict[str, tp.Any]] = {}
        self.draining = False
        eng.on_token = self._on_token

    def _on_token(self, uid: int, tok: int, t: float) -> None:
        self.events.append((int(uid), int(tok), float(t)))

    def counters(self) -> tp.Dict[str, tp.Any]:
        eng = self.eng
        return {
            "rounds": int(eng.rounds),
            "preemptions": int(eng.preemptions),
            "shed": int(eng.shed),
            "timeouts": int(eng.timeouts),
            "cancelled": int(eng.cancelled),
            "decode_kills": int(eng.decode_kills),
            "prefix_evictions": int(eng.prefix_evictions),
            "spill_readopted_pages": int(eng.spill_readopted_pages),
            "decode_steps": int(eng.decode_steps),
            "prefix_matched": int(eng._prefix_matched_tokens),
            "prefix_matchable": int(eng._prefix_matchable_tokens),
            "hit_rate": float(eng.prefix_stats()["hit_rate"]),
            "spill_ledger": self.tier.ledger(),
        }

    def handle(self, req: tp.Dict[str, tp.Any]) -> tp.Dict[str, tp.Any]:
        op = req.get("op", "")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            return {"error": "exception", "message": f"unknown op {op!r}"}
        try:
            return fn(req)
        except Exception as e:  # a structured remote error, never a hang
            return {"error": "exception", "message": f"{type(e).__name__}: {e}"}

    # -- verbs -------------------------------------------------------------------------

    def _op_hello(self, req) -> tp.Dict[str, tp.Any]:
        eng = self.eng
        return {
            "pid": os.getpid(),
            "page_size": eng.page_size,
            "max_pages_per_slot": eng.max_pages_per_slot,
            "temperature": eng.temperature,
            "prefix_cache": eng.prefix_cache is not None,
            "weights_version": eng.weights_version,
            "device": str(eng.device),
            "cache_dtype": str(eng.cache_dtype).replace("torch.", ""),
            "announced_at": self.announced_at,
        }

    def _op_submit(self, req) -> tp.Dict[str, tp.Any]:
        from midgpt_tpu_torch.sampling.serve import BackpressureError

        seq = req.get("seq")
        if seq in self.submit_replies:  # a retried RPC: never admit twice
            return self.submit_replies[seq]
        if self.draining:
            reply: tp.Dict[str, tp.Any] = {
                "error": "backpressure", "message": "worker is draining (SIGTERM): not admitting",
                "needed_pages": None, "backlog_pages": None, "budget_pages": None, "retryable": False,
            }
        else:
            try:
                uid = self.eng.submit(np.asarray(req["prompt"], np.int32), int(req["max_new_tokens"]),
                                      req.get("eos_id"), ttl_s=req.get("ttl_s"))
                reply = {"uid": int(uid), "idle": self.eng.idle}
            except BackpressureError as e:
                reply = {
                    "error": "backpressure", "message": str(e), "needed_pages": e.needed_pages,
                    "backlog_pages": e.backlog_pages, "budget_pages": e.budget_pages, "retryable": e.retryable,
                }
        self.submit_replies[seq] = reply
        return reply

    def _op_step(self, req) -> tp.Dict[str, tp.Any]:
        if not self.eng.idle:
            self.eng.step()
        return {"idle": self.eng.idle, "counters": self.counters()}

    def _op_harvest(self, req) -> tp.Dict[str, tp.Any]:
        known = set(req.get("known_uids", ()))
        fins = [
            {"uid": int(uid), "tokens": np.asarray(fr.tokens), "token_times": [float(t) for t in fr.token_times],
             "status": fr.status}
            for uid, fr in self.eng.finished.items() if uid not in known
        ]
        start = int(req.get("events_from", 0))
        return {"events": [list(e) for e in self.events[start:]], "finished": fins, "idle": self.eng.idle,
                "counters": self.counters()}

    def _op_stats(self, req) -> tp.Dict[str, tp.Any]:
        return {
            "stats": _jsonable(self.eng.stats()),
            "spill": self.tier.stats(),
            "launch_counts": process_launch_counts(),
            "counters": self.counters(),
        }

    def _op_conserve(self, req) -> tp.Dict[str, tp.Any]:
        from midgpt_tpu_torch.sampling import ops

        where = str(req.get("where", ""))
        try:
            ops.assert_conserved(self.eng, where)
            self.tier.assert_ledger(where)
        except AssertionError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "spill_ledger": self.tier.ledger()}

    def _op_spill_export(self, req) -> tp.Dict[str, tp.Any]:
        return {"items": [_item_to_wire(it) for it in self.tier.export_entries()]}

    def _op_spill_import(self, req) -> tp.Dict[str, tp.Any]:
        return {"imported": self.tier.import_entries([_item_from_wire(d) for d in req.get("items", ())])}

    def _op_evict_prefix(self, req) -> tp.Dict[str, tp.Any]:
        freed = self.eng.flush_prefix_cache()
        return {"freed": int(freed), "idle": self.eng.idle}

    def _op_drain(self, req) -> tp.Dict[str, tp.Any]:
        self.draining = True
        return {"draining": True, "idle": self.eng.idle}

    def _op_bye(self, req) -> tp.Dict[str, tp.Any]:
        return {"bye": True}


def run_worker(spec: tp.Mapping[str, tp.Any], *, port: int = 0,
               announce: tp.Optional[tp.Callable[[int], None]] = None) -> None:
    """The worker process's main loop (sampling/fleet_worker.py calls it
    once the spec's torch knobs are set). Builds the engine, loads its
    kernel libraries on CUDA (so no build lands inside an RPC's deadline),
    binds, announces the port, then serves one router connection at a time.
    SIGTERM goes through the preemption flag (the handler only sets it); the
    loop sees it between RPCs, stops admitting, and exits once drained and
    disconnected. It also exits when its parent process is gone."""
    from midgpt_tpu_torch.robustness import preempt

    eng, tier = build_worker_engine(spec)
    if eng.device.type == "cuda":
        from midgpt_tpu_torch.kernels import build

        build.load("paged_attention")
    preempt.install_handlers()
    parent = os.getppid()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(1)
    srv.settimeout(0.25)
    state = _WorkerState(eng, tier, announced_at=time.time())
    if announce is not None:
        announce(srv.getsockname()[1])
    try:
        while True:
            if preempt.requested():
                state.draining = True
            if state.draining and eng.idle:
                return
            if os.getppid() != parent:
                return  # orphaned: the router process is gone
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            with conn:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(None)
                saw_bye = _serve_conn(conn, state, preempt)
            if saw_bye and state.draining and eng.idle:
                return
    finally:
        srv.close()


def _serve_conn(conn: socket.socket, state: _WorkerState, preempt) -> bool:
    """Serve frames on one connection until the peer disconnects or says
    bye. A corrupt inbound frame drops the connection (the router's
    transport retries on a fresh one). True on an explicit bye."""
    while True:
        if preempt.requested():
            state.draining = True
        try:
            req = read_frame(conn)
        except (ConnectionError, OSError, WireFrameError):
            return False
        reply = state.handle(req)
        reply["seq"] = req.get("seq")
        try:
            write_frame(conn, reply)
        except (OSError, ConnectionError):
            return False
        if req.get("op") == "bye":
            return True


# -- spawning -------------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent.parent.parent  # the directory holding midgpt_tpu_torch/
WORKER_MODULE = "midgpt_tpu_torch.sampling.fleet_worker"


def worker_command(spec: tp.Mapping[str, tp.Any]) -> tp.List[str]:
    """The worker's argv: a fresh interpreter running the worker module."""
    return [sys.executable, "-m", WORKER_MODULE, "--spec-json", json.dumps(spec)]


def _popen_worker(spec: tp.Mapping[str, tp.Any], argv: tp.Optional[tp.List[str]] = None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(argv or worker_command(spec), stdout=subprocess.PIPE, env=env, text=True)
    proc.spawned_at = time.time()  # beside the worker's announced_at (hello)
    return proc


def spawn_worker(spec: tp.Mapping[str, tp.Any]) -> tp.Tuple[tp.Any, int]:
    """Popen a worker with `spec` and block until it announces its port on
    stdout ("PORT <n>"); returns (Popen, port). Its stderr passes through,
    so a worker's traceback lands in the caller's log and never on the
    caller's one-line JSON stdout."""
    proc = _popen_worker(spec)
    return proc, _await_port(proc)


def spawn_workers(specs: tp.Union[tp.Mapping[str, tp.Any], tp.Sequence[tp.Mapping[str, tp.Any]]],
                  n: tp.Optional[int] = None) -> tp.List[tp.Tuple[tp.Any, int]]:
    """Spawn `n` workers of one spec (JAX's signature) or one worker per
    spec of a list, CONCURRENTLY: every Popen first, then the port
    announcements, so the startups (torch import, engine build, kernel
    libraries) overlap."""
    if isinstance(specs, tp.Mapping):
        specs = [specs] * (1 if n is None else n)
    procs = [_popen_worker(s) for s in specs]
    try:
        return [(p, _await_port(p)) for p in procs]
    except BaseException:
        kill_workers(procs)
        raise


def _await_port(proc) -> int:
    while True:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"fleet worker exited (rc={proc.poll()}) before announcing its port")
        if line.startswith("PORT "):
            return int(line.split()[1])


def kill_workers(procs: tp.Iterable[tp.Any]) -> None:
    """SIGKILL and reap every worker (a Popen, or a (Popen, port) pair)."""
    for p in procs:
        proc = p[0] if isinstance(p, tuple) else p
        with contextlib.suppress(OSError, subprocess.TimeoutExpired):
            proc.kill()
            proc.wait(timeout=10)
        if proc.stdout is not None:
            proc.stdout.close()


def connect_replica(port: int, **transport_kw) -> ProcReplica:
    return ProcReplica(ReplicaTransport("127.0.0.1", port, **transport_kw))
