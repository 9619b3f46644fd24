"""Port parity, the worker-process fleet (sampling/fleet_proc.py and the
worker module sampling/fleet_worker.py), against JAX's
midgpt_tpu/sampling/fleet_proc.py.

* The frame codec: the port's frames equal JAX's byte for byte for the same
  numpy trees, each package decodes the other's, and a bad frame raises the
  same `reason` in both; a torch.Tensor never reaches the wire.
* The error contracts' fields, as JAX's test has them.
* ReplicaTransport against an in-process mini peer, the port's and JAX's
  side by side on the same scripted peer: the deadline, the retry sleeps
  on an injected sleep, connect refused, the heartbeat on an injected
  clock, and recovery from a corrupt frame, a stall and a dropped
  connection give equal counters and errors.
* The router's side on duck-typed worker replicas: the four wire kinds
  fire on the same worker at the same rounds as in JAX's router, kill -9
  becomes one proc failover, and `transport_stats` rolls up as JAX's.
* The worker protocol in process: the port's `_WorkerState` over a CPU
  engine on JAX's tiny weights answers the same RPC sequence as JAX's over
  JAX's engine (events, finishes, counters), dedups a retried submit and
  refuses admission while draining.
* The spill-transfer ledger across a wire round trip, for both tiers.
* End to end on CPU workers (one torch thread each): the kill-9
  representative with JAX's asserts, and two workers on JAX's weights
  (`params_npz`) whose greedy fleet streams equal JAX's ServeEngine's.
* `-m slow`: conn_drop, wire_corrupt, wire_stall, the SIGTERM drain, spill
  between live workers, and `loadgen --procs --device cpu`.

A worker on the card is held to an in-process engine in
tests/test_torch_kernels_cuda.py (no JAX there, so it runs on the card).
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.analysis.bench_contract import check_serve_slo_bench
from midgpt_tpu.robustness import chaos_serve as j_chaos
from midgpt_tpu.robustness.backoff import backoff_delays as j_backoff_delays
from midgpt_tpu.sampling import fleet as j_fleet
from midgpt_tpu.sampling import fleet_proc as j_fp
from midgpt_tpu.sampling import serve as j_serve
from midgpt_tpu_torch import loadgen
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.robustness import chaos_serve, faults
from midgpt_tpu_torch.robustness.backoff import backoff_delays
from midgpt_tpu_torch.sampling import fleet, serve
from midgpt_tpu_torch.sampling import fleet_proc as fp

CPU = torch.device("cpu")
ENGINE = dict(max_slots=3, page_size=8, num_pages=31, prefill_chunk=16, decode_chunk=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one thread, and the suite's workers share
    the machine's cores (spawned CPU workers run one thread too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.clear()
    yield
    faults.clear()


# -- frame codec -------------------------------------------------------------------


def _trees():
    rng = np.random.default_rng(7)
    return {
        "f32": {"k": rng.standard_normal((2, 3, 4)).astype(np.float32)},
        "int8": {"v": np.arange(-8, 8, dtype=np.int8).reshape(4, 4), "k_scale": np.ones((2, 8), np.float32)},
        "uint16": {"blocks": {"k": rng.integers(0, 1 << 16, (2, 2, 8, 4), dtype=np.uint16)}},
        "int32": {"op": "submit", "prompt": np.array([5, 6, 7], np.int32), "max_new_tokens": 7, "eos_id": None,
                  "ttl_s": 2.5, "seq": 3},
        "0-d": {"scalar": np.array(3.5, np.float64), "count": np.array(4, np.int64)},
        "nested": {"events": [[1, 2, 0.5], [1, 3, 0.75]], "finished": [
            {"uid": 1, "tokens": np.arange(9, dtype=np.int32), "token_times": [0.1, 0.2], "status": "ok"}],
            "flag": True, "none": None, "deep": {"list": [1, [2, {"x": "y"}]]}},
        "numpy scalars": {"n": np.int64(7), "x": np.float32(0.25), "i": np.int32(-3), "items": (np.int16(2), 1.5)},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_frames_equal_jax_byte_for_byte(name):
    tree = _trees()[name]
    mine, theirs = fp.encode_frame(tree), j_fp.encode_frame(tree)
    assert mine == theirs
    for out in (fp.decode_frame(theirs), j_fp.decode_frame(mine)):
        assert json.dumps(j_fp._pack_tree(out, []), sort_keys=True) == json.dumps(
            j_fp._pack_tree(j_fp.decode_frame(theirs), []), sort_keys=True)
    out = fp.decode_frame(theirs)
    blobs_in, blobs_out = [], []
    j_fp._pack_tree(tree, blobs_in)
    j_fp._pack_tree(out, blobs_out)
    for a, b in zip(blobs_in, blobs_out):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert b.flags.writeable  # a landed page may be written (SpillTier.corrupt_one)


def _bad_frames():
    data = j_fp.encode_frame({"op": "step", "payload": list(range(64))})
    flipped = bytearray(data)
    flipped[-1] ^= 0xFF
    return {
        "short header": data[:3],
        "bad magic": b"XGW1" + data[4:],
        "short payload": data[:-2],
        "checksum": bytes(flipped),
        "length": j_fp._HEADER.pack(j_fp._MAGIC, j_fp.MAX_FRAME_BYTES + 1, 0),
    }


@pytest.mark.parametrize("case", list(_bad_frames()))
def test_bad_frames_raise_jax_reason(case):
    data = _bad_frames()[case]
    with pytest.raises(j_fp.WireFrameError) as want:
        j_fp.decode_frame(data)
    with pytest.raises(fp.WireFrameError) as got:
        fp.decode_frame(data)
    assert (got.value.reason, got.value.nbytes) == (want.value.reason, want.value.nbytes)
    assert got.value.reason in ("truncated", "bad_magic", "length", "checksum")


def test_a_tensor_never_reaches_the_wire():
    with pytest.raises(TypeError, match="torch.Tensor"):
        fp.encode_frame({"counters": {"rounds": torch.tensor(3)}})
    with pytest.raises(TypeError, match="torch.Tensor"):
        fp._jsonable({"decode_seconds": torch.tensor(0.5)})
    assert fp._jsonable({"n": np.int64(3), "d": {1: np.float32(0.5)}, "o": CPU}) == {"n": 3, "d": {"1": 0.5},
                                                                                    "o": "cpu"}


def test_error_contract_fields_are_present():
    te = fp.TransportError("x", host="h", port=9, rpc="step", deadline_s=1.5)
    assert (te.host, te.port, te.rpc, te.deadline_s) == ("h", 9, "step", 1.5)
    assert isinstance(te, ConnectionError)
    wf = fp.WireFrameError("x", reason="checksum", nbytes=12)
    assert (wf.reason, wf.nbytes) == ("checksum", 12)
    assert isinstance(wf, ValueError)
    rg = fp.ReplicaGoneError("x", host="h", port=9, rpc="harvest", attempts=3)
    assert (rg.host, rg.port, rg.rpc, rg.attempts) == ("h", 9, "harvest", 3)
    assert isinstance(rg, ConnectionError)
    for mine, theirs in ((fp.TransportError, j_fp.TransportError), (fp.WireFrameError, j_fp.WireFrameError),
                         (fp.ReplicaGoneError, j_fp.ReplicaGoneError)):
        assert mine.__bases__ == theirs.__bases__
        assert mine.__init__.__code__.co_varnames == theirs.__init__.__code__.co_varnames


def test_launch_counts_travel_the_wire():
    from midgpt_tpu_torch.kernels import attention_template as tpl
    from midgpt_tpu_torch.sampling import graphs

    counts = fp.process_launch_counts()
    assert set(counts["launches"]) == {"paged_attention", "paged_attention_merge", "flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv"}
    saved = tpl.LAUNCHES.by_variant.copy(), graphs.PROCESS_CAPTURES.copy()
    try:
        tpl.LAUNCHES.by_variant.update({("decode", 1): 5, ("int8-decode", 2): 2})
        graphs.PROCESS_CAPTURES["decode_group"] += 3
        wired = fp.decode_frame(fp.encode_frame(fp.process_launch_counts()))
        got = fp.launches_from_wire(wired["launches"])
        assert got["paged_attention"] == tpl.LAUNCHES.by_variant
        assert wired["captures"]["decode_group"] == graphs.PROCESS_CAPTURES["decode_group"]
    finally:
        tpl.LAUNCHES.by_variant.clear()
        tpl.LAUNCHES.by_variant.update(saved[0])
        graphs.PROCESS_CAPTURES.clear()
        graphs.PROCESS_CAPTURES.update(saved[1])


# -- the transport against a mini peer, the port's beside JAX's --------------------------------


class _MiniPeer(threading.Thread):
    """A frame-speaking peer thread: answers each request with {"ok": True,
    "seq": ...}; "mute" swallows requests, so the caller's deadline is the
    only way out."""

    def __init__(self, mode: str = "echo"):
        super().__init__(daemon=True)
        self.mode = mode
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.port = self.srv.getsockname()[1]
        self._halt = threading.Event()
        self.start()

    def run(self):
        self.srv.settimeout(0.05)
        while not self._halt.is_set():
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(0.05)
                while not self._halt.is_set():
                    try:
                        req = fp.read_frame(conn)
                    except socket.timeout:
                        continue
                    except (ConnectionError, OSError, fp.WireFrameError):
                        break
                    if self.mode == "mute":
                        continue
                    try:
                        fp.write_frame(conn, {"ok": True, "seq": req.get("seq")})
                    except (ConnectionError, OSError):
                        break

    def stop(self):
        self._halt.set()
        self.srv.close()
        self.join(timeout=2)


@pytest.fixture
def echo_peer():
    peer = _MiniPeer("echo")
    yield peer
    peer.stop()


@pytest.fixture
def mute_peer():
    peer = _MiniPeer("mute")
    yield peer
    peer.stop()


def _counters(t):
    s = t.stats()
    return {k: v for k, v in s.items() if not k.startswith("rpc_p")}


def _both(port, **kw):
    """The port's and JAX's transports to one peer, each with its own
    recorded sleeps."""
    out = []
    for mod in (fp, j_fp):
        slept = []
        out.append((mod.ReplicaTransport("127.0.0.1", port, sleep=slept.append, **kw), slept))
    return out


def test_deadline_expiry_escalates_to_replica_gone(mute_peer):
    seen = []
    for t, slept in _both(mute_peer.port, rpc_deadline_s=0.15, call_retries=2, retry_base_s=0.01):
        with pytest.raises(ConnectionError) as ei:
            t.call("ping")
        e = ei.value
        assert type(e).__name__ == "ReplicaGoneError" and e.attempts == 2 and e.rpc == "ping"
        assert (e.host, e.port) == ("127.0.0.1", mute_peer.port)
        assert type(e.__cause__).__name__ == "TransportError" and e.__cause__.deadline_s == 0.15
        seen.append((_counters(t), slept))
        t.close()
    assert seen[0] == seen[1]
    assert seen[0][0]["deadline_expiries"] == 2 and seen[0][0]["connects"] == 2 and seen[0][0]["reconnects"] == 1


def test_retry_sleeps_equal_jax(mute_peer):
    """The transport sleeps the shared backoff schedule between attempts,
    the same sleeps as JAX's for the same budget and base."""
    seen = []
    for t, slept in _both(mute_peer.port, rpc_deadline_s=0.1, call_retries=3, retry_base_s=0.07):
        with pytest.raises(ConnectionError):
            t.call("ping")
        seen.append((_counters(t), slept))
        t.close()
    assert seen[0] == seen[1]
    assert seen[0][1] == list(backoff_delays(3, 0.07)) == list(j_backoff_delays(3, 0.07))
    assert seen[0][0]["retries"] == 2


def test_connect_refused_is_replica_gone():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    seen = []
    for t, slept in _both(dead_port, call_retries=2, retry_base_s=0.0):
        with pytest.raises(ConnectionError) as ei:
            t.call("hello")
        assert type(ei.value).__name__ == "ReplicaGoneError" and ei.value.attempts == 2
        seen.append((_counters(t), slept))
    assert seen[0] == seen[1] and seen[0][0]["connects"] == 0


def test_heartbeat_tracks_injected_clock(echo_peer):
    for mod in (fp, j_fp):
        ticks = iter([10.0, 10.5, 20.0, 20.25])
        t = mod.ReplicaTransport("127.0.0.1", echo_peer.port, clock=lambda: next(ticks))
        assert t.heartbeat_age(99.0) is None
        t.call("ping")
        assert t.last_ok == 10.5 and t.heartbeat_age(12.5) == pytest.approx(2.0)
        t.call("ping")
        assert t.last_ok == 20.25 and t.heartbeat_age(20.25) == pytest.approx(0.0)
        assert t.stats()["rpc_p95_ms"] >= t.stats()["rpc_p50_ms"] > 0
        t.close()


@pytest.mark.parametrize("fault", ["wire_corrupt", "wire_stall", "conn_drop"])
def test_wire_fault_recovery_counters_equal_jax(echo_peer, fault):
    """The same scripted peer and faults: a ping, the fault, a ping that
    must recover, a ping after; both transports end with equal counters."""
    seen = []
    for t, slept in _both(echo_peer.port, call_retries=3, retry_base_s=0.0):
        assert t.call("ping")["ok"] is True
        {"wire_corrupt": t.arm_wire_corrupt, "wire_stall": t.arm_wire_stall, "conn_drop": t.drop_conn}[fault]()
        assert t.call("ping")["ok"] is True
        assert t.call("ping")["ok"] is True
        seen.append((_counters(t), slept))
        t.close()
    assert seen[0] == seen[1]
    c = seen[0][0]
    assert c["rpc_count"] == 3 and c["reconnects"] == 1
    want = {"wire_corrupt": ("corrupt_frames", 1), "wire_stall": ("deadline_expiries", 1),
            "conn_drop": ("forced_drops", 1)}[fault]
    assert c[want[0]] == want[1]
    assert c["retries"] == (0 if fault == "conn_drop" else 1)


# -- the router's side: the wire kinds and the transport rollup, against JAX's ---------------


class _FakeProc:
    """Just enough ProcReplica surface for a router: a bounded submit, a
    finish after two steps, a transport whose stats are fixed, and a
    record of the wire-fault calls; kill9 makes every later step raise."""

    is_proc = True

    def __init__(self, smod, i):
        self.smod = smod
        self.prefix_cache, self.temperature, self.page_size = True, 0.0, 8
        self.on_token, self.finished, self.active, self._uid, self.calls, self.dead = None, {}, {}, 0, [], False
        self.rounds = self.preemptions = self.shed = self.spill_readopted_pages = 0
        self._prefix_matched_tokens = self._prefix_matchable_tokens = 0
        stats = {"rpc_count": 10 + i, "wire_bytes": 1000 * (i + 1), "connects": 1 + i, "reconnects": i, "retries": i,
                 "corrupt_frames": 0, "deadline_expiries": i, "forced_drops": 0, "rpc_p50_ms": 0.5 + i,
                 "rpc_p95_ms": 9.0 - i}
        self.transport = type("T", (), {"stats": lambda self: dict(stats)})()

    def attach_spill(self, tier):
        tier.set_page_size(self.page_size)

    def prefix_stats(self):
        return {"hit_rate": 0.0}

    def submit(self, prompt, max_new_tokens, eos_id=None, ttl_s=None):
        uid, self._uid = self._uid, self._uid + 1
        self.active[uid] = [np.asarray(prompt, np.int32), int(max_new_tokens), 2]
        return uid

    @property
    def idle(self):
        return not self.active

    def step(self):
        if self.dead:
            raise ConnectionError("worker gone")
        for uid in [u for u, rec in self.active.items() if rec[2] <= 1]:
            prompt, m, _ = self.active.pop(uid)
            self.finished[uid] = self.smod.FinishedRequest(uid, prompt, [0.0] * m, "ok")
        for rec in self.active.values():
            rec[2] -= 1

    def kill9(self):
        self.calls.append("kill9")
        self.dead = True

    def drop_conn(self):
        self.calls.append("drop_conn")

    def arm_wire_corrupt(self):
        self.calls.append("arm_wire_corrupt")

    def arm_wire_stall(self):
        self.calls.append("arm_wire_stall")

    def on_router_crash(self):
        self.calls.append("on_router_crash")


def _router_wire_run(fmod, smod, fault_mod):
    fault_mod.clear()
    for spec in ("conn_drop@1", "wire_corrupt@1", "wire_stall@2", "proc_kill9@2"):
        fault_mod.activate_plan(spec)
    router = fmod.FleetRouter([_FakeProc(smod, i) for i in range(2)], max_consecutive_failures=2)
    rollup = router.transport_stats()
    uids = [router.submit(np.arange(t, t + 12, dtype=np.int32), 3) for t in (0, 0, 50)]
    done = router.run()
    fault_mod.clear()
    return (rollup, [e.calls for e in router.engines], router.crash_log, router.proc_failovers,
            router.failed_over_streams, sorted(done) == sorted(uids), router.stats()["transport"])


def test_router_wire_faults_and_transport_rollup_equal_jax():
    from midgpt_tpu.robustness import faults as j_faults

    got = _router_wire_run(fleet, serve, faults)
    assert got == _router_wire_run(j_fleet, j_serve, j_faults)
    rollup, calls, crash_log, proc_failovers, failed_over, all_done, _ = got
    assert rollup["rpc_count"] == 21 and rollup["rpc_p50_ms"] == 1.0 and rollup["rpc_p95_ms"] == 9.0
    assert sum(c.count("kill9") for c in calls) == 1 and proc_failovers == 1 and failed_over >= 1 and all_done
    assert crash_log[0]["reason"] == "consecutive_failures"


# -- the worker protocol in process, against JAX's --------------------------------------


def _flat(jp):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny chaos model at seed 0: (JAX params, the port's copy,
    {name: array} without the keystr dots)."""
    _, jp = j_chaos._tiny_model(0)
    flat = {k.lstrip("."): v for k, v in _flat(jp).items()}
    return jp, params_from_numpy(flat, device=CPU), flat


def _worker_states(tiny):
    jp, pp, _ = tiny
    j_eng = j_serve.ServeEngine(j_chaos._tiny_cfg(), jp, temperature=0.0, prefix_cache=True,
                                cache_dtype=jnp.float32, **ENGINE)
    j_tier = j_fleet.SpillTier()
    j_eng.attach_spill(j_tier)
    p_eng = serve.ServeEngine(chaos_serve._tiny_cfg(), pp, temperature=0.0, prefix_cache=True,
                              cache_dtype=torch.float32, device=CPU, **ENGINE)
    p_tier = fleet.SpillTier()
    p_eng.attach_spill(p_tier)
    return fp._WorkerState(p_eng, p_tier), j_fp._WorkerState(j_eng, j_tier)


def _strip_times(reply):
    """A reply without its token times, and without the port's one extra
    counter (`decode_steps`, which loadgen --procs and the launch checks
    read)."""
    out = dict(reply)
    if "counters" in out:
        out["counters"] = {k: v for k, v in out["counters"].items() if k != "decode_steps"}
    if "events" in out:
        out["events"] = [e[:2] for e in out["events"]]
    if "finished" in out:
        out["finished"] = [{**f, "tokens": np.asarray(f["tokens"]).tolist(), "token_times": len(f["token_times"])}
                           for f in out["finished"]]
    return out


def test_worker_protocol_replies_equal_jax(tiny):
    """One RPC sequence (submits, a retried submit, steps, harvests from a
    high-water mark, a conserve, a flush, an export) against both workers'
    state: the same replies, token times aside."""
    mine, theirs = _worker_states(tiny)
    trace = j_chaos._trace(j_chaos._tiny_cfg(), 1, 4, shared=True)
    script = [{"op": "submit", "seq": i + 1, "prompt": p, "max_new_tokens": m, "eos_id": None, "ttl_s": None}
              for i, (p, m) in enumerate(trace[:3])]
    script.append(dict(script[-1]))  # a retried submit: same seq, no second admission
    seen = 0
    for r in range(60):
        script.append({"op": "step", "seq": 10 + 2 * r})
        script.append({"op": "harvest", "seq": 11 + 2 * r, "events_from": seen, "known_uids": []})
        seen += 2 if r % 3 else 0
    script += [{"op": "conserve", "seq": 200, "where": "test"}, {"op": "submit", "seq": 201, "prompt": trace[3][0],
                                                                 "max_new_tokens": 4}]
    for req in script:
        got, want = mine.handle(dict(req)), theirs.handle(dict(req))
        assert _strip_times(got) == _strip_times(want), req
    assert mine.eng.queue[-1].uid == 3 and len(mine.submit_replies) == 4
    assert fp.encode_frame(_strip_times(mine.handle({"op": "hello"}))) != b""
    assert mine.handle({"op": "evict_prefix"})["freed"] >= 0  # the port's flush counts what it freed
    assert mine.tier.ledger()["total_spilled"] >= 1
    exported = mine.handle({"op": "spill_export"})["items"]
    assert all(d["checksum"] == fleet._blocks_crc(d["blocks"]) for d in exported)
    assert mine.handle({"op": "nonsense"})["error"] == "exception"


def test_draining_worker_refuses_admission_without_retry(tiny):
    mine, theirs = _worker_states(tiny)
    prompt = np.arange(12, dtype=np.int32)
    for state in (mine, theirs):
        assert state.handle({"op": "drain", "seq": 1})["draining"] is True
        reply = state.handle({"op": "submit", "seq": 2, "prompt": prompt, "max_new_tokens": 3})
        assert reply["error"] == "backpressure" and reply["retryable"] is False
    assert fp.encode_frame(mine.handle({"op": "stats"}))  # every stats reply is wire-safe


# -- the spill-transfer ledger across the wire --------------------------------------------


def _transfer_items(mod, n, wv="inline"):
    rng = np.random.default_rng(42)
    return [mod.SpillTransferItem(key=(7, i), blocks={"k": rng.standard_normal((2, 8, 4)).astype(np.float32),
                                                      "v": rng.integers(0, 1 << 16, (2, 8, 4), dtype=np.uint16)},
                                  checksum=zlib.crc32(b"page-%d" % i), weights_version=wv) for i in range(n)]


def test_spill_transfer_ledger_closes_across_wire_roundtrip():
    """Pages leaving one tier through `transferred` land in another through
    `received` after a real frame round trip, both ledgers close, the
    checksums arrive unchanged, and a duplicate delivery discards; every
    ledger equals JAX's tiers' for the same operations."""
    ledgers = {}
    for name, tiers, codec in (("port", fleet, fp), ("jax", j_fleet, j_fp)):
        items = _transfer_items(tiers if tiers is fleet else j_fp, 3)
        a, b, c = tiers.SpillTier(), tiers.SpillTier(), tiers.SpillTier()
        a.import_entries(items)
        a.assert_ledger("after landing")
        exported = a.export_entries()
        a.assert_ledger("after export")
        wired = codec.decode_frame(codec.encode_frame([fp._item_to_wire(it) for it in exported]))
        landed = [fp._item_from_wire(d) for d in wired]
        assert b.import_entries(landed) == 3
        b.assert_ledger("after import")
        out = {it.key: it for it in b.export_entries()}
        for it in items:
            assert out[it.key].checksum == it.checksum
            assert out[it.key].blocks["v"].tobytes() == it.blocks["v"].tobytes()
        c.import_entries(landed)
        c.import_entries(landed)
        c.assert_ledger("after a duplicate delivery")
        ledgers[name] = (a.ledger(), b.ledger(), c.ledger())
    assert ledgers["port"] == ledgers["jax"]
    assert ledgers["port"][2]["received"] == 6 and ledgers["port"][2]["stale_discarded"] == 3


# -- worker processes end to end ------------------------------------------------------


def test_proc_kill9_failover_representative():
    """Two CPU workers behind a FleetRouter, the busiest SIGKILLed
    mid-decode: every accepted stream finishes equal to a fault-free
    worker's pass, detected through the wire, and the router process
    launched nothing (JAX's asserts)."""
    s = chaos_serve.run_serving_chaos("proc_kill9@6", seed=0, n_requests=4, device="cpu")
    assert s["procs"] is True
    assert s["faults_fired"].get("proc_kill9", 0) >= 1
    assert s["dropped_streams"] == 0
    assert s["parity_checked"] == 4 and s["parity_ok"] == 4
    assert s["proc_failovers"] >= 1 and s["failovers"] >= 1
    assert s["failed_over_streams"] >= 1
    assert s["fleet_size"] == 2 and s["alive"] == 1
    assert s["pages_conserved"] is True
    assert s["router_launches_delta"] == 0
    assert s["transport"]["rpc_count"] > 0


def test_workers_on_jax_weights_stream_as_jax_serve_engine(tiny, tmp_path):
    """The slice against JAX: two CPU workers load JAX's GPT.init weights
    (`params_npz`), serve the shared-template trace as a fleet, and every
    greedy f32 stream equals JAX's ServeEngine's on the same weights."""
    jp, _, flat = tiny
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    spec = chaos_serve.proc_worker_spec(0, device="cpu")
    spec["params_npz"] = str(npz)
    trace = j_chaos._trace(j_chaos._tiny_cfg(), 1, 6, shared=True)
    workers = fp.spawn_workers(spec, 2)
    try:
        router = fleet.FleetRouter([fp.connect_replica(port) for _, port in workers])
        uids = chaos_serve.drive_fleet(router, trace)
        fleet.assert_fleet_conserved(router, "jax weights")
        got = {idx: np.asarray(router.finished[u].tokens).tolist() for u, idx in uids.items()}
        placed = {rep.pid for rep in router.engines}
        for rep in router.engines:
            rep.close()
    finally:
        fp.kill_workers(workers)
    j_eng = j_serve.ServeEngine(j_chaos._tiny_cfg(), jp, temperature=0.0, prefix_cache=True,
                                cache_dtype=jnp.float32, **ENGINE)
    j_uids = [j_eng.submit(p, m) for p, m in trace]
    j_eng.run()
    assert got == {i: np.asarray(j_eng.finished[u].tokens).tolist() for i, u in enumerate(j_uids)}
    assert len(placed) == 2 and router.failovers == 0 and not router.step_errors


# -- slow: the wire kinds end to end, the drain, a live spill transfer, loadgen --------------


@pytest.mark.slow
@pytest.mark.parametrize("plan,counter", [("conn_drop@5", "reconnects"), ("wire_corrupt@5", "corrupt_frames"),
                                          ("wire_stall@5", "deadline_expiries")])
def test_proc_wire_kind_absorbed(plan, counter):
    s = chaos_serve.run_serving_chaos(plan, seed=0, n_requests=4, device="cpu")
    assert s["dropped_streams"] == 0
    assert s["parity_ok"] == s["parity_checked"] == 4
    assert s["transport"][counter] >= 1
    assert s["alive"] == 2 and s["proc_failovers"] == 0
    if plan.startswith("wire_corrupt"):
        assert s["transport"]["retries"] >= 1


@pytest.mark.slow
def test_sigterm_drains_worker_to_clean_exit():
    """SIGTERM goes through the preemption flag: the worker refuses new
    admissions without retry, finishes its streams, and exits 0 once idle
    and disconnected."""
    proc, port = fp.spawn_worker(chaos_serve.proc_worker_spec(0, device="cpu"))
    try:
        rep = fp.connect_replica(port)
        trace = chaos_serve._trace(chaos_serve._tiny_cfg(), 1, 3, shared=True)
        uids = [rep.submit(p, m) for p, m in trace[:2]]
        os.kill(rep.pid, signal.SIGTERM)
        rep.step()  # the worker sees the flag between RPCs
        with pytest.raises(serve.BackpressureError) as ei:
            rep.submit(*trace[2])
        assert ei.value.retryable is False
        rep.run()
        for uid in uids:
            assert rep.finished[uid].status == "ok"
        rep.assert_conserved("after drain")
        rep.close()
        assert proc.wait(timeout=60) == 0
    finally:
        fp.kill_workers([proc])


@pytest.mark.slow
def test_spill_transfer_between_live_workers():
    """A trie flush spills worker A's KV into its tier; export_spill /
    import_spill move it to worker B, both workers' conservation holds, and
    B's streams re-adopting those pages equal A's."""
    workers = fp.spawn_workers(chaos_serve.proc_worker_spec(0, device="cpu"), 2)
    try:
        a, b = (fp.connect_replica(port) for _, port in workers)
        trace = chaos_serve._trace(chaos_serve._tiny_cfg(), 1, 4, shared=True)
        ua = [a.submit(p, m) for p, m in trace]
        a.run()
        assert a.flush_prefix_cache() >= 1
        items = a.export_spill()
        assert items and b.import_spill(items) == len(items)
        a.assert_conserved("after export")
        b.assert_conserved("after import")
        assert a.spill_ledger()["transferred"] == len(items)
        assert b.spill_ledger()["received"] == b.spill_ledger()["resident"] == len(items)
        ub = [b.submit(p, m) for p, m in trace]
        b.run()
        b.assert_conserved("after re-adoption")
        assert b.spill_readopted_pages >= 1
        assert [a.finished[u].tokens.tolist() for u in ua] == [b.finished[u].tokens.tolist() for u in ub]
        a.close()
        b.close()
    finally:
        fp.kill_workers(workers)


@pytest.mark.slow
def test_loadgen_procs_passes_the_serve_slo_contract(capsys):
    assert loadgen.main(["--device", "cpu", "--fleet", "2", "--procs", "--rates", "20,60", "--template-frac", "0.5",
                         "--n-requests", "4"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert check_serve_slo_bench(rec) == []
    assert rec["procs"] is True and rec["fleet_size"] == 2 and rec["wire_bytes"] > 0
    assert rec["rpc_p95_ms"] >= rec["rpc_p50_ms"] > 0
    for p in rec["points"]:
        assert p["completed"] == p["n_offered"] and p["failovers"] == p["proc_failovers"] == p["step_errors"] == 0


@pytest.mark.parametrize("flag,why", [([], "requires --fleet"), (["--fleet", "2", "--scheduler", "slo"], "fcfs"),
                                      (["--fleet", "2", "--overlap", "group:4"], "overlap off"),
                                      (["--fleet", "2", "--max-backlog-pages", "8"], "unbounded backlog")])
def test_loadgen_procs_keeps_jax_refusals(capsys, flag, why):
    with pytest.raises(SystemExit) as ei:
        loadgen.main(["--device", "cpu", "--procs"] + flag)
    assert ei.value.code == 2 and why in capsys.readouterr().err


def test_worker_spec_runs_on_cuda_unless_it_says_cpu():
    """A spawned worker resolves its device as every entry point does: a
    spec without "cpu" asks for CUDA and, without it, the worker exits
    before announcing a port."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    spec = chaos_serve.proc_worker_spec(0, device="cpu")
    spec.pop("device")
    proc = fp._popen_worker(spec)
    try:
        with pytest.raises(RuntimeError, match="before announcing"):
            fp._await_port(proc)
        assert proc.wait(timeout=60) != 0
    finally:
        fp.kill_workers([proc])
    assert dataclasses.asdict(chaos_serve._tiny_cfg()) == spec["model"]
    assert subprocess.list2cmdline(fp.worker_command(spec)).startswith(subprocess.list2cmdline([sys.executable]))
