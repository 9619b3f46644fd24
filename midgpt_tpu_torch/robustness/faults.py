"""Fault-injection registry: named, bounded failures for recovery testing
(the port's own copy of midgpt_tpu/robustness/faults.py: the same kinds,
plan grammar and firing rules).

A fault is (kind, optional step, remaining firings). Code calls
`should_fire(kind, step=...)` at the few places a real failure would
strike; with an empty registry (the default, always) that is a scan over
nothing.

Two differences from the JAX registry:

  * `should_fire` and the counts hold a lock: the checkpoint writer is a
    thread (training/checkpoint.py), so the checkpoint faults are consulted
    from a second thread while the loop consults the training faults.
  * Activating a kind whose hook the port does not have raises
    NotImplementedError naming its ROADMAP.md item: a plan must never
    register a fault that can never fire, since that is a silent pass.

Hooked kinds and where they strike:

  nan_grad           training/train.py: the sticky loss carrier becomes NaN
                     at data step k (itr + data_step_offset), as a bad batch
                     would make it; a rollback that skips the window skips
                     the fault too.
  ckpt_io_error      training/checkpoint.py: the next N write attempts raise
                     OSError; the retry with backoff absorbs them.
  ckpt_enospc        the same, as ENOSPC after partial bytes landed in the
                     step directory; the retry sweeps them first.
  kill_mid_save      at step k's save: the items land, one is truncated,
                     SimulatedPreemption is raised before the manifest —
                     a SIGKILL between write and commit.
  truncate_ckpt_item at step k's save: one item is truncated AFTER the
                     manifest committed; verification catches it.
  preempt            training/train.py: the preemption flag is set at data
                     step k, as if SIGTERM arrived mid-step.
  hang_step          training/train.py: the sync at data step k never lands
                     (it waits on an event nothing sets), so only the
                     watchdog (robustness/watchdog.py) ends the wait.
  kill_mid_decode    sampling/serve.py, keyed on the engine's round counter:
                     the round's decode dispatch dies; every decode-ready
                     slot is recompute-preempted.
  kill_overlapped_round  the in-flight group of overlap="double" dies
                     unforced; its slots are recompute-preempted.
  poisoned_page      one live slot's first pool page is corrupted in place;
                     every other stream must stay identical.

Activation: programmatic (`activate(...)`), or a plan string from the
config (`fault_plan`) or the MIDGPT_FAULTS environment variable, parsed by
`activate_plan`: comma-separated `kind[@step][*times]`, e.g.
`"nan_grad@12,ckpt_io_error*2"`. The supervisor activates the plan once per
supervised run, not once per attempt, so a consumed fault stays consumed
across restarts.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import typing as tp

KINDS = (
    "nan_grad",
    "ckpt_io_error",
    "kill_mid_save",
    "truncate_ckpt_item",
    "preempt",
    "hang_step",
    "ckpt_enospc",
    "resume_reshard",
    # serving
    "kill_mid_decode",
    "kill_overlapped_round",
    "poisoned_page",
    "slow_client",
    "submit_storm",
    "evict_shared_prefix",
    "hot_swap_mid_decode",
    "pool_resize",
    # fleet
    "engine_crash",
    "handoff_stall",
    "spill_corrupt",
    # cross-process fleet
    "proc_kill9",
    "conn_drop",
    "wire_corrupt",
    "wire_stall",
)

DESCRIPTIONS: tp.Dict[str, str] = {
    "nan_grad": "poison the train step's loss at data step k (bad batch)",
    "ckpt_io_error": "raise IOError from the next checkpoint-save attempts",
    "kill_mid_save": "truncate one ckpt item + die before the manifest lands",
    "truncate_ckpt_item": "corrupt one ckpt item AFTER its manifest committed",
    "preempt": "set the preemption flag at data step k (SIGTERM mid-step)",
    "hang_step": "the step's device sync never lands; the watchdog must end it",
    "ckpt_enospc": "ENOSPC mid checkpoint write, partial bytes left behind",
    "resume_reshard": "preempt at data step k; the run resumes on another mesh",
    "kill_mid_decode": "the round's decode dispatch dies; slots recompute-preempt",
    "kill_overlapped_round": "the in-flight overlapped dispatch dies mid host phase",
    "poisoned_page": "corrupt one live slot's pool page in place (HBM damage)",
    "slow_client": "a streaming client stops draining; bounded buffer sheds it",
    "submit_storm": "submission burst beyond the backpressure budget; excess sheds",
    "evict_shared_prefix": "force-flush every unreferenced prefix-trie page at once",
    "hot_swap_mid_decode": "blue/green weight swap mid-trace (engine swap_source)",
    "pool_resize": "live KV pool resize to the engine's next resize_plan target",
    "engine_crash": "kill the busiest fleet replica; streams fail over to survivors",
    "handoff_stall": "wedge the spill-tier transport; admissions re-prefill instead",
    "spill_corrupt": "bit-flip a spilled host-RAM KV page; checksum must catch it",
    "proc_kill9": "SIGKILL the busiest worker process; wire-detected failover",
    "conn_drop": "drop the live router->worker socket; next RPC reconnects",
    "wire_corrupt": "bit-flip the next wire frame; crc32 rejects pre-decode",
    "wire_stall": "next RPC response misses its deadline; backoff absorbs it",
}

# The kinds the port has no hook for yet, by the ROADMAP.md item that brings it.
UNHOOKED: tp.Dict[str, str] = {
    "resume_reshard": "Queue 1 item 8 (parallelism)",
    **{k: "Queue 1 item 6 (the serving periphery)" for k in (
        "slow_client", "submit_storm", "evict_shared_prefix", "hot_swap_mid_decode", "pool_resize",
        "engine_crash", "handoff_stall", "spill_corrupt",
        "proc_kill9", "conn_drop", "wire_corrupt", "wire_stall",
    )},
}
HOOKED = tuple(k for k in KINDS if k not in UNHOOKED)

# kind names may carry digits (proc_kill9); `@` still separates the step
_PLAN_RE = re.compile(
    r"^(?P<kind>[a-z_][a-z0-9_]*?)(?:@(?P<step>\d+))?(?:\*(?P<times>\d+))?$"
)


@dataclasses.dataclass
class Fault:
    kind: str
    step: tp.Optional[int] = None  # fire only when the hook's step matches
    times: int = 1  # remaining firings
    fired: int = 0  # total firings so far


_active: tp.List[Fault] = []
_lock = threading.Lock()


def activate(kind: str, *, step: tp.Optional[int] = None, times: int = 1) -> Fault:
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; known: {KINDS}")
    if kind in UNHOOKED:
        raise NotImplementedError(
            f"fault kind {kind!r} has no hook in the port yet ({UNHOOKED[kind]} in "
            f"ROADMAP.md); activating it would register a fault that never fires. "
            f"Hooked kinds: {HOOKED}"
        )
    f = Fault(kind, step=step, times=times)
    with _lock:
        _active.append(f)
    return f


def activate_plan(plan: str) -> tp.List[Fault]:
    """Parse and activate `kind[@step][*times]` comma-separated specs. The
    whole plan is checked before any of it is activated."""
    parsed = []
    for spec in filter(None, (s.strip() for s in plan.split(","))):
        m = _PLAN_RE.match(spec)
        if not m:
            raise ValueError(
                f"bad fault spec {spec!r} (want kind[@step][*times], e.g. "
                "'nan_grad@12' or 'ckpt_io_error*2')"
            )
        parsed.append((
            m.group("kind"),
            int(m.group("step")) if m.group("step") else None,
            int(m.group("times")) if m.group("times") else 1,
        ))
    for kind, _, _ in parsed:
        if kind in UNHOOKED or kind not in KINDS:
            activate(kind)  # raises
    return [activate(kind, step=step, times=times) for kind, step, times in parsed]


def clear() -> None:
    with _lock:
        _active.clear()


def active() -> tp.List[Fault]:
    with _lock:
        return list(_active)


def fired_counts() -> tp.Dict[str, int]:
    out: tp.Dict[str, int] = {}
    with _lock:
        for f in _active:
            out[f.kind] = out.get(f.kind, 0) + f.fired
    return out


def should_fire(kind: str, *, step: tp.Optional[int] = None) -> bool:
    """Consume one firing of the first matching armed fault.

    A step-scoped fault only fires when the hook reports that exact step; a
    stepless fault fires on any matching hook call."""
    with _lock:
        for f in _active:
            if f.kind != kind or f.times <= 0:
                continue
            if f.step is not None and step != f.step:
                continue
            f.times -= 1
            f.fired += 1
            return True
    return False
