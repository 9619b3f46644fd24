"""Preemption flag: SIGTERM/SIGINT -> emergency save at the next step
boundary (the port's own copy of midgpt_tpu/robustness/preempt.py).

A signal handler may run at any host-code point, so it only sets a flag;
the training loop polls it at step boundaries (the only place a consistent
save is possible) and makes one emergency checkpoint before it exits.

Python runs a handler on the main thread only, between bytecodes: while the
main thread sits in a CUDA sync (`float(loss)`), the handler waits for it.
With the watchdog armed the main thread waits on a `threading.Event`
instead, which a signal interrupts. `signal.signal` works only on the main
thread, so the handlers are installed by the launcher, never by `train`.

`install_handlers` chains: after the first signal fires, the previous
handler is restored, so a second SIGINT still stops a wedged run.
The port runs one process, so `any_host_requested` is the local flag
(`launch --multihost` is refused; ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import signal
import time
import typing as tp

_requested = False
_requested_at: tp.Optional[float] = None
_previous: tp.Dict[int, tp.Any] = {}


def request(
    signum: tp.Optional[int] = None,
    frame: tp.Any = None,
    _clock: tp.Callable[[], float] = time.monotonic,
) -> None:
    """Mark a preemption (the signal handler; also callable directly).

    Records the first arrival on the injected clock, so the train loop can
    hold its `preempt_grace_s` budget: an emergency save that would START
    after the grace window is skipped loudly rather than being killed
    mid-write (training/train.py)."""
    global _requested, _requested_at
    _requested = True
    if _requested_at is None:  # first signal wins; re-delivery keeps it
        _requested_at = _clock()
    if signum is not None and signum in _previous:
        # One-shot: a second signal reaches the previous (default) handler.
        signal.signal(signum, _previous.pop(signum))


def requested() -> bool:
    return _requested


def requested_at() -> tp.Optional[float]:
    """Monotonic time of the first preemption request (None if none): the
    same clock as `request`'s default, so `time.monotonic() -
    requested_at()` is the grace already spent."""
    return _requested_at


def reset() -> None:
    """Clear the flag and restore every handler `install_handlers` replaced."""
    global _requested, _requested_at
    _requested = False
    _requested_at = None
    for signum, prev in list(_previous.items()):
        signal.signal(signum, prev)
    _previous.clear()


def install_handlers(
    signums: tp.Sequence[int] = (signal.SIGTERM, signal.SIGINT),
) -> None:
    """Route the preemption signals through `request` (the launcher calls
    this before training; tests drive `request()` or the `preempt` fault)."""
    for signum in signums:
        prev = signal.signal(signum, request)
        _previous.setdefault(signum, prev)


def any_host_requested() -> bool:
    """True when any process of the run saw a preemption signal. The port
    runs one process, so this is the local flag: no collective."""
    return _requested
