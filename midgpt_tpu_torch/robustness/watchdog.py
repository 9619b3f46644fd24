"""Hung-step watchdog: a bounded deadline around device syncs (the port's
own copy of midgpt_tpu/robustness/watchdog.py).

A wedged dispatch blocks the sync point (`float(loss)`, an event's
`synchronize()`), and Python cannot interrupt a main thread parked inside
that native wait. So the guard inverts control: `StepWatchdog.sync(fn)`
runs the sync in a fresh daemon worker thread and bounds the main thread's
wait on a `threading.Event`. If the worker does not land inside
`deadline_s` (measured on the injected clock), the watchdog

  1. records a `watchdog.expired` instant and dumps the process-global
     flight recorder (`flight_recorder.json` + `.prom`) into `rundir`,
  2. calls the optional `on_expire(step, waited_s)` hook,
  3. escalates: `escalate="raise"` raises StepHangError in the caller (the
     supervisor restarts from the newest verified checkpoint);
     `escalate="exit"` hard-exits with EXIT_CODE, for a cluster layer that
     restarts whole processes.

A truly wedged CUDA context cannot be reused in the same process, so
`escalate="exit"` is the path for real hangs; the injected `hang_step`
fault leaves the device healthy, and the in-process restart is exact there.

The abandoned worker is a daemon thread: it either lands late (into a box
nothing reads any more: each sync gets a fresh one) or stays parked until
the process exits, without blocking the exit. CUDA-graph captures in the
serving engine use the thread-local capture mode (sampling/graphs.py), so
such a worker cannot invalidate a capture on the main thread.

`deadline_s <= 0` disables the guard: `sync` is then a plain call — no
thread, no clock read. The module reads time only through the injected
clock, so deadline arithmetic is testable on a fake clock.
"""

from __future__ import annotations

import os
import threading
import time
import typing as tp

from midgpt_tpu_torch.robustness.errors import StepHangError

# Distinct from ordinary failure exits, so a cluster layer can tell "hung
# device" from "crashed python" without parsing logs.
EXIT_CODE = 17


class StepWatchdog:
    """Deadline guard for device syncs (module docstring).

    One instance guards one loop; `sync` is called from one thread at a
    time (the train or engine loop). `syncs` and `expiries` count guarded
    syncs and expired ones."""

    def __init__(
        self,
        deadline_s: float,
        *,
        escalate: str = "raise",
        rundir: str = "",
        clock: tp.Callable[[], float] = time.monotonic,
        poll_s: float = 0.05,
        on_expire: tp.Optional[tp.Callable[[tp.Optional[int], float], None]] = None,
    ):
        if escalate not in ("raise", "exit"):
            raise ValueError(f"unknown escalate {escalate!r} ('raise' or 'exit')")
        self.deadline_s = deadline_s
        self.escalate = escalate
        self.rundir = rundir
        self.poll_s = poll_s
        self.on_expire = on_expire
        self._clock = clock
        self.syncs = 0
        self.expiries = 0

    @property
    def enabled(self) -> bool:
        return self.deadline_s > 0

    def sync(
        self,
        fn: tp.Callable[[], tp.Any],
        *,
        step: tp.Optional[int] = None,
        label: str = "step",
    ) -> tp.Any:
        """Run `fn` (a device sync) under the deadline; return its result.

        Disabled: a plain call. An exception from `fn` itself propagates
        unchanged."""
        if not self.enabled:
            return fn()
        self.syncs += 1
        box: tp.Dict[str, tp.Any] = {}
        landed = threading.Event()

        def _worker() -> None:
            try:
                box["value"] = fn()
            except BaseException as e:  # handed to the caller below
                box["error"] = e
            finally:
                landed.set()

        t0 = self._clock()
        threading.Thread(target=_worker, daemon=True, name=f"midgpt-watchdog-{label}").start()
        while not landed.wait(self.poll_s):
            waited = self._clock() - t0
            if waited >= self.deadline_s:
                return self._expire(step, label, waited)
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def _expire(self, step: tp.Optional[int], label: str, waited: float):
        self.expiries += 1
        # Postmortem artifacts first: the raise or exit below may be the last
        # thing this process does.
        from midgpt_tpu_torch.obs import dump_flight_recorder, flight_recorder

        flight_recorder().tracer.instant(
            "watchdog.expired", "watchdog", "train",
            args={"step": step, "label": label, "deadline_s": self.deadline_s,
                  "waited_s": round(waited, 3)},
        )
        if self.rundir:
            dump_flight_recorder(self.rundir)
        if self.on_expire is not None:
            self.on_expire(step, waited)
        msg = (
            f"device sync '{label}' did not land within {self.deadline_s:g}s (waited "
            f"{waited:.3f}s" + (f" at step {step}" if step is not None else "")
            + ") — wedged dispatch or device. Flight recorder "
            + (f"dumped to {self.rundir}." if self.rundir else "not dumped (no rundir).")
        )
        if self.escalate == "exit":
            print(f"watchdog: {msg} hard-exiting {EXIT_CODE}.", flush=True)
            os._exit(EXIT_CODE)
        raise StepHangError(msg, step=step, waited_s=waited, rundir=self.rundir)
