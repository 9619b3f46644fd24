"""Exception types of the training loop, its checkpoints, the watchdog and
the fault injections (the port's own copy of
midgpt_tpu/robustness/errors.py)."""

from __future__ import annotations

import typing as tp


class DivergenceError(FloatingPointError):
    """Training produced a non-finite loss or gradient (the sticky health
    carrier, training/train.py `health_flag`).

    Subclasses FloatingPointError, as in the JAX package. `step` is the
    loop iteration at which the poisoning was noticed (a log sync or the
    check before a save); the bad batch lies at or before it.
    `last_good_step` is the newest verified checkpoint of the run directory
    (training/checkpoint.py), None when there is none."""

    def __init__(
        self,
        message: str,
        *,
        step: int,
        last_good_step: tp.Optional[int] = None,
        rundir: str = "",
    ):
        super().__init__(message)
        self.step = step
        self.last_good_step = last_good_step
        self.rundir = rundir


class StepHangError(RuntimeError):
    """A watchdog-guarded device sync did not land inside its deadline
    (robustness/watchdog.py): a wedged dispatch that would otherwise stall
    the run forever.

    `step` is the loop iteration whose sync was armed (None outside the
    training loop, e.g. the serving engine's settle); `waited_s` is how long
    the watchdog's clock says it waited, at most one poll interval past the
    deadline."""

    def __init__(
        self,
        message: str,
        *,
        step: tp.Optional[int] = None,
        waited_s: float = 0.0,
        rundir: str = "",
    ):
        super().__init__(message)
        self.step = step
        self.waited_s = waited_s
        self.rundir = rundir


class CheckpointCorruptError(ValueError):
    """A checkpoint failed its manifest verification (missing/truncated/
    bit-flipped item). `problems` lists one human-readable line per
    mismatch."""

    def __init__(self, message: str, *, step: int, problems: tp.Sequence[str] = ()):
        super().__init__(message)
        self.step = step
        self.problems = list(problems)


class CheckpointWriteError(OSError):
    """A checkpoint save still failed after the configured retry budget.

    `step` is the step whose save was abandoned, `attempts` the retry
    budget that was exhausted (training/checkpoint.py `write_retries`),
    and `directory` the checkpoint root."""

    def __init__(
        self,
        message: str,
        *,
        step: int,
        attempts: int,
        directory: str = "",
    ):
        super().__init__(message)
        self.step = step
        self.attempts = attempts
        self.directory = directory


class SimulatedPreemption(BaseException):
    """Raised by the `kill_mid_save` fault to model the process dying
    between the checkpoint's file writes and its manifest commit.

    Subclasses BaseException (like KeyboardInterrupt) on purpose: a real
    SIGKILL cannot be caught, so no `except Exception` or
    `retry_on=(OSError,)` recovery path may swallow its simulation either;
    only the fault-injection tests catch it."""
