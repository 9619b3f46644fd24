"""Exception types of the training loop and its checkpoints (the port's own
copy of midgpt_tpu/robustness/errors.py's DivergenceError,
CheckpointCorruptError and CheckpointWriteError)."""

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
