"""Exception types of the training loop (the port's own copy of
midgpt_tpu/robustness/errors.py's DivergenceError)."""

from __future__ import annotations

import typing as tp


class DivergenceError(FloatingPointError):
    """Training produced a non-finite loss or gradient (the sticky health
    carrier, training/train.py `health_flag`).

    Subclasses FloatingPointError, as in the JAX package. `step` is the
    loop iteration at which the poisoning was noticed (a log sync); the bad
    batch lies at or before it. `last_good_step` is None: the port keeps no
    periodic checkpoints yet."""

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
