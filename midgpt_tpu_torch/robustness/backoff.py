"""Bounded exponential retry-with-backoff (the port's own copy of
midgpt_tpu/robustness/backoff.py): the checkpoint write retry
(training/checkpoint.py) sleeps `base * 2**attempt` between `retries`
attempts. The schedule is a plain iterator, so an async caller can await
each delay where `retry_with_backoff` sleeps it."""

from __future__ import annotations

import time
import typing as tp

T = tp.TypeVar("T")


def backoff_delays(retries: int, base_s: float) -> tp.Iterator[float]:
    """The delays BETWEEN `retries` attempts: base, 2*base, 4*base, ...
    (`retries - 1` entries — no sleep after the last failure; the caller
    raises instead)."""
    for attempt in range(max(retries - 1, 0)):
        yield base_s * (2**attempt)


def retry_with_backoff(
    fn: tp.Callable[[], T],
    *,
    retries: int,
    base_s: float,
    retry_on: tp.Tuple[tp.Type[BaseException], ...],
    sleep: tp.Callable[[float], None] = time.sleep,
    should_retry: tp.Optional[tp.Callable[[BaseException], bool]] = None,
) -> T:
    """Call `fn` up to `retries` times, sleeping the exponential schedule
    between attempts. Only `retry_on` exceptions are absorbed — and only
    while `should_retry(exc)` (when given) agrees. The final failure
    re-raises the last exception unchanged: the caller owns its error type
    (checkpoint.py wraps it in CheckpointWriteError)."""
    if retries < 1:
        raise ValueError(f"retries must be >= 1, got {retries}")
    delays = backoff_delays(retries, base_s)
    while True:
        try:
            return fn()
        except retry_on as e:
            if should_retry is not None and not should_retry(e):
                raise
            delay = next(delays, None)
            if delay is None:
                raise
            sleep(delay)
