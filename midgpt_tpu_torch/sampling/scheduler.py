"""Pluggable serving scheduler policies (admission, ordering, preemption) —
a copy of midgpt_tpu/sampling/scheduler.py, which is pure Python.

Three policy decisions of the `ServeEngine` round loop sit behind the
`Scheduler` interface: which queued request claims a freed slot
(`select_admit`), which running slot is preempted when the page pool runs
dry (`select_victim`), and when `submit` refuses a request outright
(`shed_reason`). Policies are host code only: they feed the engine's page
table and queue order and never touch device state.

Two policies ship:

  * `FCFSScheduler` — admit the queue head, evict the youngest, shed only
    on the `max_backlog_pages` budget. The default.
  * `SLOScheduler` — deadline-aware: admission is earliest-deadline-first,
    preemption picks the victim with the MOST deadline slack, and
    admission sheds requests whose deadline is already infeasible (closer
    than `min_headroom_s`), reported via `BackpressureError.retryable=False`.

Deadlock-freedom is the ENGINE's invariant, not the policy's: the engine
only ever offers preemption candidates strictly younger (later
`admit_order`) than the slot that needs pages, so the oldest running
request always makes progress no matter what a policy returns. A policy
returning a non-candidate is a contract violation and raises.
"""

from __future__ import annotations

import typing as tp

if tp.TYPE_CHECKING:  # import cycle: serve.py imports this module
    from midgpt_tpu_torch.sampling.serve import Request, _Slot


class Scheduler:
    """Host-side serving policy. Stateless by default; implementations may
    keep statistics but must not touch device state."""

    name = "base"

    def select_admit(
        self, queue: tp.Sequence["Request"], now: float
    ) -> tp.Optional[int]:
        """Index into `queue` of the request to admit into a freed slot,
        or None to deliberately leave the slot empty this round."""
        raise NotImplementedError

    def select_victim(
        self,
        requester: "_Slot",
        candidates: tp.Sequence["_Slot"],
        now: float,
    ) -> tp.Optional["_Slot"]:
        """Which of `candidates` to preempt so `requester` can grow.

        `candidates` holds only running slots strictly younger than
        `requester` (the engine's deadlock-freedom invariant — see module
        docstring); it is never empty. Return None to defer `requester`
        instead of preempting anyone."""
        raise NotImplementedError

    def shed_reason(
        self,
        need_pages: int,
        deadline: tp.Optional[float],
        engine,
        now: float,
    ) -> tp.Optional[tp.Tuple[str, bool]]:
        """Admission control, called by `ServeEngine.submit` before a
        request enters the queue. None admits; `(reason, retryable)`
        sheds — the engine raises `BackpressureError(reason,
        retryable=retryable, ...)`."""
        raise NotImplementedError

    # Shared backpressure-budget check: every policy sheds when the
    # worst-case committed page demand would exceed `max_backlog_pages`
    # (None = unbounded).
    def _over_budget(self, need_pages: int, engine) -> tp.Optional[tp.Tuple[str, bool]]:
        if engine.max_backlog_pages is None:
            return None
        backlog = engine._backlog_pages()
        if backlog + need_pages > engine.max_backlog_pages:
            return (
                f"admission refused: request needs {need_pages} worst-case "
                f"pages on top of a committed backlog of {backlog} "
                f"(budget {engine.max_backlog_pages}) — the pool is "
                "oversubscribed; shed load or retry after requests finish",
                True,  # retryable: capacity frees as requests finish
            )
        return None


class FCFSScheduler(Scheduler):
    """First-come-first-served admission (queue head), youngest-first
    preemption, budget-only shedding."""

    name = "fcfs"

    def select_admit(self, queue, now):
        return 0 if queue else None

    def select_victim(self, requester, candidates, now):
        return max(candidates, key=lambda s: s.admit_order)

    def shed_reason(self, need_pages, deadline, engine, now):
        return self._over_budget(need_pages, engine)


class SLOScheduler(Scheduler):
    """Deadline-urgency scheduling: serve the requests whose SLO is at
    risk, shed the ones that are already lost.

    * **Admission order** — earliest deadline first; deadline-less requests
      rank last; ties fall back to FCFS (queue position).
    * **Preemption** — among the (strictly younger) candidates, evict the
      slot with the MOST deadline slack, ties youngest-first.
    * **Load shedding** — beyond the backpressure budget (retryable, like
      FCFS), and additionally any request whose deadline is nearer than
      `min_headroom_s` (non-retryable: waiting only makes it later).
    """

    name = "slo"

    def __init__(self, min_headroom_s: float = 0.0):
        self.min_headroom_s = min_headroom_s

    @staticmethod
    def _slack(deadline: tp.Optional[float], now: float) -> float:
        return float("inf") if deadline is None else deadline - now

    def select_admit(self, queue, now):
        if not queue:
            return None
        return min(
            range(len(queue)),
            key=lambda i: (self._slack(queue[i].deadline, now), i),
        )

    def select_victim(self, requester, candidates, now):
        return max(
            candidates,
            key=lambda s: (self._slack(s.request.deadline, now), s.admit_order),
        )

    def shed_reason(self, need_pages, deadline, engine, now):
        over = self._over_budget(need_pages, engine)
        if over is not None:
            return over
        if deadline is not None and deadline - now < self.min_headroom_s:
            return (
                f"admission refused: deadline headroom {deadline - now:.3f}s "
                f"is below the {self.min_headroom_s:.3f}s service floor — "
                "the SLO is already infeasible, shedding instead of burning "
                "pool pages on a request that cannot finish in time",
                False,  # waiting cannot make a past-due deadline feasible
            )
        return None


def set_backlog_budget(engine, pages: tp.Optional[int]) -> tp.Optional[int]:
    """Retune the engine's `max_backlog_pages` shed threshold live (None
    disables the budget). Returns the previous budget."""
    prev = engine.max_backlog_pages
    engine.max_backlog_pages = pages
    return prev
