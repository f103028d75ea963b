"""Deadline-aware graceful degradation for serving (a copy of the
reference's ``resilience/deadline.py``).

The paper gives every decode step a static WCET bound; a production
server turns that bound into a *deadline* and must have a pre-planned
answer for overruns — bounded degradation, never a surprise.  The
ladder here is deliberately boring and monotone:

  ``record``  first overruns: count them, emit an instant, carry on.
  ``warn``    ``warn_after`` consecutive overruns: the operator-visible
              escalation (callers typically log).
  ``shed``    ``shed_after`` consecutive overruns: the caller should
              shed load (halve the batch, drop requests) to get back
              under the deadline.  The consecutive counter resets so
              the smaller batch gets a fresh chance before the ladder
              escalates again.

Meeting the deadline resets the ladder.  Every rung fires a
``deadline_<action>`` instant on the ``deadline`` track so traces show
the overrun next to the degradation it triggered.

Accelerator-free on purpose: the policy must be unit-testable with
synthetic durations, no device required.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class DeadlineMonitor:
    deadline_s: float
    warn_after: int = 2         # consecutive overruns before "warn"
    shed_after: int = 4         # consecutive overruns before "shed"
    trace: Optional[Any] = None  # a recorder with .instant()
    overruns: int = 0
    consecutive: int = 0
    worst_overrun_s: float = 0.0
    actions: Dict[str, int] = field(default_factory=lambda: {
        "record": 0, "warn": 0, "shed": 0})

    def __post_init__(self):
        assert self.deadline_s > 0, self.deadline_s
        assert 1 <= self.warn_after <= self.shed_after, (
            self.warn_after, self.shed_after)

    def observe(self, step: int, dt_s: float) -> str:
        """Feed one measured step; returns the action for the caller:
        ``ok`` | ``record`` | ``warn`` | ``shed``."""
        if dt_s <= self.deadline_s:
            self.consecutive = 0
            return "ok"
        self.overruns += 1
        self.consecutive += 1
        self.worst_overrun_s = max(self.worst_overrun_s,
                                   dt_s - self.deadline_s)
        if self.consecutive >= self.shed_after:
            action = "shed"
            self.consecutive = 0    # fresh chance post-degradation
        elif self.consecutive >= self.warn_after:
            action = "warn"
        else:
            action = "record"
        self.actions[action] += 1
        if self.trace is not None:
            self.trace.instant(f"deadline_{action}", track="deadline",
                               step=step, step_s=dt_s,
                               deadline_s=self.deadline_s)
        return action

    def summary(self) -> Dict[str, Any]:
        return {"deadline_s": self.deadline_s,
                "overruns": self.overruns,
                "worst_overrun_s": self.worst_overrun_s,
                **{f"n_{k}": v for k, v in self.actions.items()}}
