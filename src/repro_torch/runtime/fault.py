"""Fault-tolerance building blocks for 1000+-node operation: the port's
copy of the reference's ``runtime/fault.py`` (pure Python).

PreemptionGuard   — SIGTERM/SIGINT-aware flag the train loop polls; on
                    preemption the loop checkpoints and exits cleanly.
StragglerMonitor  — EWMA step-time tracker; flags steps slower than
                    k x the trailing mean (the time-predictability lens
                    applied to the datacenter: with a static schedule a
                    slow step is an anomaly worth acting on, exactly the
                    paper's jitter argument).
elastic_remesh_plan — given a new device count after failures, choose
                    the nearest valid (data, model) mesh and report how
                    batch/shardings change; CheckpointManager.restore
                    (unsharded leaves) completes the elastic restart.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:       # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def trigger_for_test(self):
        self._requested = True


@dataclass
class StragglerMonitor:
    threshold: float = 2.0          # x trailing mean
    alpha: float = 0.1              # EWMA factor
    trace: Optional[Any] = None     # obs.TraceRecorder: step_s counter
    _mean: Optional[float] = None   # + straggler instants
    events: List[Tuple[int, float, float]] = field(default_factory=list)
    _t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> bool:
        if self._t0 is None:      # no matching step_start(): nothing to
            return False          # measure — don't poison the EWMA
        dt = time.monotonic() - self._t0
        self._t0 = None
        is_straggler = (self._mean is not None
                        and dt > self.threshold * self._mean)
        if is_straggler:
            self.events.append((step, dt, self._mean))
        if self.trace is not None:
            self.trace.counter("step_s", dt)
            if is_straggler:
                self.trace.instant("straggler", track="trainer",
                                   step=step, step_s=dt,
                                   trailing_mean_s=self._mean)
        self._mean = (dt if self._mean is None
                      else (1 - self.alpha) * self._mean + self.alpha * dt)
        return is_straggler

    @property
    def mean_step_s(self) -> Optional[float]:
        return self._mean


def elastic_remesh_plan(n_devices: int, model_parallel: int = 16,
                        min_data: int = 1) -> dict:
    """Largest (data, model) mesh usable with n_devices survivors.

    Keeps the model axis fixed (weight shards must still fit) and
    shrinks the data axis — surviving hosts re-shard via checkpoint
    restore; the global batch is kept by raising per-device batch or
    gradient accumulation (reported in the plan).

    Invariants (chaos-tested): devices_used + devices_idle ==
    n_devices and grad_accum_factor >= 1, for any n_devices >= 0."""
    if n_devices <= 0:            # total outage: nothing schedulable
        return {"data": 0, "model": 0,
                "devices_used": 0, "devices_idle": n_devices,
                "grad_accum_factor": 1}
    if n_devices < model_parallel:
        # degrade model parallelism to the largest power-of-two <= n
        mp = 1
        while mp * 2 <= n_devices:
            mp *= 2
        model_parallel = mp
    data = max(min_data, n_devices // model_parallel)
    if data * model_parallel > n_devices:
        raise ValueError(
            f"min_data={min_data} needs {data * model_parallel} devices "
            f"but only {n_devices} survive")
    used = data * model_parallel
    return {
        "data": data, "model": model_parallel,
        "devices_used": used, "devices_idle": n_devices - used,
        "grad_accum_factor": max(1, 16 // data),
    }
