"""Discrete-event execution of a static Schedule.

Resources (DMA engine, each worker core) are serial; phases start when
their dependencies have finished AND their resource is free — i.e. list
scheduling in schedule order, which is exactly how the management core
issues the statically ordered phase list (paper §4.2).

The only stochastic element is DDR4 access jitter, drawn per DMA burst
from Uniform[0, worst_extra] with a seeded generator (paper §5.1: "the
fluctuations come from the fluctuating access times of the DDR4").

A copy of the reference's ``core/simulator.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.multivic_paper import MultiVicConfig
from repro_torch.core.schedule import Schedule
from repro_torch.core.timing import (DEFAULT_TIMING, TimingParams,
                                     compute_cycles, dma_cycles)


@dataclass
class SimResult:
    total_cycles: float
    per_resource_busy: Dict[str, float]
    n_phases: int

    def seconds(self, clock_hz: float) -> float:
        return self.total_cycles / clock_hz


def simulate(sched: Schedule, hw: MultiVicConfig,
             tp: TimingParams = DEFAULT_TIMING,
             seed: Optional[int] = None,
             worst_case: bool = False,
             trace=None) -> SimResult:
    """Execute the schedule; when ``trace`` (a
    ``repro_torch.obs.trace.TraceRecorder``) is given, every phase is recorded
    as a span on its resource's track with cycle timestamps — load the
    Chrome-trace export to see the schedule as a Gantt chart."""
    rng = np.random.default_rng(seed if seed is not None else 0)
    n = len(sched.phases)
    finish = np.zeros(n, dtype=np.float64)
    res_free: Dict[str, float] = {}
    busy: Dict[str, float] = {}

    for ph in sched.phases:
        ready = 0.0
        for d in ph.deps:
            ready = max(ready, finish[d])
        start = max(ready, res_free.get(ph.resource, 0.0))
        if ph.kind == "compute":
            dur = compute_cycles(ph, hw, tp)
        else:
            jit = 1.0 if worst_case else float(rng.random())
            dur = dma_cycles(ph, tp, jitter=jit) + tp.mgmt_issue_cycles
        end = start + dur
        finish[ph.pid] = end
        res_free[ph.resource] = end
        busy[ph.resource] = busy.get(ph.resource, 0.0) + dur
        if trace is not None:
            trace.add_span(ph.tag or f"{ph.kind}#{ph.pid}",
                           track=ph.resource, start=start, end=end,
                           cat=ph.kind, pid=ph.pid,
                           bytes_moved=ph.bytes_moved, macs=ph.macs)

    return SimResult(total_cycles=float(finish.max() if n else 0.0),
                     per_resource_busy=busy, n_phases=n)


def sweep_cycles(sched: Schedule, hw: MultiVicConfig, n_runs: int = 100,
                 tp: TimingParams = DEFAULT_TIMING,
                 seed0: int = 0) -> np.ndarray:
    """Total cycles of ``n_runs`` seeded executions (seeds
    ``seed0 .. seed0+n_runs-1``) — the sample vector behind both
    ``run_many`` and ``repro_torch.obs.jitter.simulate_sweep``."""
    return np.array([
        simulate(sched, hw, tp, seed=seed0 + i).total_cycles
        for i in range(n_runs)])


def run_many(sched: Schedule, hw: MultiVicConfig, n_runs: int = 100,
             tp: TimingParams = DEFAULT_TIMING, seed0: int = 0):
    """The paper's measurement protocol: run the benchmark n times,
    report median and standard deviation of execution cycles."""
    cycles = sweep_cycles(sched, hw, n_runs=n_runs, tp=tp, seed0=seed0)
    return {
        "median": float(np.median(cycles)),
        "mean": float(cycles.mean()),
        "std": float(cycles.std()),
        "min": float(cycles.min()),
        "max": float(cycles.max()),
        "n": n_runs,
    }
