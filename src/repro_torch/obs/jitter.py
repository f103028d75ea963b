"""Execution-time fluctuation metrics (paper §5.1, Fig. 4).

The paper evaluates predictability by running each benchmark many times
and reporting how little the cycle count moves.  ``jitter_stats``
condenses a sample vector into the fluctuation metrics we track across
PRs, and ``simulate_sweep`` produces that vector from seeded simulator
runs together with the WCET bound so every report carries its margin:

    wcet_margin = wcet(schedule) / max(observed)   (>= 1 iff bound holds)

A copy of the reference's ``obs/jitter.py``;
``tests/test_torch_obs.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs.multivic_paper import MultiVicConfig
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import sweep_cycles
from repro_torch.core.timing import DEFAULT_TIMING, TimingParams
from repro_torch.core.wcet import wcet


@dataclass(frozen=True)
class JitterStats:
    """Fluctuation summary of one timing sample vector."""

    n: int
    mean: float
    median: float
    std: float
    min: float
    max: float
    spread: float           # max - min: the observed jitter window
    p99: float
    cov: float              # coefficient of variation: std / mean
    wcet_margin: Optional[float] = None   # wcet / max (None: no bound)

    def as_dict(self) -> Dict[str, Optional[float]]:
        return asdict(self)


def jitter_stats(samples: Sequence[float],
                 wcet_bound: Optional[float] = None) -> JitterStats:
    x = np.asarray(list(samples), dtype=np.float64)
    if x.size == 0:
        raise ValueError("jitter_stats needs at least one sample")
    mean = float(x.mean())
    mx = float(x.max())
    return JitterStats(
        n=int(x.size),
        mean=mean,
        median=float(np.median(x)),
        std=float(x.std()),
        min=float(x.min()),
        max=mx,
        spread=float(mx - x.min()),
        p99=float(np.percentile(x, 99)),
        cov=float(x.std() / mean) if mean else 0.0,
        wcet_margin=(float(wcet_bound) / mx
                     if wcet_bound is not None and mx else None),
    )


def simulate_sweep(sched: Schedule, hw: MultiVicConfig,
                   n_runs: int = 100,
                   tp: TimingParams = DEFAULT_TIMING,
                   seed0: int = 0,
                   include_wcet: bool = True) -> JitterStats:
    """The paper's measurement protocol as a metric source: ``n_runs``
    seeded executions (seeds ``seed0 .. seed0+n_runs-1``, matching
    ``run_many``) summarized with the WCET margin attached."""
    cycles = sweep_cycles(sched, hw, n_runs=n_runs, tp=tp, seed0=seed0)
    bound = wcet(sched, hw, tp) if include_wcet else None
    return jitter_stats(cycles, wcet_bound=bound)
