"""Compositional WCET analysis.

Because the architecture is interference-free and timing-anomaly-free
(paper §3.1, citing Hahn/Reineke/Wilhelm compositionality), a global
WCET can be composed from per-phase worst-case bounds: evaluate the
schedule DAG with every phase at its local worst case.  The invariant

        simulate(schedule, any jitter draw)  <=  wcet(schedule)

is exercised as a hypothesis property test (tests/).

A copy of the reference's ``core/wcet.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from repro_torch.configs.multivic_paper import MultiVicConfig
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import simulate
from repro_torch.core.timing import DEFAULT_TIMING, TimingParams, phase_wcet


def wcet(sched: Schedule, hw: MultiVicConfig,
         tp: TimingParams = DEFAULT_TIMING) -> float:
    """Exact bound: list-schedule with worst-case durations."""
    return simulate(sched, hw, tp, worst_case=True).total_cycles


def wcet_closed_form(sched: Schedule, hw: MultiVicConfig,
                     tp: TimingParams = DEFAULT_TIMING) -> float:
    """A coarser, human-auditable bound:
        sum over serialized DMA worst cases
      + longest single compute chain (cores run concurrently)
    This over-approximates the exact bound (no overlap assumed between
    the DMA stream and the slowest core's compute chain).

    Domain note: this form is valid for the schedules our schedulers
    emit (compute phases depend only on DMA phases and earlier
    same-core computes, and parallel cores carry balanced chains).  It
    is NOT sound for arbitrary phase DAGs — a dependency chain can
    weave core0-compute -> DMA -> core1-compute and accumulate compute
    time from several cores, exceeding ``dma_total + longest_core``
    (tests/test_timing_properties.py exercises exactly this with
    randomized DAGs).  ``wcet_serial_bound`` is the always-sound
    fallback."""
    dma_total = sum(phase_wcet(p, hw, tp) for p in sched.phases
                    if p.kind != "compute")
    per_core = {}
    for p in sched.phases:
        if p.kind == "compute":
            per_core[p.resource] = per_core.get(p.resource, 0.0) \
                + phase_wcet(p, hw, tp)
    longest_core = max(per_core.values()) if per_core else 0.0
    return dma_total + longest_core


def wcet_serial_bound(sched: Schedule, hw: MultiVicConfig,
                      tp: TimingParams = DEFAULT_TIMING) -> float:
    """Full-serialization bound: the sum of every phase's worst case.

    Sound for ANY well-formed phase DAG: list scheduling can only start
    phases earlier than executing the list back-to-back, so by
    induction ``finish(i) <= sum_{j<=i} wcet(j)``.  Much coarser than
    ``wcet_closed_form`` (it grants no parallelism at all) but free of
    that bound's structural assumptions — the outer slice of the
    randomized-DAG WCET sandwich."""
    return sum(phase_wcet(p, hw, tp) for p in sched.phases)


def jitter_bound(sched: Schedule, tp: TimingParams = DEFAULT_TIMING):
    """Max possible spread (WCET - BCET) — all of it is DDR4 jitter,
    by construction: n_dma_bursts * worst_extra."""
    n_dma = sum(1 for p in sched.phases if p.kind != "compute")
    return n_dma * tp.dma_worst_extra
