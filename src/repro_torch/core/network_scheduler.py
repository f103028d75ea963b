"""Whole-network static scheduling + time-triggered execution — the
paper's §4.3 extension ("for more complex programs such as entire
networks, time-triggered execution is preferable to facilitate timing
analyses"), implemented beyond the paper's single-matmul evaluation.

A feed-forward network (fully-connected / im2col'd conv layers) is a
sequence of GEMMs with deterministic dataflow.  We build one Schedule
covering all layers (per-layer B-stationary rounds; activations round-
trip DRAM between layers with a barrier) and derive a TIME-TRIGGERED
table: each phase gets a static release time equal to its start in the
all-worst-case list schedule.  Properties (tested):

  * schedulability: under ANY DDR4 jitter draw, every dependency
    completes before its consumer's release time,
  * the time-triggered makespan is constant up to the final phase's
    own jitter — end-to-end latency variance collapses to a single
    DMA burst's bound (vs. the event-driven execution whose makespan
    accumulates jitter),
  * makespan(event) <= makespan(time-triggered) <= WCET.

This is the scheduling layer the paper defers to its compiler future
work, expressed on the same IR and timing model.

A copy of the reference's ``core/network_scheduler.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.multivic_paper import MultiVicConfig
from repro_torch.core.schedule import Schedule
from repro_torch.core.scheduler import MatmulProblem, build_matmul_schedule
from repro_torch.core.simulator import SimResult
from repro_torch.core.timing import (DEFAULT_TIMING, TimingParams,
                                     compute_cycles, dma_cycles)


@dataclass(frozen=True)
class NetworkLayer:
    name: str
    m: int          # batch (im2col rows)
    k: int          # fan-in
    n: int          # fan-out


def mlp(batch: int, widths: Sequence[int]) -> List[NetworkLayer]:
    return [NetworkLayer(f"fc{i}", batch, widths[i], widths[i + 1])
            for i in range(len(widths) - 1)]


def build_network_schedule(hw: MultiVicConfig,
                           layers: Sequence[NetworkLayer],
                           rows_per_transfer: int = 4) -> Schedule:
    """Concatenate per-layer B-stationary schedules with a barrier on
    the previous layer's final store (activations live in DRAM between
    layers — deterministic dataflow, so this is still one static
    schedule the management core can execute)."""
    net = Schedule(meta={"hw": hw.name,
                         "layers": [vars(l) for l in layers]})
    barrier = None
    for layer in layers:
        sub = build_matmul_schedule(
            hw, MatmulProblem(layer.m, layer.k, layer.n),
            rows_per_transfer=rows_per_transfer)
        offset = len(net.phases)
        first_of_layer = offset
        for ph in sub.phases:
            deps = tuple(d + offset for d in ph.deps)
            if barrier is not None and not deps:
                deps = (barrier,)
            net.add(kind=ph.kind, resource=ph.resource, deps=deps,
                    bytes_moved=ph.bytes_moved, macs=ph.macs,
                    vec_chunks=ph.vec_chunks, elems=ph.elems,
                    spm_core=ph.spm_core,
                    tag=f"{layer.name}/{ph.tag}")
        barrier = len(net.phases) - 1   # last store of this layer
        del first_of_layer
    net.validate_dag()
    net.validate_interference_freedom()
    return net


# ---------------------------------------------------------------------------
# time-triggered table + executor


def release_times(sched: Schedule, hw: MultiVicConfig,
                  tp: TimingParams = DEFAULT_TIMING) -> np.ndarray:
    """Static per-phase release times = start times in the all-worst-
    case list schedule (the compile-time timetable)."""
    n = len(sched.phases)
    start = np.zeros(n)
    finish = np.zeros(n)
    res_free: Dict[str, float] = {}
    for ph in sched.phases:
        ready = max((finish[d] for d in ph.deps), default=0.0)
        s = max(ready, res_free.get(ph.resource, 0.0))
        if ph.kind == "compute":
            dur = compute_cycles(ph, hw, tp)
        else:
            dur = dma_cycles(ph, tp, jitter=1.0) + tp.mgmt_issue_cycles
        start[ph.pid] = s
        finish[ph.pid] = s + dur
        res_free[ph.resource] = s + dur
    return start


def simulate_time_triggered(sched: Schedule, hw: MultiVicConfig,
                            release: np.ndarray,
                            tp: TimingParams = DEFAULT_TIMING,
                            seed: int = 0) -> Tuple[SimResult, bool]:
    """Execute with phases held until their static release time.
    Returns (result, schedulable): schedulable is False if any
    dependency had not finished by its consumer's release (never
    happens for jitter <= worst case — property-tested)."""
    rng = np.random.default_rng(seed)
    n = len(sched.phases)
    finish = np.zeros(n)
    busy: Dict[str, float] = {}
    ok = True
    for ph in sched.phases:
        dep_done = max((finish[d] for d in ph.deps), default=0.0)
        if dep_done > release[ph.pid] + 1e-9:
            ok = False
        s = max(release[ph.pid], dep_done)
        if ph.kind == "compute":
            dur = compute_cycles(ph, hw, tp)
        else:
            dur = dma_cycles(ph, tp, jitter=float(rng.random())) \
                + tp.mgmt_issue_cycles
        finish[ph.pid] = s + dur
        busy[ph.resource] = busy.get(ph.resource, 0.0) + dur
    return SimResult(float(finish.max()), busy, n), ok


def tt_jitter_bound(tp: TimingParams = DEFAULT_TIMING) -> float:
    """Time-triggered end-to-end jitter collapses to the LAST phase's
    own duration jitter: one DMA burst's worst extra."""
    return tp.dma_worst_extra
