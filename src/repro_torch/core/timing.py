"""Deterministic per-phase timing model for the MultiVic hardware.

Models, at cycle granularity (benchmark clock):

* worker-core compute: Vicuna vector pipeline issuing VL-element vector
  ops processed ``mul_width`` bits per cycle, vector loads from the
  dual-port SPM at ``spm_port_bytes`` per cycle, plus Ibex scalar-loop
  overhead per vector chunk and a reduction/store epilogue per output
  element (paper §4.3's inner loop).
* DMA: DDR4 with a fixed per-burst setup latency, a sustained
  bytes/cycle rate, and a bounded *jitter* term for row-miss/refresh —
  the sole source of execution-time variability in the system
  (paper §3.1).  The WCET model charges the full worst-case for every
  burst; the simulator draws jitter uniformly in [0, worst].

The free constants are CALIBRATED against the paper's two published
absolute cycle counts (Octa / Hexadeca medians, §5.1) — see
``tests/test_paper_validation.py``.

A copy of the reference's ``core/timing.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.multivic_paper import (DDR4_BASE_LATENCY,
                                                DDR4_BYTES_PER_CYCLE,
                                                DDR4_WORST_EXTRA_LATENCY,
                                                ELEM_BYTES, MultiVicConfig)
from repro_torch.core.schedule import Phase


@dataclass(frozen=True)
class TimingParams:
    spm_port_bytes: float = 1.50697   # SPM load bandwidth per cycle
    loop_overhead: float = 19.9415    # Ibex issue + stripmine per chunk
    epilogue_cycles: float = 32.0     # reduce+store per output element
    dma_base_latency: float = DDR4_BASE_LATENCY
    dma_bytes_per_cycle: float = DDR4_BYTES_PER_CYCLE
    dma_worst_extra: float = DDR4_WORST_EXTRA_LATENCY
    mgmt_issue_cycles: float = 20.0   # mgmt-core cost to issue a phase


# Constants calibrated against the paper's two published medians (Octa
# 728,548,804 and Hexadeca 548,343,601 cycles for the 1024^3 matmul,
# §5.1); the inner loop is output-vectorized (stream B-chunk, broadcast
# A scalar — the per-chunk fixed cost absorbs the scalar load).  See
# benchmarks/bench_fig4_matmul.py and tests/test_paper_validation.py.
DEFAULT_TIMING = TimingParams()


def compute_cycles(ph: Phase, hw: MultiVicConfig,
                   tp: TimingParams = DEFAULT_TIMING) -> float:
    """Cycle count of one compute phase on a worker core."""
    assert ph.kind == "compute"
    vl_elems = hw.vicuna.vreg_bits // (8 * ELEM_BYTES)
    mac_cycles_per_chunk = hw.vicuna.vreg_bits / hw.vicuna.mul_width_bits
    load_cycles_per_chunk = vl_elems * ELEM_BYTES / tp.spm_port_bytes
    per_chunk = load_cycles_per_chunk + mac_cycles_per_chunk \
        + tp.loop_overhead
    return ph.vec_chunks * per_chunk + ph.elems * tp.epilogue_cycles


def dma_cycles(ph: Phase, tp: TimingParams = DEFAULT_TIMING,
               jitter: float = 0.0) -> float:
    """Cycle count of one DMA burst.  jitter in [0, 1] scales the
    worst-case extra latency (0 = best case, 1 = WCET)."""
    assert ph.kind in ("dma_load", "dma_store")
    return (tp.dma_base_latency + ph.bytes_moved / tp.dma_bytes_per_cycle
            + jitter * tp.dma_worst_extra)


def phase_wcet(ph: Phase, hw: MultiVicConfig,
               tp: TimingParams = DEFAULT_TIMING) -> float:
    """Worst-case duration of a single phase (compositional unit)."""
    if ph.kind == "compute":
        return compute_cycles(ph, hw, tp)
    return dma_cycles(ph, tp, jitter=1.0) + tp.mgmt_issue_cycles


def phase_best(ph: Phase, hw: MultiVicConfig,
               tp: TimingParams = DEFAULT_TIMING) -> float:
    if ph.kind == "compute":
        return compute_cycles(ph, hw, tp)
    return dma_cycles(ph, tp, jitter=0.0) + tp.mgmt_issue_cycles
