"""The paper's own hardware configurations (Tables 1 and 2).

These describe the MultiVic FPGA design points evaluated in the paper:
the single-core baselines (Small / Medium / Fast Vicuna configs) and the
multi-core variants (Dual / Quad / Octa / Hexadeca).  They are consumed
by repro_torch.core (scheduler / timing model / roofline / resources).

All frequencies are the paper's measured F_max on the VCU128
(Virtex Ultrascale+).  The benchmark clock in Fig. 4 is 100 MHz; the
seconds figures quoted in §5.1 use F_max.

A copy of the reference's ``configs/multivic_paper.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

KIB = 1024
MIB = 1024 * KIB


@dataclass(frozen=True)
class VicunaConfig:
    """One Vicuna vector core (paper Table 1 columns)."""

    vreg_bits: int          # vector register length in bits
    mul_width_bits: int     # multiplier (compute unit) width in bits


@dataclass(frozen=True)
class MultiVicConfig:
    """A full MultiVic design point (paper Tables 1-2)."""

    name: str
    num_worker_cores: int
    vicuna: VicunaConfig
    data_spm_bytes: int          # per worker core
    insn_spm_bytes: int          # per worker core
    fmax_hz: float               # measured on VCU128
    mgmt_insn_spm_bytes: int = 64 * KIB
    mgmt_data_spm_bytes: int = 64 * KIB
    benchmark_clock_hz: float = 100e6   # Fig. 4 measurement clock

    @property
    def is_multicore(self) -> bool:
        return self.num_worker_cores > 1

    @property
    def total_mul_width_bits(self) -> int:
        return self.num_worker_cores * self.vicuna.mul_width_bits

    @property
    def total_data_spm_bytes(self) -> int:
        return self.num_worker_cores * self.data_spm_bytes


# --- Table 1: single-core baselines ---------------------------------------
BASELINE_SMALL = MultiVicConfig(
    "baseline-small", 1, VicunaConfig(128, 32), 1 * MIB, 64 * KIB, 179e6)
BASELINE_MEDIUM = MultiVicConfig(
    "baseline-medium", 1, VicunaConfig(512, 128), 1 * MIB, 64 * KIB, 177e6)
BASELINE_FAST = MultiVicConfig(
    "baseline-fast", 1, VicunaConfig(2048, 1024), 1 * MIB, 64 * KIB, 149e6)

# --- Table 2: multi-core variants ------------------------------------------
DUAL = MultiVicConfig(
    "dual", 2, VicunaConfig(1024, 512), 512 * KIB, 16 * KIB, 168e6)
QUAD = MultiVicConfig(
    "quad", 4, VicunaConfig(512, 256), 256 * KIB, 16 * KIB, 169e6)
OCTA = MultiVicConfig(
    "octa", 8, VicunaConfig(256, 128), 128 * KIB, 16 * KIB, 168e6)
HEXADECA = MultiVicConfig(
    "hexadeca", 16, VicunaConfig(128, 64), 64 * KIB, 16 * KIB, 118e6)

PAPER_CONFIGS: Tuple[MultiVicConfig, ...] = (
    BASELINE_SMALL, BASELINE_MEDIUM, BASELINE_FAST,
    DUAL, QUAD, OCTA, HEXADECA,
)

EVAL_CONFIGS: Tuple[MultiVicConfig, ...] = (
    BASELINE_FAST, DUAL, QUAD, OCTA, HEXADECA)

BY_NAME = {c.name: c for c in PAPER_CONFIGS}

# --- Published measurement anchors (paper §5.1, Fig. 4) --------------------
# Median cycle counts for the 1024^3 matmul benchmark.
PAPER_MEDIAN_CYCLES = {
    "octa": 728_548_804,
    "hexadeca": 548_343_601,
}
# Seconds at F_max quoted in the paper text.
PAPER_SECONDS = {
    "octa": 4.33,
    "hexadeca": 4.65,
}

# Matmul benchmark problem size (paper §4.3)
MATMUL_N = 1024
ELEM_BYTES = 4          # fp32 elements (Vicuna RVV on FP32 words)

# DDR4 on VCU128 via Xilinx MIG: effective bandwidth & worst-case access
# latency assumptions used by the timing model (see core/timing.py).
DDR4_BYTES_PER_CYCLE = 16.0       # effective @ benchmark clock
DDR4_WORST_EXTRA_LATENCY = 64     # cycles, worst-case refresh/row-miss
DDR4_BASE_LATENCY = 32            # cycles, fixed setup per DMA burst
