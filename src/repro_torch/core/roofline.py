"""Paper Fig. 3: theoretical roofline per MultiVic configuration.

Compute ceiling: total multiplier lanes x 2 FLOPs (MAC) x F_max.
Memory slopes: aggregate scratchpad bandwidth (one dual-port SRAM port
per worker — this is the boundary the multi-core design SHIFTS) and the
shared DDR4 bandwidth (identical across configs).

The paper's observation reproduced here: all multi-core variants share
the Fast baseline's compute ceiling (total MUL width is constant at
1024 bits) but each added core adds a private SPM port, so the
SPM-bandwidth roofline moves right-up with core count, benefitting
data-intensive kernels with high reuse (§5.1).

A copy of the reference's ``core/roofline.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.multivic_paper import (DDR4_BYTES_PER_CYCLE,
                                                ELEM_BYTES, MultiVicConfig)

SPM_PORT_BYTES_THEORETICAL = 4.0   # dual-port SRAM, one 32-bit read/cycle


def config_roofline(hw: MultiVicConfig, use_fmax: bool = True
                    ) -> Dict[str, float]:
    f = hw.fmax_hz if use_fmax else hw.benchmark_clock_hz
    lanes = hw.total_mul_width_bits / (8 * ELEM_BYTES)
    peak_flops = 2.0 * lanes * f
    spm_bw = hw.num_worker_cores * SPM_PORT_BYTES_THEORETICAL * f
    dram_bw = DDR4_BYTES_PER_CYCLE * f
    return {
        "config": hw.name,
        "fmax_mhz": f / 1e6,
        "peak_gflops": peak_flops / 1e9,
        "spm_bw_gbs": spm_bw / 1e9,
        "dram_bw_gbs": dram_bw / 1e9,
        # ridge points (FLOP/byte where the kernel becomes compute-bound)
        "ridge_spm": peak_flops / spm_bw,
        "ridge_dram": peak_flops / dram_bw,
    }


def attainable_gflops(hw: MultiVicConfig, arithmetic_intensity: float,
                      from_spm: bool = True) -> float:
    r = config_roofline(hw)
    bw = r["spm_bw_gbs"] if from_spm else r["dram_bw_gbs"]
    return min(r["peak_gflops"], arithmetic_intensity * bw)
