"""FPGA resource model (paper Fig. 5): LUT / FF / BRAM / DSP per
configuration and per component.

The paper publishes bar charts, not numbers; this model uses public
per-component estimates (Ibex ~4k LUT [PATMOS'17]; Vicuna LUT/DSP scale
with the multiplier width [ECRTS'21]; BRAM36 from SPM capacity; Xilinx
DDR4 MIG ~30k LUT) and reproduces the paper's qualitative findings:
 * total resources grow with core count (each core adds an Ibex + ISPM),
 * DSP count is roughly flat across variants (many small ~ few large),
 * worker cores + scratchpads dominate; the management core is tiny.

A copy of the reference's ``core/resources.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.multivic_paper import KIB, MultiVicConfig

IBEX_LUT, IBEX_FF = 4_000, 2_600
VICUNA_LUT_BASE, VICUNA_LUT_PER_MULBIT = 6_000, 14.0
VICUNA_FF_BASE, VICUNA_FF_PER_MULBIT = 4_000, 8.0
DSP_PER_MULBIT = 0.25              # DSP48s per multiplier bit (fp32 MACs)
BRAM36_BYTES = 4_608               # 36 Kib
DMA_LUT, DMA_FF = 3_000, 2_000
XBAR_LUT_PER_PORT = 700
DDR4_MIG_LUT, DDR4_MIG_FF, DDR4_MIG_BRAM = 30_000, 25_000, 26
TIMER_LUT = 500


def _brams(nbytes: int) -> int:
    return max(1, (nbytes + BRAM36_BYTES - 1) // BRAM36_BYTES)


def component_resources(hw: MultiVicConfig) -> Dict[str, Dict[str, float]]:
    worker_lut = (IBEX_LUT + VICUNA_LUT_BASE
                  + VICUNA_LUT_PER_MULBIT * hw.vicuna.mul_width_bits)
    worker_ff = (IBEX_FF + VICUNA_FF_BASE
                 + VICUNA_FF_PER_MULBIT * hw.vicuna.mul_width_bits)
    worker_dsp = DSP_PER_MULBIT * hw.vicuna.mul_width_bits
    worker_bram = _brams(hw.data_spm_bytes) + _brams(hw.insn_spm_bytes)
    W = hw.num_worker_cores
    ports = 2 * W + 2
    comps = {
        "workers": {
            "lut": W * worker_lut, "ff": W * worker_ff,
            "dsp": W * worker_dsp, "bram": W * worker_bram,
        },
        "mgmt_core": {
            "lut": IBEX_LUT + TIMER_LUT, "ff": IBEX_FF, "dsp": 0,
            "bram": _brams(hw.mgmt_insn_spm_bytes)
            + _brams(hw.mgmt_data_spm_bytes),
        },
        "dma_xbar": {
            "lut": DMA_LUT + XBAR_LUT_PER_PORT * ports, "ff": DMA_FF,
            "dsp": 0, "bram": 2,
        },
        "ddr4_ctrl": {
            "lut": DDR4_MIG_LUT, "ff": DDR4_MIG_FF, "dsp": 3,
            "bram": DDR4_MIG_BRAM,
        },
    }
    return comps


def total_resources(hw: MultiVicConfig) -> Dict[str, float]:
    tot: Dict[str, float] = {"lut": 0, "ff": 0, "dsp": 0, "bram": 0}
    for comp in component_resources(hw).values():
        for k in tot:
            tot[k] += comp[k]
    return tot
