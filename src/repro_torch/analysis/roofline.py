"""Three-term roofline per (arch x shape x mesh) (the reference's
``analysis/roofline.py``), at the H100's rates.

Defaults: 989 TFLOP/s bf16 and 3.35 TB/s HBM3
(``core.gpu_mapping.H100``, NVIDIA's H100 SXM data sheet, dense), and
0.45 TB/s a chip for collectives: the same data sheet's NVLink figure
(0.9 TB/s bidirectional), one way.  None is measured.  The reference's
rates are a TPU's; the parity tests pass them in explicitly.

The dry run's traced counts are per device (the local shards rank 0
computes and the collectives it takes part in), so:
    compute term    = flops_per_device / peak
    memory term     = bytes_per_device / hbm_bw
    collective term = collective_bytes_per_device / link_bw
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.gpu_mapping import H100

PEAK_FLOPS = H100.peak_flops     # bf16 dense, tensor cores
HBM_BW = H100.hbm_bw             # bytes/s
NVLINK_BW = 4.5e11               # bytes/s one way, H100 SXM data sheet


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll_bytes_dev: float, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = NVLINK_BW) -> Dict[str, float]:
    compute_s = flops_dev / peak_flops
    memory_s = bytes_dev / hbm_bw
    coll_s = coll_bytes_dev / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    terms.update({
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        # share of the bound that is useful compute (1.0 = compute-bound)
        "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
    })
    return terms


def kernel_bound_s(flops: float, bytes_accessed: float, *,
                   peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW,
                   mxu_eff: float = 1.0,
                   hbm_derate: float = 1.0) -> float:
    """Two-term roofline bound for a single kernel, in seconds:
    max(compute, memory); a kernel has no collective term.
    ``mxu_eff``/``hbm_derate`` apply worst-case derates
    (``GPUChip.worst_tc_eff``, ``worst_hbm_derate``): the autotuner's
    analytic pruner ranks candidate plans with this."""
    return max(flops / (peak_flops * mxu_eff),
               bytes_accessed / (hbm_bw * hbm_derate))


def compose_pieces(piece_records) -> Dict[str, float]:
    """Sum (cost x multiplier) over piece records from the runner."""
    tot = {"flops": 0.0, "bytes_accessed": 0.0, "collective_bytes": 0.0}
    for rec in piece_records:
        m = rec["multiplier"]
        tot["flops"] += m * rec.get("flops", 0.0)
        tot["bytes_accessed"] += m * rec.get("bytes_accessed", 0.0)
        tot["collective_bytes"] += m * rec.get("collective_bytes", 0.0)
    return tot
