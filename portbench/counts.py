"""The yardstick's operations and bytes: the H100's datasheet peaks and
the cost of one launch of each kernel, from its shapes alone.

A launch's bound is the least time the card could take for it: the
larger of its operations over the peak rate and its bytes over the HBM
bandwidth, each input byte read once and each output byte written once
(``bound`` of ``chip_smoke.py``).  Operations are counted at the dense
bf16 tensor-core rate, the fastest the card has for them, so a bound
is never above what a kernel can reach.  Which launches one replay of
a model's step makes is the reference family's to say
(``reference/<family>.py::launches``).
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor cores
HBM_BYTES_PER_S = 3.35e12

BF16 = 2
FP32 = 4


@dataclass(frozen=True)
class Cost:
    flops: float
    nbytes: float

    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.nbytes / HBM_BYTES_PER_S)


def matmul(m: int, k: int, n: int, out_bytes: int = BF16,
           in_bytes: int = BF16) -> Cost:
    """One product [m, k] x [k, n]: 2mnk operations; A and B read once,
    C written once."""
    return Cost(2.0 * m * n * k,
                float((m * k + k * n) * in_bytes + m * n * out_bytes))


def attended_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a launch attends to; causal with Sq = Sk."""
    if causal:
        if sq != sk:
            raise ValueError("causal pairs are counted for Sq = Sk")
        return sq * (sq + 1) // 2
    return sq * sk


def flash(b: int, sq: int, sk: int, h: int, kv: int, d: int,
          causal: bool, elt: int = BF16) -> Cost:
    """One ``flash_attention`` forward launch: QK^T and PV over the
    attended pairs (4 D operations a pair and head); q, k, v read and o
    written once."""
    pairs = attended_pairs(sq, sk, causal)
    return Cost(4.0 * d * pairs * b * h,
                float((2 * b * sq * h * d + 2 * b * sk * kv * d) * elt))


def wkv6(b: int, s: int, h: int, k: int, elt: int = BF16) -> Cost:
    """One ``wkv6`` forward launch from a zero state: per position and
    head the outer product k^T v, the decayed state update and r S
    (4 K^2 operations, ``chip_smoke.py``'s count); r, k, v in ``elt``,
    the fp32 log-decays and u read once, y and the fp32 final state
    written once."""
    n = b * s * h * k
    return Cost(4.0 * b * s * h * k * k,
                float(3 * n * elt + n * FP32 + h * k * FP32 + n * elt
                      + b * h * k * k * FP32))


def total_bound_s(costs) -> float:
    return sum(c.bound_s() for c in costs)
