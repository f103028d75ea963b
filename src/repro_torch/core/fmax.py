"""Critical-path / routing-congestion model for F_max (paper Tables 1-2).

We cannot run Vivado synthesis here, so F_max is modeled with two
physically-motivated basis terms fitted (least squares) to the seven
published measurements:

  f = A + B*L + C*L^2 - D*max(0, ports - P0)^2
      L = log2(multiplier width)        (vector-unit critical path)
      ports = 2*W + 2                   (SPM ports on the DMA crossbar:
                                         I+D per worker + mgmt, §5.1)

The quadratic congestion term reproduces the paper's observation that
scalability breaks at 16 cores because of FPGA routing congestion from
34 scratchpad connections.  Residuals are asserted < 5% in tests.

A copy of the reference's ``core/fmax.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.multivic_paper import PAPER_CONFIGS, MultiVicConfig

P0_PORTS = 8.0


def _features(hw: MultiVicConfig) -> np.ndarray:
    L = np.log2(hw.vicuna.mul_width_bits)
    ports = 2 * hw.num_worker_cores + 2
    cong = max(0.0, ports - P0_PORTS) ** 2
    return np.array([1.0, L, L * L, -cong])


def fit_fmax_model() -> np.ndarray:
    X = np.stack([_features(c) for c in PAPER_CONFIGS])
    y = np.array([c.fmax_hz / 1e6 for c in PAPER_CONFIGS])
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    return coef


_COEF = None


def predict_fmax_mhz(hw: MultiVicConfig) -> float:
    global _COEF
    if _COEF is None:
        _COEF = fit_fmax_model()
    return float(_features(hw) @ _COEF)


def model_table():
    """(name, measured MHz, modeled MHz, rel err) for every config."""
    rows = []
    for c in PAPER_CONFIGS:
        pred = predict_fmax_mhz(c)
        meas = c.fmax_hz / 1e6
        rows.append((c.name, meas, pred, (pred - meas) / meas))
    return rows
