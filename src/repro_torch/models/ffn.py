"""Dense feed-forward layer of the port (SwiGLU / GeGLU / GELU /
squared-ReLU), from the reference's ``models/ffn.py``.  Its three
weight-pass products go through ``spm_matmul``.  The mixture-of-experts
layers come with the MoE slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.attention import linear
from repro_torch.models.common import activate, is_gated
from repro_torch.models.spec import Par


def dense_ffn_spec(d_model: int, d_ff: int, activation: str,
                   dtype: str) -> dict:
    p = {
        "w_gate": Par((d_model, d_ff), ("embed", "ffn"), init="scaled",
                      dtype=dtype),
        "w_down": Par((d_ff, d_model), ("ffn", "embed"), init="scaled",
                      dtype=dtype),
    }
    if is_gated(activation):
        p["w_up"] = Par((d_model, d_ff), ("embed", "ffn"), init="scaled",
                        dtype=dtype)
    return p


def dense_ffn(p: dict, x: torch.Tensor, activation: str,
              tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``tile`` pins the products' spm_matmul (bm, bn)."""
    hg = linear(x, p["w_gate"], tile)
    hu = linear(x, p["w_up"], tile) if "w_up" in p else None
    h = activate(hg, hu, activation)
    return linear(h, p["w_down"], tile)
