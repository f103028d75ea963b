"""int8 gradient compression of the port: the single-device round trip
of the reference's ``optim/compression.py``.

Scheme (per leaf): scale = max(|g|) / 127, q = round(g / scale) as
int8, g_hat = q * scale; |g_hat - g| <= scale / 2 per element.  The
mesh-axis mean ``compressed_grad_mean`` comes with the multi-device
slice.
"""
from __future__ import annotations

import torch


def quantize_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Quantize to int8 with the leaf's max-scale, dequantize."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-20) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(g.dtype)
