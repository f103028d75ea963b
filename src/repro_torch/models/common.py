"""Shared model pieces: norms, RoPE, activations, embedding helpers.

Port of the reference's ``models/common.py``; layouts and arithmetic
order follow it (fp32 inside the norm and RoPE, cast back at the end).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.spec import Par


# ---------------------------------------------------------------------------
# norms

def rmsnorm_spec(dim: int) -> Par:
    return Par((dim,), (None,), init="ones", dtype="float32")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight, in fp32, cast back to x's
    dtype (one fused op instead of the reference's six elementwise
    ones; same formula)."""
    out = F.rms_norm(x.float(), (x.shape[-1],), weight.float(), eps)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations

def activate(h_gate: torch.Tensor, h_up: Optional[torch.Tensor],
             kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(h_gate) * h_up
    if kind == "geglu":
        return F.gelu(h_gate, approximate="tanh") * h_up
    if kind == "gelu":
        return F.gelu(h_gate, approximate="tanh")
    if kind == "relu_sq":
        return F.relu(h_gate).square()
    raise ValueError(f"unknown activation {kind}")


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# rotary embeddings

def rope_freqs(head_dim: int, theta: float,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)            # [head_dim/2]


@functools.lru_cache(maxsize=16)
def _cached_freqs(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    return rope_freqs(head_dim, theta, device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) for ``rotate``: [..., seq, 1, head_dim] fp32, with
    cos repeated over both halves and sin as [-sin, sin]."""
    freqs = _cached_freqs(head_dim, float(theta), positions.device)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation by ``rope_tables``: the first half becomes
    x1*cos - x2*sin and the second x2*cos + x1*sin, in fp32, with the
    reference's operation order."""
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    return (x32 * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] int.

    Half-split rotation (first half pairs with second half), as the
    reference does; not the interleaved form."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# embedding / logits

def embed_spec(vocab: int, d_model: int, dtype: str) -> Par:
    return Par((vocab, d_model), ("vocab", "embed"), init="normal",
               dtype=dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits
