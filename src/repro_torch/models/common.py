"""Shared model pieces: norms, RoPE, activations, embedding helpers.

Port of the reference's ``models/common.py``; layouts and arithmetic
order follow it (fp32 inside the norm and RoPE, cast back at the end).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.spec import Par
from repro_torch.sharding.rules import redistribute


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
    if kind == "geglu_exact":   # zamba2's published MLP: erf GELU
        return F.gelu(h_gate) * h_up
    if kind == "gelu":
        return F.gelu(h_gate, approximate="tanh")
    if kind == "relu_sq":
        return F.relu(h_gate).square()
    raise ValueError(f"unknown activation {kind}")


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu", "geglu_exact")


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


class EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` with a deterministic backward.  Autograd's own
    backward of the gather is ``index_put_`` with accumulation, which on
    the CPU adds a row's duplicates with atomic float adds from many
    threads (the sum's order, so its bits, change run to run); under
    ``torch.use_deterministic_algorithms`` the CPU adds them serially,
    and CUDA runs its sort-based kernel (a stable sort of the indices,
    then each row's duplicates added in order by one thread, no
    atomics), the kernel it runs for accumulation anyway.  So the
    backward switches that mode on around its one ``index_put_``."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        out = torch.zeros(ctx.table_shape, dtype=grad.dtype,
                          device=grad.device)
        before = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True)
        try:
            out.index_put_((tokens,), grad, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(before[0],
                                               warn_only=before[1])
        return out, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; under autograd (a table that needs a gradient)
    through ``EmbedLookup``, whose backward is deterministic.  A DTensor
    table (the dry run) is gathered whole, as a ZeRO-sharded weight is
    before use, and looked up locally; its gradient is reduce-scattered
    back to the table's shards."""
    if isinstance(table, DTensor):
        return F.embedding(tokens, redistribute(
            table, [Replicate()] * table.device_mesh.ndim))
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbedLookup.apply(table, tokens)
    return table[tokens]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits
