"""Mamba2 (SSD — state-space duality) blocks of the port, used by
zamba2-7b and zamba2-7b-instruct.  Port of the reference's
``models/ssm.py``.

The recurrence  h_t = exp(a_t) h_{t-1} + dt_t * B_t x_t^T,
                y_t = C_t · h_t + D * x_t
is computed in the chunked (matrix) form: an intra-chunk attention-like
term plus the inter-chunk state carry.  Exponents of the decay segments
are always <= 0 (scalar per-head decay), so the chunked form is
numerically stable without rescaling.

What differs from the reference:

* ``in_proj`` and ``out_proj`` go through ``spm_matmul``: its
  hand-written kernel for CUDA tensors, its plain version for CPU
  tensors.  ``tile`` pins the decode step's (bm, bn).
* The reference computes ``ssd_chunked`` in jnp, not in a Pallas
  kernel, so here it stays torch ops, with the reference's casts step
  by step; its ``lax.scan`` over the chunks is a loop over the (static)
  chunk count.
* Softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it
  (``F.softplus`` returns x itself above its threshold).
* ``ssd_chunked`` masks the pairs above the diagonal before taking the
  exp, where the reference masks after it.  The forward is the same
  bits; but there ca_t - ca_j > 0 overflows to inf at full width (a
  chunk of 256 sums hundreds of log-decays), and the backward through
  the mask then takes 0 * inf = NaN: full-width zamba2's first training
  step had no finite gradient.
* ``mamba_decode`` returns the new states; the model's decode step
  copies them into its cache buffers.

Beyond the reference: B and C in ``SSMConfig.n_groups`` groups, each
shared by ``nheads / n_groups`` consecutive heads, and the gated norm
over each group's ``d_inner / n_groups`` channels (Zamba2-7B-Instruct's
two groups).  One group is the reference's arithmetic, op for op:
``ssd_chunked`` runs a grouped call one group after another.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.attention import linear
from repro_torch.models.common import rmsnorm
from repro_torch.models.spec import Par

Tile = Optional[Tuple[int, int]]


def ssm_dims(d_model: int, s: SSMConfig):
    """(d_inner, heads, conv channels: x and the groups' B and C)."""
    d_inner = s.expand * d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    return d_inner, nheads, conv_dim


def mamba_spec(d_model: int, s: SSMConfig, dtype: str) -> dict:
    d_inner, nheads, conv_dim = ssm_dims(d_model, s)
    d_in_proj = d_inner + conv_dim + nheads      # z, x B C, dt
    return {
        "in_proj": Par((d_model, d_in_proj), ("embed", "ffn"), init="scaled",
                       dtype=dtype),
        "conv_w": Par((s.conv_kernel, conv_dim), (None, "ffn"),
                      init="scaled", dtype=dtype),
        "conv_b": Par((conv_dim,), ("ffn",), init="zeros", dtype=dtype),
        "A_log": Par((nheads,), (None,), init="decay", dtype="float32"),
        "D": Par((nheads,), (None,), init="ones", dtype="float32"),
        "dt_bias": Par((nheads,), (None,), init="zeros", dtype="float32"),
        "norm": Par((d_inner,), (None,), init="ones", dtype="float32"),
        "out_proj": Par((d_inner, d_model), ("ffn", "embed"), init="scaled",
                        dtype=dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: [B,S,C]; w: [K,C]; state: [B,K-1,C]
    carries the last K-1 inputs for decode.  Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # [B, S+K-1, C]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    # a copy: a view would keep all of xp alive with the state (at a
    # 32 x 1024 prefill, 0.49 GB a layer held in the cache)
    new_state = xp[:, -(K - 1):].clone() if K > 1 else pad
    return y, new_state


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, conv_dim: int,
                nheads: int):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., -nheads:]
    return z, xBC, dt


def _split_xbc(xBC: torch.Tensor, d_inner: int, s: SSMConfig):
    """x [..., d_inner] and B, C: [..., N] for one group (the
    reference's layout), [..., G, N] for more."""
    G, N = s.n_groups, s.state_dim
    xin = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + G * N]
    Cm = xBC[..., d_inner + G * N:]
    if G > 1:
        Bm = Bm.unflatten(-1, (G, N))
        Cm = Cm.unflatten(-1, (G, N))
    return xin, Bm, Cm


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                s: SSMConfig, eps: float) -> torch.Tensor:
    """RMSNorm of y * silu(z), over each group's channels."""
    g = y * F.silu(z)
    if s.n_groups == 1:
        return rmsnorm(g, w, eps)
    gs = g.shape[-1] // s.n_groups
    out = F.rms_norm(g.float().unflatten(-1, (s.n_groups, gs)), (gs,),
                     None, eps) * w.float().view(s.n_groups, gs)
    return out.flatten(-2).to(g.dtype)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  [B,S,H,P]  (already multiplied by dt)
    a:  [B,S,H]    log-decay per step (<= 0)
    Bm: [B,S,N], Cm: [B,S,N]; or [B,S,G,N] each, for G groups of H / G
        consecutive heads (run one group after another)
    Returns (y [B,S,H,P], final_state [B,H,N,P]).
    """
    if Bm.dim() == 4:
        return _ssd_grouped(x, a, Bm, Cm, chunk, init_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    NC = S // chunk
    xc = x.reshape(Bsz, NC, chunk, H, P)
    ac = a.reshape(Bsz, NC, chunk, H).float()
    Bc = Bm.reshape(Bsz, NC, chunk, N)
    Cc = Cm.reshape(Bsz, NC, chunk, N)

    ca = torch.cumsum(ac, dim=2)                      # inclusive [B,NC,L,H]
    total = ca[:, :, -1]                              # [B,NC,H]

    # intra-chunk: y[t] += sum_{j<=t} (C_t.B_j) exp(ca_t - ca_j) x_j
    seg = ca[:, :, :, None, :] - ca[:, :, None, :, :]  # [B,NC,L(t),L(j),H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # masked before the exp: above the diagonal ca_t - ca_j > 0, whose
    # exp overflows at full width, and 0 * inf would poison the backward
    seg = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                float("-inf")))
    cb = torch.einsum("bctn,bcjn->bctj", Cc.float(), Bc.float())
    att = (cb[..., None] * seg).to(x.dtype)          # [B,NC,L,L,H]
    y_intra = torch.einsum("bctjh,bcjhp->bcthp", att, xc)

    # chunk boundary states: sum_j exp(total - ca_j) B_j x_j^T
    decay_end = torch.exp(total[:, :, None, :] - ca)  # [B,NC,L,H]
    cstate = torch.einsum("bclh,bcln,bclhp->bchnp", decay_end.to(x.dtype),
                          Bc.to(x.dtype), xc)

    state = (torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    prev = []                                          # state BEFORE chunk c
    for c in range(NC):
        prev.append(state)
        state = (state * torch.exp(total[:, c])[:, :, None, None]
                 + cstate[:, c].float())
    prev_states = torch.stack(prev, dim=1)             # [B,NC,H,N,P]

    # inter-chunk: y[t] += exp(ca_t) * C_t . S_prev
    y_inter = torch.einsum("bctn,bcnhp->bcthp", Cc.to(x.dtype),
                           prev_states.transpose(2, 3).to(x.dtype))
    y_inter = y_inter * torch.exp(ca)[..., None].to(x.dtype)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, state.to(x.dtype)


def _ssd_grouped(x, a, Bm, Cm, chunk, init_state):
    """``ssd_chunked`` over G groups, one group's H / G heads at a time
    (so the chunks' [L, L] decay terms of one group are live at once)."""
    G = Bm.shape[2]
    Hg = x.shape[2] // G
    ys, finals = [], []
    for g in range(G):
        hs = slice(g * Hg, (g + 1) * Hg)
        y, final = ssd_chunked(
            x[:, :, hs], a[:, :, hs], Bm[:, :, g], Cm[:, :, g], chunk,
            None if init_state is None else init_state[:, hs])
        ys.append(y)
        finals.append(final)
    return torch.cat(ys, dim=2), torch.cat(finals, dim=1)


def mamba_forward(p: dict, x: torch.Tensor, s: SSMConfig,
                  state: Optional[dict] = None, return_state: bool = False,
                  eps: float = 1e-6):
    """Full-sequence Mamba2 block.  x: [B,S,d]; ``eps``: the gated
    norm's."""
    d_model = x.shape[-1]
    d_inner, nheads, conv_dim = ssm_dims(d_model, s)
    zxbcdt = linear(x, p["in_proj"])
    z, xBC, dt = _split_proj(zxbcdt, d_inner, conv_dim, nheads)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xin, Bm, Cm = _split_xbc(xBC, d_inner, s)

    dt = _softplus(dt.float() + p["dt_bias"])                    # [B,S,H]
    a = -torch.exp(p["A_log"]) * dt                              # <= 0
    xh = xin.reshape(*xin.shape[:-1], nheads, s.head_dim)
    xdt = xh * dt[..., None].to(xh.dtype)

    init_ssm = None if state is None else state["ssm"]
    S = x.shape[1]
    chunk = s.chunk_size if S % s.chunk_size == 0 else S
    y, final = ssd_chunked(xdt, a, Bm, Cm, chunk, init_ssm)
    y = y + xh * p["D"][:, None].to(xh.dtype)
    y = y.reshape(*x.shape[:-1], d_inner)
    y = _gated_norm(y, z, p["norm"], s, eps)
    out = linear(y, p["out_proj"])
    if return_state:
        return out, {"conv": new_conv, "ssm": final}
    return out


def mamba_decode(p: dict, x: torch.Tensor, s: SSMConfig, state: dict,
                 tile: Tile = None, eps: float = 1e-6):
    """Single-token decode.  x: [B,1,d]; state {conv [B,K-1,C],
    ssm [B,H,N,P]}.  Returns (y [B,1,d], the new state); ``state`` is
    not written.  ``eps``: the gated norm's."""
    d_model = x.shape[-1]
    d_inner, nheads, conv_dim = ssm_dims(d_model, s)
    zxbcdt = linear(x, p["in_proj"], tile)
    z, xBC, dt = _split_proj(zxbcdt, d_inner, conv_dim, nheads)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 state["conv"])
    xBC = F.silu(xBC)
    xin, Bm, Cm = _split_xbc(xBC, d_inner, s)       # B, C: [B,1,(G,)N]

    dt = _softplus(dt.float() + p["dt_bias"])                    # [B,1,H]
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                   # [B,1,H]
    xh = xin.reshape(x.shape[0], nheads, s.head_dim)             # [B,H,P]
    xdt = xh * dt[:, 0, :, None].to(xh.dtype)

    S0 = state["ssm"].float()                                    # [B,H,N,P]
    if s.n_groups == 1:
        upd = torch.einsum("bn,bhp->bhnp", Bm[:, 0].float(), xdt.float())
        S1 = S0 * a[:, 0, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), S1)
    else:                       # heads as [G, H / G]: one B and C a group
        G = s.n_groups
        hs = (x.shape[0], G, nheads // G)
        upd = torch.einsum("bgn,bghp->bghnp", Bm[:, 0].float(),
                           xdt.float().reshape(*hs, s.head_dim))
        S1 = S0.reshape(*hs, *S0.shape[2:]) \
            * a[:, 0].reshape(*hs)[..., None, None] + upd
        y = torch.einsum("bgn,bghnp->bghp", Cm[:, 0].float(), S1)
        S1, y = S1.flatten(1, 2), y.flatten(1, 2)
    y = y.to(xh.dtype) + xh * p["D"][:, None].to(xh.dtype)
    y = y.reshape(x.shape[0], 1, d_inner)
    y = _gated_norm(y, z, p["norm"], s, eps)
    out = linear(y, p["out_proj"], tile)
    return out, {"conv": new_conv, "ssm": S1.to(state["ssm"].dtype)}


def mamba_state_spec(batch: int, d_model: int, s: SSMConfig,
                     dtype: str) -> dict:
    d_inner, nheads, conv_dim = ssm_dims(d_model, s)
    return {
        "conv": Par((batch, s.conv_kernel - 1, conv_dim),
                    ("batch", None, "ffn"), init="zeros", dtype=dtype),
        "ssm": Par((batch, nheads, s.state_dim, s.head_dim),
                   ("batch", "heads", None, None), init="zeros",
                   dtype=dtype),
    }
