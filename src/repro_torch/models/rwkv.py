"""RWKV-6 ("Finch") blocks of the port: data-dependent-decay linear
attention (WKV6) with token-shift mixing, plus the squared-ReLU channel
mix.  Port of the reference's ``models/rwkv.py``.

WKV6 recurrence per head (K = key dim, V = value dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: [K, V])
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with per-channel decay w_t in (0,1) computed from the input (low-rank).

What differs from the reference:

* Every product with a weight matrix goes through ``spm_matmul``: its
  hand-written kernel for CUDA tensors, its plain version for CPU
  tensors.  ``tile`` pins the decode step's (bm, bn).
* A WKV call with no carried state (every prefill and every training
  step) goes to the ``wkv6`` kernel wrapper: the hand-written kernels
  on CUDA (forward, and under autograd the backward of
  ``csrc/wkv6_bwd.cu``), the plain version (the exact sequential
  recurrence) on the CPU, the chunked form on ``meta`` (the dry run).
  With a carried state (every decode step) the copies of
  ``wkv6_chunked`` / ``wkv6_sequential`` run as torch ops, as the
  reference routes them: the TPU kernel takes no initial state.

The chunked form (``kernels/wkv6/ref.py``, re-exported here) factorizes
the interval decay products exp(e_t - cw_j); the k-side exponent
(-cw_j >= 0) is clamped at ``_EXP_CLAMP`` to stay finite in fp32, as in
the reference.  The returned WKV state is cast to x's dtype, so a bf16
model carries it between decode steps in bf16, as the reference does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RWKVConfig
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import _EXP_CLAMP, wkv6_chunked  # noqa: F401
from repro_torch.models.attention import linear
from repro_torch.models.spec import Par

_GN_EPS = 64e-5

Tile = Optional[Tuple[int, int]]


def rwkv_dims(d_model: int, r: RWKVConfig):
    nheads = d_model // r.head_dim
    return nheads, r.head_dim


def timemix_spec(d_model: int, r: RWKVConfig, dtype: str) -> dict:
    nheads, hd = rwkv_dims(d_model, r)
    return {
        "maa_x": Par((d_model,), (None,), init="zeros", dtype="float32"),
        "maa_rkvwg": Par((5, d_model), (None, None), init="zeros",
                         dtype="float32"),
        "mix_w1": Par((d_model, 5 * r.mix_lora), ("embed", None),
                      init="scaled", dtype=dtype),
        "mix_w2": Par((5, r.mix_lora, d_model), (None, None, "embed"),
                      init="scaled", dtype=dtype),
        "w0": Par((d_model,), (None,), init="decay", dtype="float32"),
        "wd_w1": Par((d_model, r.decay_lora), ("embed", None),
                     init="scaled", dtype=dtype),
        "wd_w2": Par((r.decay_lora, d_model), (None, "embed"),
                     init="scaled", dtype=dtype),
        "wr": Par((d_model, d_model), ("embed", "heads"), init="scaled",
                  dtype=dtype),
        "wk": Par((d_model, d_model), ("embed", "heads"), init="scaled",
                  dtype=dtype),
        "wv": Par((d_model, d_model), ("embed", "heads"), init="scaled",
                  dtype=dtype),
        "wg": Par((d_model, d_model), ("embed", "heads"), init="scaled",
                  dtype=dtype),
        "u": Par((nheads, hd), (None, None), init="zeros", dtype="float32"),
        "ln_x": Par((d_model,), (None,), init="ones", dtype="float32"),
        "wo": Par((d_model, d_model), ("heads", "embed"), init="scaled",
                  dtype=dtype),
    }


def channelmix_spec(d_model: int, d_ff: int, dtype: str) -> dict:
    return {
        "maa_k": Par((d_model,), (None,), init="zeros", dtype="float32"),
        "maa_r": Par((d_model,), (None,), init="zeros", dtype="float32"),
        "wk": Par((d_model, d_ff), ("embed", "ffn"), init="scaled",
                  dtype=dtype),
        "wv": Par((d_ff, d_model), ("ffn", "embed"), init="scaled",
                  dtype=dtype),
        "wr": Par((d_model, d_model), ("embed", None), init="scaled",
                  dtype=dtype),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1}, with `prev` [B,1,d] carried across calls."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# WKV6 in torch ops (the carried-state path; the kernel takes no state)


def wkv6_sequential(r, k, v, w_log, u, init_state=None):
    """Exact per-step scan.  r,k,v,w_log: [B,S,H,K]; u: [H,K].
    Returns (y [B,S,H,V] in r's dtype, final_state [B,H,K,V] fp32)."""
    B, S, H, K = r.shape
    f32 = torch.float32
    s = (torch.zeros((B, H, K, K), dtype=f32, device=r.device)
         if init_state is None else init_state.to(f32))
    uu = u.to(f32)[None, :, :, None]
    ys = []
    for t in range(S):
        rt, kt, vt = (a[:, t].to(f32) for a in (r, k, v))
        kv = kt[..., :, None] * vt[..., None, :]          # [B,H,K,V]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + uu * kv))
        s = torch.exp(w_log[:, t].to(f32))[..., None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


# ---------------------------------------------------------------------------
# layer-level forward


def _ddlerp(p, x, xprev, tile: Tile = None):
    """RWKV6 data-dependent token-shift mixing -> (xr,xk,xv,xw,xg)."""
    dx = (xprev - x).to(torch.float32)
    x32 = x.to(torch.float32)
    xx = x32 + dx * p["maa_x"]
    B, S, _ = x.shape
    m = torch.tanh(linear(xx.to(x.dtype), p["mix_w1"], tile))
    m = m.reshape(B, S, 5, -1)
    outs = []
    for i in range(5):
        adj = linear(m[:, :, i], p["mix_w2"][i], tile).to(torch.float32)
        mi = p["maa_rkvwg"][i] + adj
        outs.append((x32 + dx * mi).to(x.dtype))
    return outs  # r, k, v, w, g order


def timemix_forward(p: dict, x: torch.Tensor, r_cfg: RWKVConfig,
                    state: Optional[dict] = None,
                    return_state: bool = False, chunk: int = 0,
                    tile: Tile = None):
    """Full-sequence RWKV6 time-mix.  x: [B,S,d].  ``tile`` pins the
    weight products' spm_matmul (bm, bn)."""
    nheads, hd = rwkv_dims(x.shape[-1], r_cfg)
    prev = None if state is None else state["shift"]
    xprev = _shift(x, prev)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xprev, tile)

    B, S, d = x.shape
    rh = linear(xr, p["wr"], tile).reshape(B, S, nheads, hd)
    kh = linear(xk, p["wk"], tile).reshape(B, S, nheads, hd)
    vh = linear(xv, p["wv"], tile).reshape(B, S, nheads, hd)
    g = linear(xg, p["wg"], tile)

    wl = torch.tanh(linear(xw, p["wd_w1"], tile))
    wl = linear(wl, p["wd_w2"], tile).to(torch.float32)
    w_log = -torch.exp(p["w0"] + wl)                  # [B,S,d] <= 0
    w_log = w_log.reshape(B, S, nheads, hd)

    chunk = chunk or r_cfg.chunk_size
    init = None if state is None else state["wkv"]
    if init is None:
        y, final = wkv_ops.wkv(rh, kh, vh, w_log, p["u"], chunk=chunk)
    elif S % chunk == 0 and S > 1:
        y, final = wkv6_chunked(rh, kh, vh, w_log, p["u"], chunk, init)
    else:
        y, final = wkv6_sequential(rh, kh, vh, w_log, p["u"], init)

    # per-head groupnorm (scale-only) then gate
    y32 = y.to(torch.float32)
    mu = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, keepdim=True, correction=0)
    y32 = (y32 - mu) * torch.rsqrt(var + _GN_EPS)
    y = (y32.reshape(B, S, d) * p["ln_x"]).to(x.dtype)
    y = y * F.silu(g)
    out = linear(y, p["wo"], tile)
    if return_state:
        return out, {"shift": x[:, -1:], "wkv": final.to(x.dtype)}
    return out


def channelmix_forward(p: dict, x: torch.Tensor,
                       state: Optional[torch.Tensor] = None,
                       return_state: bool = False, tile: Tile = None):
    xprev = _shift(x, state)
    dx = (xprev - x).to(torch.float32)
    x32 = x.to(torch.float32)
    xk = (x32 + dx * p["maa_k"]).to(x.dtype)
    xr = (x32 + dx * p["maa_r"]).to(x.dtype)
    kh = torch.square(torch.relu(linear(xk, p["wk"], tile)))
    kv = linear(kh, p["wv"], tile)
    y = torch.sigmoid(linear(xr, p["wr"], tile)) * kv
    if return_state:
        return y, x[:, -1:]
    return y


def rwkv_state_spec(batch: int, d_model: int, r: RWKVConfig,
                    dtype: str) -> dict:
    nheads, hd = rwkv_dims(d_model, r)
    return {
        "tm": {
            "shift": Par((batch, 1, d_model), ("batch", None, None),
                         init="zeros", dtype=dtype),
            "wkv": Par((batch, nheads, hd, hd),
                       ("batch", "heads", None, None), init="zeros",
                       dtype=dtype),
        },
        "cm": Par((batch, 1, d_model), ("batch", None, None), init="zeros",
                  dtype=dtype),
    }
