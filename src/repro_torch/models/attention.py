"""Attention layers of the port: GQA self-attention (full, sliding
window, causal) and decode against a preallocated KV cache.

Port of the reference's ``models/attention.py``.  What differs:

* Every weight-pass product (the Q/K/V and output projections) goes
  through ``spm_matmul``: its hand-written kernel for CUDA tensors, its
  plain version for CPU tensors.
* Prefill self-attention on CUDA runs the hand-written
  ``flash_attention`` kernel with the layer's ``causal``, ``window``
  and ``scale``; its positions are ``arange(S)`` for q and k, which
  matches the kernel's own position masking.  On the CPU it runs
  ``sdpa``, the reference's jnp form (but under autograd: see
  Training); ``chunk_q``/``chunk_kv`` steer only that path.
* Decode (one query) has no TPU kernel and stays torch ops, as in the
  reference.  Its cache write is in place (see ``decode_attention``).
* Encoder-decoder cross-attention (``cross_kv``, ``cross_attention``):
  the memory's K/V are projected once; the prefill call on CUDA runs
  ``flash_attention`` unmasked with Sq the decoder's length and Sk the
  encoder's, the decode call (``decode=True``, one query against the
  cached cross K/V) runs ``sdpa``.  The caller states which call it
  makes; the shapes do not decide it.
* Softmax arithmetic is fp32 regardless of model dtype.
* Training: under grad mode, when q, k or v needs a gradient, the
  prefill-form calls run ``flash_attention`` on either device (on the
  CPU its plain version), whose autograd backward
  (``flash_ops.attention_grad``) recomputes ``sdpa``'s block form
  (``attention_block``) under autograd, one block of queries at a
  time.  The reference's gradient is ``jax.grad`` of its jnp ``sdpa``;
  it has no backward kernel either.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_block
from repro_torch.kernels.spm_matmul import ops as spm_ops
from repro_torch.models.common import (rmsnorm, rmsnorm_spec, rope_tables,
                                       rotate)
from repro_torch.models.spec import Par

NEG_INF = -1e30
_BIG_WINDOW = 1 << 30


# ---------------------------------------------------------------------------
# parameter specs


def attn_spec(d_model: int, a: AttentionConfig, dtype: str,
              d_out: Optional[int] = None) -> dict:
    hd, H, KV = a.head_dim, a.num_heads, a.num_kv_heads
    p = {
        "wq": Par((d_model, H, hd), ("embed", "heads", "head_dim"),
                  init="scaled", dtype=dtype),
        "wk": Par((d_model, KV, hd), ("embed", "kv_heads", "head_dim"),
                  init="scaled", dtype=dtype),
        "wv": Par((d_model, KV, hd), ("embed", "kv_heads", "head_dim"),
                  init="scaled", dtype=dtype),
        "wo": Par((H, hd, d_out or d_model), ("heads", "head_dim",
                                              "embed"),
                  init="scaled", dtype=dtype),
    }
    if a.qkv_bias:
        p["bq"] = Par((H, hd), ("heads", None), init="zeros", dtype=dtype)
        p["bk"] = Par((KV, hd), ("kv_heads", None), init="zeros", dtype=dtype)
        p["bv"] = Par((KV, hd), ("kv_heads", None), init="zeros", dtype=dtype)
    if a.qk_norm:
        p["q_norm"] = rmsnorm_spec(hd)
        p["k_norm"] = rmsnorm_spec(hd)
    return p


# ---------------------------------------------------------------------------
# projections


def linear(x: torch.Tensor, w: torch.Tensor,
           tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x [..., K] @ w [K, N] through spm_matmul, output in x's dtype;
    ``tile`` pins the kernel's (bm, bn), else its default plan."""
    lead = x.shape[:-1]
    bm, bn = tile or (None, None)
    y = spm_ops.matmul(x.reshape(-1, x.shape[-1]), w, bm=bm, bn=bn)
    return y.reshape(*lead, w.shape[1])


def qkv_project(p: dict, x: torch.Tensor, a: AttentionConfig,
                positions: torch.Tensor, theta: float,
                tile: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> q [B,S,H,hd], k/v [B,S,KV,hd] (rope applied)."""
    B, S, d = x.shape

    def proj(w):                              # w: [d, n, hd]
        return linear(x, w.reshape(d, -1), tile).reshape(
            B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if a.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if a.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if a.rope_theta > 0:  # static per-arch; whisper uses no rope
        cos, sin = rope_tables(positions, a.head_dim, theta)
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
    return q, k, v


def out_project(p: dict, o: torch.Tensor,
                tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    B, S, H, hd = o.shape
    return linear(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, -1),
                  tile)


# ---------------------------------------------------------------------------
# masked scaled-dot-product attention, chunked with online softmax


def _mask_bias(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """[Sq, Tk] additive bias in fp32."""
    dq = pos_q[:, None].long()
    dk = pos_k[None, :].long()
    ok = dk >= 0          # ring-buffer slots not yet written are < 0
    if causal:
        ok = ok & (dk <= dq)
    w_eff = window if window > 0 else _BIG_WINDOW
    ok = ok & (dq - dk < w_eff)
    return torch.where(ok, 0.0, NEG_INF).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         pos_q: torch.Tensor, pos_k: torch.Tensor, *, causal: bool,
         window: int, scale: float, chunk_q: int = 0,
         chunk_kv: int = 0) -> torch.Tensor:
    """Grouped-query attention.  q: [B,Sq,H,hd] with H = KV*G;
    k,v: [B,Tk,KV,hd].  Returns [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)

    if chunk_q > 0 and Sq % chunk_q != 0:
        chunk_q = 0                       # graceful single-block fallback
    if chunk_kv > 0 and k.shape[1] % chunk_kv != 0:
        chunk_kv = 0

    if chunk_q <= 0 or chunk_q >= Sq:
        bias = _mask_bias(pos_q, pos_k, causal, window)
        return attention_block(qg, k, v, bias, scale).reshape(B, Sq, H, hd)

    Tk = k.shape[1]
    use_kv_chunks = 0 < chunk_kv < Tk
    outs = []
    for q0 in range(0, Sq, chunk_q):
        qq = qg[:, q0:q0 + chunk_q]
        pq = pos_q[q0:q0 + chunk_q]
        if not use_kv_chunks:
            bias = _mask_bias(pq, pos_k, causal, window)
            outs.append(attention_block(qq, k, v, bias, scale))
            continue
        # online softmax over kv chunks
        m = torch.full((B, KV, G, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, chunk_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, KV, G, chunk_q, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Tk, chunk_kv):
            kk = k[:, k0:k0 + chunk_kv]
            vv = v[:, k0:k0 + chunk_kv]
            pk = pos_k[k0:k0 + chunk_kv]
            s = torch.einsum("bqkgh,btkh->bkgqt", qq, kk).float()
            s = s * scale + _mask_bias(pq, pk, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", pexp, vv.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(torch.einsum("bkgqh->bqkgh", o).to(q.dtype))
    o = torch.cat(outs, dim=1)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# layer-level entry points


def _on_card(t: torch.Tensor) -> bool:
    """A CUDA tensor, or a ``meta`` one: the dry run's stand-ins trace
    the program the card runs."""
    return t.is_cuda or t.device.type == "meta"


def _use_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """A prefill-form call runs ``flash_attention`` on the card, and on
    either device under autograd (its Function carries the gradient);
    otherwise (the CPU's serving) the reference's ``sdpa``."""
    return _on_card(q) or (torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)))


def _scale(a: AttentionConfig) -> float:
    return a.softmax_scale or 1.0 / math.sqrt(a.head_dim)


def self_attention(p: dict, x: torch.Tensor, a: AttentionConfig,
                   positions: torch.Tensor, *, theta: float, window: int,
                   chunk_q: int = 512, chunk_kv: int = 512,
                   return_kv: bool = False, causal: bool = True):
    """Training / prefill self-attention over the whole sequence;
    ``positions`` is ``arange(S)``."""
    scale = _scale(a)
    q, k, v = qkv_project(p, x, a, positions, theta)
    if _use_flash(q, k, v):
        o = flash_ops.attention(q, k, v, causal=causal, window=window,
                                scale=scale)
    else:
        o = sdpa(q, k, v, positions, positions, causal=causal,
                 window=window, scale=scale, chunk_q=chunk_q,
                 chunk_kv=chunk_kv)
    y = out_project(p, o)
    if return_kv:
        return y, (k, v)
    return y


def position_index(pos: Union[int, torch.Tensor],
                   device: torch.device) -> torch.Tensor:
    """A decode step's position as a [1] long tensor on ``device``: a
    0-d tensor is reshaped (no host read, so a captured graph replays
    it with new values), an int is put there."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1)
    return torch.full((1,), pos, dtype=torch.long, device=device)


def decode_attention(p: dict, x: torch.Tensor, a: AttentionConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *, theta: float,
                     window: int, tile: Optional[Tuple[int, int]] = None):
    """Single-token decode.  x: [B, 1, d]; cache_k/v: [B, L, KV, hd];
    ``pos`` is the index of the new token, an int or a 0-d long tensor
    on x's device (the form a captured CUDA graph replays with new
    values: no host value steers the step).

    The new K/V row is written into the cache IN PLACE (the caller's
    preallocated buffer, usually a view of the stacked cache) — what
    buffer donation buys the reference under ``jit``.  If the cache is
    shorter than the attention span (windowed ring buffer, L <= window
    for a local layer), the write lands at pos % L and per-slot
    positions are rebuilt: slot s holds the newest position p <= pos
    with p % L == s.  ``tile`` pins the projections' spm_matmul tile.
    Returns (y [B,1,d], cache_k, cache_v)."""
    scale = _scale(a)
    positions = position_index(pos, x.device)
    q, k_new, v_new = qkv_project(p, x, a, positions, theta, tile)
    L = cache_k.shape[1]
    is_ring = window > 0 and L <= window
    slot = torch.remainder(positions, L) if is_ring else positions
    cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    s_idx = torch.arange(L, dtype=torch.long, device=x.device)
    if is_ring:
        # newest position in each slot; slots "ahead" of pos wrap to
        # negative and are masked by the causal check in sdpa
        pos_k = positions - torch.remainder(positions - s_idx, L)
    else:
        pos_k = s_idx
    o = sdpa(q, cache_k, cache_v, positions, pos_k, causal=True,
             window=window, scale=scale, chunk_q=0, chunk_kv=0)
    return out_project(p, o, tile), cache_k, cache_v


def cross_attention(p: dict, x: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, a: AttentionConfig, *,
                    decode: bool = False,
                    tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Encoder-decoder cross-attention over precomputed memory K/V
    ([B, T, KV, hd], from ``cross_kv``), with no mask: the whole
    encoder memory is visible.  x: [B, S, d] -> [B, S, d].

    The prefill call on CUDA launches ``flash_attention`` (not causal,
    Sq = S, Sk = T), as does a CPU prefill call under autograd; the
    decode call (``decode``, S = 1) and the other CPU calls run
    ``sdpa``, the reference's form.  ``tile`` pins the q and
    output projections' spm_matmul tile."""
    B, S, d = x.shape
    scale = _scale(a)
    q = linear(x, p["wq"].reshape(d, -1), tile).reshape(
        B, S, a.num_heads, a.head_dim)
    if a.qkv_bias:
        q = q + p["bq"]
    if _use_flash(q, mem_k, mem_v) and not decode:
        o = flash_ops.attention(q, mem_k, mem_v, causal=False, window=0,
                                scale=scale)
    else:
        pos_q = torch.arange(S, dtype=torch.long, device=x.device)
        pos_k = torch.arange(mem_k.shape[1], dtype=torch.long,
                             device=x.device)
        o = sdpa(q, mem_k, mem_v, pos_q, pos_k, causal=False, window=0,
                 scale=scale, chunk_q=0, chunk_kv=0)
    return out_project(p, o, tile)


def cross_kv(p: dict, memory: torch.Tensor, a: AttentionConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output [B, T, d] once into cross-attention
    K/V, each [B, T, KV, hd]."""
    B, T, d = memory.shape

    def proj(w):
        return linear(memory, w.reshape(d, -1)).reshape(
            B, T, a.num_kv_heads, a.head_dim)

    k, v = proj(p["wk"]), proj(p["wv"])
    if a.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v
