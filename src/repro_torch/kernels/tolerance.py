"""How a kernel is held to its plain version on the card, element by
element, and the CPU model of the kernels' rounding that sized it.

``check(got, want, dtype)`` allows, for every element,

  |got - want| <= ATOL_FRAC * rms(want's row) + RTOL * |want|,

a row being the last axis (one output row of a product, one head's
output for one query).  In bf16, RTOL is 2 ulp of the output, which the
two versions round after differently ordered fp32 sums.  ATOL_FRAC
takes flash_attention's rounding of p to bf16 before the PV product
(the kernel rounds p unnormalised, the plain version after dividing by
the row sum): that error scales with sqrt(sum p^2) * rms(v), as the
row's RMS does, and not with the output element, which can cancel to
~0.  In fp32 both are ``tests/conftest.py::KERNEL_TOLERANCES``' 1e-5.
A check of the largest error against the largest |want| alone (under
3e-2) passed an attention kernel with its scale 1 % off at the serve
prefill shape.

wkv6 in fp32 (its y in an fp32 model, and its fp32 state always)
allows 1e-4 for both terms (``KERNEL_FP32``): a chunked form takes each
decay product as the exp of a difference of cumulative log-decays,
whose rounding grows with the chunk's total decay (|cw| reaches 256 in
the strong-decay case, where an fp32 ulp is 3e-5), while the plain
version multiplies the step decays one by one.  The CPU model of that
arithmetic (``wkv_chunked_direct``) reads 1.3 of the 1e-5 allowance in
the strong-decay case, and its planted faults read over 1e3 of 1e-4.

wkv6's backward (``csrc/wkv6_bwd.cu``) is held gradient by gradient:
dr, dk and dv in r's dtype by the rule above (both versions sum in
fp32 and round once), dw_log and du in fp32 under 1e-4 for both terms
(``KERNEL_FP32["wkv6_bwd"]``), and dw_log with its rows along the
sequence, one per (b, h, channel).  The plain version (autograd
through the exact recurrence) takes dw_t as exp(w_t) <S_{t-1}, dS_t>
with every state kept; the kernel takes it as a reverse cumulative sum
of r.dr - k.dk down each channel of a chunk from the boundary term
<S, dS>.  Those terms are each about <S_t, dS_t>, exp(-w_t) times dw_t,
and cancel: the sum's rounding scales with the channel's terms, not
with the row's dw (at t = 0 the true dw is exactly 0, S_{-1} being 0),
and grows as the decays strengthen.  The CPU models of that arithmetic
(``wkv_bwd_chunked_model``, the ``fma`` kernel's;
``wkv_bwd_cluster_model``, the ``tensor_core`` kernel's, whose products
take tf32 operands split in two parts, since a bf16 hi + lo split reads
0.53 of dw_log's allowance) read 0.02-0.2 of the allowance at the
model's and the reference test's decays, and 1.4-1.7 on dw_log at a
constant decay factor of exp(-4) = 0.018 a step, 30x below the least
the init draws (0.54, ``models/spec.py``): a check at such decays
would need a wider allowance (``python -m
repro_torch.kernels.tolerance``).  The backward's planted faults
(``wkv_bwd_planted_faults``) read over 1e3.

flash_attention's backward (``csrc/flash_attention_bwd.cu``) is held
gradient by gradient (``check_flash_grad``) to its plain version
(``ops.attention_grad``) evaluated in fp32 on the same inputs: dq, dk
and dv each by the rule above in q's dtype; dk and dv with a row per
(key, head), dq with its rows along the sequence, one per (b, head,
dim), as wkv6's dw_log: under the causal mask the first query's row is
exactly 0 (its softmax has one term, so dP = D_i), which the plain
version's softmax backward gives exactly and the kernel only to the
rounding of its D_i.  The plain version in bf16 takes its products in
bf16 (the reference model's block form), so its scores are rounded to
bf16 before the softmax: on the CPU that alone reads 0.55-2.0 of the
allowance against its fp32 evaluation.  The kernels' recipe in plain
torch is ``flash_attention.ref.attention_bwd_tiles`` (P and dS rounded
to bf16 before their products, dS in two bf16 parts for dQ).  Its D_i
must carry fp32 P: the ``tensor_core`` kernel takes D_i = rowsum(dO *
(o + o_lo)), o_lo being the part of the forward's fp32 output, its PV
product taking each p as hi + lo (``ref.attention_tc_model``), that the
bf16 rounding of o drops; at head dim 256 and on ``fma`` D_i = sum_k P
dP from the kernel's own fp32 P and dP.  Both read 0.16-0.21 on dq.  D_i
from the rounded o reads up to 2.39, the usual FlashAttention-2 recipe
(that D_i and one rounding of dS) up to 2.52 on dq under the causal
mask; o + o_lo of a forward whose PV product takes p rounded once reads
0.16-0.50 at S up to 256 but 1.04 at S 4096 (``FLASH_BWD_LONG_CASE``;
1.92 on the card at qwen2's training shape): its output carries sum_k
bf16(p) dP, not sum_k P dP.  The
planted faults (``flash_bwd_planted_faults``: the scale 5 % off, lse
shifted by 0.05, the last key tile dropped) read over 3
(``flash_bwd_main``; ``tests/test_torch_flash_grad.py``).

Run it to print, at the serve prefill shapes on the CPU, the worst error
of the modelled kernels and of planted faults as shares of the
allowance (under 1 passes), and for attention that older reading
(wkv6's model is the one of the kernel each dtype takes on the card,
``wkv_kernel_model``):

  PYTHONPATH=src python -m repro_torch.kernels.tolerance
"""
from __future__ import annotations

import math
from typing import Optional

import torch

RTOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
LOG2E = 1.4426950408889634
ATOL_FRAC = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


# (atol_frac, rtol) of a kernel whose fp32 rounding differs from the rule
KERNEL_FP32 = {"wkv6": 1e-4, "wkv6_bwd": 1e-4}
# wkv6's gradients, in the order the backward returns them
WKV_GRADS = ("dr", "dk", "dv", "dw_log", "du")


def allowance(dtype: torch.dtype, kernel: Optional[str] = None):
    """(atol_frac, rtol) for ``kernel``'s outputs in ``dtype``."""
    if dtype == torch.float32 and kernel in KERNEL_FP32:
        return KERNEL_FP32[kernel], KERNEL_FP32[kernel]
    return ATOL_FRAC[dtype], RTOL[dtype]


def check(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
          kernel: Optional[str] = None):
    """(worst |got - want| as a share of its allowance, max abs err);
    ``got`` passes when the share is below 1."""
    atol_frac, rtol = allowance(dtype, kernel)
    g, w = got.float(), want.float()
    atol = atol_frac * w.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (g - w).abs()
    ratio = (diff / (atol + rtol * w.abs() + 1e-30)).max().item()
    return ratio, diff.max().item()


def check_wkv(got, want, dtype: torch.dtype):
    """``check`` of a wkv6 result (y, state) against its plain version:
    y in its dtype, the state in fp32; the worse of the two."""
    ry, dy = check(got[0], want[0], dtype, "wkv6")
    rs, ds = check(got[1], want[1], torch.float32, "wkv6")
    return max(ry, rs), max(dy, ds)


def check_wkv_grad(got, want, dtype: torch.dtype):
    """``check`` of wkv6's gradients (dr, dk, dv, dw_log, du) against
    the plain version's: dr, dk and dv in ``dtype`` (r's), dw_log and du
    in fp32, under ``wkv6_bwd``'s allowance; dw_log's rows are each
    (b, h, channel)'s sequence.  (worst share, max abs err, {gradient:
    share})."""
    shares, worst_diff = {}, 0.0
    for name, g, w in zip(WKV_GRADS, got, want):
        dt = dtype if name in ("dr", "dk", "dv") else torch.float32
        if name == "dw_log":        # its rows run down the sequence
            g, w = g.movedim(1, -1), w.movedim(1, -1)
        shares[name], diff = check(g, w, dt, "wkv6_bwd")
        worst_diff = max(worst_diff, diff)
    return max(shares.values()), worst_diff, shares


# flash_attention's gradients, in the order the backward returns them
FLASH_GRADS = ("dq", "dk", "dv")


def check_flash_grad(got, want, dtype: torch.dtype):
    """``check`` of flash_attention's (dq, dk, dv) against the plain
    version's, each in ``dtype``; dq with its rows along the sequence,
    one per (b, head, dim).  (worst share, max abs err, {gradient:
    share})."""
    shares, worst_diff = {}, 0.0
    for name, g, w in zip(FLASH_GRADS, got, want):
        if name == "dq":            # its rows run down the sequence
            g, w = g.movedim(1, -1), w.movedim(1, -1)
        shares[name], diff = check(g, w, dtype)
        worst_diff = max(worst_diff, diff)
    return max(shares.values()), worst_diff, shares


def flash_bwd_planted_faults(bwd_fn, q, k, v, lse, do, *, causal: bool,
                             window: int, scale: float,
                             tile: int = 64) -> dict:
    """{name: (dq, dk, dv)}: wrong gradients made from ``bwd_fn`` (the
    backward kernel on the card, ``ref.attention_bwd_tiles`` here; it
    takes q, k, v, lse, do and the keywords causal, window, scale):
    the scale 5 % off (the forward's lse kept); lse shifted by 0.05 (P
    5 % low); the last key tile dropped (the backward over the keys
    before it, that tile's dk and dv left zero)."""
    kw = {"causal": causal, "window": window}
    cut = (k.shape[1] - 1) // tile * tile
    if cut == 0:
        raise ValueError("dropping a key tile needs more than one tile")
    dq, dk, dv = bwd_fn(q, k[:, :cut], v[:, :cut], lse, do, scale=scale,
                        **kw)

    def pad(g):
        return torch.cat([g, torch.zeros_like(g[:, :k.shape[1] - cut])], 1)

    return {
        "scale x1.05": bwd_fn(q, k, v, lse, do, scale=1.05 * scale, **kw),
        "lse shifted by 0.05": bwd_fn(q, k, v, lse + 0.05, do, scale=scale,
                                      **kw),
        "last key tile dropped": (dq, pad(dk), pad(dv)),
    }


def wkv_bwd_planted_faults(bwd_fn, r, k, v, w_log, u, dy, dstate,
                           boundary: int,
                           group_boundary: Optional[int] = None) -> dict:
    """{name: gradients}: wrong wkv6 gradients made from ``bwd_fn`` (the
    backward kernel on the card, a CPU model here).  The adjoint state
    not carried across the chunk boundary at ``boundary`` (the rows
    before it differentiated alone, as if nothing came after them); the
    decay's reverse sum off by one position (dw_t taking the row's own
    r_t (S_{t-1} dy_t), i.e. an inclusive sum where the exclusive one is
    due); du dropped.  Given ``group_boundary`` (the boundary between
    two groups of a cluster), two more there: the forward state not
    carried into the next group (the rows after it differentiated as if
    the state entering them were zero), and the adjoint not carried into
    the previous group (the rows before it as if nothing came after
    them)."""
    full = bwd_fn(r, k, v, w_log, u, dy, dstate)

    def part(sl, ds):
        return bwd_fn(*(a[:, sl].contiguous() for a in (r, k, v, w_log)),
                      u, dy[:, sl].contiguous(), ds)

    def adjoint_cut(at):
        first = part(slice(0, at), None)
        return (*(torch.cat([a, b[:, at:]], 1)
                  for a, b in zip(first[:4], full[:4])), full[4])

    f32 = torch.float32
    g = (dy.to(f32) * v.to(f32)).sum(-1, keepdim=True)
    own = r.to(f32) * (full[0].to(f32) - u * k.to(f32) * g)
    faults = {
        "adjoint not carried across a chunk boundary": adjoint_cut(boundary),
        "dw_log's decay off by one position":
            (*full[:3], full[3] + own, full[4]),
        "du dropped": (*full[:4], torch.zeros_like(full[4])),
    }
    if group_boundary is not None:
        at = group_boundary
        second = part(slice(at, None), dstate)
        faults["state not carried into the next group"] = (
            *(torch.cat([a[:, :at], b], 1)
              for a, b in zip(full[:4], second[:4])), full[4])
        faults["adjoint not carried into the previous group"] = \
            adjoint_cut(at)
    return faults


def wkv_bwd_chunked_model(r, k, v, w_log, u, dy, dstate=None,
                          rows: Optional[int] = None):
    """The arithmetic of ``csrc/wkv6_bwd.cu`` in plain torch, fp32, at
    its chunk (``WKV_BWD_ROWS[K]`` unless ``rows``): the states at the
    chunk boundaries by a forward walk; then backward over the chunks
    with the adjoint dS carried, the pairs' decays exp(e_t - cw_j) taken
    directly, dw by the reverse cumulative sum of r.dr - k.dk from the
    boundary term <S, dS>.  Builds [B, L, L, H, K] per chunk: small
    shapes only.  Returns (dr, dk, dv in r's dtype, dw_log, du)."""
    from repro_torch.core.gpu_mapping import WKV_BWD_ROWS
    f32 = torch.float32
    B, S, H, K = r.shape
    L = rows or WKV_BWD_ROWS[K]
    NC = -(-S // L)

    def chunked(a):
        a = torch.nn.functional.pad(a.to(f32),
                                    (0, 0, 0, 0, 0, NC * L - S))
        return a.reshape(B, NC, L, H, K)

    rc, kc, vc, yc, wc = (chunked(a) for a in (r, k, v, dy, w_log))
    uf = u.to(f32)
    st = torch.zeros(B, H, K, K, dtype=f32, device=r.device)
    saved = []
    for c in range(NC):
        saved.append(st)
        cw = torch.cumsum(wc[:, c], 1)
        kd = kc[:, c] * torch.exp(cw[:, -1:] - cw)
        st = torch.exp(cw[:, -1])[..., None] * st + torch.einsum(
            "bjhk,bjhv->bhkv", kd, vc[:, c])
    saved.append(st)
    ds = (torch.zeros_like(st) if dstate is None
          else dstate.to(f32).clone())
    grads = [torch.zeros(B, NC, L, H, K, dtype=f32, device=r.device)
             for _ in range(4)]
    du = torch.zeros(H, K, dtype=f32, device=r.device)
    later = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                  device=r.device), -1)     # t > j
    for c in reversed(range(NC)):
        rr, kk, vv, yy = rc[:, c], kc[:, c], vc[:, c], yc[:, c]
        cw = torch.cumsum(wc[:, c], 1)
        e, tot = cw - wc[:, c], cw[:, -1]
        q = (saved[c + 1] * ds).sum(-1)
        P = torch.exp(torch.where(later[None, :, :, None, None],
                                  e[:, :, None] - cw[:, None],
                                  float("-inf")))
        A = torch.einsum("bthk,bjhk,btjhk->bhtj", rr, kk, P)
        Bm = torch.einsum("bthv,bjhv->bhtj", yy, vv) * later
        g = (yy * vv).sum(-1, keepdim=True)
        dr = (torch.exp(e) * torch.einsum("bhkv,bthv->bthk", saved[c], yy)
              + torch.einsum("bhtj,bjhk,btjhk->bthk", Bm, kk, P))
        dk = (torch.exp(tot[:, None] - cw)
              * torch.einsum("bhkv,bjhv->bjhk", ds, vv)
              + torch.einsum("bhtj,bthk,btjhk->bjhk", Bm, rr, P))
        kd = kk * torch.exp(tot[:, None] - cw)
        dv = (torch.einsum("bjhk,bhkv->bjhv", kd, ds)
              + torch.einsum("bhtj,bthv->bjhv", A, yy)
              + (rr * uf * kk).sum(-1, keepdim=True) * yy)
        a = rr * dr
        z = a - kk * dk
        grads[3][:, c] = (q[:, None] + torch.flip(torch.cumsum(
            torch.flip(z, [1]), 1), [1]) - a)
        grads[0][:, c] = dr + uf * kk * g
        grads[1][:, c] = dk + uf * rr * g
        grads[2][:, c] = dv
        du += (rr * kk * g).sum((0, 1))
        ds = torch.exp(tot)[..., None] * ds + torch.einsum(
            "bthk,bthv->bhkv", rr * torch.exp(e), yy)
    out = [t.reshape(B, NC * L, H, K)[:, :S] for t in grads]
    return (*(t.to(r.dtype) for t in out[:3]), out[3], du)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """a rounded to tf32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(a: torch.Tensor) -> torch.Tensor:
    """a cut to tf32 (its low 13 mantissa bits cleared: toward zero, as
    the tensor cores read an fp32 register as tf32)."""
    bits = a.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _split_tf32(a: torch.Tensor):
    """a as its tf32 part (big, cut toward zero) and the tf32 part of the
    rest (small, cut the same way): big + small carries about 20 bits of
    each value."""
    big = _tf32_cut(a)
    return big, _tf32_cut(a - big)


def _log2_decay(w_log, rows: int, seg: int):
    """The tensor-core kernels' cumulative log2-decay per ``rows``-row
    chunk, [B, chunks, rows, H, K]: w scaled by log2(e) in fp32, summed
    down each channel in ``seg`` row segments, each segment offset by
    the sums of the ones before it.  Rows past S are zeros."""
    B, S, H, K = w_log.shape
    NC = -(-S // rows)
    w = torch.nn.functional.pad(w_log.float(), (0, 0, 0, 0, 0, NC * rows - S))
    parts = (w.reshape(B, NC, rows, H, K) * LOG2E).reshape(
        B, NC, seg, rows // seg, H, K).cumsum(3)
    lasts = parts[:, :, :, -1]
    return (parts + (lasts.cumsum(2) - lasts)[:, :, :, None]).reshape(
        B, NC, rows, H, K)


def wkv_bwd_cluster_model(r, k, v, w_log, u, dy, dstate=None,
                          rows: Optional[int] = None,
                          cluster: Optional[int] = None,
                          segments: Optional[int] = None):
    """The arithmetic of ``csrc/wkv6_bwd.cu``'s ``tensor_core`` path in
    plain torch, ``rows`` rows a chunk (``WKV_BWD_TC_ROWS[K]`` unless
    given), ``cluster`` chunks a group and ``segments`` of groups for
    the states launch (``ops.bwd_dispatch``'s unless given; within a
    segment the cluster changes no sum).
    r, k, v and dy are taken as exact, as that path reads them (bf16).
    Every operand the kernel builds enters a tensor-core product as its
    tf32 part (big) and the tf32 part of the rest (small), each cut
    toward zero, the product taken as big.big + small.big + big.small
    with fp32 sums
    (against r, k, v or dy, which are exact in tf32: big.exact +
    small.exact); one bf16 rounding of such an operand (a hi + lo pair,
    as the forward keeps) reads up to 0.53 of dw_log's allowance here
    already, since dw sums a chunk's rows of terms that cancel.

    - cw: the cumulative log2-decay of ``_log2_decay``; e is cw one row
      back, total its last row;
    - each chunk's contributions kd^T v (kd = k exp2(total - cw)) and
      (r exp2(e))^T dy;
    - the states launch folds the first in chunk order within each
      segment of groups, X = exp2(total) X + kd^T v from zero with the
      decay product D, keeping (X, D) at each group's start and the
      segment's end; the gradient launch chains the segments, E_{s+1} =
      D_s E_s + X_s, takes the state entering each group as D E + X,
      walks the groups from last to first, folds the state forward from
      that entry (S_in of each chunk) and the adjoint backward
      from the carry of the group after it (dS_out of each chunk; the
      last group's carry is dS_T or zero), both as
      X = exp2(total) X + contribution in fp32, and takes the boundary
      term Q = <S_out, dS_out> per channel;
    - dy v^T from the exact operands, fp32 sums;
    - per 16-row sub-tile pair (I, J < I): dr through J's anchor row a
      (its last): exp2(e_t - cw_a) (dy v^T)[I, J] (k exp2(cw_a - cw))_J;
      dk through I's anchor row b (the row before I):
      exp2(cw_b - cw_j) (dy v^T)[I, J]^T (r exp2(e - cw_b))_I; A as the
      forward's q' k'^T through a;
    - inside the diagonal sub-tiles, in fp32 against dy v^T, the pairs'
      decays exp2(e_t - cw_j) as running products of the step decays
      exp2(cw_q - cw_{q-1}) (dr, dk); A there taken directly inside each
      8-row half (its u bonus r u k on the diagonal) and across the
      halves as the forward's kernel does, through the anchor row between
      them (one tf32 pass);
    - dr += exp2(e) dy S_in^T, dk += exp2(total - cw) v dS_out^T;
      dv = kd dS_out + A^T dy, its products (and A's off the diagonal)
      in one tf32 pass, big.big: dv is held to r's dtype, which a tf32
      rounding (2^-11) meets;
    - dw_log = Q + the reverse cumulative sum of r dr - k dk down the
      chunk minus r dr; du summed over every row.

    Every exponent taken is <= 0.  Rows past S are zeros, as the kernel
    reads them.  Returns (dr, dk, dv in r's dtype, dw_log, du)."""
    from repro_torch.core.gpu_mapping import (WKV_BWD_TC_ROWS,
                                              WKV_BWD_THREADS)
    from repro_torch.kernels.wkv6 import ops
    f32 = torch.float32
    B, S, H, K = r.shape
    L = rows or WKV_BWD_TC_ROWS[K]
    NC = -(-S // L)
    route = ops.bwd_dispatch(S, K, torch.bfloat16, True, B * H)
    cs = min(cluster or route["cluster"], NC)
    groups = -(-NC // cs)
    T = L // 16

    def chunked(a):
        a = torch.nn.functional.pad(a.to(f32), (0, 0, 0, 0, 0, NC * L - S))
        return a.reshape(B, NC, L, H, K)

    split = _split_tf32
    rc, kc, vc, yc = (chunked(a) for a in (r, k, v, dy))
    cw = _log2_decay(w_log, L, WKV_BWD_THREADS // K)
    e = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]], 2)
    tot = cw[:, :, -1]
    dec = torch.exp2(tot)[..., None]                      # [B,NC,H,K,1]
    kdec = torch.exp2(tot[:, :, None] - cw)
    kd_h, kd_l = split(kc * kdec)
    rq_h, rq_l = split(rc * torch.exp2(e))
    dsc = sum(torch.einsum("bnthk,bnthv->bnhkv", x, vc) for x in (kd_h, kd_l))
    dac = sum(torch.einsum("bnthk,bnthv->bnhkv", x, yc) for x in (rq_h, rq_l))

    # the states launch: per segment of groups, the fold from its start
    # (X, and the decay product D) at each group's start and at its end;
    # the state entering a segment E_{s+1} = D_s E_s + X_s, and entering
    # a group D E + X
    per = -(-groups // min(groups, segments or route["segments"]))
    E = torch.zeros(B, H, K, K, dtype=f32)
    entry = []
    for g0 in range(0, groups, per):
        X = torch.zeros(B, H, K, K, dtype=f32)
        D = torch.ones(B, H, K, 1, dtype=f32)
        for g in range(g0, min(groups, g0 + per)):
            entry.append(D * E + X)
            for c in range(g * cs, min(NC, (g + 1) * cs)):
                X = dec[:, c] * X + dsc[:, c]
                D = D * dec[:, c]
        E = D * E + X
    # the gradient launch: groups from last to first, both folds
    s_in, d_out, q = [None] * NC, [None] * NC, [None] * NC
    ad = (torch.zeros(B, H, K, K, dtype=f32) if dstate is None
          else dstate.to(f32))
    for g in reversed(range(groups)):
        ranks = range(g * cs, min(NC, (g + 1) * cs))
        st = entry[g]
        outs = []
        for c in ranks:
            s_in[c] = st
            st = dec[:, c] * st + dsc[:, c]
            outs.append(st)
        for c in reversed(ranks):
            d_out[c] = ad
            ad = dec[:, c] * ad + dac[:, c]
        for c, s_out in zip(ranks, outs):
            q[c] = (s_out * d_out[c]).sum(-1)
    sh, sl = split(torch.stack(s_in, 1))
    dh, dl = split(torch.stack(d_out, 1))
    Q = torch.stack(q, 1)                                 # [B,NC,H,K]

    bm = torch.einsum("bnthv,bnjhv->bnhtj", yc, vc)
    bh, bl = split(bm)
    drp = torch.exp2(e) * sum(torch.einsum("bnthv,bnhkv->bnthk", yc, x)
                              for x in (sh, sl))
    dkp = kdec * sum(torch.einsum("bnjhv,bnhkv->bnjhk", vc, x)
                     for x in (dh, dl))
    A = torch.zeros(B, NC, H, L, L, dtype=f32)
    tri = torch.tril(torch.ones(16, 16, dtype=torch.bool), -1)[:, :, None,
                                                                 None]
    halves = torch.zeros(16, 16, 1, 1)
    halves[:8, :8] = halves[8:, 8:] = 1.0
    for d in range(T):          # inside the diagonal sub-tiles, directly
        s = slice(16 * d, 16 * d + 16)
        expo = e[:, :, s, None] - cw[:, :, None, s]       # [B,NC,t,j,H,K]
        P = torch.where(tri, torch.exp2(torch.where(tri, expo, 0.0)), 0.0)
        # dr's and dk's pair decays as running products of the step decays
        # exp2(cw_q - cw_{q-1}), from j = t - 1 (1) down
        steps = torch.exp2(cw[:, :, s][:, :, 1:] - cw[:, :, s][:, :, :-1])
        Pp = torch.zeros_like(P)
        for tl in range(1, 16):
            run = torch.cumprod(torch.flip(steps[:, :, :tl - 1], [2]), 2)
            Pp[:, :, tl, :tl] = torch.flip(torch.cat(
                [torch.ones_like(steps[:, :, :1]), run], 2), [2])
        bd = bm[..., s, s]
        drp[:, :, s] += torch.einsum("bnhtj,bnjhk,bntjhk->bnthk", bd,
                                     kc[:, :, s], Pp)
        dkp[:, :, s] += torch.einsum("bnhtj,bnthk,bntjhk->bnjhk", bd,
                                     rc[:, :, s], Pp)
        bonus = torch.einsum("bnthk,hk,bnthk->bnht", rc[:, :, s], u.to(f32),
                             kc[:, :, s])
        # A: directly inside each 8-row half; across the halves through
        # the anchor row a between them, one tf32 pass
        A[..., s, s] = torch.einsum("bnthk,bnjhk,bntjhk->bnhtj", rc[:, :, s],
                                    kc[:, :, s], P * halves) \
            + torch.diag_embed(bonus)
        a, lo, hi = 16 * d + 7, slice(16 * d, 16 * d + 8), \
            slice(16 * d + 8, 16 * d + 16)
        A[..., hi, lo] = torch.einsum(
            "bnthk,bnjhk->bnhtj",
            _tf32(rc[:, :, hi] * torch.exp2(e[:, :, hi] - cw[:, :, a, None])),
            _tf32(kc[:, :, lo] * torch.exp2(cw[:, :, a, None] - cw[:, :, lo])))
    for i in range(1, T):       # sub-tile pairs, through anchor rows
        ti = slice(16 * i, 16 * i + 16)
        b = 16 * i - 1
        rt_h, rt_l = split(rc[:, :, ti] * torch.exp2(e[:, :, ti]
                                                     - cw[:, :, b, None]))
        for j in range(i):
            tj = slice(16 * j, 16 * j + 16)
            a = 16 * j + 15
            kp_h, kp_l = split(kc[:, :, tj] * torch.exp2(cw[:, :, a, None]
                                                         - cw[:, :, tj]))
            pairs = ((bh, kp_h), (bl, kp_h), (bh, kp_l))
            drp[:, :, ti] += torch.exp2(e[:, :, ti] - cw[:, :, a, None]) * sum(
                torch.einsum("bnhtj,bnjhk->bnthk", x[..., ti, tj], z)
                for x, z in pairs)
            pairs = ((bh, rt_h), (bl, rt_h), (bh, rt_l))
            dkp[:, :, tj] += torch.exp2(cw[:, :, b, None] - cw[:, :, tj]) * sum(
                torch.einsum("bnhtj,bnthk->bnjhk", x[..., ti, tj], z)
                for x, z in pairs)
            qp = _tf32(rc[:, :, ti] * torch.exp2(e[:, :, ti]
                                                 - cw[:, :, a, None]))
            A[..., ti, tj] = torch.einsum("bnthk,bnjhk->bnhtj", qp, kp_h)
    # dv alone reads A, and dv is held to r's dtype: one tf32 pass
    dv = (torch.einsum("bnjhk,bnhkv->bnjhv", kd_h, dh)
          + torch.einsum("bnhtj,bnthv->bnjhv", _tf32(A), yc))
    g = (yc * vc).sum(-1, keepdim=True)
    a_ = rc * drp
    z = a_ - kc * dkp
    dw = (Q[:, :, None] + torch.flip(torch.cumsum(torch.flip(z, [2]), 2),
                                     [2]) - a_)
    uf = u.to(f32)
    out = [t.reshape(B, NC * L, H, K)[:, :S]
           for t in (drp + uf * kc * g, dkp + uf * rc * g, dv, dw)]
    du = (rc * kc * g).sum((0, 1, 2))
    return (*(t.to(r.dtype) for t in out[:3]), out[3], du)


def wkv_chunked_direct(r, k, v, w_log, u, chunk: int):
    """The chunked arithmetic of ``csrc/wkv6.cu`` in plain torch, fp32:
    per chunk the inclusive cumulative log-decay cw, e = cw - w, the
    intra-chunk pairs' decay exp(e_t - cw_j) taken directly, the state
    read through r * exp(e) and updated by exp(total) and
    k * exp(total - cw).  (The kernel factors the pairs' decay through
    an anchor row per tile; the rounding of the exponents, the term that
    grows with the decay, is the same.)  Builds [B, L, L, H, K] per
    chunk: small shapes only."""
    B, S, H, K = r.shape
    f32 = torch.float32
    s = torch.zeros(B, H, K, K, dtype=f32, device=r.device)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk].to(f32)
                          for a in (r, k, v, w_log))
        n = rc.shape[1]
        cw = torch.cumsum(wc, 1)
        e = cw - wc
        tot = cw[:, -1]
        tri = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                    device=r.device), -1)[None, :, :,
                                                          None, None]
        seg = torch.where(tri, e[:, :, None] - cw[:, None, :], 0.0)
        P = torch.where(tri, torch.exp(seg), 0.0)
        A = torch.einsum("bthk,bjhk,btjhk->bhtj", rc, kc, P)
        y = torch.einsum("bhtj,bjhv->bthv", A, vc)
        y = y + torch.einsum("bthk,hk,bthk->bth", rc, u.to(f32),
                             kc)[..., None] * vc
        y = y + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(e), s)
        kd = kc * torch.exp(tot[:, None] - cw)
        s = s * torch.exp(tot)[..., None] + torch.einsum(
            "bjhk,bjhv->bhkv", kd, vc)
        ys.append(y)
    return torch.cat(ys, 1).to(r.dtype), s


def wkv_cluster_model(r, k, v, w_log, u, rows: int):
    """The rounding of ``csrc/wkv6.cu``'s bf16 ``tensor_core`` kernel in
    plain torch, ``rows`` rows per block:

    - w scaled by log2(e) (in fp32), summed down each channel in
      ``WKV_TC_THREADS // K`` row segments, each segment offset by the sums of
      the ones before it (cw, log2 units); e is cw one row back;
    - A per 16-row sub-tile pair: inside each 8-row half of a diagonal
      sub-tile in fp32 with exp2(e_t - cw_s) taken directly and the u
      bonus r u k on the diagonal; off it, through the anchor a (the
      last row of sub-tile j, or of the first half for the second half's
      rows of a diagonal sub-tile), q' = r exp2(e_t - cw_a) and
      k' = k exp2(cw_a - cw_s);
    - every operand the kernel makes for the tensor cores (q', k', A,
      r exp2(e), kd = k exp2(total - cw), S_in) split as a bf16 hi part
      and the bf16 rounding of the rest, each product taken as
      hi.hi + lo.hi + hi.lo in fp32 (hi + lo against r, k and v, which
      are exact in bf16);
    - the incoming state of each chunk folded in chunk order,
      S = exp2(total) S + dS, in fp32 (the cluster's rank order and its
      groups add in the same order);
    - y = A v + (r exp2(e)) S_in summed in fp32, rounded to r's dtype.

    Rows past S are zeros, as the kernel reads them.  Returns (y, final
    state in fp32)."""
    import torch.nn.functional as F

    from repro_torch.core.gpu_mapping import WKV_TC_THREADS

    B, S, H, K = r.shape
    f32, bf = torch.float32, torch.bfloat16
    NC = -(-S // rows)
    T = rows // 16

    def chunks(a):
        a = F.pad(a.to(f32), (0, 0, 0, 0, 0, NC * rows - S))
        return a.reshape(B, NC, rows, H, K)

    def split(a):
        """a as its bf16 rounding and the bf16 rounding of the rest."""
        hi = a.to(bf).to(f32)
        return hi, (a - hi).to(bf).to(f32)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    seg = WKV_TC_THREADS // K
    parts = (chunks(w_log) * LOG2E).reshape(B, NC, seg, rows // seg, H,
                                            K).cumsum(3)
    lasts = parts[:, :, :, -1]
    cw = (parts + (lasts.cumsum(2) - lasts)[:, :, :, None]).reshape(
        B, NC, rows, H, K)
    e = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]], 2)
    tot = cw[:, :, -1]
    uu = u.to(f32)
    A = torch.zeros(B, NC, H, rows, rows)
    tri = torch.tril(torch.ones(8, 8, dtype=torch.bool), -1)[:, :, None,
                                                               None]

    def anchored(ti, tj, a):
        """A[ti, tj] through the anchor row a, hi/lo operands."""
        qh, ql = split(rc[:, :, ti] * torch.exp2(e[:, :, ti]
                                                 - cw[:, :, a, None]))
        kh, kl = split(kc[:, :, tj] * torch.exp2(cw[:, :, a, None]
                                                 - cw[:, :, tj]))
        return sum(torch.einsum("bnthk,bnshk->bnhts", x, z)
                   for x, z in ((qh, kh), (ql, kh), (qh, kl)))

    for h8 in range(2 * T):     # inside each 8-row half, directly
        th = slice(8 * h8, 8 * h8 + 8)
        expo = e[:, :, th, None] - cw[:, :, None, th]   # [B,NC,t,s,H,K]
        P = torch.where(tri, torch.exp2(torch.where(tri, expo, 0.0)), 0.0)
        Ad = torch.einsum("bnthk,bnshk,bntshk->bnhts", rc[:, :, th],
                          kc[:, :, th], P)
        bonus = torch.einsum("bnthk,hk,bnthk->bnht", rc[:, :, th], uu,
                             kc[:, :, th])
        A[..., th, th] = Ad + torch.diag_embed(bonus)
    for i in range(T):
        A[..., 16 * i + 8:16 * i + 16, 16 * i:16 * i + 8] = anchored(
            slice(16 * i + 8, 16 * i + 16), slice(16 * i, 16 * i + 8),
            16 * i + 7)
        for j in range(i):
            A[..., 16 * i:16 * i + 16, 16 * j:16 * j + 16] = anchored(
                slice(16 * i, 16 * i + 16), slice(16 * j, 16 * j + 16),
                16 * j + 15)
    y = sum(torch.einsum("bnhts,bnshv->bnthv", x, vc) for x in split(A))
    rq_hi, rq_lo = split(rc * torch.exp2(e))
    dS = sum(torch.einsum("bnthk,bnthv->bnhkv", x, vc)
             for x in split(kc * torch.exp2(tot[:, :, None] - cw)))
    dec = torch.exp2(tot)
    st = torch.zeros(B, H, K, K)
    s_in = []
    for c in range(NC):
        s_in.append(st)
        st = dec[:, c, :, :, None] * st + dS[:, c]
    s_hi, s_lo = split(torch.stack(s_in, 1))
    y = y + sum(torch.einsum("bnthk,bnhkv->bnthv", x, z)
                for x, z in ((rq_hi, s_hi), (rq_hi, s_lo), (rq_lo, s_hi)))
    return y.reshape(B, NC * rows, H, K)[:, :S].to(r.dtype), st


def wkv_kernel_model(r, k, v, w_log, u, chunk=None):
    """The CPU model of the kernel ``ops.wkv`` launches for these
    operands on the card (aligned, contiguous): ``wkv_cluster_model`` at
    the ``tensor_core`` path's rows for bf16, ``wkv_chunked_direct`` at
    the ``fma`` path's chunk for fp32."""
    from repro_torch.kernels.wkv6 import ops
    S, K = r.shape[1], r.shape[3]
    route = ops.dispatch(S, K, r.dtype, True, chunk)
    if route["path"] == "tensor_core":
        return wkv_cluster_model(r, k, v, w_log, u, route["rows"])
    return wkv_chunked_direct(r, k, v, w_log, u, route["rows"])


def wkv_planted_faults(wkv_fn, r, k, v, w_log, u, boundary: int,
                       group_boundary: Optional[int] = None) -> dict:
    """{name: (y, state)}: wrong wkv6 results made by running ``wkv_fn``
    (the kernel on the card, a CPU model here) on altered inputs.  The u
    bonus dropped (u = 0); the state not carried across the chunk
    boundary at ``boundary`` (the two parts run apart), and, given
    ``group_boundary``, across that one too (the boundary between two
    groups of a cluster); the decay off by one position (the read
    r_t S_{t-1} decayed by the step's own w_t, i.e. an inclusive
    cumulative sum where the kernel takes the exclusive one: r exp(w)
    with u = 0, plus the u bonus)."""
    def part(sl):
        return [a[:, sl].contiguous() for a in (r, k, v, w_log)]

    def not_carried(at):
        first = wkv_fn(*part(slice(0, at)), u)
        second = wkv_fn(*part(slice(at, None)), u)
        return torch.cat([first[0], second[0]], 1), second[1]

    zero_u = torch.zeros_like(u)
    late = wkv_fn((r.float() * torch.exp(w_log)).to(r.dtype), k, v, w_log,
                  zero_u)
    bonus = torch.einsum("bthk,hk,bthk->bth", r.float(), u,
                         k.float())[..., None] * v.float()
    faults = {
        "u bonus dropped": wkv_fn(r, k, v, w_log, zero_u),
        "state not carried across a chunk boundary": not_carried(boundary),
        "decay off by one position":
            ((late[0].float() + bonus).to(r.dtype), late[1]),
    }
    if group_boundary is not None:
        faults["state not carried across a cluster group boundary"] = \
            not_carried(group_boundary)
    return faults


def wkv_inputs(B, S, H, K, dtype, decay, gen, device="cpu"):
    """Seeded wkv6 inputs: r, k, v ~ N(0, 0.25) in ``dtype``, u ~
    N(0, 0.09), and w_log by ``decay``: "model" as the model makes it at
    its random init (-exp(w0 + eps), w0 uniform in [-2.5, -0.5], eps ~
    N(0, 0.09)), "strong" the constant -4, "reference" the reference
    test's -exp(0.8 N - 2)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    r, k, v = (0.5 * randn(B, S, H, K) for _ in range(3))
    if decay == "model":
        w0 = -0.5 - 2.0 * torch.rand(H, K, generator=gen, device=device)
        w_log = -torch.exp(w0 + 0.3 * randn(B, S, H, K))
    elif decay == "strong":
        w_log = torch.full((B, S, H, K), -4.0, device=device)
    else:
        w_log = -torch.exp(0.8 * randn(B, S, H, K) - 2.0)
    u = 0.3 * randn(H, K)
    return r.to(dtype), k.to(dtype), v.to(dtype), w_log, u


def flash_kernel_rounding(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, scale: Optional[float] = None,
                          tile: int = 64) -> torch.Tensor:
    """The rounding of ``csrc/flash_attention.cu``'s bf16 tensor-core
    kernel in plain torch (``flash_attention.ref.attention_tc_model``,
    whose o this is), over ``tile``-key tiles (the kernel's 64 by
    default).  q: [B,S,H,D]; k,v: [B,S,KV,D] -> [B,S,H,D] in q's
    dtype."""
    from repro_torch.kernels.flash_attention.ref import attention_tc_model
    return attention_tc_model(q, k, v, causal=causal, window=window,
                              scale=scale, block=tile)[0]


def matmul_split_model(a: torch.Tensor, b: torch.Tensor, rows: int, *,
                       trans_b: bool = False,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """The summation of ``csrc/spm_matmul.cu``'s split-K paths in plain
    torch: an fp32 partial product per ``rows``-deep slice of K (the
    last one ragged), the partials added in rank order from zero, the
    sum rounded once to ``out_dtype`` (A's dtype by default)."""
    bb = (b.t() if trans_b else b).float()
    af = a.float()
    total = torch.zeros(a.shape[0], bb.shape[1])
    for k0 in range(0, a.shape[1], rows):
        total = total + af[:, k0:k0 + rows] @ bb[k0:k0 + rows]
    return total.to(out_dtype or a.dtype)


def kernel_split_rows(m: int, k: int, n: int, trans_b: bool = False) -> int:
    """The K slice one block of the bf16 kernel ``ops.dispatch`` picks
    for this shape sums (all of K when it does not split)."""
    from repro_torch.kernels.spm_matmul import ops
    route = ops.dispatch(m, k, n, torch.bfloat16, trans_b, True)
    if route["path"] == "splitk":
        return route["ks"]
    if route["path"] == "wgmma":
        return route["kb_per"] * ops.WGMMA_BK
    return k


def main() -> None:
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.spm_matmul.ref import matmul_ref

    bf = torch.bfloat16
    torch.manual_seed(0)
    q = torch.randn(4, 256, 14, 64).to(bf)
    k = torch.randn(4, 256, 2, 64).to(bf)
    v = torch.randn(4, 256, 2, 64).to(bf)
    for kw in ({}, {"window": 64}, {"causal": False}):
        want = attention_ref(q, k, v, **kw)
        got = {name: flash_kernel_rounding(q, k, v, scale=sc, **kw)
               for name, sc in (("modelled kernel", None),
                                ("scale x1.05", 1.05 / 8),
                                ("scale x1.01", 1.01 / 8))}
        if not kw:       # rows 192.. lose the last 64-key tile
            late = attention_ref(q[:, 192:], k[:, :192], v[:, :192],
                                 causal=False)
            got["last kv tile dropped on rows >= 192"] = torch.cat(
                [want[:, :192], late], 1)
        top = want.float().abs().max().item()
        print(f"flash_attention B4 S256 H14 KV2 D64 {kw or 'causal'} "
              f"(max |want| {top:.3f}, rms "
              f"{want.float().pow(2).mean().sqrt().item():.3f}): "
              + ", ".join(f"{name} {check(g, want, bf)[0]:.3f} (max err / "
                          f"max |want| {check(g, want, bf)[1] / top:.2e})"
                          for name, g in got.items()))
    # gemma3's head dim at its serve length, global and local layers
    q = torch.randn(1, 2048, 2, 256).to(bf)
    k = torch.randn(1, 2048, 1, 256).to(bf)
    v = torch.randn(1, 2048, 1, 256).to(bf)
    for window in (0, 1024):
        want = attention_ref(q, k, v, window=window)
        share = {name: check(flash_kernel_rounding(q, k, v, window=window,
                                                   scale=sc), want, bf)[0]
                 for name, sc in (("modelled kernel", None),
                                  ("scale x1.05", 1.05 / 16))}
        print(f"flash_attention B1 S2048 H2 KV1 D256 window {window}: "
              + ", ".join(f"{name} {r:.3f}" for name, r in share.items()))
    for m, kk, n in ((4, 4864, 896), (4, 896, 896), (1024, 896, 896),
                     (4, 896, 4864)):
        a = torch.randn(m, kk).to(bf)
        b = (torch.randn(kk, n) / math.sqrt(kk)).to(bf)
        want = matmul_ref(a, b)
        rows = kernel_split_rows(m, kk, n)
        split = matmul_split_model(a, b, rows)
        dropped = a.clone()
        dropped[:, -16:] = 0
        share = {f"split-K sum ({rows}-deep slices)":
                     check(split, want, bf)[0],
                 "one 16-deep K step dropped":
                     check(matmul_ref(dropped, b), want, bf)[0],
                 "output x1.05":
                     check((want.float() * 1.05).to(bf), want, bf)[0]}
        print(f"spm_matmul {m}x{kk}x{n}: "
              + ", ".join(f"{name} {r:.3f}" for name, r in share.items()))


def wkv_main() -> None:
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    gen = torch.Generator().manual_seed(0)
    for B, S, H, K, chunk, dt, decay in (
            (4, 256, 32, 64, 256, torch.bfloat16, "model"),
            (1, 256, 2, 64, 256, torch.bfloat16, "strong"),
            (1, 2048, 8, 64, 256, torch.bfloat16, "model"),
            (2, 256, 4, 128, 128, torch.bfloat16, "model"),
            (1, 256, 2, 64, None, torch.float32, "strong"),
            (1, 64, 2, 32, 32, torch.float32, "reference"),
            (2, 64, 2, 64, 32, torch.float32, "reference")):
        args = wkv_inputs(B, S, H, K, dt, decay, gen)
        want = wkv6_ref(*args)
        route = ops.dispatch(S, K, dt, True, chunk)

        def model(*a):
            return wkv_kernel_model(*a, chunk=chunk)

        faults = wkv_planted_faults(model, *args, route["rows"])
        print(f"wkv6 B{B} S{S} H{H} K{K} {str(dt)[6:]} {decay} decay, "
              f"{route['path']} path, {route['rows']} rows a block, "
              f"cluster {route['cluster']} x {route['groups']} groups: "
              f"modelled kernel {check_wkv(model(*args), want, dt)[0]:.3f}, "
              + ", ".join(f"{name} {check_wkv(got, want, dt)[0]:.1f}"
                          for name, got in faults.items()))


def wkv_bwd_main() -> None:
    from repro_torch.core.gpu_mapping import WKV_BWD_ROWS
    from repro_torch.kernels.wkv6 import ops

    gen = torch.Generator().manual_seed(0)
    for B, S, H, K, dt, decay, with_ds in (
            (1, 256, 4, 64, torch.bfloat16, "model", False),
            (1, 600, 2, 64, torch.bfloat16, "model", True),
            (1, 100, 2, 64, torch.float32, "model", True),
            (1, 128, 2, 64, torch.float32, "strong", True),
            (1, 64, 2, 32, torch.float32, "reference", False),
            (1, 64, 2, 128, torch.float32, "model", True),
            (1, 200, 1, 128, torch.bfloat16, "model", True)):
        args = wkv_inputs(B, S, H, K, dt, decay, gen)
        dy = torch.randn(B, S, H, K, generator=gen).to(dt)
        ds = (0.1 * torch.randn(B, H, K, K, generator=gen) if with_ds
              else None)
        want = ops.wkv_grad_plain(*args, dy, ds)
        tc = ops.bwd_dispatch(S, K, torch.bfloat16, True, B * H)
        group = tc["rows"] * tc["cluster"] if tc["groups"] > 1 else None
        # each path's model: the fma kernel's for every dtype, the
        # tensor-core kernel's for bf16 (the only operands it takes)
        models = [("fma", wkv_bwd_chunked_model, WKV_BWD_ROWS[K])]
        if dt == torch.bfloat16:
            models.append(("tensor_core", wkv_bwd_cluster_model, tc["rows"]))
        for path, model, L in models:
            worst, _, shares = check_wkv_grad(model(*args, dy, ds), want, dt)
            faults = wkv_bwd_planted_faults(model, *args, dy, ds,
                                            L if S > L else S // 2, group)
            print(f"wkv6 backward B{B} S{S} H{H} K{K} {str(dt)[6:]} {decay} "
                  f"decay, dS_T {'given' if with_ds else 'zero'}, {path} "
                  f"model ({L}-row chunks"
                  + (f", cluster {tc['cluster']} x {tc['groups']} groups"
                     if path == "tensor_core" else "")
                  + f"): {worst:.3f} ("
                  + ", ".join(f"{n} {v:.3f}" for n, v in shares.items())
                  + "), " + ", ".join(
                      f"{name} {check_wkv_grad(f, want, dt)[0]:.1f}"
                      for name, f in faults.items()))


FLASH_BWD_MAIN_CASES = (  # (B, Sq, Sk, H, KV, D, causal, window)
    (1, 192, 192, 7, 1, 64, True, 0), (1, 160, 160, 4, 2, 32, True, 48),
    (1, 96, 200, 4, 4, 112, False, 0), (1, 256, 256, 7, 1, 64, True, 0),
    (1, 256, 256, 14, 2, 64, True, 0))     # the last: qwen2's group
# qwen2's training sequence at two heads of one group (the CPU's memory)
FLASH_BWD_LONG_CASE = (1, 4096, 4096, 2, 1, 64, True, 0)


def flash_bwd_readings(B, Sq, Sk, H, KV, D, causal, window) -> dict:
    """At one case of ``FLASH_BWD_MAIN_CASES`` (bf16 inputs from numpy's
    seed Sq + D), against ``attention_grad`` evaluated in fp32 on the
    same inputs: {recipe: {gradient: share of the allowance}} for the
    plain version itself in bf16; the kernels' recipes, D_i from the
    tensor-core forward's o + o_lo (``ref.attention_tc_model`` over the
    forward kernel's key tiles, its PV product taking each p as hi + lo)
    and D_i = sum P dP; D_i from o +
    o_lo of a forward whose PV product takes p rounded once (tried and
    not taken: it misses dq at S 4096); D_i from the rounded o; and the
    usual FlashAttention-2 recipe (that D_i and one bf16 rounding of dS
    for dQ); and {fault: worst share} of the planted faults on the
    tensor-core recipe."""
    import numpy as np

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_tiles,
                                                         attention_tc_model)
    bf = torch.bfloat16
    rng = np.random.default_rng(Sq + D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(bf) for shape in ((B, Sq, H, D), (B, Sk, KV, D),
                                          (B, Sk, KV, D), (B, Sq, H, D)))
    kw = {"causal": causal, "window": window, "scale": D ** -0.5}
    want = ops.attention_grad(*(t.float() for t in (q, k, v, do)), **kw)
    o, o_lo, lse = attention_tc_model(q, k, v, **kw)
    _, o_lo1, _ = attention_tc_model(q, k, v, split_pv=False, **kw)

    def recipe(*a, **k):
        return attention_bwd_tiles(*a, o=o, o_lo=o_lo, **k)

    read = {
        "plain in bf16": ops.attention_grad(q, k, v, do, **kw),
        "D_i from o + o_lo": recipe(q, k, v, lse, do, **kw),
        "D_i = sum P dP": attention_bwd_tiles(q, k, v, lse, do, **kw),
        "o_lo of PV unsplit": attention_bwd_tiles(q, k, v, lse, do, o=o,
                                                  o_lo=o_lo1, **kw),
        "D_i from o": attention_bwd_tiles(q, k, v, lse, do, o=o, **kw),
        "FA2 recipe": attention_bwd_tiles(q, k, v, lse, do, o=o,
                                          split_dq=False, **kw)}
    faults = flash_bwd_planted_faults(recipe, q, k, v, lse, do, **kw)
    return ({name: check_flash_grad(g, want, bf)[2]
             for name, g in read.items()},
            {name: check_flash_grad(g, want, bf)[0]
             for name, g in faults.items()})


def flash_bwd_main() -> None:
    """flash_attention's backward on the CPU, bf16: ``flash_bwd_readings``
    at every case of ``FLASH_BWD_MAIN_CASES`` and ``FLASH_BWD_LONG_CASE``
    (the check ``chip_smoke.py`` holds the kernel to)."""
    for case in FLASH_BWD_MAIN_CASES + (FLASH_BWD_LONG_CASE,):
        B, Sq, Sk, H, KV, D, causal, window = case
        read, faults = flash_bwd_readings(*case)
        print(f"flash backward B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} D{D} causal="
              f"{causal} window {window} bf16, against attention_grad in "
              f"fp32: " + ", ".join(
                  f"{name} " + "/".join(f"{r:.3f}" for r in shares.values())
                  + " (dq/dk/dv)" for name, shares in read.items())
              + "; faults " + ", ".join(f"{name} {r:.1f}"
                                        for name, r in faults.items()))


if __name__ == "__main__":
    main()
    wkv_main()
    wkv_bwd_main()
    flash_bwd_main()
