"""Plain PyTorch version of flash_attention, written from the
reference's ``kernels/flash_attention/ref.py::attention_ref``: causal
and/or sliding-window GQA attention by head grouping, masked scores at
the finite -1e30, softmax in fp32, p cast to v's dtype before the PV
product.  Products are taken in fp32 (the reference takes them in the
inputs' dtype and casts, which for bf16 rounds the scores first; the
TPU kernel and the CUDA kernel both accumulate in fp32).

The wrapper in ``ops.py`` runs this for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.  ``with_lse=True`` also
returns each row's log-sum-exp of its masked, scaled scores, [B, H, Sq]
fp32, which the CUDA forward writes for the backward.

``attention_block`` is the reference model's attention over one block
(its ``models/attention.py::_block_attn``): products in the inputs'
dtype, softmax in fp32.  ``jax.grad`` of that form is the reference's
attention gradient; the port's ``models.attention.sdpa`` runs it, and
``ops.attention_grad``, the backward's plain version, recomputes it
under autograd for CPU and ``meta`` tensors.

``attention_tc_model`` is the rounding of the CUDA forward's bf16
tensor-core kernel in plain torch (``attention_tc_fp32`` its output
before the final rounding), over the kernel's key tiles
(``core.gpu_mapping.FLASH_TC_KEYS``, 64): its o, its lse and ``o_lo``,
the part of its fp32 output (the PV product taking each p as hi + lo)
that the final bf16 rounding of o drops.

``attention_bwd_tiles`` is the recipe of the CUDA backward
(``csrc/flash_attention_bwd.cu``) written tile by tile in plain torch:
P from the saved log-sum-exp, dS = P (dP - D_i), with the kernel's tile
walk, masks and rounding points; D_i is rowsum(dO * (o + o_lo)) given
the forward's o and o_lo (the ``tensor_core`` kernel's recipe up to head
dim 128), else sum_k P dP (its recipe at 256, and the ``fma``
kernel's), or rowsum(dO * o) given o alone.  The CPU tests hold it to
``jax.grad`` of the reference's ``sdpa`` and to ``attention_grad``.
"""
import math
from typing import Optional

import torch

from repro_torch.core.gpu_mapping import FLASH_TC_KEYS

NEG_INF = -1e30
BLOCK = 64      # the CUDA backward's query and key tiles
LOG2E = 1.4426950408889634


def visible(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """[Sq, Sk] bool: which keys each query may attend to."""
    ok = torch.ones((len(pos_q), len(pos_k)), dtype=torch.bool,
                    device=pos_q.device)
    if causal:
        ok &= pos_k[None, :] <= pos_q[:, None]
    if window > 0:
        ok &= (pos_q[:, None] - pos_k[None, :]) < window
    return ok


def attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float) -> torch.Tensor:
    """The reference model's single-block attention.
    q: [B,Sq,KV,G,hd]; k,v: [B,Tk,KV,hd]; bias: [Sq,Tk] additive fp32
    -> [B,Sq,KV,G,hd] in v's dtype."""
    s = torch.einsum("bqkgh,btkh->bkgqt", q, k).float() * scale
    s = s + bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkh->bqkgh", p.to(v.dtype), v)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None, with_lse: bool = False):
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] -> [B,Sq,H,D]; with ``with_lse``
    also the rows' log-sum-exp [B,H,Sq] fp32."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * scale
    ok = visible(torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    s_max = s.amax(-1, keepdim=True)
    p = torch.exp(s - s_max)
    total = p.sum(-1, keepdim=True)
    p = p / total
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    if not with_lse:
        return o
    lse = (s_max + torch.log(total)).reshape(B, H, Sq)
    return o, lse


def attention_tc_fp32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      block: int = FLASH_TC_KEYS, split_pv: bool = True):
    """(out, full, lse) by the arithmetic of ``csrc/flash_attention.cu``'s
    bf16 tensor-core kernel: fp32 scores scaled by ``scale * log2(e)``,
    masked to -1e30 after that scaling, an online softmax over
    ``block``-key tiles (the kernel's by default) in the log2 domain
    (exp2), each tile's
    unnormalised p rounded to v's dtype before the PV product, the row
    sum kept from the fp32 p: out = acc / max(l, 1e-30) [B,Sq,H,D], which
    the kernel rounds to o; full = (acc + acc_lo) / max(l, 1e-30), acc_lo
    the PV product of what each p's rounding dropped, rounded to v's
    dtype too (the kernel's second product when it writes o_lo; without
    ``split_pv``, full = out); lse = (m + log2 l) ln 2 [B,H,Sq].
    q: [B,Sq,H,D]; k,v: [B,Sk,KV,D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * (scale * LOG2E)
    ok = visible(torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = torch.full(s.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros(s.shape[:-1], device=q.device)
    acc = torch.zeros(*s.shape[:-1], D, device=q.device)
    acc_lo = torch.zeros_like(acc)
    for t0 in range(0, Sk, block):
        st = s[..., t0:t0 + block]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.to(v.dtype).float()
        vt = v[:, t0:t0 + block].float()
        acc = acc * alpha[..., None] + torch.einsum("bkgqt,btkd->bkgqd", hi,
                                                    vt)
        if split_pv:
            acc_lo = acc_lo * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", (p - hi).to(v.dtype).float(), vt)
        m = m_new
    l = torch.clamp(l, min=1e-30)

    def rows(x):
        return (x / l[..., None]).permute(0, 3, 1, 2, 4).reshape(
            B, Sq, H, D).contiguous()

    lse = ((m + torch.log2(l)) * math.log(2.0)).reshape(B, H, Sq)
    return rows(acc), rows(acc + acc_lo), lse


def attention_tc_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       scale: Optional[float] = None,
                       block: int = FLASH_TC_KEYS, split_pv: bool = True):
    """(o, o_lo, lse) of the tensor-core forward: ``attention_tc_fp32``'s
    out rounded once to q's dtype (o), its full output less o rounded to
    q's dtype (``o_lo``, which the kernel writes beside lse for the
    backward's D_i), and its lse."""
    out, full, lse = attention_tc_fp32(q, k, v, causal=causal,
                                       window=window, scale=scale,
                                       block=block, split_pv=split_pv)
    o = out.to(q.dtype)
    return o, (full - o.float()).to(q.dtype), lse


def attention_bwd_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool, window: int, scale: float,
                        block: int = BLOCK,
                        o: Optional[torch.Tensor] = None,
                        o_lo: Optional[torch.Tensor] = None,
                        split_dq: bool = True):
    """(dq, dk, dv) of attention by the CUDA backward's recipe.
    q, do: [B,Sq,H,D]; k, v: [B,Sk,KV,D]; lse: [B,H,Sq] from the
    forward.  In fp32: S = scale q k^T, P = exp(S - lse) (0 where
    masked), dP = dO v^T, D_i, dS = P (dP - D_i); then per (key tile,
    query tile) pair that the mask lets through, dV += P^T dO, dK +=
    dS^T q, dQ += dS k, with P and dS rounded to the inputs' dtype as
    the tensor cores take them (a no-op in fp32), dS for dQ as the sum
    of two such parts (hi and the rounded rest: along a query's row dS
    sums to zero, and one rounding of each term leaves the sum's error
    to rows that see few keys); dQ and dK times ``scale`` at the end,
    each gradient rounded once to its input's dtype.

    D_i is rowsum(dO * (o + o_lo)) in fp32 given the forward's ``o`` and
    ``o_lo`` (``attention_tc_model``'s; the ``tensor_core`` kernel's
    recipe up to head dim 128), rowsum(dO * o) given ``o`` alone (the
    forward's rounded O, as the usual FlashAttention-2 recipe takes it),
    else sum_k P dP from this function's own P and dP (the
    ``tensor_core`` kernel's at head dim 256 and the ``fma`` kernel's).
    ``split_dq`` False rounds dS once for dQ, as FlashAttention-2 does;
    ``tolerance.flash_bwd_main`` reads these recipes side by side."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dt = q.dtype

    def operand(x):
        return x.to(dt).float()

    def split(x):               # hi + lo, each in the inputs' dtype
        hi = operand(x)
        return hi + operand(x - hi)

    qf = q.float().reshape(B, Sq, KV, G, D)
    dof = do.float().reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    lse = lse.float().reshape(B, KV, G, Sq)
    ok = visible(torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, window)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kf) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    if o is None:
        delta = (p * torch.einsum("bqkgd,btkd->bkgqt", dof, vf)).sum(-1)
    else:
        of = o.float() if o_lo is None else o.float() + o_lo.float()
        delta = (do.float() * of).sum(-1).reshape(B, Sq, KV, G)
        delta = delta.permute(0, 2, 3, 1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, Sk, block):
        k1 = min(Sk, k0 + block)
        # the query tiles that may see a key of [k0, k1): causal, none
        # before k0's; a window, none from k1 - 1 + window on
        q_begin = k0 if causal else 0
        q_end = min(Sq, k1 - 1 + window) if window > 0 else Sq
        for q0 in range(q_begin, q_end, block):
            q1 = min(Sq, q0 + block)
            ok = visible(torch.arange(q0, q1, device=q.device),
                         torch.arange(k0, k1, device=q.device), causal,
                         window)
            qt, dot = qf[:, q0:q1], dof[:, q0:q1]
            kt, vt = kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("bqkgd,btkd->bkgqt", qt, kt) * scale
            p = torch.where(ok, torch.exp(s - lse[..., q0:q1, None]), 0.0)
            dp = torch.einsum("bqkgd,btkd->bkgqt", dot, vt)
            ds = p * (dp - delta[..., q0:q1, None])
            dv[:, k0:k1] += torch.einsum("bkgqt,bqkgd->btkd", operand(p), dot)
            dk[:, k0:k1] += torch.einsum("bkgqt,bqkgd->btkd", operand(ds), qt)
            dq[:, q0:q1] += torch.einsum(
                "bkgqt,btkd->bqkgd", split(ds) if split_dq else operand(ds),
                kt)
    return ((dq * scale).reshape(B, Sq, H, D).to(dt), (dk * scale).to(dt),
            dv.to(dt))
