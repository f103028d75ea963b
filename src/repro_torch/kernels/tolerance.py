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

Run it to print, at the serve prefill shapes on the CPU, the worst error
of the modelled kernels and of planted faults as shares of the
allowance (under 1 passes), and for attention that older reading:

  PYTHONPATH=src python -m repro_torch.kernels.tolerance
"""
from __future__ import annotations

import math
from typing import Optional

import torch

RTOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
ATOL_FRAC = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def check(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype):
    """(worst |got - want| as a share of its allowance, max abs err);
    ``got`` passes when the share is below 1."""
    g, w = got.float(), want.float()
    atol = ATOL_FRAC[dtype] * w.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (g - w).abs()
    ratio = (diff / (atol + RTOL[dtype] * w.abs() + 1e-30)).max().item()
    return ratio, diff.max().item()


def flash_kernel_rounding(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, scale: Optional[float] = None,
                          tile: int = 64) -> torch.Tensor:
    """The rounding of ``csrc/flash_attention.cu`` in plain torch: an
    online softmax over ``tile``-key tiles in fp32, each tile's
    unnormalised p rounded to v's dtype before the PV product, the row
    sum kept from the fp32 p, the output divided once at the end.
    q: [B,S,H,D]; k,v: [B,S,KV,D] -> [B,S,H,D] in q's dtype."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * scale
    pos_q = torch.arange(S)[:, None]
    pos_k = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= pos_k <= pos_q
    if window > 0:
        ok &= (pos_q - pos_k) < window
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], D)
    for t0 in range(0, S, tile):
        st = s[..., t0:t0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(v.dtype).float(),
            v[:, t0:t0 + tile].float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


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
    for m, kk, n in ((4, 4864, 896), (4, 896, 896), (1024, 896, 896),
                     (4, 896, 4864)):
        a = torch.randn(m, kk).to(bf)
        b = (torch.randn(kk, n) / math.sqrt(kk)).to(bf)
        want = matmul_ref(a, b)
        h = kk // 2       # another fp32 summation order: two K halves
        other = (a[:, :h].float() @ b[:h].float()
                 + a[:, h:].float() @ b[h:].float()).to(bf)
        dropped = a.clone()
        dropped[:, -16:] = 0
        share = {"other summation order": check(other, want, bf)[0],
                 "one 16-deep K step dropped":
                     check(matmul_ref(dropped, b), want, bf)[0],
                 "output x1.05":
                     check((want.float() * 1.05).to(bf), want, bf)[0]}
        print(f"spm_matmul {m}x{kk}x{n}: "
              + ", ".join(f"{name} {r:.3f}" for name, r in share.items()))


if __name__ == "__main__":
    main()
