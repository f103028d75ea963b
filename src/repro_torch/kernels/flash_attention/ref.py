"""Plain PyTorch version of flash_attention, written from the
reference's ``kernels/flash_attention/ref.py::attention_ref``: causal
and/or sliding-window GQA attention by head grouping, masked scores at
the finite -1e30, softmax in fp32, p cast to v's dtype before the PV
product.  Products are taken in fp32 (the reference takes them in the
inputs' dtype and casts, which for bf16 rounds the scores first; the
TPU kernel and the CUDA kernel both accumulate in fp32).

The wrapper in ``ops.py`` runs this for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] -> [B,Sq,H,D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * scale
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos_k <= pos_q
    if window > 0:
        ok &= (pos_q - pos_k) < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
