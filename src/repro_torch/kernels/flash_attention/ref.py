"""Plain PyTorch version of flash_attention, written from the
reference's ``kernels/flash_attention/ref.py::attention_ref``: causal
and/or sliding-window GQA attention by head grouping, masked scores at
the finite -1e30, softmax in fp32, p cast to v's dtype before the PV
product.  Products are taken in fp32 (the reference takes them in the
inputs' dtype and casts, which for bf16 rounds the scores first; the
TPU kernel and the CUDA kernel both accumulate in fp32).

The wrapper in ``ops.py`` runs this for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.

``attention_block`` is the reference model's attention over one block
(its ``models/attention.py::_block_attn``): products in the inputs'
dtype, softmax in fp32.  ``jax.grad`` of that form is the reference's
attention gradient; the port's ``models.attention.sdpa`` runs it, and
``ops.attention_grad`` recomputes it under autograd for the kernel's
backward.
"""
import math
from typing import Optional

import torch

NEG_INF = -1e30


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
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] -> [B,Sq,H,D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * scale
    ok = visible(torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
