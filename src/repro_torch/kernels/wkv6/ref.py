"""Plain PyTorch version of wkv6, written from the reference's
``kernels/wkv6/ref.py::wkv6_ref``: the exact per-step recurrence in
fp32,

    S_t = diag(exp w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),

returning y in r's dtype and the final state in fp32.

The wrapper in ``ops.py`` runs this for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from typing import Optional

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w_log: torch.Tensor, u: torch.Tensor,
             init_state: Optional[torch.Tensor] = None):
    """r,k,v,w_log: [B,S,H,K]; u: [H,K] -> (y [B,S,H,K], S [B,H,K,K])."""
    B, S, H, K = r.shape
    f32 = torch.float32
    s = (torch.zeros((B, H, K, K), dtype=f32, device=r.device)
         if init_state is None else init_state.to(f32))
    uu = u.to(f32)[None, :, :, None]
    rf, kf, vf = r.to(f32), k.to(f32), v.to(f32)
    decay = torch.exp(w_log.to(f32))
    y = torch.empty((B, S, H, K), dtype=f32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uu * kv)
        s = decay[:, t, :, :, None] * s + kv
    return y.to(r.dtype), s
