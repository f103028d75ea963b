"""Plain PyTorch version of wkv6, written from the reference's
``kernels/wkv6/ref.py::wkv6_ref``: the exact per-step recurrence in
fp32,

    S_t = diag(exp w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),

returning y in r's dtype and the final state in fp32.

The wrapper in ``ops.py`` runs this for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.

``wkv6_chunked`` is the reference's jnp chunked form
(``src/repro/models/rwkv.py::wkv6_chunked``) in torch: the model's
carried-state path (``models/rwkv.py`` re-exports it) and what the
wrapper traces on ``meta``, where the boundary recurrence between
chunks is taken in closed form, one product, so that a trace's op
count does not grow with the sequence.
"""
from typing import Optional

import torch

_EXP_CLAMP = 30.0


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
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uu * kv))
        s = decay[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def _chunk_states(cstate, total, s0):
    """The state entering each chunk and the final one, in closed form:
    with T the inclusive cumulative sum of the chunks' total log-decays,
    chunk c starts from exp(T_{c-1}) s0 + sum_{c' < c} exp(T_{c-1} -
    T_c') cstate_c'.  One product over [NC, NC] chunk pairs instead of
    NC steps; used on ``meta``, which holds no values (differences of
    long cumulative sums round worse than the step-by-step product)."""
    NC = total.shape[1]
    T = torch.cumsum(total, dim=1)
    Tx = T - total                                           # T_{c-1}
    earlier = torch.tril(torch.ones((NC, NC), dtype=torch.bool,
                                    device=total.device), diagonal=-1)
    gap = torch.where(earlier[None, :, :, None, None],
                      Tx[:, :, None] - T[:, None], float("-inf"))
    prev = (torch.einsum("bcdhk,bdhkv->bchkv", torch.exp(gap), cstate)
            + torch.exp(Tx)[..., None] * s0[:, None])
    final = (prev[:, -1] * torch.exp(total[:, -1])[..., None]
             + cstate[:, -1])
    return prev, final


def wkv6_chunked(r, k, v, w_log, u, chunk: int, init_state=None):
    """Chunked WKV6.  Shapes as in wkv6_sequential."""
    B, S, H, K = r.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    NC = S // chunk
    f32 = torch.float32

    def chunks(a):
        return a.reshape(B, NC, chunk, H, K).to(f32)

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w_log)
    cw = torch.cumsum(wc, dim=2)          # inclusive sums of log-decay
    e = cw - wc                           # exclusive
    total = cw[:, :, -1]                  # [B,NC,H,K]

    rq = rc * torch.exp(e)                                   # exp <= 0
    kk = kc * torch.exp(torch.clamp(-cw, max=_EXP_CLAMP))    # clamped
    A = torch.einsum("bclhk,bcmhk->bchlm", rq, kk)           # t=l, j=m
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    A = torch.where(tril, A, torch.zeros((), dtype=f32, device=r.device))
    diag = torch.einsum("bclhk,bclhk->bclh", rc * u.to(f32), kc)
    y_intra = torch.einsum("bchlm,bcmhk->bclhk", A, vc)
    y_intra = y_intra + diag[..., None] * vc

    # chunk state contributions: sum_j exp(total - cw_j) k_j ^T v_j
    kdec = kc * torch.exp(total[:, :, None] - cw)            # exp <= 0
    cstate = torch.einsum("bclhk,bclhv->bchkv", kdec, vc)

    s = (torch.zeros((B, H, K, K), dtype=f32, device=r.device)
         if init_state is None else init_state.to(f32))
    if r.device.type == "meta":
        prev, s = _chunk_states(cstate, total, s)
    else:
        prev = []
        for c in range(NC):
            prev.append(s)
            s = s * torch.exp(total[:, c])[..., None] + cstate[:, c]
        prev = torch.stack(prev, dim=1)                      # [B,NC,H,K,V]

    y_inter = torch.einsum("bclhk,bchkv->bclhv", rq, prev)
    y = (y_intra + y_inter).reshape(B, S, H, K)
    return y.to(r.dtype), s
