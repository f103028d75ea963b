"""Public wrapper of the hand-written Hopper flash_attention forward
(``csrc/flash_attention.cu``), which replaces the reference's Pallas
kernel ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention``.

Dispatch is by device, with no fallback: CPU tensors take the plain
version (``ref.attention_ref``); CUDA tensors launch a kernel, or the
wrapper raises.  Each launch adds one to ``attention.launches`` and one
to its path's count in ``attention.paths``.

On CUDA, ``select_path`` picks one of two kernels before the launch:
``tensor_core`` (wgmma bf16 products fed by TMA, warp-specialised,
fp32 statistics) for bf16 q, k and v whose rows start on 16-byte
boundaries, and ``fma`` (fp32 FMAs) for fp32, which the tensor cores
cannot hold to the 1e-5 fp32 policy, and for bf16 rows that are not
16-byte aligned.

Each path is compiled for its own tile (``path_tile``,
``core.gpu_mapping.flash_tile``): ``tensor_core`` for 128 queries a
block (two warpgroups of 64; 64 at head dim 256, where the two split the
head dim) by 64 keys a K/V tile, ``fma`` for 64 by 64; both for head
dims 32, 64, 112 (zamba2's shared blocks), 128 and 256 (gemma3).  A plan
names the tile of serving's kernel; training's o_lo kernel splits the
head dim from 112 up too (64 queries a block).  The wrapper checks
each launch's shared memory against
``core.gpu_mapping.flash_smem_plan`` first.  ``bq``/``bk`` keep the
reference's plan parameters but accept only the tile of the path the
call runs (``launch_plan``); the tuned plan cache, whose one candidate
is that tile, is not read at launch.  q, k and v are
read in place through their strides (the head dim must be
contiguous).

Training: under grad mode, a call whose q, k or v needs a gradient runs
through ``FlashAttention`` (a ``torch.autograd.Function``).  On CUDA its
forward launches the kernel with the rows' log-sum-exp (``lse``) and, on
``tensor_core`` up to head dim ``FLASH_FWD_LO_MAX_D``, ``o_lo`` (the
part of its fp32 output, its PV product taking each p as hi + lo, that
o's bf16 rounding drops), and keeps q, k, v, lse, o and o_lo; its
backward launches the hand-written backward
``csrc/flash_attention_bwd.cu`` (``attention_bwd``; on ``tensor_core`` a
dQ launch that takes D_i from o + o_lo, a dK/dV launch per query head
and, under GQA, a launch that sums each group's partials;
deterministic) on the path ``bwd_dispatch`` routes it to, and adds one to
``attention.bwd_launches`` and to that path's count in
``attention.bwd_paths``; it launches or raises.  On the CPU and
on ``meta`` the forward is the plain version and the backward is
``attention_grad``, the backward's plain version, which recomputes the
reference model's attention (``ref.attention_block``) under autograd,
one block of queries at a time.  No TPU kernel computes attention's
gradient: the reference has no backward kernel, and ``jax.grad``
differentiates its jnp ``sdpa``.  Every other call, serving's among
them, takes the direct route and asks for no lse.

What bounds it on the card, and what the design does about it, is in
the source note of ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.gpu_mapping import (FLASH_FWD_LO_MAX_D, FLASH_PATHS,
                                          flash_bwd_smem_plan,
                                          flash_smem_plan, flash_tile)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     attention_block,
                                                     attention_ref, visible)

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65_535
PATHS = FLASH_PATHS
# queries per block of attention_grad's recompute (the backward's plain
# version, which runs for CPU and meta tensors and for chip_smoke.py's
# comparison): one block's fp32 scores at qwen2's training shape (batch
# 4, 4096 keys, 14 heads) are 4 x 14 x 512 x 4096 x 4 B = 470 MB
BWD_CHUNK_Q = 512

attention_plain = attention_ref


def select_path(dtype: torch.dtype, aligned: bool) -> str:
    """The kernel a CUDA call launches, decided before the launch:
    ``tensor_core`` for bf16 with every row of q, k and v on a 16-byte
    boundary (``aligned``), else ``fma``."""
    return "tensor_core" if dtype == torch.bfloat16 and aligned else "fma"


def bwd_dispatch(D: int, dtype: torch.dtype, aligned: bool,
                 shape: Optional[tuple] = None) -> dict:
    """The backward's launch, decided before it: the path
    (``select_path``'s rule over q, k, v and do) and its blocks' shared
    memory, threads and warpgroups, and with ``shape`` (B, Sk, H, KV)
    the group sum's scratch bytes on ``tensor_core``
    (``core.gpu_mapping.flash_bwd_smem_plan``).  Pure Python."""
    path = select_path(dtype, aligned)
    return {"path": path, **flash_bwd_smem_plan(D, path, shape=shape)}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_COMMON = [_P] * 5 + [_I] * 6 + [_STRIDES, _I, _I, _F]
# each path's C entry in csrc/flash_attention.cu and its argument types:
# q, k, v, o, lse (null: not written), B, Sq, Sk, H, KV, D, strides,
# causal, window, scale, (tensor_core: o_lo, null when not written; fma:
# the dtype flag,) the stream
ENTRIES = {"tensor_core": ("flash_attention_tc_launch", _COMMON + [_P, _P]),
           "fma": ("flash_attention_launch", _COMMON + [_I, _P])}
_BWD_COMMON = [_P] * 9 + [_I] * 6 + [_STRIDES, _I, _I, _F]
# the backward's C entries in csrc/flash_attention_bwd.cu: q, k, v, do,
# lse, delta (scratch), dq, dk, dv, B, Sq, Sk, H, KV, D, strides, causal,
# window, scale, (tensor_core: the forward's o and o_lo, null above
# FLASH_FWD_LO_MAX_D, and the group's fp32 dk and dv partials, null when
# H == KV; fma: the dtype flag,) the stream
BWD_ENTRIES = {
    "tensor_core": ("flash_attention_bwd_tc_launch",
                    _BWD_COMMON + [_P] * 5),
    "fma": ("flash_attention_bwd_launch", _BWD_COMMON + [_I, _P])}


def path_tile(path: str, D: int) -> dict:
    """The tile ``path``'s kernel is compiled for at head dim ``D``:
    {"bq": queries of a block, "bk": keys of a K/V tile}."""
    return dict(zip(("bq", "bk"), flash_tile(D, path)))


def launch_plan(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                causal: bool, window: int, dtype: torch.dtype,
                bq: Optional[int] = None, bk: Optional[int] = None,
                path: Optional[str] = None) -> dict:
    """The tile a CUDA call runs: the compiled tile of ``path``
    (``select_path``'s for aligned operands of ``dtype`` by default;
    ``path_tile``).  ``bq``/``bk`` as passed must name it, or the call
    raises.  The tuned plan cache is not read: its only candidate is
    this tile, and a plan tuned against an earlier build of the kernel
    may name another."""
    compiled = path_tile(path or select_path(dtype, True), D)
    for name, pin in (("bq", bq), ("bk", bk)):
        if pin is not None and pin != compiled[name]:
            raise ValueError(f"{name}={pin}: the kernel is compiled for "
                             f"{compiled[name]}-row tiles at head dim {D}")
    return compiled


def _lib(path: str, backward: bool = False):
    """The C entry of ``path``'s kernel (the backward's when
    ``backward``), argument types set once."""
    source, (name, argtypes) = (
        ("flash_attention_bwd", BWD_ENTRIES[path]) if backward
        else ("flash_attention", ENTRIES[path]))
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B,Sq,H,D], k/v [B,Sk,KV,D]: {tuple(q.shape)},"
                         f" {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and kv "
                         f"{tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share a dtype in {_DTYPES}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, scale: float = 0.0,
              bq: Optional[int] = None,
              bk: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] -> [B,Sq,H,D] in q's dtype.
    Positions are ``arange`` for both q and k (prefill).  Differentiable
    (``FlashAttention``) when grad mode is on and an input needs a
    gradient."""
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale,
                                    (bq, bk))
    return _attention(q, k, v, causal, window, scale, bq, bk)


def _on_cpu(*ts: torch.Tensor) -> bool:
    """Whether every operand lies on the CPU or on ``meta`` (a DTensor's
    device is its local shard's): the plain version runs.  ``meta``
    holds no data, so only the plain version can trace shapes there."""
    return all(t.device.type in ("cpu", "meta") for t in ts)


def _attention(q, k, v, causal, window, scale, bq=None, bk=None):
    """The checked call's dispatch: the plain version on the CPU and on
    ``meta``, the kernel on CUDA."""
    if _on_cpu(q, k, v):
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    return _launch(q, k, v, causal, window, scale, bq, bk)


def _check_card(*ts: torch.Tensor) -> None:
    """One CUDA device, contiguous head dims, a problem the grids take."""
    q, k = ts[0], ts[1]
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("flash_attention runs on one CUDA device or the "
                         f"CPU: {[str(t.device) for t in ts]}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention needs a contiguous head dim")
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    if B * H > _MAX_GRID_Y or min(B, Sq, Sk) == 0:
        raise ValueError(f"unsupported problem B={B} H={H} Sq={Sq} Sk={Sk}")


def _aligned(*ts: torch.Tensor) -> bool:
    """Whether every row of every operand starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in t.stride()[:3]) for t in ts)


def _launch(q, k, v, causal, window, scale, bq=None, bk=None,
            with_lse=False):
    """Launch the CUDA kernel ``select_path`` picks, or raise: o, or
    with ``with_lse`` (o, lse [B, H, Sq] fp32, o_lo): ``o_lo`` in o's
    dtype and layout on ``tensor_core`` up to head dim
    ``FLASH_FWD_LO_MAX_D`` (the backward's D_i comes from o + o_lo),
    else None."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check_card(q, k, v)
    path = select_path(q.dtype, _aligned(q, k, v))
    launch_plan(B, Sq, Sk, H, KV, D, causal, window, q.dtype, bq, bk, path)
    lo = with_lse and path == "tensor_core" and D <= FLASH_FWD_LO_MAX_D
    plan = flash_smem_plan(D, path, lo=lo)
    if not plan["fits"]:
        raise ValueError(f"flash_attention {path} at head dim {D} needs "
                         f"{plan['smem_need']} bytes of shared memory, "
                         f"over {plan['smem_bytes']}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    o_lo = torch.empty_like(o) if lo else None
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, D,
            strides, int(causal), int(window), float(scale))
    if path == "tensor_core":
        err = _lib(path)(*args, None if o_lo is None else o_lo.data_ptr(),
                         stream)
    else:
        err = _lib(path)(*args, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, kv {tuple(k.shape)},"
                           f" {path})")
    attention.launches += 1
    attention.paths[path] += 1
    return (o, lse, o_lo) if with_lse else o


def attention_bwd(q, k, v, lse, do, *, causal: bool, window: int,
                  scale: float, o: Optional[torch.Tensor] = None,
                  o_lo: Optional[torch.Tensor] = None):
    """(dq, dk, dv) by the backward kernel (``csrc/flash_attention_bwd
    .cu``) on CUDA operands: ``lse``, ``o`` and ``o_lo`` are the
    forward's (``_launch(..., with_lse=True)``), ``do`` the output's
    gradient.  Routed by ``bwd_dispatch``; ``tensor_core`` up to head dim
    ``FLASH_FWD_LO_MAX_D`` needs o and o_lo (its D_i is rowsum(do * (o +
    o_lo))); the other launches read neither.  Raises on what the kernel
    does not take."""
    _check(q, k, v)
    do = do.contiguous() if do.stride(3) != 1 else do
    _check_card(q, k, v, do)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise TypeError(f"do must match q: {tuple(do.shape)} {do.dtype}")
    B, Sq, H, D = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be [B, H, Sq] fp32 contiguous: "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if select_path(q.dtype, _aligned(q, k, v, do)) == "tensor_core" \
            and D <= FLASH_FWD_LO_MAX_D:
        if o is None or o_lo is None:
            raise ValueError("the tensor_core backward needs the forward's "
                             "o and o_lo")
        if any(t.shape != q.shape or t.dtype != q.dtype
               or t.device != q.device for t in (o, o_lo)):
            raise ValueError(f"o and o_lo must match q: {tuple(o.shape)} "
                             f"{o.dtype}, {tuple(o_lo.shape)} {o_lo.dtype}")
        o, o_lo = o.contiguous(), o_lo.contiguous()
    else:
        o = o_lo = None
    return _bwd_launch(q, k, v, lse, do, o, o_lo, causal, window, scale)


def _bwd_launch(q, k, v, lse, do, o, o_lo, causal, window, scale):
    """The backward's launches, on the path ``bwd_dispatch`` routes the
    operands ``attention_bwd`` has checked to; the gradients come out
    contiguous, in q's, k's and v's dtypes.  ``tensor_core`` under GQA
    takes [B, Sk, H, D] fp32 scratch for each head's dk and dv."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    route = bwd_dispatch(D, q.dtype, _aligned(q, k, v, do), (B, Sk, H, KV))
    path = route["path"]
    if not route["fits"]:
        raise ValueError(f"flash_attention backward {path} at head dim {D} "
                         f"needs {route['smem_need']} bytes of shared "
                         f"memory, over {route['smem_bytes']}")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, KV, D), dtype=v.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 21)(
        *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Sq, Sk, H, KV, D, strides, int(causal),
            int(window), float(scale))
    if path == "tensor_core":
        parts = ([torch.empty((B, Sk, H, D), dtype=torch.float32,
                              device=q.device) for _ in range(2)]
                 if route["scratch_bytes"] else [])
        tail = tuple(None if t is None else t.data_ptr() for t in (o, o_lo)) \
            + (tuple(t.data_ptr() for t in parts) or (None, None))
    else:
        tail = (int(q.dtype == torch.bfloat16),)
    err = _lib(path, backward=True)(*args, *tail, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, kv "
                           f"{tuple(k.shape)}, {path})")
    attention.bwd_launches += 1
    attention.bwd_paths[path] += 1
    return dq, dk, dv


def attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, *, causal: bool, window: int,
                   scale: float, chunk_q: int = BWD_CHUNK_Q):
    """(dq, dk, dv) of ``attention(q, k, v)`` against the output
    gradient ``do``.  ``ref.attention_block`` is recomputed under
    autograd one block of ``chunk_q`` queries at a time, over the keys
    the block's mask can let through (causal: up to its last query; a
    window: from its first query's window start); the keys cut off are
    masked to exactly zero weight, so the function is the same.  dk and
    dv sum the blocks in fp32 and are cast to k's and v's dtype once."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k, dtype=torch.float32,
                          memory_format=torch.contiguous_format)
    dv = torch.zeros_like(v, dtype=torch.float32,
                          memory_format=torch.contiguous_format)
    with torch.enable_grad():
        for q0 in range(0, Sq, chunk_q):
            q1 = min(Sq, q0 + chunk_q)
            k0 = max(0, q0 - window + 1) if window > 0 else 0
            k1 = min(Sk, q1) if causal else Sk
            if k1 <= k0:        # rows with no visible key: keep them all
                k0, k1 = 0, Sk
            qc = q[:, q0:q1].detach().requires_grad_()
            kc = k[:, k0:k1].detach().requires_grad_()
            vc = v[:, k0:k1].detach().requires_grad_()
            ok = visible(torch.arange(q0, q1, device=q.device),
                         torch.arange(k0, k1, device=q.device), causal,
                         window)
            bias = torch.where(ok, 0.0, NEG_INF).float()
            o = attention_block(qc.reshape(B, q1 - q0, KV, H // KV, D),
                                kc, vc, bias, scale)
            gq, gk, gv = torch.autograd.grad(
                o, (qc, kc, vc), do[:, q0:q1].reshape(o.shape))
            dq[:, q0:q1] = gq
            dk[:, k0:k1] += gk.float()
            dv[:, k0:k1] += gv.float()
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """flash_attention under autograd.  On CUDA: the forward kernel with
    the rows' log-sum-exp and o_lo, and the backward kernel
    (``attention_bwd``, fed the forward's o and o_lo).
    On the CPU and ``meta``: the plain forward, and ``attention_grad``.
    The backward returns dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, pins):
        ctx.mask = (causal, window, scale)
        if _on_cpu(q, k, v):
            ctx.save_for_backward(q, k, v)
            return attention_plain(q, k, v, causal=causal, window=window,
                                   scale=scale)
        o, lse, o_lo = _launch(q, k, v, causal, window, scale, *pins,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, lse, o, o_lo)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, window, scale = ctx.mask
        saved = ctx.saved_tensors       # unpacked once (remat's rule)
        kw = {"causal": causal, "window": window, "scale": scale}
        if len(saved) == 3:
            grads = attention_grad(*saved, do, **kw)
        else:
            q, k, v, lse, o, o_lo = saved
            grads = attention_bwd(q, k, v, lse, do, o=o, o_lo=o_lo, **kw)
        return (*grads, None, None, None, None)


attention.launches = 0
attention.bwd_launches = 0
attention.paths = dict.fromkeys(PATHS, 0)
attention.bwd_paths = dict.fromkeys(PATHS, 0)
