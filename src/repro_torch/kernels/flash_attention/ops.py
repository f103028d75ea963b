"""Public wrapper of the hand-written Hopper flash_attention forward
(``csrc/flash_attention.cu``), which replaces the reference's Pallas
kernel ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention``.

Dispatch is by device, with no fallback: CPU tensors take the plain
version (``ref.attention_ref``); CUDA tensors launch a kernel, or the
wrapper raises.  Each launch adds one to ``attention.launches`` and one
to its path's count in ``attention.paths``.

On CUDA, ``select_path`` picks one of two kernels before the launch:
``tensor_core`` (mma.sync bf16 products, fp32 statistics) for bf16
q, k and v whose rows start on 16-byte boundaries, and ``fma`` (fp32
FMAs) for fp32, which the tensor cores cannot hold to the 1e-5 fp32
policy, and for bf16 rows that are not 16-byte aligned.

Both kernels are compiled for 64-query by 64-key tiles and head dims
32, 64, 112 (zamba2's shared blocks), 128 and 256 (gemma3); the
wrapper checks each launch's shared memory against
``core.gpu_mapping.flash_smem_plan`` first.
``bq``/``bk`` keep the reference's plan parameters but accept only
that compiled tile: a call that passes neither takes the tuned plan
cache's (``launch_plan``), which can only name that tile too.  q, k and
v are read in place through their strides (the head dim must be
contiguous).

Training: under grad mode, a call whose q, k or v needs a gradient runs
through ``FlashAttention`` (a ``torch.autograd.Function``): the forward
is this wrapper's call (the kernel on CUDA), the backward
(``attention_grad``) recomputes the reference model's attention
(``ref.attention_block``) under autograd, one block of queries at a
time.  No TPU kernel computes attention's gradient: the reference has
no backward kernel, and ``jax.grad`` differentiates its jnp ``sdpa``.
Every other call, serving's among them, takes the direct route.

What bounds it on the card, and what the design does about it, is in
the source note of ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.gpu_mapping import (FLASH_BK, FLASH_BQ, FLASH_PATHS,
                                          flash_smem_plan)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     attention_block,
                                                     attention_ref, visible)

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65_535
PATHS = FLASH_PATHS
# queries per block of attention_grad's recompute: one block's fp32
# scores at qwen2's training shape (batch 4, 4096 keys, 14 heads) are
# 4 x 14 x 512 x 4096 x 4 B = 470 MB
BWD_CHUNK_Q = 512

attention_plain = attention_ref


def select_path(dtype: torch.dtype, aligned: bool) -> str:
    """The kernel a CUDA call launches, decided before the launch:
    ``tensor_core`` for bf16 with every row of q, k and v on a 16-byte
    boundary (``aligned``), else ``fma``."""
    return "tensor_core" if dtype == torch.bfloat16 and aligned else "fma"


_P, _I = ctypes.c_void_p, ctypes.c_int
_COMMON = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
           ctypes.POINTER(ctypes.c_longlong), _I, _I, ctypes.c_float]
# each path's C entry in csrc/flash_attention.cu and its argument types:
# q, k, v, o, B, Sq, Sk, H, KV, D, strides, causal, window, scale, (the
# fma kernel's dtype flag,) the stream
ENTRIES = {"tensor_core": ("flash_attention_tc_launch", _COMMON + [_P]),
           "fma": ("flash_attention_launch", _COMMON + [_I, _P])}


def launch_plan(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                causal: bool, window: int, dtype: torch.dtype,
                bq: Optional[int] = None, bk: Optional[int] = None) -> dict:
    """The tile a CUDA call runs: ``bq``/``bk`` as passed, else the
    tuned plan cache's for this problem (``tuning.runtime.cached_pins``),
    else the compiled tile; anything but the compiled tile raises."""
    from repro_torch.compat import dtype_name
    from repro_torch.tuning.plan import AttentionProblem
    from repro_torch.tuning.runtime import cached_pins
    problem = AttentionProblem(B, Sq, Sk, H, KV, D, causal, window,
                               dtype_name(dtype))
    plan = {"bq": FLASH_BQ, "bk": FLASH_BK,
            **cached_pins("flash_attention", problem, {"bq": bq, "bk": bk})}
    for name, compiled in (("bq", FLASH_BQ), ("bk", FLASH_BK)):
        if plan[name] != compiled:
            raise ValueError(f"{name}={plan[name]}: the kernel is compiled "
                             f"for {compiled}-row tiles")
    return plan


def _lib(path: str):
    """The C entry of ``path``'s kernel, argument types set once."""
    name, argtypes = ENTRIES[path]
    fn = getattr(_build.load("flash_attention"), name)
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


def _launch(q, k, v, causal, window, scale, bq=None, bk=None):
    """Launch the CUDA kernel ``select_path`` picks, or raise."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention runs on one CUDA device or the "
                         f"CPU: {q.device}, {k.device}, {v.device}")
    launch_plan(B, Sq, Sk, H, KV, D, causal, window, q.dtype, bq, bk)
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dim")
    if B * H > _MAX_GRID_Y or min(B, Sq, Sk) == 0:
        raise ValueError(f"unsupported problem B={B} H={H} Sq={Sq} Sk={Sk}")
    aligned = all(t.data_ptr() % 16 == 0
                  and all(s % 8 == 0 for s in t.stride()[:3])
                  for t in (q, k, v))
    path = select_path(q.dtype, aligned)
    plan = flash_smem_plan(D, path)
    if not plan["fits"]:
        raise ValueError(f"flash_attention {path} at head dim {D} needs "
                         f"{plan['smem_need']} bytes of shared memory, "
                         f"over {plan['smem_bytes']}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            Sk, H, KV, D, strides, int(causal), int(window), float(scale))
    if path == "tensor_core":
        err = _lib(path)(*args, stream)
    else:
        err = _lib(path)(*args, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, kv {tuple(k.shape)},"
                           f" {path})")
    attention.launches += 1
    attention.paths[path] += 1
    return o


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
    """flash_attention under autograd: the forward is the wrapper's call
    (the kernel on CUDA, the plain version on the CPU); the backward is
    ``attention_grad`` and returns dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, pins):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, scale)
        return _attention(q, k, v, causal, window, scale, *pins)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = attention_grad(q, k, v, do, causal=causal,
                                    window=window, scale=scale)
        return dq, dk, dv, None, None, None, None


attention.launches = 0
attention.paths = dict.fromkeys(PATHS, 0)
