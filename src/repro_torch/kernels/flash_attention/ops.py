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
32, 64, 128 and 256 (gemma3); the wrapper checks each launch's shared
memory against ``core.gpu_mapping.flash_smem_plan`` first.
``bq``/``bk`` keep the reference's plan parameters but accept only
that compiled tile: a call that passes neither takes the tuned plan
cache's (``launch_plan``), which can only name that tile too.  q, k and
v are read in place through their strides (the head dim must be
contiguous).

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
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65_535
PATHS = FLASH_PATHS

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
    Positions are ``arange`` for both q and k (prefill)."""
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
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


attention.launches = 0
attention.paths = dict.fromkeys(PATHS, 0)
