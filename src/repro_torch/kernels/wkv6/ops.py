"""Public wrapper of the hand-written Hopper wkv6 kernel
(``csrc/wkv6.cu``), which replaces the reference's Pallas kernel
``src/repro/kernels/wkv6/wkv6.py::wkv6``.

Dispatch is by device, with no fallback: CPU tensors take the plain
version (``ref.wkv6_ref``, the exact sequential recurrence); CUDA
tensors launch the kernel, or the wrapper raises.  Each launch adds one
to ``wkv.launches``.  Like the TPU kernel it takes no initial state.

The plan parameter is the reference's ``chunk``: an explicit value
wins, else the reference's default of 128.  It is clamped to the
sequence length, then halved while one block's working set does not fit
the shared memory a block may use (``core.gpu_mapping.wkv_smem_plan``),
as ``spm_matmul`` halves ``bk``.  The result depends on the chunk only
through rounding.  The kernel masks a ragged last chunk, so the
sequence length need not be a multiple of it.

What bounds it on the card, and what the design does about it, is in
the source note of ``csrc/wkv6.cu``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.gpu_mapping import wkv_smem_plan
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_ref

DEFAULT_CHUNK = 128
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

wkv_plain = wkv6_ref


@functools.lru_cache(maxsize=256)
def resolve_chunk(S: int, K: int, chunk: Optional[int] = None) -> int:
    """The chunk the kernel runs: ``chunk`` (default 128) clamped to
    ``S``, halved until ``wkv_smem_plan`` says it fits."""
    c = min(chunk or DEFAULT_CHUNK, S)
    if c < 1:
        raise ValueError(f"chunk={chunk} for S={S}")
    while not wkv_smem_plan(c, K)["fits"]:
        if c == 1:
            raise ValueError(f"no shared-memory plan for K={K}")
        c //= 2
    return c


def _lib():
    lib = _build.load("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w_log, u) -> None:
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or w_log.shape != r.shape:
        raise ValueError(f"r, k, v, w_log must share one [B,S,H,K] shape: "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w_log.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"u must be [H, K]: {tuple(u.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise TypeError(f"r, k, v must share a dtype in {_DTYPES}")
    if w_log.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w_log and u must be float32: {w_log.dtype}, "
                        f"{u.dtype}")
    if r.shape[1] == 0:
        raise ValueError("empty sequence")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor, *,
        chunk: Optional[int] = None):
    """r,k,v,w_log: [B,S,H,K]; u: [H,K].  Returns (y [B,S,H,K] in r's
    dtype, final state [B,H,K,K] fp32)."""
    _check(r, k, v, w_log, u)
    B, S, H, K = r.shape
    L = resolve_chunk(S, K, chunk)
    ts = (r, k, v, w_log, u)
    if all(t.device.type == "cpu" for t in ts):
        return wkv_plain(r, k, v, w_log, u)
    if r.device.type != "cuda" or any(t.device != r.device for t in ts):
        raise ValueError("wkv6 runs on one CUDA device or the CPU: "
                         f"{[str(t.device) for t in ts]}")
    if K not in HEAD_DIMS:
        raise ValueError(f"head dim {K} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("wkv6 needs contiguous operands")
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
                 u.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, K,
                 L, int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err} "
                           f"({tuple(r.shape)}, chunk {L})")
    wkv.launches += 1
    return y, state


wkv.launches = 0
