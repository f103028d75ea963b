"""Public wrapper of the hand-written Hopper wkv6 kernel
(``csrc/wkv6.cu``), which replaces the reference's Pallas kernel
``src/repro/kernels/wkv6/wkv6.py::wkv6``.

Dispatch is by device, with no fallback: CPU tensors take the plain
version (``ref.wkv6_ref``, the exact sequential recurrence); CUDA
tensors launch a kernel, or the wrapper raises.  Each launch adds one
to ``wkv.launches`` and one to its path's count in ``wkv.paths``.  Like
the TPU kernel it takes no initial state.

On CUDA, ``route`` picks one of two kernels before the launch:
``tensor_core`` for bf16 r, k and v with every operand on a 16-byte
boundary (the chunks of one (b, h) run in parallel as the blocks of a
thread-block cluster, products on mma.sync), and ``fma`` (one block per
(b, h) walking the chunks in order, fp32 FMAs) for fp32, which the
tensor cores cannot hold to the 1e-4 fp32 allowance, and for operands
off the 16-byte grid.

The plan parameter is the reference's ``chunk``: an explicit value
wins, then on CUDA the tuned plan cache's (``launch_plan``), else the
reference's default of 128, clamped to the sequence length.  The
``fma`` kernel runs it halved while one block's working set does not
fit the shared memory a block may use
(``core.gpu_mapping.wkv_smem_plan``), as ``spm_matmul`` halves ``bk``.
The ``tensor_core`` kernel picks its own parallel unit from it: a block
takes ``tc_rows`` rows, the chunk rounded down to a multiple of 16 and
held between 16 and the rows it is compiled for (64 at K = 32 and 64,
16 at K = 128), so the model's chunk of 256 at S = 256 runs as four
64-row blocks per (b, h), not one.  The result depends on the chunk
only through rounding.  Both kernels mask a ragged last chunk, so the
sequence length need not be a multiple of it.

What bounds it on the card, and what the design does about it, is in
the source note of ``csrc/wkv6.cu``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.gpu_mapping import (WKV_MAX_CLUSTER, WKV_PATHS,
                                          WKV_TC_ROWS, wkv_smem_plan)
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_ref

DEFAULT_CHUNK = 128
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
PATHS = WKV_PATHS
SUBTILE = 16

wkv_plain = wkv6_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
# each path's C entry in csrc/wkv6.cu and its argument types: r, k, v,
# w, u, y, state, B, S, H, K, the chunk (fma) or rows per block
# (tensor_core), (the fma kernel's dtype flag,) the stream
ENTRIES = {"tensor_core": ("wkv6_tc_launch",
                           [_P] * 7 + [_I] * 5 + [_P]),
           "fma": ("wkv6_launch", [_P] * 7 + [_I] * 6 + [_P])}


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


def tc_rows(S: int, K: int, chunk: Optional[int] = None) -> int:
    """Rows of one ``tensor_core`` block: the chunk (default 128,
    clamped to ``S``) rounded down to a multiple of 16, at least 16 and
    at most the rows the kernel is compiled for at this ``K``."""
    c = min(chunk or DEFAULT_CHUNK, S)
    if c < 1:
        raise ValueError(f"chunk={chunk} for S={S}")
    return max(SUBTILE, min(WKV_TC_ROWS[K], c // SUBTILE * SUBTILE))


def select_path(dtype: torch.dtype, aligned: bool) -> str:
    """The kernel a CUDA call launches: ``tensor_core`` for bf16 with
    every operand on a 16-byte boundary (``aligned``), else ``fma``."""
    return "tensor_core" if dtype == torch.bfloat16 and aligned else "fma"


def dispatch(S: int, K: int, dtype: torch.dtype, aligned: bool = True,
             chunk: Optional[int] = None) -> dict:
    """Everything the launch is decided by: the path; for ``fma`` the
    chunk its block walks, for ``tensor_core`` the rows per block, the
    cluster's size (blocks per (b, h) at once) and the groups of chunks
    it walks in order."""
    path = select_path(dtype, aligned)
    if path == "fma":
        return {"path": path, "rows": resolve_chunk(S, K, chunk),
                "cluster": 1, "groups": 1}
    rows = tc_rows(S, K, chunk)
    chunks = -(-S // rows)
    cluster = min(WKV_MAX_CLUSTER, chunks)
    groups = -(-chunks // cluster)
    if not wkv_smem_plan(WKV_TC_ROWS[K], K, path=path,
                         groups=groups)["fits"]:
        raise ValueError(f"no shared-memory plan for K={K}")
    return {"path": path, "rows": rows, "cluster": cluster,
            "groups": groups}


def launch_plan(B: int, S: int, H: int, K: int, dtype: torch.dtype,
                aligned: bool = True, chunk: Optional[int] = None) -> dict:
    """``dispatch`` for the chunk a CUDA call runs: ``chunk`` as passed,
    else the tuned plan cache's for this problem
    (``tuning.runtime.cached_pins``), else the default.  Pure Python, so
    the CPU tests can say what a card would launch."""
    from repro_torch.compat import dtype_name
    from repro_torch.tuning.plan import WkvProblem
    from repro_torch.tuning.runtime import cached_pins
    pins = cached_pins("wkv6", WkvProblem(B, S, H, K, dtype_name(dtype)),
                       {"chunk": chunk})
    return dispatch(S, K, dtype, aligned, pins.get("chunk"))


def _lib(path: str):
    """The C entry of ``path``'s kernel, argument types set once."""
    name, argtypes = ENTRIES[path]
    fn = getattr(_build.load("wkv6"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


def _on_cpu(*ts: torch.Tensor) -> bool:
    """Whether every operand lies on the CPU or on ``meta`` (a DTensor's
    device is its local shard's): the plain version runs.  ``meta``
    holds no data, so only the plain version can trace shapes there."""
    return all(t.device.type in ("cpu", "meta") for t in ts)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor, *,
        chunk: Optional[int] = None):
    """r,k,v,w_log: [B,S,H,K]; u: [H,K].  Returns (y [B,S,H,K] in r's
    dtype, final state [B,H,K,K] fp32).  On CUDA under grad mode, inputs
    that need a gradient raise: the kernel has no backward, and a
    detached result would train nothing without a word."""
    _check(r, k, v, w_log, u)
    B, S, H, K = r.shape
    resolve_chunk(S, K, chunk)      # a bad plan fails on every device
    ts = (r, k, v, w_log, u)
    if _on_cpu(*ts):
        return wkv_plain(r, k, v, w_log, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "wkv6 has no backward on CUDA: the kernel's result would carry "
            "no gradient.  RWKV training waits for a wkv6 gradient "
            "(ROADMAP.md, Queue 1 item 7, what it leaves)")
    if r.device.type != "cuda" or any(t.device != r.device for t in ts):
        raise ValueError("wkv6 runs on one CUDA device or the CPU: "
                         f"{[str(t.device) for t in ts]}")
    if K not in HEAD_DIMS:
        raise ValueError(f"head dim {K} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("wkv6 needs contiguous operands")
    aligned = all(t.data_ptr() % 16 == 0 for t in ts)
    route = launch_plan(B, S, H, K, r.dtype, aligned, chunk)
    path = route["path"]
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, K,
            route["rows"])
    if path == "tensor_core":
        err = _lib(path)(*args, stream)
    else:
        err = _lib(path)(*args, int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err} "
                           f"({tuple(r.shape)}, {route})")
    wkv.launches += 1
    wkv.paths[path] += 1
    return y, state


wkv.launches = 0
wkv.paths = dict.fromkeys(PATHS, 0)
