"""Public wrapper of the hand-written Hopper spm_matmul
(``csrc/spm_matmul.cu``), which replaces the reference's Pallas kernel
``src/repro/kernels/spm_matmul/spm_matmul.py::spm_matmul``.

Dispatch is by device, with no fallback: CPU tensors take the plain
version (``ref.matmul_ref``); CUDA tensors launch the kernel, or the
wrapper raises.  Each launch adds one to ``matmul.launches``.

Block plans keep the reference's parameters: ``bm``/``bn`` are the
output tile and ``bk`` the K extent staged in shared memory per step
(``bk == 0``: the whole K).  The kernel is compiled for the ``TILES``
its plans select; a plan's tile is clamped to the problem as the
reference clamps ``min(bm, m)``.  Two staging
buffers are used when they fit the 227 KB a block may use
(``core.gpu_mapping.smem_plan``), else one; when one does not fit
either, ``bk`` is halved from 512 down to 128, the reference's
``vmem_plan`` fallback with the shared-memory rule in its place.

What bounds it on the card, and what the design does about it, is in
the source note of ``csrc/spm_matmul.cu``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch.core.gpu_mapping import H100, smem_plan
from repro_torch.kernels import _build
from repro_torch.kernels.spm_matmul.ref import matmul_ref

# (bm, bn) tiles compiled into csrc/spm_matmul.cu: the defaults' 16x64,
# 32x128 and 64x128, their clamps to narrow N (32x64, 64x64), and the
# reference's conformance plans (64x128, 128x128)
TILES = ((16, 64), (32, 64), (32, 128), (64, 64), (64, 128), (128, 128))
DEFAULT_BK = 64
_IN_DTYPES = (torch.float32, torch.bfloat16)

matmul_plain = matmul_ref


def default_plan(m: int, k: int, n: int) -> dict:
    """The port's shape-safe defaults: the 16-row tile with 64 columns
    for decode-sized M (more blocks on the card for narrow N), 64 x 128
    for prefill-sized M.  K slabs are 64 deep, so several blocks share
    an SM and hide each other's loads, unless the grid has fewer blocks
    than the card has SMs: then each block stages the whole K
    (``bk = 0``, halved to fit) to keep more bytes in flight."""
    bm, bn = (16, 64) if m <= 16 else (32 if m <= 32 else 64, 128)
    blocks = math.ceil(m / bm) * math.ceil(n / bn)
    return {"bm": bm, "bn": bn, "bk": 0 if blocks < H100.num_sms
            else DEFAULT_BK}


def _clamp_tile(req: int, dim: int, tiles: Sequence[int]) -> int:
    """Largest compiled tile <= ``req``, shrunk to the smallest compiled
    tile that still covers ``dim``."""
    fitting = [t for t in tiles if t <= req]
    if not fitting:
        raise ValueError(f"tile {req} below the compiled tiles {tiles}")
    covering = [t for t in fitting if t >= dim]
    return min(covering) if covering else max(fitting)


@functools.lru_cache(maxsize=1024)
def resolve_plan(m: int, k: int, n: int, elem_bytes: int, trans_b: bool,
                 bm: Optional[int] = None, bn: Optional[int] = None,
                 bk: Optional[int] = None) -> dict:
    """Explicit arguments over ``default_plan``; tiles clamped to the
    compiled set; two staging buffers when they fit, else one; ``bk``
    halved until one fits.  Returns ``bm, bn, bk``, ``bkc`` (the K
    extent staged per step) and ``stages``.  Cached: the serving loop
    asks for the same few shapes every step.  Do not mutate the
    returned dict."""
    plan = default_plan(m, k, n)
    plan.update({key: v for key, v in (("bm", bm), ("bn", bn), ("bk", bk))
                 if v is not None})
    tm = _clamp_tile(plan["bm"], m, sorted({bm for bm, _ in TILES}))
    tn = _clamp_tile(plan["bn"], n, [bn for bm, bn in TILES if bm == tm])
    tk = plan["bk"]
    if tk < 0 or tk % 16:
        raise ValueError(f"bk={tk}: 0 (whole K) or a multiple of 16")

    def rule(b, stages=1):
        return smem_plan(m, k, n, tm, tn, b, elem_bytes, trans_b, stages)

    fit = rule(tk)
    if not fit["fits"]:
        tk = 512 if tk <= 0 else tk
        fit = rule(tk)
        while not fit["fits"] and tk > 128:
            tk //= 2
            fit = rule(tk)
    if not fit["fits"]:
        raise ValueError(f"no shared-memory plan for bm={tm} bn={tn} "
                         f"bk={tk}: {fit}")
    stages = 2 if fit["bkc"] < k and rule(tk, 2)["fits"] else 1
    return {"bm": tm, "bn": tn, "bk": tk, "bkc": fit["bkc"],
            "stages": stages}


def _lib():
    lib = _build.load("spm_matmul")
    fn = lib.spm_matmul_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, i, ll, ll, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor, trans_b: bool,
           out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"2-D operands only: {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    kb = b.shape[1] if trans_b else b.shape[0]
    if a.shape[1] != kb:
        raise ValueError(f"K mismatch: {tuple(a.shape)} @ {tuple(b.shape)}"
                         f" (trans_b={trans_b})")
    if a.dtype != b.dtype or a.dtype not in _IN_DTYPES:
        raise TypeError(f"operands must share a dtype in {_IN_DTYPES}: "
                        f"{a.dtype}, {b.dtype}")
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: A's dtype or float32")


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False,
           out_dtype: Optional[torch.dtype] = None,
           bm: Optional[int] = None, bn: Optional[int] = None,
           bk: Optional[int] = None) -> torch.Tensor:
    """C = A @ B (``trans_b``: A @ B.T with B given as [N, K]), fp32
    accumulation, output in A's dtype unless ``out_dtype`` is given."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, trans_b, out_dtype)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, out_dtype, trans_b=trans_b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"spm_matmul runs on one CUDA device or the CPU: "
                         f"{a.device}, {b.device}")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("spm_matmul needs unit stride along each "
                         "operand's last dim")
    m, k = a.shape
    n = b.shape[0] if trans_b else b.shape[1]
    if min(m, n, k) == 0:
        raise ValueError(f"empty problem {m}x{k}x{n}")
    plan = resolve_plan(m, k, n, a.element_size(), trans_b, bm, bn, bk)
    per_vec = 16 // a.element_size()
    vec = int(all(t.data_ptr() % 16 == 0 and t.stride(0) % per_vec == 0
                  for t in (a, b)))
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                 a.stride(0), b.stride(0), int(trans_b),
                 int(a.dtype == torch.bfloat16),
                 int(out_dtype == torch.float32), plan["bm"], plan["bn"],
                 plan["bkc"], plan["stages"], vec, stream)
    if err != 0:
        raise RuntimeError(f"spm_matmul launch failed: CUDA error {err} "
                           f"({m}x{k}x{n}, plan {plan})")
    matmul.launches += 1
    return c


matmul.launches = 0
