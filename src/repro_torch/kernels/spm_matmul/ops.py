"""Public wrapper of the hand-written Hopper spm_matmul
(``csrc/spm_matmul.cu``), which replaces the reference's Pallas kernel
``src/repro/kernels/spm_matmul/spm_matmul.py::spm_matmul``.

Dispatch is by device, with no fallback: CPU tensors take the plain
version (``ref.matmul_ref``); CUDA tensors launch a kernel, or the
wrapper raises.  Each launch adds one to ``matmul.launches`` and one to
its path's count in ``matmul.paths``.

On CUDA, ``select_path`` picks one of three kernels before the launch:

* ``splitk``: bf16 operands whose rows start on 16-byte boundaries,
  M <= 16 (decode) and B given as [K, N] with N a multiple of 8.  TMA
  and wgmma with the weights as the 64-row operand and the tokens as N
  (8 or 16); one cluster of ``splits`` blocks (1 to 8, the portable
  cluster limit) per 64-column tile, each block over one K slice of
  whole 64-deep steps, as few splits as give every SM a block
  (``splitk_plan``).
* ``wgmma``: bf16, 16-byte aligned rows, M >= 64 (prefill), either B
  layout.  TMA and wgmma on 128 x 128 x 64 tiles; problems with fewer
  tiles than half the SMs split K over a cluster in 64-deep steps
  (``wgmma_plan``).
* ``tiled``: everything else, the port's first kernel: fp32 operands,
  bf16 rows that are not 16-byte aligned, 16 < M < 64, the transposed-B
  decode logits (already at ~71 % of their byte bound), and plans that
  pin a tile the other two do not run.

Block plans keep the reference's parameters: ``bm``/``bn`` are the
output tile and ``bk`` the K extent staged in shared memory per step
(``bk == 0``: the whole K).  They shape the ``tiled`` kernel, which is
compiled for the ``TILES`` its plans select; a plan's tile is clamped
to the problem as the reference clamps ``min(bm, m)``.  Two staging
buffers are used when they fit the 227 KB a block may use
(``core.gpu_mapping.smem_plan``), else one; when one does not fit
either, ``bk`` is halved from 512 down to 128, the reference's
``vmem_plan`` fallback with the shared-memory rule in its place.

``splitk`` and ``wgmma`` run fixed tiles (``PATH_TILES``): 16 x 64
with a K slice the wrapper picks from the shape (the split count is
not a plan parameter; its ring streams the slice 64 rows a stage), and
128 x 128 x 64.  A call whose plan pins
another ``bm``, ``bn`` or ``bk`` runs on ``tiled``, which honours it.
So the serving plan's decode pins (16 x 64) name the ``splitk`` tile,
and a plan that pins any other tile times the kernel that runs it.

A pin a CUDA call does not pass comes from the tuned plan cache
(``launch_plan``, through ``tuning.runtime.cached_pins``) where the
cache holds a plan for the call's problem; otherwise it stays unpinned.
The lookup sits in front of the cached ``resolve_plan`` and
``splitk_plan``, so a new cache, or ``tuning.reset()``, is seen at the
next call.

Training: under grad mode, a call whose operand needs a gradient runs
through ``SpmMatmul`` (a ``torch.autograd.Function``), whose backward
makes both gradient products through this same wrapper, so on CUDA
they are kernel launches too (see ``SpmMatmul``).  Every other call,
serving's and its captured graphs' among them, takes the direct route
and launches exactly what it launched before.

What bounds each path on the card, and what its design does about it,
is in the source notes of ``csrc/spm_matmul.cu``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch.core.gpu_mapping import (H100, PATHS, SPLITK_BK,
                                          WGMMA_BK, smem_plan, splitk_rows)
from repro_torch.kernels import _build
from repro_torch.kernels.spm_matmul.ref import matmul_ref

# (bm, bn) tiles compiled into csrc/spm_matmul.cu: the defaults' 16x64,
# 32x128 and 64x128, their clamps to narrow N (32x64, 64x64), and the
# reference's conformance plans (64x128, 128x128)
TILES = ((16, 64), (32, 64), (32, 128), (64, 64), (64, 128), (128, 128))
DEFAULT_BK = 64
_IN_DTYPES = (torch.float32, torch.bfloat16)
MAX_SPLITS = 8            # the portable thread-block cluster size
SPLITK_MAX_M = 16         # decode path: rows of A (wgmma's largest N here)
SPLITK_BN = 64            # decode path: output columns of one cluster
SPLITK_STAGES = 6         # decode path: TMA ring depth
WGMMA_MIN_M = 64          # wgmma path: one warpgroup's 64 rows
WGMMA_TILE = (128, 128)   # wgmma path: output tile
WGMMA_STAGES = 4          # wgmma path: TMA ring depth
# the (bm, bn, bk) each fixed-tile path runs; None: the wrapper's own
PATH_TILES = {"splitk": (SPLITK_MAX_M, SPLITK_BN, None),
              "wgmma": WGMMA_TILE + (WGMMA_BK,)}

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


def select_path(m: int, n: int, dtype: torch.dtype, trans_b: bool,
                aligned: bool) -> str:
    """The kernel a CUDA call launches, decided before the launch (see
    the module note): ``splitk``, ``wgmma`` or ``tiled``.  ``aligned``:
    every row of A and B starts on a 16-byte boundary."""
    if dtype != torch.bfloat16 or not aligned:
        return "tiled"
    if m <= SPLITK_MAX_M:
        return "splitk" if not trans_b and n % 8 == 0 else "tiled"
    return "wgmma" if m >= WGMMA_MIN_M else "tiled"


def k_slices(k: int, splits: int, step: int) -> tuple:
    """(slice, splits): K cut into ``splits`` slices of ``slice`` rows, a
    multiple of ``step``, the last one ragged; ``splits`` shrinks so that
    no slice is empty."""
    size = math.ceil(math.ceil(k / splits) / step) * step
    return size, math.ceil(k / size)


@functools.lru_cache(maxsize=1024)
def splitk_plan(m: int, k: int, n: int) -> Optional[dict]:
    """The decode path's split: the fewest splits that give every SM a
    block (column tiles x splits >= the SMs), at most ``MAX_SPLITS`` and
    at most one a ``SPLITK_BK``-deep step, K cut into slices of whole
    steps (``ks`` rows).  Fewer splits would leave SMs without bytes in
    flight; more give each block less to stream for the same ramp-up
    and reduction, and on the card take longer (PERF.md §6).  None
    when the ring of ``SPLITK_STAGES`` does not fit shared memory.
    Blocks are small (160 threads, ~62 KB), so several share an SM and
    the grid runs as one wave."""
    if not smem_plan(m, k, n, splitk_rows(m), SPLITK_BN, SPLITK_BK,
                     stages=SPLITK_STAGES, path="splitk")["fits"]:
        return None
    tiles = math.ceil(n / SPLITK_BN)
    steps = math.ceil(k / SPLITK_BK)
    want = max(1, min(MAX_SPLITS, steps, math.ceil(H100.num_sms / tiles)))
    per, splits = k_slices(steps, want, 1)
    return {"splits": splits, "ks": per * SPLITK_BK}


@functools.lru_cache(maxsize=1024)
def wgmma_plan(m: int, k: int, n: int) -> dict:
    """The prefill path's split: one 128 x 128 tile per block, and one
    block per SM (its ring takes ~129 KB), so K is split over a cluster
    only as far as the tiles leave SMs idle: splits = SMs // tiles, at
    most ``MAX_SPLITS``, in whole 64-deep steps."""
    tiles = math.ceil(m / WGMMA_TILE[0]) * math.ceil(n / WGMMA_TILE[1])
    steps = math.ceil(k / WGMMA_BK)
    want = max(1, min(MAX_SPLITS, H100.num_sms // tiles, steps))
    per, splits = k_slices(steps, want, 1)
    return {"splits": splits, "kb_per": per}


def dispatch(m: int, k: int, n: int, dtype: torch.dtype, trans_b: bool,
             aligned: bool, bm: Optional[int] = None,
             bn: Optional[int] = None, bk: Optional[int] = None) -> dict:
    """``{"path", "splits", ...}``: the kernel a CUDA call launches and
    its split, decided before the launch.  A call goes to ``tiled`` when
    its plan pins a tile other than the path's (``PATH_TILES``), or when
    the ring of its path (``SPLITK_STAGES``, ``WGMMA_STAGES``) does not
    fit shared memory."""
    path = select_path(m, n, dtype, trans_b, aligned)
    if path != "tiled" and any(
            pin is not None and pin != tile
            for pin, tile in zip((bm, bn, bk), PATH_TILES[path])):
        path = "tiled"
    if path == "splitk":
        plan = splitk_plan(m, k, n)
        if plan is not None:
            return {"path": path, **plan}
    if path == "wgmma" and smem_plan(
            m, k, n, *WGMMA_TILE, WGMMA_BK, stages=WGMMA_STAGES,
            path="wgmma")["fits"]:
        return {"path": path, **wgmma_plan(m, k, n)}
    return {"path": "tiled", "splits": 1}


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each path's C entry in csrc/spm_matmul.cu and its argument types:
# a, b, c, m, n, k, lda, ldb, the path's own ints, the stream
ENTRIES = {
    "tiled": ("spm_matmul_launch",
              [_P, _P, _P, _I, _I, _I, _LL, _LL] + [_I] * 8 + [_P]),
    "splitk": ("spm_matmul_splitk_launch",
               [_P, _P, _P, _I, _I, _I, _LL, _LL] + [_I] * 3 + [_P]),
    "wgmma": ("spm_matmul_wgmma_launch",
              [_P, _P, _P, _I, _I, _I, _LL, _LL] + [_I] * 4 + [_P]),
}


def launch_of(m: int, k: int, n: int, dtype: torch.dtype, trans_b: bool,
              aligned: bool, bm: Optional[int] = None,
              bn: Optional[int] = None, bk: Optional[int] = None) -> dict:
    """``dispatch`` for exactly these pins, with ``tile``: what the
    launched kernel runs, ``bm``, ``bn`` and ``bkc`` (the K extent a
    block stages per step; on ``splitk`` the K slice a block sums, which
    its ring streams ``SPLITK_BK`` rows a stage) and, on ``tiled``,
    ``resolve_plan``'s whole plan (``bk``, ``stages``).  Do not mutate
    ``tile``."""
    launch = dispatch(m, k, n, dtype, trans_b, aligned, bm, bn, bk)
    if launch["path"] == "tiled":
        tile = resolve_plan(m, k, n, torch.finfo(dtype).bits // 8, trans_b,
                            bm, bn, bk)
    elif launch["path"] == "splitk":
        tile = {"bm": SPLITK_MAX_M, "bn": SPLITK_BN, "bkc": launch["ks"]}
    else:
        tile = {"bm": WGMMA_TILE[0], "bn": WGMMA_TILE[1], "bkc": WGMMA_BK}
    return {**launch, "tile": tile}


def launch_plan(m: int, k: int, n: int, dtype: torch.dtype, trans_b: bool,
                aligned: bool, bm: Optional[int] = None,
                bn: Optional[int] = None, bk: Optional[int] = None) -> dict:
    """What a CUDA call with these pins launches (``launch_of``): the
    pins it passes, and for each one it leaves None the tuned plan
    cache's value where the cache holds a plan for this problem
    (``tuning.runtime.cached_pins``).  With no entry, or with
    ``REPRO_AUTOTUNE=0``, nothing is added: the launch of a call that
    passes no pins is the one it was before tuning existed.  Pure
    Python, so the CPU tests can say what a card would launch."""
    from repro_torch.compat import dtype_name
    from repro_torch.tuning.plan import MatmulProblem
    from repro_torch.tuning.runtime import cached_pins
    pins = cached_pins("spm_matmul",
                       MatmulProblem(m, k, n, dtype_name(dtype), trans_b),
                       {"bm": bm, "bn": bn, "bk": bk})
    return launch_of(m, k, n, dtype, trans_b, aligned, **pins)


def route(a: torch.Tensor, b: torch.Tensor, trans_b: bool = False,
          bm: Optional[int] = None, bn: Optional[int] = None,
          bk: Optional[int] = None) -> dict:
    """``launch_plan`` for these CUDA operands and plan pins, with
    ``aligned``: whether every row of A and B starts on a 16-byte
    boundary."""
    per_vec = 16 // a.element_size()
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) % per_vec == 0
                  for t in (a, b))
    m, k = a.shape
    n = b.shape[0] if trans_b else b.shape[1]
    return {**launch_plan(m, k, n, a.dtype, trans_b, aligned, bm, bn, bk),
            "aligned": aligned}


def _lib(path: str):
    """The C entry of ``path``'s kernel, argument types set once."""
    name, argtypes = ENTRIES[path]
    fn = getattr(_build.load("spm_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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
    accumulation, output in A's dtype unless ``out_dtype`` is given.
    Differentiable (``SpmMatmul``) when grad mode is on and an operand
    needs a gradient."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, trans_b, out_dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return SpmMatmul.apply(a, b, trans_b, out_dtype, (bm, bn, bk))
    return _matmul(a, b, trans_b, out_dtype, bm, bn, bk)


def _on_cpu(*ts: torch.Tensor) -> bool:
    """Whether every operand lies on the CPU or on ``meta`` (a DTensor's
    device is its local shard's): the plain version runs.  ``meta``
    holds no data, so only the plain version can trace shapes there."""
    return all(t.device.type in ("cpu", "meta") for t in ts)


def _matmul(a, b, trans_b, out_dtype, bm=None, bn=None, bk=None):
    """The checked call's dispatch: the plain version on the CPU and on
    ``meta``, the kernel on CUDA."""
    if _on_cpu(a, b):
        if a.device.type == "meta":
            # no values to round: the dry run traces the product in the
            # operands' dtype, as the kernel reads them (the plain
            # version's fp32 upcast would double every gather it counts)
            return torch.matmul(a, b.t() if trans_b else b).to(out_dtype)
        return matmul_plain(a, b, out_dtype, trans_b=trans_b)
    return _launch(a, b, trans_b, out_dtype, bm, bn, bk)


def _launch(a, b, trans_b, out_dtype, bm=None, bn=None, bk=None):
    """Launch the CUDA kernel ``route`` picks, or raise."""
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
    launch = route(a, b, trans_b, bm, bn, bk)
    path, plan = launch["path"], launch["tile"]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
            b.stride(0))
    out_f32 = int(out_dtype == torch.float32)
    if path == "splitk":
        err = _lib(path)(*args, out_f32, launch["splits"], launch["ks"],
                         stream)
    elif path == "wgmma":
        err = _lib(path)(*args, int(trans_b), out_f32, launch["splits"],
                         launch["kb_per"], stream)
    else:
        err = _lib(path)(*args, int(trans_b), int(a.dtype == torch.bfloat16),
                         out_f32, plan["bm"], plan["bn"], plan["bkc"],
                         plan["stages"], int(launch["aligned"]), stream)
    if err != 0:
        raise RuntimeError(f"spm_matmul launch failed: CUDA error {err} "
                           f"({m}x{k}x{n}, {launch})")
    matmul.launches += 1
    matmul.paths[path] += 1
    return c


def _unit(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit stride along its last dim (a copy only if not)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def grad_a(dc: torch.Tensor, b: torch.Tensor, trans_b: bool,
           a_dtype: torch.dtype) -> torch.Tensor:
    """dA = dC @ B^T of C = A @ B: a ``trans_b`` call on B as it lies
    ([K, N]); for a ``trans_b`` forward (B given as [N, K]) a plain
    call."""
    return matmul(_unit(dc), b, trans_b=not trans_b, out_dtype=a_dtype)


def grad_b(a: torch.Tensor, dc: torch.Tensor, trans_b: bool,
           b_dtype: torch.dtype) -> torch.Tensor:
    """dB of C = A @ B, in B's layout: A^T @ dC ([K, N]), or for a
    ``trans_b`` forward dC^T @ A ([N, K]).  The wrapper needs unit
    stride along each operand's last dim, so the smaller of A and dC is
    copied transposed; copying A gives A^T @ dC, copying dC gives
    dC^T @ A, and the other of the two layouts is a transposed view of
    the result."""
    if a.numel() <= dc.numel():
        g = matmul(a.t().contiguous(), _unit(dc), out_dtype=b_dtype)
        return g.t() if trans_b else g
    g = matmul(dc.t().contiguous(), _unit(a), out_dtype=b_dtype)
    return g if trans_b else g.t()


class SpmMatmul(torch.autograd.Function):
    """spm_matmul under autograd.  The forward is the wrapper's call;
    the backward makes dA and dB (``grad_a``, ``grad_b``) through the
    same wrapper (grad mode is off in a backward, so they take its direct
    route): on CUDA both are kernel launches, on the CPU both run the
    plain version.

    An fp32 output of bf16 operands (the loss's logits) brings an fp32
    dC: the backward rounds it to the operands' dtype once and feeds
    both products the bf16 copy, which keeps them on the bf16 tensor
    core paths (the kernel takes two operands of one dtype) at the cost
    of dC's rounding, 2^-9 of each element, inside fp32 sums whose
    result is rounded to bf16 anyway."""

    @staticmethod
    def forward(ctx, a, b, trans_b, out_dtype, pins):
        ctx.save_for_backward(a, b)
        ctx.trans_b = trans_b
        return _matmul(a, b, trans_b, out_dtype, *pins)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc = dc.to(a.dtype)
        da = grad_a(dc, b, ctx.trans_b, a.dtype) \
            if ctx.needs_input_grad[0] else None
        db = grad_b(a, dc, ctx.trans_b, b.dtype) \
            if ctx.needs_input_grad[1] else None
        return da, db, None, None, None


matmul.launches = 0
matmul.paths = dict.fromkeys(PATHS, 0)
