"""Public wrapper of the hand-written Hopper wkv6 kernel
(``csrc/wkv6.cu``), which replaces the reference's Pallas kernel
``src/repro/kernels/wkv6/wkv6.py::wkv6``.

Dispatch is by device, with no fallback: CPU tensors take the plain
version (``ref.wkv6_ref``, the exact sequential recurrence); ``meta``
tensors (the dry run's) the chunked torch form at the caller's chunk
(``ref.wkv6_chunked``, what the reference's dry run traces: its op
count does not grow with the sequence); CUDA tensors launch a kernel,
or the wrapper raises.  Each launch adds one to ``wkv.launches`` and
one to its path's count in ``wkv.paths``.  Like the TPU kernel it
takes no initial state.

Under grad mode, when an operand needs a gradient, a CUDA call goes
through ``WKV6``: its forward launches the kernel as above and keeps
r, k, v, w_log and u; its backward launches ``csrc/wkv6_bwd.cu``
(``wkv_bwd``), which adds one to ``wkv.bwd_launches`` and to its path's
count in ``wkv.bwd_paths``.  It launches or raises: the plain version
is never differentiated on the card.  CPU and ``meta`` operands are
differentiated by autograd through their torch forms.
``wkv_grad_plain`` is the backward's plain version.  ``bwd_dispatch``
routes the backward as ``select_path`` routes the forward:
``tensor_core`` (a states launch and a gradient launch, the chunks of
a (b, h) in parallel across a cluster, products on mma.sync in tf32)
for bf16 with every operand on a 16-byte boundary, ``fma`` (one block
per (b, h) walking the chunks) for fp32 and operands off the grid.

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

from repro_torch.core.gpu_mapping import (H100, WKV_BWD_ROWS,
                                          WKV_BWD_TC_ROWS, WKV_MAX_CLUSTER,
                                          WKV_PATHS, WKV_TC_ROWS,
                                          wkv_bwd_smem_plan, wkv_smem_plan)
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_chunked, wkv6_ref

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
# the backward's C entries in csrc/wkv6_bwd.cu: r, k, v, w, u, dy,
# dstate, dr, dk, dv, dw, du, scratch, B, S, H, K, rows, then the
# tensor-core kernels' cluster and segments or the fma kernel's dtype
# flag, the stream
BWD_ENTRIES = {"tensor_core": ("wkv6_bwd_tc_launch",
                               [_P] * 13 + [_I] * 7 + [_P]),
               "fma": ("wkv6_bwd_launch", [_P] * 13 + [_I] * 6 + [_P])}


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


def bwd_dispatch(S: int, K: int, dtype: torch.dtype, aligned: bool = True,
                 bh: int = 1) -> dict:
    """The backward's launch, decided before it: the path
    (``select_path``'s rule), the rows of a chunk, the cluster's size
    and the groups of chunks it walks (``fma``: one block per (b, h),
    cluster 1, one group).  ``bh`` is B * H.  The ``tensor_core``
    cluster is the one (1 to 8) whose launch takes the fewest waves of
    blocks times groups walked, the smaller on a tie: at rwkv6's
    training shape (B * H 128, 128 chunks of 32 rows) 2, which puts
    all 256 blocks on the card at once (two an SM) where 8 would take
    four waves of 16 groups.  Its states launch cuts each (b, h)'s groups
    into ``segments`` (4 there) walked in parallel.  Pure Python."""
    path = select_path(dtype, aligned)
    if path == "fma":
        return {"path": path, "rows": WKV_BWD_ROWS[K], "cluster": 1,
                "groups": 1}
    rows = WKV_BWD_TC_ROWS[K]
    plan = wkv_bwd_smem_plan(K, path=path, rows=rows)
    if not plan["fits"]:
        raise ValueError(f"no shared-memory plan for K={K}")
    chunks = -(-S // rows)
    slots = H100.num_sms * plan["resident"]
    cluster = min(range(1, min(WKV_MAX_CLUSTER, chunks) + 1),
                  key=lambda c: (-(-bh * c // slots) * -(-chunks // c), c))
    groups = -(-chunks // cluster)
    # the states launch: segments of groups, as many as fill its blocks
    # (4 an SM, 2 at K = 128) once
    seg_slots = H100.num_sms * (2 if K >= 128 else 4)
    per = -(-groups // min(groups, max(1, seg_slots // bh)))
    return {"path": path, "rows": rows, "cluster": cluster,
            "groups": groups, "segments": -(-groups // per)}


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


def _lib(path: str, backward: bool = False):
    """The C entry of ``path``'s kernel (the backward's when
    ``backward``), argument types set once."""
    source, (name, argtypes) = (("wkv6_bwd", BWD_ENTRIES[path]) if backward
                                else ("wkv6", ENTRIES[path]))
    fn = getattr(_build.load(source), name)
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
    device is its local shard's): a torch form runs, not a kernel."""
    return all(t.device.type in ("cpu", "meta") for t in ts)


def _meta_chunk(S: int, chunk: Optional[int]) -> int:
    """The chunk ``meta`` operands are traced at: the caller's (default
    128) clamped to ``S``, down to a divisor of ``S``."""
    c = min(chunk or DEFAULT_CHUNK, S)
    while S % c:
        c -= 1
    return c


def _check_card(ts) -> None:
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device
                                          for t in ts):
        raise ValueError("wkv6 runs on one CUDA device or the CPU: "
                         f"{[str(t.device) for t in ts]}")
    K = ts[0].shape[-1]
    if K not in HEAD_DIMS:
        raise ValueError(f"head dim {K} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("wkv6 needs contiguous operands")


def _launch(r, k, v, w_log, u, chunk: Optional[int]):
    """One launch of the forward kernel on checked CUDA operands:
    (y, final state)."""
    B, S, H, K = r.shape
    ts = (r, k, v, w_log, u)
    _check_card(ts)
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


def wkv_bwd(r, k, v, w_log, u, dy, dstate=None):
    """One launch of the backward (``csrc/wkv6_bwd.cu``) on CUDA
    operands, on the path ``bwd_dispatch`` routes them to: (dr, dk, dv
    in r's dtype; dw_log, du in fp32).  ``dy`` is y's gradient (made
    contiguous here: a group norm's backward may hand it strided),
    ``dstate`` the final state's, or None for zero."""
    B, S, H, K = r.shape
    dy = dy.contiguous()
    ts = (r, k, v, w_log, u, dy)
    _check_card(ts)
    if dy.shape != r.shape or dy.dtype != r.dtype:
        raise TypeError(f"dy must match r: {tuple(dy.shape)} {dy.dtype}")
    if dstate is not None:
        dstate = dstate.to(torch.float32).contiguous()
        _check_card((r, dstate))
        if tuple(dstate.shape) != (B, H, K, K):
            raise ValueError(f"dstate must be [B,H,K,K]: "
                             f"{tuple(dstate.shape)}")
        ts = ts + (dstate,)
    aligned = all(t.data_ptr() % 16 == 0 for t in ts)
    return _bwd_launch(bwd_dispatch(S, K, r.dtype, aligned, B * H),
                       r, k, v, w_log, u, dy, dstate)


def _bwd_launch(route, r, k, v, w_log, u, dy, dstate=None):
    """The backward's launch on ``route`` (a ``bwd_dispatch`` result;
    ``fma``'s takes every operand, ``tensor_core``'s only what it routes
    there) with operands ``wkv_bwd`` has checked: contiguous, dstate
    fp32 or None.  du is summed here in a fixed order from the kernel's
    partials (per (b, h) on ``fma``, per (b, h, chunk) on
    ``tensor_core``)."""
    B, S, H, K = r.shape
    rows = route["rows"]
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w_log)
    if route["path"] == "tensor_core":
        parts = route["cluster"] * route["groups"]
        du = torch.empty((B * H, parts, K), dtype=torch.float32,
                         device=r.device)
        # per group and per segment a [K, K] state and a [K] decay
        scratch = torch.empty(
            (B * H * (route["groups"] + route["segments"]) * K * (K + 1),),
            dtype=torch.float32, device=r.device)
        flag = (route["cluster"], route["segments"])
    else:
        du = torch.empty((B, H, K), dtype=torch.float32, device=r.device)
        scratch = torch.empty((B * H, -(-S // rows) + 1, K, K),
                              dtype=torch.float32, device=r.device)
        flag = (int(r.dtype == torch.bfloat16),)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib(route["path"], backward=True)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        u.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        scratch.data_ptr(), B, S, H, K, rows, *flag, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward launch failed: CUDA error {err} "
                           f"({tuple(r.shape)}, {route})")
    wkv.bwd_launches += 1
    wkv.bwd_paths[route["path"]] += 1
    if route["path"] == "tensor_core":
        du = du.sum(1).view(B, H, K)
    return dr, dk, dv, dw, du.sum(0)


def wkv_grad_plain(r, k, v, w_log, u, dy, dstate=None):
    """The backward's plain version: ``torch.autograd.grad`` through
    ``wkv6_ref`` (the exact recurrence, fp32) of y against ``dy`` and the
    final state against ``dstate`` (None: zero).  Returns (dr, dk, dv,
    dw_log, du)."""
    ins = [t.detach().requires_grad_() for t in (r, k, v, w_log, u)]
    with torch.enable_grad():
        y, state = wkv6_ref(*ins)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, ins, grads)


class WKV6(torch.autograd.Function):
    """wkv6 under autograd on the card: the forward kernel, and the
    backward kernel for the gradients of r, k, v, w_log and u."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, chunk):
        y, state = _launch(r, k, v, w_log, u, chunk)
        ctx.save_for_backward(r, k, v, w_log, u)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w_log, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        return (*wkv_bwd(r, k, v, w_log, u, dy, dstate), None)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor, *,
        chunk: Optional[int] = None):
    """r,k,v,w_log: [B,S,H,K]; u: [H,K].  Returns (y [B,S,H,K] in r's
    dtype, final state [B,H,K,K] fp32).  On CUDA under grad mode, with
    an operand that needs a gradient, through ``WKV6``."""
    _check(r, k, v, w_log, u)
    B, S, H, K = r.shape
    resolve_chunk(S, K, chunk)      # a bad plan fails on every device
    ts = (r, k, v, w_log, u)
    if _on_cpu(*ts):
        if any(t.device.type == "meta" for t in ts):
            return wkv6_chunked(r, k, v, w_log, u, _meta_chunk(S, chunk))
        return wkv_plain(r, k, v, w_log, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return WKV6.apply(r, k, v, w_log, u, chunk)
    return _launch(r, k, v, w_log, u, chunk)


wkv.launches = 0
wkv.bwd_launches = 0
wkv.paths = dict.fromkeys(PATHS, 0)
wkv.bwd_paths = dict.fromkeys(PATHS, 0)
