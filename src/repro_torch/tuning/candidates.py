"""Candidate block-plan enumeration + per-kernel defaults, for the
port's Hopper kernels (the reference's ``tuning/candidates.py`` with
the H100 plan family in place of the TPU one).

A candidate is a plan some kernel on the card launches differently from
every other candidate; two plans that produce the same launch (the
same ``dispatch`` result and the same resolved tile) are one candidate:

- ``spm_matmul``: the shape's fixed-tile path, if it has one, gets one
  candidate, its ``PATH_TILES`` pins — ``{bm: 16, bn: 64}`` for
  ``splitk``, with no ``bk`` (that path picks its own K slice), and
  ``{bm: 128, bn: 128, bk: 64}`` for ``wgmma``.  The ``tiled`` kernel
  gets every compiled tile (``ops.TILES``) crossed with the ``bk``
  depths (``BK_DEPTHS``, 0 = the whole K) whose staging fits shared
  memory (``core.gpu_mapping.smem_plan``), clamped to the shape as the
  wrapper clamps it.
- ``flash_attention``: one candidate, the one tile it is compiled for.
- ``wkv6``: on the ``tensor_core`` kernel the chunks whose rows per
  block (``ops.tc_rows``) are the distinct multiples of 16 up to the
  rows it is compiled for at this K; on ``fma`` the powers of two up to
  128 whose working set fits shared memory (``wkv_smem_plan``).

``defaults_for`` is the plan a wrapper runs with no cache entry and no
explicit args: the launch written as a plan, so that the plan, written
into a cache, reproduces that launch exactly.  It is not what a wrapper
passes when no plan is cached (it passes nothing: see
``tuning.runtime``).  Enumeration takes the default first, so it is the
one plan of its launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Tuple

import torch

from repro_torch.compat import torch_dtype
from repro_torch.core.gpu_mapping import (FLASH_BK, FLASH_BQ, WKV_TC_ROWS,
                                          smem_plan, wkv_smem_plan)
from repro_torch.kernels.spm_matmul import ops as mm_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.tuning.plan import (AttentionProblem, MatmulProblem, Plan,
                                     Problem, WkvProblem)

# the tiled kernel's K staging depths a plan may pin (0: the whole K)
BK_DEPTHS = (0, 64, 128, 256, 512)
# fma wkv6 chunks: the powers of two up to 128
WKV_FMA_CHUNKS = tuple(2 ** i for i in range(8))


def _dedupe(plans: List[Plan], launch: Callable[[Plan], Hashable]
            ) -> List[Plan]:
    """The first plan of each distinct launch, in order."""
    seen, out = set(), []
    for plan in plans:
        key = launch(plan)
        if key not in seen:
            seen.add(key)
            out.append(plan)
    return out


# ------------------------------------------------------------ spm_matmul

def matmul_launch(p: MatmulProblem, plan: Plan) -> dict:
    """The launch a CUDA call on ``p`` makes under exactly ``plan`` (no
    cache consulted), with 16-byte aligned operands."""
    return mm_ops.launch_of(p.m, p.k, p.n, torch_dtype(p.dtype), p.trans_b,
                            True, plan.get("bm"), plan.get("bn"),
                            plan.get("bk"))


def matmul_launch_key(p: MatmulProblem, plan: Plan) -> tuple:
    """What tells two launches apart: the path, its split and the tile
    it runs (on ``tiled``: rows, columns, K staged and stages)."""
    launch = matmul_launch(p, plan)
    tile = launch["tile"]
    if launch["path"] == "tiled":
        return ("tiled", tile["bm"], tile["bn"], tile["bkc"],
                tile["stages"])
    return (launch["path"], launch["splits"], tile["bkc"])


def _tile_fits(p: MatmulProblem, plan: Plan) -> bool:
    """The tiled plan's own ``bk`` stages in shared memory, unhalved."""
    elem = torch.finfo(torch_dtype(p.dtype)).bits // 8
    tm = mm_ops._clamp_tile(plan["bm"], p.m,
                            sorted({bm for bm, _ in mm_ops.TILES}))
    tn = mm_ops._clamp_tile(plan["bn"], p.n,
                            [bn for bm, bn in mm_ops.TILES if bm == tm])
    return smem_plan(p.m, p.k, p.n, tm, tn, plan["bk"], elem,
                     p.trans_b)["fits"]


def _default_spm_matmul(p: MatmulProblem) -> Plan:
    launch = matmul_launch(p, {})
    if launch["path"] == "tiled":
        tile = launch["tile"]
        return {"bm": tile["bm"], "bn": tile["bn"], "bk": tile["bk"]}
    pins = mm_ops.PATH_TILES[launch["path"]]
    return {k: v for k, v in zip(("bm", "bn", "bk"), pins) if v is not None}


def _enum_spm_matmul(p: MatmulProblem) -> List[Plan]:
    # the default is the fixed-tile path's pins where the shape has one
    tiled = [{"bm": bm, "bn": bn, "bk": bk}
             for bm, bn in mm_ops.TILES for bk in BK_DEPTHS]
    return _dedupe([_default_spm_matmul(p)]
                   + [c for c in tiled if _tile_fits(p, c)],
                   lambda c: matmul_launch_key(p, c))


# ------------------------------------------------------ flash_attention

def _default_flash(p: AttentionProblem) -> Plan:
    return {"bq": FLASH_BQ, "bk": FLASH_BK}


def _enum_flash(p: AttentionProblem) -> List[Plan]:
    return [_default_flash(p)]


# ----------------------------------------------------------------- wkv6

def wkv_launch(p: WkvProblem, plan: Plan) -> dict:
    """The launch a CUDA call on ``p`` makes under exactly ``plan``,
    with 16-byte aligned operands."""
    return wkv_ops.dispatch(p.seq, p.key_dim, torch_dtype(p.dtype), True,
                            plan.get("chunk"))


def _default_wkv(p: WkvProblem) -> Plan:
    return {"chunk": wkv_launch(p, {})["rows"]}


def _enum_wkv(p: WkvProblem) -> List[Plan]:
    if wkv_launch(p, {})["path"] == "tensor_core":
        top = WKV_TC_ROWS[p.key_dim]
        cands = [{"chunk": r} for r in range(16, top + 1, 16)
                 if wkv_ops.tc_rows(p.seq, p.key_dim, r) == r]
    else:
        cands = [{"chunk": c} for c in WKV_FMA_CHUNKS
                 if wkv_smem_plan(c, p.key_dim)["fits"]]
    return _dedupe([_default_wkv(p)] + cands,
                   lambda c: tuple(sorted(wkv_launch(p, c).items())))


# -------------------------------------------------------------- registry

@dataclass(frozen=True)
class KernelTuneSpec:
    """Tuning hooks for one registered kernel."""
    name: str
    param_names: Tuple[str, ...]
    defaults: Callable[[Problem], Plan]
    enumerate: Callable[[Problem], List[Plan]]


TUNE_SPECS: Dict[str, KernelTuneSpec] = {
    "spm_matmul": KernelTuneSpec(
        "spm_matmul", ("bm", "bn", "bk"),
        _default_spm_matmul, _enum_spm_matmul),
    "flash_attention": KernelTuneSpec(
        "flash_attention", ("bq", "bk"),
        _default_flash, _enum_flash),
    "wkv6": KernelTuneSpec(
        "wkv6", ("chunk",), _default_wkv, _enum_wkv),
}


def defaults_for(kernel: str, problem: Problem) -> Plan:
    return dict(TUNE_SPECS[kernel].defaults(problem))


def enumerate_candidates(kernel: str, problem: Problem) -> List[Plan]:
    cands = TUNE_SPECS[kernel].enumerate(problem)
    default = TUNE_SPECS[kernel].defaults(problem)
    if default not in cands:
        cands.append(default)
    return cands
