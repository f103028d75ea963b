"""Analytic pruning stage of the autotuner, for the H100 (the
reference's ``tuning/cost_model.py`` on the port's own rules).

Before anything is measured, every candidate plan is checked for
shared-memory feasibility — the port's counterpart of the reference's
VMEM rule, and of the paper's scratchpad-capacity rule: an infeasible
plan is rejected *offline*, never discovered at runtime — by the rules
the wrappers apply at launch (``core.gpu_mapping.smem_plan``,
``flash_smem_plan``, ``wkv_smem_plan``).  Survivors are ranked by the
reference's roofline bound (``analysis.roofline.kernel_bound_s``) at the
H100's datasheet rates with the worst-case derates of ``GPUChip``
(``worst_tc_eff``, ``worst_hbm_derate``), plus a small per-block launch
term in place of the reference's per-grid-step term, so plans that
trade bytes for many more blocks do not all rank alike.

Traffic follows what each launch loads (``vmem_need`` keeps the
reference's name for the shared-memory need):

- spm_matmul ``tiled``: A is read again for each column block, and B
  for each row block when a block stages less than the whole K
  (``bkc < K``); ``splitk``: B once, A once per 64-column tile;
  ``wgmma``: A once per 128-column tile, B once per 128-row tile; C is
  written once.
- flash_attention: K/V are read again for each 64-query block; Q and O
  move once.
- wkv6: inputs and output move once, the state is written once; the
  operations grow with the chunk (rows per block on the tensor cores).

Only the ranking matters: measurement (measure.py) decides.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.analysis.roofline import kernel_bound_s
from repro_torch.compat import torch_dtype
from repro_torch.core.gpu_mapping import (FLASH_BK, FLASH_BQ, H100,
                                          WKV_TC_ROWS, GPUChip,
                                          flash_smem_plan, smem_plan,
                                          splitk_rows, wkv_smem_plan)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.spm_matmul import ops as mm_ops
from repro_torch.tuning.candidates import matmul_launch, wkv_launch
from repro_torch.tuning.plan import (AttentionProblem, MatmulProblem, Plan,
                                     Problem, WkvProblem)

F32 = 4
# fp32 outside the tensor cores (H100 SXM datasheet, dense)
PEAK_FLOPS_FP32 = 67e12

# Per-block launch cost (seconds) for ranking only: the block scheduler
# pays a small fixed cost per block, so at equal traffic fewer blocks
# should outrank more.
BLOCK_LAUNCH_S = 1e-8


def _elem_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4,
            "float64": 8}.get(dtype, 4)


def _peak_flops(dtype: str, chip: GPUChip) -> float:
    return PEAK_FLOPS_FP32 if _elem_bytes(dtype) == 4 else chip.peak_flops


@dataclass(frozen=True)
class Feasibility:
    fits: bool
    vmem_need: int
    vmem_bytes: int


def _wkv_block(p: WkvProblem, plan: Plan) -> dict:
    """The launch and its block's shared-memory plan."""
    launch = wkv_launch(p, plan)
    if launch["path"] == "fma":
        smem = wkv_smem_plan(launch["rows"], p.key_dim)
    else:
        smem = wkv_smem_plan(WKV_TC_ROWS[p.key_dim], p.key_dim,
                             path="tensor_core", groups=launch["groups"])
    return {**launch, "smem": smem}


def _flash_path(p: AttentionProblem) -> str:
    return fa_ops.select_path(torch_dtype(p.dtype), True)


def smem_need(kernel: str, problem: Problem, plan: Plan) -> int:
    """Bytes of shared memory one block of the plan's launch takes (the
    H100 spelling of the paper's SPM residency requirement)."""
    if kernel == "spm_matmul":
        p: MatmulProblem = problem
        launch = matmul_launch(p, plan)
        tile, e = launch["tile"], _elem_bytes(p.dtype)
        if launch["path"] == "splitk":
            fit = smem_plan(p.m, p.k, p.n, splitk_rows(p.m), tile["bn"],
                            tile["bkc"], path="splitk")
        elif launch["path"] == "wgmma":
            fit = smem_plan(p.m, p.k, p.n, tile["bm"], tile["bn"],
                            tile["bkc"], e, stages=mm_ops.WGMMA_STAGES,
                            path="wgmma")
        else:
            fit = smem_plan(p.m, p.k, p.n, tile["bm"], tile["bn"],
                            tile["bk"], e, p.trans_b, tile["stages"])
        return fit["smem_need"]
    if kernel == "flash_attention":
        return flash_smem_plan(problem.head_dim,
                               _flash_path(problem))["smem_need"]
    if kernel == "wkv6":
        return _wkv_block(problem, plan)["smem"]["smem_need"]
    raise KeyError(f"unknown kernel {kernel!r}")


# the reference's name for it
vmem_need = smem_need


def feasibility(kernel: str, problem: Problem, plan: Plan,
                chip: GPUChip = H100) -> Feasibility:
    """Whether the wrapper would launch the plan and its block fits
    shared memory; a plan the wrapper refuses (a tile it is not
    compiled for, no shared-memory plan) does not fit."""
    if kernel not in ("spm_matmul", "flash_attention", "wkv6"):
        raise KeyError(f"unknown kernel {kernel!r}")
    if kernel == "flash_attention" and \
            (plan.get("bq"), plan.get("bk")) != (FLASH_BQ, FLASH_BK):
        return Feasibility(False, 0, chip.smem_bytes)
    try:
        need = smem_need(kernel, problem, plan)
    except (ValueError, KeyError):
        return Feasibility(False, 0, chip.smem_bytes)
    return Feasibility(need <= chip.smem_bytes, need, chip.smem_bytes)


def grid_steps(kernel: str, problem: Problem, plan: Plan) -> int:
    """Blocks the plan's launch runs (the reference counted sequential
    grid steps; on the card the blocks are the unit of scheduling)."""
    if kernel == "spm_matmul":
        p: MatmulProblem = problem
        launch = matmul_launch(p, plan)
        tile = launch["tile"]
        return (math.ceil(p.m / tile["bm"]) * math.ceil(p.n / tile["bn"])
                * launch["splits"])
    if kernel == "flash_attention":
        a: AttentionProblem = problem
        return a.batch * a.heads * math.ceil(a.seq_q / FLASH_BQ)
    if kernel == "wkv6":
        w: WkvProblem = problem
        launch = wkv_launch(w, plan)
        chunks = 1 if launch["path"] == "fma" \
            else math.ceil(w.seq / launch["rows"])
        return w.batch * w.heads * chunks
    raise KeyError(f"unknown kernel {kernel!r}")


def flops_bytes(kernel: str, problem: Problem,
                plan: Plan) -> Tuple[float, float]:
    """(flops, HBM bytes moved) for one invocation under ``plan``."""
    if kernel == "spm_matmul":
        p: MatmulProblem = problem
        e = _elem_bytes(p.dtype)
        launch = matmul_launch(p, plan)
        tile = launch["tile"]
        a_bytes, b_bytes = p.m * p.k * e, p.k * p.n * e
        if launch["path"] == "splitk":
            a_bytes *= math.ceil(p.n / tile["bn"])
        elif launch["path"] == "wgmma":
            a_bytes *= math.ceil(p.n / tile["bn"])
            b_bytes *= math.ceil(p.m / tile["bm"])
        else:
            a_bytes *= math.ceil(p.n / tile["bn"])
            if tile["bkc"] < p.k:
                b_bytes *= math.ceil(p.m / tile["bm"])
        return 2.0 * p.m * p.k * p.n, a_bytes + b_bytes + p.m * p.n * e
    if kernel == "flash_attention":
        a: AttentionProblem = problem
        e = _elem_bytes(a.dtype)
        q_bytes = 2 * a.batch * a.seq_q * a.heads * a.head_dim * e
        kv_bytes = (2 * a.batch * a.kv_heads * a.seq_k * a.head_dim
                    * e * (a.heads // a.kv_heads)
                    * math.ceil(a.seq_q / FLASH_BQ))
        flops = 4.0 * a.batch * a.heads * a.seq_q * a.seq_k * a.head_dim
        if a.causal:
            flops /= 2
        return flops, q_bytes + kv_bytes
    if kernel == "wkv6":
        w: WkvProblem = problem
        e = _elem_bytes(w.dtype)
        L = wkv_launch(w, plan)["rows"]
        nc = math.ceil(w.seq / L)
        K = w.key_dim
        # per chunk: intra-chunk decay+scores (~3 L^2 K), A@v (2 L^2 K)
        # and the two state matmuls (~4 L K^2)
        flops = w.batch * w.heads * nc * (5.0 * L * L * K
                                          + 4.0 * L * K * K)
        # r, k, v and y in the dtype, w_log in fp32, the state once
        io_bytes = (4 * e + F32) * w.batch * w.seq * w.heads * K \
            + w.batch * w.heads * K * K * F32
        return flops, io_bytes
    raise KeyError(f"unknown kernel {kernel!r}")


def analytic_cost_s(kernel: str, problem: Problem, plan: Plan,
                    chip: GPUChip = H100) -> float:
    """Modeled worst-case seconds — the pruning objective.  Measurement
    (measure.py) decides among the survivors; this only has to rank."""
    flops, byts = flops_bytes(kernel, problem, plan)
    bound = kernel_bound_s(flops, byts,
                           peak_flops=_peak_flops(problem.dtype, chip),
                           hbm_bw=chip.hbm_bw,
                           mxu_eff=chip.worst_tc_eff,
                           hbm_derate=chip.worst_hbm_derate)
    return bound + grid_steps(kernel, problem, plan) * BLOCK_LAUNCH_S


def cost_summary(kernel: str, problem: Problem, plan: Plan,
                 chip: GPUChip = H100) -> Dict[str, float]:
    """Itemized model output (CLI/report explainability)."""
    flops, byts = flops_bytes(kernel, problem, plan)
    feas = feasibility(kernel, problem, plan, chip)
    return {
        "flops": flops,
        "bytes": byts,
        "grid_steps": float(grid_steps(kernel, problem, plan)),
        "vmem_need": float(feas.vmem_need),
        "fits": float(feas.fits),
        "cost_s": analytic_cost_s(kernel, problem, plan, chip),
    }
