"""Compile-time scheduler: the paper's matmul mapping (§4.3) plus a
general blocked-GEMM scheduler for arbitrary (M, K, N).

Mapping (paper-faithful):
  * B (K x N) is partitioned into column blocks of width ``bw`` chosen
    so a block FITS in a worker's data scratchpad next to the
    double-buffered A-row and C-fragment buffers; each round, core w
    receives one block which stays resident for the whole round
    ("as long as possible", §4.3).
  * Within a round, rows of A are streamed (double-buffered DMA) into
    every core; each core computes the bw-wide fragments of C rows and
    the DMA writes fragments back.  Multiple rounds cover all N columns
    (A is re-streamed per round — the cost of finite SPM).
  * Inside a core, each output element is a dot product over K computed
    as ceil(K / VL) vector-MAC chunks (output-vectorized inner loop) +
    a reduction/store epilogue.

The resulting Schedule is input-data-independent — exactly the static
schedule the management core executes.  SPM capacity feasibility is
part of schedule construction, not an afterthought.

A copy of the reference's ``core/scheduler.py``;
``tests/test_torch_paper_model.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from repro_torch.configs.multivic_paper import (ELEM_BYTES, MATMUL_N,
                                                MultiVicConfig)
from repro_torch.core.schedule import DMA, Schedule, core_resource


@dataclass(frozen=True)
class MatmulProblem:
    m: int = MATMUL_N
    k: int = MATMUL_N
    n: int = MATMUL_N

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


def vl_elems(hw: MultiVicConfig) -> int:
    return hw.vicuna.vreg_bits // (8 * ELEM_BYTES)


def spm_plan(hw: MultiVicConfig, prob: MatmulProblem,
             rows_per_transfer: int = 4) -> dict:
    """Choose the widest B-block (multiple of VL) that fits in the SPM
    beside 2 A-row buffers and 2 C-fragment buffers."""
    vl = vl_elems(hw)
    a_buf = 2 * rows_per_transfer * prob.k * ELEM_BYTES
    avail = hw.data_spm_bytes - a_buf
    bw_max = avail // (prob.k * ELEM_BYTES + 2 * rows_per_transfer
                       * ELEM_BYTES)
    bw = max(vl, (bw_max // vl) * vl)
    b_block = prob.k * bw * ELEM_BYTES
    fits = (b_block + a_buf + 2 * rows_per_transfer * bw * ELEM_BYTES
            <= hw.data_spm_bytes)
    cols_per_round = bw * hw.num_worker_cores
    n_rounds = math.ceil(prob.n / cols_per_round)
    return {"bw": bw, "vl": vl, "b_block_bytes": b_block, "fits": fits,
            "n_rounds": n_rounds, "cols_per_round": cols_per_round,
            "rows_per_transfer": rows_per_transfer,
            "spm_bytes": hw.data_spm_bytes}


def _col_blocks(hw: MultiVicConfig, prob: MatmulProblem, bw: int
                ) -> List[List[int]]:
    """Per round, the block width each core owns (0 = idle)."""
    W = hw.num_worker_cores
    rounds = []
    remaining = prob.n
    while remaining > 0:
        widths = []
        for _ in range(W):
            w = min(bw, remaining)
            widths.append(w)
            remaining -= w
            if remaining <= 0:
                widths.extend([0] * (W - len(widths)))
                break
        rounds.append(widths)
    return rounds


def build_matmul_schedule(hw: MultiVicConfig,
                          prob: MatmulProblem = MatmulProblem(),
                          rows_per_transfer: int = 4) -> Schedule:
    W = hw.num_worker_cores
    plan = spm_plan(hw, prob, rows_per_transfer)
    assert plan["fits"], plan
    bw, vl = plan["bw"], plan["vl"]
    chunks_per_elem = math.ceil(prob.k / vl)
    R = rows_per_transfer
    assert prob.m % R == 0
    n_iters = prob.m // R

    sched = Schedule(meta={"hw": hw.name, "problem": vars(prob), **plan})
    rounds = _col_blocks(hw, prob, bw)

    last_compute = {w: None for w in range(W)}
    for widths in rounds:
        # 1) B blocks for this round (DMA serialized; B buffer reuse
        #    requires the core's previous-round compute to be done)
        load_b = {}
        for w, width in enumerate(widths):
            if width == 0:
                continue
            deps = (last_compute[w],) if last_compute[w] is not None else ()
            load_b[w] = sched.add(
                kind="dma_load", resource=DMA,
                bytes_moved=prob.k * width * ELEM_BYTES,
                deps=deps, spm_core=w, tag=f"B->c{w}")

        # 2) stream A row-groups; compute; write back C fragments.
        # DMA issue order matters (the management core executes the
        # phase list in order, and the DMA is serial): all loads for
        # iteration it+1 are issued BEFORE the stores of iteration it,
        # so a store waiting on a long compute never starves the loads
        # the other cores' next computes depend on.
        active = [w for w, width in enumerate(widths) if width > 0]
        comp_hist = {w: [] for w in active}    # per-core compute phases

        def add_loads(it):
            loads = {}
            for w in active:
                deps = [load_b[w]]
                if len(comp_hist[w]) >= 2:      # A double buffer depth 2
                    deps.append(comp_hist[w][-2])
                loads[w] = sched.add(
                    kind="dma_load", resource=DMA,
                    bytes_moved=R * prob.k * ELEM_BYTES,
                    deps=tuple(deps), spm_core=w, tag=f"A{it}->c{w}")
            return loads

        pending_loads = add_loads(0)
        for it in range(n_iters):
            cur_loads = pending_loads
            comps = {}
            for w in active:
                width = widths[w]
                comp_deps = [cur_loads[w]]
                if comp_hist[w]:
                    comp_deps.append(comp_hist[w][-1])
                comps[w] = sched.add(
                    kind="compute", resource=core_resource(w),
                    deps=tuple(comp_deps),
                    macs=R * prob.k * width,
                    vec_chunks=R * width * chunks_per_elem,
                    elems=R * width,
                    spm_core=w, tag=f"C{it},{w}")
                comp_hist[w].append(comps[w])
            if it + 1 < n_iters:
                pending_loads = add_loads(it + 1)
            for w in active:
                sched.add(
                    kind="dma_store", resource=DMA,
                    bytes_moved=R * widths[w] * ELEM_BYTES,
                    deps=(comps[w],), spm_core=w, tag=f"C{it},{w}->ddr")
        last_compute.update({w: comp_hist[w][-1] for w in active})

    sched.validate_dag()
    sched.validate_interference_freedom()
    return sched


def schedule_totals(sched: Schedule) -> dict:
    macs = sum(p.macs for p in sched.phases)
    dma_bytes = sum(p.bytes_moved for p in sched.phases)
    return {"macs": macs, "dma_bytes": dma_bytes,
            "n_phases": len(sched.phases),
            "n_dma": sum(1 for p in sched.phases if p.kind != "compute")}
