"""MultiVic -> H100 bridge: the paper's execution model instantiated on
an NVIDIA H100 SXM, the port's counterpart of the reference's
``core/tpu_mapping.py``.

Scale mapping:
    worker core + Vicuna      -> streaming multiprocessor (tensor cores)
    data scratchpad           -> shared memory (227 KB a block can use)
    management core + DMA     -> HBM traffic of the kernel's tile loads
    DDR4                      -> HBM3

``gpu_matmul_schedule`` builds the same static Schedule IR the paper
core uses: B column blocks are dealt round-robin to the SMs, A tiles
and C tiles stream through the one shared HBM, and each SM computes
its tiles in order.  Per-phase WCETs use worst-case effective rates,
giving a deterministic per-step bound that ``launch/serve.py`` prints
next to measured step times.

Constants are NVIDIA's H100 SXM data sheet and Hopper architecture
white paper figures (dense rates, no sparsity): 989 TFLOP/s bf16 on
the tensor cores, 3.35 TB/s HBM3, 132 SMs, 232,448 bytes of shared
memory per block.  None is measured.  The two worst-case derates are
assumptions of this model, carried over from the reference's TPU
mapping: 80 % of peak HBM bandwidth under contention and 85 % of the
tensor-core rate after pipeline bubbles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.schedule import DMA, Schedule, core_resource


@dataclass(frozen=True)
class GPUChip:
    peak_flops: float = 989e12       # bf16 dense, tensor cores
    hbm_bw: float = 3.35e12          # bytes/s
    smem_bytes: int = 232_448        # shared memory one block can use
    sm_smem_bytes: int = 233_472     # shared memory of one SM (228 KB)
    smem_reserved: int = 1_024       # per resident block, kept by the system
    max_threads_per_sm: int = 2_048
    num_sms: int = 132
    # worst-case derates for WCET (assumptions, not datasheet values)
    worst_hbm_derate: float = 0.8
    worst_tc_eff: float = 0.85


H100 = GPUChip()

# csrc/spm_matmul.cu's shared-memory layouts (the kernels' constants;
# tests/test_torch_kernels.py reads them back from the source)
SMEM_PAD = 8            # tiled path: row padding, in elements
SPLITK_WARPS = 8        # split-K decode path: warps of a block
WGMMA_BK = 64           # wgmma path: K depth of a stage (128 bf16 bytes)
WGMMA_PART_PAD = 8      # wgmma path: fp32 epilogue tile row padding
WGMMA_ALIGN = 1024      # wgmma path: swizzle-atom alignment slack
MBARRIER_BYTES = 8
PATHS = ("tiled", "splitk", "wgmma")

# csrc/wkv6.cu's layouts (the kernels' constants; tests read them back)
WKV_FMA_THREADS = 256   # fma path: threads of a block
WKV_TC_THREADS = 256    # tensor-core path: threads of a block
WKV_TC_ROWS = {32: 64, 64: 64, 128: 16}   # its compiled rows per block
WKV_TC_PAD = 8          # its row padding, in elements
WKV_MAX_CLUSTER = 8     # its blocks per cluster, at most
WKV_PATHS = ("tensor_core", "fma")

# csrc/flash_attention.cu's layouts (the kernels' constants; tests read
# them back)
FLASH_THREADS = 128     # both paths: threads of a block
FLASH_BQ = 64           # queries of a block
FLASH_BK = 64           # keys of a K/V tile
FLASH_TC_PAD = 8        # tensor-core path: row padding, in elements
FLASH_HEAD_DIMS = (32, 64, 112, 128, 256)   # the compiled head dims
FLASH_PATHS = ("tensor_core", "fma")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def splitk_rows(m: int) -> int:
    """Rows the split-K decode kernel is compiled for: 4, 8 or 16."""
    return 4 if m <= 4 else 8 if m <= 8 else 16


def smem_plan(m: int, k: int, n: int, bm: int, bn: int, bk: int = 0,
              elem_bytes: int = 2, trans_b: bool = False, stages: int = 1,
              chip: GPUChip = H100, *, path: str = "tiled") -> dict:
    """Shared-memory feasibility of one spm_matmul block: the port's
    stand-in for the reference's ``vmem_plan``, for each of the three
    kernels of ``csrc/spm_matmul.cu`` (whose launchers size their
    dynamic shared memory by the same sums).

    ``tiled``: each of ``stages`` buffers holds an A slab [bm, bkc] and a
    B slab of bkc rows of K (laid out [bn, bkc] for a transposed B,
    [bkc, bn] otherwise), each row padded by ``SMEM_PAD`` elements;
    ``bkc`` is ``bk`` (the whole K when ``bk == 0``) rounded up to the
    16-deep MMA step.

    ``splitk``: ``bk`` is the block's K slice; the block keeps that
    slice of A in fp32 ([bk, rows], rows = ``splitk_rows(m)``), one
    fp32 [rows, bn] partial per warp and the block's own [rows, bn]
    partial, which the cluster reads.

    ``wgmma``: ``stages`` ring stages of an A box [bm, bk] and a B box
    [bk, bn] in ``elem_bytes``, a full and an empty mbarrier per stage,
    and 1 KB of slack to align the 128-byte swizzle atoms; the
    epilogue's fp32 [bm, bn + WGMMA_PART_PAD] tile (with ``splits`` > 1
    the block's partial, which the cluster reads) reuses the drained
    stages.

    ``m`` and ``n`` enter only through ``rows``: edges are masked, not
    padded in memory."""
    del n
    if path == "tiled":
        bkc = _round_up(k if bk <= 0 else min(bk, k), 16)
        a = bm * (bkc + SMEM_PAD)
        b = bn * (bkc + SMEM_PAD) if trans_b else bkc * (bn + SMEM_PAD)
        need = stages * (a + b) * elem_bytes
    elif path == "splitk":
        bkc = bk
        rows = splitk_rows(m)
        need = 4 * (bk * rows + (SPLITK_WARPS + 1) * rows * bn)
    elif path == "wgmma":
        bkc = bk
        ring = stages * (bm + bn) * bk * elem_bytes
        tile = bm * (bn + WGMMA_PART_PAD) * 4
        need = WGMMA_ALIGN + max(ring, tile) + 2 * stages * MBARRIER_BYTES
    else:
        raise ValueError(f"path {path!r} not in {PATHS}")
    return {"smem_need": need, "smem_bytes": chip.smem_bytes,
            "fits": need <= chip.smem_bytes, "bkc": bkc}


def blocks_per_sm(need: int, threads: int, chip: GPUChip = H100) -> int:
    """Blocks of ``need`` bytes of shared memory and ``threads`` threads
    one SM holds at once, by shared memory and threads (registers not
    counted)."""
    return min(chip.sm_smem_bytes // (need + chip.smem_reserved),
               chip.max_threads_per_sm // threads)


def wkv_smem_plan(chunk: int, K: int, chip: GPUChip = H100, *,
                  path: str = "fma", groups: int = 1) -> dict:
    """Shared-memory feasibility of one ``csrc/wkv6.cu`` block: the
    port's stand-in for the reference's ``cost_model.py`` VMEM rule for
    a wkv6 chunk, and the blocks one SM holds.

    ``fma``: the block keeps, in fp32: the [K, K] state; r, k, the
    anchored k and the cumulative log-decay of the chunk ([chunk, K + 1]
    each, rows padded by one against bank conflicts); v [chunk, K]; the
    intra-chunk matrix [chunk, chunk + 1]; the u-bonus per row; u and
    the chunk's total decay per channel.  ``smem_floats`` in
    ``csrc/wkv6.cu`` is the same sum.

    ``tensor_core``: ``chunk`` is the block's rows, which the kernel is
    compiled for (``WKV_TC_ROWS[K]``; ``tc_smem_bytes`` in the source is
    the same sum), rows padded by ``WKV_TC_PAD`` elements (P = K + pad):
    in fp32 the cumulative log2-decay [max(rows, K), P], whose space the
    chunk's state contribution [K, P] takes over (the cluster reads it),
    and exp2(total) and u per channel; in bf16 r, v and the lo part of
    the anchored keys (later of r exp2(e)) [rows, P], k and the hi part
    of the anchored keys [max(rows, K), P] (later the hi and lo parts of
    the state product's keys, then of the incoming state) and the hi
    and lo parts of the intra-chunk matrix [rows, rows + pad]; with
    ``groups`` > 1 the [K, K] fp32 carry between the cluster's groups."""
    L = chunk
    if path == "fma":
        need = 4 * (K * K + 4 * L * (K + 1) + L * K + L * (L + 1) + L + 2 * K)
        threads = WKV_FMA_THREADS
    elif path == "tensor_core":
        P, kr = K + WKV_TC_PAD, max(L, K)
        need = (4 * (kr * P + 2 * K)
                + 2 * ((3 * L + 2 * kr) * P + 2 * L * (L + WKV_TC_PAD))
                + (4 * K * K if groups > 1 else 0))
        threads = WKV_TC_THREADS
    else:
        raise ValueError(f"path {path!r} not in {WKV_PATHS}")
    return {"smem_need": need, "smem_bytes": chip.smem_bytes,
            "fits": need <= chip.smem_bytes,
            "blocks_per_sm": blocks_per_sm(need, threads, chip)}


def flash_smem_plan(D: int, path: str, chip: GPUChip = H100) -> dict:
    """Shared-memory feasibility of one ``csrc/flash_attention.cu``
    block at head dim ``D``, and the blocks one SM holds; the wrapper
    checks it before each launch.

    ``tensor_core``: bf16 Q [FLASH_BQ, D + FLASH_TC_PAD] and two buffers
    each of K and V [FLASH_BK, D + FLASH_TC_PAD] (``launch_tc`` in the
    source sizes the same sum).  ``fma``: fp32 Q, K and V with rows
    padded by one [rows, D + 1], and p [FLASH_BQ, FLASH_BK + 1]
    (``launch_d``)."""
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {FLASH_HEAD_DIMS}")
    if path == "tensor_core":
        need = (FLASH_BQ + 4 * FLASH_BK) * (D + FLASH_TC_PAD) * 2
    elif path == "fma":
        need = ((FLASH_BQ + 2 * FLASH_BK) * (D + 1)
                + FLASH_BQ * (FLASH_BK + 1)) * 4
    else:
        raise ValueError(f"path {path!r} not in {FLASH_PATHS}")
    return {"smem_need": need, "smem_bytes": chip.smem_bytes,
            "fits": need <= chip.smem_bytes,
            "blocks_per_sm": blocks_per_sm(need, FLASH_THREADS, chip)}


def gpu_matmul_schedule(m: int, k: int, n: int, *, n_devices: int = 1,
                        tile_m: int = 64, tile_n: int = 128,
                        elem_bytes: int = 2,
                        chip: GPUChip = H100) -> Schedule:
    """B-stationary blocked matmul on one or more H100s.

    N is partitioned across devices (the paper's B-column blocks);
    within a device, column block ``tn`` belongs to SM ``tn % num_sms``,
    which receives its [k, tile_n] B block once and then streams the
    [tile_m, k] A tiles against it; C tiles stream back to HBM."""
    assert n % n_devices == 0
    n_local = n // n_devices
    tiles_m = math.ceil(m / tile_m)
    tiles_n = math.ceil(n_local / tile_n)
    smem = smem_plan(m, k, n, tile_m, tile_n, 0, elem_bytes, chip=chip)
    sched = Schedule(meta={"kind": "gpu_matmul", "m": m, "k": k, "n": n,
                           "n_devices": n_devices, "tile_m": tile_m,
                           "tile_n": tile_n,
                           "smem_need": smem["smem_need"],
                           "smem_ok": smem["fits"]})
    for dev in range(n_devices):
        prev_comp = {}
        for tn in range(tiles_n):
            sm = dev * chip.num_sms + tn % chip.num_sms
            prev = prev_comp.get(sm)
            b_load = sched.add(
                kind="dma_load", resource=DMA,
                bytes_moved=k * tile_n * elem_bytes, spm_core=sm,
                deps=(prev,) if prev is not None else (),
                tag=f"B[{tn}]->sm{sm}")
            for tm in range(tiles_m):
                a_load = sched.add(
                    kind="dma_load", resource=DMA,
                    bytes_moved=tile_m * k * elem_bytes,
                    deps=(b_load,), spm_core=sm,
                    tag=f"A[{tm}]->sm{sm}")
                comp = sched.add(
                    kind="compute", resource=core_resource(sm),
                    deps=(a_load,) + ((prev,) if prev is not None else ()),
                    macs=tile_m * k * tile_n,
                    elems=tile_m * tile_n, spm_core=sm,
                    tag=f"C[{tm},{tn}]@sm{sm}")
                sched.add(
                    kind="dma_store", resource=DMA,
                    bytes_moved=tile_m * tile_n * elem_bytes,
                    deps=(comp,), spm_core=sm, tag=f"C[{tm},{tn}]->hbm")
                prev = comp
            prev_comp[sm] = prev
    sched.validate_dag()
    sched.validate_interference_freedom()
    return sched


def serve_step_schedule(batch: int, d_model: int, n_params: int, *,
                        plan: dict, elem_bytes: int = 2,
                        chip: GPUChip = H100) -> Schedule:
    """Static schedule for one decode step's weight pass, tiled by the
    SERVED plan's ``mm_bm``/``mm_bn`` pins, with the reference's sizing
    rule: an effective [batch, d_model, 2*n_params/d_model] matmul.
    Its ``gpu_wcet`` is the bound ``serve_step_wcet`` computes in closed
    form (the tests hold the two equal)."""
    n_eff = max(d_model, 2 * n_params // d_model)
    tile_m = max(1, min(int(plan["mm_bm"]), batch))
    tile_n = max(1, min(int(plan["mm_bn"]), n_eff))
    return gpu_matmul_schedule(batch, d_model, n_eff, tile_m=tile_m,
                               tile_n=tile_n, elem_bytes=elem_bytes,
                               chip=chip)


def serve_step_wcet(batch: int, d_model: int, n_params: int, *,
                    plan: dict, elem_bytes: int = 2,
                    chip: GPUChip = H100) -> float:
    """The per-step WCET bound of serving (``launch.serve.plan_wcet_s``)
    and of training's deadline (``launch.train``):
    ``gpu_wcet(serve_step_schedule(...))`` in closed form, without
    building the schedule: at a training batch (16,384 rows of qwen2)
    the schedule holds ~6.6 M phases and takes ~35 s of host time to
    build.  Same phases, same per-phase times: every column block loads
    B once and each row tile loads A and stores C; the slowest SM runs
    ceil(column blocks / SMs) blocks of ``tiles_m`` tile products."""
    n_eff = max(d_model, 2 * n_params // d_model)
    tile_m = max(1, min(int(plan["mm_bm"]), batch))
    tile_n = max(1, min(int(plan["mm_bn"]), n_eff))
    tiles_m = math.ceil(batch / tile_m)
    tiles_n = math.ceil(n_eff / tile_n)
    rate = chip.hbm_bw * chip.worst_hbm_derate
    k = d_model
    dma = tiles_n * (k * tile_n * elem_bytes / rate + tiles_m * (
        tile_m * k * elem_bytes / rate
        + tile_m * tile_n * elem_bytes / rate))
    per_sm = chip.peak_flops / chip.num_sms
    comp = 2.0 * tile_m * k * tile_n / (per_sm * chip.worst_tc_eff)
    return dma + math.ceil(tiles_n / chip.num_sms) * tiles_m * comp


def gpu_phase_wcet(ph, chip: GPUChip = H100) -> float:
    """Worst-case seconds for one phase: compute at one SM's share of
    the derated tensor-core peak, transfers at the derated HBM rate."""
    if ph.kind == "compute":
        per_sm = chip.peak_flops / chip.num_sms
        return 2.0 * ph.macs / (per_sm * chip.worst_tc_eff)
    return ph.bytes_moved / (chip.hbm_bw * chip.worst_hbm_derate)


def _totals(sched: Schedule, chip: GPUChip):
    dma_total = 0.0
    per_core = {}
    for p in sched.phases:
        t = gpu_phase_wcet(p, chip)
        if p.kind == "compute":
            per_core[p.resource] = per_core.get(p.resource, 0.0) + t
        else:
            dma_total += t
    return dma_total, (max(per_core.values()) if per_core else 0.0)


def gpu_wcet(sched: Schedule, chip: GPUChip = H100) -> float:
    """Compositional bound: serialized HBM traffic + slowest-SM chain."""
    dma_total, comp = _totals(sched, chip)
    return dma_total + comp


def gpu_steady_state(sched: Schedule, chip: GPUChip = H100) -> float:
    """Overlap-aware estimate: max(total HBM traffic, slowest SM)."""
    dma_total, comp = _totals(sched, chip)
    return max(dma_total, comp)
