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
from typing import Optional

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
SPLITK_BK = 64          # split-K decode path: K depth of a stage (128
#                         bf16 bytes)
WGMMA_BK = 64           # wgmma path: K depth of a stage (128 bf16 bytes)
WGMMA_PART_PAD = 8      # wgmma path: fp32 epilogue tile row padding
WGMMA_ALIGN = 1024      # wgmma and split-K: swizzle-atom alignment slack
MBARRIER_BYTES = 8
PATHS = ("tiled", "splitk", "wgmma")

# csrc/wkv6.cu's layouts (the kernels' constants; tests read them back)
WKV_FMA_THREADS = 256   # fma path: threads of a block
WKV_TC_THREADS = 256    # tensor-core path: threads of a block
WKV_TC_ROWS = {32: 64, 64: 64, 128: 16}   # its compiled rows per block
WKV_TC_PAD = 8          # its row padding, in elements
WKV_MAX_CLUSTER = 8     # its blocks per cluster, at most
WKV_PATHS = ("tensor_core", "fma")
WKV_BWD_THREADS = 256   # csrc/wkv6_bwd.cu: threads of a block
WKV_BWD_ROWS = {32: 64, 64: 32, 128: 16}   # its fma path's chunk rows
WKV_BWD_TC_ROWS = {32: 32, 64: 32, 128: 16}   # its tensor-core path's
WKV_BWD_TC_PAD = 8      # tensor-core path: row padding, in elements

# csrc/flash_attention.cu's layouts (the kernels' constants; tests read
# them back)
FLASH_THREADS = 128     # fma: threads of a block; tensor_core: of a warpgroup
FLASH_HEAD_DIMS = (32, 64, 112, 128, 256)   # the backward's compiled dims
# the forward's: 224 serves zamba2-7b-instruct's tied blocks, which
# take no gradient (serving only)
FLASH_FWD_HEAD_DIMS = (32, 64, 112, 128, 224, 256)
FLASH_PATHS = ("tensor_core", "fma")
FLASH_FMA_BQ = 64       # fma: queries of a block
FLASH_FMA_BK = 64       # fma: keys of a K/V tile
FLASH_TC_WG_ROWS = 64   # tensor_core: query rows of a consumer warpgroup
FLASH_TC_CONSUMERS = 2  # tensor_core: consumer warpgroups of a block (and
#                         one producer warpgroup)
FLASH_TC_KEYS = 64      # tensor_core: keys of a K/V tile
FLASH_TC_CHUNK = 64     # tensor_core: head dims of a TMA box (128 bytes)
FLASH_TC_STAGES = 3     # tensor_core: K/V ring stages
FLASH_TC_REGS = (24, 240)   # tensor_core: setmaxnreg of the producer and
#                             of each consumer warpgroup
FLASH_TC_REG_BUDGET = 120   # of a consumer's 240, for its live tiles
FLASH_FWD_LO_MAX_D = 128  # tensor_core: the largest head dim whose forward
#                           writes o_lo (at 256 a second accumulator would
#                           not fit), so whose backward reads D_i from it
# csrc/flash_attention_bwd.cu's layouts (the kernels' constants; tests
# read them back)
FLASH_BWD_TILE = 64     # rows of a tile (fma: a block's own rows;
#                         tensor_core: a consumer warpgroup's wgmma M)
FLASH_BWD_TC_CHUNK = 64  # tensor_core: head dims of a TMA box (128 bytes)
FLASH_BWD_TC_SPLIT_D = 64   # tensor_core: above this head dim the dK/dV
#                             block's two warpgroups split the head dim
FLASH_BWD_TC_WIDE_D = 128   # tensor_core: above this head dim the dQ
#                             block has one warpgroup, both two stages
FLASH_BWD_TC_PRODUCER = 32  # tensor_core: each block's producer warp
FLASH_BWD_FMA_WIDE_D = 128   # fma: above this head dim the streamed tile
FLASH_BWD_FMA_NARROW = 32    # is 32 rows (else FLASH_BWD_TILE) and dK/dV
#                              takes 4 threads a key row (else 2)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def splitk_rows(m: int) -> int:
    """A's rows in the split-K decode kernel's box, wgmma's N: 8 or 16."""
    return 8 if m <= 8 else 16


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

    ``wgmma``: ``stages`` ring stages of an A box [bm, bk] and a B box
    [bk, bn] in ``elem_bytes``, a full and an empty mbarrier per stage,
    and 1 KB of slack to align the 128-byte swizzle atoms; the
    epilogue's fp32 [bm, bn + WGMMA_PART_PAD] tile (with ``splits`` > 1
    the block's partial, which the cluster reads) reuses the drained
    stages.

    ``splitk``: the same ring, of a B box [bk, bn] and an A box of
    ``bm`` rows (``splitk_rows(m)``, zero-filled past M) a stage; the
    block's fp32 [bm, bn] partial, which the cluster reads, reuses the
    drained stages.  K does not enter: the ring streams any slice.

    ``m`` and ``n`` do not enter (split-K's rows come as ``bm``): edges
    are masked or zero-filled, not padded in memory."""
    del m, n
    if path == "tiled":
        bkc = _round_up(k if bk <= 0 else min(bk, k), 16)
        a = bm * (bkc + SMEM_PAD)
        b = bn * (bkc + SMEM_PAD) if trans_b else bkc * (bn + SMEM_PAD)
        need = stages * (a + b) * elem_bytes
    elif path in ("splitk", "wgmma"):
        bkc = bk
        ring = stages * (bm + bn) * bk * elem_bytes
        pad = WGMMA_PART_PAD if path == "wgmma" else 0
        tile = bm * (bn + pad) * 4
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


def wkv_bwd_smem_plan(K: int, chip: GPUChip = H100, *, path: str = "fma",
                      rows: int = 0, states: bool = False) -> dict:
    """Shared-memory feasibility of one ``csrc/wkv6_bwd.cu`` block and
    the blocks one SM holds.

    ``fma`` (one (b, h), chunks of ``WKV_BWD_ROWS[K]`` rows L): in fp32
    r, k, v, dy, the cumulative log-decay, a = r (S dy) and a - k (dS v)
    [L, K + 1] each (rows padded by one against bank conflicts); the
    chunk's incoming state and the carried adjoint [K, K + 1]; the
    intra-chunk A and dy . v [L, L + 1]; g and r u k per row; the total
    decay, u, the boundary term Q and du per channel.
    ``bwd_smem_floats`` in the source is the same sum.

    ``tensor_core`` (one chunk of ``rows`` rows L, default
    ``WKV_BWD_TC_ROWS[K]``; ``TcLayout`` in the source is the same sum),
    rows padded by ``WKV_BWD_TC_PAD`` elements (P = K + pad, PL = L +
    pad): in fp32 [L, P] the cumulative log2-decay, the diagonal
    sub-tiles' dr and dk (later a = r dr and a - k dk) and two derived
    operands (kd and r exp2(e), then the anchored k and r, then kd);
    [K, P] the state and the adjoint (the chunk's contributions, which
    the cluster folds in place into S_in and dS_out); [L, PL] dy v^T and
    A^T; per channel exp2(total), u and Q; per row g and r u k; in bf16
    r, k, v and dy [L, P].  ``states=True``: the states launch's block
    (``StLayout``): fp32 the log-decay and kd [L, P] and exp2(total);
    bf16 k and v [L, P].
    ``resident``: the gradient launch's blocks an SM (two where two fit:
    its launch bounds hold it to 128 registers a thread there)."""
    if path == "fma":
        L = WKV_BWD_ROWS[K]
        need = 4 * (7 * L * (K + 1) + 2 * K * (K + 1) + 2 * L * (L + 1)
                    + 2 * L + 4 * K)
    elif path == "tensor_core":
        L = rows or WKV_BWD_TC_ROWS[K]
        P, PL = K + WKV_BWD_TC_PAD, L + WKV_BWD_TC_PAD
        if states:
            need = 4 * (2 * L * P + K) + 2 * 2 * L * P
        else:
            need = (4 * (5 * L * P + 2 * K * P + 2 * L * PL + 3 * K + 2 * L)
                    + 2 * 4 * L * P)
    else:
        raise ValueError(f"path {path!r} not in {WKV_PATHS}")
    resident = blocks_per_sm(need, WKV_BWD_THREADS, chip)
    return {"rows": L, "smem_need": need, "smem_bytes": chip.smem_bytes,
            "fits": need <= chip.smem_bytes, "blocks_per_sm": resident,
            # the gradient launch is compiled for two blocks an SM (128
            # registers a thread) where two fit, else one
            "resident": min(2, resident)}


def flash_tc_registers(D: int, lo: bool) -> dict:
    """The ``tensor_core`` kernel's schedule at head dim ``D`` (``lo``:
    the o_lo kernel), from the fp32 registers a consumer thread keeps
    live across a key tile (``tc_live_regs``, ``tc_split`` and
    ``tc_overlap`` in the source): O takes dp / 2 (dp the head dims the
    warpgroup holds, padded to ``FLASH_TC_CHUNK``), the tile's scores
    ``FLASH_TC_KEYS`` / 2 and, overlapped (the next tile's S beside the
    last P V), p as the PV product's bf16 A operand ``FLASH_TC_KEYS`` /
    4; with ``lo`` a second O and a second p.  The two warpgroups split
    the head dim (``split``: both on the block's 64 query rows) where
    one holding all of it does not fit ``FLASH_TC_REG_BUDGET`` in
    series; a warpgroup overlaps where its tiles fit that way
    (``overlap``).  ``live`` is the schedule's count.  The rule holds at
    any head dim (the CPU models run it at small ones); the kernel is
    compiled at ``FLASH_FWD_HEAD_DIMS``.  At 224 (padded to 256) it is
    256's schedule: O of all 224 would take 128 registers padded (112
    unpadded) beside the scores' 32, over the budget, so the warpgroups
    split the head dim."""
    n = 2 if lo else 1

    def live(dp, overlap):
        return (dp // 2 * n + FLASH_TC_KEYS // 2
                + (FLASH_TC_KEYS // 4 * n if overlap else 0))
    dp = _round_up(D, FLASH_TC_CHUNK)
    split = live(dp, False) > FLASH_TC_REG_BUDGET
    held = dp // 2 if split else dp
    overlap = live(held, True) <= FLASH_TC_REG_BUDGET
    return {"split": split, "overlap": overlap, "head_dims": held,
            "live": live(held, overlap), "budget": FLASH_TC_REG_BUDGET,
            "rows": FLASH_TC_WG_ROWS * (1 if split else FLASH_TC_CONSUMERS)}


def flash_tile(D: int, path: str) -> tuple:
    """(queries of a block, keys of a K/V tile) that ``path``'s kernel
    serving runs is compiled for at head dim ``D`` (the o_lo kernel's
    rows: ``flash_tc_registers``)."""
    if path == "tensor_core":
        return flash_tc_registers(D, False)["rows"], FLASH_TC_KEYS
    if path == "fma":
        return FLASH_FMA_BQ, FLASH_FMA_BK
    raise ValueError(f"path {path!r} not in {FLASH_PATHS}")


def flash_smem_plan(D: int, path: str, chip: GPUChip = H100,
                    lo: bool = False) -> dict:
    """Shared-memory feasibility of one ``csrc/flash_attention.cu``
    block at head dim ``D`` (``lo``: the o_lo kernel's), and the blocks
    one SM holds; the wrapper checks it before each launch.

    ``tensor_core`` (``tc_smem`` in the source sums the same way): TMA
    boxes of 64 rows by ``FLASH_TC_CHUNK`` head dims (8 KB, 128-byte
    swizzle), the head dim padded to a multiple of 64: 1 KB of
    alignment slack, the block's Q [rows, D] (``flash_tc_registers``'
    rows), then a ring of ``FLASH_TC_STAGES`` stages of a K and a V tile
    [``FLASH_TC_KEYS``, D], and an 8-byte ``full`` and ``empty`` barrier
    a stage and one for Q; one block an SM (its launch bounds'
    registers).  ``fma``: fp32 Q, K and
    V with rows padded by one [rows, D + 1], and p [FLASH_FMA_BQ,
    FLASH_FMA_BK + 1] (``launch_d``).  Compiled at
    ``FLASH_FWD_HEAD_DIMS``."""
    if D not in FLASH_FWD_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {FLASH_FWD_HEAD_DIMS}")
    if path == "tensor_core":
        tile = -(-D // FLASH_TC_CHUNK) * FLASH_TC_WG_ROWS * FLASH_TC_CHUNK * 2
        rows = flash_tc_registers(D, lo)["rows"]
        q_bytes = rows // FLASH_TC_WG_ROWS * tile
        stages = FLASH_TC_STAGES
        need = 1024 + q_bytes + stages * 2 * tile + (2 * stages + 1) * 8
        threads = FLASH_THREADS * (FLASH_TC_CONSUMERS + 1)
        return {"smem_need": need, "smem_bytes": chip.smem_bytes,
                "fits": need <= chip.smem_bytes,
                "blocks_per_sm": min(1, blocks_per_sm(need, threads, chip)),
                "stages": stages, "stage_bytes": 2 * tile,
                "q_bytes": q_bytes, "rows": rows, "keys": FLASH_TC_KEYS,
                "threads": threads}
    if path == "fma":
        need = ((FLASH_FMA_BQ + 2 * FLASH_FMA_BK) * (D + 1)
                + FLASH_FMA_BQ * (FLASH_FMA_BK + 1)) * 4
    else:
        raise ValueError(f"path {path!r} not in {FLASH_PATHS}")
    return {"smem_need": need, "smem_bytes": chip.smem_bytes,
            "fits": need <= chip.smem_bytes,
            "blocks_per_sm": blocks_per_sm(need, FLASH_THREADS, chip)}


def flash_bwd_smem_plan(D: int, path: str, chip: GPUChip = H100,
                        shape: Optional[tuple] = None) -> dict:
    """Shared memory, threads and warpgroups of the blocks of
    ``csrc/flash_attention_bwd.cu`` at head dim ``D``, and whether each
    fits; the wrapper checks it before each launch.

    ``tensor_core`` (bf16; the source's ``tc_dq_smem`` and
    ``tc_dkdv_smem`` sum the same way): warpgroups of 64 rows each,
    compiled for one block an SM.  Tiles are TMA boxes of 64 rows by
    ``FLASH_BWD_TC_CHUNK`` head dims (8 KB, 128-byte swizzle), the head
    dim padded to a multiple of 64.  ``dq`` (two warpgroups, one above
    head dim ``FLASH_BWD_TC_WIDE_D``, and a producer warp of
    ``FLASH_BWD_TC_PRODUCER`` threads): the block's q and dO [64 x
    warpgroups, D] once, then three stages (two above that head dim) of
    a K and a V tile [64, D], walked once (twice above it: D_i, then dQ).
    ``dkdv`` (two warpgroups and a producer warp): the block's k and v
    [keys, D]
    (128 keys; 64 above head dim ``FLASH_BWD_TC_SPLIT_D``, where each
    warpgroup keeps half the head dim's dK and dV), then three stages
    (two above ``FLASH_BWD_TC_WIDE_D``) of a q and a dO tile [64, D]
    with lse and D_i of their 64 rows in fp32.  Each adds 1 KB of
    alignment slack and an 8-byte ``full`` and ``empty`` barrier a
    stage and one for its own tiles.  With ``shape`` = (B, Sk, H, KV)
    and H > KV the plan gives ``scratch_bytes``: each head's fp32 dK and
    dV partials [B, Sk, H, D], which a third launch sums over the GQA
    group.

    ``fma`` (fp32, rows padded by one; ``fma_dq_smem``, ``fma_dkdv_smem``):
    the own tiles [64, D + 1], the streamed tiles [T, D + 1] (T = 64, or
    ``FLASH_BWD_FMA_NARROW`` above head dim ``FLASH_BWD_FMA_WIDE_D``), dS
    [64, T + 1] (dK/dV: P too and lse and D_i of the T streamed rows); dQ
    2 threads a query row, dK/dV 2 (4 above that head dim) a key row."""
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {FLASH_HEAD_DIMS}")
    R = FLASH_BWD_TILE
    if path == "tensor_core":
        box = R * FLASH_BWD_TC_CHUNK * 2
        nc = -(-D // FLASH_BWD_TC_CHUNK)
        split = D > FLASH_BWD_TC_SPLIT_D
        wide = D > FLASH_BWD_TC_WIDE_D
        wgs = {"dq": 1 if wide else 2, "dkdv": 2}
        rows = {"dq": R * wgs["dq"], "dkdv": R * (1 if split else 2)}
        stages = {"dq": 2 if wide else 3, "dkdv": 2 if wide else 3}
        own = {n: 2 * (rows[n] // R) * nc * box for n in wgs}
        stage = {"dq": 2 * nc * box, "dkdv": 2 * nc * box + 2 * R * 4}
        need = {n: 1024 + own[n] + stages[n] * stage[n]
                + (2 * stages[n] + 1) * 8 for n in wgs}
        threads = {n: FLASH_THREADS * wgs[n] + FLASH_BWD_TC_PRODUCER
                   for n in wgs}
        detail = {n: {"warpgroups": wgs[n], "stages": stages[n],
                      "stage_bytes": stage[n], "own_bytes": own[n],
                      "rows": rows[n]} for n in wgs}
        resident = 1        # the launch bounds' registers: one an SM
    elif path == "fma":
        wide = D > FLASH_BWD_FMA_WIDE_D
        T = FLASH_BWD_FMA_NARROW if wide else R
        own = 2 * (R + T) * (D + 1)
        need = {"dq": 4 * (own + R * (T + 1)),
                "dkdv": 4 * (own + 2 * R * (T + 1) + 2 * T)}
        threads = {"dq": 2 * R, "dkdv": (4 if wide else 2) * R}
        detail = {n: {} for n in need}
        resident = None
    else:
        raise ValueError(f"path {path!r} not in {FLASH_PATHS}")
    kernels = {}
    for name in need:
        per_sm = blocks_per_sm(need[name], threads[name], chip)
        kernels[name] = {"smem_need": need[name], "threads": threads[name],
                         "fits": need[name] <= chip.smem_bytes,
                         "blocks_per_sm": (per_sm if resident is None
                                           else min(per_sm, resident)),
                         **detail[name]}
    worst = max(need.values())
    plan = {"kernels": kernels, "smem_need": worst,
            "smem_bytes": chip.smem_bytes, "fits": worst <= chip.smem_bytes}
    if shape is not None and path == "tensor_core":
        B, Sk, H, KV = shape
        plan["scratch_bytes"] = 0 if H == KV else 2 * B * Sk * H * D * 4
    return plan


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
