"""The port's kernels against the JAX package's (CPU, small shapes).

For CPU tensors each wrapper runs its kernel's plain PyTorch version;
these tests hold that plain version against the reference's Pallas
kernel in interpret mode and against its ``ref.py`` oracle, on the same
numpy-seeded inputs, under ``conftest.KERNEL_TOLERANCES`` (fp32 1e-5;
bf16 3e-2, which absorbs p rounded to bf16 before the PV product, as
the TPU kernel and the CUDA kernel do while the model's chunked sdpa
keeps it in fp32, and the frameworks' other rounding points).  The
plan rules (spm_matmul's tile clamping, shared-memory fit and ``bk``
halving; wkv6's chunk halving) are host code and are tested here too;
the plain wkv6 against the Pallas kernel is in ``test_torch_rwkv.py``.

The CUDA kernels themselves cannot run here.  The tests marked ``gpu``
launch them on a card and skip elsewhere; ``chip_smoke.py`` holds them
against their plain versions at the main path's shapes.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KERNEL_TOLERANCES, assert_kernel_close
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.spm_matmul.ops import matmul as jax_matmul
from repro.kernels.spm_matmul.ref import matmul_ref as jax_matmul_ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import gpu_mapping
from repro_torch.core.gpu_mapping import H100, smem_plan, wkv_smem_plan
from repro_torch.kernels import (CONFORMANCE_SHAPES, KERNEL_REGISTRY,
                                 _build, import_entry, tolerance)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.spm_matmul import ops as mm_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x, dtype):
    """numpy array in ``dtype`` (bf16 as an ml_dtypes array)."""
    return np.asarray(jnp.asarray(x, JDT[dtype]))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


# ------------------------------------------------------------ spm_matmul

MATMUL_CASES = [c[:3] + (c[6], None) for c in
                CONFORMANCE_SHAPES["spm_matmul"]] + [
    (4, 128, 384, "bfloat16", None),          # decode-like
    (4, 128, 384, "bfloat16", "float32"),
    (3, 64, 96, "float32", "float32"),
    (3, 64, 96, "bfloat16", "float32"),
]


@pytest.mark.parametrize("m,k,n,dtype,out", MATMUL_CASES)
def test_plain_matmul_matches_reference(m, k, n, dtype, out):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = _np(rng.standard_normal((m, k), np.float32), dtype)
    b = _np(rng.standard_normal((k, n), np.float32), dtype)
    out_t = torch.float32 if out else None
    got = mm_ops.matmul(tensor_from_numpy(a), tensor_from_numpy(b),
                        out_dtype=out_t)
    assert got.dtype == (torch.float32 if out else got.dtype)
    want = jax_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                          out_dtype=jnp.float32 if out else None)
    assert_kernel_close(_f32(got), _f32(want), dtype)
    if out is None:   # the Pallas kernel returns A's dtype
        pallas = jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
        assert_kernel_close(_f32(got), _f32(pallas), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matmul_transposed_b_reads_table_in_place(dtype):
    """The logits path: B given as the [N, K] table, no transposed copy
    on the caller's side."""
    rng = np.random.default_rng(7)
    a = _np(rng.standard_normal((4, 64), np.float32), dtype)
    table = _np(rng.standard_normal((96, 64), np.float32), dtype)
    got = mm_ops.matmul(tensor_from_numpy(a), tensor_from_numpy(table),
                        trans_b=True, out_dtype=torch.float32)
    want = jax_matmul_ref(jnp.asarray(a), jnp.asarray(table).T,
                          out_dtype=jnp.float32)
    assert_kernel_close(_f32(got), _f32(want), dtype)


def test_plain_path_does_not_count_launches():
    before = mm_ops.matmul.launches
    mm_ops.matmul(torch.ones(2, 16), torch.ones(16, 8))
    assert mm_ops.matmul.launches == before


@pytest.mark.parametrize("a_shape,b_shape,kw,err", [
    ((4, 8), (9, 4), {}, ValueError),                      # K mismatch
    ((4, 8), (4, 8), {"trans_b": False}, ValueError),
    ((4, 8, 1), (8, 4), {}, ValueError),                   # not 2-D
    ((4, 8), (8, 4), {"out_dtype": torch.float16}, TypeError),
])
def test_matmul_rejects_bad_operands(a_shape, b_shape, kw, err):
    with pytest.raises(err):
        mm_ops.matmul(torch.ones(a_shape), torch.ones(b_shape), **kw)


def test_matmul_rejects_mixed_dtypes():
    with pytest.raises(TypeError):
        mm_ops.matmul(torch.ones(2, 8), torch.ones(8, 2,
                                                   dtype=torch.bfloat16))


@pytest.mark.parametrize("m,k,n,want", [
    # decode, 14 blocks: the small-M tile, whole K resident
    (4, 896, 896, (16, 64, 0, 896, 1)),
    # decode, 14 blocks, K too deep to pin: 512-deep slabs, two buffers
    (4, 4864, 896, (16, 64, 512, 512, 2)),
    # decode logits, 2374 blocks: 64-deep slabs, two buffers
    (4, 896, 151_936, (16, 64, 64, 64, 2)),
    # prefill, 608 blocks
    (1024, 896, 4864, (64, 128, 64, 64, 2)),
    (20, 896, 32, (32, 64, 0, 896, 1)),       # ragged M, narrow N
])
def test_default_plan_follows_the_grid(m, k, n, want):
    plan = mm_ops.resolve_plan(m, k, n, 2, n == 151_936)
    assert (plan["bm"], plan["bn"], plan["bk"], plan["bkc"],
            plan["stages"]) == want
    assert (plan["bm"], plan["bn"]) in mm_ops.TILES
    assert smem_plan(m, k, n, plan["bm"], plan["bn"], plan["bk"], 2,
                     n == 151_936, plan["stages"])["fits"]


def test_whole_k_plan_halves_bk_until_it_fits():
    """bk == 0 pins the whole K; when that overflows the 227 KB of
    shared memory the wrapper halves bk from 512, as the reference's
    vmem fallback does."""
    assert not smem_plan(4, 4864, 896, 16, 64, 0)["fits"]
    plan = mm_ops.resolve_plan(4, 4864, 896, 2, False, bk=0)
    assert plan["bk"] == 512
    assert smem_plan(4, 4864, 896, plan["bm"], plan["bn"],
                     plan["bk"])["smem_need"] <= H100.smem_bytes
    small = mm_ops.resolve_plan(4, 896, 896, 2, False, bk=0)
    assert small["bk"] == 0 and small["bkc"] == 896     # resident K fits


@pytest.mark.parametrize("kw", [{"bk": 24}, {"bm": 8}, {"bn": 32}])
def test_plan_rejects_what_the_kernel_does_not_take(kw):
    with pytest.raises(ValueError):
        mm_ops.resolve_plan(64, 128, 128, 4, False, **kw)


def test_smem_rule_matches_transposed_layout():
    # [bn, bkc] for a transposed B, [bkc, bn] otherwise, rows padded
    t = smem_plan(4, 64, 64, 16, 64, 64, 2, trans_b=True)
    n = smem_plan(4, 64, 64, 16, 64, 64, 2, trans_b=False)
    assert t["smem_need"] == (16 * 72 + 64 * 72) * 2
    assert n["smem_need"] == (16 * 72 + 64 * 72) * 2
    assert smem_plan(4, 64, 64, 16, 64, 64, 2, stages=2)["smem_need"] \
        == 2 * n["smem_need"]
    assert smem_plan(4, 100, 64, 16, 64, 0)["bkc"] == 112


# ------------------------------------------------------- flash_attention

FLASH_CASES = list(CONFORMANCE_SHAPES["flash_attention"]) + [
    (2, 100, 100, 4, 2, 64, True, 0, "float32"),      # ragged S
    (1, 100, 100, 4, 1, 32, True, 24, "bfloat16"),    # ragged, windowed
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,dtype", FLASH_CASES)
def test_plain_flash_matches_pallas(B, Sq, Sk, H, KV, D, causal, window,
                                    dtype):
    rng = np.random.default_rng(Sq + H + D)
    q = _np(rng.standard_normal((B, Sq, H, D), np.float32), dtype)
    k = _np(rng.standard_normal((B, Sk, KV, D), np.float32), dtype)
    v = _np(rng.standard_normal((B, Sk, KV, D), np.float32), dtype)
    got = fa_ops.attention(tensor_from_numpy(q), tensor_from_numpy(k),
                           tensor_from_numpy(v), causal=causal,
                           window=window)
    assert got.dtype == tensor_from_numpy(q).dtype
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, interpret=True)
    assert_kernel_close(_f32(got), _f32(want), dtype)


# zamba2's shared attention blocks: head dim 112 (3584 / 32), MHA
FLASH_D112 = [(2, 128, 4, 4, True, 0, "float32"),
              (2, 128, 4, 4, True, 0, "bfloat16"),
              (1, 100, 4, 2, True, 24, "bfloat16"),     # ragged, windowed
              (1, 64, 2, 2, False, 0, "float32")]


@pytest.mark.parametrize("B,S,H,KV,causal,window,dtype", FLASH_D112)
def test_plain_flash_d112_matches_pallas_and_oracle(B, S, H, KV, causal,
                                                    window, dtype):
    rng = np.random.default_rng(112 + S + H)
    q, k, v = (_np(rng.standard_normal((B, S, n, 112), np.float32), dtype)
               for n in (H, KV, KV))
    got = fa_ops.attention(*(tensor_from_numpy(t) for t in (q, k, v)),
                           causal=causal, window=window)
    assert got.shape == (B, S, H, 112)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want = jax_attention(jq, jk, jv, causal=causal, window=window,
                         interpret=True)
    assert_kernel_close(_f32(got), _f32(want), dtype)
    assert_kernel_close(_f32(got), _f32(jax_attn_ref(
        jq, jk, jv, causal=causal, window=window)), dtype)


# whisper's cross-attention: Sq (the decoder's length) != Sk (the
# encoder's), unmasked, both ways round
FLASH_CROSS = [(2, 48, 80, 4, 2, 64, "float32"),
               (2, 48, 80, 4, 2, 64, "bfloat16"),
               (1, 64, 16, 8, 8, 64, "float32"),
               (1, 32, 96, 8, 8, 64, "bfloat16")]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,dtype", FLASH_CROSS)
def test_plain_flash_cross_shapes_match_pallas_and_oracle(B, Sq, Sk, H, KV,
                                                          D, dtype):
    rng = np.random.default_rng(Sq * Sk)
    q = _np(rng.standard_normal((B, Sq, H, D), np.float32), dtype)
    k, v = (_np(rng.standard_normal((B, Sk, KV, D), np.float32), dtype)
            for _ in range(2))
    got = fa_ops.attention(*(tensor_from_numpy(t) for t in (q, k, v)),
                           causal=False)
    assert got.shape == (B, Sq, H, D)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want = jax_attention(jq, jk, jv, causal=False, interpret=True)
    assert_kernel_close(_f32(got), _f32(want), dtype)
    assert_kernel_close(_f32(got), _f32(jax_attn_ref(jq, jk, jv,
                                                     causal=False)), dtype)


def test_flash_smem_plan_at_head_dim_112():
    """D = 112 pads to two 64-dim TMA boxes of 8 KB (the map's zero fill
    supplies head dims 112..127): Q [128, 128] and three stages of a K
    and a V tile of 64 keys take 132,152 bytes on ``tensor_core`` (one
    block an SM); the fp32 path's 103,424 leave two."""
    tc = gpu_mapping.flash_smem_plan(112, "tensor_core")
    fma = gpu_mapping.flash_smem_plan(112, "fma")
    assert (tc["smem_need"], fma["smem_need"]) == (132_152, 103_424)
    assert (tc["blocks_per_sm"], fma["blocks_per_sm"]) == (1, 2)
    assert tc == gpu_mapping.flash_smem_plan(128, "tensor_core")
    assert (tc["keys"], tc["stages"], tc["q_bytes"]) == (64, 3, 2 * 2 * 8192)
    assert tc["smem_need"] == 1024 + 2 * 2 * 8192 + 3 * 2 * 2 * 8192 + 7 * 8


def test_flash_first_tile_fully_masked_row_is_cleared():
    """Window < tile with causal: the early keys are masked for late
    rows; the finite -1e30 keeps the row finite and exact."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((1, 96, 2, 32), (1, 96, 2, 32), (1, 96, 2, 32)))
    out = fa_ops.attention(q, k, v, causal=True, window=4)
    assert torch.isfinite(out).all()
    # row 95 sees keys 92..95 only
    s = torch.einsum("hd,thd->ht", q[0, 95], k[0, 92:96]) / 32 ** 0.5
    want = torch.einsum("ht,thd->hd", torch.softmax(s, -1), v[0, 92:96])
    assert torch.allclose(out[0, 95], want, atol=1e-5)


def test_flash_rejects_mismatched_heads():
    with pytest.raises(ValueError):
        fa_ops.attention(torch.ones(1, 8, 3, 32), torch.ones(1, 8, 2, 32),
                         torch.ones(1, 8, 2, 32))


def test_registry_resolves_ported_wrappers():
    assert import_entry("spm_matmul") is mm_ops.matmul
    assert import_entry("flash_attention") is fa_ops.attention
    assert import_entry("wkv6") is wkv_ops.wkv
    assert KERNEL_REGISTRY["wkv6"].plan_params == ("chunk",)


def test_tolerance_policy_is_the_repos():
    assert KERNEL_TOLERANCES == {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("S,window", [(128, 0), (100, 24)])
def test_flash_rounding_model_is_the_attention(S, window):
    """In fp32 the CPU model of the CUDA kernel's tiling and rounding
    (which sized the card's bf16 allowance) computes the attention."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((2, S, 4, 64), (2, S, 2, 64), (2, S, 2, 64)))
    got = tolerance.flash_kernel_rounding(q, k, v, window=window)
    want = fa_ops.attention_plain(q, k, v, window=window)
    assert_kernel_close(got.numpy(), want.numpy(), "float32")


# -------------------------------------------------------------- wkv6 plan

def test_wkv_smem_rule_rejects_the_model_chunk_at_k64():
    assert not wkv_smem_plan(256, 64)["fits"]
    assert not wkv_smem_plan(128, 64)["fits"]
    assert wkv_smem_plan(64, 64)["fits"]
    assert wkv_smem_plan(64, 64)["smem_bytes"] == H100.smem_bytes


@pytest.mark.parametrize("S,K,chunk,want", [
    (256, 64, 256, 64),      # the serve shape: 256 -> 128 -> 64
    (256, 64, None, 64),     # the reference's default 128, halved
    (256, 32, None, 128),    # fits as asked
    (256, 128, 128, 32),
    (40, 64, 256, 40),       # clamped to S, which fits
    (100, 64, 64, 64),       # a ragged last chunk is the kernel's
])
def test_wkv_chunk_halves_until_it_fits(S, K, chunk, want):
    got = wkv_ops.resolve_chunk(S, K, chunk)
    assert got == want
    assert wkv_smem_plan(got, K)["fits"]


def test_wkv_smem_rule_is_monotone_in_chunk_and_k():
    for K in wkv_ops.HEAD_DIMS:
        needs = [wkv_smem_plan(c, K)["smem_need"] for c in range(1, 300)]
        assert all(a < b for a, b in zip(needs, needs[1:]))
    for c in (16, 64, 128):
        needs = [wkv_smem_plan(c, K)["smem_need"] for K in range(8, 200, 8)]
        assert all(a < b for a, b in zip(needs, needs[1:]))


@pytest.mark.parametrize("kernel", ["spm_matmul", "flash_attention",
                                    "wkv6"])
def test_card_check_passes_rounding_and_catches_planted_faults(kernel):
    """The element-wise check chip_smoke.py holds each kernel to on the
    card: under its bf16 allowance for the kernel's own rounding, over
    it for the planted faults chip_smoke.py runs (one 16-deep K step
    dropped from a product; the attention scale 5 % off)."""
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    if kernel == "spm_matmul":
        a = torch.randn(4, 896, generator=gen).to(bf)
        b = (torch.randn(896, 896, generator=gen) / 896 ** 0.5).to(bf)
        want = mm_ops.matmul_plain(a, b)
        sound = tolerance.matmul_split_model(
            a, b, tolerance.kernel_split_rows(4, 896, 896))
        dropped = a.clone()
        dropped[:, -16:] = 0
        fault = mm_ops.matmul_plain(dropped, b)
    elif kernel == "flash_attention":
        q, k, v = (torch.randn(*s, generator=gen).to(bf)
                   for s in ((1, 128, 4, 64), (1, 128, 2, 64),
                             (1, 128, 2, 64)))
        want = fa_ops.attention_plain(q, k, v)
        sound = tolerance.flash_kernel_rounding(q, k, v)
        fault = tolerance.flash_kernel_rounding(q, k, v, scale=1.05 / 8)
    else:
        # the chunked arithmetic of csrc/wkv6.cu's fma kernel, and its
        # three planted faults, in bf16 (model decays) and fp32 (strong
        # decay)
        for dt, decay in ((bf, "model"), (torch.float32, "strong")):
            args = tolerance.wkv_inputs(2, 128, 2, 64, dt, decay, gen)
            want = wkv_ops.wkv_plain(*args)

            def model(*a):
                return tolerance.wkv_chunked_direct(*a, 32)

            assert tolerance.check_wkv(model(*args), want, dt)[0] < 1
            faults = tolerance.wkv_planted_faults(model, *args, 32)
            assert len(faults) == 3
            for got in faults.values():
                assert tolerance.check_wkv(got, want, dt)[0] > 1
        # the kernel each dtype takes on the card (bf16: the cluster
        # kernel's sub-tiles, hi/lo operands, rank-ordered carry and
        # exp2; fp32: the fma kernel), 16-row blocks over 160 rows: ten
        # chunks, clusters of 8 walking two groups; the carry fault also
        # at the boundary between the groups
        for dt, decay in ((bf, "model"), (bf, "strong"),
                          (torch.float32, "strong")):
            args = tolerance.wkv_inputs(1, 160, 2, 64, dt, decay, gen)
            want = wkv_ops.wkv_plain(*args)
            route = wkv_ops.dispatch(160, 64, dt, True, 16)
            assert route["rows"] == 16
            if dt == bf:
                assert (route["path"], route["cluster"], route["groups"]) \
                    == ("tensor_core", 8, 2)

            def kernel(*a):
                return tolerance.wkv_kernel_model(*a, chunk=16)

            assert tolerance.check_wkv(kernel(*args), want, dt)[0] < 1
            faults = tolerance.wkv_planted_faults(kernel, *args, 16, 128)
            assert len(faults) == 4
            for got in faults.values():
                assert tolerance.check_wkv(got, want, dt)[0] > 1
        return
    assert tolerance.check(sound, want, bf)[0] < 1
    assert tolerance.check(fault, want, bf)[0] > 1


# ------------------------------------------------- spm_matmul paths

# the main path's bf16 products: qwen2-0.5b's, then rwkv6-1.6b's
DECODE_SHAPES = [(4, 896, 896), (4, 896, 128), (4, 896, 4864),
                 (4, 4864, 896), (4, 2048, 2048), (4, 2048, 7168),
                 (4, 7168, 2048), (4, 2048, 160), (4, 32, 2048),
                 (4, 2048, 64), (4, 64, 2048)]
PREFILL_SHAPES = [(1024, k, n) for _, k, n in DECODE_SHAPES]
# the benchmark's decode products: pixtral-12b's five at its batch of 16,
# rwkv6-1.6b's seven at its batch of 8
BENCH_DECODE_SHAPES = [(16, 5120, 4096), (16, 5120, 1024), (16, 4096, 5120),
                       (16, 5120, 14336), (16, 14336, 5120)] + [
    (8, k, n) for _, k, n in DECODE_SHAPES[4:]]


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES + [(1, 896, 896),
                                                   (16, 896, 896)]
                         + BENCH_DECODE_SHAPES)
def test_splitk_count_covers_the_sms(m, k, n):
    """At most the portable cluster of 8, slices of whole 64-deep steps
    that cover K once; column tiles x splits covers the 132 SMs, with
    the fewest splits that do, unless it stops at the most splits
    allowed (8, or one a step); the ring fits shared memory, whatever
    K."""
    plan = mm_ops.splitk_plan(m, k, n)
    s, ks = plan["splits"], plan["ks"]
    tiles, steps = -(-n // mm_ops.SPLITK_BN), -(-k // gpu_mapping.SPLITK_BK)
    assert 1 <= s <= mm_ops.MAX_SPLITS and ks % gpu_mapping.SPLITK_BK == 0
    assert (s - 1) * ks < k <= s * ks
    most = mm_ops.k_slices(steps, min(mm_ops.MAX_SPLITS, steps), 1)[1]
    assert tiles * s >= H100.num_sms or s == most
    assert s == 1 or tiles * (s - 1) < H100.num_sms
    assert smem_plan(m, k, n, gpu_mapping.splitk_rows(m), mm_ops.SPLITK_BN,
                     gpu_mapping.SPLITK_BK, stages=mm_ops.SPLITK_STAGES,
                     path="splitk")["fits"]


@pytest.mark.parametrize("k", [16, 32, 64, 100, 896, 2048, 4864, 7168,
                               7169])
@pytest.mark.parametrize("want", [1, 2, 3, 5, 8])
def test_k_slices_tile_k_exactly(k, want):
    """Each slice is a multiple of 16 rows, none is empty, and together
    they cover K once, the last one ragged."""
    size, splits = mm_ops.k_slices(k, want, 16)
    assert size % 16 == 0 and 1 <= splits <= want
    bounds = [(r * size, min(k, (r + 1) * size)) for r in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(b0 < b1 for b0, b1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("m,k,n", PREFILL_SHAPES + [(259, 896, 896),
                                                    (128, 128, 256)])
def test_wgmma_split_fills_one_wave_in_whole_steps(m, k, n):
    """One 128 x 128 tile per block and one block per SM: the K split
    keeps the grid within one wave, cuts K in whole 64-deep steps, and
    leaves no block without a step."""
    plan = mm_ops.wgmma_plan(m, k, n)
    tiles = -(-m // 128) * -(-n // 128)
    steps = -(-k // 64)
    s = plan["splits"]
    assert 1 <= s <= mm_ops.MAX_SPLITS
    assert s == 1 or tiles * s <= H100.num_sms
    assert (s - 1) * plan["kb_per"] < steps <= s * plan["kb_per"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,rows", [(4, 4864, 896, 608),
                                        (4, 2048, 160, 256),
                                        (64, 896, 128, 128),
                                        (3, 100, 24, 16)])
def test_split_k_sum_stays_within_policy(dtype, m, k, n, rows):
    """A plain emulation of the cluster split-K sum (an fp32 partial
    per slice, added in rank order) agrees with ``matmul_ref`` under the
    repo's fp32 and bf16 policies and under the card's element-wise
    check."""
    rng = np.random.default_rng(m + k + n)
    a = tensor_from_numpy(_np(rng.standard_normal((m, k), np.float32),
                              dtype))
    b = tensor_from_numpy(_np(rng.standard_normal((k, n), np.float32)
                              / np.sqrt(k), dtype))
    got = tolerance.matmul_split_model(a, b, rows)
    want = mm_ops.matmul_plain(a, b)
    assert_kernel_close(_f32(got), _f32(want), dtype)
    assert tolerance.check(got, want, got.dtype)[0] < 1


@pytest.mark.parametrize("m,n,dtype,trans_b,aligned,want", [
    (4, 896, torch.bfloat16, False, True, "splitk"),       # decode
    (1, 64, torch.bfloat16, False, True, "splitk"),
    (16, 896, torch.bfloat16, False, True, "splitk"),
    (4, 151_936, torch.bfloat16, True, True, "tiled"),     # decode logits
    (4, 100, torch.bfloat16, False, True, "tiled"),        # N % 8
    (4, 896, torch.float32, False, True, "tiled"),         # fp32
    (4, 896, torch.bfloat16, False, False, "tiled"),       # unaligned
    (1024, 896, torch.bfloat16, False, True, "wgmma"),     # prefill
    (64, 896, torch.bfloat16, True, True, "wgmma"),
    (1024, 896, torch.float32, False, True, "tiled"),
    (1024, 896, torch.bfloat16, False, False, "tiled"),
    (20, 896, torch.bfloat16, False, True, "tiled"),       # between
])
def test_dispatch_picks_the_documented_path(m, n, dtype, trans_b, aligned,
                                            want):
    assert mm_ops.select_path(m, n, dtype, trans_b, aligned) == want
    route = mm_ops.dispatch(m, 896, n, dtype, trans_b, aligned)
    assert route["path"] == want
    assert set(route) >= {"path", "splits"}


def test_route_reads_alignment_from_the_operands():
    """The wrapper's own route: a contiguous bf16 decode product takes
    the split-K path; the same product with A's rows off the 16-byte
    grid (a column slice) takes the tiled kernel."""
    a = torch.zeros(4, 897, dtype=torch.bfloat16)
    b = torch.zeros(896, 896, dtype=torch.bfloat16)
    whole = mm_ops.route(a[:, :896].contiguous(), b)
    assert whole["aligned"] and whole["path"] == "splitk"
    sliced = mm_ops.route(a[:, 1:], b)
    assert not sliced["aligned"] and sliced["path"] == "tiled"
    assert mm_ops.route(b.t().contiguous()[:4], b, trans_b=True)["path"] \
        == "tiled"


def test_splitk_without_a_fitting_slice_goes_tiled(monkeypatch):
    """The ring streams any K: a deep one splits 8 ways on split-K.  A
    ring deeper than shared memory holds (the stage count the card
    would refuse) sends the product to the tiled kernel."""
    args = (16, 1 << 18, 64)
    mm_ops.splitk_plan.cache_clear()
    try:
        assert mm_ops.splitk_plan(*args) == {"splits": 8, "ks": 1 << 15}
        assert mm_ops.dispatch(*args, torch.bfloat16, False,
                               True)["path"] == "splitk"
        mm_ops.splitk_plan.cache_clear()
        monkeypatch.setattr(mm_ops, "SPLITK_STAGES", 32)
        assert mm_ops.splitk_plan(*args) is None
        assert mm_ops.dispatch(*args, torch.bfloat16, False,
                               True)["path"] == "tiled"
    finally:
        mm_ops.splitk_plan.cache_clear()


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES + BENCH_DECODE_SHAPES)
def test_serving_plan_pins_name_the_splitk_tile(m, k, n):
    """The decode pins the serving plan takes from ``resolve_plan``
    (the tile its WCET bound counts) are the split-K path's tile, so
    the decode products that carry them run that path."""
    plan = mm_ops.resolve_plan(m, k, n, 2, False)
    assert (plan["bm"], plan["bn"]) == mm_ops.PATH_TILES["splitk"][:2]
    route = mm_ops.dispatch(m, k, n, torch.bfloat16, False, True,
                            plan["bm"], plan["bn"])
    assert route["path"] == "splitk"


@pytest.mark.parametrize("m,k,n,pins,want", [
    (4, 896, 896, (16, 64, None), "splitk"),
    (4, 896, 896, (32, 128, None), "tiled"),
    (4, 896, 896, (None, 128, None), "tiled"),
    (4, 896, 896, (16, 64, 64), "tiled"),    # splitk picks its own slice
    (1024, 896, 896, (128, 128, 64), "wgmma"),
    (1024, 896, 896, (64, 128, None), "tiled"),
    (1024, 896, 896, (None, None, 0), "tiled"),
    (128, 128, 256, (128, 128, 0), "tiled"),  # the bf16 conformance plan
])
def test_pins_other_than_the_paths_tile_go_tiled(m, k, n, pins, want):
    """A plan that pins a tile the fixed-tile path does not run goes to
    the tiled kernel, which honours it, before the launch."""
    assert mm_ops.dispatch(m, k, n, torch.bfloat16, False, True,
                           *pins)["path"] == want
    a = torch.zeros(m, k, dtype=torch.bfloat16)
    b = torch.zeros(k, n, dtype=torch.bfloat16)
    assert mm_ops.route(a, b, False, *pins)["path"] == want


def test_wgmma_ring_that_does_not_fit_goes_tiled(monkeypatch):
    """Dispatch asks the shared-memory rule for the wgmma ring: a stage
    count the card would refuse sends the product to the tiled kernel."""
    args = (1024, 896, 896, torch.bfloat16, False, True)
    assert mm_ops.dispatch(*args)["path"] == "wgmma"
    monkeypatch.setattr(mm_ops, "WGMMA_STAGES", 8)
    assert mm_ops.dispatch(*args) == {"path": "tiled", "splits": 1}


@pytest.mark.parametrize("flash_dtype,aligned,want", [
    (torch.bfloat16, True, "tensor_core"),
    (torch.bfloat16, False, "fma"),
    (torch.float32, True, "fma"),
])
def test_flash_dispatch_by_dtype_and_alignment(flash_dtype, aligned, want):
    assert fa_ops.select_path(flash_dtype, aligned) == want


def test_smem_plan_rejects_stages_that_do_not_fit():
    """The wgmma ring: stages x (A box + B box) + barriers + alignment
    slack against the 232,448 bytes a block may use."""
    def ring(stages):
        return smem_plan(1024, 2048, 2048, 128, 128, 64, 2, stages=stages,
                         path="wgmma")
    assert ring(4)["fits"] and ring(7)["fits"]
    assert not ring(8)["fits"]
    assert ring(4)["smem_need"] == 1024 + 4 * 32768 + 4 * 16
    # the epilogue's fp32 tile (the split-K partial) reuses the stages,
    # unless there are too few of them
    assert ring(2)["smem_need"] == 1024 + 128 * 136 * 4 + 2 * 16
    # split-K decode: the same ring of a 64 x 64 B box and an A box of 8
    # or 16 rows a stage; the block's fp32 partial reuses the stages
    def sk(rows, stages):
        return smem_plan(4, 2048, 2048, rows, 64, 64, 2, stages=stages,
                         path="splitk")
    assert sk(8, 6)["smem_need"] == 1024 + 6 * (8192 + 1024) + 6 * 16
    assert sk(16, 6)["smem_need"] == 1024 + 6 * (8192 + 2048) + 6 * 16
    assert sk(16, 6)["fits"] and not sk(16, 23)["fits"]
    assert sk(16, 1)["smem_need"] == 1024 + 10240 + 16   # the partial fits
    with pytest.raises(ValueError):
        smem_plan(4, 64, 64, 16, 64, 64, path="wgmma-typo")


def _cu_constant(name: str, source: str = "spm_matmul.cu") -> int:
    text = (_build.CSRC / source).read_text()
    import re
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_shared_memory_rule_reads_the_kernels_constants():
    """The wrapper's rule and plans name the sizes the kernels are
    compiled with."""
    assert (_cu_constant("kWgBM"), _cu_constant("kWgBN")) \
        == mm_ops.WGMMA_TILE
    assert _cu_constant("kWgBK") == gpu_mapping.WGMMA_BK
    assert _cu_constant("kWgStages") == mm_ops.WGMMA_STAGES
    assert _cu_constant("kSkBN") == mm_ops.SPLITK_BN
    assert _cu_constant("kSkBK") == gpu_mapping.SPLITK_BK
    assert _cu_constant("kSkStages") == mm_ops.SPLITK_STAGES
    assert _cu_constant("kPad") == gpu_mapping.SMEM_PAD
    text = (_build.CSRC / "spm_matmul.cu").read_text()
    assert f"kWgPartLd = kWgBN + {gpu_mapping.WGMMA_PART_PAD};" in text


def test_wkv_shared_memory_rule_reads_the_kernels_constants():
    """``wkv_smem_plan`` and the wrapper's rows rule name the sizes
    csrc/wkv6.cu is compiled with, and the source's ``tc_smem_bytes``
    sums the same buffers."""
    def c(name):
        return _cu_constant(name, "wkv6.cu")
    assert c("kThreads") == gpu_mapping.WKV_FMA_THREADS
    assert c("kTcThreads") == gpu_mapping.WKV_TC_THREADS
    assert c("kTcPad") == gpu_mapping.WKV_TC_PAD
    assert c("kMaxCluster") == gpu_mapping.WKV_MAX_CLUSTER
    assert c("kSub") == wkv_ops.SUBTILE
    assert gpu_mapping.WKV_TC_ROWS == {32: c("kTcRows"), 64: c("kTcRows"),
                                       128: c("kTcRowsWide")}
    text = (_build.CSRC / "wkv6.cu").read_text()
    for k, rows in gpu_mapping.WKV_TC_ROWS.items():
        assert f"launch_tc_k<{k}, " in text
    # the shared-memory sum of the tensor-core block, buffer by buffer
    # (K = 64, 64 rows, row pitch 72): cw/dS, exp2(total) and u in fp32;
    # r, v, lo of k'; k, hi of k'; hi and lo of A in bf16; the carry
    plan = wkv_smem_plan(64, 64, path="tensor_core")
    assert plan["smem_need"] == 4 * (64 * 72 + 2 * 64) \
        + 2 * ((3 * 64 + 2 * 64) * 72 + 2 * 64 * 72)
    assert wkv_smem_plan(64, 64, path="tensor_core", groups=2)["smem_need"] \
        == plan["smem_need"] + 4 * 64 * 64
    assert plan["blocks_per_sm"] == 2
    for k, rows in gpu_mapping.WKV_TC_ROWS.items():
        assert wkv_smem_plan(rows, k, path="tensor_core", groups=2)["fits"]
    with pytest.raises(ValueError):
        wkv_smem_plan(64, 64, path="wgmma")


def test_flash_shared_memory_rule_reads_the_kernels_constants():
    """``flash_smem_plan`` names the sizes csrc/flash_attention.cu is
    compiled with, and gives each path's launcher's sum: at gemma3's
    head dim 256, 230,456 bytes on ``tensor_core`` (the split pair's Q
    of 64 rows and three stages of 64-key K and V tiles) and 214,016 on
    ``fma``, both under the 232,448 a block may use, one block an SM."""
    def c(name):
        return _cu_constant(name, "flash_attention.cu")
    assert c("kThreads") == gpu_mapping.FLASH_THREADS
    assert c("kBQ") == gpu_mapping.FLASH_FMA_BQ
    assert c("kBK") == gpu_mapping.FLASH_FMA_BK
    assert c("kWgRows") == gpu_mapping.FLASH_TC_WG_ROWS
    assert c("kTcKeys") == gpu_mapping.FLASH_TC_KEYS
    assert "kTcThreads = 3 * kThreads;" in (
        _build.CSRC / "flash_attention.cu").read_text()
    assert c("kChunk") == gpu_mapping.FLASH_TC_CHUNK
    assert c("kStages") == gpu_mapping.FLASH_TC_STAGES
    assert (c("kProducerRegs"), c("kConsumerRegs")) \
        == gpu_mapping.FLASH_TC_REGS
    assert c("kRegBudget") == gpu_mapping.FLASH_TC_REG_BUDGET
    assert c("kLoMaxD") == gpu_mapping.FLASH_FWD_LO_MAX_D
    assert c("kSmemBytes") == gpu_mapping.H100.smem_bytes
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for d in gpu_mapping.FLASH_FWD_HEAD_DIMS:
        assert f"launch_tc<{d}>(" in text and f"launch_d<T, {d}>(" in text
    tc = gpu_mapping.flash_smem_plan(256, "tensor_core")
    fma = gpu_mapping.flash_smem_plan(256, "fma")
    assert (tc["smem_need"], fma["smem_need"]) == (230_456, 214_016)
    assert tc["fits"] and fma["fits"] and tc["stages"] == 3
    assert tc["blocks_per_sm"] == fma["blocks_per_sm"] == 1
    assert gpu_mapping.flash_smem_plan(64, "tensor_core")["smem_need"] \
        == 1024 + 2 * 8192 + 3 * 2 * 8192 + 7 * 8
    with pytest.raises(ValueError, match="head dim"):
        gpu_mapping.flash_smem_plan(96, "tensor_core")
    with pytest.raises(ValueError, match="path"):
        gpu_mapping.flash_smem_plan(64, "wgmma")


# head dim -> (serving's kernel, the o_lo kernel): (split, overlap)
FLASH_TC_SCHEDULES = {32: ((False, True), (False, False)),
                      64: ((False, True), (False, False)),
                      112: ((False, True), (True, False)),
                      128: ((False, True), (True, False)),
                      224: ((True, True), None),
                      256: ((True, True), None)}


@pytest.mark.parametrize("D", gpu_mapping.FLASH_FWD_HEAD_DIMS)
@pytest.mark.parametrize("lo", [False, True])
def test_flash_tc_plan_and_registers_at_each_head_dim(D, lo):
    """At every compiled head dim, with and without o_lo: a warpgroup's
    live tiles (O, the 64-key scores; overlapped, p too; o_lo doubling O
    and p) against the 120-register budget give the schedule: serving's
    kernel overlaps a tile's softmax with the last P V up to head dim
    128 and splits the head dim between its warpgroups at 256; the o_lo
    kernel runs in series, split from 112 up (no o_lo kernel at 256: it
    would not fit split and in series either).  A split block covers 64
    queries; the ring fits shared memory."""
    regs = gpu_mapping.flash_tc_registers(D, lo)
    want = FLASH_TC_SCHEDULES[D][lo]
    compiled = not lo or D <= gpu_mapping.FLASH_FWD_LO_MAX_D
    assert (want is not None) == compiled
    dp = -(-D // 64) * 64
    held = dp // 2 if regs["split"] else dp
    assert regs["head_dims"] == held
    assert regs["live"] == (held // 2 * (1 + lo) + 32
                            + (16 * (1 + lo) if regs["overlap"] else 0))
    assert (regs["live"] <= 120) == compiled
    if not compiled:
        return
    assert (regs["split"], regs["overlap"]) == want
    rows = 64 if regs["split"] else 128
    assert regs["rows"] == rows
    if not lo:   # a plan names serving's kernel's tile
        assert gpu_mapping.flash_tile(D, "tensor_core") == (rows, 64)
    assert gpu_mapping.flash_tile(D, "fma") == (64, 64)
    plan = gpu_mapping.flash_smem_plan(D, "tensor_core", lo=lo)
    assert plan["fits"] and (plan["rows"], plan["keys"]) == (rows, 64)
    assert plan["stages"] == 3 and plan["threads"] == 3 * 128
    assert plan["smem_need"] == (1024 + plan["q_bytes"]
                                 + plan["stages"] * plan["stage_bytes"]
                                 + (2 * plan["stages"] + 1) * 8)
    assert plan["q_bytes"] == rows // 64 * dp // 64 * 8192


@pytest.mark.parametrize("S,K,dtype,aligned,chunk,want", [
    # the serve prefill: the model's chunk of 256 becomes four 64-row
    # blocks per (b, h) in one cluster, not one block
    (256, 64, torch.bfloat16, True, 256, ("tensor_core", 64, 4, 1)),
    (256, 64, torch.bfloat16, True, None, ("tensor_core", 64, 4, 1)),
    (2048, 64, torch.bfloat16, True, 256, ("tensor_core", 64, 8, 4)),
    (256, 128, torch.bfloat16, True, 128, ("tensor_core", 16, 8, 2)),
    (100, 64, torch.bfloat16, True, 40, ("tensor_core", 32, 4, 1)),
    (7, 32, torch.bfloat16, True, None, ("tensor_core", 16, 1, 1)),
    (256, 64, torch.bfloat16, False, 256, ("fma", 64, 1, 1)),
    (256, 64, torch.float32, True, 256, ("fma", 64, 1, 1)),
    (64, 32, torch.float32, True, 32, ("fma", 32, 1, 1)),
])
def test_wkv_dispatch_picks_the_path_and_its_rows(S, K, dtype, aligned,
                                                  chunk, want):
    route = wkv_ops.dispatch(S, K, dtype, aligned, chunk)
    assert (route["path"], route["rows"], route["cluster"],
            route["groups"]) == want
    assert wkv_ops.select_path(dtype, aligned) == want[0]
    if want[0] == "tensor_core":
        assert route["rows"] == wkv_ops.tc_rows(S, K, chunk)
        assert route["rows"] % wkv_ops.SUBTILE == 0
        chunks = -(-S // route["rows"])
        assert route["cluster"] * route["groups"] >= chunks


def test_wkv_cpu_call_counts_no_launch_or_path():
    before = (wkv_ops.wkv.launches, dict(wkv_ops.wkv.paths))
    args = tolerance.wkv_inputs(1, 16, 2, 32, torch.bfloat16, "model",
                                torch.Generator().manual_seed(0))
    wkv_ops.wkv(*args)
    assert (wkv_ops.wkv.launches, wkv_ops.wkv.paths) == before
    assert set(wkv_ops.wkv.paths) == set(wkv_ops.PATHS)


def _c_params(source: str, entry: str) -> list:
    """The parameter types of ``extern "C" int entry(...)`` in a csrc
    source, as ctypes would take them."""
    import re
    text = (_build.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                       text).group(1)
    kinds = []
    for param in params.split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append("ptr" if "long long*" not in param else "llptr")
        else:
            kinds.append(param.rsplit(" ", 1)[0])
    return kinds


_CTYPES = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
           ctypes.c_longlong: "long long", ctypes.c_float: "float"}


@pytest.mark.parametrize("ops,source", [(mm_ops, "spm_matmul.cu"),
                                        (fa_ops, "flash_attention.cu"),
                                        (wkv_ops, "wkv6.cu")])
def test_wrapper_argtypes_match_the_c_entries(ops, source):
    """Each path's ctypes signature has the C entry's parameters, in
    order: a wrong count or width would pass garbage to the card."""
    assert set(ops.ENTRIES) == set(ops.PATHS)
    for entry, argtypes in ops.ENTRIES.values():
        got = [_CTYPES.get(t, "llptr") for t in argtypes]
        assert got == _c_params(source, entry), entry


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every library that may include it."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build.library_path("k") != second
    assert second.parent == _build.BUILD_DIR


# ----------------------------------------------------- on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run chip_smoke.py there")
    from repro_torch.compat import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
def test_cuda_matmul_launches_kernel_and_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4, 896, generator=g, device=cuda_device).bfloat16()
    b = torch.randn(896, 128, generator=g, device=cuda_device).bfloat16()
    before = mm_ops.matmul.launches
    got = mm_ops.matmul(a, b)
    torch.cuda.synchronize()
    assert mm_ops.matmul.launches == before + 1
    want = mm_ops.matmul_plain(a, b)
    assert_kernel_close(_f32(got.cpu()), _f32(want.cpu()), "bfloat16")


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    before = (mm_ops.matmul.launches, fa_ops.attention.launches)
    a = torch.ones(4, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        mm_ops.matmul(a, a.t().contiguous())
    q = torch.ones(1, 64, 2, 48, device=cuda_device)
    with pytest.raises(ValueError):
        fa_ops.attention(q, q, q)               # head dim 48: no kernel
    assert (mm_ops.matmul.launches, fa_ops.attention.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,aligned", [(torch.bfloat16, True),
                                           (torch.bfloat16, False),
                                           (torch.float32, True)])
def test_cuda_flash_d112_launches_its_path_and_matches_plain(
        cuda_device, dtype, aligned):
    """zamba2's head dim on the card: bf16 rows on the 16-byte grid take
    the tensor-core kernel, fp32 and off-grid rows the fma kernel; each
    launch counts once and holds to the plain version.  Head dim 120,
    which no kernel is compiled for, raises and launches nothing."""
    from repro_torch.kernels.tolerance import check
    g = torch.Generator(device=cuda_device).manual_seed(112)
    off = int(not aligned)
    q, k, v = (torch.randn(2, 100, n, 112 + off, generator=g,
                           device=cuda_device).to(dtype)[..., off:]
               for n in (8, 8, 8))
    path = fa_ops.select_path(dtype, aligned)
    before = dict(fa_ops.attention.paths)
    got = fa_ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.attention.paths[path] == before[path] + 1
    want = fa_ops.attention_plain(q, k, v, causal=True)
    assert check(got, want, dtype)[0] < 1
    launches = fa_ops.attention.launches
    x = torch.ones(1, 64, 2, 120, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.attention(x, x, x)
    assert fa_ops.attention.launches == launches
