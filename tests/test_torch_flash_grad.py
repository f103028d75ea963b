"""flash_attention's gradient in the port: the backward kernel's recipe
against the JAX package's gradient (CPU, small sizes), and the routes
that carry it.

* ``ref.attention_bwd_tiles`` (the recipe of
  ``csrc/flash_attention_bwd.cu``, tile by tile: P from the forward's
  lse, D_i = sum P dP or rowsum(dO * (o + o_lo)) from the tensor-core
  forward's model ``ref.attention_tc_model``, dS = P (dP - D_i)) against
  ``jax.grad`` of
  the reference's ``models/attention.py::sdpa``: the same numpy-seeded
  inputs, fp32, causal, windowed and non-causal with Sq != Sk, GQA
  groups 1, 2 and 7, head dims 32, 64 and 112; each gradient within the
  repo's fp32 tolerance (``conftest.KERNEL_TOLERANCES``: 1e-5 of its
  largest magnitude).
* In bf16 the recipe, with the tensor cores' rounding of P and dS, stays
  within half of ``tolerance.check_flash_grad``'s allowance of
  ``ops.attention_grad`` (the backward's plain version) evaluated in
  fp32 on the same bf16 inputs, as ``chip_smoke.py`` holds the kernel,
  and each planted fault (``tolerance.flash_bwd_planted_faults``) breaks
  it, at ``tolerance.flash_bwd_main``'s shapes too.  Two choices of the
  recipe are what keeps dq there: D_i from fp32 P and dP (summed, or
  through the forward's unrounded output o + o_lo, whose PV product
  takes each p as hi + lo) and dS split in two bf16 parts for the dQ
  product.  D_i from the rounded o misses dq, and so, at S 4096, does o
  + o_lo of a forward that rounds p once.
* The plain forward's lse is the reference's log-sum-exp of its masked
  scores.
* ``bwd_dispatch`` routes aligned bf16 to ``tensor_core`` and all else
  to ``fma``; on a faked card the backward launches the routed C entry
  and never calls ``attention_grad``; on the CPU and on ``meta`` it
  calls ``attention_grad`` and counts no launch.
* The backward's C entries and shared-memory constants against the
  source; ``flash_bwd_smem_plan``'s blocks and scratch.
"""
import ctypes
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KERNEL_TOLERANCES
from repro.models.attention import _mask_bias, sdpa
from repro_torch.core import gpu_mapping
from repro_torch.kernels import _build, tolerance
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_tiles,
                                                     attention_ref,
                                                     attention_tc_fp32,
                                                     attention_tc_model)
from test_torch_kernels import _CTYPES, _c_params
from test_torch_train import _fake_card

TOL = KERNEL_TOLERANCES["float32"]


def _inputs(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D))
    k = rng.standard_normal((B, Sk, KV, D))
    v = rng.standard_normal((B, Sk, KV, D))
    do = rng.standard_normal((B, Sq, H, D))
    return [a.astype(np.float32) for a in (q, k, v, do)]


def _jax_grads(q, k, v, do, causal, window, scale):
    pos_q = jnp.arange(q.shape[1])
    pos_k = jnp.arange(k.shape[1])

    def loss(q, k, v):
        o = sdpa(q, k, v, pos_q, pos_k, causal=causal, window=window,
                 scale=scale)
        return jnp.sum(o * do)
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _model(q, k, v, do, causal, window, scale):
    """The recipe on the plain forward's o and lse."""
    o, lse = attention_ref(q, k, v, causal=causal, window=window,
                           scale=scale, with_lse=True)
    return attention_bwd_tiles(q, k, v, lse, do, causal=causal,
                               window=window, scale=scale), o, lse


# (B, Sq, Sk, H, KV, D, causal, window): G = H / KV of 1, 2 and 7
GRAD_CASES = [
    (2, 80, 80, 2, 1, 32, True, 0),
    (1, 130, 130, 4, 2, 64, True, 0),        # ragged, three tiles
    (1, 96, 96, 7, 1, 64, True, 24),         # window, group 7
    (2, 128, 128, 2, 1, 112, True, 40),
    (1, 70, 150, 2, 2, 112, False, 0),       # cross: Sq < Sk
    (1, 100, 60, 7, 1, 32, False, 0),        # cross: Sq > Sk
    (1, 90, 90, 2, 2, 32, False, 16),        # window without the causal mask
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", GRAD_CASES)
def test_recipe_matches_jax_grad_of_the_reference_sdpa(B, Sq, Sk, H, KV, D,
                                                       causal, window):
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, D, Sq + 7 * D + H)
    scale = 1.0 / math.sqrt(D)
    want = _jax_grads(q, k, v, do, causal, window, scale)
    (dq, dk, dv), _, _ = _model(*(torch.from_numpy(a) for a in (q, k, v, do)),
                                causal, window, scale)
    for name, g, j in zip(tolerance.FLASH_GRADS, (dq, dk, dv), want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), j) < TOL, (name, _rel(g.numpy(), j))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", [
    (1, 192, 192, 7, 1, 64, True, 0),       # qwen2's group, three tiles
    (1, 160, 160, 4, 2, 32, True, 48),
    (1, 96, 200, 4, 4, 112, False, 0),
])
def test_recipe_in_bf16_within_allowance_and_faults_caught(B, Sq, Sk, H, KV,
                                                           D, causal,
                                                           window):
    """The recipe in bf16 (P and dS rounded to bf16 before their products,
    as the tensor cores take them) against ``attention_grad`` evaluated
    in fp32 on the same bf16 inputs, under half of
    ``check_flash_grad``'s allowance; each planted fault breaks it."""
    bf = torch.bfloat16
    q, k, v, do = (torch.from_numpy(a).to(bf)
                   for a in _inputs(B, Sq, Sk, H, KV, D, Sq + D))
    scale = 1.0 / math.sqrt(D)
    want = fa_ops.attention_grad(*(t.float() for t in (q, k, v, do)),
                                 causal=causal, window=window, scale=scale)
    got, o, lse = _model(q, k, v, do, causal, window, scale)
    assert all(g.dtype == bf for g in got)
    share, _, shares = tolerance.check_flash_grad(got, want, bf)
    assert share < 0.5, shares
    faults = tolerance.flash_bwd_planted_faults(
        attention_bwd_tiles, q, k, v, lse, do, causal=causal,
        window=window, scale=scale)
    assert len(faults) == 3
    for name, wrong in faults.items():
        assert tolerance.check_flash_grad(wrong, want, bf)[0] > 1, name


@pytest.mark.parametrize("Sq,D,window", [(192, 64, 0), (160, 32, 48)])
def test_fa2_recipe_misses_dq_that_the_kernels_recipe_holds(Sq, D, window):
    """Why the kernel takes D_i as sum P dP and splits dS for dQ: under the
    causal mask the usual FlashAttention-2 recipe (D_i = rowsum(dO * O),
    O rounded to bf16 by the forward; one bf16 rounding of dS) breaks
    dq's allowance on the rows that see few keys."""
    bf = torch.bfloat16
    q, k, v, do = (torch.from_numpy(a).to(bf)
                   for a in _inputs(1, Sq, Sq, 4, 2, D, Sq + D))
    kw = {"causal": True, "window": window, "scale": 1.0 / math.sqrt(D)}
    want = fa_ops.attention_grad(*(t.float() for t in (q, k, v, do)), **kw)
    o, lse = attention_ref(q, k, v, with_lse=True, **kw)
    ours = attention_bwd_tiles(q, k, v, lse, do, **kw)
    fa2 = attention_bwd_tiles(q, k, v, lse, do, o=o, split_dq=False, **kw)
    assert tolerance.check_flash_grad(ours, want, bf)[2]["dq"] < 0.5
    assert tolerance.check_flash_grad(fa2, want, bf)[2]["dq"] > 1


@pytest.mark.parametrize("case", tolerance.FLASH_BWD_MAIN_CASES)
def test_recipe_in_bf16_at_flash_bwd_main_shapes(case):
    """The kernels' recipes in bf16 at ``flash_bwd_main``'s shapes
    (qwen2's group of 7 and of 14 / 2 among them) against
    ``attention_grad`` evaluated in fp32: D_i from the forward's o + o_lo
    and D_i = sum P dP, every gradient under half of the allowance, and
    each planted fault over 1."""
    read, faults = tolerance.flash_bwd_readings(*case)
    for recipe in ("D_i from o + o_lo", "D_i = sum P dP"):
        assert max(read[recipe].values()) < 0.5, (recipe, read[recipe])
    assert len(faults) == 3 and min(faults.values()) > 1, faults


@pytest.mark.parametrize("D", gpu_mapping.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 72),
                                           (False, 0)])
def test_tc_model_at_the_kernels_key_tile_is_the_plain_forward(D, causal,
                                                               window):
    """``ref.attention_tc_fp32`` walks the kernel's key tile at each
    compiled head dim by default (64 keys; 200 keys: a ragged last
    tile).  On fp32 inputs its output is the plain
    version's and the reference's ``sdpa``'s within the repo's fp32
    tolerance; on bf16 inputs, rounded once, within the bf16 allowance
    of the plain version, and the 5 % scale fault is not."""
    q, k, v, _ = _inputs(1, 200, 200, 4, 2, D, D + window)
    kw = {"causal": causal, "window": window, "scale": 1.0 / math.sqrt(D)}
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, full, lse = attention_tc_fp32(qt, kt, vt, **kw)
    assert torch.equal(out, attention_tc_fp32(
        qt, kt, vt, block=gpu_mapping.FLASH_TC_KEYS, **kw)[0])
    assert _rel(out.numpy(), attention_ref(qt, kt, vt, **kw).numpy()) < TOL
    want = sdpa(*(jnp.asarray(a) for a in (q, k, v)), jnp.arange(200),
                jnp.arange(200), **kw)
    assert _rel(out.numpy(), want) < TOL
    bf = torch.bfloat16
    qb, kb, vb = (t.to(bf) for t in (qt, kt, vt))
    plain = attention_ref(qb, kb, vb, **kw)
    o = tolerance.flash_kernel_rounding(qb, kb, vb, **kw)
    assert tolerance.check(o, plain, bf)[0] < 1
    wrong = tolerance.flash_kernel_rounding(
        qb, kb, vb, causal=causal, window=window, scale=1.05 * kw["scale"])
    assert tolerance.check(wrong, plain, bf)[0] > 1


def test_o_lo_needs_the_split_pv_product_at_qwen2s_sequence():
    """At S 4096 (``tolerance.FLASH_BWD_LONG_CASE``) D_i from o + o_lo holds
    dq only when the forward's PV product takes each p as hi + lo: o_lo
    of a forward that rounds p once carries sum bf16(p) dP, and misses."""
    read, _ = tolerance.flash_bwd_readings(*tolerance.FLASH_BWD_LONG_CASE)
    assert read["D_i from o + o_lo"]["dq"] < 0.5, read
    assert read["o_lo of PV unsplit"]["dq"] > 1, read


@pytest.mark.parametrize("Sq,Sk,H,KV,D,causal,window", [
    (130, 130, 4, 2, 64, True, 0), (96, 200, 4, 4, 112, False, 0),
    (100, 100, 2, 1, 32, True, 24)])
def test_o_plus_o_lo_is_the_forwards_fp32_output(Sq, Sk, H, KV, D, causal,
                                                 window):
    """The forward model's o is its fp32 output rounded once, and o +
    o_lo its full output (the PV product taking each p as hi + lo) to
    within one bf16 rounding (2^-8 relative) of the part o drops."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(2, Sq, Sk, H, KV, D, Sq + D))
    kw = {"causal": causal, "window": window, "scale": 1.0 / math.sqrt(D)}
    out, full, lse = attention_tc_fp32(q, k, v, **kw)
    o, o_lo, lse_m = attention_tc_model(q, k, v, **kw)
    assert o.dtype == o_lo.dtype == torch.bfloat16
    assert torch.equal(o, out.to(torch.bfloat16)) and torch.equal(lse, lse_m)
    rest = full - o.float()
    err = (o.float() + o_lo.float() - full).abs()
    assert (err <= 2.0 ** -8 * rest.abs()).all(), err.max()
    assert (o_lo.float().abs() > 0).any()


def test_forward_models_give_the_same_o():
    """The forward model's o is the one the forward kernel is held to
    (``tolerance.flash_kernel_rounding``), and the plain forward gives
    the same o with and without its lse."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(1, 96, 96, 4, 2, 64, 11))
    o, _, _ = attention_tc_model(q, k, v, causal=True, window=40)
    assert torch.equal(o, tolerance.flash_kernel_rounding(q, k, v,
                                                          window=40))
    plain = attention_ref(q, k, v, causal=True, window=40)
    assert torch.equal(plain, attention_ref(q, k, v, causal=True, window=40,
                                            with_lse=True)[0])


@pytest.mark.parametrize("H,KV", [(7, 1), (14, 2)])
def test_o_in_bf16_misses_dq_that_o_plus_o_lo_holds(H, KV):
    """The companion of the case above: with dS split for dQ, D_i from
    the forward's o rounded to bf16 breaks dq's allowance under the
    causal mask at S 256, where D_i from o + o_lo, the forward's
    unrounded output, holds it."""
    bf = torch.bfloat16
    q, k, v, do = (torch.from_numpy(a).to(bf)
                   for a in _inputs(1, 256, 256, H, KV, 64, 256 + 64))
    kw = {"causal": True, "window": 0, "scale": 0.125}
    want = fa_ops.attention_grad(*(t.float() for t in (q, k, v, do)), **kw)
    o, o_lo, lse = attention_tc_model(q, k, v, **kw)
    ours = attention_bwd_tiles(q, k, v, lse, do, o=o, o_lo=o_lo, **kw)
    rounded = attention_bwd_tiles(q, k, v, lse, do, o=o, **kw)
    assert tolerance.check_flash_grad(ours, want, bf)[2]["dq"] < 0.6
    assert tolerance.check_flash_grad(rounded, want, bf)[2]["dq"] > 1


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, 0), (100, 100, True, 24), (70, 150, False, 0)])
def test_plain_forward_lse_is_the_references_logsumexp(Sq, Sk, causal,
                                                       window):
    q, k, v, _ = _inputs(2, Sq, Sk, 4, 2, 32, Sq)
    scale = 0.2
    o, lse = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=causal, window=window, scale=scale,
                           with_lse=True)
    assert lse.shape == (2, 4, Sq) and lse.dtype == torch.float32
    assert torch.equal(o, attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window, scale=scale))
    qg = jnp.asarray(q).reshape(2, Sq, 2, 2, 32)
    s = jnp.einsum("bqkgh,btkh->bkgqt", qg, jnp.asarray(k)) * scale
    s = s + _mask_bias(jnp.arange(Sq), jnp.arange(Sk), causal, window)
    want = jax.scipy.special.logsumexp(s, axis=-1).reshape(2, 4, Sq)
    assert _rel(lse.numpy(), want) < TOL


@pytest.mark.parametrize("dtype,aligned,want", [
    (torch.bfloat16, True, "tensor_core"), (torch.bfloat16, False, "fma"),
    (torch.float32, True, "fma"), (torch.float32, False, "fma")])
def test_bwd_dispatch_routes_aligned_bf16_to_the_tensor_cores(dtype, aligned,
                                                             want):
    route = fa_ops.bwd_dispatch(64, dtype, aligned)
    assert route["path"] == want == fa_ops.select_path(dtype, aligned)
    assert route == {"path": want, **gpu_mapping.flash_bwd_smem_plan(64, want)}
    assert route["fits"]
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.bwd_dispatch(96, dtype, aligned)


def _recording_backward(monkeypatch):
    """The faked card's forward (the plain version with its lse), the
    backward's real dispatch, each C entry replaced by a recorder and
    ``attention_grad`` by a trap: (entry name, arguments) per launch."""
    _fake_card(monkeypatch)
    calls = []

    def lib(path, backward=False):
        assert backward
        name = fa_ops.BWD_ENTRIES[path][0]
        return lambda *a: calls.append((name, a)) or 0

    def trap(*a, **k):
        raise AssertionError("attention_grad ran on the card")

    monkeypatch.setattr(fa_ops, "_bwd_launch", _REAL_BWD_LAUNCH)
    monkeypatch.setattr(fa_ops, "_lib", lib)
    monkeypatch.setattr(fa_ops, "attention_grad", trap)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    return calls


_REAL_BWD_LAUNCH = fa_ops._bwd_launch


def _grid_tensor(shape, dtype, gen, off):
    """Random ``shape`` whose rows start ``off`` elements past a 16-byte
    boundary (0: on it), requiring a gradient."""
    base = torch.randn(*shape[:-1], shape[-1] + off, generator=gen)
    return base.to(dtype)[..., off:].requires_grad_()


@pytest.mark.parametrize("dtype,off,entry,flag", [
    (torch.bfloat16, 0, "flash_attention_bwd_tc_launch", None),
    (torch.bfloat16, 1, "flash_attention_bwd_launch", (1,)),
    (torch.float32, 0, "flash_attention_bwd_launch", (0,))])
def test_faked_card_backward_launches_the_routed_entry(monkeypatch, dtype,
                                                       off, entry, flag):
    """On the faked card the autograd backward runs the real dispatch: it
    launches the entry ``bwd_dispatch`` routes to (the shape, strides,
    mask and scale in place; on ``tensor_core`` the forward's o and o_lo
    and the group's two fp32 partials), counts one launch by path, and
    never calls ``attention_grad``."""
    calls = _recording_backward(monkeypatch)
    gen = torch.Generator().manual_seed(5)
    q = _grid_tensor((2, 96, 4, 64), dtype, gen, off)
    k = _grid_tensor((2, 96, 2, 64), dtype, gen, off)
    v = _grid_tensor((2, 96, 2, 64), dtype, gen, off)
    o = fa_ops.attention(q, k, v, causal=True, window=40)
    assert fa_ops.attention.launches == 1
    do = torch.ones_like(o)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    assert [name for name, _ in calls] == [entry]
    a = calls[0][1]
    assert a[9:15] == (2, 96, 96, 4, 2, 64)
    assert list(a[15]) == [s for t in (q, k, v, do, dq, dk, dv)
                           for s in t.stride()[:3]]
    assert a[16:19] == (1, 40, 0.125)
    if flag is None:    # o (the output itself), o_lo, dk and dv partials
        assert a[19] == o.data_ptr() and len(a[19:-1]) == 4
        assert all(isinstance(x, int) and x for x in a[20:-1])
        assert len(set(a[19:-1])) == 4
    else:
        assert a[19:-1] == flag
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    path = "tensor_core" if entry.endswith("tc_launch") else "fma"
    assert fa_ops.attention.bwd_launches == 1
    assert fa_ops.attention.bwd_paths == {**dict.fromkeys(fa_ops.PATHS, 0),
                                          path: 1}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_backward_is_the_plain_version(monkeypatch, device):
    """On the CPU and on ``meta`` the backward is ``attention_grad`` and
    no launch is counted."""
    seen = []
    real = fa_ops.attention_grad
    monkeypatch.setattr(fa_ops, "attention_grad",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    monkeypatch.setattr(fa_ops.attention, "bwd_launches", 0)
    q = torch.randn(1, 32, 4, 32, device=device, requires_grad=True)
    k = torch.randn(1, 32, 2, 32, device=device, requires_grad=True)
    v = torch.randn(1, 32, 2, 32, device=device, requires_grad=True)
    o = fa_ops.attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    assert seen == [1] and fa_ops.attention.bwd_launches == 0
    assert all(g.device.type == device for g in grads)


def test_backward_entries_and_smem_plan_match_the_source():
    """Each backward path's ctypes signature has its C entry's parameters
    in order; the layout constants and ``flash_bwd_smem_plan`` name what
    ``csrc/flash_attention_bwd.cu`` is compiled with and sums."""
    source = "flash_attention_bwd.cu"
    assert "flash_attention_bwd" in _build.SOURCES
    assert set(fa_ops.BWD_ENTRIES) == set(fa_ops.PATHS)
    for entry, argtypes in fa_ops.BWD_ENTRIES.values():
        got = [_CTYPES.get(t, "llptr") for t in argtypes]
        assert got == _c_params(source, entry), entry
    text = (_build.CSRC / source).read_text()

    def c(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))
    assert c("kThreads") == gpu_mapping.FLASH_THREADS
    assert c("kTile") == gpu_mapping.FLASH_BWD_TILE
    assert c("kChunk") == gpu_mapping.FLASH_BWD_TC_CHUNK
    assert c("kTcSplitD") == gpu_mapping.FLASH_BWD_TC_SPLIT_D
    assert c("kTcWideD") == gpu_mapping.FLASH_BWD_TC_WIDE_D
    assert c("kProducer") == gpu_mapping.FLASH_BWD_TC_PRODUCER
    assert c("kFmaWideD") == gpu_mapping.FLASH_BWD_FMA_WIDE_D
    assert c("kFmaNarrow") == gpu_mapping.FLASH_BWD_FMA_NARROW
    for d in gpu_mapping.FLASH_HEAD_DIMS:
        assert f"launch_bwd_tc<{d}>(" in text
        assert f"launch_bwd_fma<T, {d}>(" in text
    # the launchers' sums: tensor_core 1 KB of slack, 8 KB boxes (own
    # tiles and stages), dK/dV's fp32 lse and D_i a stage, barriers; fma fp32 [64 + 32, 257]
    # twice, dS [64, 33] (dK/dV: P too, and lse and D_i of 32 rows)
    flat = " ".join(text.split())
    for body in (
            "1024 + (2 * tc_dq_wgs<D>() + 2 * tc_dq_stages<D>()) * "
            "tc_chunks<D>() * kBox + (2 * tc_dq_stages<D>() + 1) * "
            "sizeof(uint64_t)",
            "1024 + (2 * tc_dkdv_keys<D>() / kTile + 2 * "
            "tc_dkdv_stages<D>()) * tc_chunks<D>() * kBox + "
            "tc_dkdv_stages<D>() * 2 * kTile * sizeof(float) + (2 * "
            "tc_dkdv_stages<D>() + 1) * sizeof(uint64_t)",
            "(2 * (kTile + fma_tile<D>()) * (D + 1) + kTile * "
            "(fma_tile<D>() + 1)) * sizeof(float)",
            "(2 * (kTile + fma_tile<D>()) * (D + 1) + 2 * kTile * "
            "(fma_tile<D>() + 1) + 2 * fma_tile<D>()) * sizeof(float)"):
        assert f"return {body};" in flat, body
    # at gemma3's head dim 256: dQ one warpgroup, q and dO [64, 256] and
    # two stages of K and V; dK/dV k and v [64, 256] and two stages of q
    # and dO; at qwen2's 64: two warpgroups and three stages each, dK/dV
    # on 128 keys; at 128 dK/dV's warpgroups share 64 keys
    box = 64 * 64 * 2
    tc = gpu_mapping.flash_bwd_smem_plan(256, "tensor_core")
    assert {n: k["smem_need"] for n, k in tc["kernels"].items()} \
        == {"dq": 1024 + (2 + 4) * 4 * box + 5 * 8,
            "dkdv": 1024 + (2 + 4) * 4 * box + 2 * 512 + 5 * 8}
    assert {n: k["threads"] for n, k in tc["kernels"].items()} \
        == {"dq": 160, "dkdv": 288}
    tc64 = gpu_mapping.flash_bwd_smem_plan(64, "tensor_core",
                                           shape=(4, 4096, 14, 2))
    assert {n: k["smem_need"] for n, k in tc64["kernels"].items()} \
        == {"dq": 1024 + (4 + 6) * box + 7 * 8,
            "dkdv": 1024 + (4 + 6) * box + 3 * 512 + 7 * 8}
    assert {n: k["threads"] for n, k in tc64["kernels"].items()} \
        == {"dq": 288, "dkdv": 288}
    tc128 = gpu_mapping.flash_bwd_smem_plan(128, "tensor_core")
    assert tc128["kernels"]["dkdv"]["rows"] == 64
    assert tc128["kernels"]["dkdv"]["smem_need"] \
        == 1024 + (2 + 6) * 2 * box + 3 * 512 + 7 * 8
    assert tc64["scratch_bytes"] == 2 * 4 * 4096 * 14 * 64 * 4
    assert gpu_mapping.flash_bwd_smem_plan(
        112, "tensor_core", shape=(4, 1024, 32, 32))["scratch_bytes"] == 0
    assert all(k["blocks_per_sm"] == 1 for k in tc64["kernels"].values())
    fma = gpu_mapping.flash_bwd_smem_plan(256, "fma")
    assert {n: k["smem_need"] for n, k in fma["kernels"].items()} \
        == {"dq": 4 * (2 * 96 * 257 + 64 * 33),
            "dkdv": 4 * (2 * 96 * 257 + 2 * 64 * 33 + 64)}
    assert fma["kernels"]["dkdv"]["threads"] == 256
    assert tc["fits"] and fma["fits"]
    for d in gpu_mapping.FLASH_HEAD_DIMS:
        for path in fa_ops.PATHS:
            assert gpu_mapping.flash_bwd_smem_plan(d, path)["fits"]
    with pytest.raises(ValueError, match="path"):
        gpu_mapping.flash_bwd_smem_plan(64, "wgmma")


def test_ctypes_strides_are_long_long():
    """The strides reach the C entries as 64-bit integers."""
    for _, argtypes in fa_ops.BWD_ENTRIES.values():
        assert argtypes[15]._type_ is ctypes.c_longlong
