"""flash_attention's gradient in the port: the backward kernel's recipe
against the JAX package's gradient (CPU, small sizes), and the routes
that carry it.

* ``ref.attention_bwd_tiles`` (the recipe of
  ``csrc/flash_attention_bwd.cu``, tile by tile: P from the forward's
  lse, D_i = rowsum(dO * O), dS = P (dP - D_i)) against ``jax.grad`` of
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
  it.  Two choices of the recipe are what keeps dq there: D_i as the sum
  of its own P dP and dS split in two bf16 parts for the dQ product.
* The plain forward's lse is the reference's log-sum-exp of its masked
  scores.
* ``bwd_dispatch`` routes aligned bf16 to ``tensor_core`` and all else
  to ``fma``; on a faked card the backward launches the routed C entry
  and never calls ``attention_grad``; on the CPU and on ``meta`` it
  calls ``attention_grad`` and counts no launch.
* The backward's C entries and shared-memory constants against the
  source.
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
                                                     attention_ref)
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
    (torch.bfloat16, 0, "flash_attention_bwd_tc_launch", ()),
    (torch.bfloat16, 1, "flash_attention_bwd_launch", (1,)),
    (torch.float32, 0, "flash_attention_bwd_launch", (0,))])
def test_faked_card_backward_launches_the_routed_entry(monkeypatch, dtype,
                                                       off, entry, flag):
    """On the faked card the autograd backward runs the real dispatch: it
    launches the entry ``bwd_dispatch`` routes to (the shape, strides,
    mask and scale in place), counts one launch by path, and never calls
    ``attention_grad``."""
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
    assert a[16:19] == (1, 40, 0.125) and a[19:-1] == flag
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
    assert c("kTile") == gpu_mapping.FLASH_BWD_TILE == gpu_mapping.FLASH_BQ
    assert c("kTcPad") == gpu_mapping.FLASH_TC_PAD
    assert c("kTcSplitD") == gpu_mapping.FLASH_BWD_TC_SPLIT_D
    assert c("kFmaWideD") == gpu_mapping.FLASH_BWD_FMA_WIDE_D
    assert c("kFmaNarrow") == gpu_mapping.FLASH_BWD_FMA_NARROW
    for d in gpu_mapping.FLASH_HEAD_DIMS:
        assert f"launch_bwd_tc<{d}>(" in text
        assert f"launch_bwd_fma<T, {d}>(" in text
    # the launchers' sums, buffer by buffer, at gemma3's head dim 256:
    # tensor_core six bf16 tiles [64, 264] and fp32 lse (dQ) or lse and
    # D_i in two buffers (dK/dV); fma fp32 [64 + 32, 257] twice, dS
    # [64, 33] (dK/dV: P too, and lse and D_i of 32 rows)
    flat = " ".join(text.split())
    for body in (
            "6 * kTile * (D + kTcPad) * sizeof(bf16) + kTile * sizeof(float)",
            "6 * kTile * (D + kTcPad) * sizeof(bf16) + 4 * kTile * "
            "sizeof(float)",
            "(2 * (kTile + fma_tile<D>()) * (D + 1) + kTile * "
            "(fma_tile<D>() + 1)) * sizeof(float)",
            "(2 * (kTile + fma_tile<D>()) * (D + 1) + 2 * kTile * "
            "(fma_tile<D>() + 1) + 2 * fma_tile<D>()) * sizeof(float)"):
        assert f"return {body};" in flat, body
    tc = gpu_mapping.flash_bwd_smem_plan(256, "tensor_core")
    fma = gpu_mapping.flash_bwd_smem_plan(256, "fma")
    assert {n: k["smem_need"] for n, k in tc["kernels"].items()} \
        == {"dq": 6 * 64 * 264 * 2 + 256, "dkdv": 6 * 64 * 264 * 2 + 1024}
    assert {n: k["smem_need"] for n, k in fma["kernels"].items()} \
        == {"dq": 4 * (2 * 96 * 257 + 64 * 33),
            "dkdv": 4 * (2 * 96 * 257 + 2 * 64 * 33 + 64)}
    assert tc["kernels"]["dkdv"]["threads"] == 256
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
