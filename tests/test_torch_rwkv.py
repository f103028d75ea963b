"""The port's RWKV path against the JAX package's (CPU, small sizes).

``wkv6``: the port's plain version (what its wrapper runs for CPU
tensors) against the reference's Pallas kernel in interpret mode and
its ``wkv6_ref`` oracle, on numpy-seeded inputs: the cases of
``tests/test_kernel_wkv6.py``, its strong-decay case and a case with
the decays the model makes at its random init.  Tolerance: the repo's
wkv6 policy, 2e-3 of the largest magnitude.

Functions (``_ddlerp``, ``timemix_forward``, ``channelmix_forward``,
the torch copies of ``wkv6_chunked``/``wkv6_sequential``) in fp32 and
bf16 under ``conftest.KERNEL_TOLERANCES`` (fp32 1e-5, bf16 3e-2 of the
largest magnitude).

The whole slice: reduced rwkv6-1.6b (2 layers, d 128, head_dim 32,
chunk 32) in fp32 with the JAX package's parameters, ``u`` and the
``maa_*`` mixes set non-zero: prefill logits and state within fp32
1e-5, 8 greedy tokens identical, decode after prefill equal to the full
forward, and the decode state updated in place.

Where the reference's model path runs its clamped ``wkv6_chunked``
(every prefill whose length the chunk divides) the comparison lifts the
clamp to 80 (exp(80) is finite in fp32): at the model's own decays the
clamp at 30 drops terms whose true weight is near 1 (see
``test_reference_chunked_clamp_drops_terms_at_model_decays``), while
the port's prefill WKV, like the TPU kernel, is exact.  The port's own
copy of ``wkv6_chunked`` keeps the clamp at 30, as the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_kernel_close
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.wkv6.ops import wkv as jax_wkv
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import lm as jlm
from repro.models import rwkv as jrwkv
from repro.models.lm import RunOptions as JaxRunOptions
from repro_torch import convert
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import lm as plm
from repro_torch.models import rwkv as prwkv
from repro_torch.models.spec import tree_from_items, tree_items
from test_torch_model import DTYPES, _f32, _np, _rand, _t, port_cfg

WKV_TOL = 2e-3
UNCLAMPED = 80.0


def _close_max_normalised(got, want, tol=WKV_TOL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9)
    assert err < tol, f"rel err {err:.2e} >= {tol:.0e}"


def _wkv_inputs(B, S, H, K, decay, seed, dtype="float32"):
    """r, k, v ~ N(0, 0.25); u ~ N(0, 0.09); w_log by ``decay``: as
    tests/test_kernel_wkv6.py draws it, the constant -4, or as the model
    makes it at init (-exp(w0 + eps), w0 uniform in [-2.5, -0.5], eps
    ~ N(0, 0.25) for the decay LoRA's term)."""
    rng = np.random.default_rng(seed)
    r, k, v = (_np(0.5 * rng.standard_normal((B, S, H, K), np.float32),
                   dtype) for _ in range(3))
    if decay == "reference":
        w = -np.exp(0.8 * rng.standard_normal((B, S, H, K)) - 2.0)
    elif decay == "strong":
        w = np.full((B, S, H, K), -4.0)
    else:
        w0 = -0.5 - 2.0 * rng.random((H, K))
        w = -np.exp(w0 + 0.5 * rng.standard_normal((B, S, H, K)))
    u = 0.3 * rng.standard_normal((H, K))
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


# ----------------------------------------------------------------- wkv6

WKV_CASES = [
    # (B, S, H, K, chunk, decay): tests/test_kernel_wkv6.py's CASES,
    # its strong-decay case, and the model's decays
    (2, 128, 2, 64, 32, "reference"),
    (1, 256, 4, 64, 64, "reference"),
    (2, 64, 2, 128, 64, "reference"),
    (1, 96, 3, 32, 32, "reference"),
    (1, 64, 2, 64, 32, "strong"),
    (2, 64, 2, 32, 32, "model"),
]


@pytest.mark.parametrize("B,S,H,K,chunk,decay", WKV_CASES)
def test_plain_wkv_matches_pallas_and_oracle(B, S, H, K, chunk, decay):
    r, k, v, w, u = _wkv_inputs(B, S, H, K, decay, seed=S + K)
    before = wkv_ops.wkv.launches
    y, s = wkv_ops.wkv(*(_t(a) for a in (r, k, v, w, u)), chunk=chunk)
    assert wkv_ops.wkv.launches == before      # the plain path
    assert y.dtype == torch.float32 and s.shape == (B, H, K, K)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    py, ps = jax_wkv(*jargs, chunk=chunk, interpret=True)
    oy, os_ = jax_wkv6_ref(*jargs)
    for got, want in ((y, py), (s, ps), (y, oy), (s, os_)):
        _close_max_normalised(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_wkv_returns_y_in_rs_dtype(dtype):
    r, k, v, w, u = _wkv_inputs(1, 32, 2, 32, "model", 3, dtype)
    y, s = wkv_ops.wkv(*(_t(a) for a in (r, k, v, w, u)))
    oy, os_ = jax_wkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    assert y.dtype == _t(r).dtype and s.dtype == torch.float32
    assert_kernel_close(_f32(y), _f32(oy), dtype)
    assert_kernel_close(_f32(s), _f32(os_), "float32")


def test_reference_chunked_clamp_drops_terms_at_model_decays():
    """At the model's init decays, -cw over a 64-token chunk passes 30,
    and the reference's clamped chunked form leaves the exact recurrence
    that the port's prefill WKV (and the TPU kernel) computes."""
    r, k, v, w, u = _wkv_inputs(2, 128, 2, 32, "model", 5)
    assert -np.cumsum(w[:, :64], axis=1).min() > 30
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    oy, _ = jax_wkv6_ref(*jargs)
    cy, _ = jrwkv.wkv6_chunked(*jargs, 64)
    ref_err = float(jnp.max(jnp.abs(cy - oy)) / jnp.max(jnp.abs(oy)))
    assert ref_err > WKV_TOL
    y, _ = wkv_ops.wkv(*(_t(a) for a in (r, k, v, w, u)), chunk=64)
    _close_max_normalised(y, oy)


@pytest.mark.parametrize("form", ["chunked", "sequential"])
@pytest.mark.parametrize("with_state", [False, True])
def test_torch_wkv_copies_match_reference(form, with_state):
    r, k, v, w, u = _wkv_inputs(2, 32, 2, 32, "reference", 9)
    rng = np.random.default_rng(10)
    init = (0.2 * rng.standard_normal((2, 2, 32, 32))).astype(np.float32) \
        if with_state else None
    args = [r, k, v, w, u]
    if form == "chunked":
        got = prwkv.wkv6_chunked(*(_t(a) for a in args), 16,
                                 None if init is None else _t(init))
        want = jrwkv.wkv6_chunked(*(jnp.asarray(a) for a in args), 16,
                                  None if init is None else jnp.asarray(init))
    else:
        got = prwkv.wkv6_sequential(*(_t(a) for a in args),
                                    None if init is None else _t(init))
        want = jrwkv.wkv6_sequential(
            *(jnp.asarray(a) for a in args),
            None if init is None else jnp.asarray(init))
    assert_kernel_close([_f32(g) for g in got], [_f32(x) for x in want],
                        "float32")


def test_torch_chunked_keeps_the_reference_clamp():
    assert prwkv._EXP_CLAMP == jrwkv._EXP_CLAMP == 30.0
    r, k, v, w, u = _wkv_inputs(1, 64, 2, 32, "model", 5)
    got = prwkv.wkv6_chunked(*(_t(a) for a in (r, k, v, w, u)), 32)
    want = jrwkv.wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                              32)
    assert_kernel_close([_f32(g) for g in got], [_f32(x) for x in want],
                        "float32")


@pytest.mark.parametrize("shapes,kw,err", [
    (((1, 8, 2, 32),) * 4 + ((3, 32),), {}, ValueError),       # u shape
    (((1, 8, 2, 32),) * 3 + ((1, 8, 2, 16), (2, 32)), {}, ValueError),
    (((1, 0, 2, 32),) * 4 + ((2, 32),), {}, ValueError),       # empty
    (((1, 8, 2, 32),) * 4 + ((2, 32),), {"chunk": -4}, ValueError),
])
def test_wkv_rejects_bad_operands(shapes, kw, err):
    with pytest.raises(err):
        wkv_ops.wkv(*(torch.ones(s) for s in shapes), **kw)


def test_wkv_rejects_non_fp32_decay_and_mixed_dtypes():
    x = torch.ones(1, 8, 2, 32)
    u = torch.ones(2, 32)
    with pytest.raises(TypeError):
        wkv_ops.wkv(x, x, x, x.bfloat16(), u)
    with pytest.raises(TypeError):
        wkv_ops.wkv(x.bfloat16(), x, x, x, u)


# ------------------------------------------------------------ functions

D, HD, LORA = 64, 32, 16
RCFG = dataclasses.replace(jax_get_config("rwkv6-1.6b").rwkv, head_dim=HD,
                           decay_lora=LORA, mix_lora=8, chunk_size=16)


def _timemix_params(rng, dtype):
    H, ml = D // HD, RCFG.mix_lora
    p = {"maa_x": _rand(rng, (D,), "float32", 0.3),
         "maa_rkvwg": _rand(rng, (5, D), "float32", 0.3),
         "mix_w1": _rand(rng, (D, 5 * ml), dtype, D ** -0.5),
         "mix_w2": _rand(rng, (5, ml, D), dtype, ml ** -0.5),
         "w0": (-0.5 - 2.0 * rng.random(D)).astype(np.float32),
         "wd_w1": _rand(rng, (D, LORA), dtype, D ** -0.5),
         "wd_w2": _rand(rng, (LORA, D), dtype, LORA ** -0.5),
         "u": _rand(rng, (H, HD), "float32", 0.3),
         "ln_x": (1 + _rand(rng, (D,), "float32", 0.1)).astype(np.float32),
         **{n: _rand(rng, (D, D), dtype, D ** -0.5)
            for n in ("wr", "wk", "wv", "wg", "wo")}}
    return {n: _t(a) for n, a in p.items()}, \
        {n: jnp.asarray(a) for n, a in p.items()}


def _channelmix_params(rng, dtype):
    p = {"maa_k": _rand(rng, (D,), "float32", 0.3),
         "maa_r": _rand(rng, (D,), "float32", 0.3),
         "wk": _rand(rng, (D, 96), dtype, D ** -0.5),
         "wv": _rand(rng, (96, D), dtype, 96 ** -0.5),
         "wr": _rand(rng, (D, D), dtype, D ** -0.5)}
    return {n: _t(a) for n, a in p.items()}, \
        {n: jnp.asarray(a) for n, a in p.items()}


def test_specs_match_reference():
    for port, ref in (
            (prwkv.timemix_spec(D, port_cfg(RCFG), "bfloat16"),
             jrwkv.timemix_spec(D, RCFG, "bfloat16")),
            (prwkv.channelmix_spec(D, 96, "bfloat16"),
             jrwkv.channelmix_spec(D, 96, "bfloat16")),
            (prwkv.rwkv_state_spec(2, D, port_cfg(RCFG), "bfloat16"),
             jrwkv.rwkv_state_spec(2, D, RCFG, "bfloat16"))):
        flat = dict(tree_items(port))
        jflat = {"/".join(k.key for k in path): p for path, p in
                 jax.tree_util.tree_flatten_with_path(
                     ref, is_leaf=lambda x: hasattr(x, "axes"))[0]}
        assert {k: (p.shape, p.axes, p.init, p.dtype)
                for k, p in flat.items()} == \
            {k: (p.shape, p.axes, p.init, p.dtype) for k, p in jflat.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_ddlerp(dtype):
    rng = np.random.default_rng(20)
    pt, pj = _timemix_params(rng, dtype)
    x = _rand(rng, (2, 9, D), dtype)
    xp = _rand(rng, (2, 9, D), dtype)
    got = prwkv._ddlerp(pt, _t(x), _t(xp))
    want = jrwkv._ddlerp(pj, jnp.asarray(x), jnp.asarray(xp))
    for g, w in zip(got, want):
        assert g.dtype == _t(x).dtype
        assert_kernel_close(_f32(g), _f32(w), dtype)


TIMEMIX_MODES = [
    # (S, state): S = 32 with no state is a chunked prefill in the
    # reference and the wkv6 kernel's path in the port; S = 24 is not a
    # multiple of the chunk (sequential in the reference); with a state,
    # S = 32 runs both chunked copies and S = 1 (decode) both sequential
    (32, False), (24, False), (32, True), (1, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,with_state", TIMEMIX_MODES)
def test_timemix_forward(dtype, S, with_state, monkeypatch):
    if not with_state:      # the port's prefill WKV is exact
        monkeypatch.setattr(jrwkv, "_EXP_CLAMP", UNCLAMPED)
    rng = np.random.default_rng(21)
    pt, pj = _timemix_params(rng, dtype)
    x = _rand(rng, (2, S, D), dtype)
    st = jst = None
    if with_state:
        shift = _rand(rng, (2, 1, D), dtype)
        wkv = _rand(rng, (2, D // HD, HD, HD), dtype, 0.3)
        st = {"shift": _t(shift), "wkv": _t(wkv)}
        jst = {"shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)}
    got, gst = prwkv.timemix_forward(pt, _t(x), port_cfg(RCFG), st,
                                     return_state=True)
    want, wst = jrwkv.timemix_forward(pj, jnp.asarray(x), RCFG, jst,
                                      return_state=True)
    assert got.dtype == _t(x).dtype and gst["wkv"].dtype == _t(x).dtype
    assert_kernel_close(_f32(got), _f32(want), dtype)
    assert_kernel_close(_f32(gst["shift"]), _f32(wst["shift"]), dtype)
    assert_kernel_close(_f32(gst["wkv"]), _f32(wst["wkv"]), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_channelmix_forward(dtype, with_state):
    rng = np.random.default_rng(22)
    pt, pj = _channelmix_params(rng, dtype)
    x = _rand(rng, (2, 7, D), dtype)
    prev = _rand(rng, (2, 1, D), dtype) if with_state else None
    got, gs = prwkv.channelmix_forward(
        pt, _t(x), None if prev is None else _t(prev), return_state=True)
    want, ws = jrwkv.channelmix_forward(
        pj, jnp.asarray(x), None if prev is None else jnp.asarray(prev),
        return_state=True)
    assert_kernel_close(_f32(got), _f32(want), dtype)
    np.testing.assert_array_equal(_f32(gs), _f32(ws))


# ------------------------------------------------------ the whole slice

B, S, GEN = 2, 64, 8


@pytest.fixture(scope="module")
def slice_setup():
    """Reduced rwkv6-1.6b at fp32 with the JAX package's parameters,
    ``u`` and the ``maa_*`` mixes set non-zero (their init is zeros)."""
    jcfg = jax_reduce_config(jax_get_config("rwkv6-1.6b"), layers=2,
                             d_model=128, vocab=512)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    cfg = port_cfg(jcfg)
    assert (cfg.rwkv.head_dim, cfg.rwkv.chunk_size) == (32, 32)
    rng = np.random.default_rng(31)
    np_params = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    stage = np_params["stage0"]["pos0"]
    for part, names in (("tm", ("u", "maa_x", "maa_rkvwg")),
                        ("cm", ("maa_k", "maa_r"))):
        for name in names:
            leaf = stage[part][name]
            stage[part][name] = (0.3 * rng.standard_normal(leaf.shape)
                                 ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.params_from_numpy(cfg, np_params, "cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


@pytest.fixture(scope="module")
def jax_run(slice_setup):
    jcfg, _, jparams, _, tokens = slice_setup
    opts = JaxRunOptions(cache_len=S + GEN, remat=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrwkv, "_EXP_CLAMP", UNCLAMPED)
        logits, cache = jlm.prefill(jcfg, jparams,
                                    {"tokens": jnp.asarray(tokens[:, :S])},
                                    opts)
    prefill = np.asarray(logits), jax.tree.map(np.asarray, cache)
    toks = []
    tok = jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1)
    for i in range(GEN):
        logits, cache = jlm.decode_step(jcfg, jparams, cache, tok, S + i,
                                        opts)
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1)
        toks.append(np.asarray(tok))
    return prefill, np.stack(toks, 1)


def _opts():
    return plm.RunOptions(cache_len=S + GEN, remat=False)


def test_slice_config_and_specs_match_reference(slice_setup):
    jcfg, cfg, *_ = slice_setup
    assert plm.param_count(cfg) == jlm.param_count(jcfg)
    full = jax_get_config("rwkv6-1.6b")
    assert plm.param_count(port_cfg(full)) == jlm.param_count(full) \
        == 1_599_719_424


def test_slice_prefill_matches_reference(slice_setup, jax_run):
    _, cfg, _, params, tokens = slice_setup
    (ref_logits, ref_cache), _ = jax_run
    logits, cache = plm.prefill(
        cfg, params, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
        _opts())
    V = cfg.vocab_size
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")
    ref_flat = dict(tree_items(ref_cache))
    flat = dict(tree_items(cache))
    assert set(flat) == set(ref_flat) == {
        "stage0/pos0/cm", "stage0/pos0/tm/shift", "stage0/pos0/tm/wkv"}
    for path, leaf in flat.items():
        assert_kernel_close(_f32(leaf), ref_flat[path], "float32")


def test_slice_greedy_tokens_identical_to_reference(slice_setup, jax_run):
    _, cfg, _, params, tokens = slice_setup
    _, ref_toks = jax_run
    logits, cache = plm.prefill(
        cfg, params, {"tokens": torch.from_numpy(tokens[:, :S]).long()},
        _opts())
    toks = []
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    for i in range(GEN):
        logits, cache = plm.decode_step(cfg, params, cache, tok, S + i,
                                        _opts())
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        toks.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(toks, 1), ref_toks)


def test_slice_converted_cache_round_trips(slice_setup, jax_run):
    _, cfg, *_ = slice_setup
    (_, ref_cache), _ = jax_run
    cache = convert.cache_from_numpy(cfg, ref_cache, B, S + GEN, "cpu")
    for (_, got), (_, want) in zip(tree_items(cache), tree_items(ref_cache)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_decode_after_prefill_matches_full_forward(slice_setup):
    """As tests/test_decode_equivalence.py checks the reference: decode
    with the carried state reproduces the full forward's logits."""
    _, cfg, _, params, tokens = slice_setup
    toks = torch.from_numpy(tokens).long()
    x, _, _ = plm.forward_hidden(cfg, params, {"tokens": toks}, _opts())
    want = plm.compute_logits(cfg, params, x[:, -1])
    logits, cache = plm.prefill(cfg, params, {"tokens": toks[:, :S]},
                                _opts())
    for t in range(GEN):
        logits, cache = plm.decode_step(cfg, params, cache, toks[:, S + t],
                                        S + t, _opts())
    V = cfg.vocab_size
    assert_kernel_close(_f32(logits)[:, :V], _f32(want)[:, :V], "float32")


def test_decode_step_updates_the_state_in_place(slice_setup):
    """The returned cache is the input's buffers, holding the new state;
    a second step reads the first step's state from them."""
    _, cfg, _, params, tokens = slice_setup
    toks = torch.from_numpy(tokens).long()
    _, cache = plm.prefill(cfg, params, {"tokens": toks[:, :S]}, _opts())
    before = {k: v.clone() for k, v in tree_items(cache)}
    ptrs = {k: v.data_ptr() for k, v in tree_items(cache)}
    _, out = plm.decode_step(cfg, params, cache, toks[:, S], S, _opts())
    assert out is cache
    for path, leaf in tree_items(out):
        assert leaf.data_ptr() == ptrs[path], path
        assert not torch.equal(leaf, before[path]), path
    second, _ = plm.decode_step(cfg, params, cache, toks[:, S + 1], S + 1,
                                _opts())
    stale = tree_from_items(cache, before)
    wrong, _ = plm.decode_step(cfg, params, stale, toks[:, S + 1], S + 1,
                               _opts())
    assert not torch.equal(second, wrong)


# ----------------------------------------------------- on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run chip_smoke.py there")
    from repro_torch.compat import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
def test_cuda_wkv_launches_kernel_and_matches_plain(cuda_device):
    from repro_torch.kernels.tolerance import check_wkv, wkv_inputs
    g = torch.Generator(device=cuda_device).manual_seed(0)
    args = wkv_inputs(2, 128, 4, 64, torch.bfloat16, "model", g,
                      cuda_device)
    before = wkv_ops.wkv.launches
    got = wkv_ops.wkv(*args, chunk=256)
    torch.cuda.synchronize()
    assert wkv_ops.wkv.launches == before + 1
    assert check_wkv(got, wkv_ops.wkv_plain(*args), torch.bfloat16)[0] < 1


@pytest.mark.gpu
def test_cuda_wkv_raises_instead_of_falling_back(cuda_device):
    before = wkv_ops.wkv.launches
    x = torch.ones(1, 8, 2, 48, device=cuda_device)
    with pytest.raises(ValueError):          # head dim 48: no kernel
        wkv_ops.wkv(x, x, x, x, torch.ones(2, 48, device=cuda_device))
    x = torch.ones(1, 8, 2, 64, device=cuda_device)
    u = torch.ones(2, 64, device=cuda_device)
    with pytest.raises(ValueError):          # not contiguous
        wkv_ops.wkv(x.transpose(1, 2).contiguous().transpose(1, 2), x, x,
                    x, u)
    with pytest.raises(ValueError):          # one operand on the CPU
        wkv_ops.wkv(x, x, x, x, u.cpu())
    assert wkv_ops.wkv.launches == before
