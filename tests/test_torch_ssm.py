"""The port's Mamba2 (SSD) layer against the JAX package's (CPU, small
sizes).

``ssd_chunked`` (1, 2 and 4 chunks, with and without a carried state),
``_causal_conv`` (with and without the decode state), ``mamba_forward``
(returning its state, carrying one in, and the one-chunk fallback when
the chunk size does not divide the sequence) and ``mamba_decode`` take
the same numpy-seeded inputs in both packages and must agree under
``conftest.KERNEL_TOLERANCES`` (fp32 1e-5, bf16 3e-2 of the reference's
largest magnitude).  The reference computes all of it in jnp; no
Pallas kernel covers it, so the port's counterpart is torch ops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_kernel_close
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models import ssm as jssm
from repro.models.spec import is_par
from repro_torch.configs.base import SSMConfig
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import ssm as pssm
from repro_torch.models.spec import tree_items

DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
D_MODEL = 64
SSM = dict(state_dim=16, head_dim=32, expand=2, conv_kernel=4,
           chunk_size=8)


def _np(x, dtype):
    return np.asarray(jnp.asarray(x, JDT[dtype]))


def _t(arr):
    return tensor_from_numpy(arr, "cpu")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _rand(rng, shape, dtype, scale=1.0):
    return _np(scale * rng.standard_normal(shape, np.float32), dtype)


def _cfgs(**kw):
    fields = dict(SSM, **kw)
    return SSMConfig(**fields), JaxSSMConfig(**fields)


def _close(got, want, dtype):
    assert_kernel_close(_f32(got), _f32(want), dtype)


# ---------------------------------------------------------------- specs

def _items(tree, port):
    if port:
        return {k: (p.shape, p.axes, p.dtype) for k, p in tree_items(tree)}
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_par)[0]
    return {"/".join(k.key for k in path): (p.shape, p.axes, p.dtype)
            for path, p in leaves}


@pytest.mark.parametrize("dtype", DTYPES)
def test_specs_and_dims_match_reference(dtype):
    s, js = _cfgs()
    assert pssm.ssm_dims(D_MODEL, s) == jssm.ssm_dims(D_MODEL, js)
    assert _items(pssm.mamba_spec(D_MODEL, s, dtype), True) == \
        _items(jssm.mamba_spec(D_MODEL, js, dtype), False)
    assert _items(pssm.mamba_state_spec(3, D_MODEL, s, dtype), True) == \
        _items(jssm.mamba_state_spec(3, D_MODEL, js, dtype), False)


def test_softplus_is_the_references_above_torchs_threshold():
    """``F.softplus`` switches to the identity above 20; jax's (and the
    port's) logaddexp form does not."""
    x = np.array([-30.0, -5.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0],
                 np.float32)
    got = pssm._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ----------------------------------------------------------- ssd_chunked

def _ssd_inputs(rng, B, S, H, P, N, dtype):
    x = _rand(rng, (B, S, H, P), dtype)
    a = -rng.uniform(0.01, 0.6, (B, S, H)).astype(np.float32)
    Bm = _rand(rng, (B, S, N), dtype, 0.5)
    Cm = _rand(rng, (B, S, N), dtype, 0.5)
    return x, a, Bm, Cm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(dtype, n_chunks, with_state):
    rng = np.random.default_rng(10 * n_chunks + with_state)
    B, L, H, P, N = 2, 8, 3, 16, 8
    S = L * n_chunks
    x, a, Bm, Cm = _ssd_inputs(rng, B, S, H, P, N, dtype)
    s0 = _rand(rng, (B, H, N, P), dtype) if with_state else None
    y, final = pssm.ssd_chunked(_t(x), _t(a), _t(Bm), _t(Cm), L,
                                None if s0 is None else _t(s0))
    jy, jfinal = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(a),
                                  jnp.asarray(Bm), jnp.asarray(Cm), L,
                                  None if s0 is None else jnp.asarray(s0))
    assert y.dtype == final.dtype == _t(x).dtype
    assert tuple(final.shape) == (B, H, N, P)
    _close(y, jy, dtype)
    _close(final, jfinal, dtype)


def test_ssd_chunked_is_the_recurrence():
    """In fp32 the chunked form computes h_t = exp(a_t) h_{t-1} +
    B_t x_t^T, y_t = C_t . h_t step by step."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 1, 16, 2, 8, 4
    x, a, Bm, Cm = (_t(t) for t in
                    _ssd_inputs(rng, B, S, H, P, N, "float32"))
    y, final = pssm.ssd_chunked(x, a, Bm, Cm, 4)
    h = torch.zeros(B, H, N, P)
    ys = []
    for t in range(S):
        h = h * torch.exp(a[:, t])[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", Bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
    assert_kernel_close(y.numpy(), torch.stack(ys, 1).numpy(), "float32")
    assert_kernel_close(final.numpy(), h.numpy(), "float32")


# ---------------------------------------------------------- causal conv

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(20 + with_state)
    B, S, C, K = 2, 7, 12, 4
    x = _rand(rng, (B, S, C), dtype)
    w = _rand(rng, (K, C), dtype, 0.5)
    b = _rand(rng, (C,), dtype, 0.1)
    st = _rand(rng, (B, K - 1, C), dtype) if with_state else None
    y, new = pssm._causal_conv(_t(x), _t(w), _t(b),
                               None if st is None else _t(st))
    jy, jnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    _close(y, jy, dtype)
    np.testing.assert_array_equal(_f32(new), _f32(jnew))   # a copy


# ----------------------------------------------------- mamba layer

def _mamba_params(rng, s, dtype):
    """Every leaf of ``mamba_spec`` drawn from ``rng``, the bias, decay,
    skip and norm leaves non-trivial too."""
    spec = jssm.mamba_spec(D_MODEL, s, dtype)
    p = {}
    for name, par in spec.items():
        if name == "A_log":
            p[name] = rng.uniform(-2.5, 0.5, par.shape).astype(np.float32)
        elif name in ("D", "norm"):
            p[name] = (1 + 0.3 * rng.standard_normal(par.shape)).astype(
                np.float32)
        elif name == "dt_bias":
            p[name] = (0.5 * rng.standard_normal(par.shape)).astype(
                np.float32)
        else:
            scale = 0.1 if name == "conv_b" else par.shape[0] ** -0.5
            p[name] = _rand(rng, par.shape, par.dtype, scale)
    return ({k: _t(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _state(rng, s, B, dtype):
    _, nheads, conv_dim = jssm.ssm_dims(D_MODEL, s)
    return {"conv": _rand(rng, (B, s.conv_kernel - 1, conv_dim), dtype),
            "ssm": _rand(rng, (B, nheads, s.state_dim, s.head_dim), dtype,
                         0.5)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,with_state", [
    (16, False),    # two chunks, state returned
    (16, True),     # a carried state in
    (12, False),    # 8 does not divide 12: one chunk of 12
])
def test_mamba_forward_matches_reference(dtype, S, with_state):
    s, js = _cfgs()
    rng = np.random.default_rng(S + with_state)
    pt, pj = _mamba_params(rng, js, dtype)
    x = _rand(rng, (2, S, D_MODEL), dtype)
    st = _state(rng, js, 2, dtype) if with_state else None
    out, new = pssm.mamba_forward(
        pt, _t(x), s, None if st is None else
        {k: _t(v) for k, v in st.items()}, return_state=True)
    jout, jnew = jssm.mamba_forward(
        pj, jnp.asarray(x), js, None if st is None else
        {k: jnp.asarray(v) for k, v in st.items()}, return_state=True)
    _close(out, jout, dtype)
    for k in ("conv", "ssm"):
        _close(new[k], jnew[k], dtype)
    plain = pssm.mamba_forward(pt, _t(x), s, None if st is None else
                               {k: _t(v) for k, v in st.items()})
    assert torch.equal(plain, out)


def test_chunk_fallback_is_one_block():
    """S % chunk_size != 0: the whole sequence is one chunk, which the
    port computes as ``ssd_chunked`` with chunk = S."""
    s, _ = _cfgs()
    rng = np.random.default_rng(4)
    pt, _ = _mamba_params(rng, _cfgs()[1], "float32")
    x = _t(_rand(rng, (1, 12, D_MODEL), "float32"))
    out = pssm.mamba_forward(pt, x, s)
    same = pssm.mamba_forward(pt, x, dataclasses.replace(s, chunk_size=12))
    assert torch.equal(out, same)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_reference(dtype):
    s, js = _cfgs()
    rng = np.random.default_rng(7)
    pt, pj = _mamba_params(rng, js, dtype)
    x = _rand(rng, (3, 1, D_MODEL), dtype)
    st = _state(rng, js, 3, dtype)
    tst = {k: _t(v) for k, v in st.items()}
    kept = {k: v.clone() for k, v in tst.items()}
    out, new = pssm.mamba_decode(pt, _t(x), s, tst)
    jout, jnew = jssm.mamba_decode(pj, jnp.asarray(x), js,
                                   {k: jnp.asarray(v) for k, v in st.items()})
    _close(out, jout, dtype)
    for k in ("conv", "ssm"):
        assert new[k].dtype == tst[k].dtype
        _close(new[k], jnew[k], dtype)
        assert torch.equal(tst[k], kept[k])      # the input is not written


def test_decode_steps_continue_the_forward():
    """Prefill then decode, token by token, equals one forward over the
    whole sequence (fp32)."""
    s, js = _cfgs()
    rng = np.random.default_rng(9)
    pt, _ = _mamba_params(rng, js, "float32")
    x = _t(_rand(rng, (2, 20, D_MODEL), "float32"))
    want = pssm.mamba_forward(pt, x, s)
    out, st = pssm.mamba_forward(pt, x[:, :16], s, return_state=True)
    outs = [out]
    for t in range(16, 20):
        y, st = pssm.mamba_decode(pt, x[:, t:t + 1], s, st)
        outs.append(y)
    assert_kernel_close(torch.cat(outs, 1).numpy(), want.numpy(), "float32")


def test_ssd_chunked_gradient_stays_finite_where_the_decays_overflow():
    """At full width a chunk's cumulative log-decays reach hundreds, and
    exp(ca_t - ca_j) above the diagonal overflows.  Both packages' SSD
    forwards agree (the pairs are masked), but the reference masks
    after the exp, so ``jax.grad`` takes 0 * inf = NaN there; the port
    masks before it, and its gradient is finite (and where no decay
    overflows, the same as the reference's)."""
    rng = np.random.default_rng(7)
    B, S, H, P, N, chunk = 1, 32, 2, 8, 4, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    strong = -rng.uniform(10.0, 20.0, (B, S, H)).astype(np.float32)
    weak = -rng.uniform(0.0, 0.5, (B, S, H)).astype(np.float32)

    def jgrad(a):
        return jax.grad(lambda xx, aa: jnp.sum(
            jssm.ssd_chunked(xx, aa, jnp.asarray(Bm), jnp.asarray(Cm),
                             chunk)[0] ** 2), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(a))

    def pgrad(a):
        xt, at = (torch.from_numpy(v).requires_grad_() for v in (x, a))
        y, _ = pssm.ssd_chunked(xt, at, torch.from_numpy(Bm),
                                torch.from_numpy(Cm), chunk)
        want = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(a),
                                jnp.asarray(Bm), jnp.asarray(Cm), chunk)[0]
        assert_kernel_close(y.detach().numpy(), np.asarray(want), "float32")
        return torch.autograd.grad((y ** 2).sum(), (xt, at))

    ref_strong = jgrad(strong)
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_strong)
    assert all(torch.isfinite(g).all() for g in pgrad(strong))
    for got, want in zip(pgrad(weak), jgrad(weak)):
        assert_kernel_close(got.numpy(), np.asarray(want), "float32")
