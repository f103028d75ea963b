"""The port's model path against the JAX package's (CPU, small sizes).

Per function (``rmsnorm``, ``apply_rope``, ``activate``,
``qkv_project``, ``sdpa``, ``decode_attention``, ``dense_ffn``) the same
numpy-seeded inputs go through both packages in fp32 and bf16 and must
agree under ``conftest.KERNEL_TOLERANCES`` (fp32 1e-5, bf16 3e-2,
relative to the reference's largest magnitude).

For the whole slice, reduced qwen2-0.5b (2 layers, fp32) runs with the
JAX package's ``init_params`` converted through
``convert.params_from_numpy``: prefill logits and KV caches within the
fp32 tolerance, 8 greedy decode tokens identical to
``repro.models.lm.decode_step``'s, and ``decode_scan`` True and False
bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_LAYERS, assert_kernel_close, tiny_cfg
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.models.lm import RunOptions as JaxRunOptions
from repro.models.spec import is_par
from repro_torch import convert
from repro_torch.configs import base as pbase
from repro_torch.configs import get_config
from repro_torch.models import attention as pattn
from repro_torch.models import common as pcommon
from repro_torch.models import ffn as pffn
from repro_torch.models import lm as plm
from repro_torch.models.spec import tree_items

DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def port_cfg(obj):
    """The port's copy of a reference config dataclass, field by field
    (fails if the copy lacks a field)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(pbase, type(obj).__name__)
        return cls(**{f.name: port_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def _np(x, dtype):
    return np.asarray(jnp.asarray(x, JDT[dtype]))


def _t(arr):
    return convert.tensor_from_numpy(arr, "cpu")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _rand(rng, shape, dtype, scale=1.0):
    return _np(scale * rng.standard_normal(shape, np.float32), dtype)


# ------------------------------------------------------------- configs

PARAMS = {"qwen2-0.5b": 494_032_768, "rwkv6-1.6b": 1_599_719_424,
          "gemma3-12b": 11_765_788_416,
          "qwen3-moe-235b-a22b": 235_093_634_560,
          "llama4-maverick-400b-a17b": 400_712_504_320}


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_config_copy_matches_reference_field_for_field(arch):
    ref = jax_get_config(arch)
    assert port_cfg(ref) == get_config(arch)
    assert plm.param_count(get_config(arch)) == PARAMS[arch]
    assert plm.param_count(get_config(arch)) == jlm.param_count(ref)


@pytest.mark.parametrize("arch", sorted(PARAMS))
@pytest.mark.parametrize("full", [True, False])
def test_model_and_cache_specs_match_reference(full, arch):
    ref = jax_get_config(arch)
    if not full:
        ref = tiny_cfg(arch, num_layers=TINY_LAYERS[arch])
    cfg = port_cfg(ref)

    def ref_items(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree,
                                                      is_leaf=is_par)[0]
        return {"/".join(k.key for k in path): (p.shape, p.axes, p.dtype)
                for path, p in leaves}

    def port_items(tree):
        return {k: (p.shape, p.axes, p.dtype)
                for k, p in tree_items(tree)}

    assert port_items(plm.model_spec(cfg)) == \
        ref_items(jlm.model_spec(ref))
    assert port_items(plm.cache_spec(cfg, 2, 40)) == \
        ref_items(jlm.cache_spec(ref, 2, 40))


def test_init_params_is_seeded_and_keeps_the_scale_rule():
    cfg = get_config("qwen2-0.5b", num_layers=1)
    cfg = dataclasses.replace(cfg, vocab_size=256, d_model=64, d_ff=128,
                              attention=dataclasses.replace(
                                  cfg.attention, num_heads=8,
                                  num_kv_heads=2, head_dim=64))
    a = plm.init_params(cfg, seed=3, device="cpu")
    b = plm.init_params(cfg, seed=3, device="cpu")
    c = plm.init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(x, b_) for (_, x), (_, b_) in
               zip(tree_items(a), tree_items(b)))
    assert not torch.equal(a["embed"], c["embed"])
    # "scaled": fan-in is shape[-2], here the head count 8 of wq
    wq = a["stage0"]["pos0"]["attn"]["wq"].float()
    assert abs(wq.std().item() - 8 ** -0.5) < 0.02
    assert torch.all(a["stage0"]["pos0"]["attn"]["bq"] == 0)
    assert torch.all(a["final_norm"] == 1)


# ---------------------------------------------------------- functions

@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 5, 64), dtype)
    w = _rand(rng, (64,), "float32")
    got = pcommon.rmsnorm(_t(x), _t(w))
    want = jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    assert got.dtype == _t(x).dtype
    assert_kernel_close(_f32(got), _f32(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(dtype, theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 32), dtype)
    pos = np.array([0, 1, 2, 5, 9, 100, 4000], np.int32)
    got = pcommon.apply_rope(_t(x), torch.from_numpy(pos).long(), theta)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert_kernel_close(_f32(got), _f32(want), dtype)
    assert_kernel_close(_f32(pcommon.rope_freqs(32, theta)),
                        _f32(jcommon.rope_freqs(32, theta)), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu_sq"])
def test_activate(dtype, kind):
    rng = np.random.default_rng(2)
    g, u = _rand(rng, (3, 40), dtype), _rand(rng, (3, 40), dtype)
    got = pcommon.activate(_t(g), _t(u), kind)
    want = jcommon.activate(jnp.asarray(g), jnp.asarray(u), kind)
    assert_kernel_close(_f32(got), _f32(want), dtype)


def _attn_setup(rng, dtype, qk_norm=False):
    a = dataclasses.replace(get_config("qwen2-0.5b").attention,
                            num_heads=4, num_kv_heads=2, head_dim=32,
                            qk_norm=qk_norm)
    d = 64
    p = {"wq": _rand(rng, (d, 4, 32), dtype, d ** -0.5),
         "wk": _rand(rng, (d, 2, 32), dtype, d ** -0.5),
         "wv": _rand(rng, (d, 2, 32), dtype, d ** -0.5),
         "wo": _rand(rng, (4, 32, d), dtype, 128 ** -0.5),
         "bq": _rand(rng, (4, 32), dtype, 0.1),
         "bk": _rand(rng, (2, 32), dtype, 0.1),
         "bv": _rand(rng, (2, 32), dtype, 0.1)}
    if qk_norm:
        p["q_norm"] = _rand(rng, (32,), "float32")
        p["k_norm"] = _rand(rng, (32,), "float32")
    pt = {k: _t(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    return port_cfg(a), a, pt, pj, d


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_project_with_bias(dtype, qk_norm):
    rng = np.random.default_rng(3)
    a, ja, pt, pj, d = _attn_setup(rng, dtype, qk_norm)
    x = _rand(rng, (2, 9, d), dtype)
    pos = np.arange(9, dtype=np.int32)
    got = pattn.qkv_project(pt, _t(x), a, torch.from_numpy(pos).long(),
                            a.rope_theta)
    want = jattn.qkv_project(pj, jnp.asarray(x), ja, jnp.asarray(pos),
                             ja.rope_theta)
    for g, w in zip(got, want):
        assert_kernel_close(_f32(g), _f32(w), dtype)
    o = _rand(rng, (2, 9, 4, 32), dtype)
    assert_kernel_close(_f32(pattn.out_project(pt, _t(o))),
                        _f32(jattn.out_project(pj, jnp.asarray(o))), dtype)


SDPA_CASES = [
    # (causal, window, chunk_q, chunk_kv)
    (True, 0, 16, 16),
    (True, 0, 16, 0),
    (False, 0, 32, 16),
    (True, 8, 16, 16),
    (True, 0, 24, 16),     # chunk does not divide 64: one-block fallback
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,cq,ckv", SDPA_CASES)
def test_sdpa_chunked_matches_single_block_and_reference(dtype, causal,
                                                        window, cq, ckv):
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 64, 4, 2, 32
    q = _rand(rng, (B, S, H, hd), dtype)
    k = _rand(rng, (B, S, KV, hd), dtype)
    v = _rand(rng, (B, S, KV, hd), dtype)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, scale=hd ** -0.5)
    post = torch.from_numpy(pos).long()
    chunked = pattn.sdpa(_t(q), _t(k), _t(v), post, post, chunk_q=cq,
                         chunk_kv=ckv, **kw)
    single = pattn.sdpa(_t(q), _t(k), _t(v), post, post, **kw)
    assert_kernel_close(_f32(chunked), _f32(single), dtype)
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(pos), jnp.asarray(pos), chunk_q=cq,
                      chunk_kv=ckv, **kw)
    assert_kernel_close(_f32(chunked), _f32(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,window,pos", [
    (24, 0, 10),       # plain cache, write at pos
    (8, 8, 13),        # ring buffer: write at pos % L, slots rebuilt
    (8, 8, 5),         # ring not yet full: unwritten slots masked
])
def test_decode_attention_including_ring_buffer(dtype, L, window, pos):
    rng = np.random.default_rng(5)
    a, ja, pt, pj, d = _attn_setup(rng, dtype)
    x = _rand(rng, (2, 1, d), dtype)
    ck = _rand(rng, (2, L, 2, 32), dtype)
    cv = _rand(rng, (2, L, 2, 32), dtype)
    tk, tv = _t(ck), _t(cv)
    y, nk, nv = pattn.decode_attention(pt, _t(x), a, tk, tv, pos,
                                       theta=a.rope_theta, window=window)
    assert nk is tk and nv is tv          # updated in place
    jy, jk, jv = jattn.decode_attention(
        pj, jnp.asarray(x), ja, jnp.asarray(ck), jnp.asarray(cv), pos,
        theta=ja.rope_theta, window=window)
    assert_kernel_close(_f32(y), _f32(jy), dtype)
    assert_kernel_close(_f32(nk), _f32(jk), dtype)
    assert_kernel_close(_f32(nv), _f32(jv), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_dense_ffn(dtype, activation):
    rng = np.random.default_rng(6)
    p = {"w_gate": _rand(rng, (64, 96), dtype, 0.125),
         "w_down": _rand(rng, (96, 64), dtype, 0.1)}
    if activation == "swiglu":
        p["w_up"] = _rand(rng, (64, 96), dtype, 0.125)
    x = _rand(rng, (2, 5, 64), dtype)
    got = pffn.dense_ffn({k: _t(v) for k, v in p.items()}, _t(x),
                         activation)
    want = jffn.dense_ffn({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), activation)
    assert_kernel_close(_f32(got), _f32(want), dtype)
    spec = pffn.dense_ffn_spec(64, 96, activation, dtype)
    jspec = jffn.dense_ffn_spec(64, 96, activation, dtype)
    assert {k: v.shape for k, v in spec.items()} == \
        {k: v.shape for k, v in jspec.items()}


# ------------------------------------------------------ the whole slice

B, S, GEN = 2, 32, 8


@pytest.fixture(scope="module")
def slice_setup():
    """Reduced qwen2-0.5b at fp32, JAX parameters (with non-zero QKV
    biases) shared with the port through numpy."""
    jcfg = tiny_cfg("qwen2-0.5b", num_layers=2, dtype="float32")
    cfg = port_cfg(jcfg)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    np_params = jax.tree.map(np.asarray, jparams)
    for name in ("bq", "bk", "bv"):
        leaf = np_params["stage0"]["pos0"]["attn"][name]
        np_params["stage0"]["pos0"]["attn"][name] = \
            (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.params_from_numpy(cfg, np_params, "cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jopts = JaxRunOptions(chunk_q=16, chunk_kv=16, cache_len=S + GEN,
                          remat=False)
    opts = plm.RunOptions(chunk_q=16, chunk_kv=16, cache_len=S + GEN,
                          remat=False)
    return jcfg, cfg, jparams, params, tokens, jopts, opts


def jax_greedy(jcfg, jparams, tokens, jopts, steps=GEN, extra=None):
    """The reference's prefill of ``tokens`` [B, S] (and the numpy
    batch entries of ``extra``: frames, patch embeddings) and ``steps``
    greedy decode steps, jitted: (prefill logits, prefill cache, tokens
    [B, steps], last logits), as numpy."""
    P = tokens.shape[1]
    batch = {k: jnp.asarray(v) for k, v in (extra or {}).items()}
    batch["tokens"] = jnp.asarray(tokens)
    logits, cache = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b, jopts))(
        jparams, batch)
    step = jax.jit(lambda p, c, t, i: jlm.decode_step(jcfg, p, c, t, i,
                                                      jopts))
    prefill_logits, prefill_cache = np.asarray(logits), \
        jax.tree.map(np.asarray, cache)
    toks = []
    tok = jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1)
    for i in range(steps):
        logits, cache = step(jparams, cache, tok, P + i)
        tok = jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1)
        toks.append(np.asarray(tok))
    return prefill_logits, prefill_cache, np.stack(toks, 1), \
        np.asarray(logits)


def port_greedy(cfg, params, tokens, opts, steps=GEN, extra=None):
    """The port's counterpart of ``jax_greedy``: ((prefill logits, the
    prefill cache's leaves by path), tokens [B, steps], last logits)."""
    P = tokens.shape[1]
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in (extra or {}).items()}
    batch["tokens"] = torch.from_numpy(tokens).long()
    logits, cache = plm.prefill(cfg, params, batch, opts)
    first = (logits.clone(), {k: v.clone() for k, v in
                              tree_items(cache)})
    toks = []
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    for i in range(steps):
        logits, cache = plm.decode_step(cfg, params, cache, tok, P + i,
                                        opts)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        toks.append(tok.numpy())
    return first, np.stack(toks, 1), logits


def assert_prefill_matches(port_first, ref_logits, ref_cache, V):
    """Prefill logits (padding masked) and every cache leaf within the
    fp32 tolerance of the reference's."""
    logits, cache = port_first
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")
    assert np.all(_f32(logits)[:, V:] == -1e30)
    ref_flat = {k: v for k, v in tree_items(ref_cache)}
    assert set(ref_flat) == set(cache)
    for k, v in cache.items():
        assert_kernel_close(_f32(v), ref_flat[k], "float32")


@pytest.fixture(scope="module")
def jax_run(slice_setup):
    jcfg, _, jparams, _, tokens, jopts, _ = slice_setup
    return jax_greedy(jcfg, jparams, tokens, jopts)


def _port_run(slice_setup, decode_scan):
    _, cfg, _, params, tokens, _, opts = slice_setup
    opts = dataclasses.replace(opts, decode_scan=decode_scan)
    return port_greedy(cfg, params, tokens, opts)


def test_slice_prefill_matches_reference(slice_setup, jax_run):
    first, _, _ = _port_run(slice_setup, None)
    ref_logits, ref_cache, _, _ = jax_run
    assert_prefill_matches(first, ref_logits, ref_cache,
                           slice_setup[1].vocab_size)


def test_slice_greedy_tokens_identical_to_reference(slice_setup, jax_run):
    _, toks, logits = _port_run(slice_setup, None)
    _, _, ref_toks, ref_logits = jax_run
    np.testing.assert_array_equal(toks, ref_toks)
    V = slice_setup[1].vocab_size
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")


def test_decode_scan_and_unrolled_views_are_identical(slice_setup):
    (l1, c1), t1, d1 = _port_run(slice_setup, True)
    (l2, c2), t2, d2 = _port_run(slice_setup, False)
    np.testing.assert_array_equal(t1, t2)
    assert torch.equal(l1, l2) and torch.equal(d1, d2)


def test_decode_with_tensor_position_matches_int(slice_setup):
    """The graph-safe form (a 0-d position tensor) computes the same
    step as a Python int position."""
    _, cfg, _, params, tokens, _, opts = slice_setup
    batch = {"tokens": torch.from_numpy(tokens).long()}
    _, c_int = plm.prefill(cfg, params, batch, opts)
    _, c_ten = plm.prefill(cfg, params, batch, opts)
    tok = torch.arange(B)
    for i in range(3):
        l_int, _ = plm.decode_step(cfg, params, c_int, tok, S + i, opts)
        l_ten, _ = plm.decode_step(cfg, params, c_ten, tok,
                                   torch.tensor(S + i), opts)
        assert torch.equal(l_int, l_ten)
    for (_, a), (_, b) in zip(tree_items(c_int), tree_items(c_ten)):
        assert torch.equal(a, b)


def test_converted_cache_round_trips(slice_setup, jax_run):
    _, cfg, *_ = slice_setup
    _, ref_cache, _, _ = jax_run
    cache = convert.cache_from_numpy(cfg, ref_cache, B, S + GEN, "cpu")
    for (k, got), (_, want) in zip(tree_items(cache),
                                   tree_items(ref_cache)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_convert_rejects_mismatched_trees(slice_setup):
    jcfg, cfg, jparams, *_ = slice_setup
    np_params = jax.tree.map(np.asarray, jparams)
    bad = jax.tree.map(lambda x: x, np_params)
    bad["final_norm"] = bad["final_norm"][:-1]
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(cfg, bad, "cpu")
    bad = jax.tree.map(lambda x: x, np_params)
    bad["embed"] = bad["embed"].astype(np.float64)
    with pytest.raises(ValueError, match="dtype"):
        convert.params_from_numpy(cfg, bad, "cpu")
    bad = jax.tree.map(lambda x: x, np_params)
    bad["lm_head"] = bad["embed"]
    with pytest.raises(ValueError, match="unexpected"):
        convert.params_from_numpy(cfg, bad, "cpu")


def test_bf16_parameters_convert_through_the_bit_view():
    jcfg = tiny_cfg("qwen2-0.5b", num_layers=1)        # bf16
    np_params = jax.tree.map(
        np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(1)))
    params = convert.params_from_numpy(port_cfg(jcfg), np_params, "cpu")
    got = params["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        np_params["embed"].view(np.uint16))
