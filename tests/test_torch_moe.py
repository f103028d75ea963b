"""The port's mixture-of-experts path against the JAX package's (CPU,
small sizes).

Functions (``_topk_dispatch``, ``_gather_dispatch``/``_gather_combine``,
``moe_ffn`` in its einsum and gather forms, the Switch aux loss) on the
same numpy-seeded inputs in both packages, fp32, within
``conftest.KERNEL_TOLERANCES`` (1e-5 of the largest magnitude); the
cases of ``tests/test_moe.py`` among them.  The gates are random
normals through a softmax, so no two experts of a token tie:
``jax.lax.top_k`` and ``torch.topk`` may order tied values differently,
and a tie would route a token to another expert in each package.

The whole slice: reduced qwen3-moe-235b-a22b (2 layers, every layer MoE,
4 experts top-2) and reduced llama4-maverick-400b-a17b (2 layers: one
unit of an MoE layer with a shared expert and a dense layer, 4 experts
top-1) in fp32 with the JAX package's parameters: prefill logits and
caches within the fp32 tolerance and 8 greedy tokens identical, for
both ``moe_impl`` values.  llama4 runs one unit, not the two of
``conftest.TINY_LAYERS``: without ``qk_norm`` its random attention
scores reach ~220, and at two units the reference's own prefill logits
move by 3.4e-5 of the largest when only its sdpa chunking changes (16
against one block), past the fp32 policy, against 4.9e-7 at one unit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_kernel_close, tiny_cfg
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.models.lm import RunOptions as JaxRunOptions
from repro_torch import convert
from repro_torch.models import blocks as pblk
from repro_torch.models import ffn as pffn
from repro_torch.models import lm as plm
from test_torch_model import (_f32, _t, assert_prefill_matches, jax_greedy,
                              port_cfg, port_greedy)

# reduced depth of each arch (see the module note for llama4's)
MOE_LAYERS = {"qwen3-moe-235b-a22b": 2, "llama4-maverick-400b-a17b": 2}
MOE_ARCHS = sorted(MOE_LAYERS)
IMPLS = ["einsum", "gather"]


def _gates(seed, G, S, E):
    logits = np.random.default_rng(seed).standard_normal((G, S, E))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _moe_params(m, d, activation, seed):
    """Reference MoE parameters (random, fp32) as numpy and both
    packages' tensors."""
    from repro.models.spec import init_tree
    jp = init_tree(jffn.moe_spec(d, m, activation, "float32"),
                   jax.random.PRNGKey(seed))
    np_p = jax.tree.map(np.asarray, jp)
    return jp, jax.tree.map(_t, np_p)


# ------------------------------------------------------------ dispatch

# (seed, G, S, E, k, capacity): capacities below S*k/E drop tokens
DISPATCH_CASES = [(0, 2, 16, 4, 1, 4), (1, 2, 16, 4, 2, 8),
                  (2, 2, 32, 8, 2, 8), (3, 1, 32, 4, 2, 4),
                  (4, 2, 16, 8, 1, 2)]


@pytest.mark.parametrize("seed,G,S,E,k,C", DISPATCH_CASES)
def test_topk_dispatch_matches_reference(seed, G, S, E, k, C):
    """Random softmax gates, so no two experts of a token tie: the two
    packages' top-k may order tied gates differently."""
    gates = _gates(seed, G, S, E)
    combine, dispatch = pffn._topk_dispatch(torch.from_numpy(gates), k, C)
    jc, jd = jffn._topk_dispatch(jnp.asarray(gates), k, C)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    assert_kernel_close(combine.numpy(), np.asarray(jc), "float32")
    # the capacity is static and respected: one token per (expert, slot),
    # at most k slots per token, weights within the gate simplex
    assert dispatch.sum(1).max() <= 1 and dispatch.sum((2, 3)).max() <= k
    assert combine.sum((2, 3)).max() <= 1 + 1e-6
    if C * E < S * k:
        assert dispatch.sum() < G * S * k           # some were dropped


@pytest.mark.parametrize("seed,G,S,E,k,C", DISPATCH_CASES)
def test_gather_dispatch_and_combine_match_reference(seed, G, S, E, k, C):
    gates = _gates(seed, G, S, E)
    m = JaxMoEConfig(num_experts=E, top_k=k, expert_ff=8)
    xg = np.random.default_rng(seed + 10).standard_normal(
        (G, S, 16)).astype(np.float32)
    xe, route = pffn._gather_dispatch(_t(xg), _t(gates), port_cfg(m), C)
    jxe, jroute = jffn._gather_dispatch(jnp.asarray(xg), jnp.asarray(gates),
                                        m, C)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jxe))
    for got, want in zip(route, jroute):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ye = np.random.default_rng(seed + 20).standard_normal(
        xe.shape).astype(np.float32)
    got = pffn._gather_combine(_t(ye), route, G, S, 16)
    want = jffn._gather_combine(jnp.asarray(ye), jroute, G, S, 16)
    assert_kernel_close(got.numpy(), np.asarray(want), "float32")


# ------------------------------------------------------------ moe_ffn

# (experts, top_k, expert_ff, group_size, capacity factor, shared ff,
#  activation, tokens)
MOE_CASES = [(4, 2, 32, 16, 2.0, 0, "swiglu", (2, 32)),
             (4, 1, 16, 8, 1.25, 0, "gelu", (1, 16)),
             (8, 2, 32, 32, 1.0, 0, "swiglu", (2, 32)),   # drops tokens
             (4, 1, 32, 16, 1.25, 24, "swiglu", (2, 16))]  # shared expert


@pytest.mark.parametrize("impl", IMPLS + ["ep"])
@pytest.mark.parametrize("E,k,f,gs,cf,shared,act,tokens", MOE_CASES)
def test_moe_ffn_matches_reference(impl, E, k, f, gs, cf, shared, act,
                                   tokens):
    m = JaxMoEConfig(num_experts=E, top_k=k, expert_ff=f, group_size=gs,
                     capacity_factor=cf, shared_expert_ff=shared)
    jp, pp = _moe_params(m, 64, act, E + k + gs)
    x = np.random.default_rng(7).standard_normal(
        tokens + (64,)).astype(np.float32)
    y, aux = pffn.moe_ffn(pp, _t(x), port_cfg(m), act, impl)
    jy, jaux = jffn.moe_ffn(jp, jnp.asarray(x), m, act, impl)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert_kernel_close(y.numpy(), np.asarray(jy), "float32")
    assert_kernel_close(aux.numpy(), np.asarray(jaux), "float32")


@pytest.mark.parametrize("E,k,f,gs,cf,shared,act,tokens", MOE_CASES)
def test_einsum_and_gather_forms_agree(E, k, f, gs, cf, shared, act,
                                       tokens):
    """With a capacity that holds every token.  When an expert
    overflows, the two forms drop different tokens, in the reference as
    here: the einsum form fills slots rank by rank over the top-k, the
    gather form token by token."""
    del cf
    m = JaxMoEConfig(num_experts=E, top_k=k, expert_ff=f, group_size=gs,
                     capacity_factor=float(E), shared_expert_ff=shared)
    _, pp = _moe_params(m, 64, act, 1)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        tokens + (64,)).astype(np.float32))
    y1, a1 = pffn.moe_ffn(pp, x, port_cfg(m), act, "einsum")
    y2, a2 = pffn.moe_ffn(pp, x, port_cfg(m), act, "gather")
    assert_kernel_close(y2.numpy(), y1.numpy(), "float32")
    assert torch.equal(a1, a2)
    y3, _ = pffn.moe_ffn(pp, x, port_cfg(m), act, "gather")
    assert torch.equal(y2, y3)                  # a static schedule


def test_aux_loss_is_near_one_for_a_balanced_router():
    """``tests/test_moe.py::test_moe_static_shapes_and_aux`` on the
    port: E * sum_e f_e p_e is about 1 for a near-uniform router."""
    m = JaxMoEConfig(num_experts=4, top_k=2, expert_ff=32, group_size=16,
                     capacity_factor=2.0)
    _, pp = _moe_params(m, 64, "swiglu", 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 64)).astype(np.float32))
    y, aux = pffn.moe_ffn(pp, x, port_cfg(m), "swiglu")
    assert y.shape == x.shape and torch.isfinite(aux)
    assert 0.5 < float(aux) < 4.0


@pytest.mark.parametrize("shared", [0, 64])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_moe_spec_matches_reference(shared, activation):
    m = JaxMoEConfig(num_experts=4, top_k=2, expert_ff=32,
                     shared_expert_ff=shared)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else (v.shape, v.axes,
                                                          v.dtype)
                for k, v in tree.items()}
    assert shapes(pffn.moe_spec(64, port_cfg(m), activation, "bfloat16")) \
        == shapes(jffn.moe_spec(64, m, activation, "bfloat16"))


# ------------------------------------------------------ the whole slice

B, S, GEN = 2, 32, 8


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_setup(request):
    arch = request.param
    jcfg = tiny_cfg(arch, num_layers=MOE_LAYERS[arch], dtype="float32")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = convert.params_from_numpy(port_cfg(jcfg), np_params, "cpu")
    tokens = np.random.default_rng(21).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, params, tokens


def test_stages_follow_the_reference(moe_setup):
    from repro.models import blocks as jblk
    jcfg = moe_setup[0]
    assert pblk.build_stages(port_cfg(jcfg)) == tuple(
        pblk.StageDescr(st.n_units, tuple(
            pblk.LayerDescr(**dataclasses.asdict(d)) for d in st.unit))
        for st in jblk.build_stages(jcfg))


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_slice_prefill_and_greedy_tokens_match_reference(moe_setup,
                                                             impl):
    jcfg, jparams, params, tokens = moe_setup
    kw = dict(chunk_q=16, chunk_kv=16, cache_len=S + GEN, remat=False,
              moe_impl=impl)
    ref_logits, ref_cache, ref_toks, ref_last = jax_greedy(
        jcfg, jparams, tokens, JaxRunOptions(**kw))
    first, toks, last = port_greedy(port_cfg(jcfg), params, tokens,
                                    plm.RunOptions(**kw))
    assert_prefill_matches(first, ref_logits, ref_cache, jcfg.vocab_size)
    np.testing.assert_array_equal(toks, ref_toks)
    V = jcfg.vocab_size
    assert_kernel_close(_f32(last)[:, :V], ref_last[:, :V], "float32")


def test_forward_hidden_sums_the_layers_aux_losses(moe_setup):
    jcfg, jparams, params, tokens = moe_setup
    opts = plm.RunOptions(chunk_q=16, chunk_kv=16, remat=False)
    _, aux, _ = plm.forward_hidden(port_cfg(jcfg), params,
                                   {"tokens": torch.from_numpy(tokens).long()},
                                   opts)
    _, jaux, _ = jlm.forward_hidden(
        jcfg, jparams, {"tokens": jnp.asarray(tokens)},
        JaxRunOptions(chunk_q=16, chunk_kv=16, remat=False))
    assert float(aux) > 0
    assert_kernel_close(aux.numpy(), np.asarray(jaux), "float32")
