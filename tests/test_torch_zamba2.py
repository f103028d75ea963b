"""The port's zamba2 (hybrid) path against the JAX package's (CPU, small
sizes).

Reduced zamba2-7b (``conftest.tiny_cfg`` at ``TINY_LAYERS`` = 15
layers: two units of [shared attention + mamba, mamba x5], so both tied
blocks run, and a tail of three mamba layers; d 128, 4/4 heads of 64,
chunk 16, fp32) with the JAX package's ``init_params`` converted
through numpy, the convolution biases, decay biases and skips made
non-trivial, and the tied blocks' ``wq``/``wk`` scaled to the fan-in of
their 2 x d inputs.  The reference's init rule takes the head count (4)
as their fan-in, which makes the scores' spread ~60: the softmax is
then one-hot up to near ties, and the SSM layers' decays multiply what
fp32 rounding leaves there.  At that scale the two packages' caches
differ by up to 1e-4 of their largest values, and each differs by up
to 5e-5 from the port run in float64 (its norms and rope stay fp32);
at the fan-in scale they agree to ~1e-6.  The prompt (32) is two chunks long, so the inter-chunk state
carry runs.  Prefill logits and every cache leaf (conv, SSM and
the shared blocks' K/V) agree within the fp32 tolerance
(``conftest.KERNEL_TOLERANCES``, 1e-5 of the largest magnitude), and 8
greedy tokens are identical.  The 2-layer cut (a stage of no units and
a tail of two layers) agrees too.

Config, parameter spec and cache spec equal the reference's, at full
size too (6,930,975,952 parameters, counted from the spec).  flash at
zamba2's head dim 112 is in ``test_torch_kernels.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_LAYERS, assert_kernel_close, tiny_cfg
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.lm import RunOptions as JaxRunOptions
from repro.models.spec import is_par
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import blocks as pblk
from repro_torch.models import lm as plm
from repro_torch.models.spec import tree_from_items, tree_items
from test_torch_model import (_f32, assert_prefill_matches, jax_greedy,
                              port_cfg, port_greedy)

ARCH = "zamba2-7b"
B, S, GEN = 2, 32, 8
PARAMS = 6_930_975_952


def _opts(cls=plm.RunOptions):
    return cls(chunk_q=16, chunk_kv=16, cache_len=S + GEN, remat=False)


def _setup(layers):
    jcfg = tiny_cfg(ARCH, num_layers=layers, dtype="float32")
    cfg = port_cfg(jcfg)
    np_params = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(18)
    a = cfg.attention
    for name in ("wq", "wk"):
        np_params["shared"]["attn"][name] = (
            np_params["shared"]["attn"][name]
            * np.sqrt(a.num_heads / (2 * cfg.d_model))).astype(np.float32)
    for si in range(len(pblk.build_stages(cfg))):
        for pos in np_params[f"stage{si}"].values():
            m = pos["mamba"]
            for name, scale, mean in (("conv_b", 0.1, 0.0),
                                      ("dt_bias", 0.5, 0.0),
                                      ("D", 0.3, 1.0)):
                m[name] = (mean + scale * rng.standard_normal(
                    m[name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.params_from_numpy(cfg, np_params, "cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


@pytest.fixture(scope="module")
def slice_setup():
    return _setup(TINY_LAYERS[ARCH])


@pytest.fixture(scope="module")
def jax_run(slice_setup):
    jcfg, _, jparams, _, tokens = slice_setup
    return jax_greedy(jcfg, jparams, tokens[:, :S], _opts(JaxRunOptions))


@pytest.fixture(scope="module")
def port_run(slice_setup):
    _, cfg, _, params, tokens = slice_setup
    return port_greedy(cfg, params, tokens[:, :S], _opts())


# --------------------------------------------------------------- config

def _spec_items(tree, port):
    if port:
        return {k: (p.shape, p.axes, p.dtype) for k, p in tree_items(tree)}
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_par)[0]
    return {"/".join(k.key for k in path): (p.shape, p.axes, p.dtype)
            for path, p in leaves}


def test_config_copy_and_param_count_match_reference():
    ref = jax_get_config(ARCH)
    cfg = get_config(ARCH)
    assert port_cfg(ref) == cfg
    assert plm.param_count(cfg) == jlm.param_count(ref) == PARAMS


@pytest.mark.parametrize("layers", [0, 2, 15],
                         ids=["full", "2 layers", "15 layers"])
def test_model_and_cache_specs_match_reference(layers):
    ref = (jax_get_config(ARCH) if not layers
           else tiny_cfg(ARCH, num_layers=layers))
    cfg = port_cfg(ref)
    assert _spec_items(plm.model_spec(cfg), True) == \
        _spec_items(jlm.model_spec(ref), False)
    assert _spec_items(plm.cache_spec(cfg, 2, 40), True) == \
        _spec_items(jlm.cache_spec(ref, 2, 40), False)


def test_stages_are_the_units_and_the_tail():
    full = pblk.build_stages(get_config(ARCH))
    assert [st.n_units for st in full] == [13, 1]
    assert [d.shared_attn for d in full[0].unit] == [True] + [False] * 5
    assert len(full[1].unit) == 3 and not any(
        d.shared_attn for d in full[1].unit)
    two = pblk.build_stages(port_cfg(tiny_cfg(ARCH, num_layers=2)))
    assert [(st.n_units, len(st.unit)) for st in two] == [(0, 6), (1, 2)]


def test_shared_block_projects_concat_back_to_d_model():
    """The tied block's attention reads concat(x, x0): its projections
    are 2d -> heads x head_dim and back to d (at full size 7168 -> 32 x
    112 and 32 x 112 -> 3584)."""
    spec = plm.model_spec(get_config(ARCH))["shared"]
    assert spec["attn"]["wq"].shape == (2, 7168, 32, 112)
    assert spec["attn"]["wk"].shape == spec["attn"]["wv"].shape \
        == (2, 7168, 32, 112)
    assert spec["attn"]["wo"].shape == (2, 32, 112, 3584)
    assert spec["ln_in"].shape == (2, 7168)


# ------------------------------------------------------ the whole slice

def test_prefill_matches_reference(slice_setup, jax_run, port_run):
    jcfg = slice_setup[0]
    ref_logits, ref_cache, _, _ = jax_run
    assert_prefill_matches(port_run[0], ref_logits, ref_cache,
                           jcfg.vocab_size)


def test_greedy_tokens_identical_to_reference(slice_setup, jax_run,
                                              port_run):
    V = slice_setup[0].vocab_size
    _, _, ref_toks, ref_logits = jax_run
    _, toks, logits = port_run
    np.testing.assert_array_equal(toks, ref_toks)
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")


def test_decode_after_prefill_matches_full_forward(slice_setup):
    """The reference's ``test_decode_equivalence.py`` case on the port:
    decode with the carried conv, SSM and shared K/V state reproduces
    the full forward's logits (fp32, 1e-5)."""
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


def test_converted_cache_round_trips(slice_setup, jax_run):
    _, cfg, *_ = slice_setup
    _, ref_cache, _, _ = jax_run
    cache = convert.cache_from_numpy(cfg, ref_cache, B, S + GEN, "cpu")
    for (_, got), (_, want) in zip(tree_items(cache),
                                   tree_items(ref_cache)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_decode_step_updates_the_state_in_place(slice_setup):
    """conv, ssm, shared_k and shared_v: the returned cache is the
    input's buffers, holding the new state; a second step reads the
    first step's state from them."""
    _, cfg, _, params, tokens = slice_setup
    toks = torch.from_numpy(tokens).long()
    _, cache = plm.prefill(cfg, params, {"tokens": toks[:, :S]}, _opts())
    before = {k: v.clone() for k, v in tree_items(cache)}
    ptrs = {k: v.data_ptr() for k, v in tree_items(cache)}
    _, out = plm.decode_step(cfg, params, cache, toks[:, S], S, _opts())
    assert out is cache
    names = set()
    for path, leaf in tree_items(out):
        assert leaf.data_ptr() == ptrs[path], path
        assert not torch.equal(leaf, before[path]), path
        names.add(path.rsplit("/", 1)[-1])
    assert names == {"conv", "ssm", "shared_k", "shared_v"}
    second, _ = plm.decode_step(cfg, params, cache, toks[:, S + 1], S + 1,
                                _opts())
    stale = tree_from_items(cache, before)
    wrong, _ = plm.decode_step(cfg, params, stale, toks[:, S + 1], S + 1,
                               _opts())
    assert not torch.equal(second, wrong)


def test_decode_scan_and_unrolled_views_are_identical(slice_setup):
    _, cfg, _, params, tokens = slice_setup
    runs = [port_greedy(cfg, params, tokens[:, :S],
                        dataclasses.replace(_opts(), decode_scan=scan))
            for scan in (True, False)]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])


def test_two_layers_a_stage_of_no_units_matches_reference():
    """``--layers 2``: stage0 holds no unit (its leaves lead with 0, as
    the reference's scan stacks them) and the tail two mamba layers."""
    jcfg, cfg, jparams, params, tokens = _setup(2)
    ref_logits, ref_cache, ref_toks, _ = jax_greedy(
        jcfg, jparams, tokens[:, :S], _opts(JaxRunOptions))
    (logits, cache), toks, _ = port_greedy(cfg, params, tokens[:, :S],
                                           _opts())
    ref_flat = dict(tree_items(ref_cache))
    assert set(cache) == set(ref_flat)
    for path, leaf in cache.items():
        assert tuple(leaf.shape) == ref_flat[path].shape, path
        if path.startswith("stage0/"):
            assert leaf.shape[0] == 0, path
        else:
            assert_kernel_close(_f32(leaf), ref_flat[path], "float32")
    V = jcfg.vocab_size
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")
    np.testing.assert_array_equal(toks, ref_toks)


def test_reduced_serve_on_cpu(capsys):
    """The 15-layer reduced zamba2 through ``launch.serve.main``: the
    shared blocks' prefill attention runs the flash wrapper (its plain
    version here) and decode carries every state."""
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--layers", "15",
                      "--dtype", "float32", "--prompt-len", "32",
                      "--gen", "4", "--deadline-ms", "10000"])
    out = capsys.readouterr().out
    assert f"{ARCH} 15L d_model=128" in out
    toks = np.stack(res["tokens"], 1)
    assert toks.shape == (4, 4)
    assert ((toks >= 0) & (toks < 512)).all()
