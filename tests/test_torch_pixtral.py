"""The port's VLM stub (pixtral-12b) against the JAX package's (CPU,
small sizes).

pixtral-12b is the dense decoder (40 layers, d 5120, 32/8 heads of 128,
SwiGLU 14,336, rope theta 1e9, vocab 131,072) behind a ViT frontend that
is a stub in both packages: precomputed patch embeddings replace the
token embeddings at the first positions of the prompt (the reference's
``dynamic_update_slice`` at (0, 0, 0); at most the config's
``num_positions``, 1024).  Reduced pixtral-12b (``conftest.tiny_cfg`` at
``TINY_LAYERS`` = 2; d 128, 4/2 heads of 32, fp32) with the JAX
package's ``init_params`` converted through numpy, ``wq``/``wk`` scaled
to the fan-in of their d inputs.  The reference's init rule takes the
head count (4) as their fan-in; at that scale the softmax is near
one-hot, and with rope theta 1e9 the prefill logits of the two
packages differ by 1.7e-5 of the largest logit, the reference's 2.5e-5
from the port run in float64 and the port's 7.9e-6; at the fan-in
scale they agree to 8.7e-7.  Then: the embedding with
and without patches, then prefill logits, every cache leaf and 8 greedy
tokens with and without patch embeddings over the first 8 positions,
under the fp32 policy (``conftest.KERNEL_TOLERANCES``, 1e-5 of the
largest magnitude).  Config, parameter spec and cache spec equal the
reference's, at full size too (12,247,782,400 parameters, counted from
the spec).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_LAYERS, assert_kernel_close, tiny_cfg
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.lm import RunOptions as JaxRunOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm as plm
from test_torch_model import (_f32, assert_prefill_matches, jax_greedy,
                              port_cfg, port_greedy)
from test_torch_zamba2 import _spec_items

ARCH = "pixtral-12b"
B, S, GEN, PATCHES = 2, 32, 8, 8
PARAMS = 12_247_782_400


def _opts(cls=plm.RunOptions):
    return cls(chunk_q=16, chunk_kv=16, cache_len=S + GEN, remat=False)


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = tiny_cfg(ARCH, num_layers=TINY_LAYERS[ARCH], dtype="float32")
    cfg = port_cfg(jcfg)
    np_params = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    attn = np_params["stage0"]["pos0"]["attn"]
    for name in ("wq", "wk"):
        attn[name] = (attn[name] * np.sqrt(cfg.attention.num_heads
                                           / cfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.params_from_numpy(cfg, np_params, "cpu")
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    # patch embeddings at the token embeddings' scale
    patches = (0.02 * rng.standard_normal((B, PATCHES, cfg.d_model))
               ).astype(np.float32)
    return jcfg, cfg, jparams, params, tokens, patches


def test_config_copy_and_param_count_match_reference():
    ref = jax_get_config(ARCH)
    cfg = get_config(ARCH)
    assert port_cfg(ref) == cfg
    assert (cfg.family, cfg.frontend.kind, cfg.frontend.num_positions) \
        == ("vlm", "patches", 1024)
    assert (cfg.attention.head_dim, cfg.attention.rope_theta) == (128, 1e9)
    assert plm.param_count(cfg) == jlm.param_count(ref) == PARAMS


@pytest.mark.parametrize("layers", [0, 2], ids=["full", "2 layers"])
def test_model_and_cache_specs_match_reference(layers):
    ref = (jax_get_config(ARCH) if not layers
           else tiny_cfg(ARCH, num_layers=layers))
    cfg = port_cfg(ref)
    assert _spec_items(plm.model_spec(cfg), True) == \
        _spec_items(jlm.model_spec(ref), False)
    assert _spec_items(plm.cache_spec(cfg, 2, 40), True) == \
        _spec_items(jlm.cache_spec(ref, 2, 40), False)


@pytest.mark.parametrize("with_patches", [False, True],
                         ids=["tokens", "patches"])
def test_embedding_matches_reference(slice_setup, with_patches):
    """Patch embeddings replace the first positions' token embeddings,
    exactly; the rest are the token embeddings."""
    jcfg, cfg, jparams, params, tokens, patches = slice_setup
    jb = {"tokens": jnp.asarray(tokens[:, :S])}
    pb = {"tokens": torch.from_numpy(tokens[:, :S]).long()}
    if with_patches:
        jb["patch_embeds"] = jnp.asarray(patches)
        pb["patch_embeds"] = torch.from_numpy(patches)
    want = np.asarray(jlm._embed(jcfg, jparams, jb["tokens"], jb))
    got = plm._embed(cfg, params, pb["tokens"], pb).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:, :PATCHES] == patches, np.full(patches.shape, with_patches))


@pytest.mark.parametrize("with_patches", [False, True],
                         ids=["tokens", "patches"])
def test_prefill_and_greedy_tokens_match_reference(slice_setup,
                                                   with_patches):
    jcfg, cfg, jparams, params, tokens, patches = slice_setup
    extra = {"patch_embeds": patches} if with_patches else None
    ref_logits, ref_cache, ref_toks, ref_last = jax_greedy(
        jcfg, jparams, tokens[:, :S], _opts(JaxRunOptions), extra=extra)
    first, toks, last = port_greedy(cfg, params, tokens[:, :S], _opts(),
                                    extra=extra)
    V = jcfg.vocab_size
    assert_prefill_matches(first, ref_logits, ref_cache, V)
    np.testing.assert_array_equal(toks, ref_toks)
    assert_kernel_close(_f32(last)[:, :V], ref_last[:, :V], "float32")


def test_patches_change_the_prefill(slice_setup):
    _, cfg, _, params, tokens, patches = slice_setup
    toks = torch.from_numpy(tokens[:, :S]).long()
    plain, _ = plm.prefill(cfg, params, {"tokens": toks}, _opts())
    vlm, _ = plm.prefill(cfg, params, {
        "tokens": toks, "patch_embeds": torch.from_numpy(patches)}, _opts())
    assert not torch.equal(plain, vlm)


def test_reduced_serve_on_cpu(capsys):
    """The reduced pixtral through ``launch.serve.main``: the reference's
    serve feeds no patches, so the dense path serves."""
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--dtype",
                      "float32", "--prompt-len", "32", "--gen", "4",
                      "--deadline-ms", "10000"])
    assert f"{ARCH} 2L d_model=128" in capsys.readouterr().out
    toks = np.stack(res["tokens"], 1)
    assert toks.shape == (4, 4) and ((toks >= 0) & (toks < 512)).all()
