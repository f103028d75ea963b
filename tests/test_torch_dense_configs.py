"""The two large dense configs, deepseek-67b and qwen2-72b, in the port
against the JAX package (CPU).

Neither fits one card in bf16 (134.9 GB and 145.4 GB of weights), so
the port holds them at reduced size: ``conftest.tiny_cfg`` at 2 layers
(d 128, 4/2 heads of 32; qwen2-72b keeps its QKV biases), fp32, with
the JAX package's ``init_params`` converted through numpy.  Prefill
logits and every KV cache leaf within the fp32 policy
(``conftest.KERNEL_TOLERANCES``, 1e-5 of the largest magnitude), and 8
greedy tokens identical.  Config, parameter spec and cache spec equal
the reference's, at full width too: 67,425,001,472 and 72,706,203,648
parameters, counted from the spec with nothing allocated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import TINY_LAYERS, assert_kernel_close, tiny_cfg
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.lm import RunOptions as JaxRunOptions
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.all_archs import ALL_ARCH_IDS
from repro_torch.models import lm as plm
from test_torch_model import (_f32, assert_prefill_matches, jax_greedy,
                              port_cfg, port_greedy)
from test_torch_zamba2 import _spec_items

PARAMS = {"deepseek-67b": 67_425_001_472, "qwen2-72b": 72_706_203_648}
B, S, GEN = 2, 32, 8


def _opts(cls=plm.RunOptions):
    return cls(chunk_q=16, chunk_kv=16, cache_len=S + GEN, remat=False)


def test_every_reference_arch_is_registered():
    from repro.configs.all_archs import ALL_ARCH_IDS as REF_IDS
    assert ALL_ARCH_IDS == REF_IDS
    for arch in ALL_ARCH_IDS:
        assert port_cfg(jax_get_config(arch)) == get_config(arch)


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_param_count_from_the_spec_alone(arch):
    cfg = get_config(arch)
    assert plm.param_count(cfg) == jlm.param_count(jax_get_config(arch)) \
        == PARAMS[arch]


@pytest.mark.parametrize("arch", sorted(PARAMS))
@pytest.mark.parametrize("layers", [0, 2], ids=["full", "2 layers"])
def test_model_and_cache_specs_match_reference(arch, layers):
    ref = (jax_get_config(arch) if not layers
           else tiny_cfg(arch, num_layers=layers))
    cfg = port_cfg(ref)
    assert _spec_items(plm.model_spec(cfg), True) == \
        _spec_items(jlm.model_spec(ref), False)
    assert _spec_items(plm.cache_spec(cfg, 2, 40), True) == \
        _spec_items(jlm.cache_spec(ref, 2, 40), False)


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_reduced_prefill_and_greedy_tokens_match_reference(arch):
    jcfg = tiny_cfg(arch, num_layers=TINY_LAYERS[arch], dtype="float32")
    cfg = port_cfg(jcfg)
    np_params = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    if jcfg.attention.qkv_bias:     # make the biases count
        rng = np.random.default_rng(72)
        for name in ("bq", "bk", "bv"):
            b = np_params["stage0"]["pos0"]["attn"][name]
            np_params["stage0"]["pos0"]["attn"][name] = (
                0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.params_from_numpy(cfg, np_params, "cpu")
    tokens = np.random.default_rng(67).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ref_logits, ref_cache, ref_toks, ref_last = jax_greedy(
        jcfg, jparams, tokens, _opts(JaxRunOptions))
    first, toks, last = port_greedy(cfg, params, tokens, _opts())
    V = jcfg.vocab_size
    assert_prefill_matches(first, ref_logits, ref_cache, V)
    np.testing.assert_array_equal(toks, ref_toks)
    assert_kernel_close(_f32(last)[:, :V], ref_last[:, :V], "float32")
