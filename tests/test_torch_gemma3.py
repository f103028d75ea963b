"""The port's gemma3 path against the JAX package's (CPU, small sizes).

Reduced gemma3-12b: one 5:1 unit of local and global layers (6 layers,
d 128, 4/2 heads of 32, ``sliding_window`` 8, fp32) with the JAX
package's ``init_params`` converted through numpy.  The prompt (32) is
four windows long, so the window masks keys in the prefill and in every
decode step; the local and global layers use their own rope thetas,
and ``qk_norm``, GeGLU, the post-norms and the scaled, tied embeddings
all run.  Prefill logits and caches agree within the fp32 tolerance
(``conftest.KERNEL_TOLERANCES``, 1e-5 of the largest magnitude) and 8
greedy tokens are identical, with full-length caches and with
``windowed_cache`` ring buffers.

flash_attention at head dim 256 (gemma3's): the port's plain version
against the reference's Pallas kernel in interpret mode, and the CUDA
kernels (marked ``gpu``, skipped without a card) against the plain
version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_kernel_close
from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.models import lm as jlm
from repro.models.lm import RunOptions as JaxRunOptions
from repro_torch import convert
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import lm as plm
from test_torch_model import (_f32, _np, assert_prefill_matches,
                              jax_greedy, port_cfg, port_greedy)

B, S, GEN, WINDOW = 2, 32, 8, 8


def reduced_gemma3(window=WINDOW):
    """gemma3-12b cut to one pattern unit at small widths, fp32."""
    cfg = jax_get_config("gemma3-12b")
    return dataclasses.replace(
        cfg, num_layers=6, d_model=128, d_ff=256, vocab_size=512,
        vocab_pad_multiple=64, dtype="float32",
        attention=dataclasses.replace(cfg.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=32,
                                      sliding_window=window))


@pytest.fixture(scope="module")
def gemma_setup():
    jcfg = reduced_gemma3()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = convert.params_from_numpy(port_cfg(jcfg), np_params, "cpu")
    tokens = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jparams, params, tokens


def _opts(windowed):
    kw = dict(chunk_q=16, chunk_kv=16, cache_len=S + GEN, remat=False,
              windowed_cache=windowed)
    return JaxRunOptions(**kw), plm.RunOptions(**kw)


@pytest.fixture(scope="module", params=[False, True],
                ids=["full_cache", "windowed_cache"])
def gemma_runs(request, gemma_setup):
    jcfg, jparams, params, tokens = gemma_setup
    jopts, opts = _opts(request.param)
    return (jcfg, jax_greedy(jcfg, jparams, tokens, jopts),
            port_greedy(port_cfg(jcfg), params, tokens, opts))


def test_config_is_the_unit_of_five_local_and_one_global_layer():
    from repro_torch.models import blocks as pblk
    cfg = port_cfg(reduced_gemma3())
    (stage,) = pblk.build_stages(cfg)
    assert stage.n_units == 1
    assert [d.window for d in stage.unit] == [WINDOW] * 5 + [0]
    assert [d.theta for d in stage.unit] == [10_000.0] * 5 + [1_000_000.0]


def test_gemma3_prefill_matches_reference(gemma_runs):
    jcfg, (ref_logits, ref_cache, _, _), (first, _, _) = gemma_runs
    assert_prefill_matches(first, ref_logits, ref_cache, jcfg.vocab_size)


def test_gemma3_greedy_tokens_identical_to_reference(gemma_runs):
    jcfg, (_, _, ref_toks, ref_logits), (_, toks, logits) = gemma_runs
    np.testing.assert_array_equal(toks, ref_toks)
    V = jcfg.vocab_size
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")


def test_windowed_ring_cache_matches_full(gemma_setup):
    """The port of the reference's ``test_decode_equivalence.py::
    test_windowed_ring_cache_matches_full``: local layers keep an
    O(window) ring buffer and decode still reproduces the full forward;
    here also the reference's own windowed decode, within fp32."""
    jcfg, jparams, params, _ = gemma_setup
    cfg = port_cfg(jcfg)
    extra = 10
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, S + extra)).astype(np.int32)
    full = plm.RunOptions(chunk_q=0, chunk_kv=0, remat=False)
    x, _, _ = plm.forward_hidden(cfg, params,
                                 {"tokens": torch.from_numpy(toks).long()},
                                 full)
    want = plm.compute_logits(cfg, params, x[:, -1])
    jopts, opts = (o(chunk_q=0, chunk_kv=0, cache_len=S + extra,
                     remat=False, windowed_cache=True)
                   for o in (JaxRunOptions, plm.RunOptions))
    lg, cache = plm.prefill(cfg, params,
                            {"tokens": torch.from_numpy(toks[:, :S]).long()},
                            opts)
    assert cache["stage0"]["pos0"]["k"].shape[2] == WINDOW   # ring
    assert cache["stage0"]["pos5"]["k"].shape[2] == S + extra  # global
    jlg, jcache = jlm.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(toks[:, :S])}, jopts)
    for t in range(extra):
        lg, cache = plm.decode_step(cfg, params, cache,
                                    torch.from_numpy(toks[:, S + t]).long(),
                                    S + t, opts)
        jlg, jcache = jlm.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(toks[:, S + t]), S + t,
                                      jopts)
    V = cfg.vocab_size
    assert_kernel_close(_f32(lg)[:, :V], _f32(want)[:, :V], "float32")
    assert_kernel_close(_f32(lg)[:, :V], _f32(jlg)[:, :V], "float32")


# ---------------------------------------------- flash_attention, D = 256

FLASH_D256 = [(window, dtype) for window in (0, 32)
              for dtype in ("float32", "bfloat16")]


def _flash_inputs(dtype, seed=256, S=128, H=2, KV=1, D=256):
    rng = np.random.default_rng(seed)
    return tuple(_np(rng.standard_normal((1, S, n, D), np.float32), dtype)
                 for n in (H, KV, KV))


@pytest.mark.parametrize("window,dtype", FLASH_D256)
def test_plain_flash_d256_matches_pallas(window, dtype):
    q, k, v = _flash_inputs(dtype)
    got = fa_ops.attention(*(tensor_from_numpy(t) for t in (q, k, v)),
                           causal=True, window=window)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window, interpret=True)
    assert_kernel_close(_f32(got), _f32(want), dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run chip_smoke.py there")
    from repro_torch.compat import resolve_device
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("window,dtype", FLASH_D256)
def test_cuda_flash_d256_launches_its_path_and_matches_plain(
        cuda_device, window, dtype):
    from repro_torch.kernels.tolerance import check
    q, k, v = (tensor_from_numpy(t, cuda_device)
               for t in _flash_inputs(dtype))
    before = dict(fa_ops.attention.paths)
    got = fa_ops.attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    path = "tensor_core" if dtype == "bfloat16" else "fma"
    assert fa_ops.attention.paths[path] == before[path] + 1
    want = fa_ops.attention_plain(q, k, v, causal=True, window=window)
    assert check(got, want, q.dtype)[0] < 1
