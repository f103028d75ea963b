"""The port's encoder-decoder (whisper-base) path against the JAX
package's (CPU, small sizes).

Reduced whisper-base (``conftest.tiny_cfg`` at ``TINY_LAYERS`` = 2
decoder layers and 2 encoder layers; d 128, 4/2 heads of 32, cross K/V
length 32, fp32) with the JAX package's ``init_params`` converted
through numpy, the attention blocks' ``wq``/``wk`` scaled to the fan-in
of their d inputs.  The reference's init rule takes the head count (4)
as their fan-in, which makes the encoder's scores' spread ~45: the
unmasked softmax is then one-hot up to near ties, and at that scale the
two packages' encoder outputs differ by 1.0e-4 of their largest value,
each 4-6e-5 from the port run in float64; at the fan-in scale they agree
within the policy.  The vocabulary is cut to 500, which pads to 512, so
the padded-vocab mask runs in every logits call, as whisper's 51,865 pad
to 51,968.  Frames of the config's ``cross_kv_len`` (32) feed the
encoder, so the prefill cache's cross K/V have exactly the shape
``cache_spec`` gives them.  Under the fp32 policy
(``conftest.KERNEL_TOLERANCES``, 1e-5 of the largest magnitude):
``cross_kv``/``cross_attention``, ``_encode``, prefill logits and every
cache leaf (self and cross K/V), 8 greedy tokens identical through
``decode_step``, and, with frames longer and shorter than the prompt,
the prefill logits and greedy tokens.

Config, parameter spec and cache spec equal the reference's, at full
size too (130,826,240 parameters, counted from the spec).  The serve
feeds frames of the prompt's length, as the reference's does; a forced
deadline shed slices the cross K/V on their batch axis.  The serving
tuner counts 8 decode products a layer (the cross k/v are prefill-only)
and tunes a reduced whisper on the CPU.
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_LAYERS, assert_kernel_close, tiny_cfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.lm import RunOptions as JaxRunOptions
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve
from repro_torch.launch import tune as tune_cli
from repro_torch.models import attention as pattn
from repro_torch.models import blocks as pblk
from repro_torch.models import lm as plm
from repro_torch.models.spec import tree_items
from repro_torch.tuning.model import decode_products
from test_torch_model import (_f32, _np, _t, assert_prefill_matches,
                              jax_greedy, port_cfg, port_greedy)
from test_torch_zamba2 import _spec_items

ARCH = "whisper-base"
B, S, GEN = 2, 24, 8
V = 500                      # pads to 512: the masked tail runs
PARAMS = 130_826_240


def _opts(cls=plm.RunOptions):
    return cls(chunk_q=8, chunk_kv=8, cache_len=S + GEN, remat=False)


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = tiny_cfg(ARCH, num_layers=TINY_LAYERS[ARCH], dtype="float32",
                    vocab_size=V)
    cfg = port_cfg(jcfg)
    np_params = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    a = cfg.attention
    for blk in (np_params["encoder"]["stack"]["pos0"]["attn"],
                np_params["stage0"]["pos0"]["self"],
                np_params["stage0"]["pos0"]["cross"]):
        for name in ("wq", "wk"):
            blk[name] = (blk[name] * np.sqrt(a.num_heads / cfg.d_model)
                         ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.params_from_numpy(cfg, np_params, "cpu")
    rng = np.random.default_rng(19)
    tokens = rng.integers(0, V, (B, S + GEN)).astype(np.int32)
    T = cfg.encdec.cross_kv_len
    frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jparams, params, tokens, frames


def _frames(rng, T, d=128):
    return rng.standard_normal((B, T, d)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run(slice_setup):
    jcfg, _, jparams, _, tokens, frames = slice_setup
    return jax_greedy(jcfg, jparams, tokens[:, :S], _opts(JaxRunOptions),
                      extra={"frames": frames})


@pytest.fixture(scope="module")
def port_run(slice_setup):
    _, cfg, _, params, tokens, frames = slice_setup
    return port_greedy(cfg, params, tokens[:, :S], _opts(),
                       extra={"frames": frames})


def _prefill(cfg, params, tokens, frames):
    return plm.prefill(cfg, params,
                       {"tokens": torch.from_numpy(tokens).long(),
                        "frames": torch.from_numpy(frames)}, _opts())


# --------------------------------------------------------------- config

def test_config_copy_and_param_count_match_reference():
    ref = jax_get_config(ARCH)
    cfg = get_config(ARCH)
    assert port_cfg(ref) == cfg
    assert (cfg.encdec.encoder_layers, cfg.encdec.cross_kv_len,
            cfg.frontend.kind) == (6, 1536, "frames")
    assert (cfg.vocab_size, cfg.padded_vocab) == (51_865, 51_968)
    assert plm.param_count(cfg) == jlm.param_count(ref) == PARAMS


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b",
                                  "deepseek-67b", "qwen2-72b"])
def test_reduce_config_matches_reference(arch):
    """The launchers' shrink (whisper's encoder branch: 2 encoder
    layers, its cross K/V length kept) equals the reference's."""
    kw = dict(layers=2, d_model=128, vocab=500)
    got = reduce_config(get_config(arch), **kw)
    assert got == port_cfg(jax_reduce_config(jax_get_config(arch), **kw))
    if got.encdec:
        assert (got.encdec.encoder_layers, got.encdec.cross_kv_len) \
            == (2, 1536)


@pytest.mark.parametrize("layers", [0, 2], ids=["full", "2 layers"])
def test_model_and_cache_specs_match_reference(layers):
    ref = (jax_get_config(ARCH) if not layers
           else tiny_cfg(ARCH, num_layers=layers))
    cfg = port_cfg(ref)
    assert _spec_items(plm.model_spec(cfg), True) == \
        _spec_items(jlm.model_spec(ref), False)
    assert _spec_items(plm.cache_spec(cfg, 2, 40), True) == \
        _spec_items(jlm.cache_spec(ref, 2, 40), False)


def test_stages_are_the_decoder_and_the_unmasked_encoder():
    cfg = get_config(ARCH)
    (dec,) = pblk.build_stages(cfg)
    assert dec.n_units == 6 and dec.unit == (
        pblk.LayerDescr("dec_attn", theta=0.0),)
    enc = pblk.encoder_stage(cfg)
    assert enc.n_units == 6 and enc.unit == (
        pblk.LayerDescr("enc_attn", theta=0.0, causal=False),)
    spec = plm.model_spec(cfg)
    assert spec["encoder"]["pos"].shape == spec["dec_pos"].shape \
        == (plm.MAX_POS_TABLE, 512)
    assert set(spec["stage0"]["pos0"]) == {"ln_self", "self", "ln_cross",
                                           "cross", "ln_ffn", "ffn"}


# ------------------------------------------------------------ functions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,T", [(24, 32), (40, 16), (1, 32)],
                         ids=["Sq<T", "Sq>T", "one query"])
def test_cross_kv_and_cross_attention_match_reference(slice_setup, dtype,
                                                      Sq, T):
    """Memory K/V and unmasked cross-attention with Sq != Sk; the port's
    decode form (``decode=True``) and its prefill form agree with the
    reference's one form."""
    jcfg, cfg, _, params, _, _ = slice_setup
    rng = np.random.default_rng(Sq + T)
    jp = jax.tree.map(lambda a: jnp.asarray(_np(a[0], dtype)),
                      jlm.init_params(jcfg, jax.random.PRNGKey(3))
                      ["stage0"]["pos0"]["cross"])
    pp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    x = _np(rng.standard_normal((B, Sq, 128)), dtype)
    mem = _np(rng.standard_normal((B, T, 128)), dtype)
    jk, jv = jattn.cross_kv(jp, jnp.asarray(mem), jcfg.attention)
    pk, pv = pattn.cross_kv(pp, _t(mem), cfg.attention)
    assert tuple(pk.shape) == (B, T, 2, 32)
    assert_kernel_close(_f32(pk), _f32(jk), dtype)
    assert_kernel_close(_f32(pv), _f32(jv), dtype)
    want = jattn.cross_attention(jp, jnp.asarray(x), jk, jv,
                                 jcfg.attention)
    for decode in (False, True):
        got = pattn.cross_attention(pp, _t(x), pk, pv, cfg.attention,
                                    decode=decode)
        assert got.dtype == _t(x).dtype
        assert_kernel_close(_f32(got), _f32(want), dtype)


def test_encode_matches_reference(slice_setup):
    jcfg, cfg, jparams, params, _, frames = slice_setup
    want = jlm._encode(jcfg, jparams, jnp.asarray(frames),
                       _opts(JaxRunOptions))
    got = plm._encode(cfg, params, torch.from_numpy(frames), _opts())
    assert tuple(got.shape) == frames.shape
    assert_kernel_close(_f32(got), _f32(want), "float32")


def test_padded_vocab_is_masked_as_the_reference_masks_it(slice_setup):
    """Logits past the vocabulary are exactly -1e30 on both sides; the
    rest agree under the fp32 policy."""
    jcfg, cfg, jparams, params, _, _ = slice_setup
    assert (cfg.vocab_size, cfg.padded_vocab) == (V, 512)
    x = np.random.default_rng(5).standard_normal((B, 128)).astype(
        np.float32)
    want = np.asarray(jlm.compute_logits(jcfg, jparams, jnp.asarray(x)))
    got = plm.compute_logits(cfg, params, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:, V:], want[:, V:])
    assert np.all(got[:, V:] == np.float32(-1e30))
    assert_kernel_close(got[:, :V], want[:, :V], "float32")


# ------------------------------------------------------ the whole slice

def test_prefill_logits_and_every_cache_leaf_match_reference(
        slice_setup, jax_run, port_run):
    ref_logits, ref_cache, _, _ = jax_run
    assert_prefill_matches(port_run[0], ref_logits, ref_cache, V)
    leaves = {path.rsplit("/", 1)[-1]: leaf
              for path, leaf in port_run[0][1].items()}
    assert set(leaves) == {"k", "v", "ck", "cv"}
    assert tuple(leaves["ck"].shape) == (2, B, 32, 2, 32)
    assert tuple(leaves["k"].shape) == (2, B, S + GEN, 2, 32)


def test_greedy_tokens_identical_to_reference(jax_run, port_run):
    _, _, ref_toks, ref_logits = jax_run
    _, toks, logits = port_run
    np.testing.assert_array_equal(toks, ref_toks)
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")


@pytest.mark.parametrize("T", [48, 16], ids=["T>S", "T<S"])
def test_frames_of_another_length_than_the_prompt(slice_setup, T):
    """Encoder memory longer and shorter than the decoder's prompt:
    prefill logits and 8 greedy tokens (the caches' cross K/V are T
    long, not ``cross_kv_len``, in both packages)."""
    jcfg, cfg, jparams, params, tokens, _ = slice_setup
    frames = _frames(np.random.default_rng(T), T)
    ref_logits, ref_cache, ref_toks, _ = jax_greedy(
        jcfg, jparams, tokens[:, :S], _opts(JaxRunOptions),
        extra={"frames": frames})
    (logits, cache), toks, _ = port_greedy(
        cfg, params, tokens[:, :S], _opts(), extra={"frames": frames})
    assert_kernel_close(_f32(logits)[:, :V], ref_logits[:, :V], "float32")
    np.testing.assert_array_equal(toks, ref_toks)
    assert cache["stage0/pos0/ck"].shape[2] == T


def test_decode_after_prefill_matches_full_forward(slice_setup):
    """The reference's ``test_decode_equivalence.py`` case on the port:
    decode over the carried self K/V and the cached cross K/V, with the
    decoder positions looked up at each step, reproduces the full
    forward's logits (fp32, 1e-5)."""
    _, cfg, _, params, tokens, frames = slice_setup
    toks = torch.from_numpy(tokens).long()
    fr = torch.from_numpy(frames)
    x, _, _ = plm.forward_hidden(cfg, params, {"tokens": toks,
                                               "frames": fr}, _opts())
    want = plm.compute_logits(cfg, params, x[:, -1])
    logits, cache = _prefill(cfg, params, tokens[:, :S], frames)
    for t in range(GEN):
        logits, cache = plm.decode_step(cfg, params, cache, toks[:, S + t],
                                        S + t, _opts())
    assert_kernel_close(_f32(logits)[:, :V], _f32(want)[:, :V], "float32")


def test_decode_with_tensor_position_matches_int(slice_setup):
    """``pos`` as a 0-d device tensor (what a captured graph replays)
    gives the int position's step bit for bit: the decoder position is
    a gather at ``pos``, not a host read."""
    _, cfg, _, params, tokens, frames = slice_setup
    tok = torch.from_numpy(tokens[:, S]).long()
    runs = []
    for pos in (S, torch.tensor(S)):
        _, cache = _prefill(cfg, params, tokens[:, :S], frames)
        runs.append(plm.decode_step(cfg, params, cache, tok, pos, _opts()))
    assert torch.equal(runs[0][0], runs[1][0])
    for (path, a), (_, b) in zip(tree_items(runs[0][1]),
                                 tree_items(runs[1][1])):
        assert torch.equal(a, b), path
    # another position reads another table row
    _, cache = _prefill(cfg, params, tokens[:, :S], frames)
    other, _ = plm.decode_step(cfg, params, cache, tok,
                               torch.tensor(S + 1), _opts())
    assert not torch.equal(other, runs[0][0])


def test_decode_step_writes_self_kv_in_place_and_reads_cross_kv(
        slice_setup):
    _, cfg, _, params, tokens, frames = slice_setup
    _, cache = _prefill(cfg, params, tokens[:, :S], frames)
    before = {k: v.clone() for k, v in tree_items(cache)}
    ptrs = {k: v.data_ptr() for k, v in tree_items(cache)}
    _, out = plm.decode_step(cfg, params, cache,
                             torch.from_numpy(tokens[:, S]).long(), S,
                             _opts())
    assert out is cache
    for path, leaf in tree_items(out):
        assert leaf.data_ptr() == ptrs[path], path
        changed = not torch.equal(leaf, before[path])
        assert changed == path.endswith(("/k", "/v")), path
        if changed:     # only the row at S
            diff = (leaf != before[path]).any(dim=(0, 1, 3, 4))
            assert diff.nonzero().flatten().tolist() == [S], path


def test_converted_cache_round_trips(slice_setup, jax_run):
    _, cfg, *_ = slice_setup
    _, ref_cache, _, _ = jax_run
    cache = convert.cache_from_numpy(cfg, ref_cache, B, S + GEN, "cpu")
    for (_, got), (_, want) in zip(tree_items(cache),
                                   tree_items(ref_cache)):
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- serve

SERVE = ["--arch", ARCH, "--device", "cpu", "--dtype", "float32",
         "--prompt-len", "32", "--gen", "6"]


def test_serve_feeds_frames_of_the_prompt_length():
    """``setup`` draws ``frames`` [B, P, d_model] fp32 normals from the
    prompt's generator after the tokens, as the reference's serve."""
    args = serve.build_parser().parse_args(SERVE)
    cfg, *_, batch = serve.setup(args, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    frames = torch.randn((4, 32, 128), generator=gen)
    assert set(batch) == {"tokens", "targets", "frames"}
    assert torch.equal(batch["tokens"], tokens)
    assert batch["frames"].dtype == torch.float32
    assert torch.equal(batch["frames"], frames)


def test_reduced_serve_and_a_forced_shed_on_cpu(capsys):
    """The reduced whisper through ``serve.main``: it ends, and under a
    1e-6 ms deadline the ladder sheds the batch 4 -> 2 after four
    overruns; the shed cache's rows (self and cross K/V sliced on their
    batch axis) go on giving the unshed serve's tokens."""
    full = serve.main(SERVE + ["--deadline-ms", "10000"])
    shed = serve.main(SERVE + ["--deadline-ms", "1e-6"])
    out = capsys.readouterr().out
    assert f"{ARCH} 2L d_model=128" in out
    assert "shedding batch 4 -> 2 at decode step 3" in out
    assert [t.shape[0] for t in full["tokens"]] == [4] * 6
    assert [t.shape[0] for t in shed["tokens"]] == [4] * 4 + [2] * 2
    assert shed["deadline"]["n_shed"] == 1
    for a, b in zip(full["tokens"], shed["tokens"]):
        np.testing.assert_array_equal(a[:b.shape[0]], b)


def test_shed_batch_slices_cross_kv_on_the_batch_axis(slice_setup):
    _, cfg, _, params, tokens, frames = slice_setup
    _, cache = _prefill(cfg, params, tokens[:, :S], frames)
    tok = torch.arange(B)
    shed, _ = serve.shed_batch(cfg, cache, tok, 1, S + GEN)
    for (path, old), (_, new) in zip(tree_items(cache), tree_items(shed)):
        assert new.shape == (old.shape[0], 1) + old.shape[2:], path
        assert new.data_ptr() == old.data_ptr()
        assert torch.equal(new, old[:, :1])
    assert {p.rsplit("/", 1)[-1] for p, _ in tree_items(shed)} \
        == {"k", "v", "ck", "cv"}


# --------------------------------------------------------------- tuning

def test_decode_products_count_the_spec():
    """At batch 4, counted from ``lm.model_spec``: per decoder layer the
    self wq/wk/wv/wo, the cross wq and wo (the cross wk/wv project the
    encoder memory once, at prefill) and the ungated GELU FFN's two; then
    the transposed-B logits over the padded table.  49 launches a step."""
    cfg = get_config(ARCH)
    spec = plm.model_spec(cfg)["stage0"]["pos0"]
    want = Counter()
    for part, names in (("self", ("wq", "wk", "wv")), ("cross", ("wq",))):
        for name in names:
            units, k, heads, hd = spec[part][name].shape
            want[(k, heads * hd)] += units
    for part in ("self", "cross"):
        units, heads, hd, n = spec[part]["wo"].shape
        want[(heads * hd, n)] += units
    assert set(spec["ffn"]) == {"w_gate", "w_down"}
    for par in spec["ffn"].values():
        units, k, n = par.shape
        want[(k, n)] += units
    prods = decode_products(cfg, 4)
    assert {(k, n): c for m, k, n, tb, c in prods if not tb} == dict(want)
    assert [p for p in prods if p[3]] == [(4, 512, 51_968, True, 1)]
    assert sum(c for *_, c in prods) == 8 * 6 + 1


def test_tune_cli_tunes_a_reduced_whisper_on_the_cpu(tmp_path,
                                                     monkeypatch, capsys):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    from repro_torch import tuning
    tuning.reset()
    try:
        argv = ["--device", "cpu", "--model", ARCH, "--shape", "2x16x2",
                "--dtype", "float32", "--reps", "1", "--max-candidates",
                "2"]
        out = tune_cli.run(argv)
        assert out["spans"] > 0 and out["results"][0].source == "measured"
        assert tune_cli.run(argv)["spans"] == 0
    finally:
        tuning.reset()
    assert f"model {ARCH}" in capsys.readouterr().out


# ----------------------------------------------------- on the card only

@pytest.mark.gpu
def test_captured_prefill_copies_frames_in(slice_setup):
    """Reduced whisper in fp32 on the card: the captured prefill reads
    the frames of each call (``compile_step_fns`` copies every batch
    entry into its static buffers), so new frames give the eager
    prefill's logits on those frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run chip_smoke.py there")
    from repro_torch.compat import resolve_device
    from repro_torch.models.spec import tree_map
    dev = resolve_device("cuda")
    _, cfg, _, params, tokens, frames = slice_setup
    params = tree_map(lambda t: t.to(dev), params)
    batch = {"tokens": torch.from_numpy(tokens[:, :S]).long().to(dev),
             "frames": torch.from_numpy(frames).to(dev)}
    prefill_fn, _ = serve.compile_step_fns(cfg, params, batch, _opts(), S)
    other = dict(batch, frames=torch.from_numpy(
        _frames(np.random.default_rng(7), frames.shape[1])).to(dev))
    for b in (other, batch):
        got, _ = prefill_fn(b)
        want, _ = plm.prefill(cfg, params, b, _opts())
        assert torch.equal(got, want)
    assert not torch.equal(prefill_fn(other)[0].clone(),
                           prefill_fn(batch)[0])


@pytest.mark.gpu
def test_cross_attention_launches_flash_only_for_the_prefill_call(
        slice_setup):
    """On the card the prefill call (Sq 24 against Sk 32) launches one
    flash_attention and holds to the CPU's sdpa; the decode call
    (``decode=True``) launches none, whatever its shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run chip_smoke.py there")
    from repro_torch.compat import resolve_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    dev = resolve_device("cuda")
    _, cfg, _, params, _, _ = slice_setup
    p = {k: v[0] for k, v in params["stage0"]["pos0"]["cross"].items()}
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_frames(rng, S))
    mem = torch.from_numpy(_frames(rng, 32))
    k, v = pattn.cross_kv(p, mem, cfg.attention)
    want = pattn.cross_attention(p, x, k, v, cfg.attention)
    pd = {n: w.to(dev) for n, w in p.items()}
    args = (x.to(dev), k.to(dev), v.to(dev), cfg.attention)
    before = fa_ops.attention.launches
    got = pattn.cross_attention(pd, *args)
    assert fa_ops.attention.launches == before + 1
    assert_kernel_close(_f32(got.cpu()), _f32(want), "float32", tol=1e-4)
    pattn.cross_attention(pd, *args, decode=True)
    assert fa_ops.attention.launches == before + 1
