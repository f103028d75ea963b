"""zamba2-7b-instruct, the published Zamba2-7B-Instruct, on the port's
serving path (CPU, fp32, small widths), held to the benchmark's plain
reference (``portbench/reference/hybrid.py``), and that reference held
to transformers' ``Zamba2ForCausalLM``.

The tiny model keeps every mechanism of the published one: two B/C
groups of Mamba heads (each group its own B, C and gated-norm slice),
irregular hybrid ids (a leading stage of Mamba layers alone, then
units of unequal lengths) that run both tied blocks in turn by hybrid
ordinal, each hybrid layer with its own adapter and ``linear``, RoPE
over the whole tied-block head and its (head_dim / 2)^-1/2 scale, eps
1e-5 and a tied head.  Its prompt is two SSD chunks long, so the port's
chunked scan carries state across a chunk boundary.

Tolerances: the port, the reference and transformers all compute in
fp32 and differ only in the order of their sums (the port's chunked SSD
against the reference's quadratic form, fused norms against written-out
ones), so their logits agree to 1e-5 of the largest; a wrong group, a
block chosen by unit index instead of ordinal, a missing adapter or a
residual inside the tied block moves them by 1e-2 or more.

Also: the full-size configuration from its spec alone, flash's plain
version and plan at head dim 224, and the benchmark's four new readers
on synthetic rows (the published hybrid's spans are in
``test_torch_stamps.py``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import counts, harness, program  # noqa: E402
from portbench.reference import hybrid as ref  # noqa: E402
from portbench.weights import Weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.all_archs import (ALL_ARCH_IDS,  # noqa: E402
                                           PORT_ONLY_ARCH_IDS)
from repro_torch.core import gpu_mapping  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.models.spec import tree_items  # noqa: E402

ARCH = "zamba2-7b-instruct"
PARAMS = 7_356_749_648
TOL = 1e-5
B, P, G = 2, 16, 5
# a small Zamba2: 9 layers with hybrids at 2, 4 and 7 (stages [m, m],
# 2 x [h, m], [h, m]: both tied blocks, ordinals 0..2), 2 groups of 2
# Mamba heads, a 4-head tied block over 2 x 32 inputs
TINY = {"num_hidden_layers": 9, "hidden_size": 32, "num_attention_heads": 4,
        "num_key_value_heads": 4, "attention_head_dim": 16,
        "intermediate_size": 48, "vocab_size": 128, "rope_theta": 10000,
        "rms_norm_eps": 1e-5, "mamba_d_state": 8, "mamba_headdim": 16,
        "mamba_expand": 2, "mamba_ngroups": 2, "mamba_d_conv": 4,
        "n_mamba_heads": 4, "chunk_size": 8,
        "hybrid_layer_ids": [2, 4, 7], "num_mem_blocks": 2,
        "adapter_rank": 4, "dtype": "float32"}


def tiny(seed: int = 3, **over):
    dm = ref.dims(dict(TINY, **over))
    cfg = program.program_config("hybrid", dm)
    program.check_layout(cfg, ref.layout(dm))
    w = Weights(ref.layout(dm), torch.device("cpu"))
    w.draw(seed)
    return dm, cfg, w


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# ------------------------------------------------------- the reference


def _transformers_model(dm, tree, chunk: int):
    """transformers' Zamba2ForCausalLM (its torch path) with the
    benchmark's weights, at SSD chunk ``chunk``."""
    os.environ.setdefault("USE_TF", "0")
    tf = pytest.importorskip("transformers")
    L = dm["layers"]
    hc = tf.Zamba2Config(
        vocab_size=dm["vocab"], hidden_size=dm["d"], num_hidden_layers=L,
        layers_block_type=["hybrid" if i in dm["hybrid"] else "mamba"
                           for i in range(L)],
        mamba_d_state=dm["state"], mamba_d_conv=dm["conv"],
        mamba_expand=dm["expand"], mamba_ngroups=dm["groups"],
        n_mamba_heads=dm["ssm_heads"], num_attention_heads=dm["heads"],
        num_key_value_heads=dm["kv_heads"], intermediate_size=dm["ff"],
        num_mem_blocks=dm["blocks"], use_mem_rope=True,
        rope_theta=dm["rope_theta"], rms_norm_eps=dm["eps"],
        adapter_rank=dm["adapter_rank"], chunk_size=chunk,
        use_shared_attention_adapter=False, hidden_act="gelu",
        pad_token_id=None)
    assert hc.attention_head_dim == dm["head_dim"] and hc.tie_word_embeddings
    m = tf.Zamba2ForCausalLM(hc).eval()
    # its torch path clamps dt below at time_step_min; the config's
    # time_step_limit is null, which the fused kernels (and the port)
    # read as no clamp
    for mod in m.modules():
        if hasattr(mod, "time_step_min"):
            mod.time_step_min = 0.0

    def put(dst, src):
        assert dst.shape == src.shape, (dst.shape, src.shape)
        dst.data.copy_(src)
    d = dm["d"]
    put(m.model.embed_tokens.weight, tree["embed"])
    put(m.model.final_layernorm.weight, tree["final_norm"])
    for i, (si, u, j, k) in enumerate(ref._layer_sites(dm)):
        p = ref._index(tree[f"stage{si}"][f"pos{j}"], u)
        layer = m.model.layers[i]
        mam = layer.mamba_decoder if k is not None else layer
        put(mam.input_layernorm.weight, p["ln"])
        mx, pm = mam.mamba, p["mamba"]
        put(mx.in_proj.weight, pm["in_proj"].t())
        put(mx.conv1d.weight, pm["conv_w"].t()[:, None, :])
        for name in ("A_log", "D", "dt_bias"):
            put(getattr(mx, name), pm[name])
        put(mx.conv1d.bias, pm["conv_b"])
        put(mx.norm.weight, pm["norm"])
        put(mx.out_proj.weight, pm["out_proj"].t())
        if k is None:
            continue
        put(layer.linear.weight, p["linear"].t())
        blk = layer.shared_transformer
        assert blk.block_id == k % dm["blocks"]
        b = ref._index(tree["shared"], blk.block_id)
        for name, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                           ("wv", "v_proj")):
            put(getattr(blk.self_attn, proj).weight,
                b["attn"][name].reshape(2 * d, -1).t())
        put(blk.self_attn.o_proj.weight, b["attn"]["wo"].reshape(-1, d).t())
        put(blk.input_layernorm.weight, b["ln_in"])
        put(blk.pre_ff_layernorm.weight, b["ln_ffn"])
        f = blk.feed_forward
        put(f.gate_up_proj.weight, b["ffn"]["w_gate_up"].t())
        put(f.down_proj.weight, b["ffn"]["w_down"].t())
        put(f.gate_up_proj_adapter_list[k][0].weight, p["adapter_a"].t())
        put(f.gate_up_proj_adapter_list[k][1].weight, p["adapter_b"].t())
    return m


def test_reference_matches_transformers_zamba2():
    """The reference's logits at every position equal transformers'
    Zamba2ForCausalLM's on the same weights.  transformers' torch path
    runs the prompt as one SSD chunk here: across chunks it sums each
    chunk's carried state over the target chunks (``.sum(dim=2)`` of
    ``decay_chunk * states``) where the recurrence sums the source
    chunks, so its multi-chunk prefill is not the model's function; the
    reference has no chunks, and the port's two are held to it below."""
    dm, _, w = tiny()
    tokens = torch.randint(0, dm["vocab"], (B, P),
                           generator=torch.Generator().manual_seed(1))
    m = _transformers_model(dm, w.tree, chunk=P)
    with torch.no_grad():
        want = m(tokens, use_cache=False).logits
    got = ref.logits(dm, w.tree, tokens, range(P))
    assert rel(got, want) < TOL


def test_reference_is_sensitive_to_each_mechanism():
    """Each of the published form's own pieces moves the logits far
    past the tolerance: the adapters, the ``linear``, the tied blocks
    (swapped)."""
    dm, _, w = tiny()
    tokens = torch.randint(0, dm["vocab"], (B, P),
                           generator=torch.Generator().manual_seed(1))
    base = ref.logits(dm, w.tree, tokens, range(P))
    tree = w.tree
    for name, leaf in (("adapter", "adapter_b"), ("linear", "linear")):
        saved = {}
        for path, t in tree_items(tree):
            if path.endswith(leaf):
                saved[path] = t.clone()
                t.mul_(0.5)
        moved = rel(ref.logits(dm, tree, tokens, range(P)), base)
        for path, t in tree_items(tree):
            if path in saved:
                t.copy_(saved[path])
        assert moved > 1e3 * TOL, name
    for k, t in tree["shared"]["attn"].items():
        t.copy_(t.flip(0))
    moved = rel(ref.logits(dm, tree, tokens, range(P)), base)
    assert moved > 1e3 * TOL


# --------------------------------------------------------------- the port


def test_port_prefill_and_decode_match_the_reference():
    """Through ``serve.compile_step_fns`` (on the CPU the prefill and
    the decode step the graphs capture): the prefill's logits, then four
    decode steps through the cache, which they update in place (K/V rows
    of the tied blocks, conv and SSM states), against the reference's
    full forward over the prompt and the served tokens.  The prompt is
    two chunks of the port's scan."""
    dm, cfg, w = tiny()
    assert P == 2 * cfg.ssm.chunk_size
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, dm["vocab"], (B, P), generator=g)
    opts = lm.RunOptions(chunk_q=8, chunk_kv=8, cache_len=P + G,
                         remat=False)
    prefill_fn, step = serve.compile_step_fns(cfg, w.tree,
                                              {"tokens": tokens}, opts, P)
    logits, cache = prefill_fn({"tokens": tokens})
    bufs = {path: t.data_ptr() for path, t in tree_items(cache)}
    got, served = [logits], []
    for i in range(G - 1):
        # tokens off the argmax, so the check does not lean on greedy
        tok = torch.randint(0, dm["vocab"], (B,), generator=g)
        served.append(tok)
        got.append(step(tok, P + i))
    assert {path: t.data_ptr() for path, t in tree_items(cache)} == bufs
    seqs = torch.cat([tokens, torch.stack(served, 1)], 1)
    want = ref.logits(dm, w.tree, seqs, range(P - 1, P + G - 1))
    assert rel(torch.stack(got, 1), want) < TOL


@pytest.mark.parametrize("what", ["one_group", "unit_index", "residual"])
def test_port_departures_are_caught(what, monkeypatch):
    """The comparison above sees each way the port could depart: B and
    C of the first group for every head, the tied block chosen by unit
    index within the stage, a residual add of the attention inside the
    tied block (as the port's variant has)."""
    dm, cfg, w = tiny()
    tokens = torch.randint(0, dm["vocab"], (B, P),
                           generator=torch.Generator().manual_seed(1))
    want = ref.logits(dm, w.tree, tokens, [P - 1])[:, 0]
    if what == "one_group":
        from repro_torch.models import ssm
        real = ssm._split_xbc

        def first_group(xBC, d_inner, s):
            x, Bm, Cm = real(xBC, d_inner, s)
            return (x, Bm[..., :1, :].expand_as(Bm),
                    Cm[..., :1, :].expand_as(Cm))
        monkeypatch.setattr(ssm, "_split_xbc", first_group)
    elif what == "unit_index":
        stages = blocks.build_stages(cfg)
        monkeypatch.setattr(blocks, "build_stages", lambda c: tuple(
            dataclasses.replace(st, first_hybrid=0) for st in stages))
    else:
        real = lm._tied_block_mlp
        monkeypatch.setattr(lm, "_tied_block_mlp",
                            lambda cfg, sp, p, att, tile=None:
                            att + real(cfg, sp, p, att, tile))
    opts = lm.RunOptions(chunk_q=8, chunk_kv=8, remat=False)
    got, _ = lm.prefill(cfg, w.tree, {"tokens": tokens}, opts)
    assert rel(got, want) > 1e3 * TOL


# ------------------------------------------------------------ full size


def test_full_size_from_the_spec_alone():
    """At every published width and all 81 layers, from the spec (no
    allocation): 7,356,749,648 parameters from the port's spec and from
    the benchmark's layout, a tied head, stages from
    ``hybrid_layer_ids``, in_proj of 14,704 columns, and a K/V cache of
    13 x 2 x 32 heads x 224 x 2 bytes = 372,736 bytes a slot."""
    cfg = get_config(ARCH)
    assert ARCH in PORT_ONLY_ARCH_IDS and ARCH not in ALL_ARCH_IDS
    assert lm.param_count(cfg) == PARAMS
    cell = harness.load_cell(ROOT, "zamba2-7b-instruct.chat")
    dm = ref.dims(cell.config)
    assert program.program_config("hybrid", dm) == cfg
    assert sum(math.prod(shape) for _, shape, _, _ in ref.layout(dm)) \
        == PARAMS
    spec = lm.model_spec(cfg)
    assert "lm_head" not in spec and cfg.tie_embeddings
    assert spec["stage0"]["pos0"]["mamba"]["in_proj"].shape == (1, 3584,
                                                                 14_704)
    stages = [(st.n_units, len(st.unit), st.unit[0].shared_attn,
               st.first_hybrid) for st in blocks.build_stages(cfg)]
    assert stages == [(1, 6, False, 0), (1, 5, True, 0), (11, 6, True, 1),
                      (1, 4, True, 12)]
    assert [(n, ln, h) for n, ln, h, _ in stages] == ref.stages(dm)
    hybrid_layers = [i for i, (_, _, _, k) in
                     enumerate(ref._layer_sites(dm)) if k is not None]
    assert hybrid_layers == list(cfg.ssm.hybrid_layer_ids)
    kv = sum(math.prod(p.shape) * 2 for path, p in
             tree_items(lm.cache_spec(cfg, 1, 1)) if "shared_" in path)
    assert kv == 372_736
    assert cfg.attention.softmax_scale == pytest.approx(112 ** -0.5)
    assert cfg.norm_eps == 1e-5 and cfg.ssm.n_groups == 2
    # the serving plan's count of a decode step's products is the
    # benchmark's: 81 x (in_proj, out_proj) + 13 x (q, k, v, o, gate/up,
    # adapter A and B, down, linear), then the logits
    from collections import Counter

    from repro_torch.tuning import model as tuning_model
    prods = tuning_model.decode_products(cfg, 32)
    assert sum(c for *_, c in prods) == 81 * 2 + 13 * 9 + 1 == len(
        ref.launches(dm, 32, 1024, "decode")["spm_matmul"])
    want = Counter()
    for _, k, n, c in ref._products(dm, 32):
        want[(k, n)] += c
    assert Counter({(k, n): c for _, k, n, tb, c in prods if not tb}) == want


# ---------------------------------------------------------- flash at 224


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_at_head_dim_224(causal):
    """The plain version (what CPU calls run, and what the card's kernel
    is held to) equals attention written out in fp64 at head dim 224."""
    g = torch.Generator().manual_seed(5)
    Bq, S, H = 2, 80, 3
    q, k, v = (torch.randn(Bq, S, H, 224, generator=g) for _ in range(3))
    scale = 112 ** -0.5
    got = flash_ops.attention(q, k, v, causal=causal, scale=scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.double())
    assert float((got.double() - want).abs().max()) < 1e-5


def test_flash_plan_at_head_dim_224():
    """Serving's kernel at 224 takes 256's schedule: the head dim padded
    to four TMA boxes, the two warpgroups split it (one holding all of O
    would need 128 + 32 registers, over the 120), 64 queries a block,
    230,456 bytes of shared memory; fma's plan fits too.  The backward
    is not compiled at 224 and its plan raises."""
    regs = gpu_mapping.flash_tc_registers(224, False)
    assert (regs["split"], regs["overlap"], regs["head_dims"]) \
        == (True, True, 128)
    assert gpu_mapping.flash_tile(224, "tensor_core") == (64, 64)
    tc = gpu_mapping.flash_smem_plan(224, "tensor_core")
    assert tc["fits"] and tc["smem_need"] == 230_456 and tc["rows"] == 64
    assert tc["q_bytes"] == 4 * 8192 and tc["stage_bytes"] == 2 * 4 * 8192
    assert gpu_mapping.flash_smem_plan(224, "fma")["fits"]
    assert flash_ops.launch_plan(32, 1024, 1024, 32, 32, 224, True, 0,
                                 torch.bfloat16) == {"bq": 64, "bk": 64}
    with pytest.raises(ValueError, match="head dim"):
        gpu_mapping.flash_bwd_smem_plan(224, "tensor_core")
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.bwd_dispatch(224, torch.bfloat16, True)


# ------------------------------------------------------------ readers


def _span_run():
    """A run whose program spans pass gave two replays of each phase."""
    rows = {"prefill": [dict(graph=100.0, mixer=60.0, ffn=20.0, head=1.0,
                             cache=2.0, embed=1.0),
                        dict(graph=110.0, mixer=64.0, ffn=20.0, head=1.0,
                             cache=2.0, embed=1.0)],
            "decode": [dict(graph=40.0, mixer=30.0, ffn=5.0, head=0.5,
                            cache=0.5, embed=0.0),
                       dict(graph=42.0, mixer=32.0, ffn=5.0, head=0.5,
                            cache=0.5, embed=0.0)]}
    cell = harness.load_cell(ROOT, "zamba2-7b-instruct.chat")
    ctx = SimpleNamespace(workload=cell.workload, reference=ref,
                          dims=ref.dims(cell.config))
    return SimpleNamespace(program_spans=rows, ctx=ctx)


def test_the_hybrid_cells_readers_on_synthetic_rows():
    """``shared_attention_ms.*``: the median of graph less every group
    (16 and 22 ms in prefill: median 19; 4 and 4 in decode);
    ``mamba_roofline.*``: ``mamba_costs``' bound over the mixer's median
    ms (62 and 31)."""
    run = _span_run()
    read = {n: harness.reader(n).read(run) for n in (
        "shared_attention_ms.prefill", "shared_attention_ms.decode",
        "mamba_roofline.prefill", "mamba_roofline.decode")}
    assert read["shared_attention_ms.prefill"] == pytest.approx(19.0)
    assert read["shared_attention_ms.decode"] == pytest.approx(4.0)
    dm, w = run.ctx.dims, run.ctx.workload
    for phase, ms in (("prefill", 62.0), ("decode", 31.0)):
        costs = ref.mamba_costs(dm, w["batch"], w["prompt_len"], phase)
        assert len(costs) == 3 * 81
        want = 100 * counts.total_bound_s(costs) / (ms * 1e-3)
        assert read[f"mamba_roofline.{phase}"] == pytest.approx(want)
    # decode's least work: the weights of in_proj and out_proj and the
    # state read and written once in bf16, 81 layers
    dec = ref.mamba_costs(dm, 32, 1024, "decode")
    state = 2 * 32 * 112 * 64 * 64 * 2
    assert dec[2].nbytes == 32 * (3 * 7168 + 2 * 128) * 2 + state
    assert dec[0].nbytes == (32 * 3584 + 3584 * 14_704 + 32 * 14_704) * 2
    run.program_spans = {"prefill": [], "decode": []}
    assert all(harness.reader(n).read(run) is None for n in read)
    vlm = SimpleNamespace(ctx=SimpleNamespace(
        workload=run.ctx.workload, reference=SimpleNamespace(),
        dims={}), program_spans=_span_run().program_spans)
    assert harness.reader("mamba_roofline.decode").read(vlm) is None


# ------------------------------------------------------ on the card only


@pytest.mark.gpu
def test_cuda_flash_d224_serving_case():
    """The new cell's prefill attention on the card (B 32, 1024 x 1024
    causal, 32 / 32 heads, head dim 224, the model's scale): the
    tensor-core kernel, each element within the bf16 allowance of the
    plain version, the same bits twice, and a 5 % scale error caught.
    The backward at 224 raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run it there")
    from repro_torch.kernels.tolerance import check
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(224)
    q, k, v = (torch.randn(32, 1024, 32, 224, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    scale = 112 ** -0.5
    before = dict(flash_ops.attention.paths)
    got = flash_ops.attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert flash_ops.attention.paths["tensor_core"] \
        == before["tensor_core"] + 1
    assert torch.equal(got, flash_ops.attention(q, k, v, causal=True,
                                                scale=scale))
    want = flash_ops.attention_plain(q, k, v, causal=True, scale=scale)
    assert check(got, want, torch.bfloat16)[0] < 1
    fault = flash_ops.attention(q, k, v, causal=True, scale=1.05 * scale)
    assert check(fault, want, torch.bfloat16)[0] > 1
    x = q[:1, :64, :2].clone().requires_grad_()
    lse_launches = flash_ops.attention.bwd_launches
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.attention(x, x, x, causal=True).sum().backward()
    assert flash_ops.attention.bwd_launches == lse_launches
