"""The port's serving layer on the CPU: the serve entry point's banner
(for qwen2-0.5b and rwkv6-1.6b), the H100 WCET bound's dependence on
the served plan (as tests/test_model_plan.py asserts for the
reference), spec-driven batch shedding, the gpu_mapping schedule's
invariants, the copied deadline ladder and plan helpers against the
reference's, ``compile_step_fns`` against direct ``lm`` calls, the
``jitter`` block of ``main``'s result, and ``REPRO_TRACE``'s spans,
counters and deadline instants against the reference serve's."""
import json
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve as jax_serve
from repro.obs import jitter_stats as jax_jitter_stats
from repro.resilience.deadline import DeadlineMonitor as JaxDeadline
from repro.tuning.plan import plan_sig as jax_plan_sig
from repro_torch import compat
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.gpu_mapping import (H100, gpu_matmul_schedule,
                                          gpu_steady_state, gpu_wcet,
                                          serve_step_schedule)
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.spec import tree_items, tree_map
from repro_torch.obs import JitterStats
from repro_torch.resilience.deadline import DeadlineMonitor
from repro_torch.tuning.model import (ModelProblem, default_model_plan,
                                      plan_sig)

MICRO = ModelProblem("qwen2-0.5b", 2, 32, 4, layers=2, d_model=64,
                     vocab=256)


def _micro_cfg():
    return reduce_config(get_config("qwen2-0.5b"), layers=2, d_model=64,
                         vocab=256)


def test_serve_main_on_cpu_prints_the_banner(capsys):
    res = serve.main(["--device", "cpu", "--prompt-len", "32", "--gen",
                      "4", "--d-model", "64", "--vocab", "256",
                      "--deadline-ms", "10000"])
    out = capsys.readouterr().out
    for line in ("serving plan [defaults]:", "prefill:",
                 "decode:  median", "generated shape: (4, 4)",
                 "H100 WCET bound per step", "deadline:"):
        assert line in out, (line, out)
    toks = np.stack(res["tokens"], 1)
    assert toks.shape == (4, 4)
    assert ((toks >= 0) & (toks < 256)).all()
    assert res["device"] == "cpu" and res["wcet_s"] > 0


def test_serve_main_serves_rwkv_on_cpu(capsys):
    """The reduced rwkv6-1.6b through the same entry point: prefill runs
    the wkv6 wrapper (its plain version here), decode carries the
    state."""
    res = serve.main(["--device", "cpu", "--arch", "rwkv6-1.6b",
                      "--prompt-len", "64", "--gen", "4", "--d-model", "64",
                      "--vocab", "256", "--deadline-ms", "10000"])
    out = capsys.readouterr().out
    assert "rwkv6-1.6b 2L d_model=64" in out
    assert "generated shape: (4, 4)" in out
    toks = np.stack(res["tokens"], 1)
    assert ((toks >= 0) & (toks < 256)).all()
    assert res["deadline"]["n_shed"] == 0


def test_serve_explicit_chunks_and_dtype(capsys):
    res = serve.main(["--device", "cpu", "--prompt-len", "24", "--gen",
                      "2", "--d-model", "64", "--vocab", "256",
                      "--chunk-q", "8", "--chunk-kv", "8", "--dtype",
                      "float32", "--deadline-ms", "10000"])
    out = capsys.readouterr().out
    assert "serving plan [explicit+defaults]:" in out
    assert res["plan"]["chunk_q"] == 8 and "float32" in out


def test_wcet_bound_derives_from_the_served_plan():
    cfg = _micro_cfg()
    n_p = lm.param_count(cfg)
    plan = default_model_plan(cfg, MICRO)
    w = serve.plan_wcet_s(cfg, plan, MICRO.batch, n_p)
    assert w > 0
    repinned = dict(plan, mm_bn=max(1, plan["mm_bn"] // 2))
    assert serve.plan_wcet_s(cfg, repinned, MICRO.batch, n_p) != w
    sched = serve_step_schedule(MICRO.batch, cfg.d_model, n_p, plan=plan)
    assert sched.meta["tile_m"] == min(plan["mm_bm"], MICRO.batch)
    assert sched.meta["tile_n"] == plan["mm_bn"]


# weight-pass products per layer of one decode step: q k v o gate up
# down; rwkv's time mix mix_w1, mix_w2 x 5, wd_w1, wd_w2, r k v g o and
# its channel mix k v r; zamba2's in_proj and out_proj (2 layers: a
# stage of no units, so no tied block, and a tail of two mamba layers)
PRODUCTS_PER_LAYER = {"qwen2-0.5b": 7, "rwkv6-1.6b": 16, "zamba2-7b": 2}


@pytest.mark.parametrize("arch", sorted(PRODUCTS_PER_LAYER))
def test_decode_products_run_the_plans_tile(monkeypatch, capsys, arch):
    """The serving plan's mm_bm/mm_bn pins (the tile the WCET bound
    counts) reach every weight-pass product of every decode step, and
    are what spm_matmul resolves for the decode weight pass; prefill
    keeps the kernel's per-shape defaults."""
    from repro_torch.kernels.spm_matmul import ops as mm_ops
    plain = mm_ops.matmul
    calls = []

    def recording(a, b, **kw):
        calls.append((kw.get("bm"), kw.get("bn")))
        return plain(a, b, **kw)

    recording.launches = 0
    monkeypatch.setattr(mm_ops, "matmul", recording)
    gen, layers = 3, 2
    res = serve.main(["--device", "cpu", "--arch", arch, "--prompt-len",
                      "32", "--gen", str(gen), "--d-model", "64",
                      "--vocab", "256", "--deadline-ms", "10000"])
    capsys.readouterr()
    pins = (res["plan"]["mm_bm"], res["plan"]["mm_bn"])
    resolved = mm_ops.resolve_plan(4, 64, 2 * res["n_params"] // 64, 4,
                                   False)
    assert pins == (resolved["bm"], resolved["bn"]) in mm_ops.TILES
    per_step = PRODUCTS_PER_LAYER[arch] * layers + 1     # + logits
    # one untimed warm-up step, then the timed ones
    assert calls.count(pins) == (1 + gen) * per_step
    assert set(calls) == {pins, (None, None)}
    assert res["replayed_launches"] == {"spm_matmul": 0,
                                        "flash_attention": 0, "wkv6": 0}


def test_default_plan_follows_the_reference_rules():
    cfg = _micro_cfg()
    plan = default_model_plan(cfg, MICRO)
    assert (plan["chunk_q"], plan["chunk_kv"]) == (32, 32)
    assert plan["decode_scan"] == int(cfg.scan_layers)
    odd = ModelProblem("qwen2-0.5b", 2, 24, 4)
    assert default_model_plan(cfg, odd)["chunk_q"] == 24
    assert plan_sig(plan) == jax_plan_sig(plan)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-1.6b", "zamba2-7b",
                                  "whisper-base"])
def test_shed_batch_slices_only_the_batch_axis(arch):
    # zamba2 at 8 layers: one unit, so the tied block's K/V too; whisper:
    # the cross K/V too
    layers = 8 if arch == "zamba2-7b" else 2
    cfg = reduce_config(get_config(arch), layers=layers, d_model=64,
                        vocab=256)
    cache = lm.init_cache(cfg, 4, 40, device="cpu")
    for _, leaf in tree_items(cache):
        leaf.normal_()
    tok = torch.arange(4)
    shed, tok2 = serve.shed_batch(cfg, cache, tok, 2, 40)
    assert tok2.tolist() == [0, 1]
    for (path, old), (_, new) in zip(tree_items(cache), tree_items(shed)):
        assert new.shape == (old.shape[0], 2) + old.shape[2:], path
        assert torch.equal(new, old[:, :2])
        assert new.data_ptr() == old.data_ptr()      # a view, no copy
    with pytest.raises(ValueError):
        serve.shed_batch(cfg, cache, tok, 4, 40)


@pytest.mark.parametrize("m,k,n,tm,tn", [
    (4, 896, 4096, 4, 64), (256, 512, 1024, 64, 128), (3, 64, 200, 16, 64)])
def test_gpu_schedule_is_valid_and_bounded(m, k, n, tm, tn):
    sched = gpu_matmul_schedule(m, k, n, tile_m=tm, tile_n=tn)
    sched.validate_dag()
    sched.validate_interference_freedom()
    assert 0 < gpu_steady_state(sched) <= gpu_wcet(sched)
    assert sched.meta["smem_ok"] == (sched.meta["smem_need"]
                                     <= H100.smem_bytes)


def test_gpu_schedule_spreads_column_blocks_over_sms():
    one = gpu_wcet(gpu_matmul_schedule(512, 512, 64 * 132, tile_m=512,
                                       tile_n=64))
    sched = gpu_matmul_schedule(512, 512, 64 * 264, tile_m=512, tile_n=64)
    assert len(sched.resources()) == 133          # 132 SMs + HBM
    assert gpu_wcet(sched) > one


def test_deadline_ladder_matches_reference():
    durations = [0.5, 2, 2, 2, 2, 2, 0.1, 3, 3, 3, 3, 0.2]
    ours, ref = DeadlineMonitor(1.0), JaxDeadline(1.0)
    assert [ours.observe(i, d) for i, d in enumerate(durations)] == \
        [ref.observe(i, d) for i, d in enumerate(durations)]
    assert ours.summary() == ref.summary()


def test_cuda_entry_points_refuse_without_a_card():
    """Entry points default to CUDA and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(_micro_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--gen", "1"])


def test_compat_dtype_mapping():
    assert compat.torch_dtype("bfloat16") is torch.bfloat16
    assert compat.torch_dtype(torch.float32) is torch.float32
    with pytest.raises(ValueError):
        compat.torch_dtype("int4")
    with pytest.raises(ValueError):
        compat.resolve_device("mps")


def _trace_outline(path):
    """A Chrome trace's events without their clock readings: each
    span's name, track and arguments, each counter's name and track,
    and each instant's name, track and step."""
    doc = json.loads(path.read_text())
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M"}
    out = {"X": [], "C": [], "i": []}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            out["X"].append((e["name"], tracks[e["tid"]], e["cat"],
                             e["args"]))
        elif e["ph"] == "C":
            out["C"].append((e["name"], tracks[e["tid"]]))
        elif e["ph"] == "i":
            out["i"].append((e["name"], tracks[e["tid"]],
                             e["args"]["step"], e["args"]["deadline_s"]))
    return out


SERVE_ARGS = ["--prompt-len", "32", "--gen", "6", "--d-model", "64",
              "--vocab", "256"]


@pytest.mark.parametrize("deadline_ms", ["10000", "1e-6"],
                         ids=["met", "overrun"])
def test_repro_trace_matches_the_reference_serve(monkeypatch, capsys,
                                                 tmp_path, deadline_ms):
    """The same reduced serve through both packages with ``REPRO_TRACE``
    set: one ``prefill`` and a ``decode{i}`` span per step on the
    ``serve`` track, a ``step_ms`` counter per step and, under a tiny
    deadline, the same ``deadline_*`` instants (record, warn, shed)."""
    argv = SERVE_ARGS + ["--deadline-ms", deadline_ms]
    ours, ref = tmp_path / "port.json", tmp_path / "reference.json"
    monkeypatch.setenv("REPRO_TRACE", str(ours))
    serve.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setenv("REPRO_TRACE", str(ref))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    ref_out = capsys.readouterr().out
    assert f"trace: 7 spans -> {ours}" in port_out
    assert f"trace: 7 spans -> {ref}" in ref_out
    a, b = _trace_outline(ours), _trace_outline(ref)
    assert a == b
    assert [n for n, *_ in a["X"]] == ["prefill"] + [
        f"decode{i}" for i in range(6)]
    assert {track for _, track, *_ in a["X"]} == {"serve"}
    assert a["C"] == [("step_ms", "serve")] * 6
    if deadline_ms == "10000":
        assert a["i"] == []
    else:
        assert [n for n, *_ in a["i"]] == [
            "deadline_record", "deadline_warn", "deadline_warn",
            "deadline_shed", "deadline_record", "deadline_warn"]
        assert {track for _, track, *_ in a["i"]} == {"deadline"}


def test_no_trace_without_repro_trace(monkeypatch, capsys):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    serve.main(SERVE_ARGS + ["--deadline-ms", "1e-6", "--device", "cpu"])
    assert "trace:" not in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-1.6b", "zamba2-7b"])
def test_compile_step_fns_on_cpu_match_direct_lm_calls(arch):
    """On the CPU, ``compile_step_fns`` are the plain ``lm.prefill`` and
    ``lm.decode_step``: the same logits and greedy tokens as calling
    them directly, with the step reading the cache the last prefill
    wrote, and no captured launch."""
    cfg = reduce_config(get_config(arch), layers=2, d_model=64, vocab=256)
    P, G = 16, 5
    opts = lm.RunOptions(chunk_q=16, chunk_kv=16, cache_len=P + G,
                         remat=False)
    params = lm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, P),
                           generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "targets": tokens}
    prefill_fn, step = serve.compile_step_fns(cfg, params, batch, opts, P)

    def greedy(logits, stepper):
        toks = []
        for i in range(G):
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
            toks.append(tok)
            logits = stepper(tok, P + i)
        return torch.stack(toks, 1), logits

    logits, cache = prefill_fn(batch)
    want_logits, want_cache = lm.prefill(cfg, params, batch, opts)
    assert torch.equal(logits, want_logits)
    for (path, a), (_, b) in zip(tree_items(cache), tree_items(want_cache)):
        assert torch.equal(a, b), path
    got = greedy(logits, step)
    want = greedy(want_logits, lambda t, p: lm.decode_step(
        cfg, params, want_cache, t, p, opts)[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    zeros = dict.fromkeys(("spm_matmul", "flash_attention", "wkv6"), 0)
    assert prefill_fn.captured == step.captured == zeros
    assert prefill_fn.replays == step.replays == 0
    # a second prefill rewrites the cache the step reads
    prefill_fn(batch)
    again = greedy(logits, step)
    assert torch.equal(again[0], got[0])


def test_serve_reports_jitter_with_the_wcet_margin(capsys):
    res = serve.main(["--device", "cpu", "--prompt-len", "16", "--gen",
                      "5", "--d-model", "64", "--vocab", "256",
                      "--deadline-ms", "10000"])
    capsys.readouterr()
    j = res["jitter"]
    times = res["decode_s"]
    assert set(j) == set(JitterStats.__dataclass_fields__)
    assert j["n"] == 5 and j["max"] == times.max()
    assert j["wcet_margin"] == res["wcet_s"] / times.max()
    assert j == jax_jitter_stats(times, wcet_bound=res["wcet_s"]).as_dict()
    assert res["prefill_launches"] == res["replayed_launches"] == \
        dict.fromkeys(("spm_matmul", "flash_attention", "wkv6"), 0)


@pytest.mark.gpu
def test_captured_prefill_is_bit_identical_to_eager_on_the_card():
    """Reduced qwen2 in bf16 on the card: the prefill graph's replay
    gives the eager prefill's logits and cache bit for bit, each
    replay launches one spm_matmul per product and one flash_attention
    per layer, and the decode graph reads the cache it wrote."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run chip_smoke.py there")
    dev = compat.resolve_device("cuda")
    cfg = _micro_cfg()
    P = 64
    opts = lm.RunOptions(chunk_q=32, chunk_kv=32, cache_len=P + 4,
                         remat=False, mm_tiles=(16, 64))
    params = tree_map(lambda t: t.to(dev),
                      lm.init_params(cfg, seed=0, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (4, P), device=dev)
    batch = {"tokens": tokens}
    prefill_fn, step = serve.compile_step_fns(cfg, params, batch, opts, P)
    logits, cache = prefill_fn(batch)
    want, want_cache = lm.prefill(cfg, params, batch, opts)
    torch.cuda.synchronize()
    assert torch.equal(logits, want)
    for (path, a), (_, b) in zip(tree_items(cache), tree_items(want_cache)):
        assert torch.equal(a, b), path
    assert prefill_fn.captured == {"spm_matmul": 7 * 2 + 1,
                                   "flash_attention": 2, "wkv6": 0}
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    got = step(tok, P)
    eager = lm.decode_step(cfg, params, want_cache, tok, P, opts)[0]
    assert torch.equal(got, eager)
