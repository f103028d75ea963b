"""Spans inside the prefill and decode graphs (``obs.stamps``): on the
CPU, reduced models through ``compile_step_fns(..., spans=rec)`` give
per replay one span per module boundary, ordered, tiling the replay and
inside its host span, with the same logits and tokens as without spans;
the stamper's passes, its clock conversion and ``serve``'s ``--seed``;
the published hybrid's (zamba2-7b-instruct's) spans and their counts.
On the card (``gpu``): stamped and unstamped graphs give the same bits
and launch counts, each replay makes its stamps, and each stamp agrees
with the profiler's start of its kernel."""
from __future__ import annotations

import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.obs import TraceRecorder, stamps

MIXERS = {"attention", "cross_attention", "time_mix", "mamba"}
FFNS = {"ffn", "channel_mix"}
P, G = 16, 4


def _reduced(arch: str):
    cfg = reduce_config(get_config(arch), layers=2, d_model=64, vocab=256)
    if arch in ("qwen3-moe-235b-a22b", "whisper-base"):
        cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg


def _batch(cfg, with_patches: bool = False):
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, P), generator=g)
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, P, cfg.d_model), generator=g)
    if with_patches:
        batch["patch_embeds"] = torch.randn((2, 4, cfg.d_model), generator=g)
    return batch


def _serve(cfg, batch, spans):
    """Logits of the prefill and of G greedy steps, and the tokens."""
    opts = lm.RunOptions(chunk_q=16, chunk_kv=16, cache_len=P + G,
                         remat=False)
    params = lm.init_params(cfg, seed=0, device="cpu")
    prefill_fn, step = serve.compile_step_fns(cfg, params, batch, opts, P,
                                              spans=spans)
    logits, _ = prefill_fn(batch)
    out, toks = [logits], []
    for i in range(G):
        toks.append(torch.argmax(logits[:, :cfg.vocab_size], dim=-1))
        logits = step(toks[-1], P + i)
        out.append(logits)
    return torch.stack(out), torch.stack(toks), prefill_fn


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "pixtral-12b", "qwen2-0.5b",
                                  "zamba2-7b", "whisper-base",
                                  "qwen3-moe-235b-a22b"])
def test_spans_tile_each_replay_and_change_no_bit(arch):
    cfg = _reduced(arch)
    batch = _batch(cfg, with_patches=arch == "pixtral-12b")
    ref_logits, ref_toks = _serve(cfg, batch, None)[:2]
    rec = TraceRecorder()
    logits, toks, prefill_fn = _serve(cfg, batch, rec)
    assert torch.equal(logits, ref_logits) and torch.equal(toks, ref_toks)
    assert prefill_fn.stamper.collect() > 0
    host = {(dict(s.args)["graph"], dict(s.args)["replay"]): s
            for s in rec.spans_on("host") if s.name == "replay"}
    # compile_step_fns' own prefill and step, then the calls above
    assert sorted(host) == [("decode", r) for r in range(G + 1)] + [
        ("prefill", r) for r in range(2)]
    for phase in ("prefill", "decode"):
        # layers are numbered as a replay runs them: whisper's prefill
        # runs its encoder's first
        n_layers = cfg.num_layers + (cfg.encdec.encoder_layers
                                     if cfg.family == "encdec"
                                     and phase == "prefill" else 0)
        by = collections.defaultdict(list)
        for s in rec.spans_on(f"device.{phase}"):
            by[dict(s.args)["replay"]].append(s)
        assert sorted(by) == sorted(r for p, r in host if p == phase)
        shapes = set()
        for r, spans in by.items():
            # ordered, each starting where the one before it ended, all
            # inside the host span that ran the replay
            for a, b in zip(spans, spans[1:]):
                assert a.end == b.start
            hs = host[(phase, r)]
            assert hs.start <= spans[0].start and spans[-1].end <= hs.end
            assert spans[0].name == "embed" and spans[-1].name == "head"
            assert sum(s.dur for s in spans) == pytest.approx(
                spans[-1].end - spans[0].start)
            if phase == "decode":
                # compile_step_fns' own step is at P, then P, P + 1, ...
                assert {dict(s.args)["pos"] for s in spans} == {
                    P + max(r - 1, 0)}
            shapes.add(tuple((s.name, dict(s.args)["layer"])
                             for s in spans))
        assert len(shapes) == 1
        (shape,) = shapes
        layered = collections.Counter(
            (layer, "mixer" if n in MIXERS else "ffn" if n in FFNS else n)
            for n, layer in shape if layer is not None)
        layers = {layer for layer, _ in layered}
        assert layers == set(range(n_layers))
        for layer in layers:
            kinds = {k for (li, k), _ in layered.items() if li == layer}
            assert {"mixer", "ffn"} <= kinds or cfg.family in ("hybrid",
                                                               "encdec")
        if cfg.family not in ("hybrid", "encdec"):
            assert all(c == 1 for c in layered.values())
        names = {n for n, _ in shape}
        assert names <= MIXERS | FFNS | {"embed", "head", "cache"}


def test_published_hybrid_spans_tile_each_replay():
    """All 81 layers at tiny widths through ``compile_step_fns(...,
    spans=rec)``: each replay's spans tile it, the mixer spans are the
    81 ``mamba`` spans alone, 13 ``shared_attention`` spans hold the
    tied blocks' attention (in no group of the benchmark's), and both
    counts are on the recorder as counters; the logits are those of a
    run with no spans."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import program_spans
    arch = "zamba2-7b-instruct"
    cfg = dataclasses.replace(
        get_config(arch), d_model=32, d_ff=48, vocab_size=128,
        vocab_pad_multiple=64, dtype="float32",
        attention=dataclasses.replace(get_config(arch).attention,
                                      num_heads=4, num_kv_heads=4,
                                      head_dim=16, softmax_scale=8 ** -0.5),
        ssm=dataclasses.replace(get_config(arch).ssm, head_dim=16,
                                state_dim=8, chunk_size=8, adapter_rank=4))
    params = lm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, 128, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    opts = lm.RunOptions(chunk_q=8, chunk_kv=8, cache_len=12, remat=False)

    def run(spans):
        pf, step = serve.compile_step_fns(cfg, params, {"tokens": tokens},
                                          opts, 8, spans=spans)
        logits, _ = pf({"tokens": tokens})
        out = [logits, step(torch.argmax(logits[:, :128], -1), 9)]
        return torch.stack(out), pf
    want, _ = run(None)
    rec = TraceRecorder()
    got, pf = run(rec)
    assert torch.equal(got, want)
    pf.stamper.collect()
    counters = {c.name: c.value for c in rec.counters}
    assert counters == {"prefill.mamba_spans": 81,
                        "prefill.shared_attention_spans": 13,
                        "decode.mamba_spans": 81,
                        "decode.shared_attention_spans": 13}
    grouped = {n for names in program_spans.GROUPS.values() for n in names}
    assert "shared_attention" not in grouped
    for phase in ("prefill", "decode"):
        by = {}
        for s in rec.spans_on(f"device.{phase}"):
            by.setdefault(dict(s.args)["replay"], []).append(s)
        for spans in by.values():
            for a, b in zip(spans, spans[1:]):
                assert a.end == b.start
            names = [s.name for s in spans]
            mixers = [n for n in names
                      if n in program_spans.GROUPS["mixer"]]
            assert mixers == ["mamba"] * 81
            assert names.count("shared_attention") == 13
            assert set(names) <= {"embed", "shared_attention", "ffn",
                                  "mamba", "cache", "head"}
        rows = program_spans.summarize(rec)[phase]
        for row in rows:
            inside = sum(row[g] for g in program_spans.GROUPS)
            assert 0 < row["graph"] - inside < row["graph"]


def test_no_stamper_no_span():
    a, b = stamps.span("attention"), stamps.span("ffn", layer=None)
    assert a is b
    assert stamps.next_layer() is None


def _pass(g, body):
    g.begin("host")
    token = stamps._ACTIVE.set(g)
    try:
        body()
    finally:
        stamps._ACTIVE.reset(token)
    g.end()


def test_adjacent_spans_share_a_stamp_and_one_name_merges():
    g = stamps.GraphStamps("decode", torch.device("cpu"), 0)

    def body():
        with stamps.span("embed", layer=None):
            pass
        stamps.next_layer()
        with stamps.span("attention"):
            pass
        with stamps.span("ffn"):
            pass
        with stamps.span("head", layer=None):
            pass
        with stamps.span("head", layer=None):
            pass
    _pass(g, body)
    assert g.table == [("embed", None, 0, 1), ("attention", 0, 1, 2),
                       ("ffn", 0, 2, 3), ("head", None, 3, 4)]
    assert g.n_slots == 5 and len(g.host_rows[0]) == 5

    def nested():
        with stamps.span("attention"):
            with stamps.span("ffn"):
                pass
    g2 = stamps.GraphStamps("decode", torch.device("cpu"), 0)
    with pytest.raises(RuntimeError, match="inside"):
        _pass(g2, nested)

    def short():
        with stamps.span("embed", layer=None):
            pass
    # a later pass must give the first pass's spans
    with pytest.raises(RuntimeError, match="differ"):
        _pass(g, short)


def test_device_ns_reach_the_recorder_clock_between_calibrations():
    st = stamps.Stamper(TraceRecorder(), torch.device("cpu"))
    assert [i.name for i in st.rec.instants] == ["profiler_clock"]
    base = 1_700_000_000_000_000_000
    # two calibrations 10 s apart; the device clock runs 20 ppm fast
    st.calibrations = [(base, 5_000.0, 3.0),
                       (base + 10_000_200_000, 10_005_000.0, 7.0)]
    ns = np.array([base, base + 5_000_100_000, base + 10_000_200_000,
                   base + 20_000_400_000], dtype=np.int64)
    got = st.to_host_us(ns)
    assert got[:3] == pytest.approx([5_000.0, 5_005_000.0, 10_005_000.0],
                                    abs=1e-3)
    # past the last calibration: its offset
    assert got[3] == pytest.approx(10_005_000.0 + 10_000_200.0, abs=1e-3)
    assert st.error_us == 7.0
    offset, err = stamps.profiler_offset_us()
    assert err >= 0 and abs(offset) > 0


def test_serve_seed_draws_other_weights_and_prompt(capsys):
    argv = ["--prompt-len", "16", "--gen", "3", "--d-model", "64",
            "--vocab", "256", "--device", "cpu"]
    a = serve.main(argv)
    b = serve.main(argv + ["--seed", "0"])
    c = serve.main(argv + ["--seed", "7"])
    assert all(np.array_equal(x, y) for x, y in zip(a["tokens"],
                                                    b["tokens"]))
    assert not all(np.array_equal(x, y) for x, y in zip(a["tokens"],
                                                        c["tokens"]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run it there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-1.6b"])
def test_stamped_graphs_on_the_card(cuda_device, arch):
    """Full width at 2 layers: stamped and unstamped graphs give the same
    logits bit for bit and the same captured launches; a replay makes one
    stamp per boundary; under ``torch.profiler`` each stamp kernel's start
    agrees with its stamp on the profiler's clock to within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    dev = cuda_device
    _build.build()
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    B, Pc, Gc = 4, 256, 8
    opts = lm.RunOptions(cache_len=Pc + Gc, remat=False)
    params = lm.init_params(cfg, seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, Pc), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": tokens, "targets": tokens}

    def run(spans):
        with torch.no_grad():
            prefill_fn, step = serve.compile_step_fns(cfg, params, batch,
                                                      opts, Pc, spans=spans)
            logits, _ = prefill_fn(batch)
            out = [logits.clone()]
            for i in range(Gc):
                tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
                logits = step(tok, Pc + i)
                out.append(logits.clone())
        return prefill_fn, step, torch.stack(out)

    pf0, st0, ref = run(None)
    rec = TraceRecorder()
    pf1, st1, got = run(rec)
    assert torch.equal(ref, got)
    assert pf0.captured == pf1.captured and st0.captured == st1.captured
    stamper = pf1.stamper
    stamper.collect()
    L = cfg.num_layers
    if cfg.family == "rwkv":
        want = {"prefill": 2 * L + 4, "decode": 3 * L + 3}
    else:
        want = {"prefill": 3 * L + 4, "decode": 2 * L + 3}
    assert {g.phase: g.n_slots for g in stamper.graphs} == want
    n = 4
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    first = stamper.replays["decode"]
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            for i in range(n):
                st1(tok, Pc + i)
        torch.cuda.synchronize(dev)
    stamper.collect()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(e.start_ns() for e in
                     prof.profiler.kineto_results.events()
                     if e.device_type() == cuda
                     and "stamp_kernel" in e.name())
    (clock,) = [i for i in rec.instants if i.name == "profiler_clock"]
    offset_us = dict(clock.args)["offset_us"]
    ours = sorted({t for s in rec.spans_on("device.decode")
                   if dict(s.args)["replay"] >= first
                   for t in (s.start, s.end)})
    assert len(ours) == n * want["decode"]
    assert len(kernels) == len(ours), (len(kernels), len(ours))
    worst = max(abs((t + offset_us) * 1e3 - k)
                for t, k in zip(ours, kernels))
    print(f"{arch}: worst stamp against its profiler kernel "
          f"{worst / 1e3:.2f} us over {len(ours)} stamps; calibration "
          f"error {stamper.error_us:.2f} us")
    assert worst < 50e3


@pytest.mark.gpu
def test_a_full_ring_raises_until_it_is_drained(cuda_device, monkeypatch):
    """A graph's ring holds ``CAPACITY`` replays: one more raises (no
    drain inside a replay), a drain empties it, and every replay drained
    is recorded with its position."""
    from repro_torch.kernels import _build
    dev = cuda_device
    _build.build()
    monkeypatch.setattr(stamps, "CAPACITY", 3)
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2)
    B, Pc = 2, 64
    opts = lm.RunOptions(cache_len=Pc + 8, remat=False)
    params = lm.init_params(cfg, seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, Pc), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": tokens, "targets": tokens}
    rec = TraceRecorder()
    with torch.no_grad():
        prefill_fn, step = serve.compile_step_fns(cfg, params, batch, opts,
                                                  Pc, spans=rec)
        prefill_fn(batch)
        stamper = step.stamper
        tok = torch.zeros(B, dtype=torch.long, device=dev)
        for i in range(3):
            step(tok, Pc + i)
        assert stamper.full()
        with pytest.raises(RuntimeError, match="not drained"):
            step(tok, Pc + 3)
        stamper.drain()
        assert not stamper.full()
        step(tok, Pc + 3)
    assert step.replays == 4
    assert stamper.collect() == 2 + 4
    pos = sorted({dict(s.args)["replay"]: dict(s.args)["pos"]
                  for s in rec.spans_on("device.decode")}.items())
    assert pos == [(r, Pc + r) for r in range(4)]
