"""The readers of the program's spans (``program_spans``): medians per
replay from a recorder's device spans, whose groups add up to the
replay's device time, and the pass itself on the CPU, which holds its
tokens to the window's, gives no result where the program has no spans
or a token differs, and fails the run where it fails otherwise."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import tiny_cell
from portbench import harness, program_spans

NEW = ["graph_ms.decode", "graph_ms.prefill", "mixer_ms.decode",
       "mixer_ms.prefill", "ffn_ms.decode", "ffn_ms.prefill",
       "head_ms.decode", "cache_ms.prefill"]


def replay(rec, phase, r, parts, t0):
    """Spans of one replay from ``t0`` (us): ``parts`` [(name, us)], back
    to back, as the stamps lay them."""
    t = t0
    for name, dur in parts:
        rec.add_span(name, f"device.{phase}", t, t + dur, cat="device",
                     replay=r, layer=0)
        t += dur
    rec.add_span("replay", "host", t0 - 50, t0 - 10, cat="host", graph=phase,
                 replay=r)
    return t


def synthetic():
    from repro_torch.obs import TraceRecorder
    rec = TraceRecorder()
    t = 0.0
    # replay 0 of each phase is the capture's own and is left out
    t = replay(rec, "prefill", 0, [("embed", 9e9)], t)
    for r, mix in enumerate((1000.0, 3000.0, 2000.0), start=1):
        t = replay(rec, "prefill", r, [
            ("embed", 100.0), ("attention", mix), ("ffn", 2000.0),
            ("cache", 300.0), ("attention", mix), ("ffn", 2000.0),
            ("cache", 300.0), ("cache", 50.0), ("head", 250.0)], t + 1e3)
    t = replay(rec, "decode", 0, [("embed", 9e9)], t)
    for r in range(1, 4):
        t = replay(rec, "decode", r, [
            ("embed", 10.0), ("time_mix", 400.0 * r), ("channel_mix", 500.0),
            ("cache", 40.0), ("head", 50.0)], t + 1e3)
    return program_spans.summarize(rec, {"prefill": 1, "decode": 1})


def read(run, name):
    return harness.reader(name).read(run)


def test_readers_take_medians_per_replay():
    run = SimpleNamespace(program_spans=synthetic())
    got = {n: read(run, n) for n in NEW}
    assert got == pytest.approx({
        "graph_ms.prefill": 9.0, "mixer_ms.prefill": 4.0,
        "ffn_ms.prefill": 4.0, "cache_ms.prefill": 0.65,
        "graph_ms.decode": 1.4, "mixer_ms.decode": 0.8,
        "ffn_ms.decode": 0.5, "head_ms.decode": 0.05})
    res = run.program_spans
    assert len(res["prefill"]) == len(res["decode"]) == 3
    assert res["host_replay_ms"]["decode"] == pytest.approx([0.04] * 3)
    # the groups tile a replay: they add up to its device time
    for phase in ("prefill", "decode"):
        for row in res[phase]:
            assert sum(row[g] for g in program_spans.GROUPS) \
                == pytest.approx(row["graph"])
    assert "decode: 3 replays" in program_spans.describe(res, 2, 1.5)


def served_run(monkeypatch, family):
    import torch
    monkeypatch.setattr(program_spans, "MIN_SECONDS", 0.0)
    cell = tiny_cell(family)
    ctx = harness.context(cell, 2**35 + 5, torch.device("cpu"))
    ctx.kind.prepare(ctx)
    # the window's two first batches, as the window serves them
    record = {"batches": [ctx.kind.serve_batch(ctx, k, None)
                          for k in range(2)]}
    ctx.kind.release(ctx)
    return SimpleNamespace(ctx=ctx, setup_s=0.0, window=record, trace=None)


def test_the_pass_serves_the_window_again_on_the_cpu(monkeypatch, family,
                                                     capsys):
    run = served_run(monkeypatch, family)
    got = {n: read(run, n) for n in NEW}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    res = run.program_spans
    w = run.ctx.workload
    # two batches: a prefill and gen - 1 steps each
    assert len(res["prefill"]) == 2
    assert len(res["decode"]) == 2 * (w["gen"] - 1)
    for row in res["prefill"] + res["decode"]:
        assert sum(row[g] for g in program_spans.GROUPS) \
            == pytest.approx(row["graph"])
    assert run.ctx.state is None
    assert "program spans: 2 batches" in capsys.readouterr().err


def test_no_result_where_a_token_differs(monkeypatch, capsys):
    run = served_run(monkeypatch, "rwkv")
    run.window["batches"][1]["out"][0, 0] += 1
    assert all(read(run, n) is None for n in NEW)
    assert "served other tokens" in capsys.readouterr().err


def test_no_result_from_a_program_without_spans(monkeypatch, capsys):
    from repro_torch.launch import serve
    run = served_run(monkeypatch, "rwkv")

    def compile_step_fns(cfg, params, batch, opts, prompt_len):
        raise AssertionError("not called")
    monkeypatch.setattr(serve, "compile_step_fns", compile_step_fns)
    assert all(read(run, n) is None for n in NEW)
    assert "takes no spans" in capsys.readouterr().err


def test_a_pass_that_fails_fails_the_run(monkeypatch):
    from repro_torch.launch import serve
    run = served_run(monkeypatch, "rwkv")

    def compile_step_fns(cfg, params, batch, opts, prompt_len, spans=None):
        raise RuntimeError("capture failed")
    monkeypatch.setattr(serve, "compile_step_fns", compile_step_fns)
    with pytest.raises(RuntimeError, match="capture failed"):
        read(run, "graph_ms.decode")
