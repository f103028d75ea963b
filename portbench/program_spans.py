"""The program's own spans inside its graphs: each replay's device time
split by module, for the readers ``graph_ms.*``, ``mixer_ms.*``,
``ffn_ms.*``, ``head_ms.decode`` and ``cache_ms.prefill``.

The first of those readers calls ``result(run)``, which runs the pass
once and keeps its result on ``run``.  The readers come last in
``BENCHMARK.json``, so the pass runs after the check and after every
other reader, and changes nothing they read.  It captures the prefill
and decode graphs again on the run's weights, with a recorder
(``launch.serve.compile_step_fns(..., spans=rec)``: a device stamp at
each module boundary of ``models/lm.py``, ``repro_torch.obs.stamps``),
serves the window's batches 0, 1, ... again until at least
``MIN_BATCHES`` and ``MIN_SECONDS`` (or the window's batches run out),
holds their tokens to the window's bit for bit, reads the stamps, frees
the graphs and prints one line to standard error.  A program whose
``compile_step_fns`` takes no ``spans``, or a token that differs, gives
no result: every reader returns None, and standard error says why.  Any
other failure of the pass fails the run.  A replay's spans tile it from
its first stamp to its last (``obs.stamps``), so the groups' sums add up
to ``graph`` by construction.

The graphs of the pass are the window's with the stamps added, whose
cost PERF.md gives.  The pass follows the profiled batch, after which a
graph's launch stays slower; a replay's device time starts at its first
stamp, after its launch, so the launch does not enter it.
"""
from __future__ import annotations

import inspect
import statistics
import sys
import time
from typing import Dict, Iterable, List, Optional

MIN_BATCHES = 2
MIN_SECONDS = 10.0
# the spans each metric sums, by the names models/lm.py gives them
GROUPS = {"mixer": ("attention", "cross_attention", "time_mix", "mamba"),
          "ffn": ("ffn", "channel_mix"),
          "head": ("head",),
          "cache": ("cache",),
          "embed": ("embed",)}
PHASES = ("prefill", "decode")


def result(run) -> Optional[dict]:
    """The pass's per-replay figures (``summarize``), run once per run."""
    if not hasattr(run, "program_spans"):
        run.program_spans = measure(run)
    return run.program_spans


def median_ms(run, phase: str, what: str) -> Optional[float]:
    """Median over the pass's replays of ``phase`` of ``what`` (``graph``
    or a group of ``GROUPS``) in ms per replay."""
    res = result(run)
    rows = res and res[phase]
    if not rows:
        return None
    return statistics.median(row[what] for row in rows)


def measure(run) -> Optional[dict]:
    """The pass (see the module's note); None from a program whose
    ``compile_step_fns`` takes no ``spans`` or where a token differs.  A
    pass that fails otherwise fails the run."""
    import torch

    from portbench import program
    from repro_torch.launch import serve
    if "spans" not in inspect.signature(serve.compile_step_fns).parameters:
        print("program spans: the program's compile_step_fns takes no "
              "spans: no result", file=sys.stderr)
        return None
    from repro_torch.obs import TraceRecorder
    ctx, window = run.ctx, run.window["batches"]
    w = ctx.workload
    B, P, G = w["batch"], w["prompt_len"], w["gen"]
    cfg = program.program_config(ctx.config["family"], ctx.dims)
    opts = program.serve_options(cfg, ctx.config["port_arch"], B, P, G)
    rec = TraceRecorder()
    with torch.no_grad():
        prefill_fn, step = serve.compile_step_fns(
            cfg, ctx.weights.tree, ctx.kind.batch_inputs(ctx, -1), opts, P,
            spans=rec)
    stamper = prefill_fn.stamper
    ctx.state = {"prefill_fn": prefill_fn, "step": step}
    del prefill_fn, step
    served: List[dict] = []
    try:
        stamper.collect()
        # the replays of the capture itself are left out
        first = dict(stamper.replays)
        t0 = time.perf_counter()
        while len(served) < len(window) and (
                len(served) < MIN_BATCHES
                or time.perf_counter() - t0 < MIN_SECONDS):
            served.append(ctx.kind.serve_batch(ctx, len(served), None))
            stamper.collect()
    finally:
        ctx.kind.release(ctx)
    differ = [b["index"] for b, wb in zip(served, window)
              if not torch.equal(b["out"], wb["out"])]
    if differ:
        print(f"program spans: batches {differ} served other tokens with "
              f"the stamps than in the window: no result", file=sys.stderr)
        return None
    out = summarize(rec, first)
    print(describe(out, len(served), stamper.error_us), file=sys.stderr)
    return out


def summarize(rec, first: Optional[Dict[str, int]] = None) -> dict:
    """Per replay of each phase numbered at or past ``first[phase]``: its
    device time from its first stamp to its last (``graph``) and each
    group's spans summed (ms), from the ``device.<phase>`` tracks of
    ``rec``; and the host's ``replay`` spans of the same replays (ms)."""
    first = first or {}
    out: dict = {"host_replay_ms": {}}
    for phase in PHASES:
        lo = first.get(phase, 0)
        by: Dict[int, list] = {}
        for s in rec.spans_on(f"device.{phase}"):
            r = dict(s.args)["replay"]
            if r >= lo:
                by.setdefault(r, []).append(s)
        rows = []
        for r in sorted(by):
            spans = by[r]
            row = {"graph": (max(s.end for s in spans)
                             - min(s.start for s in spans)) / 1e3}
            for group, names in GROUPS.items():
                row[group] = sum(s.dur for s in spans
                                 if s.name in names) / 1e3
            rows.append(row)
        out[phase] = rows
        out["host_replay_ms"][phase] = [
            s.dur / 1e3 for s in rec.spans_on("host")
            if s.name == "replay" and dict(s.args)["graph"] == phase
            and dict(s.args)["replay"] >= lo]
    return out


def _q(values: Iterable[float]) -> str:
    vals = sorted(values)
    if not vals:
        return "none"
    if len(vals) == 1:
        return f"{vals[0]:.4f}"
    q = statistics.quantiles(vals, n=20, method="inclusive")
    return f"p5 {q[0]:.4f} p50 {statistics.median(vals):.4f} p95 {q[-1]:.4f}"


def describe(out: dict, batches: int, error_us: float) -> str:
    """One line: per phase the replays, their device ms by quantile, each
    group's median ms, the host's ``replay`` ms."""
    parts = [f"program spans: {batches} batches, clock error "
             f"{error_us:.2f} us"]
    for phase in PHASES:
        rows = out[phase]
        if not rows:
            parts.append(f"{phase}: no replay")
            continue
        groups = " ".join(
            f"{g} {statistics.median(r[g] for r in rows):.4f}"
            for g in GROUPS)
        parts.append(
            f"{phase}: {len(rows)} replays, graph ms "
            f"{_q(r['graph'] for r in rows)}; median ms {groups}; host "
            f"replay ms {_q(out['host_replay_ms'][phase])}")
    return "; ".join(parts)
