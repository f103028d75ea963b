"""What the module spans cost on the card, and what they show.

    python3 scripts/stamp_turns.py turns [--cells a,b] [--rounds 3]
    python3 scripts/stamp_turns.py regimes <serve trace .json>

``turns``: for each cell of ``BENCHMARK.json`` (both by default), the
weights and inputs as the benchmark draws them (``portbench``), the
prefill and decode graphs captured twice through
``launch.serve.compile_step_fns``, without and with a recorder, then
replayed in turns (plain, stamped, stamped, plain; ``--rounds`` times),
each turn timed with CUDA events: ms per replay, the difference per stamp
and as a share of a replay.  Then, on the stamped graphs, the device time
of a decode replay (first stamp to last, median) and the host's launch,
read before any profiler has run in the process and again after a short
profiled stretch.  Writes ``chiprun_out/stamp_turns.json``.

``regimes``: reads the Chrome trace that ``launch.serve`` writes under
``REPRO_TRACE`` on the card (``serve`` track: a span per decode step;
``device.decode``: each replay's module spans) and splits each step's
host time into the graph's device time by module and the time outside
it, early and late in the run, to say where a slower start sits and how
much of a step the card spends outside the graph.  Writes
``chiprun_out/stamp_regimes.json``.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
CELLS = ("pixtral-12b.image-chat", "rwkv6-1.6b.long-doc")
SEED = 2**33 + 17


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def timed_ms(fn, n: int) -> float:
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def cell_turns(name: str, rounds: int) -> dict:
    import torch

    from portbench import harness, program, program_spans
    from portbench.traffic import batch_serve
    from portbench.weights import Weights
    from repro_torch.launch import serve
    from repro_torch.obs import TraceRecorder
    dev = torch.device("cuda", 0)
    ctx = harness.context(harness.load_cell(ROOT, name), SEED, dev)
    w = ctx.workload
    B, P, G = w["batch"], w["prompt_len"], w["gen"]
    cfg = program.program_config(ctx.config["family"], ctx.dims)
    program.build_kernels()
    ctx.weights = Weights(ctx.reference.layout(ctx.dims), dev)
    ctx.weights.draw(SEED)
    opts = program.serve_options(cfg, ctx.config["port_arch"], B, P, G)
    first = batch_serve.batch_inputs(ctx, -1)
    rec = TraceRecorder()
    with torch.no_grad():
        plain = serve.compile_step_fns(cfg, ctx.weights.tree, first, opts, P)
        stamped = serve.compile_step_fns(cfg, ctx.weights.tree, first, opts,
                                         P, spans=rec)
    stamper = stamped[0].stamper
    slots = {g.phase: g.n_slots for g in stamper.graphs}
    inp = batch_serve.batch_inputs(ctx, 0)
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    n = {"prefill": 2 if ctx.config["family"] == "vlm" else 4,
         "decode": 40 if ctx.config["family"] == "vlm" else 150}
    fns = {}
    for side, (prefill_fn, step) in (("plain", plain),
                                     ("stamped", stamped)):
        fns[(side, "prefill")] = lambda f=prefill_fn: f(inp)
        fns[(side, "decode")] = lambda f=step: f(tok, P)
    times = {k: [] for k in fns}
    with torch.no_grad():
        for phase in ("prefill", "decode"):
            for side in ("plain", "stamped"):
                timed_ms(fns[(side, phase)], 1)
            for _ in range(rounds):
                for side in ("plain", "stamped", "stamped", "plain"):
                    times[(side, phase)].append(
                        timed_ms(fns[(side, phase)], n[phase]))
                    stamper.collect()
    out = {"cell": name, "slots": slots, "replays_per_turn": n}
    for phase in ("prefill", "decode"):
        a = statistics.median(times[("plain", phase)])
        b = statistics.median(times[("stamped", phase)])
        out[phase] = {"plain_ms": times[("plain", phase)],
                      "stamped_ms": times[("stamped", phase)],
                      "median_plain_ms": a, "median_stamped_ms": b,
                      "us_per_stamp": (b - a) * 1e3 / slots[phase],
                      "share": (b - a) / a}
        print(f"{name} {phase}: plain {a:.4f} ms, stamped {b:.4f} ms a "
              f"replay ({slots[phase]} stamps): "
              f"{(b - a) * 1e3 / slots[phase]:.3f} us a stamp, "
              f"{100 * (b - a) / a:.3f} % of a replay; turns plain "
              f"{times[('plain', phase)]} stamped "
              f"{times[('stamped', phase)]}", flush=True)

    def decode_pass(k: int) -> dict:
        lo = dict(stamper.replays)
        with torch.no_grad():
            for i in range(k):
                stamped[1](tok, P + i % G)
                torch.cuda.synchronize()
        stamper.collect()
        res = program_spans.summarize(rec, lo)
        rows = res["decode"]
        return {"graph_ms": statistics.median(r["graph"] for r in rows),
                "host_replay_ms": statistics.median(
                    res["host_replay_ms"]["decode"]),
                "groups_ms": {g: statistics.median(r[g] for r in rows)
                              for g in program_spans.GROUPS}}

    k = 100 if ctx.config["family"] == "vlm" else 400
    before = decode_pass(k)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.no_grad():
            for i in range(10):
                stamped[1](tok, P)
        torch.cuda.synchronize()
    after = decode_pass(k)
    out["profiler"] = {"before": before, "after": after}
    print(f"{name} decode replays, {k} each, synchronized one by one: "
          f"before any profiler {before}; after one {after}", flush=True)
    return out


def turns(args) -> int:
    import torch
    out = {"card": card(), "cells": []}
    print(f"card: {out['card']}", flush=True)
    for name in args.cells.split(","):
        out["cells"].append(cell_turns(name, args.rounds))
        gc.collect()
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "stamp_turns.json").write_text(json.dumps(out, indent=1))
    return 0


def regimes(args) -> int:
    trace = json.loads(Path(args.trace).read_text())
    tracks = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M"}
    steps, launches, mods = [], {}, {}
    for e in trace["traceEvents"]:
        if e["ph"] != "X":
            continue
        track = tracks[e["tid"]]
        if track == "serve" and e["name"].startswith("decode"):
            steps.append((e["ts"], e["ts"] + e["dur"]))
        elif track == "host" and e["name"] == "replay" \
                and e["args"]["graph"] == "decode":
            launches[e["ts"]] = e["args"]["replay"]
        elif track == "device.decode":
            mods.setdefault(e["args"]["replay"], []).append(e)
    starts = sorted(launches)
    rows = []
    for s0, s1 in sorted(steps):
        # the replay whose launch lies inside the step
        i = bisect.bisect_left(starts, s0)
        if i == len(starts) or starts[i] > s1:
            continue
        spans = mods.get(launches[starts[i]])
        if not spans:
            continue
        g0 = min(e["ts"] for e in spans)
        g1 = max(e["ts"] + e["dur"] for e in spans)
        by = {}
        for e in spans:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e3
        rows.append({"step_ms": (s1 - s0) / 1e3,
                     "graph_ms": (g1 - g0) / 1e3, "modules_ms": by,
                     "start_s": s0 / 1e6, "graph_us": (g0, g1)})
    t0 = rows[0]["start_s"]

    def summary(part):
        keys = sorted({k for r in part for k in r["modules_ms"]})
        return {"steps": len(part),
                "from_s": part[0]["start_s"] - t0,
                "step_ms": statistics.median(r["step_ms"] for r in part),
                "graph_ms": statistics.median(r["graph_ms"] for r in part),
                "outside_graph_ms": statistics.median(
                    r["step_ms"] - r["graph_ms"] for r in part),
                "modules_ms": {k: statistics.median(
                    r["modules_ms"].get(k, 0.0) for r in part)
                    for k in keys}}
    # the step's time in windows of 250 steps, to find a switch
    windows = [summary(rows[i:i + 250]) for i in range(0, len(rows), 250)]
    # from one replay's last stamp to the next one's first: the card
    # outside the graph (the step's argmax and token copy, the host)
    gaps = [b["graph_us"][0] - a["graph_us"][1]
            for a, b in zip(rows, rows[1:])]
    out = {"steps": len(rows), "windows": windows,
           "card_outside_graph_share": sum(gaps) / (
               rows[-1]["graph_us"][1] - rows[0]["graph_us"][0]),
           "gap_ms": {"median": statistics.median(gaps) / 1e3,
                      "max": max(gaps) / 1e3}}
    for wdw in windows:
        print(json.dumps(wdw), flush=True)
    print(f"card outside the decode graph between replays: "
          f"{100 * out['card_outside_graph_share']:.3f} % of the decode "
          f"stretch", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "stamp_regimes.json").write_text(json.dumps(out, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    t = sub.add_parser("turns")
    t.add_argument("--cells", default=",".join(CELLS))
    t.add_argument("--rounds", type=int, default=3)
    r = sub.add_parser("regimes")
    r.add_argument("trace")
    args = ap.parse_args(argv)
    return turns(args) if args.what == "turns" else regimes(args)


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import os
    os.environ.setdefault("REPRO_AUTOTUNE", "0")
    t_start = time.perf_counter()
    rc = main()
    print(f"stamp_turns: {time.perf_counter() - t_start:.1f} s", flush=True)
    sys.exit(rc)
