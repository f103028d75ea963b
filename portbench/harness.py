"""The general harness: one run of one cell of ``BENCHMARK.json``.

Everything of a cell is found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic
(``workloads/<cell>.json``, whose ``kind`` names the generator
``traffic/<kind>.py``), the reference of its model family
(``reference/<family>.py``) and each metric's reader
(``metrics/<metric>.py``).  A run:

1. set-up (``setup_s``, from the process's start): the traffic kind's
   ``prepare`` (kernels, weights from the seed, graphs, untimed
   batches);
2. the measured window of ``--seconds`` or a little more, to the end of
   a batch (``window``); with ``--trace 1`` one more batch after it under
   the profiler (whose own start-up is warmed first);
3. the device's peak memory read, the program's state freed, and the
   check against the plain reference (``check``);
4. the metrics of the cell that ``--trace`` selects, each by its reader,
   and the result as the last line of standard output.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot measure: it exits non-zero and prints no result."""


def load_file(path: Path, name: str) -> ModuleType:
    """A module from a file whose name need not be an identifier
    (``metrics/mfu.decode.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise Refused(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"no file {path}")
    return json.loads(path.read_text())


def load_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` with everything it names, loaded by name."""
    spec = read_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    config = read_json(HERE / "configs" / f"{entry['config']}.json")
    workload = read_json(HERE / "workloads" / f"{name}.json")
    if workload["traffic"] != entry["traffic"]:
        raise Refused(f"{name}: traffic {workload['traffic']!r} in its file, "
                      f"{entry['traffic']!r} in BENCHMARK.json")
    return SimpleNamespace(spec=spec, entry=entry, config=config,
                           workload=workload)


def metrics_of(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those whose ``workloads`` list it, or that list none."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str) -> ModuleType:
    return load_file(HERE / "metrics" / f"{name}.py",
                     f"portbench_metric_{name.replace('.', '_')}")


def context(cell: SimpleNamespace, seed: int, device) -> SimpleNamespace:
    family = cell.config["family"]
    ref = importlib.import_module(f"portbench.reference.{family}")
    return SimpleNamespace(
        cell=cell, name=cell.entry["name"], config=cell.config,
        workload=cell.workload, seed=seed, device=device, reference=ref,
        dims=ref.dims(cell.config), kind=importlib.import_module(
            f"portbench.traffic.{cell.workload['kind']}"),
        state=None, weights=None)


def execute(cell: SimpleNamespace, seed: int, seconds: float, trace: bool,
            device, t_process: float) -> dict:
    """Steps 1 to 4 on ``device``; returns the result's fields.  The
    tests call it on the CPU at a small size."""
    import time

    import torch

    from portbench.trace import Tracer
    ctx = context(cell, seed, device)
    ctx.kind.prepare(ctx)
    setup_s = time.perf_counter() - t_process
    tracer = Tracer() if trace else None
    record = ctx.kind.window(ctx, seconds, tracer)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx.kind.release(ctx)
    compared = ctx.kind.check(ctx, record)
    run = SimpleNamespace(ctx=ctx, setup_s=setup_s, window=record,
                          trace=tracer.summary() if trace else None)
    metrics = {}
    for m in metrics_of(cell.spec, ctx.name, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(v <= lim for v, lim in compared.values()),
        "attempted": record["attempted"],
        "failed": record.get("failed", 0),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak},
    }
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_by_span()}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    for line in ctx.kind.describe(record) + (
            run.trace.describe() if trace else []):
        print(line, file=sys.stderr)
    return result


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                             "benchmark on this machine.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]], root: Path, t_process: float) -> int:
    args = parse(argv)
    try:
        cell = load_cell(root, args.workload)
        import torch
        chips = cell.entry["chips"]
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise Refused(f"{torch.cuda.device_count()} cards, the cell "
                          f"needs {chips}")
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
        result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t_process)
        found = forbidden_modules()
        if found:
            raise Refused(f"loaded in this process: {', '.join(found)}")
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
