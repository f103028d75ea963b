"""Readings that set a cell's limit: for each seed, the check's number
on the program's served tokens and the control's on the same sample.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 8 [--control-seeds 3] [--out readings.jsonl]

One process sets the cell up once; each seed then draws the weights
anew in place (the captured graphs stay valid), serves a short window at
the cell's own sizes, and compares a sample of its finished requests
with the plain reference in fp32, and the same sample's positions with
the reference in float8 (the control: its own first choice at each
position, read under the fp32 reference).  The benchmark's runs do not
run the control.  Prints one JSON line a seed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="run the control on the first this many seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctx = harness.context(cell, seeds[0], torch.device("cuda", 0))
    ctx.kind.prepare(ctx)
    print(f"card: {harness.card_line()}; set-up "
          f"{time.perf_counter() - T_PROCESS:.1f} s", flush=True)
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(seeds):
            ctx.seed = seed
            ctx.weights.draw(seed)
            t0 = time.perf_counter()
            record = ctx.kind.window(ctx, args.seconds, None)
            t1 = time.perf_counter()
            row = {"workload": args.workload, "seed": seed,
                   **ctx.kind.readings(ctx, record,
                                       control=i < args.control_seeds),
                   "window_s": t1 - t0,
                   "check_s": time.perf_counter() - t1}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    import os
    os.environ["REPRO_AUTOTUNE"] = "0"
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    sys.exit(main())
