"""Offline jitter-aware autotuner CLI of the port (``repro_torch.tuning``;
the counterpart of the reference's ``scripts/tune.py``, same flags plus
``--device``).

Tunes the port's kernels — or, with ``--model``, a whole serving
configuration — on the card and persists the winning plans to the JSON
plan cache, so later runs — serving, the kernel wrappers, or this CLI
again — reuse them with ZERO measurements (the final ``measurement
spans`` line is the proof: it counts the timed reps recorded on the obs
trace, and a fully warm cache prints 0).

  # tune every registered kernel on the reference's shapes
  PYTHONPATH=src python -m repro_torch.launch.tune

  # one kernel, explicit shape/dtype, fresh measurements
  PYTHONPATH=src python -m repro_torch.launch.tune --kernel spm_matmul \\
      --shape 4x896x4864 --dtype bfloat16 --force

  # a serving plan, measured as full captured prefill+decode passes,
  # cached under ``model|``
  PYTHONPATH=src python -m repro_torch.launch.tune --model qwen2-0.5b \\
      --layers 0 --shape 4x256x32 --dtype bfloat16

  # the mechanics on the CPU (plain versions; no times printed)
  PYTHONPATH=src python -m repro_torch.launch.tune --device cpu

Shape syntax per kernel: spm_matmul MxKxN (MxKxNt: B given as [N, K]);
flash_attention BxSxHxKVxD (causal, Sq=Sk=S); wkv6 BxSxHxK; --model
BxPxG (batch x prompt x gen, model dims from --layers/--d-model/--vocab,
--layers 0 the full model).  Cache path: --cache, else
$REPRO_PLAN_CACHE, else ~/.cache/repro_torch/tuning_plans.json.  Times
are printed only from the card, in us, beside its name and power limit.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.kernels import registered_kernels
    ap = argparse.ArgumentParser(
        description="offline jitter-aware autotuner (H100 port)")
    ap.add_argument("--kernel", action="append",
                    choices=registered_kernels(),
                    help="kernel(s) to tune (default: all registered)")
    ap.add_argument("--model", default=None, metavar="ARCH",
                    help="tune a serving plan for this architecture "
                         "instead of kernel plans")
    ap.add_argument("--shape", default=None,
                    help="kernel-specific shape (single --kernel "
                         "only); BxPxG with --model")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--layers", type=int, default=2,
                    help="--model: reduced layer count (0 = full)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed reps per surviving candidate")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--max-candidates", type=int, default=4,
                    help="plans measured after analytic pruning")
    ap.add_argument("--cache", default=None,
                    help="plan-cache path (default: $REPRO_PLAN_CACHE)")
    ap.add_argument("--force", action="store_true",
                    help="re-measure even on a warm cache")
    ap.add_argument("--device", default="cuda",
                    help="cuda (an sm_90 card) or cpu")
    return ap


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse, tune and print; returns ``{"results", "spans", "cache",
    "device"}`` (the TuneResult or ModelTuneResult of each job)."""
    from repro_torch import compat
    from repro_torch.kernels import registered_kernels
    from repro_torch.obs import TraceRecorder
    from repro_torch.tuning import (DEFAULT_PROBLEMS, PlanCache,
                                    measurement_count, parse_model_problem,
                                    parse_problem, plan_sig, tune,
                                    tune_model, us_per_token)

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.model and args.kernel:
        ap.error("--model and --kernel are mutually exclusive")
    dev = compat.resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        ident = compat.device_identity()
        print(f"device: {ident['gpu']}, power limit "
              f"{ident['power_limit_w']} W; times are device us (CUDA "
              f"events)")
    else:
        print("device: cpu (plain versions: mechanics only, no times)")

    cache = PlanCache(args.cache) if args.cache else None
    trace = TraceRecorder()
    results: List[object] = []

    if args.model:
        problem = parse_model_problem(
            args.model, args.shape or "4x64x32", layers=args.layers,
            d_model=args.d_model, vocab=args.vocab, dtype=args.dtype)
        res = tune_model(problem, cache=cache, reps=args.reps,
                         warmup=args.warmup,
                         max_candidates=args.max_candidates,
                         force=args.force, device=str(dev), trace=trace)
        results.append(res)
        line = (f"model {problem.sig}: plan={plan_sig(res.plan)} "
                f"[{res.source}] measured={res.measured}")
        if res.stats is not None:
            line += (f" (candidates={res.candidates} "
                     f"feasible={res.feasible} "
                     f"pruned_to={res.pruned_to})")
        print(line)
        if on_card and res.stats is not None:
            d, t = res.default_stats, res.stats
            print(f"  tuned:   {us_per_token(t, problem):10.1f} us/tok  "
                  f"pass p99 {t.p99:.1f} us  cov {t.cov:.4f}")
            print(f"  default: {us_per_token(d, problem):10.1f} us/tok  "
                  f"pass p99 {d.p99:.1f} us  cov {d.cov:.4f}")
            for sig, st in res.results.items():
                print(f"  {sig}: {us_per_token(st, problem):10.1f} us/tok"
                      f"  pass p99 {st.p99:.1f} us  cov {st.cov:.4f}")
    else:
        kernels = args.kernel or registered_kernels()
        if args.shape and len(kernels) != 1:
            ap.error("--shape needs exactly one --kernel")
        for kern in kernels:
            problem = (parse_problem(kern, args.shape, args.dtype)
                       if args.shape else DEFAULT_PROBLEMS[kern])
            res = tune(kern, problem, cache=cache, reps=args.reps,
                       warmup=args.warmup,
                       max_candidates=args.max_candidates,
                       force=args.force, device=str(dev), trace=trace)
            results.append(res)
            line = (f"{kern} {problem.sig}: plan={plan_sig(res.plan)} "
                    f"[{res.source}] measured={res.measured}")
            if res.stats is not None:
                line += (f" (candidates={res.candidates} "
                         f"feasible={res.feasible} "
                         f"pruned_to={res.pruned_to})")
            print(line)
            if on_card and res.stats is not None:
                d = res.default_stats
                print(f"  tuned:   p99 {res.stats.p99:.2f} us  cov "
                      f"{res.stats.cov:.4f}")
                print(f"  default: p99 {d.p99:.2f} us  cov {d.cov:.4f} "
                      f"({plan_sig(res.default_plan)})")
                for sig, st in res.results.items():
                    print(f"  {sig}: median {st.median:.2f} us  p99 "
                          f"{st.p99:.2f} us  cov {st.cov:.4f}")
    path = (cache or PlanCache()).path
    spans = measurement_count(trace)
    print(f"plan cache: {path}")
    print(f"measurement spans: {spans}")
    return {"results": results, "spans": spans, "cache": path,
            "device": str(dev)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
