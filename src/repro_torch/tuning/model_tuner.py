"""End-to-end measurement of model serving plans (the reference's
``tuning/model_tuner.py``, for the port's serve).

Same pipeline as the kernel autotuner one level up: enumerate -> prune
(shared memory + roofline, tuning.model) -> measure -> persist.  The
measured unit is a *full serve pass* — one prefill plus ``gen`` decode
steps over a preallocated cache — timed by the same ``measure_callable``
the kernel tuner uses, so a warm cache still means zero measurement
spans on the trace.

Capture is hoisted out of the timed region entirely: the runner builds
the weights once and goes through ``launch/serve.py::compile_step_fns``
(the counterpart of the reference's AOT compile), which on CUDA captures
the prefill and the decode step as CUDA graphs; the thunk only replays
them, so nothing timed runs eagerly and p99/CoV of the pass speak for
the plan.  On CUDA a pass is timed by CUDA events from the prefill
replay's start to the last step's end; on the CPU by the host clock.  A
candidate's graphs and weights are released before the next candidate
is built.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.obs import JitterStats, TraceRecorder
from repro_torch.tuning.autotuner import release
from repro_torch.tuning.measure import measure_callable, select_plan
from repro_torch.tuning.model import (ModelProblem, default_model_plan,
                                      enumerate_model_candidates,
                                      model_analytic_cost_s, model_cache_key,
                                      model_feasible, problem_config)
from repro_torch.tuning.plan import Plan, plan_sig
from repro_torch.tuning.plan_cache import PlanCache


@dataclass(frozen=True)
class ModelTuneResult:
    problem: ModelProblem
    plan: Plan
    source: str                       # "cache" | "measured"
    key: str
    measured: int                     # timed passes performed (0 = warm)
    candidates: int
    feasible: int
    pruned_to: int
    stats: Optional[JitterStats] = None          # winning plan, full pass
    default_plan: Optional[Plan] = None
    default_stats: Optional[JitterStats] = None  # always measured cold
    # per measured plan (plan_sig): its full-pass stats
    results: Dict[str, JitterStats] = field(default_factory=dict)


def us_per_token(stats: JitterStats, problem: ModelProblem) -> float:
    """Median full-pass latency amortized over the generated tokens."""
    return stats.median / max(1, problem.gen)


def make_serve_runner(cfg, problem: ModelProblem, plan: Plan,
                      device: str = "cuda") -> Callable[[], Optional[float]]:
    """A zero-arg thunk executing one full serve pass (prefill + ``gen``
    decode steps) under ``plan``, with the weights built and every
    graph captured before the thunk is returned.  On CUDA it returns
    the pass's device us (CUDA events), on the CPU None."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import compile_step_fns
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.lm import RunOptions

    dev = compat.resolve_device(device)
    B, P, G = problem.batch, problem.prompt_len, problem.gen
    opts = RunOptions(chunk_q=int(plan["chunk_q"]),
                      chunk_kv=int(plan["chunk_kv"]),
                      cache_len=P + G, remat=False,
                      decode_scan=bool(plan["decode_scan"]),
                      mm_tiles=(int(plan["mm_bm"]), int(plan["mm_bn"])))
    seed = B + P + G
    params = lm_mod.init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, P, cfg.d_model), generator=gen,
                                      device=dev)
    if dev.type == "cuda":
        _build.build()
    prefill_fn, step = compile_step_fns(cfg, params, batch, opts, P)
    V = cfg.vocab_size

    def serve_pass() -> None:
        logits, _ = prefill_fn(batch)
        tok = torch.argmax(logits[:, :V], dim=-1)
        for i in range(G):
            tok = torch.argmax(step(tok, P + i)[:, :V], dim=-1)

    if dev.type != "cuda":
        return serve_pass
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run() -> float:
        start.record()
        serve_pass()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3

    return run


def model_shortlist(cfg, problem: ModelProblem, max_candidates: int = 4,
                    device: str = "cuda") -> Tuple[List[Plan], int, int]:
    """Enumerate, shared-memory-filter, rank by the analytic serve-pass
    bound; the default plan is always measured (it is the
    tuned-vs-default baseline, not just a fallback)."""
    cands = enumerate_model_candidates(cfg, problem, device)
    feas = [c for c in cands if model_feasible(cfg, problem, c)]
    ranked = sorted(feas, key=lambda c: (
        model_analytic_cost_s(cfg, problem, c), plan_sig(c)))
    keep = ranked[:max(1, max_candidates)]
    default = default_model_plan(cfg, problem)
    if default not in keep:
        keep.append(default)
    return keep, len(cands), len(feas)


def tune_model(problem: ModelProblem, *,
               cache: Optional[PlanCache] = None,
               reps: int = 5, warmup: int = 1, max_candidates: int = 4,
               tie_rel: float = 0.05, force: bool = False,
               device: str = "cuda",
               trace: Optional[TraceRecorder] = None) -> ModelTuneResult:
    """Tune one serving problem end-to-end, consulting/updating the
    shared plan cache under the ``model|`` namespace.

    A warm cache short-circuits before any device work (``measured ==
    0``, no spans on ``trace``).  On a cold run the result carries both
    the winner's stats and the default plan's, so callers can print the
    tuned-vs-default comparison without re-measuring.
    """
    if cache is None:
        from repro_torch.tuning.runtime import active_cache
        cache = active_cache()
    key = model_cache_key(problem)
    if not force:
        cached = cache.get(key)
        if cached is not None:
            return ModelTuneResult(problem, cached, "cache", key,
                                   measured=0, candidates=0, feasible=0,
                                   pruned_to=0)

    cfg = problem_config(problem)
    keep, n_cands, n_feas = model_shortlist(cfg, problem, max_candidates,
                                            device)
    default = default_model_plan(cfg, problem)
    results: List[Tuple[Plan, JitterStats]] = []
    for plan in keep:
        fn = make_serve_runner(cfg, problem, plan, device=device)
        stats = measure_callable(
            fn, reps=reps, warmup=warmup, trace=trace,
            label=f"model/{problem.sig}/{plan_sig(plan)}")
        results.append((plan, stats))
        del fn
        release(device)
    best_plan, best_stats = select_plan(results, tie_rel=tie_rel)
    default_stats = next(s for p, s in results if p == default)

    cache.put(key, best_plan,
              kernel="model", shape=problem.sig, dtype=problem.dtype,
              objective=best_stats.as_dict(),
              default_objective=default_stats.as_dict(),
              candidates=n_cands, feasible=n_feas,
              measured_plans=len(results), reps=reps)
    cache.save()
    return ModelTuneResult(problem, dict(best_plan), "measured", key,
                           measured=len(results) * max(1, reps),
                           candidates=n_cands, feasible=n_feas,
                           pruned_to=len(results), stats=best_stats,
                           default_plan=dict(default),
                           default_stats=default_stats,
                           results={plan_sig(p): s for p, s in results})
