"""The offline autotuner: enumerate -> prune -> measure -> persist (the
reference's ``tuning/autotuner.py``, timing the port's kernels on the
card).

Pipeline for one (kernel, problem):

1. enumerate candidate plans (candidates.py: the plans that launch
   differently on the card),
2. drop shared-memory-infeasible ones and rank the rest with the
   analytic roofline model (cost_model.py) — only the top
   ``max_candidates`` (always including the default plan) are ever
   measured,
3. measure the survivors under an ``obs.TraceRecorder`` and select by
   the jitter-aware objective (measure.py: p99 with CoV tie-break),
4. persist the winner to the JSON plan cache (plan_cache.py) so every
   later call — CLI, serve, or kernel wrapper — reuses it with zero
   measurements.

Measurement inputs are deterministic: a ``torch.Generator`` seeded from
the problem, as the reference seeds its PRNG keys, so re-tuning the same
problem measures the same computation.

On CUDA each runner first holds the plan's output against the kernel's
plain version on the same inputs (``kernels.tolerance``: 0.02 of the
row's RMS plus 2 ulp in bf16), and raises if it disagrees: a wrong plan
is never measured, so never cached.  Then one rep is one replay of a
CUDA graph holding ``launches`` calls that cycle through copies of the
inputs which together exceed twice the 50 MB L2 (the serve streams its
weights from HBM every step, so a warm-L2 time would rank plans for a
cache state the serve never sees), timed by CUDA events and divided by
the launches.  A candidate that fails to launch raises; nothing falls
back.  On the CPU every wrapper runs its plain version whatever the
plan: tuning there exercises the mechanics (counts, spans, cache,
precedence), keyed under ``gpu: None``, which never resolves on a card.
"""
from __future__ import annotations

import gc
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.obs import JitterStats, TraceRecorder
from repro_torch.tuning.candidates import defaults_for, enumerate_candidates
from repro_torch.tuning.cost_model import analytic_cost_s, feasibility
from repro_torch.tuning.measure import measure_callable, select_plan
from repro_torch.tuning.plan import (AttentionProblem, MatmulProblem, Plan,
                                     Problem, WkvProblem, plan_sig)
from repro_torch.tuning.plan_cache import PlanCache, cache_key

L2_BYTES = 50 * 2 ** 20
MIN_LAUNCHES = 20          # launches in one timed graph replay, at least
MAX_COPIES = 64            # input copies a runner cycles through, at most


@dataclass(frozen=True)
class TuneResult:
    kernel: str
    problem: Problem
    plan: Plan
    source: str                       # "cache" | "measured"
    key: str
    measured: int                     # timed reps performed (0 = warm)
    candidates: int                   # enumerated
    feasible: int                     # after the shared-memory check
    pruned_to: int                    # actually measured plans
    stats: Optional[JitterStats] = None
    default_plan: Optional[Plan] = None
    default_stats: Optional[JitterStats] = None  # always measured cold
    # per measured plan (plan_sig): its stats, and on CUDA its error as a
    # share of the allowance against the plain version
    results: Dict[str, JitterStats] = field(default_factory=dict)
    err_ratios: Dict[str, float] = field(default_factory=dict)


# ------------------------------------------------------ input builders

def _inputs(kernel: str, problem: Problem, dev: torch.device):
    """(args, kwargs, plain, check) for one call on seeded inputs: the
    wrapper's positional tensors, its other kwargs, the plain version
    and the element-wise check that holds the kernel to it."""
    from repro_torch.kernels import tolerance
    gen = torch.Generator(device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if kernel == "spm_matmul":
        from repro_torch.kernels.spm_matmul import ops
        p: MatmulProblem = problem
        dt = compat.torch_dtype(p.dtype)
        gen.manual_seed(p.m + p.k + p.n)
        a = randn(p.m, p.k).to(dt)
        b = randn(*((p.n, p.k) if p.trans_b else (p.k, p.n))).to(dt)
        return ((a, b), {"trans_b": p.trans_b},
                lambda x, y: ops.matmul_plain(x, y, dt, trans_b=p.trans_b),
                lambda got, want: tolerance.check(got, want, dt)[0])

    if kernel == "flash_attention":
        from repro_torch.kernels.flash_attention import ops
        ap: AttentionProblem = problem
        dt = compat.torch_dtype(ap.dtype)
        gen.manual_seed(ap.seq_q + ap.heads + ap.head_dim)
        q = randn(ap.batch, ap.seq_q, ap.heads, ap.head_dim).to(dt)
        k = randn(ap.batch, ap.seq_k, ap.kv_heads, ap.head_dim).to(dt)
        v = randn(ap.batch, ap.seq_k, ap.kv_heads, ap.head_dim).to(dt)
        kw = {"causal": ap.causal, "window": ap.window}
        return ((q, k, v), kw,
                lambda x, y, z: ops.attention_plain(
                    x, y, z, scale=1.0 / math.sqrt(ap.head_dim), **kw),
                lambda got, want: tolerance.check(got, want, dt)[0])

    if kernel == "wkv6":
        from repro_torch.kernels.wkv6 import ops
        wp: WkvProblem = problem
        dt = compat.torch_dtype(wp.dtype)
        gen.manual_seed(wp.seq + wp.key_dim)
        shape = (wp.batch, wp.seq, wp.heads, wp.key_dim)
        r = (randn(*shape) * 0.5).to(dt)
        k = (randn(*shape) * 0.5).to(dt)
        v = (randn(*shape) * 0.5).to(dt)
        w_log = -torch.exp(randn(*shape) * 0.8 - 2.0)
        u = randn(wp.heads, wp.key_dim) * 0.3
        return ((r, k, v, w_log, u), {}, ops.wkv_plain,
                lambda got, want: tolerance.check_wkv(got, want, dt)[0])

    raise KeyError(f"unknown kernel {kernel!r}")


def make_runner(kernel: str, problem: Problem, plan: Plan,
                device: str = "cuda") -> Callable[[], Optional[float]]:
    """A zero-arg thunk running the kernel under exactly ``plan`` on
    deterministic inputs (what measure_callable times).  On the CPU it
    makes one call and returns None; on CUDA, after holding the plan to
    the plain version (``run.err_ratio``; a ratio not under 1 raises),
    it replays a captured graph of ``run.launches`` calls and returns
    the device us per call."""
    from repro_torch.kernels import import_entry
    from repro_torch.tuning.runtime import cache_suspended
    dev = compat.resolve_device(device)
    wrapper = import_entry(kernel)
    args, kw, plain, check = _inputs(kernel, problem, dev)

    def call(*xs):
        with cache_suspended():
            return wrapper(*xs, **kw, **plan)

    if dev.type != "cuda":
        def run() -> None:
            call(*args)
        run.err_ratio, run.launches = None, 1
        return run

    got = call(*args)          # the first call builds the kernel's library
    ratio = check(got, plain(*args))
    if not ratio < 1:
        raise RuntimeError(
            f"{kernel} {problem.sig} plan {plan_sig(plan)}: error at "
            f"{ratio:.3f} of the allowance against the plain version")
    nbytes = sum(t.numel() * t.element_size() for t in args)
    copies = max(1, min(MAX_COPIES, math.ceil(2 * L2_BYTES / nbytes)))
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]
    run = _graph_runner(call, sets, max(MIN_LAUNCHES, copies))
    run.err_ratio = ratio
    return run


def _graph_runner(call, sets, launches: int) -> Callable[[], float]:
    """``run() -> us per call``: one replay of a CUDA graph holding
    ``launches`` calls over ``sets`` in turn, timed by CUDA events.  The
    first calls run on a side stream before capture (first-launch
    attributes), and one replay warms the graph up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for xs in sets[:2]:
            call(*xs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            call(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / launches

    run.launches = launches
    return run


def release(device: str) -> None:
    """Hand a measured candidate's graph and inputs back before the next
    one is built."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# -------------------------------------------------------------- tuning

def shortlist(kernel: str, problem: Problem,
              max_candidates: int = 4) -> Tuple[List[Plan], int, int]:
    """Enumerate, shared-memory-filter, rank analytically; returns the
    plans to measure (default always included) plus (enumerated,
    feasible)."""
    cands = enumerate_candidates(kernel, problem)
    feas = [c for c in cands if feasibility(kernel, problem, c).fits]
    ranked = sorted(feas, key=lambda c: (
        analytic_cost_s(kernel, problem, c), plan_sig(c)))
    keep = ranked[:max(1, max_candidates)]
    default = defaults_for(kernel, problem)
    if default in feas and default not in keep:
        keep.append(default)
    if not keep:        # no candidate fits: measure the default anyway
        keep = [default]
    return keep, len(cands), len(feas)


def tune(kernel: str, problem: Problem, *,
         cache: Optional[PlanCache] = None,
         reps: int = 5, warmup: int = 1, max_candidates: int = 4,
         tie_rel: float = 0.05, force: bool = False,
         device: str = "cuda",
         trace: Optional[TraceRecorder] = None) -> TuneResult:
    """Tune one (kernel, problem), consulting/updating the plan cache.

    A warm cache short-circuits before any device work: ``measured ==
    0`` and no spans are added to ``trace``.  ``force=True`` re-measures
    and overwrites the cached plan.  On a cold run the result carries
    the winner's stats and the default plan's."""
    if cache is None:
        from repro_torch.tuning.runtime import active_cache
        cache = active_cache()
    key = cache_key(kernel, problem)
    if not force:
        cached = cache.get(key)
        if cached is not None:
            return TuneResult(kernel, problem, cached, "cache", key,
                              measured=0, candidates=0, feasible=0,
                              pruned_to=0)

    keep, n_cands, n_feas = shortlist(kernel, problem, max_candidates)
    default = defaults_for(kernel, problem)
    results: List[Tuple[Plan, JitterStats]] = []
    errs: Dict[str, float] = {}
    for plan in keep:
        fn = make_runner(kernel, problem, plan, device=device)
        stats = measure_callable(
            fn, reps=reps, warmup=warmup, trace=trace,
            label=f"{kernel}/{problem.sig}/{plan_sig(plan)}")
        results.append((plan, stats))
        if fn.err_ratio is not None:
            errs[plan_sig(plan)] = fn.err_ratio
        del fn
        release(device)
    best_plan, best_stats = select_plan(results, tie_rel=tie_rel)
    default_stats = next((s for p, s in results if p == default), None)

    cache.put(key, best_plan,
              kernel=kernel, shape=problem.sig, dtype=problem.dtype,
              objective=best_stats.as_dict(),
              candidates=n_cands, feasible=n_feas,
              measured_plans=len(results), reps=reps)
    cache.save()
    return TuneResult(kernel, problem, dict(best_plan), "measured",
                      key, measured=len(results) * max(1, reps),
                      candidates=n_cands, feasible=n_feas,
                      pruned_to=len(results), stats=best_stats,
                      default_plan=dict(default),
                      default_stats=default_stats,
                      results={plan_sig(p): s for p, s in results},
                      err_ratios=errs)
