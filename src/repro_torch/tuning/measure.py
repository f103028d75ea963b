"""Measurement + jitter-aware plan selection (the reference's
``tuning/measure.py``; selection word for word).

Like the paper's evaluation protocol (§5.1), candidates are judged on
their *distribution* of execution times, not a single number: each
surviving plan runs ``reps`` times under an ``obs.TraceRecorder`` (one
span per measured rep on the ``autotune`` track — the span count IS the
measurement count, which is how tests and the CLI verify a warm cache
performs zero measurements), and selection goes to the lowest **p99**
latency with a **CoV tie-break**: any plan whose p99 is within
``tie_rel`` of the best competes, and the steadiest (lowest coefficient
of variation) of those wins.  Speed never comes at the cost of
predictability.

On the card a host clock around one launch times the launch and the
synchronise, not the kernel.  So a runner may time itself: if ``fn()``
returns a number, that is the rep's sample in us (the autotuner's CUDA
runners return a CUDA-event reading of a graph replay divided by the
launches it holds), and the host clock only places the rep's span.  A
runner that returns None is timed by the host clock, as in the
reference (the CPU path).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.obs import JitterStats, TraceRecorder, jitter_stats
from repro_torch.tuning.plan import Plan, plan_sig

MEASURE_TRACK = "autotune"


def measure_callable(fn: Callable[[], Optional[float]], *, reps: int = 5,
                     warmup: int = 1,
                     trace: Optional[TraceRecorder] = None,
                     label: str = "plan") -> JitterStats:
    """Time ``fn()`` ``reps`` times (after ``warmup`` untimed runs that
    absorb first-call costs) and summarize as JitterStats (us): each
    sample is what ``fn()`` returns, or the host clock around it when
    it returns None."""
    for _ in range(max(0, warmup)):
        fn()
    samples: List[float] = []
    # GC pauses are the dominant interference source on the host —
    # collect up front, then keep the collector out of the timed region
    # (the paper's no-interference protocol).
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        for i in range(max(1, reps)):
            t0 = time.perf_counter()
            timed = fn()
            t1 = time.perf_counter()
            samples.append((t1 - t0) * 1e6 if timed is None
                           else float(timed))
            if trace is not None:
                trace.add_span(label, MEASURE_TRACK, t0 * 1e6, t1 * 1e6,
                               cat="measure", rep=i)
    finally:
        if gc_was_enabled:
            gc.enable()
    return jitter_stats(samples)


def measurement_count(trace: TraceRecorder) -> int:
    """Number of measured reps recorded on ``trace``."""
    return len(trace.spans_on(MEASURE_TRACK))


def select_plan(results: Sequence[Tuple[Plan, JitterStats]],
                tie_rel: float = 0.05) -> Tuple[Plan, JitterStats]:
    """Jitter-aware argmin: best p99; plans within ``tie_rel`` of it
    are tied and the lowest-CoV one wins."""
    if not results:
        raise ValueError("select_plan needs at least one measurement")
    best_p99 = min(s.p99 for _, s in results)
    pool = [(p, s) for p, s in results
            if s.p99 <= best_p99 * (1.0 + tie_rel)]
    return min(pool, key=lambda ps: (ps[1].cov, ps[1].p99,
                                     plan_sig(ps[0])))
