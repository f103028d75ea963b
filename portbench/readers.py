"""What the metric readers (``metrics/<name>.py``) share.  A reader
takes the run (``run.window``: the traffic kind's record; ``run.trace``:
the ``TraceSummary`` of a ``--trace 1`` run, else None; ``run.setup_s``;
``run.ctx``: the cell, its sizes and reference) and returns a number, or
None where it finds nothing to read."""
from __future__ import annotations

from typing import List, Optional

from portbench import counts, stats
from portbench.trace import port_kernel


def batches(run) -> List[dict]:
    return run.window["batches"]


def device_ms_per_replay(run, phase: str, kernel: Optional[str]
                         ) -> Optional[float]:
    """Device ms per replay of ``phase``'s graph in ``kernel``'s launches
    (None: in every operation that is not one of the port's kernels)."""
    if run.trace is None:
        return None
    n = run.trace.replays(phase)
    ops = [o for o in run.trace.replay_ops(phase)
           if port_kernel(o.name) == kernel]
    if not n or not ops:
        return None
    return sum(o.end - o.start for o in ops) / n * 1e3


def roofline(run, kernel: str, phase: str) -> Optional[float]:
    """%: the bound of ``kernel``'s launches in one replay of ``phase``
    (``counts``, from shapes) over their traced device time."""
    ms = device_ms_per_replay(run, phase, kernel)
    if ms is None:
        return None
    w, ctx = run.ctx.workload, run.ctx
    launched = ctx.reference.launches(ctx.dims, w["batch"], w["prompt_len"],
                                      phase).get(kernel)
    if not launched:
        return None
    return 100.0 * counts.total_bound_s(launched) / (ms * 1e-3)


def mfu(run, phase: str) -> Optional[float]:
    """%: model FLOPs of the window's ``phase`` over its host time and
    the bf16 peak; a decode step from token in to token out, a prefill
    from prompt in to first token out."""
    ctx, w = run.ctx, run.ctx.workload
    B, P = w["batch"], w["prompt_len"]
    flops = seconds = 0.0
    for b in batches(run):
        if phase == "decode":
            flops += sum(ctx.reference.step_flops(ctx.dims, B, 1, pos)
                         for pos in b["positions"])
            seconds += sum(b["steps"])
        else:
            flops += ctx.reference.step_flops(ctx.dims, B, P, 0)
            seconds += b["ttft"]
    if not seconds:
        return None
    return 100.0 * flops / seconds / counts.PEAK_FLOPS


def host_ms_decode(run) -> Optional[float]:
    """Mean ms per decode step that the host spends inside the step's
    call: the decode graph's launch (token and position copied in, the
    replay enqueued), on the host clock, over the window's steps."""
    launch = [s for b in batches(run) for s in b["launch"]]
    return sum(launch) / len(launch) * 1e3 if launch else None


def tok_s(run) -> float:
    return run.window["tokens"] / run.window["seconds"]


def ttft_ms(run) -> float:
    ttft = [b["ttft"] for b in batches(run)]
    return sum(ttft) / len(ttft) * 1e3


def itl_p95_ms(run) -> Optional[float]:
    steps = [s for b in batches(run) for s in b["steps"]]
    return stats.percentile(steps, 95) * 1e3 if steps else None


def idle_share(run) -> Optional[float]:
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
