"""Readers of the hybrid family's own per-layer metrics: the tied
blocks' attention, the one module of a replay that no group of
``program_spans.GROUPS`` holds, and the Mamba layers' share of their
least work (``reference/hybrid.py::mamba_costs``) over the mixer
group's time, which in this family is its Mamba layers alone."""
from __future__ import annotations

import statistics
from typing import Optional

from portbench import counts, program_spans


def outside_groups_ms(run, phase: str) -> Optional[float]:
    """Median over the program spans pass's replays of ``phase`` of the
    replay's device ms outside every group: ``graph`` less the groups'
    sum (the hybrid's ``shared_attention`` spans)."""
    res = program_spans.result(run)
    rows = res and res[phase]
    if not rows:
        return None
    return statistics.median(
        r["graph"] - sum(r[g] for g in program_spans.GROUPS) for r in rows)


def mamba_roofline(run, phase: str) -> Optional[float]:
    """%: the least time of the Mamba layers' work in one replay of
    ``phase`` over the median ms of the mixer group's spans."""
    ctx, w = run.ctx, run.ctx.workload
    costs = getattr(ctx.reference, "mamba_costs", None)
    if costs is None:
        return None
    ms = program_spans.median_ms(run, phase, "mixer")
    if not ms:
        return None
    bound = counts.total_bound_s(
        costs(ctx.dims, w["batch"], w["prompt_len"], phase))
    return 100.0 * bound / (ms * 1e-3)
