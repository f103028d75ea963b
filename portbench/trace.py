"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
over the device, and the harness's own host spans around each call it
makes into the program.

A span is a ``record_function`` range named ``pb.<what>``: ``inputs``
(a batch drawn), ``prefill`` (prompt copied in, prefill graph
replayed), ``first_token`` (argmax, token stored, synchronize),
``decode`` (token and position in, decode graph replayed) and
``next_token`` (as ``first_token``).  Each operation on the device is
charged to the span whose host call launched it, through the
profiler's correlation of a launch with its kernels; an operation that a
graph launch ran belongs to that replay.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench import stats

PREFIX = "pb."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

# the port's kernels by the names their device functions carry
PORT_KERNELS = {
    "spm_matmul": ("splitk_decode_kernel", "wgmma_gemm_kernel",
                   "spm_matmul_kernel"),
    "flash_attention": ("flash_fwd",),
    "wkv6": ("wkv6_kernel", "wkv6_tc_kernel"),
}


def port_kernel(name: str) -> Optional[str]:
    """Which of the port's kernels a device operation is, or None."""
    for kernel, pats in PORT_KERNELS.items():
        if any(p in name for p in pats):
            return kernel
    return None


@dataclass
class DeviceOp:
    name: str
    start: float           # seconds, the profiler's clock
    end: float
    span: Optional[str]    # the host span that launched it
    span_index: int        # which instance of that span (-1: none)
    graph: bool            # launched by a graph replay


@dataclass
class TraceSummary:
    window: Tuple[float, float]
    spans: List[Tuple[str, float, float]]
    ops: List[DeviceOp] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return stats.busy(((o.start, o.end) for o in self.ops),
                          *self.window)

    def count(self, span: str) -> int:
        return sum(1 for s in self.spans if s[0] == span)

    def replays(self, span: str) -> int:
        """Graph replays of ``span`` whose launch the trace holds: a
        replay whose launch record the profiler dropped is left out of
        the per-replay figures rather than counted as empty."""
        return len({o.span_index for o in self.replay_ops(span)})

    def replay_ops(self, span: str) -> List[DeviceOp]:
        return [o for o in self.ops if o.span == span and o.graph]

    def describe(self) -> List[str]:
        """Lines for standard error: device operations and their seconds
        by the span charged with them, replays apart from the rest."""
        by: Dict[Tuple[Optional[str], bool], List[float]] = {}
        for o in self.ops:
            by.setdefault((o.span, o.graph), []).append(o.end - o.start)
        rows = [f"{span or 'no span'}{' replay' if graph else ''}: "
                f"{len(d)} ops, {sum(d)} s"
                for (span, graph), d in sorted(by.items(), key=str)]
        seen = {k: f"{self.replays(k)} of {self.count(k)}"
                for k in ("prefill", "decode")}
        return [f"traced window {self.window_s} s, busy {self.busy_s} s; "
                f"replays with their launch: {seen}; " + "; ".join(rows)]

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + (o.end - o.start)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle time on the device inside the traced window, summed by
        the host span that was open at each gap's middle."""
        starts = [s[1] for s in self.spans]
        by: Dict[str, List[float]] = {}
        for a, b in stats.gaps(((o.start, o.end) for o in self.ops),
                               *self.window):
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            name = (self.spans[i][0] if i >= 0 and mid <= self.spans[i][2]
                    else "between spans")
            by.setdefault(name, []).append(b - a)
        rows = sorted(by.items(), key=lambda kv: -sum(kv[1]))[:n]
        return [[f"{name}: {len(g)} gaps, longest {max(g)} s", sum(g)]
                for name, g in rows]


class Tracer:
    """Profiles between ``start`` and ``stop``; ``span`` marks a host
    span (a no-op context when no tracer is given: ``span(None, ...)``)."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def warm(self) -> None:
        """One short trace, so that the profiler's own start-up (CUPTI)
        falls in set-up and not in the traced batch."""
        import torch
        self.start()
        torch.ones(1, device="cuda" if torch.cuda.is_available()
                   else "cpu").add_(1)
        self.stop()
        self.prof = None

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def summary(self) -> TraceSummary:
        return summarize(self.prof.profiler.kineto_results.events())


def span(tracer: Optional[Tracer], what: str):
    if tracer is None or tracer.prof is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(PREFIX + what)


def _kind(e) -> str:
    try:
        return str(e.activity_type())
    except AttributeError:
        return ""


def summarize(events) -> TraceSummary:
    """The spans and device operations of a trace's kineto events.
    Times are seconds from the trace's first event (integer ns until
    then, so a kernel of a microsecond keeps its digits)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = list(events)
    if not events:
        raise RuntimeError("the profiler recorded nothing")
    base = min(e.start_ns() for e in events)
    spans, launches, raw = [], {}, []
    for e in events:
        name, kind = e.name(), _kind(e)
        start = (e.start_ns() - base) * 1e-9
        end = (e.start_ns() + e.duration_ns() - base) * 1e-9
        if e.device_type() == cuda:
            if name.startswith(PREFIX) or (kind and kind not in DEVICE_KINDS):
                continue
            raw.append((name, start, end, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], start, end))
        elif e.correlation_id() and (not kind or kind.startswith("cuda")):
            launches[e.correlation_id()] = (name, start)
    spans.sort(key=lambda s: s[1])
    if not spans:
        raise RuntimeError("the trace holds none of the harness's spans")
    starts = [s[1] for s in spans]
    index: Dict[str, int] = {}
    numbered = []
    for name, _, _ in spans:
        numbered.append(index.get(name, 0))
        index[name] = numbered[-1] + 1

    def owner(t: float) -> int:
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= spans[i][2] else -1

    ops = []
    for name, start, end, corr in raw:
        launch = launches.get(corr)
        i = owner(launch[1] if launch else start)
        ops.append(DeviceOp(
            name, start, end, spans[i][0] if i >= 0 else None,
            numbered[i] if i >= 0 else -1,
            bool(launch) and "Graph" in launch[0]))
    if not ops:
        raise RuntimeError("the profiler saw no operation on the device")
    return TraceSummary((spans[0][1], spans[-1][2]), spans, ops)
