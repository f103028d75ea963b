"""Span/counter trace recorder.

One recorder instance collects timing events from heterogeneous
sources: the discrete-event simulator stamps spans with *explicit*
cycle timestamps (one track per serial resource — the DMA engine and
each worker core), while runtime code (trainer step loop, kernel
conformance harness) uses wall-clock spans via the ``span()`` context
manager.  A recorder therefore carries a ``time_unit`` label so the
exporter and readers know what the numbers mean; mixing clock domains
in one recorder is the caller's mistake, not something we try to
auto-convert.

Spans on the same track must nest properly (begin/end are a stack per
track) — the invariant chrome://tracing assumes for duration events and
the one our tests enforce.

A copy of the reference's ``obs/trace.py``;
``tests/test_torch_obs.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Span:
    """A closed interval of work on one track."""

    name: str
    track: str                 # resource / thread label (serial lane)
    start: float
    end: float
    cat: str = ""
    args: Tuple[Tuple[str, Any], ...] = ()

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass(frozen=True)
class Counter:
    """A sampled scalar time series (chrome 'C' event)."""

    name: str
    t: float
    value: float
    track: str = "counters"


@dataclass(frozen=True)
class Instant:
    """A zero-duration marker (chrome 'i' event)."""

    name: str
    t: float
    track: str = "main"
    args: Tuple[Tuple[str, Any], ...] = ()


class TraceRecorder:
    """Append-only event sink; cheap enough to thread everywhere."""

    def __init__(self, time_unit: str = "us"):
        self.time_unit = time_unit
        self.spans: List[Span] = []
        self.counters: List[Counter] = []
        self.instants: List[Instant] = []
        self._open: Dict[str, List[Tuple[str, float, str,
                                         Tuple[Tuple[str, Any], ...]]]] = {}

    # ------------------------------------------------------------ clock

    @staticmethod
    def now() -> float:
        """Wall clock in microseconds (chrome ts convention)."""
        return time.perf_counter() * 1e6

    # ----------------------------------------------- explicit-time spans

    def add_span(self, name: str, track: str, start: float, end: float,
                 cat: str = "", **args: Any) -> Span:
        """Record an already-closed span (simulator path: caller owns
        the clock and stamps cycle times)."""
        assert end >= start, (name, start, end)
        sp = Span(name, track, float(start), float(end), cat,
                  tuple(sorted(args.items())))
        self.spans.append(sp)
        return sp

    # -------------------------------------------------- begin/end stack

    def begin(self, name: str, track: str = "main",
              t: Optional[float] = None, cat: str = "",
              **args: Any) -> None:
        t = self.now() if t is None else float(t)
        self._open.setdefault(track, []).append(
            (name, t, cat, tuple(sorted(args.items()))))

    def end(self, track: str = "main",
            t: Optional[float] = None) -> Span:
        """Close the innermost open span on ``track``."""
        stack = self._open.get(track)
        if not stack:
            raise ValueError(f"end() with no open span on {track!r}")
        t = self.now() if t is None else float(t)
        name, start, cat, args = stack.pop()
        sp = Span(name, track, start, max(start, t), cat, args)
        self.spans.append(sp)
        return sp

    def span(self, name: str, track: str = "main", cat: str = "",
             **args: Any) -> "_SpanCtx":
        """``with rec.span("step"): ...`` — wall-clock convenience."""
        return _SpanCtx(self, name, track, cat, args)

    @property
    def open_spans(self) -> int:
        return sum(len(s) for s in self._open.values())

    # --------------------------------------------------- scalar streams

    def counter(self, name: str, value: float,
                t: Optional[float] = None,
                track: str = "counters") -> None:
        self.counters.append(Counter(
            name, self.now() if t is None else float(t), float(value),
            track))

    def instant(self, name: str, track: str = "main",
                t: Optional[float] = None, **args: Any) -> None:
        self.instants.append(Instant(
            name, self.now() if t is None else float(t), track,
            tuple(sorted(args.items()))))

    # ------------------------------------------------------- inspection

    def tracks(self) -> List[str]:
        names = {s.track for s in self.spans}
        names.update(i.track for i in self.instants)
        return sorted(names)

    def spans_on(self, track: str) -> List[Span]:
        return [s for s in self.spans if s.track == track]

    def busy(self) -> Dict[str, float]:
        """Summed span duration per track (simulator spans: exactly the
        per-resource busy cycles)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.track] = out.get(s.track, 0.0) + s.dur
        return out

    def __len__(self) -> int:
        return len(self.spans) + len(self.counters) + len(self.instants)


class _SpanCtx:
    def __init__(self, rec: TraceRecorder, name: str, track: str,
                 cat: str, args: Dict[str, Any]):
        self._rec, self._name, self._track = rec, name, track
        self._cat, self._args = cat, args

    def __enter__(self) -> "_SpanCtx":
        self._rec.begin(self._name, self._track, cat=self._cat,
                        **self._args)
        return self

    def __exit__(self, *exc) -> None:
        self._rec.end(self._track)
