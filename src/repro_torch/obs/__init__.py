"""Predictability observatory of the port (a copy of the reference's
``obs`` package).

The paper's headline claim is *low execution-time fluctuation*, not raw
speed (§5.1).  ``repro_torch.core`` can simulate jitter and bound it;
this package makes it observable:

- ``trace``        — :class:`TraceRecorder`: span/counter recorder shared
  by the cycle-accurate simulator (explicit cycle timestamps) and the
  wall-clock paths (the serve driver's ``REPRO_TRACE``).
- ``chrome_trace`` — export a recorder to the Chrome trace-event JSON
  format (load in ``chrome://tracing`` / Perfetto).
- ``jitter``       — the paper's fluctuation metrics (mean, p99,
  max−min spread, coefficient of variation, WCET margin) over timing
  samples or seeded simulator sweeps.
- ``report``       — the schema-v1 report, with a fingerprint that names
  the card.
"""
from repro_torch.obs.chrome_trace import to_chrome_trace, write_chrome_trace
from repro_torch.obs.jitter import JitterStats, jitter_stats, simulate_sweep
from repro_torch.obs.report import (BENCH_SCHEMA_VERSION, hw_fingerprint,
                                    make_report, validate_report)
from repro_torch.obs.trace import Counter, Instant, Span, TraceRecorder

__all__ = [
    "BENCH_SCHEMA_VERSION",
    "Counter",
    "Instant",
    "JitterStats",
    "Span",
    "TraceRecorder",
    "hw_fingerprint",
    "jitter_stats",
    "make_report",
    "simulate_sweep",
    "to_chrome_trace",
    "validate_report",
    "write_chrome_trace",
]
