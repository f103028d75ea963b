"""Chrome trace-event exporter.

Serializes a :class:`~repro_torch.obs.trace.TraceRecorder` to the JSON object
format consumed by ``chrome://tracing`` and Perfetto: one complete
('X') event per span with ``ts``/``dur``, 'C' events for counters, 'i'
for instants, plus 'M' metadata events naming each track.  Tracks map
to tids inside a single pid so the resource lanes (dma, core0..N)
render as parallel swimlanes — the schedule Gantt chart the paper draws
by hand.

``ts`` is nominally microseconds; the simulator records cycle
timestamps, which view fine (1 cycle renders as 1 us) — the recorder's
``time_unit`` is carried in ``otherData`` so readers can re-scale.

A copy of the reference's ``obs/chrome_trace.py``;
``tests/test_torch_obs.py`` holds it to the reference, bit for bit.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.trace import TraceRecorder

PID = 1


def _tid_map(rec: TraceRecorder) -> Dict[str, int]:
    tracks = rec.tracks()
    tracks.extend(sorted({c.track for c in rec.counters
                          if c.track not in tracks}))
    return {t: i + 1 for i, t in enumerate(tracks)}


def to_chrome_trace(rec: TraceRecorder) -> Dict[str, Any]:
    """Return the trace as a JSON-serializable dict."""
    tids = _tid_map(rec)
    events: List[Dict[str, Any]] = []
    for track, tid in tids.items():
        events.append({"ph": "M", "pid": PID, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": track}})
    for s in rec.spans:
        events.append({"ph": "X", "pid": PID, "tid": tids[s.track],
                       "name": s.name, "cat": s.cat or "span",
                       "ts": s.start, "dur": s.dur,
                       "args": dict(s.args)})
    for c in rec.counters:
        events.append({"ph": "C", "pid": PID, "tid": tids[c.track],
                       "name": c.name, "ts": c.t,
                       "args": {c.name: c.value}})
    for i in rec.instants:
        events.append({"ph": "i", "pid": PID, "tid": tids[i.track],
                       "name": i.name, "ts": i.t, "s": "t",
                       "args": dict(i.args)})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"time_unit": rec.time_unit,
                      "producer": "repro_torch.obs"},
    }


def write_chrome_trace(rec: TraceRecorder, path: str) -> str:
    """Dump the trace to ``path``; returns the path for chaining."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_chrome_trace(rec), f, indent=None,
                  separators=(",", ":"))
    return path
