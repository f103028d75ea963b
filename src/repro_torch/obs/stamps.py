"""Spans inside the captured prefill and decode graphs, stamped on the
device and laid on a :class:`~repro_torch.obs.trace.TraceRecorder`.

A replay of a CUDA graph runs none of the model's Python, so no host
span can say which module a replay's time went to.  ``models/lm.py``
opens ``span(name)`` at each module boundary (``embed``; the token mixer,
``attention``, ``cross_attention``, ``time_mix`` or ``mamba``, with its
pre-norm; ``ffn`` or ``channel_mix`` with its pre-norm; ``cache``; the
final norm and the logits, ``head``).  With no stamper active, ``span``
returns one shared null context and nothing else happens, so a graph
captured without a recorder is the graph it always was.

While ``launch.serve.compile_step_fns`` captures a graph with a
recorder, each boundary puts one stamp into the graph: a one-thread
kernel (``csrc/stamp.cu``) that writes ``%globaltimer`` (ns) into
``buf[replay % capacity, slot]``; the graph's last stamp advances a
replay counter on the device.  Every kernel of the port is ordered on
the stream, so a stamp lands between the module before it and the one
after it.  A span's end is stamped where the next span begins (or where
the graph ends), so adjacent spans share one stamp, work between two
spans counts to the span before it (``lm`` keeps each residual add
inside its module's span), and a replay's spans tile it from its first
stamp to its last.  Adjacent spans of one
name and layer are one span (``head``: the final norm in
``forward_hidden``, then the logits in ``prefill``).

``Stamper.collect`` reads the stamps and records each replay's spans on
a ``device.prefill`` or ``device.decode`` track, with its ``replay``,
its ``layer`` (in the order a replay runs the layers; None for
``embed``, ``head`` and the cache's stack) and, for decode, its
``pos``.  A graph's ring holds ``CAPACITY`` replays: the caller drains
it (``drain``, or ``collect``) before it fills, outside whatever it
times, since a drain synchronizes; a replay into a full ring raises.
Each replay's host span, ``replay``, goes on the ``host`` track with
the same ``replay`` number.  Everything is on the recorder's clock
(``TraceRecorder.now``: ``perf_counter`` in us).  ``%globaltimer`` is
brought to it by calibrations: a stamp launched alone between two reads
of the host clock around a ``synchronize``, the tightest bracket of 32
kept, its half the error bound; one at start and one at each
``collect``, a stamp converted by the offset interpolated between the
calibrations around it.  The recorder also gets, once, the offset from
its clock to ``torch.profiler``'s (CLOCK_REALTIME ns, ``time.time_ns``):
a host span, a device stamp and a profiler kernel lie on one line.

On the CPU, where ``compile_step_fns`` calls the model eagerly, each
boundary is stamped from the host clock during the call: the same spans,
with no kernel.
Once a graph's table is built, the recorder gets a counter
``<phase>.<name>_spans`` for each name of ``COUNTED`` that the table
holds: how many such spans one replay makes (the hybrid's Mamba layers
and its tied blocks' attention: 81 and 13 for zamba2-7b-instruct).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import TraceRecorder

HOST_TRACK = "host"
CLOCK_TRACK = "clock"
CALIBRATION_TRIES = 32
# replays a graph's ring holds between two reads
CAPACITY = 1024
# span names whose count a replay makes goes on the recorder
COUNTED = ("mamba", "shared_attention")

_NULL = contextlib.nullcontext()
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_stamps", default=None)


def span(name: str, layer: Optional[int] = -1):
    """The span ``name`` of the layer ``next_layer`` opened last (``layer``
    -1, the default), or of no layer (``layer=None``: ``embed``, ``head``,
    the cache's stack); a shared null context unless a stamper is
    active."""
    g = _ACTIVE.get()
    return _NULL if g is None else _Span(g, name, layer)


def next_layer() -> Optional[int]:
    """Open the next layer of the pass; its index (None when no stamper
    is active)."""
    g = _ACTIVE.get()
    if g is None:
        return None
    g.layer += 1
    return g.layer


class _Span:
    def __init__(self, g: "GraphStamps", name: str, layer: Optional[int]):
        self.g, self.name = g, name
        self.layer = g.layer if layer == -1 else layer

    def __enter__(self) -> None:
        self.g.enter(self.name, self.layer)

    def __exit__(self, *exc) -> None:
        self.g.exit()


def _stamp_fn():
    from repro_torch.kernels import _build
    fn = _build.load("stamp").stamp_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_stamp(buf: torch.Tensor, counter: torch.Tensor, capacity: int,
                 n_slots: int, slot: int, last: bool) -> None:
    """One stamp on the current stream: ``buf`` int64 on the card,
    ``counter`` int32 [1] beside it."""
    if buf.dtype != torch.int64 or counter.dtype != torch.int32 \
            or buf.device != counter.device or buf.device.type != "cuda":
        raise ValueError("a stamp needs an int64 buffer and an int32 "
                         "counter on one CUDA device")
    if buf.numel() < capacity * n_slots or slot >= max(n_slots, 1):
        raise ValueError(f"slot {slot} of {n_slots} x {capacity} outside "
                         f"a buffer of {buf.numel()}")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = _stamp_fn()(buf.data_ptr(), counter.data_ptr(), capacity, n_slots,
                      slot, int(last), stream)
    if err != 0:
        raise RuntimeError(f"stamp launch failed: CUDA error {err}")


class GraphStamps:
    """The stamps of one graph (``phase`` prefill or decode): its table of
    spans, built by the passes of the model's code that run under
    ``Stamper.active``, and on the card the ring its replays write.

    A pass is ``plan`` (the eager warm-up before a capture: the stamps
    go to a scratch word, the table is built), ``capture`` (the stamps go
    into the graph; the table must come out as the plan's) or ``host``
    (an eager call on the CPU: each boundary's host time is kept)."""

    def __init__(self, phase: str, device: torch.device, capacity: int):
        self.phase, self.device, self.capacity = phase, device, capacity
        self.table: List[Tuple[str, Optional[int], int, int]] = []
        self.buf: Optional[torch.Tensor] = None
        self.counter: Optional[torch.Tensor] = None
        self.launched = 0     # replays the host launched
        self.drained = 0      # of them, copied from the ring to the host
        # replays not yet recorded: (replay, pos) each, and their stamps,
        # rows of device ns drained from the ring (the card) or of the
        # host's us (the CPU)
        self.meta: List[Tuple[int, Optional[int]]] = []
        self.raw: List[np.ndarray] = []
        self.host_rows: List[List[float]] = []
        self.layer = -1
        self._pass: Optional[dict] = None
        self._scratch: Tuple[torch.Tensor, ...] = ()

    @property
    def n_slots(self) -> int:
        return self.table[-1][3] + 1 if self.table else 0

    # ------------------------------------------------------------ a pass

    def begin(self, mode: str) -> None:
        if self._pass is not None:
            raise RuntimeError(f"{self.phase}: a pass is already open")
        if mode == "capture" and self.buf is None:
            raise RuntimeError(f"{self.phase}: capture before a plan pass")
        self.layer = -1
        self._pass = {"mode": mode, "slot": 0, "table": [], "times": [],
                      "open": None, "pending": None}
        if mode == "plan":
            self._scratch = (torch.zeros(1, dtype=torch.int64,
                                         device=self.device),
                             torch.zeros(1, dtype=torch.int32,
                                         device=self.device))

    def _stamp(self, last: bool = False) -> int:
        p = self._pass
        slot = p["slot"]
        p["slot"] += 1
        if p["mode"] == "host":
            p["times"].append(TraceRecorder.now())
        elif p["mode"] == "plan":
            launch_stamp(*self._scratch, 1, 1, 0, last)
        else:
            launch_stamp(self.buf, self.counter, self.capacity,
                         self.n_slots, slot, last)
        return slot

    def enter(self, name: str, layer: Optional[int]) -> None:
        p = self._pass
        if p["open"] is not None:
            raise RuntimeError(f"span {name!r} opened inside "
                               f"{p['open'][0]!r}")
        pend = p["pending"]
        p["pending"] = None
        if pend is not None and pend[:2] == (name, layer):
            p["open"] = pend
            return
        slot = self._stamp()
        if pend is not None:
            p["table"].append(pend + (slot,))
        p["open"] = (name, layer, slot)

    def exit(self) -> None:
        p = self._pass
        p["pending"], p["open"] = p["open"], None

    def end(self) -> None:
        """Close the pass: the last span's end is its last stamp."""
        p = self._pass
        if p["open"] is not None:
            raise RuntimeError(f"{self.phase}: span {p['open'][0]!r} is "
                               f"still open")
        if p["pending"] is not None:
            p["table"].append(p["pending"] + (self._stamp(last=True),))
        self._pass = None
        if p["mode"] == "plan" or (p["mode"] == "host" and not self.table):
            self.table = p["table"]
        elif p["table"] != self.table:
            raise RuntimeError(f"{self.phase}: the pass's spans differ from "
                               f"the first pass's")
        if p["mode"] == "plan":
            self.buf = torch.zeros((self.capacity, max(self.n_slots, 1)),
                                   dtype=torch.int64, device=self.device)
            self.counter = torch.zeros(1, dtype=torch.int32,
                                       device=self.device)
        elif p["mode"] == "host":
            self.host_rows.append(p["times"])

    def abort(self) -> None:
        self._pass = None


class Stamper:
    """The stamps of the graphs ``compile_step_fns`` captures for one
    recorder, the calibrations that bring them to its clock, and the
    host spans of their replays."""

    def __init__(self, rec: TraceRecorder, device: torch.device):
        self.rec, self.device = rec, device
        self.graphs: List[GraphStamps] = []
        self.replays: Dict[str, int] = {}
        # (device ns, recorder us, half the bracket in us)
        self.calibrations: List[Tuple[int, float, float]] = []
        offset, err = profiler_offset_us()
        rec.instant("profiler_clock", CLOCK_TRACK, offset_us=offset,
                    error_us=err)
        if device.type == "cuda":
            self.calibrate()

    def graph(self, phase: str) -> GraphStamps:
        g = GraphStamps(phase, self.device,
                        CAPACITY if self.device.type == "cuda" else 0)
        self.graphs.append(g)
        return g

    @contextlib.contextmanager
    def active(self, g: GraphStamps, mode: str):
        """Run the model's code of one pass of ``g`` with its spans on."""
        g.begin(mode)
        token = _ACTIVE.set(g)
        try:
            yield
        except BaseException:
            g.abort()
            raise
        finally:
            _ACTIVE.reset(token)
        first = not g.table
        g.end()
        if mode == "plan" or (mode == "host" and first):
            for name in COUNTED:
                n = sum(row[0] == name for row in g.table)
                if n:
                    self.rec.counter(f"{g.phase}.{name}_spans", n)

    def full(self) -> bool:
        """Whether a graph's ring holds as many replays not yet drained
        as it has room for (never on the CPU)."""
        return self.device.type == "cuda" and any(
            g.launched - g.drained >= g.capacity for g in self.graphs)

    @contextlib.contextmanager
    def replay(self, g: GraphStamps, pos: Optional[int] = None):
        """One replay of ``g`` (on the CPU: one eager call of its model
        code, stamped from the host clock), inside a host ``replay``
        span; its number and ``pos`` are kept for its device spans."""
        if self.device.type == "cuda" and g.launched - g.drained \
                >= g.capacity:
            raise RuntimeError(f"{g.phase}: the ring's {g.capacity} "
                               f"replays are not drained yet: drain() "
                               f"first")
        r = self.replays.get(g.phase, 0)
        with self.rec.span("replay", HOST_TRACK, cat="host", graph=g.phase,
                           replay=r):
            if self.device.type == "cuda":
                yield
            else:
                with self.active(g, "host"):
                    yield
        self.replays[g.phase] = r + 1
        g.meta.append((r, None if pos is None else int(pos)))
        g.launched += 1

    # ------------------------------------------------------------ clocks

    def calibrate(self, tries: int = CALIBRATION_TRIES) -> None:
        """One calibration: ``tries`` stamps, each launched alone between
        two host reads around a synchronize; the tightest is kept."""
        dev = self.device
        buf = torch.zeros(tries, dtype=torch.int64, device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        torch.cuda.synchronize(dev)
        brackets = []
        for i in range(tries):
            h0 = time.perf_counter_ns()
            launch_stamp(buf, counter, 1, tries, i, False)
            torch.cuda.synchronize(dev)
            brackets.append((h0, time.perf_counter_ns()))
        stamps = buf.cpu().tolist()
        i = min(range(tries), key=lambda j: brackets[j][1] - brackets[j][0])
        h0, h1 = brackets[i]
        cal = (int(stamps[i]), (h0 + h1) / 2e3, (h1 - h0) / 2e3)
        self.calibrations.append(cal)
        self.rec.instant("device_clock", CLOCK_TRACK, t=cal[1],
                         error_us=cal[2])

    @property
    def error_us(self) -> float:
        """The widest calibration error: the bound on a stamp's place on
        the recorder's clock (0 on the CPU)."""
        return max((c[2] for c in self.calibrations), default=0.0)

    def to_host_us(self, ns: np.ndarray) -> np.ndarray:
        """Device ns (int64) on the recorder's clock (us): the offset
        interpolated between the calibrations around each stamp, that of
        the nearest outside them."""
        cal = sorted(self.calibrations)
        base = cal[0][0]
        x = (np.asarray(ns, dtype=np.int64) - base).astype(np.float64)
        xp = np.array([c[0] - base for c in cal], dtype=np.float64)
        off = np.array([c[1] for c in cal]) - xp / 1e3
        return x / 1e3 + np.interp(x, xp, off)

    # ------------------------------------------------------------ reading

    def drain(self) -> None:
        """Synchronize, calibrate, and copy every graph's replays not yet
        copied from its ring to the host as they are (device ns)."""
        torch.cuda.synchronize(self.device)
        self.calibrate()
        for g in self.graphs:
            if g.launched == g.drained or not g.table:
                g.drained = g.launched
                continue
            done = int(g.counter.item())
            if done != g.launched:
                raise RuntimeError(f"{g.phase}: the device counted {done} "
                                   f"replays, the host launched "
                                   f"{g.launched}")
            rows = torch.arange(g.drained, g.launched) % g.capacity
            g.raw.append(g.buf[rows.to(g.device)].cpu().numpy())
            g.drained = g.launched

    def collect(self) -> int:
        """Record every replay not yet recorded, of every graph, on the
        recorder; returns how many.  On the card it drains the rings
        first."""
        on_card = self.device.type == "cuda"
        if on_card:
            self.drain()
        n = 0
        for g in self.graphs:
            meta, g.meta = g.meta, []
            if not g.table:
                g.raw, g.host_rows = [], []
                continue
            if on_card:
                times = self.to_host_us(np.concatenate(g.raw)) if g.raw \
                    else []
                g.raw = []
            else:
                times, g.host_rows = g.host_rows, []
            for (r, pos), t in zip(meta, times):
                extra = {} if pos is None else {"pos": pos}
                for name, layer, s0, s1 in g.table:
                    self.rec.add_span(name, f"device.{g.phase}",
                                      float(t[s0]), float(t[s1]),
                                      cat="device", replay=r, layer=layer,
                                      **extra)
            n += len(meta)
        return n


def profiler_offset_us(tries: int = 16) -> Tuple[float, float]:
    """(the offset from the recorder's clock to ``torch.profiler``'s,
    CLOCK_REALTIME, in us; half the tightest bracket): profiler time =
    recorder time + offset."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[2] - best[0]:
            best = (a, r, b)
    a, r, b = best
    return (r - (a + b) / 2) / 1e3, (b - a) / 2e3
