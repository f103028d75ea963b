"""Deterministic fault injection (the chaos harness): the port's copy of
the reference's ``resilience/chaos.py`` (standard library only).

The paper's thesis is that predictability comes from enumerating every
timing scenario ahead of time; this module applies the same doctrine to
*failures*: a :class:`FaultPlan` is a seeded, step-indexed schedule of
faults that the training loop consults at each step boundary, so a
chaos run is exactly reproducible — rerunning the same plan injects the
same faults at the same steps with the same corrupted bytes.

Fault taxonomy (``Fault.kind``):

==============  ======================================================
``preempt``     SIGTERM-equivalent: trips the PreemptionGuard, the
                loop checkpoints (blocking) and exits cleanly.
``nan_loss``    poisons the loss/gradients of one step with NaN
                (via the train step's ``loss_scale`` input); the
                non-finite guard must discard the update and retry.
``straggler``   sleeps ``duration_s`` inside the step so the
                StragglerMonitor/deadline machinery sees a real
                outlier.
``io_error``    arms a :class:`TransientIOFault` hook on the
                checkpoint manager: the next ``count`` I/O ops raise
                ``OSError`` and must be absorbed by retry_transient.
``ckpt_corrupt``  corrupts the newest on-disk checkpoint
                (``mode`` selects manifest/array/truncate/partial);
                restore must fall back to the previous intact one.
``cache_corrupt`` overwrites the tuning plan cache with garbage;
                the cache must degrade to empty, not crash.
==============  ======================================================

A port chaos run with ``cache_corrupt`` sets ``REPRO_PLAN_CACHE``:
unset, the fault damages the default plan cache,
``~/.cache/repro_torch/tuning_plans.json`` (the file ``PlanCache``
reads), whose tuned plans a later serve relies on.

Every injection is emitted as an ``obs`` instant on the ``chaos``
track (``chaos_<kind>``), so a Chrome trace of a chaos run shows the
fault next to the recovery it provoked.

This module is accelerator-free on purpose (stdlib only): fault
planning must work — and be unit-testable — without a device.
"""
from __future__ import annotations

import json
import pathlib
import random
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

FAULT_KINDS = ("preempt", "nan_loss", "straggler", "io_error",
               "ckpt_corrupt", "cache_corrupt")

CKPT_CORRUPT_MODES = ("manifest", "array", "truncate", "partial",
                      "latest")


@dataclass(frozen=True)
class Fault:
    """One scheduled injection.

    ``step``       the trainer step at whose *start* the fault fires,
    ``kind``       one of :data:`FAULT_KINDS`,
    ``mode``       sub-mode for ``ckpt_corrupt`` (see
                   :func:`corrupt_checkpoint`) / ``cache_corrupt``,
    ``duration_s`` injected stall for ``straggler``,
    ``count``      consecutive failures for ``io_error``.
    """

    step: int
    kind: str
    mode: str = ""
    duration_s: float = 0.0
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; "
                f"taxonomy: {FAULT_KINDS}")


class FaultPlan:
    """Seeded, one-shot schedule of faults.

    ``take(step)`` pops (and records) every not-yet-fired fault
    scheduled at ``step`` — one-shot semantics matter: a ``nan_loss``
    step is *retried* by the trainer, and the retry must see a clean
    step, exactly like a transient bit-flip would behave.
    """

    def __init__(self, faults: Sequence[Fault], seed: int = 0,
                 trace: Optional[Any] = None):
        self._pending: List[Fault] = sorted(faults,
                                            key=lambda f: f.step)
        self.fired: List[Fault] = []
        self.rng = random.Random(seed)
        self.trace = trace          # obs.TraceRecorder (or None)

    def take(self, step: int) -> List[Fault]:
        due = [f for f in self._pending if f.step == step]
        if not due:
            return []
        self._pending = [f for f in self._pending if f.step != step]
        self.fired.extend(due)
        if self.trace is not None:
            for f in due:
                self.trace.instant(
                    f"chaos_{f.kind}", track="chaos", step=f.step,
                    mode=f.mode, duration_s=f.duration_s,
                    count=f.count)
        return due

    @property
    def pending(self) -> List[Fault]:
        return list(self._pending)

    def done(self) -> bool:
        return not self._pending


class TransientIOFault:
    """Injectable I/O fault hook: raises ``OSError`` for the first
    ``count`` matching operations, then heals — the shape of a blip
    that :func:`~repro_torch.resilience.retry.retry_transient` must absorb.

    Attach to ``CheckpointManager.fault_hook`` or
    ``PlanCache.fault_hook``; the hook is called as ``hook(op, path)``
    before each I/O primitive (``op`` in {save_array, write_manifest,
    read_manifest, read_array, read_cache}).
    """

    def __init__(self, count: int = 1, op_match: str = ""):
        self.remaining = count
        self.op_match = op_match
        self.raised = 0

    def __call__(self, op: str, path: Any) -> None:
        if self.remaining > 0 and (not self.op_match
                                   or self.op_match in op):
            self.remaining -= 1
            self.raised += 1
            raise OSError(
                f"injected transient I/O error ({op} on {path})")


def apply_offline_fault(fault: Fault, ckpt_dir=None, cache_path=None,
                        trace: Optional[Any] = None,
                        rng: Optional[random.Random] = None):
    """Apply a disk-damage fault *between* runs (crash-window chaos:
    the damage a dying host leaves behind).  Emits the same
    ``chaos_<kind>`` instant a live :class:`FaultPlan` would, so the
    trace of the recovering run still shows the fault it recovered
    from.  Returns the corrupted checkpoint step (ckpt_corrupt) or
    None."""
    if trace is not None:
        trace.instant(f"chaos_{fault.kind}", track="chaos",
                      step=fault.step, mode=fault.mode)
    if fault.kind == "ckpt_corrupt":
        return corrupt_checkpoint(ckpt_dir, mode=fault.mode or "array",
                                  rng=rng)
    if fault.kind == "cache_corrupt":
        corrupt_plan_cache(cache_path, mode=fault.mode or "garbage")
        return None
    raise ValueError(
        f"{fault.kind!r} is a live fault; schedule it on a FaultPlan")


# --------------------------------------------------------------------
# corruption primitives (the disk-damage half of the taxonomy)


def _newest_step_dir(ckpt_dir: pathlib.Path) -> pathlib.Path:
    dirs = sorted((p for p in ckpt_dir.glob("step_*") if p.is_dir()),
                  key=lambda p: int(p.name.split("_")[1]))
    if not dirs:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return dirs[-1]


def corrupt_checkpoint(ckpt_dir, step: Optional[int] = None,
                       mode: str = "array",
                       rng: Optional[random.Random] = None) -> int:
    """Deterministically damage one checkpoint; returns the step hit.

    modes: ``manifest`` (garbage JSON), ``array`` (flip bytes mid-file
    — caught only by checksums), ``truncate`` (half the array file —
    partial write), ``partial`` (manifest deleted — interrupted save),
    ``latest`` (the latest pointer names a step that does not exist).
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    rng = random.Random(0xBADF00D) if rng is None else rng
    d = (ckpt_dir / f"step_{step}" if step is not None
         else _newest_step_dir(ckpt_dir))
    if not d.is_dir():
        raise FileNotFoundError(d)
    hit = int(d.name.split("_")[1])
    if mode == "manifest":
        (d / "manifest.json").write_bytes(b'{"step": garbage')
    elif mode == "array":
        f = d / "arr_0.npy"
        blob = bytearray(f.read_bytes())
        # flip bytes in the payload, past the .npy header
        for _ in range(8):
            i = rng.randrange(min(128, len(blob) - 1), len(blob))
            blob[i] ^= 0xFF
        f.write_bytes(bytes(blob))
    elif mode == "truncate":
        f = d / "arr_0.npy"
        f.write_bytes(f.read_bytes()[:max(1, f.stat().st_size // 2)])
    elif mode == "partial":
        (d / "manifest.json").unlink()
    elif mode == "latest":
        (ckpt_dir / "latest").write_text(str(hit + 1_000_000))
    else:
        raise ValueError(f"unknown ckpt_corrupt mode {mode!r}; "
                         f"modes: {CKPT_CORRUPT_MODES}")
    return hit


def corrupt_plan_cache(path, mode: str = "garbage") -> None:
    """Damage the tuning plan cache file (created if absent).

    ``garbage`` — not JSON at all; ``schema`` — valid JSON, wrong
    shape.  Either way PlanCache must warn once and act empty.
    """
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if mode == "garbage":
        p.write_bytes(b"\x00\xffnot json at all\x9c")
    elif mode == "schema":
        p.write_text(json.dumps({"schema_version": -1, "plans": 7}))
    else:
        raise ValueError(f"unknown cache_corrupt mode {mode!r}")
