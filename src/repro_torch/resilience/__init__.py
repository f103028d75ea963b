"""Resilience of the port: deterministic chaos and the recovery
machinery it tests (the reference's ``resilience/``).

- ``chaos``    — seeded :class:`FaultPlan` fault injection (preemption,
  checkpoint/plan-cache corruption, stragglers, NaN losses, transient
  I/O errors) plus the corruption primitives; every injection is an
  ``obs`` instant so traces show fault and recovery side by side.
- ``retry``    — :func:`retry_transient`, jittered-exponential-backoff
  retry for transient I/O (checkpoint writes, plan-cache reads).
- ``deadline`` — :class:`DeadlineMonitor`, the WCET-derived per-step
  deadline with the record -> warn -> shed degradation ladder used by
  ``launch/serve`` and ``launch/train``.

Device-free: fault planning and degradation policy import no torch.
"""
from repro_torch.resilience.chaos import (CKPT_CORRUPT_MODES, FAULT_KINDS,
                                          Fault, FaultPlan,
                                          TransientIOFault,
                                          apply_offline_fault,
                                          corrupt_checkpoint,
                                          corrupt_plan_cache)
from repro_torch.resilience.deadline import DeadlineMonitor
from repro_torch.resilience.retry import RetriesExhausted, retry_transient

__all__ = [
    "CKPT_CORRUPT_MODES",
    "FAULT_KINDS",
    "DeadlineMonitor",
    "Fault",
    "FaultPlan",
    "RetriesExhausted",
    "TransientIOFault",
    "apply_offline_fault",
    "corrupt_checkpoint",
    "corrupt_plan_cache",
    "retry_transient",
]
