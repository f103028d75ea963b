"""Resilience pieces of the port: the WCET-derived per-step deadline
with its record -> warn -> shed ladder, which serve uses, and the
jittered-backoff retry for transient I/O, which the plan cache reads
through.  The chaos harness comes with the training slice."""
from repro_torch.resilience.deadline import DeadlineMonitor
from repro_torch.resilience.retry import RetriesExhausted, retry_transient

__all__ = ["DeadlineMonitor", "RetriesExhausted", "retry_transient"]
