"""Resilience pieces the port's serving path needs: the WCET-derived
per-step deadline with its record -> warn -> shed ladder.  The chaos
harness and retry helpers come with the training slice."""
from repro_torch.resilience.deadline import DeadlineMonitor

__all__ = ["DeadlineMonitor"]
