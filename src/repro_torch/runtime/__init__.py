"""The fault-tolerant training runtime of the port (the reference's
``runtime/``)."""
from repro_torch.runtime.fault import (PreemptionGuard, StragglerMonitor,
                                       elastic_remesh_plan)
from repro_torch.runtime.trainer import (NonFiniteLossError, Trainer,
                                         TrainerState)

__all__ = ["NonFiniteLossError", "Trainer", "TrainerState",
           "PreemptionGuard", "StragglerMonitor", "elastic_remesh_plan"]
