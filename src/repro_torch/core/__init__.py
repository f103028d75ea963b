"""The paper's execution model on the port's target: the static
schedule IR (``schedule``) and its H100 mapping (``gpu_mapping``)."""
from repro_torch.core.schedule import DMA, Phase, Schedule, core_resource

__all__ = ["DMA", "Phase", "Schedule", "core_resource"]
