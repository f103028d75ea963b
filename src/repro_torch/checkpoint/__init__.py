"""Checkpointing of the port (the reference's ``checkpoint/``)."""
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)

__all__ = ["CheckpointCorruptError", "CheckpointManager"]
