"""Optimizer of the port (the reference's ``optim/``)."""
from repro_torch.optim.adamw import (adamw_init, adamw_update, cosine_lr,
                                     global_norm, make_train_step,
                                     value_and_grad)
from repro_torch.optim.compression import quantize_roundtrip

__all__ = ["adamw_init", "adamw_update", "cosine_lr", "global_norm",
           "make_train_step", "quantize_roundtrip", "value_and_grad"]
