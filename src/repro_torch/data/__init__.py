"""Deterministic synthetic data of the port (the reference's
``data/``)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       make_train_iterator)

__all__ = ["DataConfig", "SyntheticLMDataset", "make_train_iterator"]
