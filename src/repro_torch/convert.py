"""Turn the reference's parameter and cache trees, as numpy arrays, into
the port's tensors.

The two frameworks' random generators never agree, so parity tests
make parameters with the JAX package's ``init_params``, pass them
through numpy, and hand them to the port here.  Every leaf's path,
shape and dtype is checked against the port's own spec; a mismatch
raises.

bf16 arrives as an ``ml_dtypes`` bfloat16 array.  It is read through
its ``uint16`` bit view and re-viewed as ``torch.bfloat16``, so this
module needs no ``ml_dtypes`` import.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.spec import tree_from_items, tree_items

Device = Union[str, torch.device]


def tensor_from_numpy(arr: np.ndarray, device: Device = "cpu"
                      ) -> torch.Tensor:
    """One array -> tensor, bf16 through its bit view."""
    arr = np.array(arr)     # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _from_numpy(spec: dict, tree: dict, device: Device, what: str) -> dict:
    dev = compat.resolve_device(device)
    want = dict(tree_items(spec))
    got = dict(tree_items(tree))
    if set(want) != set(got):
        raise ValueError(
            f"{what} tree mismatch: missing {sorted(set(want) - set(got))},"
            f" unexpected {sorted(set(got) - set(want))}")
    flat = {}
    for path, par in want.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != tuple(par.shape):
            raise ValueError(f"{what} {path}: shape {arr.shape} != spec "
                             f"{par.shape}")
        if arr.dtype.name != par.dtype:
            raise ValueError(f"{what} {path}: dtype {arr.dtype.name} != "
                             f"spec {par.dtype}")
        flat[path] = tensor_from_numpy(arr, dev)
    return tree_from_items(spec, flat)


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: Device = "cuda") -> dict:
    """Reference parameters (numpy leaves) -> the port's parameters."""
    return _from_numpy(lm.model_spec(cfg), tree, device, "param")


def cache_from_numpy(cfg: ModelConfig, tree: dict, batch: int,
                     cache_len: int, device: Device = "cuda",
                     windowed: bool = False) -> dict:
    """Reference KV cache (numpy leaves) -> the port's cache."""
    spec = lm.cache_spec(cfg, batch, cache_len, windowed)
    return _from_numpy(spec, tree, device, "cache")
