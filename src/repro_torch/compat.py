"""The port's one device seam.

Every other module of ``repro_torch`` takes a ``device`` (or a tensor)
from its caller and asks this module what it means; none probes the
hardware itself.  The rules it enforces:

* Entry points default to ``"cuda"`` and run on the CPU only when the
  caller asks for it.  A CUDA request on a machine without a usable
  card raises; nothing falls back to the CPU.
* CUDA means Hopper: the hand-written kernels are built for
  ``sm_90a``, so a card whose capability is not (9, 0) is refused.
* The plain PyTorch versions that run beside the kernels on the card
  compute float32 products in full float32: TF32 is switched off for
  both matmuls and cuDNN convolutions (PyTorch turns it on for the
  latter by default).
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["HOPPER_CAPABILITY", "DTYPES", "resolve_device", "torch_dtype",
           "require_hopper"]

HOPPER_CAPABILITY = (9, 0)

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Map a config dtype string (``"bfloat16"``) to a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have "
                         f"{sorted(DTYPES)}") from None


def require_hopper(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA card of capability (9, 0)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != HOPPER_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has capability {cap}; "
            f"the port's kernels are built for sm_90a {HOPPER_CAPABILITY}")


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """Turn a user's device request into a checked ``torch.device``.

    ``"cpu"`` is taken as asked.  ``"cuda"`` (or ``"cuda:N"``) must be a
    Hopper card; on it TF32 is disabled so the plain versions stay
    full-float32 references for the kernels."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: cpu or cuda")
    require_hopper(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
