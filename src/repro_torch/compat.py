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

import subprocess
from typing import Optional, Union

import torch

__all__ = ["HOPPER_CAPABILITY", "DTYPES", "resolve_device", "torch_dtype",
           "dtype_name", "require_hopper", "device_identity"]

HOPPER_CAPABILITY = (9, 0)

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
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


def dtype_name(dtype: torch.dtype) -> str:
    """The config string of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``), as plan signatures spell it."""
    return str(dtype).rsplit(".", 1)[-1]


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


def _power_limit_w() -> Optional[float]:
    """Card 0's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_identity() -> dict:
    """What a report's fingerprint records of the card: the CUDA
    version, card 0's name, capability and power limit.  All ``None``
    without a card (a limit ``nvidia-smi`` cannot read is ``None``
    too)."""
    if not torch.cuda.is_available():
        return dict.fromkeys(("cuda", "gpu", "capability",
                              "power_limit_w"))
    major, minor = torch.cuda.get_device_capability(0)
    return {"cuda": torch.version.cuda,
            "gpu": torch.cuda.get_device_name(0),
            "capability": f"{major}.{minor}",
            "power_limit_w": _power_limit_w()}


def all_gather_autograd(t: torch.Tensor, gather_dim: int, group
                        ) -> torch.Tensor:
    """A differentiable all-gather of ``t`` along ``gather_dim`` over
    ``group``: functional collectives' ``all_gather_single_autograd``
    (torch 2.13), ``all_gather_tensor_autograd`` before it took that
    name."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd
    return fn(t, gather_dim, group)
