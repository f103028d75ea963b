"""Pieces shared by the reference families: float32 products (TF32 off)
or their float8 control, RMSNorm, and the parameter inits the benchmark
draws.  Imports nothing but torch."""
from __future__ import annotations

import functools

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp32_only(fn):
    """Run ``fn`` without gradients and with every float32 product in
    full float32: TF32 off for cuBLAS and cuDNN, restored after."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        before = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32,
                  torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            with torch.no_grad():
                return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before[0]
            torch.backends.cudnn.allow_tf32 = before[1]
            torch.set_float32_matmul_precision(before[2])
    return wrapped


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude to 448), back in fp32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(FP8).float() * scale


def matmul(precision: str):
    """``x [..., k] @ w [k, n]`` in fp32 from any input dtype; with
    ``fp8``, x rounded per row and w per output column first."""
    if precision == "fp32":
        return lambda x, w: x.float() @ w.float()
    if precision == "fp8":
        return lambda x, w: _fp8(x.float(), -1) @ _fp8(w.float(), 0)
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


# inits: (kind, a, b) read by ``portbench.weights``
def normal(std: float, mean: float = 0.0) -> tuple:
    return ("normal", mean, std)


def ones(std: float = 0.1) -> tuple:
    """Scales near one: N(1, std^2)."""
    return ("normal", 1.0, std)


def uniform(lo: float, hi: float) -> tuple:
    return ("uniform", lo, hi)
