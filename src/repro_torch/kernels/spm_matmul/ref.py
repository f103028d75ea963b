"""Plain PyTorch version of spm_matmul, written from the reference's
``kernels/spm_matmul/ref.py::matmul_ref``: fp32 products and sums, the
result cast to ``out_dtype`` (A's dtype by default).

The wrapper in ``ops.py`` runs this for CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card.  On the card the fp32
product runs in full fp32 (``compat.resolve_device`` turns TF32 off).
"""
from typing import Optional

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype:
               Optional[torch.dtype] = None, *,
               trans_b: bool = False) -> torch.Tensor:
    """a: [M, K]; b: [K, N], or [N, K] with ``trans_b`` -> [M, N]."""
    out_dtype = out_dtype or a.dtype
    bb = b.t() if trans_b else b
    return torch.matmul(a.float(), bb.float()).to(out_dtype)
