"""spm_matmul's split-K decode kernel on the card (``gpu``; skips here).

The kernel (``csrc/spm_matmul.cu``, ``splitk_decode_kernel``: TMA and
wgmma with the tokens as N, 8 or 16) against the plain version at M 1,
4, 8 and 16 over the benchmark's decode products (pixtral-12b's five,
rwkv6-1.6b's seven, the LoRA products with K 32 and 64 among them) and
zamba2-7b's ``in_proj``, whose N of 14,576 ends 48 columns into a
64-column tile.  Each case runs on the split-K path, within the
element-wise allowance of ``kernels.tolerance``, with a dropped K step
caught, and twice to the same bits, in bf16 and in fp32 output.

This file imports no JAX, so the card runs it alone:
``python -m pytest --noconftest -m gpu tests/test_torch_splitk_gpu.py``.
"""
import math

import pytest
import torch

from repro_torch.kernels.spm_matmul import ops
from repro_torch.kernels.tolerance import check

SHAPES = [(5120, 4096), (5120, 1024), (4096, 5120), (5120, 14336),
          (14336, 5120), (2048, 2048), (2048, 7168), (7168, 2048),
          (2048, 160), (32, 2048), (2048, 64), (64, 2048), (3584, 14576)]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run it there")
    from repro_torch.kernels import _build
    _build.build(("spm_matmul",))
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_splitk_kernel_matches_plain(cuda_device, m, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(m * k + n)
    a = torch.randn(m, k, generator=g, device=cuda_device).bfloat16()
    b = (torch.randn(k, n, generator=g, device=cuda_device)
         / math.sqrt(k)).bfloat16()
    dropped = a.clone()
    dropped[:, -16:] = 0
    for out in (None, torch.float32):
        before = ops.matmul.paths["splitk"]
        got = ops.matmul(a, b, out_dtype=out)
        torch.cuda.synchronize()
        assert ops.matmul.paths["splitk"] == before + 1
        assert torch.equal(got, ops.matmul(a, b, out_dtype=out))
        want = ops.matmul_plain(a, b, out)
        assert check(got, want, torch.bfloat16)[0] < 1
        fault = ops.matmul(dropped, b, out_dtype=out)
        assert check(fault, want, torch.bfloat16)[0] > 1
