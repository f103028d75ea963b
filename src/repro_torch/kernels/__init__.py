"""Kernel registry of the port: the reference's ``kernels/__init__.py``
copied as data.

``KERNEL_REGISTRY`` names each public kernel wrapper and the block
parameters its plans own, as in the reference.

``CONFORMANCE_SHAPES`` are the shapes of the reference's
``conformance_cases()`` for the three kernels; the tests and
``chip_smoke.py`` run them against the port.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One public kernel: where its wrapper lives and which kwargs its
    plans own."""
    name: str
    module: str
    func: str
    plan_params: Tuple[str, ...]


KERNEL_REGISTRY: Dict[str, KernelEntry] = {
    "spm_matmul": KernelEntry(
        "spm_matmul", "repro_torch.kernels.spm_matmul.ops", "matmul",
        ("bm", "bn", "bk")),
    "flash_attention": KernelEntry(
        "flash_attention", "repro_torch.kernels.flash_attention.ops",
        "attention", ("bq", "bk")),
    "wkv6": KernelEntry("wkv6", "repro_torch.kernels.wkv6.ops", "wkv",
                        ("chunk",)),
}


def import_entry(name: str) -> Callable[..., Any]:
    """Resolve a registry row to its public wrapper (lazy)."""
    entry = KERNEL_REGISTRY[name]
    return getattr(importlib.import_module(entry.module), entry.func)


# (m, k, n, bm, bn, bk, dtype)
MATMUL_CONFORMANCE = (
    (128, 128, 128, 128, 128, 0, "float32"),
    (128, 256, 128, 64, 128, 128, "float32"),
    (128, 128, 256, 128, 128, 0, "bfloat16"),
)
# (B, Sq, Sk, H, KV, D, causal, window, dtype)
FLASH_CONFORMANCE = (
    (1, 128, 128, 4, 2, 64, True, 0, "float32"),
    (1, 128, 128, 4, 4, 64, False, 0, "float32"),
    (1, 128, 128, 4, 2, 64, True, 32, "bfloat16"),
)
# (B, S, H, K, chunk, dtype)
WKV_CONFORMANCE = (
    (1, 64, 2, 32, 32, "float32"),
    (2, 64, 2, 64, 32, "float32"),
)
CONFORMANCE_SHAPES = {"spm_matmul": MATMUL_CONFORMANCE,
                      "flash_attention": FLASH_CONFORMANCE,
                      "wkv6": WKV_CONFORMANCE}
