"""Weights and inputs drawn from the run's seed on the device.

One flat buffer per dtype holds every parameter of that dtype and is
filled by one ``normal_`` call from a ``torch.Generator`` on the device;
each parameter is a view of it, scaled or mapped to its init in place.
The same seed gives the same values on the same kind of device; the
program and the reference are handed the same tensors.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
# every parameter starts on a 512-byte boundary at least, as a tensor of
# its own would: the kernels' aligned paths (TMA, 16-byte rows) need it
ALIGN = 256


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number,
    large ones included)."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(device: torch.device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, *parts))
    return g


def _nest(leaves: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in leaves.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


class Weights:
    """The parameters of ``layout`` (``reference/<family>.py::layout``)
    on ``device``: ``tree`` is the nested dict the program and the
    reference take.  ``draw(seed)`` fills them anew in place, so a
    captured graph that reads them stays valid."""

    def __init__(self, layout: List[tuple], device: torch.device):
        self.layout = layout
        self.device = device
        starts, sizes = {}, {}
        for path, shape, dt, _ in layout:
            starts[path] = sizes.get(dt, 0)
            sizes[dt] = -(-(starts[path] + _numel(shape)) // ALIGN) * ALIGN
        self.buffers = {dt: torch.empty(n, dtype=DTYPES[dt], device=device)
                        for dt, n in sizes.items()}
        leaves = {}
        for path, shape, dt, _ in layout:
            a = starts[path]
            leaves[path] = self.buffers[dt][a:a + _numel(shape)].view(shape)
        self.leaves = leaves
        self.tree = _nest(leaves)

    def draw(self, seed: int) -> None:
        for dt, buf in self.buffers.items():
            buf.normal_(generator=generator(self.device, seed, "weights",
                                            dt))
        for path, _, _, (kind, a, b) in self.layout:
            leaf = self.leaves[path]
            if kind == "normal":
                leaf.mul_(b).add_(a)
            elif kind == "uniform":
                u = torch.special.ndtr(leaf.float())
                leaf.copy_(u.mul_(b - a).add_(a))
            else:
                raise ValueError(f"{path}: unknown init {kind!r}")

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers.values())


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
