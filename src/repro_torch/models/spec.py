"""Parameter-spec system of the port: one description of every leaf
(shape, logical axes, init style, dtype) from which parameters and
caches are made, converted parameters are checked, and parameter
counts are taken.

A leaf is a ``Par``.  Model modules compose nested dicts of ``Par``;
``stack`` prepends the "stack" dimension for repeated layers.  Trees
are plain nested dicts, walked in sorted-key order (the order
``jax.tree`` flattens the reference's dicts in).

``shape_tree`` is the dry run's realization: ``meta`` tensors where the
reference makes ``ShapeDtypeStruct``s, and with sharding rules
DTensors over a ``DeviceMesh`` whose local shards are ``meta``, so no
memory is ever allocated for the full-size models.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.compat import torch_dtype


@dataclass(frozen=True)
class Par:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | scaled | decay
    scale: float = 0.02
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (and matching ``rest``
    trees).  A leaf is anything that is not a dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` pairs in sorted-key order; paths join keys with
    ``/``."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_from_items(like, leaves: Dict[str, object], prefix: str = ""):
    """The tree shaped like ``like`` whose leaf at each ``tree_items``
    path is ``leaves[path]``."""
    return {k: tree_from_items(v, leaves, f"{prefix}{k}/")
            if isinstance(v, dict) else leaves[f"{prefix}{k}"]
            for k, v in like.items()}


def stack(tree, n: int):
    """Prepend a stack dimension of size n to every Par in tree."""
    return tree_map(
        lambda p: replace(p, shape=(n,) + p.shape, axes=("stack",) + p.axes),
        tree)


def cast(tree, dtype: str):
    return tree_map(lambda p: replace(p, dtype=dtype), tree)


# ---------------------------------------------------------------------------
# realizations


def _init_leaf(p: Par, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dt = torch_dtype(p.dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dt, device=device)
    if p.init == "decay":
        # small negative values; used for SSM/RWKV decay parameters
        u = torch.rand(p.shape, generator=gen, device=device,
                       dtype=torch.float32)
        return (-0.5 - 2.0 * u).to(dt)
    scale = p.scale
    if p.init == "scaled":
        # the reference's rule as it stands: fan-in is the second-to-
        # last dimension, also for 3-D projections such as wq [d, H, hd]
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(p.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (scale * x).to(dt)


def init_tree(tree, gen: torch.Generator,
              device: torch.device) -> dict:
    """Materialize random parameters for a spec tree.  Leaves draw from
    ``gen`` in sorted-path order, so a seed fixes every value."""
    return tree_from_items(tree, {path: _init_leaf(p, gen, device)
                                  for path, p in tree_items(tree)})


def is_par(x) -> bool:
    return isinstance(x, Par)


def meta_tensor(shape, dtype, rules=None, axes=None,
                mesh=None) -> torch.Tensor:
    """A ``meta`` tensor of ``shape``; with ``rules``, a DTensor of that
    global shape on ``mesh`` (default ``rules.mesh``), placed as
    ``rules`` resolve ``axes``, whose local shard is ``meta``."""
    dt = torch_dtype(dtype)
    shape = tuple(shape)
    if rules is None:
        return torch.empty(shape, dtype=dt, device="meta")
    from torch.distributed.tensor import DTensor, Shard
    mesh = rules.mesh if mesh is None else mesh
    placements = rules.placements_for(axes, shape)
    local = list(shape)
    for size, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= size
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(torch.empty(local, dtype=dt, device="meta"),
                              mesh, placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def shape_tree(tree, rules=None, mesh=None) -> dict:
    """``meta`` tensors (DTensors placed by ``rules`` if given) for a
    spec tree: the dry run's stand-ins, nothing allocated."""
    return tree_map(lambda p: meta_tensor(p.shape, p.dtype, rules, p.axes,
                                          mesh), tree)


def pspec_tree(tree, rules) -> dict:
    """Each leaf's resolved spec entries (``rules.spec_for``)."""
    return tree_map(lambda p: rules.spec_for(p.axes, p.shape), tree)


def param_bytes(tree) -> int:
    return int(sum(math.prod(p.shape) * torch_dtype(p.dtype).itemsize
                   for _, p in tree_items(tree)))


def param_count(tree) -> int:
    return int(sum(math.prod(p.shape) for _, p in tree_items(tree)))
