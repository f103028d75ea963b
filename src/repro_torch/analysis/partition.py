"""The dry run's contraction rule: how a matrix product over DTensors is
partitioned.

DTensor picks among a product's strategies by redistribution cost, and
slicing a replicated operand costs it nothing, so left to itself it
shards replicated work freely (a projection of a batch-sharded
activation by a weight replicated on ``model`` comes out sharded on
``model``), in ways that differ between torch versions.  The
reference's partitioner propagates its operands' shardings instead, and
its per-device cost counts replicated work in full on every device.
``contract`` gives every ``aten.mm`` and ``aten.bmm`` over DTensors
(einsums and matmuls reach the dispatcher as these, in the forward and
in autograd's backward) that rule.  Per mesh dim:

  * a Partial operand is reduced first, and a strided shard (what a
    view leaves of a dim sharded inside a flattened group) gathered;
  * when the operands are sharded on different labels, the larger
    (local bytes) keeps its label and the smaller is all-gathered, the
    least traffic of the two (a layer's weights at training's and
    prefill's token counts: the ZeRO-style gather of
    ``sharding/rules.py``; a decode step's activations);
  * an operand that carries the kept label but is replicated is sliced
    on it (no communication);
  * the output is sharded on the kept label if it survives, Partial if
    it is contracted, replicated if neither operand is sharded.

The product itself then runs on the local shards.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.rules import redistribute

# aten product -> (operand labels, output labels)
EQUATIONS = {
    torch.ops.aten.mm.default: (("mk", "kn"), "mn"),
    torch.ops.aten.bmm.default: (("bmk", "bkn"), "bmn"),
}


def _local_bytes(t: DTensor) -> int:
    return t._local_tensor.numel() * t._local_tensor.element_size()


def global_stride(local: torch.Tensor, shape) -> tuple:
    """Strides of ``shape`` laid out in the dim order of ``local``'s."""
    order = sorted(range(local.dim()), key=lambda d: -local.stride(d))
    stride, step = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = step
        step *= shape[d]
    return tuple(stride)


def contract(func: Callable, operands: Sequence[torch.Tensor]) -> DTensor:
    """``func(*operands)`` for a product in ``EQUATIONS``, partitioned by
    the rule above (plain operands are taken as replicated)."""
    subs, out_subs = EQUATIONS[func]
    mesh = next(t for t in operands if isinstance(t, DTensor)).device_mesh
    n = mesh.ndim
    ops = []
    for t in operands:
        if isinstance(t, DTensor):
            # below autograd, which recorded the product itself: a
            # redistribution here carries no gradient
            t = t.detach()
        else:
            t = DTensor.from_local(t, mesh, [Replicate()] * n,
                                   run_check=False)
        plain = [p if type(p) in (Shard, Replicate) else Replicate()
                 for p in t.placements]
        if plain != list(t.placements):
            t = redistribute(t, plain)
        ops.append(t)
    sizes = {}
    for s, t in zip(subs, ops):
        sizes.update(zip(s, t.shape))
    new = [list(t.placements) for t in ops]
    out_pl = []
    for i in range(n):
        labels = [s[pl[i].dim] if isinstance(pl[i], Shard) else None
                  for s, pl in zip(subs, new)]
        sharded = [j for j, lab in enumerate(labels) if lab is not None]
        keep = None
        if sharded:
            keep = labels[max(sharded, key=lambda j: _local_bytes(ops[j]))]
        for j, s in enumerate(subs):
            if keep is not None and keep in s:
                new[j][i] = Shard(s.index(keep))
            elif labels[j] is not None:
                new[j][i] = Replicate()
        if keep is None:
            out_pl.append(Replicate())
        elif keep in out_subs:
            out_pl.append(Shard(out_subs.index(keep)))
        else:
            out_pl.append(Partial())
    local = []
    for t, pl in zip(ops, new):
        if tuple(pl) != tuple(t.placements):
            t = redistribute(t, pl)
        local.append(t.to_local())
    out = func(*local)
    shape = tuple(sizes[c] for c in out_subs)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=global_stride(out, shape))
