"""Logical-axis -> mesh-axis sharding rules (the reference's
``sharding/rules.py``).

This is the datacenter-scale version of the paper's partitioning: weights
are *stationary* in per-device shards (the paper pins B-matrix column
blocks in each core's scratchpad), activations stream through, partial
results reduce.  Rules:

  - big weight matrices are 2D-sharded: feature/head/expert/vocab dims on
    the ``tensor`` ("model") axis, the d_model dim on the ``fsdp``
    ("data") axis (ZeRO-style),
  - activations shard batch on ("pod","data"),
  - long-context decode shards the KV-cache *sequence* on "data",
  - any dim that does not divide its mesh axes is replicated
    (divisibility fallback).

Every rule resolution is per-parameter stateful: a mesh axis is used at
most once per array.

The rules read only a mesh's axis names and sizes, so a
``torch.distributed.DeviceMesh`` (``mesh_dim_names``, a tuple
``shape``) and a plain stand-in (``axis_names``, a ``shape`` dict by
name, as the reference's ``Mesh`` has) both do.  A resolved spec is the
reference's ``PartitionSpec`` entries as a tuple: one entry per dim (a
mesh axis name, a tuple of names, or None), trailing Nones trimmed.
``placements_for`` turns one into DTensor placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

Spec = Tuple[object, ...]

# Logical axis vocabulary used by the model param/activation specs.
#   vocab, embed (d_model inside weights), ffn, heads, kv_heads, head_dim,
#   experts, expert_ff, stack (stacked layers), batch, seq, kv_seq,
#   state, conv_k, group, capacity
# Anything unlisted resolves to replicated.


def axis_names(mesh) -> Tuple[str, ...]:
    """A DeviceMesh's ``mesh_dim_names``, or a stand-in's
    ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, read by name: a DeviceMesh's ``shape`` is
    a tuple in ``mesh_dim_names`` order, a stand-in's a dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


@dataclass(frozen=True)
class ShardingRules:
    mesh: object
    batch_axes: Tuple[str, ...]        # activations' batch dim
    fsdp_axes: Tuple[str, ...]         # weights' d_model dim (ZeRO)
    tensor_axes: Tuple[str, ...]       # weights' feature dims (Megatron)
    kv_seq_axes: Tuple[str, ...] = ()  # KV-cache sequence dim (long ctx)
    # optimization levers (see launch/specs.py variants):
    head_dim_axes: Tuple[str, ...] = ()   # shard head_dim when heads
    #                                       don't divide the model axis
    act_seq_axes: Tuple[str, ...] = ()    # sequence parallelism for the
    #                                       residual stream / remat saves

    def _table(self) -> Dict[str, Tuple[str, ...]]:
        return {
            "vocab": self.tensor_axes,
            "embed": self.fsdp_axes,
            "ffn": self.tensor_axes,
            "heads": self.tensor_axes,
            "kv_heads": self.tensor_axes,
            "head_dim": self.head_dim_axes,
            "experts": self.tensor_axes,
            "expert_ff": self.fsdp_axes,
            "batch": self.batch_axes,
            "kv_seq": self.kv_seq_axes,
            "seq": self.act_seq_axes,
        }

    def axis_size(self, names: Tuple[str, ...]) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[n] for n in names) if names else 1

    def spec_for(self, logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Spec:
        """Resolve one array's logical axes to PartitionSpec entries."""
        table = self._table()
        used: set = set()
        out = []
        for logical, dim in zip(logical_axes, shape):
            entry: Optional[Tuple[str, ...]] = None
            if logical is not None:
                cand = table.get(logical, ())
                if cand and not (set(cand) & used):
                    if dim % self.axis_size(cand) == 0 and dim > 0:
                        entry = cand
            if entry:
                used.update(entry)
                out.append(entry if len(entry) > 1 else entry[0])
            else:
                out.append(None)
        # trim trailing Nones (cosmetic)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements_for(self, logical_axes, shape) -> tuple:
        """DTensor placements on ``self.mesh`` (the reference's
        ``sharding_for``)."""
        return placements_for(self.spec_for(logical_axes, shape), self.mesh)


def placements_for(spec: Spec, mesh) -> tuple:
    """DTensor placements of a resolved spec: a tensor dim on mesh axes
    ("pod", "data") is ``Shard(d)`` on both mesh dims, every other mesh
    dim ``Replicate()``.  DTensor shards in mesh-dim order, which is the
    reference's major-to-minor order of a multi-axis entry; an entry in
    any other order is refused."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def redistribute(t, placements):
    """DTensor ``t`` moved to ``placements`` one mesh dim at a time, in
    a fixed order: partial sums reduced first (while the other dims
    still shard them, so each reduction is smallest), then shards
    gathered, then replicated dims sliced.  DTensor plans a move over
    several mesh dims itself, and its planner orders the steps
    differently between torch versions; one dim at a time, every
    version issues the same collectives."""
    mesh, cur = t.device_mesh, list(t.placements)
    target = list(placements)

    def step(i, p):
        nonlocal t
        cur[i] = p
        t = t.redistribute(mesh, tuple(cur))

    for i, (c, g) in enumerate(zip(cur, target)):
        if c.is_partial() and c != g:
            step(i, g if isinstance(g, Shard) else Replicate())
    for i, (c, g) in enumerate(zip(cur, target)):
        if isinstance(c, Shard) and c != g:
            step(i, Replicate())
    for i, (c, g) in enumerate(zip(cur, target)):
        if c != g:
            step(i, g)
    return t


def make_rules(mesh, shape_kind: str = "train",
               global_batch: int = 0) -> ShardingRules:
    """Build rules for a mesh and a shape regime.

    shape_kind: train | prefill | decode | long_decode
    """
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    has_pod = "pod" in names
    batch: Tuple[str, ...] = (("pod", "data") if has_pod else ("data",))
    fsdp: Tuple[str, ...] = ("data",) if "data" in names else ()
    tensor: Tuple[str, ...] = ("model",) if "model" in names else ()
    kv_seq: Tuple[str, ...] = ()

    if shape_kind == "long_decode" or (
            shape_kind == "decode" and global_batch == 1):
        # batch=1: cannot shard batch; shard the KV sequence over the
        # whole mesh instead (flash-decoding-style partial softmax).
        batch = ()
        kv_seq = tuple(a for a in ("data", "model") if a in names)
    else:
        if shape_kind in ("decode", "prefill"):
            # KV heads rarely divide the model axis (GQA); shard the
            # cache sequence dim on "model" instead.
            kv_seq = ("model",) if "model" in names else ()
        # shard batch only if divisible; else fall back to data-only
        bsz = global_batch
        if bsz and has_pod:
            full = math.prod(sizes[a] for a in batch)
            if bsz % full != 0:
                batch = ("data",)
    return ShardingRules(mesh=mesh, batch_axes=batch, fsdp_axes=fsdp,
                         tensor_axes=tensor, kv_seq_axes=kv_seq)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def logical_to_pspec(tree_axes, tree_shapes, rules: ShardingRules):
    """Map a tree (nested dicts) of logical-axes tuples + shapes to
    resolved specs."""
    if _is_axes(tree_axes):
        return rules.spec_for(tree_axes, tree_shapes)
    return {k: logical_to_pspec(v, tree_shapes[k], rules)
            for k, v in tree_axes.items()}
