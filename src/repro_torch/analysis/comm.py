"""Collective inventory with byte counts: the port's counterpart of the
reference's ``repro/analysis/hlo.py``.

The reference parses the compiled HLO text and sums the result-shape
bytes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op; ``COLLECTIVE_KINDS``, ``shape_bytes`` and
``collective_stats`` are kept here as copies of that parser.  The
port has no HLO: its dry run traces the step over DTensors whose local
shards are ``meta`` (``launch/dryrun.py``), and ``TracedCost`` reads
what rank 0 would run:

  * each ``c10d_functional`` collective DTensor issues, by kind (the
    reference's names), count and bytes (the output's numel x itemsize,
    as the reference counts result shapes);
  * matrix products partitioned by ``analysis/partition.py``'s rule,
    and partial sums reduced before a nonlinear op;
  * a dtype cast run on the local shard, keeping its placements, and
    an ``index_copy`` (the decode step's cache write) by the rule of
    ``_index_copy``, the same on every torch version;
  * logsumexp as max and sum of exponentials, reduced by all-reduces
    of the reduced shape (not a gather of the whole input);
  * views by the port's own rule (``view_placements``): each mesh dim
    follows its dim into the result, so dims sharded on two mesh dims
    flatten and split back (the batched products an einsum reshapes
    to), the same on every torch version; a mesh dim no dim of the
    result can take is gathered first, and counted (``view_gathers``);
  * FLOPs of the local ops, by ``torch.utils.flop_counter``'s
    registered formulas applied to the local shard shapes: per-device
    FLOPs, replicated work counted in full on every device, as XLA's
    per-device ``cost_analysis`` counts it (a ``FlopCounterMode`` over
    DTensors counts global shapes instead);
  * "bytes accessed": every non-view local op's tensor inputs and
    outputs, unfused — the stand-in for XLA's per-op "bytes accessed".

Ops inside a repeated unit appear once; the roofline composer multiplies
per-unit pieces by their trip counts (``analysis/pieces.py``).
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.partition import EQUATIONS, contract, global_stride
from repro_torch.sharding.rules import redistribute

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
# e.g.:  %all-reduce.1 = bf16[8,128]{1,0} all-reduce(...)
#        ROOT %x = (f32[2], f32[2]) all-to-all(...)
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|\w+\[[^\]]*\](?:\{[^}]*\})?)\s*"
    r"(all-gather-start|all-gather|all-reduce-start|all-reduce|"
    r"reduce-scatter|all-to-all|collective-permute-start|"
    r"collective-permute)\(")


def shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = math.prod(int(d) for d in dims.split(",") if d) if dims else 1
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_stats(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """-> {kind: {count, bytes}} summed over every appearance."""
    stats = defaultdict(lambda: {"count": 0, "bytes": 0})
    for m in _OP_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        kind = kind.replace("-start", "")
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += shape_bytes(shape_str)
    return {k: dict(v) for k, v in stats.items()}


def total_collective_bytes(stats: Dict) -> int:
    return int(sum(v["bytes"] for v in stats.values()))


# c10d_functional op name (without "_coalesced") -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
_INDEX_COPIES = (torch.ops.aten.index_copy_.default,
                 torch.ops.aten.index_copy.default)
_FUNCOL_NS = ("_c10d_functional", "c10d_functional",
              "_c10d_functional_autograd")


def _kind(func) -> str:
    """The reference's name of a c10d_functional collective, or '' (for
    waits and wrappers, which move nothing)."""
    if func.namespace not in _FUNCOL_NS:
        return ""
    name = func._overloadpacket.__name__.removesuffix("_coalesced")
    return _KINDS.get(name, "")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def tensor_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a DTensor counts its local
    shard)."""
    total = 0
    for t in _tensors(x):
        t = getattr(t, "_local_tensor", t)
        total += t.numel() * t.element_size()
    return total


# ops under which a partial sum stays a partial sum (DTensor's rules
# keep it); before any other op it is reduced, as the reference's
# partitioner reduces a partial result before a nonlinear use.  An
# in-place op on a partial sum (the ``add_`` of ``rms_norm``'s
# decomposition) then runs on the reduced copy, whose result its caller
# takes.
_LINEAR = {
    "add", "sub", "neg", "mul", "div", "sum", "mean",
    "view", "_unsafe_view", "reshape", "transpose", "t", "permute",
    "expand", "slice", "select", "squeeze", "unsqueeze", "_to_copy",
    "clone", "detach", "alias", "cat", "stack", "split", "unbind",
    "split_with_sizes", "narrow", "index_select",
}


def _partial_dims(args) -> set:
    return {i for t in args if isinstance(t, DTensor)
            for i, p in enumerate(t.placements) if p.is_partial()}


def _logsumexp(x, dim, keepdim: bool = False):
    """logsumexp as max, then the sum of exponentials: over a sharded
    dim each is a partial result reduced by an all-reduce of the
    reduced shape, as the reference's partitioner computes it (DTensor's
    own rule gathers the whole input first)."""
    m = torch.amax(x, dim, keepdim=True)
    out = torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True)) + m
    return out if keepdim else out.squeeze(dim)


def _index_copy(func, x, dim, index, src):
    """``index_copy(_)`` of rows of ``src`` into ``x`` along ``dim`` (a
    decode step's cache write): ``src`` takes ``x``'s placements but
    on the mesh dims that shard ``dim``, where it is replicated, and the
    write runs on the local shards (rank 0's shard stands for the
    owner's write; ``meta`` checks no index)."""
    mesh, n = x.device_mesh, x.device_mesh.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * n,
                                 run_check=False)
    src = redistribute(src.detach(), pl)
    if isinstance(index, DTensor):
        index = index.full_tensor()
    out = func(x._local_tensor, dim, index, src._local_tensor)
    if func is torch.ops.aten.index_copy_.default:
        return x
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _infer_size(size, numel: int) -> tuple:
    if -1 not in size:
        return size
    known = math.prod(d for d in size if d != -1)
    return tuple(numel // known if d == -1 else d for d in size)


def _groups(a, b) -> list:
    """The dims of shape ``a`` and of shape ``b`` that a reshape maps
    onto each other: [(dims of a, dims of b), ...]."""
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        gi, gj, pa, pb = [i], [j], a[i], b[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                gi.append(i)
                pa *= a[i]
                i += 1
            else:
                gj.append(j)
                pb *= b[j]
                j += 1
        groups.append((gi, gj))
    if groups:
        groups[-1][0].extend(range(i, len(a)))
        groups[-1][1].extend(range(j, len(b)))
    return groups


def view_placements(t: DTensor, size) -> tuple:
    """(placements of ``t`` viewed as ``size``, mesh dims that must be
    gathered first).  Each sharding mesh dim, in mesh order, moves to
    the first dim of the result in its group whose size still divides
    by the mesh dim's.  A merge of dims sharded on two mesh dims and
    the split back (an einsum's batched product) give the local sizes
    of the strided layout they stand for; a split whose factors none
    divides (16 heads into 8 kv heads x 2) gathers.  Partial sums stay
    partial; a strided shard is taken as a shard of its dim."""
    mesh = t.device_mesh
    out = [p if p.is_partial() else Replicate() for p in t.placements]
    left = list(size)
    gather = []
    groups = _groups(tuple(t.shape), tuple(size))
    for m, p in enumerate(t.placements):
        if not isinstance(p, Shard):
            continue
        gj = next(g for gi, g in groups if p.dim in gi)
        d = next((d for d in gj if left[d] % mesh.size(m) == 0), None)
        if d is None:
            gather.append(m)
            continue
        left[d] //= mesh.size(m)
        out[m] = Shard(d)
    return tuple(out), gather


def _reduce_on(args, dims: set) -> list:
    """``args`` with their partial sums on ``dims`` reduced (detached
    first: this runs below autograd, which recorded the op itself)."""
    out = []
    for t in args:
        if isinstance(t, DTensor) and any(
                t.placements[i].is_partial() for i in dims):
            t = redistribute(t.detach(), [
                Replicate() if i in dims and p.is_partial() else p
                for i, p in enumerate(t.placements)])
        out.append(t)
    return out


class TracedCost(TorchDispatchMode):
    """Per-device cost of what runs under it: collectives by kind, FLOPs
    and unfused bytes of the local ops (see the module note)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.view_gathers = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            if func in _VIEWS:
                return self._view(func, args, kwargs)
            if func is torch.ops.aten._to_copy.default and \
                    kwargs.get("device") in (None, args[0].device):
                return self._cast(func, args[0], kwargs)
            if func in _INDEX_COPIES:
                with self:
                    return _index_copy(func, *args, **kwargs)
            if func is torch.ops.aten.logsumexp.default:
                with self:
                    return _logsumexp(*args, **kwargs)
            if func in EQUATIONS:
                with self:
                    return contract(func, args)
            reduce = (_partial_dims(args) if func._overloadpacket.__name__
                      not in _LINEAR else set())
            if reduce:
                with self:
                    return func(*_reduce_on(args, reduce), **kwargs)
            # let DTensor desugar into local ops and collectives, which
            # come back here
            return NotImplemented
        out = func(*args, **kwargs)
        kind = _kind(func)
        if kind:
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += tensor_bytes(out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view:
            self.bytes_accessed += tensor_bytes(args) \
                + tensor_bytes(kwargs) + tensor_bytes(out)
        return out

    def _cast(self, func, x, kwargs):
        """A dtype cast keeps its input's placements (DTensor's own
        rule weighs every placement of the output, which on a 3-D mesh
        takes seconds a call): the cast runs on the local shard."""
        with self:
            local = func(x._local_tensor, **kwargs)
        return DTensor.from_local(local, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    def _view(self, func, args, kwargs):
        """A view of a DTensor by ``view_placements``: on the local
        shard, with each mesh dim moved to the dim of the result that
        its group of dims becomes.  A mesh dim that no dim of the result
        can take evenly (a dim sharded 16 ways split into factors that
        do not divide by 16: GQA heads into (kv heads, group)) is
        gathered first, and counted in ``view_gathers``."""
        t, size = args[0], tuple(args[1])
        size = _infer_size(size, t.numel())
        placements, gather = view_placements(t, size)
        if gather:
            self.view_gathers += 1
            with self:
                t = redistribute(t.detach(), [
                    Replicate() if i in gather else p
                    for i, p in enumerate(t.placements)])
            placements, _ = view_placements(t, size)
        local = list(size)
        for m, p in enumerate(placements):
            if isinstance(p, Shard):
                local[p.dim] //= t.device_mesh.size(m)
        with self:
            out = t._local_tensor.reshape(local)
        return DTensor.from_local(out, t.device_mesh, placements,
                                  run_check=False, shape=size,
                                  stride=global_stride(out, size))

    def record(self) -> Dict:
        colls = {k: dict(v) for k, v in self.collectives.items()}
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collectives": colls,
                "collective_bytes": total_collective_bytes(colls),
                "view_gathers": self.view_gathers}


def traced_stats(fn: Callable, *args) -> Dict:
    """Run ``fn(*args)`` under ``TracedCost``; its record, plus the
    stand-in for XLA's memory analysis: the summed local-shard bytes of
    the arguments and of the outputs."""
    with TracedCost() as mode:
        out = fn(*args)
    rec = mode.record()
    rec["memory"] = {"argument_bytes": tensor_bytes(args),
                     "output_bytes": tensor_bytes(out)}
    return rec
