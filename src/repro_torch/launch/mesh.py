"""Production mesh definitions (the reference's ``launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group and touches no device.  A mesh needs a process group of
its size; ``init_fake_world`` starts one explicitly, and only the dry
run's entry points (``launch/dryrun.py``, ``launch/roofline_run.py``)
call it.  The production meshes run over the ``fake`` backend (a
``FakeStore``, one process standing for rank 0 of 256 or 512): their
tensors are ``meta`` and their collectives are traced, never sent.
A ``fake`` group moves no data, so a mesh over real tensors runs over
a real group: ``init_world`` starts one rank of it (gloo on the CPU,
NCCL on the card; the ranks meet through a ``FileStore``), and
``make_mesh`` lays a ``DeviceMesh`` of named axes over the running
group, as the reference's tests do with ``compat.make_mesh`` over host
devices.  The process group is global to the process, so tests and
``chip_smoke.py`` run a dry run, or a group of ranks, in subprocesses
of their own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import compat

POD, DATA, MODEL = 2, 16, 16


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices: what the sharding
    rules read (as the reference's tests stand a class in for a
    ``Mesh``)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def production_shape(multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod: (pod=2, data=16, model=16) = 512 chips; the ``pod`` axis
    is pure data parallelism (gradient all-reduce across pods)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"),
                         {"pod": POD, "data": DATA, "model": MODEL})
    return MeshShape(("data", "model"), {"data": DATA, "model": MODEL})


def init_fake_world(n: int) -> None:
    """Start this process's process group as rank 0 of ``n`` over the
    ``fake`` backend, or check that the running one has ``n`` ranks."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is running; this mesh needs {n}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=n,
                            rank=0)


def init_world(backend: str, rank: int, world_size: int,
               store_path: str) -> None:
    """Start this process's process group as ``rank`` of
    ``world_size`` over ``backend`` ("gloo" or "nccl"); the ranks meet
    through a ``FileStore`` at ``store_path`` (no port to pick, so
    groups started side by side never meet by mistake).  Under NCCL the
    rank takes the card of its index."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    if backend == "nccl":
        torch.cuda.set_device(compat.resolve_device(f"cuda:{rank}"))
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)


def _device_mesh(device_type: str, ms: MeshShape):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for a in ms.axis_names:
        n *= ms.shape[a]
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {n}-rank process group must be running: "
                           f"call init_fake_world({n}) first")
    return init_device_mesh(device_type,
                            tuple(ms.shape[a] for a in ms.axis_names),
                            mesh_dim_names=ms.axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh``: (16, 16) over data and model, or
    (2, 16, 16) with pod added, over the ``fake`` group that
    ``init_fake_world`` started."""
    return _device_mesh("cpu", production_shape(multi_pod))


def make_mesh(sizes: Sequence[int], names: Sequence[str],
              device_type: str = "cpu"):
    """A ``DeviceMesh`` of axes ``names`` with ``sizes`` over the process
    group that is running (``init_world``): the reference's
    ``compat.make_mesh``.  Its size must be the group's."""
    return _device_mesh(device_type, MeshShape(tuple(names),
                                               dict(zip(names, sizes))))


def make_host_mesh(device: Optional[str] = None):
    """Degenerate 1x1 mesh on the one device (the CPU unless a device is
    given), over a one-rank group."""
    dev = compat.resolve_device(device or "cpu")
    init_fake_world(1)
    return _device_mesh(dev.type, MeshShape(("data", "model"),
                                            {"data": 1, "model": 1}))


def mesh_tag(mesh) -> str:
    from repro_torch.sharding.rules import axis_names, axis_sizes
    sizes = axis_sizes(mesh)
    return "x".join(f"{n}={sizes[n]}" for n in axis_names(mesh))
