"""The port's elastic re-mesh restore (``checkpoint/manager.py``:
``save`` of DTensor leaves under a process group,
``restore(..., shardings=)``) held to ``tests/test_elastic.py``.

A checkpoint saved from a 2x2 ``data`` x ``model`` mesh of 4 gloo ranks
restores onto the 1x2 mesh of ``elastic_remesh_plan(2,
model_parallel=2)`` on 2 ranks, bit for bit, each leaf a DTensor on the
new mesh; so does a checkpoint written by the reference's own
multi-device save (4 host devices, as ``tests/test_elastic.py`` writes
it).  The ranks run in subprocesses (``torch_dist.run_ranks``).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from torch_dist import run_ranks, run_reference

# the reference's multi-device save, as tests/test_elastic.py runs it
_REF_SAVE = """
import sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint.manager import CheckpointManager
from repro.compat import auto_axis_types, make_mesh
mesh = make_mesh((2, 2), ("data", "model"), axis_types=auto_axis_types(2))
w = jax.device_put(jnp.arange(64.0).reshape(8, 8),
                   NamedSharding(mesh, P("data", "model")))
CheckpointManager(sys.argv[1]).save(7, {"w": w})
"""

# 4 ranks: a fp32 leaf on both mesh dims and a bf16 one on model only,
# saved at step 7 (blocking) and step 8 (in the background, then wait)
_SAVE = """
import numpy as np, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("data", "model"))
z = np.load(OUT / "tree.npz")
tree = {"w": distribute_tensor(torch.tensor(z["w"]), mesh,
                               [Shard(0), Shard(1)]),
        "b": distribute_tensor(torch.tensor(z["b"]).bfloat16(), mesh,
                               [Replicate(), Shard(1)])}
cm = CheckpointManager(str(OUT / "ckpt"))
cm.save(7, tree)
cm.save(8, {"w": tree["w"] * 2, "b": tree["b"]}, blocking=False)
cm.wait()
"""

# 2 ranks: the surviving devices' plan, its mesh, the restore onto it
_RESTORE = """
import json, sys
import numpy as np, torch
from torch.distributed.tensor import DTensor, Shard
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.fault import elastic_remesh_plan
plan = elastic_remesh_plan(WORLD, model_parallel=2)
mesh = make_mesh((plan["data"], plan["model"]), ("data", "model"))
names = json.loads((OUT / "names.json").read_text())
like = {n: torch.zeros(8, 8, dtype=getattr(torch, dt))
        for n, dt in names.items()}
sh = {n: (mesh, (Shard(0), Shard(1))) for n in names}
cm = CheckpointManager(str(OUT / "ckpt"))
out = {}
for step in (None, 7):
    restored, got = cm.restore(like, step=step, shardings=sh)
    for n, t in restored.items():
        full = t.full_tensor()
        out[f"{n}_{got}"] = full.float().numpy()
        out[f"{n}_{got}_bits"] = full.view(
            torch.int16 if full.dtype == torch.bfloat16 else torch.int32
        ).numpy()
        meta = {"dtensor": isinstance(t, DTensor),
                "device": t.to_local().device.type,
                "model": t.device_mesh.size(1),
                "local": list(t.to_local().shape), "plan": plan}
np.savez(OUT / f"restored_{RANK}.npz", **out)
(OUT / f"restored_{RANK}.json").write_text(json.dumps(meta))
"""


def _tree():
    rng = np.random.default_rng(3)
    return {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": rng.standard_normal((8, 8)).astype(np.float32)}


def _restore(tmp_path, names):
    (tmp_path / "names.json").write_text(json.dumps(names))
    run_ranks(2, _RESTORE, tmp_path)
    return ([np.load(tmp_path / f"restored_{r}.npz") for r in range(2)],
            [json.loads((tmp_path / f"restored_{r}.json").read_text())
             for r in range(2)])


def test_checkpoint_survives_remesh(tmp_path):
    """4 ranks save, 2 restore onto ``elastic_remesh_plan(2,
    model_parallel=2)``'s 1x2 mesh: every leaf bit-exact, a DTensor
    whose mesh's model axis has size 2, each rank holding its half; the
    newest step (8, saved in the background) by default, step 7 on
    request."""
    tree = _tree()
    np.savez(tmp_path / "tree.npz", **tree)
    run_ranks(4, _SAVE, tmp_path)
    got, meta = _restore(tmp_path, {"w": "float32", "b": "bfloat16"})
    b16 = torch.tensor(tree["b"]).bfloat16()
    for r in range(2):
        assert np.array_equal(got[r]["w_7_bits"],
                              tree["w"].view(np.int32))
        assert np.array_equal(got[r]["w_8_bits"],
                              (2 * tree["w"]).view(np.int32))
        assert np.array_equal(got[r]["b_7_bits"],
                              b16.view(torch.int16).numpy())
        plan = meta[r].pop("plan")
        assert (plan["data"], plan["model"]) == (1, 2)
        assert meta[r] == {"dtensor": True, "device": "cpu", "model": 2,
                           "local": [8, 4]}


def test_reference_multidevice_checkpoint_restores_remeshed(tmp_path):
    """``tests/test_elastic.py``'s save (the reference, 4 host devices)
    restores in the port's re-mesh path on 2 ranks."""
    run_reference(_REF_SAVE, 4, tmp_path / "ckpt")
    got, meta = _restore(tmp_path, {"w": "float32"})
    want = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r in range(2):
        assert np.array_equal(got[r]["w_7_bits"], want.view(np.int32))
        assert meta[r]["model"] == 2 and meta[r]["dtensor"]


def test_shardings_must_match_the_tree(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"a": torch.zeros(2), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="match"):
        cm.restore({"a": torch.zeros(2), "b": torch.zeros(2)},
                   shardings={"a": None})
