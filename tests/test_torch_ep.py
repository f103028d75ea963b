"""Expert parallelism of the port (``models/ffn.py::moe_ffn_ep``) held
against the reference's (``src/repro/models/ffn.py``, ``shard_map``).

The reference runs as its own tests run it (``tests/test_moe.py``): in
process on one device, and in a subprocess with 8 host devices for the
2x4 ``data`` x ``model`` mesh.  The port runs on gloo ranks of the same
count (``torch_dist.run_ranks``), on the reference's parameters
converted through numpy and inputs drawn with numpy from a seed.  Held:
EP on a 1x1 mesh against the einsum dispatch (1e-5); EP on 2x4, with S
divisible by the model axis (the all-to-all) and not (each rank's
expert slice and a sum over ``model``), against the port's einsum
(2e-5, the reference's own bound) and the reference's EP (1e-5); and
the ``moe_ep`` dry-run variant of a reduced MoE config on a ``fake``
2x4 mesh: status ok, two all-to-alls of the [E, C, d] buffer for each
MoE layer's forward.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import ffn as jffn
from repro.models.spec import init_tree
from repro_torch.configs.base import MoEConfig
from repro_torch.models import ffn as pffn
from torch_dist import REPO, run_ranks, run_reference

MOE_1X1 = dict(num_experts=8, top_k=2, expert_ff=32, group_size=32,
               capacity_factor=8.0)
MOE_2X4 = dict(num_experts=8, top_k=2, expert_ff=64, group_size=64,
               capacity_factor=8.0)

# the reference's EP and einsum on 8 host devices (a 2x4 mesh), its
# parameters, inputs and outputs to an npz
_REF_2X4 = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import auto_axis_types, make_mesh
from repro.configs.base import MoEConfig
from repro.models.ffn import moe_ffn, moe_spec
from repro.models.spec import init_tree
out, S = sys.argv[1], int(sys.argv[2])
mesh = make_mesh((2, 4), ("data", "model"), axis_types=auto_axis_types(2))
xs = NamedSharding(mesh, P("data", None, None))
m = MoEConfig(**%s, shared_expert_ff=int(sys.argv[3]))
p = init_tree(moe_spec(64, m, "swiglu", "float32"), jax.random.PRNGKey(0))
x = np.random.default_rng(1).standard_normal((4, S, 64)).astype(np.float32)
y1, _ = jax.jit(lambda p, x: moe_ffn(p, x, m, "swiglu", "einsum"))(p, x)
y2, _ = jax.jit(lambda p, x: moe_ffn(p, x, m, "swiglu", "ep", xs))(
    p, jax.device_put(x, xs))
leaves = {k: np.asarray(v) for k, v in p.items() if k != "shared"}
leaves.update({"shared_" + k: np.asarray(v)
               for k, v in p.get("shared", {}).items()})
np.savez(out, x=x, ref_einsum=np.asarray(y1), ref_ep=np.asarray(y2),
         **leaves)
""" % repr(MOE_2X4)

# the port on 8 gloo ranks: EP over the 2x4 mesh (x's batch on data,
# the parameters plain and alike on every rank) and the einsum dispatch
_PORT_2X4 = """
import numpy as np, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import MoEConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.ffn import moe_ffn
z = np.load(OUT / "ref.npz")
shared = {k[len("shared_"):]: torch.tensor(z[k]) for k in z.files
          if k.startswith("shared_")}
m = MoEConfig(**%s, shared_expert_ff=(shared["w_gate"].shape[1]
                                      if shared else 0))
p = {k: torch.tensor(z[k]) for k in ("router", "we_gate", "we_up",
                                        "we_down")}
if shared:
    p["shared"] = shared
x = torch.from_numpy(z["x"])
mesh = make_mesh((2, 4), ("data", "model"))
xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
with implicit_replication():
    y_ep, aux_ep = moe_ffn(p, xd, m, "swiglu", "ep", ("data",))
y_ep, aux_ep = y_ep.full_tensor(), aux_ep.full_tensor()
y_einsum, aux = moe_ffn(p, x, m, "swiglu", "einsum")
if RANK == 0:
    np.savez(OUT / "port.npz", ep=y_ep.numpy(), einsum=y_einsum.numpy(),
             aux_ep=float(aux_ep), aux=float(aux))
""" % repr(MOE_2X4)

# the port on one gloo rank: EP over the 1x1 mesh; a DTensor x without
# x_sharding raises
_PORT_1X1 = """
import numpy as np, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import MoEConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.ffn import moe_ffn
z = np.load(OUT / "in.npz")
m = MoEConfig(**%s)
p = {k: torch.tensor(z[k]) for k in ("router", "we_gate", "we_up",
                                        "we_down")}
mesh = make_mesh((1, 1), ("data", "model"))
xd = distribute_tensor(torch.from_numpy(z["x"]), mesh,
                       [Shard(0), Replicate()])
with implicit_replication():
    y, _ = moe_ffn(p, xd, m, "swiglu", "ep", ("data",))
    try:
        moe_ffn(p, xd, m, "swiglu", "ep")
        raised = ""
    except ValueError as e:
        raised = str(e)
np.savez(OUT / "port.npz", ep=y.full_tensor().numpy(), raised=raised)
""" % repr(MOE_1X1)


def _ref_params(m: JaxMoEConfig, d: int) -> dict:
    p = init_tree(jffn.moe_spec(d, m, "swiglu", "float32"),
                  jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


def test_ep_matches_einsum_single_device(tmp_path):
    """``tests/test_moe.py::test_ep_matches_einsum_single_device`` on the
    port: EP on a 1x1 mesh (one gloo rank) within 1e-5 of the einsum
    dispatch, and of the reference's EP on the same inputs."""
    m = JaxMoEConfig(**MOE_1X1)
    p = _ref_params(m, 64)
    x = np.random.default_rng(1).standard_normal((2, 32, 64)).astype(
        np.float32)
    np.savez(tmp_path / "in.npz", x=x, **p)
    run_ranks(1, _PORT_1X1, tmp_path)
    got = np.load(tmp_path / "port.npz")
    y_einsum, _ = pffn.moe_ffn({k: torch.tensor(v) for k, v in
                                p.items()}, torch.from_numpy(x),
                               MoEConfig(**MOE_1X1), "swiglu", "einsum")
    assert np.max(np.abs(got["ep"] - y_einsum.numpy())) < 1e-5
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    y_ref, _ = jffn.moe_ffn(p, x, m, "swiglu", "ep",
                            NamedSharding(mesh, P("data", None, None)))
    assert np.max(np.abs(got["ep"] - np.asarray(y_ref))) < 1e-5
    assert "spec" in str(got["raised"])


@pytest.mark.parametrize("S,shared", [(32, 0), (30, 0), (32, 48)],
                         ids=["all_to_all", "slice_and_sum",
                              "shared_expert"])
def test_ep_multidevice(tmp_path, S, shared):
    """``tests/test_moe.py::test_ep_multidevice`` on the port: 8 ranks,
    a 2x4 data x model mesh, E 8, top 2, f 64, group 64, cf 8, x [4, S,
    64] fp32.  S = 32 splits the tokens over the model axis (the
    all-to-all); S = 30 does not (every model rank runs its experts on
    all its tokens, then a sum over ``model``); a shared expert (as
    llama4's) adds its dense FFN to the routed experts' output."""
    run_reference(_REF_2X4, 8, tmp_path / "ref.npz", S, shared)
    run_ranks(8, _PORT_2X4, tmp_path)
    ref, got = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert got["ep"].shape == (4, S, 64)
    assert np.max(np.abs(got["ep"] - got["einsum"])) < 2e-5
    assert np.max(np.abs(got["ep"] - ref["ref_ep"])) < 1e-5
    # the einsum dispatch itself, the port against the reference
    assert np.max(np.abs(got["einsum"] - ref["ref_einsum"])) < 1e-5
    assert abs(float(got["aux_ep"]) - float(got["aux"])) < 1e-6


def test_ep_on_a_plain_tensor_runs_gather():
    """With no mesh (a plain x, no x_sharding) "ep" runs the gather
    dispatch, as in the reference (``ffn.py``'s "ep without mesh")."""
    m = MoEConfig(**MOE_1X1)
    p = {k: torch.tensor(v) for k, v in
         _ref_params(JaxMoEConfig(**MOE_1X1), 64).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 64)).astype(np.float32))
    y_ep, a_ep = pffn.moe_ffn(p, x, m, "swiglu", "ep")
    y_g, a_g = pffn.moe_ffn(p, x, m, "swiglu", "gather")
    assert torch.equal(y_ep, y_g) and torch.equal(a_ep, a_g)


def test_ep_needs_a_dtensor_for_its_mesh():
    m = MoEConfig(**MOE_1X1)
    p = {k: torch.tensor(v) for k, v in
         _ref_params(JaxMoEConfig(**MOE_1X1), 64).items()}
    with pytest.raises(ValueError, match="DTensor"):
        pffn.moe_ffn(p, torch.zeros(2, 32, 64), m, "swiglu", "ep",
                     x_sharding=("data",))


# the moe_ep variant's prefill of a reduced qwen3-moe on a fake 2x4
# mesh, traced on meta; the record and the arithmetic it is held to
_DRYRUN = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, reduce_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_mesh
from repro_torch.launch.specs import input_specs, run_options
cfg = reduce_config(get_config("qwen3-moe-235b-a22b"), layers=2,
                    d_model=128, vocab=512)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, num_experts=8))
shape = ShapeConfig(name="prefill_small", seq_len=64, global_batch=4,
                    kind="prefill")
init_fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for variant in ("moe_ep", "baseline"):
    opts = run_options(cfg, shape, mesh, variant)
    step = dryrun.step_fn_for(cfg, shape, opts, variant)
    out[variant] = dryrun.trace(step, *input_specs(cfg, shape, mesh,
                                                   variant))
m = cfg.moe
N = (4 // 2) * (64 // 4)                # a shard's tokens
out["buffer_bytes"] = m.num_experts * m.capacity(N) * cfg.d_model * 2
out["moe_layers"] = cfg.num_layers
print(json.dumps(out))
"""


def test_dryrun_moe_ep_cell_counts_its_all_to_alls():
    r = subprocess.run([sys.executable, "-c", _DRYRUN], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                                OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    ep = rec["moe_ep"]["collectives"]
    assert "all-to-all" not in rec["baseline"]["collectives"]
    assert ep["all-to-all"]["count"] == 2 * rec["moe_layers"]
    assert ep["all-to-all"]["bytes"] == \
        2 * rec["moe_layers"] * rec["buffer_bytes"]
    # the local experts' d-slices gathered over data, three leaves a
    # layer
    assert ep["all-gather"]["count"] >= 3 * rec["moe_layers"]
