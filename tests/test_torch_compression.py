"""The port's int8 cross-pod gradient mean (``optim/compression.py``)
held against the reference's (``src/repro/optim/compression.py``).

As ``tests/test_compression.py`` runs the reference: on a 2x2 ``pod`` x
``data`` mesh of 4 host devices, pod 0 holding g and pod 1 holding 3g.
The port runs on 4 gloo ranks (``torch_dist.run_ranks``) with g drawn
by numpy from a seed.  Held: the mean within max|3g| / 127 of 2g; each
leaf's result equal to the reference's ``_compress_psum_leaf`` output
to the last bit, fp32 and bf16, for a leaf replicated over ``data``, a
leaf sharded over it (its scale still the whole pod leaf's max, as
GSPMD's ``auto`` axes give the reference) and a plain tensor; the
input returned as it is without a ``pod`` axis or with one of size 1;
and, property-tested, the wire format's per-element bound of scale/2.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import quantize_roundtrip as jax_roundtrip
from repro_torch.optim.compression import quantize_roundtrip
from torch_dist import run_ranks, run_reference

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (pip install repro[test])")
from hypothesis import given, settings, strategies as st  # noqa: E402

# the reference: _compress_psum_leaf over the pod axis of 4 host
# devices, as tests/test_compression.py runs it, for g in fp32 and bf16
_REF = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import auto_axis_types, make_mesh, shard_map
from repro.optim.compression import _compress_psum_leaf
mesh = make_mesh((2, 2), ("pod", "data"), axis_types=auto_axis_types(2))
g = np.load(sys.argv[1])["g"]
fn = shard_map(lambda x: _compress_psum_leaf(x[0], "pod")[None],
               mesh, (P("pod", None, None),), P("pod", None, None))
out = {}
for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
    gd = jnp.asarray(g, dt)
    stacked = jnp.stack([gd, 3 * gd])
    res = jax.jit(fn)(jax.device_put(
        stacked, NamedSharding(mesh, P("pod", None, None))))
    out[name] = np.asarray(res[0].astype(jnp.float32))
    out[name + "_pod1"] = np.asarray(res[1].astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""

# the port on 4 gloo ranks: a tree of leaves, each pod's value g or 3g
_PORT = """
import json
import numpy as np, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.compression import compressed_grad_mean
mesh = make_mesh((2, 2), ("pod", "data"))
k = 1 + 2 * mesh.get_local_rank("pod")
data = mesh.get_local_rank("data")
g = torch.tensor(np.load(OUT / "in.npz")["g"])
gb = g.bfloat16()
rep = [Replicate(), Replicate()]
tree = {
    "f32": DTensor.from_local(g * k, mesh, rep),
    "bf16": DTensor.from_local(gb * k, mesh, rep),
    "f32_data_sharded": DTensor.from_local((g * k).chunk(2)[data], mesh,
                                           [Replicate(), Shard(0)]),
    "f32_plain": g * k,
}
got = compressed_grad_mean(tree, mesh)
full = {name: (t.full_tensor() if isinstance(t, DTensor) else t).float()
        for name, t in got.items()}
types = {name: type(t).__name__ + str(t.dtype) for name, t in got.items()}
same = {}
for shape, names in (((2, 2), ("data", "model")), ((1, 4), ("pod", "data"))):
    other = make_mesh(shape, names)
    same["x".join(map(str, shape))] = compressed_grad_mean(tree, other) is tree
np.savez(OUT / f"port_{RANK}.npz", **{k: v.numpy() for k, v in full.items()})
(OUT / f"port_{RANK}.json").write_text(json.dumps({"types": types,
                                                   "same": same}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference run and one 4-rank port run on the same g."""
    d = tmp_path_factory.mktemp("compression")
    g = (np.random.default_rng(0).standard_normal((8, 16)) * 0.37).astype(
        np.float32)
    np.savez(d / "in.npz", g=g)
    run_reference(_REF, 4, d / "in.npz", d / "ref.npz")
    run_ranks(4, _PORT, d)
    return (g, np.load(d / "ref.npz"),
            [np.load(d / f"port_{r}.npz") for r in range(4)],
            json.loads((d / "port_0.json").read_text()))


def test_compressed_mean_multipod(runs):
    """2-pod mean via the int8 wire format: pod 0 holds g, pod 1 holds
    3g, so the compressed mean is 2g within the quantization bound, on
    every rank alike."""
    g, _, port, _ = runs
    for name in ("f32", "f32_data_sharded", "f32_plain"):
        err = np.max(np.abs(port[0][name] - 2 * g))
        assert err <= np.max(np.abs(3 * g)) / 127.0 + 1e-6, (name, err)
        for r in range(1, 4):
            assert np.array_equal(port[r][name], port[0][name])


@pytest.mark.parametrize("name,ref_name", [
    ("f32", "f32"), ("bf16", "bf16"), ("f32_data_sharded", "f32"),
    ("f32_plain", "f32")])
def test_compressed_mean_equals_the_reference_bit_for_bit(runs, name,
                                                          ref_name):
    """Both round half to even (``torch.round``, ``jnp.round``) and
    compute scale, quotient and mean in the same fp32 order."""
    _, ref, port, _ = runs
    assert np.array_equal(ref[ref_name], ref[ref_name + "_pod1"])
    for r in range(4):
        assert port[r][name].tobytes() == ref[ref_name].tobytes(), (name, r)


def test_leaves_keep_their_type_and_dtype(runs):
    assert runs[3]["types"] == {
        "f32": "DTensortorch.float32", "bf16": "DTensortorch.bfloat16",
        "f32_data_sharded": "DTensortorch.float32",
        "f32_plain": "Tensortorch.float32"}


def test_no_pod_axis_or_one_pod_returns_the_input(runs):
    """As the reference: ``axis not in mesh`` or ``mesh.shape[axis] ==
    1`` returns ``grads`` itself."""
    assert runs[3]["same"] == {"2x2": True, "1x4": True}


@given(seed=st.integers(0, 1000), scale=st.floats(1e-4, 1e3))
@settings(max_examples=30, deadline=None)
def test_quantization_error_bound(seed, scale):
    """The wire format's per-element error is at most scale/2 =
    max|g| / 127 / 2, and the port's round trip is the reference's to
    the bit."""
    g = (scale * np.random.default_rng(seed).standard_normal(256)).astype(
        np.float32)
    gq = quantize_roundtrip(torch.from_numpy(g)).numpy()
    amax = float(np.max(np.abs(g)))
    assert float(np.max(np.abs(gq - g))) <= amax / 127.0 / 2 + 1e-6
    assert gq.tobytes() == np.asarray(jax_roundtrip(jnp.asarray(g))).tobytes()


def test_zero_grads_stay_zero():
    assert torch.all(quantize_roundtrip(torch.zeros(64)) == 0)
