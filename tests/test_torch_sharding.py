"""The port's sharding rules and shape specs (``repro_torch.sharding``,
``launch/specs.py``, ``models.spec.pspec_tree``) against the
reference's: for every architecture, every supported shape, both
production meshes and the variants baseline, serving_tp, seqpar,
kvshard and seqpar+kvshard, every leaf of the parameter, optimizer-state,
cache and batch specs, the decode token and every activation-sharding
entry resolves to the reference's PartitionSpec entries.

The reference's rules run in-process over a stand-in mesh (its
``spec_for`` needs no devices).  Its batch specs and activation
shardings are ``NamedSharding``s of a real ``Mesh``, so they are
computed once, in a subprocess that sets 512 host devices before JAX
starts, as ``repro.launch.dryrun`` does."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.launch import specs as jax_specs
from repro.models import lm as jax_lm
from repro.models.spec import pspec_tree as jax_pspec_tree
from repro.optim.adamw import adamw_init_spec as jax_adamw_init_spec
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro_torch.configs import SHAPES, get_config, supported_shapes
from repro_torch.configs.all_archs import ALL_ARCH_IDS
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshShape, mesh_tag, production_shape
from repro_torch.models import lm
from repro_torch.models.spec import Par, pspec_tree, tree_items
from repro_torch.optim.adamw import adamw_init_spec
from repro_torch.sharding import make_rules, placements_for
from repro_torch.sharding.rules import axis_names, logical_to_pspec

REPO = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ["baseline", "serving_tp", "seqpar", "kvshard", "seqpar+kvshard"]
MESHES = {"16x16": False, "2x16x16": True}

_REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import SHAPES, get_config, supported_shapes
from repro.configs.all_archs import ALL_ARCH_IDS
from repro.launch.mesh import make_production_mesh
from repro.launch import specs

def ent(ps):
    return [list(e) if isinstance(e, tuple) else e for e in ps]

out = {}
for mname, mp in (("16x16", False), ("2x16x16", True)):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ALL_ARCH_IDS:
        cfg = get_config(arch)
        for sname in supported_shapes(cfg):
            shape = SHAPES[sname]
            for var in sys.argv[1].split(","):
                r = specs.rules_for(mesh, cfg, shape, var)
                rec = {"act": {k: ent(v.spec) for k, v in
                               specs.act_shardings(cfg, shape, r).items()},
                       "token": ent(specs.decode_token_spec(
                           cfg, shape, r).sharding.spec)}
                if shape.kind != "decode":
                    rec["batch"] = {k: ent(v.sharding.spec) for k, v in
                                    specs.batch_specs(cfg, shape, r).items()}
                out["|".join((mname, arch, sname, var))] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_mesh_specs():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                          ",".join(VARIANTS)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


class _RefMesh:
    def __init__(self, ms: MeshShape):
        self.shape = dict(ms.shape)
        self.axis_names = ms.axis_names


def spec_of(placements, mesh, ndim: int):
    """The resolved spec that ``placements`` on ``mesh`` realize
    (``placements_for``'s inverse)."""
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(axis_names(mesh), placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    out = [None if not a else (a[0] if len(a) == 1 else tuple(a))
           for a in dims]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _flat(tree, prefix=""):
    """path -> leaf of a reference spec tree (dicts of PartitionSpecs)."""
    out = {}
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _same_tree(port_tree, ref_tree, what):
    got = {p: _entries(s) for p, s in tree_items(port_tree)}
    want = {p: _entries(s) for p, s in _flat(ref_tree).items()}
    assert got == want, what


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_every_leaf_resolves_to_the_reference_entries(arch, variant,
                                                      ref_mesh_specs):
    cfg, ref = get_config(arch), jax_config(arch)
    pspec = lm.model_spec(cfg)
    for mname, mp in MESHES.items():
        ms = production_shape(mp)
        for sname in supported_shapes(cfg):
            shape, rshape = SHAPES[sname], JAX_SHAPES[sname]
            what = (mname, sname)
            r = specs.rules_for(ms, cfg, shape, variant)
            rr = jax_specs.rules_for(_RefMesh(ms), ref, rshape, variant)
            _same_tree(pspec_tree(pspec, r),
                       jax_pspec_tree(jax_lm.model_spec(ref), rr),
                       ("params",) + what)
            _same_tree(pspec_tree(adamw_init_spec(pspec), r),
                       jax_pspec_tree(jax_adamw_init_spec(
                           jax_lm.model_spec(ref)), rr), ("opt",) + what)
            _same_tree(pspec_tree(specs.cache_pars(cfg, shape, variant), r),
                       jax_pspec_tree(jax_lm.cache_spec(
                           ref, rshape.global_batch, rshape.seq_len,
                           "wincache" in variant), rr), ("cache",) + what)
            want = ref_mesh_specs["|".join((mname, arch, sname, variant))]
            act = specs.act_shardings(cfg, shape, r)
            assert {k: _entries(v) for k, v in act.items()} == \
                {k: _entries(v) for k, v in want["act"].items()}, what
            tok = specs.decode_token_par(cfg, shape)
            assert _entries(r.spec_for(tok.axes, tok.shape)) == \
                _entries(want["token"]), what
            if shape.kind != "decode":
                got = {k: _entries(r.spec_for(p.axes, p.shape))
                       for k, p in specs.batch_pars(cfg, shape).items()}
                assert got == {k: _entries(v)
                               for k, v in want["batch"].items()}, what


def test_rules_regimes_on_a_stand_in_mesh():
    ms = production_shape(True)
    r = make_rules(ms, "train", 256)
    assert r.batch_axes == ("pod", "data")
    assert make_rules(ms, "decode", 128).kv_seq_axes == ("model",)
    assert make_rules(ms, "prefill", 8).batch_axes == ("data",)
    r = make_rules(ms, "decode", 1)
    assert r.batch_axes == () and r.kv_seq_axes == ("data", "model")
    # an axis is used at most once per array; trailing Nones trimmed
    r = make_rules(production_shape(False), "train", 256)
    assert r.spec_for(("experts", "embed", "ffn"), (128, 4096, 1536)) == \
        ("model", "data")
    assert r.spec_for(("embed", "heads", None), (8192, 14, 128)) == \
        ("data",)
    assert mesh_tag(ms) == "pod=2xdata=16xmodel=16"


def test_placements_follow_the_mesh_order():
    ms = production_shape(True)
    assert placements_for((("pod", "data"), None, "model"), ms) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements_for((None, "data"), ms) == \
        (Replicate(), Shard(1), Replicate())
    assert placements_for((), ms) == (Replicate(),) * 3
    for spec in ((("pod", "data"), None, "model"), (None, "data"), ()):
        assert spec_of(placements_for(spec, ms), ms, 3) == spec
    with pytest.raises(ValueError, match="axis order"):
        placements_for((("data", "pod"),), ms)


def test_logical_to_pspec_maps_a_tree():
    r = make_rules(production_shape(False), "train", 256)
    axes = {"a": ("vocab", "embed"), "b": {"c": ("batch", None)}}
    shapes = {"a": (151936, 896), "b": {"c": (256, 4096)}}
    assert logical_to_pspec(axes, shapes, r) == \
        {"a": ("model", "data"), "b": {"c": ("data",)}}


def test_batch_pars_are_the_references_leaves():
    for arch in ("qwen2-0.5b", "whisper-base", "pixtral-12b"):
        cfg = get_config(arch)
        pars = specs.batch_pars(cfg, SHAPES["train_4k"])
        assert all(isinstance(p, Par) for p in pars.values())
        assert sorted(pars) == sorted(
            ["tokens", "targets"]
            + (["frames"] if cfg.family == "encdec" else [])
            + (["patch_embeds"] if cfg.frontend.kind == "patches"
               and cfg.frontend.num_positions else []))
