"""The port's cost counts (``repro_torch.analysis``) against the
reference's: parameter counts, MODEL_FLOPS and every item of the
analytic HBM-bytes model are exact equality for all ten architectures
over their supported shapes; the device-free checks of
``tests/test_analysis.py`` run again on the port, the roofline's with
the reference's (TPU) rates passed in; and the port's own defaults are
the H100's."""
import pathlib
import re

import pytest

from repro.analysis import bytes_model as jax_bytes
from repro.analysis import flops as jax_flops
from repro.analysis import hlo as jax_hlo
from repro.analysis import roofline as jax_roof
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro_torch.analysis import comm, roofline
from repro_torch.analysis.bytes_model import analytic_bytes
from repro_torch.analysis.flops import (active_param_count, model_flops,
                                        param_count)
from repro_torch.analysis.roofline import compose_pieces, roofline_terms
from repro_torch.configs import SHAPES, get_config, supported_shapes
from repro_torch.configs.all_archs import ALL_ARCH_IDS
from repro_torch.core.gpu_mapping import H100

SRC = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
# the reference's TPU rates, passed in where the port's math is checked
TPU = dict(peak_flops=jax_roof.PEAK_FLOPS, hbm_bw=jax_roof.HBM_BW,
           link_bw=jax_roof.LINK_BW)


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_counts_and_model_flops_match_reference(arch):
    cfg, ref = get_config(arch), jax_config(arch)
    assert param_count(cfg) == jax_flops.param_count(ref)
    assert active_param_count(cfg) == jax_flops.active_param_count(ref)
    assert cfg.param_count() == ref.param_count()
    for name in supported_shapes(cfg):
        assert model_flops(cfg, SHAPES[name]) == \
            jax_flops.model_flops(ref, JAX_SHAPES[name]), name


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_analytic_bytes_match_reference_item_by_item(arch):
    cfg, ref = get_config(arch), jax_config(arch)
    for name in supported_shapes(cfg):
        for chips in (256, 512):
            for ws in (0, 16):
                got = analytic_bytes(cfg, SHAPES[name], chips,
                                     weight_shards=ws)
                want = jax_bytes.analytic_bytes(ref, JAX_SHAPES[name],
                                                chips, weight_shards=ws)
                assert got == want, (name, chips, ws)


def test_shape_bytes_parser():
    assert comm.shape_bytes("bf16[8,128]{1,0}") == 8 * 128 * 2
    assert comm.shape_bytes("f32[4096]") == 4096 * 4
    assert comm.shape_bytes("(f32[2,2], s8[16])") == 16 + 16
    assert comm.shape_bytes("pred[]") == 1
    for s in ("bf16[8,128]{1,0}", "(f32[2,2], s8[16])", "c128[3,5]"):
        assert comm.shape_bytes(s) == jax_hlo.shape_bytes(s)


def test_collective_stats_from_text():
    txt = """
  %ar = f32[1024]{0} all-reduce(%x), replica_groups={}
  %ag.1 = bf16[64,32]{1,0} all-gather(%y), dimensions={0}
  %aa = f32[8,8]{1,0} all-to-all(%z), dimensions={0}
  %cp = (f32[2], f32[2]) collective-permute-start(%w)
  %nothing = f32[4]{0} add(%a, %b)
"""
    s = comm.collective_stats(txt)
    assert s["all-reduce"]["count"] == 1
    assert s["all-reduce"]["bytes"] == 4096
    assert s["all-gather"]["bytes"] == 64 * 32 * 2
    assert "add" not in s
    assert comm.total_collective_bytes(s) == 4096 + 4096 + 256 + 16
    assert s == jax_hlo.collective_stats(txt)
    assert comm.COLLECTIVE_KINDS == jax_hlo.COLLECTIVE_KINDS


def test_param_counts_sane():
    cfg = get_config("qwen2-72b")
    n = param_count(cfg)
    assert 70e9 < n < 85e9, n            # ~72B + embeddings
    assert active_param_count(cfg) == n  # dense: all params active
    moe = get_config("qwen3-moe-235b-a22b")
    n_tot, n_act = param_count(moe), active_param_count(moe)
    assert 200e9 < n_tot < 260e9, n_tot
    assert 15e9 < n_act < 30e9, n_act    # ~22B active


def test_llama4_param_budget():
    cfg = get_config("llama4-maverick-400b-a17b")
    n_tot, n_act = param_count(cfg), active_param_count(cfg)
    assert 360e9 < n_tot < 440e9, n_tot   # ~400B as published
    assert 10e9 < n_act < 25e9, n_act     # ~17B active


def test_model_flops_regimes():
    cfg = get_config("qwen2-0.5b")
    tr = model_flops(cfg, SHAPES["train_4k"])
    pf = model_flops(cfg, SHAPES["prefill_32k"])
    de = model_flops(cfg, SHAPES["decode_32k"])
    assert tr == pytest.approx(6 * active_param_count(cfg) * 256 * 4096)
    assert pf == pytest.approx(2 * active_param_count(cfg) * 32 * 32768)
    assert de == pytest.approx(2 * active_param_count(cfg) * 128)


def test_roofline_terms_math():
    peak = TPU["peak_flops"]
    t = roofline_terms(peak, TPU["hbm_bw"], TPU["link_bw"], **TPU)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["roofline_fraction"] == pytest.approx(1.0)
    t = roofline_terms(peak, 2 * TPU["hbm_bw"], TPU["link_bw"], **TPU)
    assert t["dominant"] == "memory"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    for args in ((1e15, 3e12, 4e10), (2e9, 8e11, 1e12), (0.0, 0.0, 0.0)):
        assert roofline_terms(*args, **TPU) == jax_roof.roofline_terms(*args)


def test_roofline_defaults_are_the_h100s():
    assert roofline.PEAK_FLOPS == H100.peak_flops == 989e12
    assert roofline.HBM_BW == H100.hbm_bw == 3.35e12
    assert roofline.NVLINK_BW == 0.45e12
    t = roofline_terms(989e12, 3.35e12, 0.45e12)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0


def test_no_tpu_rate_in_the_port():
    rate = re.compile(r"(?<![\d.])(197e12|197e\+12|819e9|819e\+9|50e9|"
                      r"50e\+9|197_?000_?000_?000_?000)(?![\d.])")
    hits = [f"{p.relative_to(SRC)}:{i}" for p in sorted(SRC.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if rate.search(line)]
    assert not hits, hits


def test_compose_pieces_multiplies():
    recs = [{"multiplier": 10, "flops": 2.0, "bytes_accessed": 3.0,
             "collective_bytes": 1.0},
            {"multiplier": 1, "flops": 5.0, "bytes_accessed": 7.0,
             "collective_bytes": 0.0}]
    tot = compose_pieces(recs)
    assert tot == {"flops": 25.0, "bytes_accessed": 37.0,
                   "collective_bytes": 10.0}
    assert tot == jax_roof.compose_pieces(recs)


def test_analytic_bytes_regimes():
    cfg = get_config("qwen2-72b")
    tr = analytic_bytes(cfg, SHAPES["train_4k"])
    de = analytic_bytes(cfg, SHAPES["decode_32k"])
    de_tp = analytic_bytes(cfg, SHAPES["decode_32k"], weight_shards=16)
    assert tr["total"] > de["total"]          # train moves more
    # serving TP reads a 16x bigger weight shard per step
    assert de_tp["weights"] == pytest.approx(16 * de["weights"])
    # decode is weight/cache-dominated
    assert (de["weights"] + de["kv_cache_read"]) / de["total"] > 0.5


def test_kernel_bound_is_one_function():
    from repro_torch.tuning import cost_model
    assert cost_model.kernel_bound_s is roofline.kernel_bound_s
    kw = dict(peak_flops=989e12, hbm_bw=3.35e12, mxu_eff=0.85,
              hbm_derate=0.8)
    assert roofline.kernel_bound_s(3.5e10, 2.1e9, **kw) == \
        jax_roof.kernel_bound_s(3.5e10, 2.1e9, **kw)


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_param_bytes_and_optimizer_spec_match_reference(arch):
    from repro.models import lm as jax_lm
    from repro.models import spec as jax_spec
    from repro.optim.adamw import adamw_init_spec as jax_adamw_init_spec
    from repro_torch.models import lm
    from repro_torch.models.spec import is_par, param_bytes, tree_items
    from repro_torch.optim.adamw import adamw_init_spec
    cfg, ref = get_config(arch), jax_config(arch)
    spec, rspec = lm.model_spec(cfg), jax_lm.model_spec(ref)
    assert param_bytes(spec) == jax_spec.param_bytes(rspec)
    opt, ropt = adamw_init_spec(spec), jax_adamw_init_spec(rspec)
    assert param_bytes(opt) == jax_spec.param_bytes(ropt)
    assert all(is_par(p) for _, p in tree_items(opt))
    assert opt["count"].dtype == "int32" and opt["count"].shape == ()
