"""The port's copy of the paper's timing model against the reference's:
the MultiVic configurations, the blocked-matmul scheduler, the timing
model, the discrete-event simulator (with its ``trace=`` hook), the
WCET bounds, the F_max fit, the resource model, the roofline and the
whole-network time-triggered schedule.  The copies are numpy only and
do the same arithmetic in the same order, so every comparison is exact
equality, for every configuration of the paper (Tables 1-2).

The schedules at the paper's 1024^3 problem size back the phase and
WCET checks; the seeded simulator sweeps run a smaller problem so the
file stays quick."""
import dataclasses
import importlib

import numpy as np
import pytest

from repro.configs import multivic_paper as jax_paper
from repro.core import fmax as jax_fmax
from repro.core import network_scheduler as jax_net
from repro.core import resources as jax_res
from repro.core import roofline as jax_roof
from repro.core import scheduler as jax_sched
from repro.core import simulator as jax_sim
from repro.core import timing as jax_timing
from repro.obs import TraceRecorder as JaxRecorder
from repro.obs import to_chrome_trace as jax_chrome
import repro_torch.configs
import repro_torch.core
from repro_torch.configs import multivic_paper as paper
from repro_torch.core import fmax, network_scheduler as net, resources
from repro_torch.core import roofline, scheduler, simulator, timing
from repro_torch.obs import TraceRecorder, to_chrome_trace

# the core packages re-export the function ``wcet`` under the module's name
wcet = importlib.import_module("repro_torch.core.wcet")
jax_wcet = importlib.import_module("repro.core.wcet")

CONFIGS = [c.name for c in paper.PAPER_CONFIGS]
SWEEP = dict(m=16, k=128, n=256)       # the simulator sweeps' problem
SEEDS = range(10)


def _pair(name):
    return jax_paper.BY_NAME[name], paper.BY_NAME[name]


_SCHEDULES = {}


def _paper_schedules(name):
    """Both packages' schedules of the paper's 1024^3 matmul, built once
    per configuration."""
    if name not in _SCHEDULES:
        ref_hw, hw = _pair(name)
        _SCHEDULES[name] = (jax_sched.build_matmul_schedule(ref_hw),
                            scheduler.build_matmul_schedule(hw))
    return _SCHEDULES[name]


def _sweep_schedules(name):
    ref_hw, hw = _pair(name)
    return (jax_sched.build_matmul_schedule(
                ref_hw, jax_sched.MatmulProblem(**SWEEP)),
            scheduler.build_matmul_schedule(
                hw, scheduler.MatmulProblem(**SWEEP)))


def _phases(sched):
    return [dataclasses.asdict(p) for p in sched.phases]


def test_paper_configs_and_constants_match():
    assert [dataclasses.asdict(c) for c in paper.PAPER_CONFIGS] == \
        [dataclasses.asdict(c) for c in jax_paper.PAPER_CONFIGS]
    assert [c.name for c in paper.EVAL_CONFIGS] == \
        [c.name for c in jax_paper.EVAL_CONFIGS]
    for name in ("PAPER_MEDIAN_CYCLES", "PAPER_SECONDS", "MATMUL_N",
                 "ELEM_BYTES", "DDR4_BYTES_PER_CYCLE",
                 "DDR4_WORST_EXTRA_LATENCY", "DDR4_BASE_LATENCY", "KIB",
                 "MIB"):
        assert getattr(paper, name) == getattr(jax_paper, name), name
    assert dataclasses.asdict(timing.DEFAULT_TIMING) == \
        dataclasses.asdict(jax_timing.DEFAULT_TIMING)
    # as in the reference, the configs package does not re-export it
    assert not hasattr(repro_torch.configs, "PAPER_CONFIGS")


def test_core_package_exports_the_references_names():
    import repro.core
    assert repro_torch.core.__all__ == repro.core.__all__


@pytest.mark.parametrize("name", CONFIGS)
def test_matmul_schedule_matches(name):
    ref_hw, hw = _pair(name)
    ref, ours = _paper_schedules(name)
    assert _phases(ours) == _phases(ref)
    assert ours.meta == ref.meta
    assert scheduler.schedule_totals(ours) == \
        jax_sched.schedule_totals(ref)
    for r in (1, 4, 8):
        assert scheduler.spm_plan(hw, scheduler.MatmulProblem(),
                                  rows_per_transfer=r) == \
            jax_sched.spm_plan(ref_hw, jax_sched.MatmulProblem(),
                               rows_per_transfer=r)
    assert scheduler.vl_elems(hw) == jax_sched.vl_elems(ref_hw)


@pytest.mark.parametrize("name", CONFIGS)
def test_simulate_and_run_many_match(name):
    """Seeds 0-9: total cycles, per-resource busy cycles, the worst
    case, ``run_many``'s summary and ``sweep_cycles``' samples."""
    ref_hw, hw = _pair(name)
    ref, ours = _sweep_schedules(name)
    for seed in SEEDS:
        a = simulator.simulate(ours, hw, seed=seed)
        b = jax_sim.simulate(ref, ref_hw, seed=seed)
        assert (a.total_cycles, a.per_resource_busy, a.n_phases) == \
            (b.total_cycles, b.per_resource_busy, b.n_phases)
        assert a.seconds(hw.fmax_hz) == b.seconds(ref_hw.fmax_hz)
    worst = simulator.simulate(ours, hw, worst_case=True)
    assert worst.total_cycles == jax_sim.simulate(
        ref, ref_hw, worst_case=True).total_cycles
    assert simulator.run_many(ours, hw, n_runs=len(SEEDS)) == \
        jax_sim.run_many(ref, ref_hw, n_runs=len(SEEDS))
    assert np.array_equal(
        simulator.sweep_cycles(ours, hw, n_runs=4, seed0=3),
        jax_sim.sweep_cycles(ref, ref_hw, n_runs=4, seed0=3))


@pytest.mark.parametrize("name", ["quad", "hexadeca"])
def test_simulator_trace_hook_matches(name):
    """``simulate(trace=)`` records each phase as the same span on the
    same resource track, with cycle timestamps."""
    ref_hw, hw = _pair(name)
    ref, ours = _sweep_schedules(name)
    rec, ref_rec = TraceRecorder(time_unit="cycles"), \
        JaxRecorder(time_unit="cycles")
    simulator.simulate(ours, hw, seed=5, trace=rec)
    jax_sim.simulate(ref, ref_hw, seed=5, trace=ref_rec)
    assert len(rec.spans) == len(ours.phases)
    assert rec.busy() == ref_rec.busy()
    assert to_chrome_trace(rec)["traceEvents"] == \
        jax_chrome(ref_rec)["traceEvents"]


@pytest.mark.parametrize("name", CONFIGS)
def test_wcet_bounds_match(name):
    ref_hw, hw = _pair(name)
    ref, ours = _paper_schedules(name)
    for ours_fn, ref_fn in ((wcet.wcet, jax_wcet.wcet),
                            (wcet.wcet_closed_form,
                             jax_wcet.wcet_closed_form),
                            (wcet.wcet_serial_bound,
                             jax_wcet.wcet_serial_bound)):
        assert ours_fn(ours, hw) == ref_fn(ref, ref_hw), ours_fn.__name__
    assert wcet.jitter_bound(ours) == jax_wcet.jitter_bound(ref)
    for p, q in zip(ours.phases[:64], ref.phases[:64]):
        assert timing.phase_wcet(p, hw) == jax_timing.phase_wcet(q, ref_hw)
        assert timing.phase_best(p, hw) == jax_timing.phase_best(q, ref_hw)


def test_fmax_fit_and_model_table_match():
    assert np.array_equal(fmax.fit_fmax_model(), jax_fmax.fit_fmax_model())
    assert fmax.model_table() == jax_fmax.model_table()


@pytest.mark.parametrize("name", CONFIGS)
def test_fmax_prediction_matches(name):
    ref_hw, hw = _pair(name)
    assert fmax.predict_fmax_mhz(hw) == jax_fmax.predict_fmax_mhz(ref_hw)
    assert np.array_equal(fmax._features(hw), jax_fmax._features(ref_hw))


@pytest.mark.parametrize("name", CONFIGS)
def test_resources_match(name):
    ref_hw, hw = _pair(name)
    assert resources.total_resources(hw) == \
        jax_res.total_resources(ref_hw)
    assert resources.component_resources(hw) == \
        jax_res.component_resources(ref_hw)


@pytest.mark.parametrize("name", CONFIGS)
def test_roofline_matches(name):
    ref_hw, hw = _pair(name)
    for use_fmax in (True, False):
        assert roofline.config_roofline(hw, use_fmax) == \
            jax_roof.config_roofline(ref_hw, use_fmax)
    for ai in (0.25, 1.0, 8.0, 64.0):
        for spm in (True, False):
            assert roofline.attainable_gflops(hw, ai, spm) == \
                jax_roof.attainable_gflops(ref_hw, ai, spm)


@pytest.mark.parametrize("name", CONFIGS)
def test_network_schedule_matches(name):
    """A small ``mlp``: the whole-network schedule, its time-triggered
    release table, and time-triggered runs for three seeds."""
    ref_hw, hw = _pair(name)
    widths = [64, 128, 32]
    ours = net.build_network_schedule(hw, net.mlp(8, widths))
    ref = jax_net.build_network_schedule(ref_hw, jax_net.mlp(8, widths))
    assert _phases(ours) == _phases(ref)
    assert ours.meta == ref.meta
    rel = net.release_times(ours, hw)
    ref_rel = jax_net.release_times(ref, ref_hw)
    assert np.array_equal(rel, ref_rel)
    for seed in range(3):
        (a, ok), (b, ref_ok) = (
            net.simulate_time_triggered(ours, hw, rel, seed=seed),
            jax_net.simulate_time_triggered(ref, ref_hw, ref_rel,
                                            seed=seed))
        assert (a.total_cycles, a.per_resource_busy, a.n_phases, ok) == \
            (b.total_cycles, b.per_resource_busy, b.n_phases, ref_ok)
    assert net.tt_jitter_bound() == jax_net.tt_jitter_bound()
