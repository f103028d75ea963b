"""Chaos on the port (CPU): ``tests/test_chaos_soak.py``'s three
scenarios run through the port's ``Trainer``, each held bit for bit to
an undisturbed port run, and the port's copies of
``resilience/chaos.py`` and ``runtime/fault.py`` held to the reference's
(same faults fired, same corrupted bytes, same plans).
"""
import random
import shutil
import warnings

import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.resilience import chaos as jchaos
from repro.runtime import fault as jfault
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.lm import RunOptions
from repro_torch.models.spec import tree_items
from repro_torch.obs import TraceRecorder, to_chrome_trace
from repro_torch.resilience import (Fault, FaultPlan, TransientIOFault,
                                    apply_offline_fault, corrupt_checkpoint,
                                    corrupt_plan_cache)
from repro_torch.resilience import chaos as pchaos
from repro_torch.runtime import fault as pfault
from repro_torch.runtime.trainer import NonFiniteLossError, Trainer
from repro_torch.tuning.plan_cache import CACHE_PATH_ENV
from test_torch_model import port_cfg


def _trainer(tmp=None, steps=12, **kw):
    cfg = port_cfg(tiny_cfg("qwen2-0.5b", num_layers=1, d_model=64,
                            d_ff=128, vocab_size=64, vocab_pad_multiple=64))
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2,
                       total_steps=steps, seed=0)
    dcfg = DataConfig(vocab_size=64, global_batch=4, seq_len=16)
    opts = RunOptions(chunk_q=16, chunk_kv=16, loss_chunk=16, remat=False)
    return Trainer(cfg, tcfg, dcfg, ckpt_dir=tmp, ckpt_every=3, opts=opts,
                   log_every=0, device="cpu", **kw)


def _bits(tree):
    return [t.view(torch.uint8).numpy().tobytes() if t.dim() else
            t.reshape(1).view(torch.uint8).numpy().tobytes()
            for _, t in tree_items(tree)]


# ------------------------------------------------------ the soak, ported

def test_nan_injection_is_invisible_in_final_params():
    ref = _trainer(steps=6)
    ref.run(6)
    rec = TraceRecorder()
    tr = _trainer(steps=6, chaos=FaultPlan([Fault(2, "nan_loss")]),
                  trace=rec)
    tr.run(6)
    assert tr.nonfinite_steps == [2]
    assert _bits(tr.final_state.params) == _bits(ref.final_state.params)
    assert _bits(tr.final_state.opt_state) == _bits(
        ref.final_state.opt_state)
    names = [i.name for i in rec.instants]
    assert "chaos_nan_loss" in names and "nonfinite_skipped" in names


def test_persistent_nonfinite_aborts():
    tr = _trainer(steps=6, chaos=FaultPlan([Fault(1, "nan_loss")]),
                  max_nonfinite=1)
    with pytest.raises(NonFiniteLossError):
        tr.run(6)


def test_chaos_soak_resumes_bit_exact(tmp_path):
    N = 12
    ref = _trainer(str(tmp_path / "ref"), N)
    ref.run(N)

    rec1 = TraceRecorder()
    plan = FaultPlan([Fault(4, "nan_loss"),
                      Fault(5, "io_error", count=2),  # hits the step-6 save
                      Fault(7, "preempt")], seed=3, trace=rec1)
    tr1 = _trainer(str(tmp_path / "chaos"), N, trace=rec1, chaos=plan)
    tr1.run(N)
    assert plan.done()
    assert tr1.final_state.step == 8         # preempted, exited cleanly
    assert tr1.nonfinite_steps == [4]
    names1 = [i.name for i in rec1.instants]
    for expected in ("chaos_nan_loss", "chaos_io_error", "chaos_preempt",
                     "nonfinite_skipped", "io_retry", "ckpt_saved"):
        assert expected in names1, (expected, names1)

    rec2 = TraceRecorder()
    hit = apply_offline_fault(Fault(8, "ckpt_corrupt", mode="truncate"),
                              ckpt_dir=tmp_path / "chaos", trace=rec2)
    assert hit == 8
    tr2 = _trainer(str(tmp_path / "chaos"), N, trace=rec2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tr2.run(N)
    assert tr2.final_state.step == N
    names2 = [i.name for i in rec2.instants]
    assert {"chaos_ckpt_corrupt", "ckpt_fallback",
            "ckpt_restored"} <= set(names2)
    restored = [i for i in rec2.instants if i.name == "ckpt_restored"]
    assert dict(restored[0].args)["step"] == 6

    assert _bits(tr2.final_state.params) == _bits(ref.final_state.params)
    assert _bits(tr2.final_state.opt_state) == _bits(
        ref.final_state.opt_state)
    events = {e["name"] for rec in (rec1, rec2)
              for e in to_chrome_trace(rec)["traceEvents"]
              if e.get("ph") == "i"}
    assert {"chaos_nan_loss", "chaos_io_error", "chaos_preempt",
            "chaos_ckpt_corrupt", "nonfinite_skipped", "io_retry",
            "ckpt_saved", "ckpt_fallback", "ckpt_restored"} <= events


def test_trainer_records_step_spans_and_loss_counters():
    rec = TraceRecorder()
    tr = _trainer(steps=3, trace=rec)
    hist = tr.run(3)
    spans = [s for s in rec.spans if s.track == "trainer"]
    assert [s.name for s in spans] == ["step0", "step1", "step2"]
    assert [c.value for c in rec.counters if c.name == "loss"] \
        == hist["loss"]
    assert len(hist["step_time_s"]) == 3


def test_cache_corrupt_hits_the_ports_plan_cache(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(CACHE_PATH_ENV, str(path))
    tr = _trainer(steps=2, chaos=FaultPlan([Fault(1, "cache_corrupt")]))
    tr.run(2)
    assert path.read_bytes() == b"\x00\xffnot json at all\x9c"


def test_cache_corrupt_without_the_variable_hits_the_default_cache(
        tmp_path, monkeypatch):
    """``REPRO_PLAN_CACHE`` unset: the fault damages exactly the file
    ``PlanCache`` reads, the default under the expanded ``HOME`` (the
    reference writes under a literal ``./~`` instead, which its cache
    never reads)."""
    from repro_torch.tuning.plan_cache import PlanCache
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv(CACHE_PATH_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    target = PlanCache().path
    assert target == tmp_path / ".cache" / "repro_torch" / "tuning_plans.json"
    tr = _trainer(steps=2, chaos=FaultPlan([Fault(1, "cache_corrupt")]))
    tr.run(2)
    assert target.read_bytes() == b"\x00\xffnot json at all\x9c"
    assert not (tmp_path / "~").exists()
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert len(PlanCache()) == 0


# ------------------------------------------ the copies, against the reference

def test_fault_taxonomy_matches_reference():
    assert pchaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert pchaos.CKPT_CORRUPT_MODES == jchaos.CKPT_CORRUPT_MODES
    with pytest.raises(ValueError):
        Fault(0, "meteor")


def test_fault_plan_fires_as_the_reference():
    faults = [(3, "nan_loss"), (1, "preempt"), (3, "straggler"),
              (7, "io_error")]
    p = FaultPlan([Fault(s, k) for s, k in faults], seed=5)
    j = jchaos.FaultPlan([jchaos.Fault(s, k) for s, k in faults], seed=5)
    for step in range(9):
        assert [(f.step, f.kind) for f in p.take(step)] == \
            [(f.step, f.kind) for f in j.take(step)]
    assert p.done() and j.done() and p.take(3) == []
    assert p.rng.random() == j.rng.random()


def test_transient_io_fault_heals_as_the_reference():
    p, j = TransientIOFault(2, "save"), jchaos.TransientIOFault(2, "save")
    for op in ("read_array", "save_array", "save_array", "save_array"):
        outs = []
        for hook in (p, j):
            try:
                hook(op, "x")
                outs.append(None)
            except OSError:
                outs.append("raised")
        assert outs[0] == outs[1]
    assert p.raised == j.raised == 2


@pytest.mark.parametrize("mode", pchaos.CKPT_CORRUPT_MODES)
def test_corrupt_checkpoint_damages_the_same_bytes(tmp_path, mode):
    src = tmp_path / "src" / "step_3"
    src.mkdir(parents=True)
    np.save(src / "arr_0.npy", np.arange(512, dtype=np.float32))
    (src / "manifest.json").write_text('{"n_leaves": 1}')
    (tmp_path / "src" / "latest").write_text("3")
    for d in ("p", "j"):
        shutil.copytree(tmp_path / "src", tmp_path / d)
    assert corrupt_checkpoint(tmp_path / "p", mode=mode,
                              rng=random.Random(9)) == 3
    assert jchaos.corrupt_checkpoint(tmp_path / "j", mode=mode,
                                     rng=random.Random(9)) == 3
    for f in sorted((tmp_path / "j").rglob("*")):
        twin = tmp_path / "p" / f.relative_to(tmp_path / "j")
        assert twin.exists() == f.exists()
        if f.is_file():
            assert twin.read_bytes() == f.read_bytes(), f.name


@pytest.mark.parametrize("mode", ["garbage", "schema"])
def test_corrupt_plan_cache_writes_the_same_bytes(tmp_path, mode):
    corrupt_plan_cache(tmp_path / "p.json", mode=mode)
    jchaos.corrupt_plan_cache(tmp_path / "j.json", mode=mode)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_apply_offline_fault_refuses_live_faults():
    with pytest.raises(ValueError):
        apply_offline_fault(Fault(0, "nan_loss"))


@pytest.mark.parametrize("n", [0, 1, 3, 7, 16, 17, 64, 100, 512])
@pytest.mark.parametrize("mp", [1, 4, 16])
def test_elastic_remesh_plan_matches_reference(n, mp):
    assert pfault.elastic_remesh_plan(n, mp) == \
        jfault.elastic_remesh_plan(n, mp)


def test_straggler_monitor_matches_reference(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 7.0, 7.0, 8.0])
    times = list(clock)
    rec = TraceRecorder()
    mons = (pfault.StragglerMonitor(trace=rec), jfault.StragglerMonitor())
    out = []
    for mon, mod in zip(mons, (pfault, jfault)):
        it = iter(times)
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(it))
        flags = []
        for step in range(4):
            mon.step_start()
            flags.append(mon.step_end(step))
        out.append((flags, mon.events, mon.mean_step_s))
    assert out[0] == out[1] and out[0][0] == [False, False, True, False]
    assert any(i.name == "straggler" for i in rec.instants)


def test_preemption_guard_trips():
    g = pfault.PreemptionGuard()
    assert not g.preempted
    g.trigger_for_test()
    assert g.preempted
