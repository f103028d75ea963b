"""The port's copy of the predictability observatory (``obs``) against
the reference's: the same recorder calls give the same Chrome trace,
``jitter_stats`` and ``simulate_sweep`` give the same numbers, the two
schema-v1 reports are each accepted by the other package's validator,
and the fingerprint hashes the same paper configurations while naming
the card (``None`` here, without one)."""
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.obs as jax_obs
from repro.configs.multivic_paper import BY_NAME as JAX_CONFIGS
from repro.core.scheduler import build_matmul_schedule as jax_build
from repro.core.scheduler import MatmulProblem as JaxProblem
import repro_torch.obs as obs
from repro_torch.configs.multivic_paper import BY_NAME
from repro_torch.core.scheduler import MatmulProblem, build_matmul_schedule

REPO = pathlib.Path(__file__).resolve().parent.parent
COMMITTED_REPORTS = sorted(REPO.glob("BENCH_*.json"))


def _record(rec):
    """One fixed sequence of recorder calls, every time explicit."""
    rec.add_span("prefill", "serve", 10.0, 25.5, cat="serve", batch=4,
                 prompt_len=64)
    rec.begin("outer", track="host", t=30.0, step=1)
    rec.begin("inner", track="host", t=31.0)
    rec.end(track="host", t=33.0)
    rec.end(track="host", t=40.0)
    rec.begin("clamped", track="dma", t=50.0)
    rec.end(track="dma", t=45.0)          # ends before it began: clamped
    rec.counter("step_ms", 4.25, t=41.0, track="serve")
    rec.counter("occupancy", 0.5, t=42.0)
    rec.instant("deadline_warn", track="deadline", t=43.0, step=3,
                step_s=0.2)
    rec.instant("mark", t=44.0)
    return rec


def test_recorder_calls_give_the_same_chrome_trace():
    ours = _record(obs.TraceRecorder(time_unit="us"))
    ref = _record(jax_obs.TraceRecorder(time_unit="us"))
    a, b = obs.to_chrome_trace(ours), jax_obs.to_chrome_trace(ref)
    assert a["traceEvents"] == b["traceEvents"]
    assert a["displayTimeUnit"] == b["displayTimeUnit"]
    assert a["otherData"] == dict(b["otherData"],
                                  producer="repro_torch.obs")
    assert (ours.tracks(), ours.busy(), len(ours), ours.open_spans) == \
        (ref.tracks(), ref.busy(), len(ref), ref.open_spans)
    assert [s.dur for s in ours.spans_on("host")] == \
        [s.dur for s in ref.spans_on("host")]


def test_recorder_refuses_what_the_reference_refuses():
    for rec in (obs.TraceRecorder(), jax_obs.TraceRecorder()):
        with pytest.raises(ValueError):
            rec.end(track="nothing open")
        with pytest.raises(AssertionError):
            rec.add_span("backwards", "t", 2.0, 1.0)


def test_wall_clock_span_and_written_trace(tmp_path):
    rec = obs.TraceRecorder()
    with rec.span("work", track="host", k=1):
        pass
    assert rec.open_spans == 0 and rec.spans[0].dur >= 0
    path = obs.write_chrome_trace(rec, str(tmp_path / "t.json"))
    doc = json.loads(pathlib.Path(path).read_text())
    assert doc == json.loads(json.dumps(obs.to_chrome_trace(rec)))


@pytest.mark.parametrize("bound", [None, 0.0, 1.5, 40.0])
@pytest.mark.parametrize("n", [1, 2, 32, 1000])
def test_jitter_stats_match(n, bound):
    x = np.random.default_rng(n).gamma(3.0, 2.0, size=n)
    ours = obs.jitter_stats(x, wcet_bound=bound)
    ref = jax_obs.jitter_stats(x, wcet_bound=bound)
    assert ours.as_dict() == ref.as_dict()
    if bound is not None:
        assert ours.wcet_margin == bound / x.max()


def test_jitter_stats_edge_cases_match():
    for samples in ([0.0, 0.0], [5.0], [-1.0, 1.0]):
        assert obs.jitter_stats(samples, 2.0).as_dict() == \
            jax_obs.jitter_stats(samples, 2.0).as_dict()
    with pytest.raises(ValueError):
        obs.jitter_stats([])


@pytest.mark.parametrize("name", ["baseline-fast", "octa", "hexadeca"])
@pytest.mark.parametrize("include_wcet", [True, False])
def test_simulate_sweep_matches(name, include_wcet):
    prob = dict(m=16, k=128, n=256)
    ours = obs.simulate_sweep(
        build_matmul_schedule(BY_NAME[name], MatmulProblem(**prob)),
        BY_NAME[name], n_runs=10, include_wcet=include_wcet)
    ref = jax_obs.simulate_sweep(
        jax_build(JAX_CONFIGS[name], JaxProblem(**prob)),
        JAX_CONFIGS[name], n_runs=10, include_wcet=include_wcet)
    assert ours.as_dict() == ref.as_dict()
    assert (ours.wcet_margin is not None) == include_wcet


def _rows(stats):
    return [{"name": "serve/qwen2-0.5b/decode", "us_per_call": 4030.5,
             "derived": "batch=4", "jitter": stats.as_dict()},
            {"name": "kernel/spm_matmul", "us_per_call": 12,
             "derived": ""}]


def test_each_validator_accepts_the_others_report():
    x = [1.0, 1.2, 0.9]
    ours = obs.make_report(_rows(obs.jitter_stats(x, 1.0)),
                           generated_at=1.0)
    ref = jax_obs.make_report(_rows(jax_obs.jitter_stats(x, 1.0)),
                              generated_at=1.0)
    assert obs.validate_report(ours) == []
    assert jax_obs.validate_report(ours) == []
    assert obs.validate_report(ref) == []
    # the same document but for the writer and the fingerprint
    strip = ("generated_by", "hw_fingerprint")
    assert {k: v for k, v in ours.items() if k not in strip} == \
        {k: v for k, v in ref.items() if k not in strip}
    assert ours["schema_version"] == jax_obs.BENCH_SCHEMA_VERSION
    assert ours["generated_by"] == "repro_torch"
    assert json.loads(json.dumps(ours)) == ours


@pytest.mark.parametrize("mutate", [
    lambda d: d.update(schema_version=2),
    lambda d: d.pop("generated_at"),
    lambda d: d["hw_fingerprint"].pop("paper_configs_sha256"),
    lambda d: d["benchmarks"][0].update(name=""),
    lambda d: d["benchmarks"][0]["jitter"].pop("p99"),
    lambda d: d["benchmarks"][0]["jitter"].update(cov="high"),
    lambda d: d["benchmarks"].append(3),
], ids=["schema", "generated_at", "sha", "name", "p99", "cov", "row"])
def test_validators_reject_alike(mutate):
    doc = obs.make_report(_rows(obs.jitter_stats([1.0, 2.0], 3.0)))
    mutate(doc)
    errs = obs.validate_report(doc)
    assert errs and errs == jax_obs.validate_report(doc)


@pytest.mark.parametrize("path", COMMITTED_REPORTS,
                         ids=[p.name for p in COMMITTED_REPORTS])
def test_port_validator_accepts_the_committed_reports(path):
    doc = json.loads(path.read_text())
    assert obs.validate_report(doc) == jax_obs.validate_report(doc) == []


def test_fingerprint_hashes_the_same_paper_configs_and_names_no_card():
    ours, ref = obs.hw_fingerprint(), jax_obs.hw_fingerprint()
    assert ours["paper_configs_sha256"] == ref["paper_configs_sha256"]
    for key in ("python", "platform", "machine", "numpy"):
        assert ours[key] == ref[key], key
    assert "jax" not in ours and "backend" not in ours
    assert ours["torch"] == torch.__version__
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert {k: ours[k] for k in ("cuda", "gpu", "capability",
                                 "power_limit_w")} == dict.fromkeys(
        ("cuda", "gpu", "capability", "power_limit_w"))


def test_obs_package_exports_the_references_names():
    assert obs.__all__ == jax_obs.__all__
    assert obs.BENCH_SCHEMA_VERSION == jax_obs.BENCH_SCHEMA_VERSION
