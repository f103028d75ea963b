"""The port's autotuner (``repro_torch.tuning``) on the CPU, held to the
reference's (``repro.tuning``).

Every comparison is exact equality: problem signatures, plan selection,
retry delays, cache keys and resolution involve no floating-point model
arithmetic.  On the CPU every wrapper runs its plain version whatever
the plan, so tuning here tests the mechanics (counts, spans, cache,
precedence); what a card would launch is checked through the wrappers'
pure-Python seams (``launch_plan``).  The one test that tunes on the
card is marked ``gpu`` and skips here.

Tier-1 runs with REPRO_AUTOTUNE=0 (conftest); tests that exercise the
cache re-enable it with a tmp cache for each package and reset both
process-wide caches around themselves.
"""
import importlib.util
import json
import pathlib
import random
import warnings

import numpy as np
import pytest
import torch

from repro import tuning as jax_tuning
from repro.obs import jitter_stats as jax_jitter_stats
from repro.resilience import retry as jax_retry
from repro_torch import compat
from repro_torch import tuning
from repro_torch.configs import get_config
from repro_torch.core.gpu_mapping import smem_plan, wkv_smem_plan
from repro_torch.kernels import registered_kernels
from repro_torch.kernels.spm_matmul import ops as mm_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch import serve
from repro_torch.launch import tune as tune_cli
from repro_torch.obs import TraceRecorder, jitter_stats
from repro_torch.resilience import retry as port_retry
from repro_torch.tuning import (DEFAULT_PROBLEMS, AttentionProblem,
                                MatmulProblem, PlanCache, WkvProblem,
                                cache_key, defaults_for,
                                enumerate_candidates, feasibility,
                                measurement_count, parse_problem, plan_sig,
                                resolve_plan, select_plan, tune)
from repro_torch.tuning import model as port_model
from repro_torch.tuning.candidates import matmul_launch, wkv_launch
from repro_torch.tuning.cost_model import kernel_bound_s
from repro_torch.tuning.model import (ModelProblem, default_model_plan,
                                      enumerate_model_candidates,
                                      model_cache_key, problem_config,
                                      resolve_model_plan)
from repro_torch.tuning.model_tuner import tune_model
from repro_torch.tuning.plan_cache import CACHE_SCHEMA_VERSION, env_sig
from repro_torch.tuning.runtime import cached_pins

REPO = pathlib.Path(__file__).resolve().parent.parent
MICRO = dict(arch="qwen2-0.5b", batch=2, prompt_len=32, gen=4, layers=2,
             d_model=64, vocab=256)
BF16 = torch.bfloat16
SM90 = {"cuda": "12.8", "gpu": "NVIDIA H100 80GB HBM3",
        "capability": "9.0", "power_limit_w": 700.0}


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """A fresh plan cache for each package, autotuning on, and both
    process-wide caches reset around the test."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(port_path))
    tuning.reset()
    jax_tuning.reset(jax_tuning.PlanCache(str(ref_path)))
    yield port_path, ref_path
    tuning.reset()
    jax_tuning.reset()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_path_products():
    """(m, k, n, trans_b) of every main-path product of the three
    served models, as chip_smoke.py builds them."""
    return sorted({(m, k, n, tb) for _, m, k, n, tb, dt, _, plan, main
                   in _chip_smoke().matmul_cases()
                   if main and dt == BF16 and not plan})


MAIN_PRODUCTS = _main_path_products()


# ------------------------------------------------------ problems/sigs

@pytest.mark.parametrize("kernel", sorted(DEFAULT_PROBLEMS))
def test_default_problem_sigs_match_reference(kernel):
    assert DEFAULT_PROBLEMS[kernel].sig \
        == jax_tuning.DEFAULT_PROBLEMS[kernel].sig


@pytest.mark.parametrize("kernel,text", [
    ("spm_matmul", "512x512x512"), ("spm_matmul", "4,896,4864"),
    ("flash_attention", "4x256x14x2x64"), ("wkv6", "4x256x32x64")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parsed_problem_sigs_match_reference(kernel, text, dtype):
    assert parse_problem(kernel, text, dtype).sig \
        == jax_tuning.parse_problem(kernel, text, dtype).sig
    with pytest.raises(ValueError):
        parse_problem(kernel, "4x4")


def test_trans_b_problems_get_their_own_sig():
    plain = MatmulProblem(4, 3840, 262_144, "bfloat16")
    tb = parse_problem("spm_matmul", "4x3840x262144t", "bfloat16")
    assert tb == MatmulProblem(4, 3840, 262_144, "bfloat16", trans_b=True)
    assert tb.sig == plain.sig + "-tb"
    assert plain.sig == jax_tuning.MatmulProblem(
        4, 3840, 262_144, "bfloat16").sig


@pytest.mark.parametrize("fields", [
    MICRO, dict(MICRO, layers=0), dict(MICRO, dtype="bfloat16"),
    dict(arch="rwkv6-1.6b", batch=4, prompt_len=256, gen=32, layers=0)])
def test_model_problem_sig_matches_reference(fields):
    port, ref = ModelProblem(**fields), jax_tuning.ModelProblem(**fields)
    assert port.sig == ref.sig
    text = f"{port.batch}x{port.prompt_len}x{port.gen}"
    kw = {k: v for k, v in fields.items()
          if k not in ("arch", "batch", "prompt_len", "gen")}
    assert tuning.parse_model_problem(port.arch, text, **kw) == port


def test_public_names_match_reference():
    assert sorted(tuning.__all__) == sorted(jax_tuning.__all__)
    assert tuning.MODEL_NS == jax_tuning.MODEL_NS
    assert tuning.MEASURE_TRACK == jax_tuning.MEASURE_TRACK
    assert registered_kernels() == sorted(tuning.TUNE_SPECS)


@pytest.mark.parametrize("plan", [{"bm": 128, "bn": 256, "bk": 0},
                                  {"chunk": 64}, {}])
def test_plan_sig_matches_reference(plan):
    assert plan_sig(plan) == jax_tuning.plan_sig(plan)
    assert port_model.plan_sig(plan) == plan_sig(plan)


# ------------------------------------------------------------ selection

SELECTIONS = {
    "lowest p99 wins": [({"bm": 64}, [10, 11, 12, 30]),
                        ({"bm": 128}, [14, 14, 15, 15])],
    "CoV breaks a p99 tie": [({"bm": 64}, [10, 20, 10, 20]),
                             ({"bm": 128}, [19.5, 19.6, 19.5, 19.6])],
    "sig breaks an exact tie": [({"bm": 128}, [5, 5, 5]),
                                ({"bm": 64}, [5, 5, 5])],
    "outside the tie band": [({"chunk": 16}, [100, 100, 100]),
                             ({"chunk": 32}, [80, 120, 80])],
}


@pytest.mark.parametrize("name", sorted(SELECTIONS))
@pytest.mark.parametrize("tie_rel", [0.0, 0.05, 0.5])
def test_select_plan_matches_reference(name, tie_rel):
    runs = SELECTIONS[name]
    port = select_plan([(p, jitter_stats(s)) for p, s in runs], tie_rel)
    ref = jax_tuning.select_plan([(p, jax_jitter_stats(s))
                                  for p, s in runs], tie_rel)
    assert port[0] == ref[0]
    assert port[1].as_dict() == ref[1].as_dict()


def test_select_plan_needs_a_measurement():
    with pytest.raises(ValueError):
        select_plan([])


def test_measure_callable_takes_a_runners_own_time():
    """A runner that times itself on the device returns its sample;
    one span per rep either way."""
    rec = TraceRecorder()
    stats = tuning.measure_callable(iter([0.0, 7.0, 9.0, 8.0]).__next__,
                                    reps=3, warmup=1, trace=rec)
    assert (stats.n, stats.min, stats.max, stats.median) == (3, 7, 9, 8)
    assert measurement_count(rec) == 3
    host = tuning.measure_callable(lambda: None, reps=2, warmup=0,
                                   trace=rec)
    assert host.n == 2 and measurement_count(rec) == 5


def test_kernel_bound_matches_reference():
    from repro.analysis.roofline import kernel_bound_s as jax_bound
    for args in ((1e9, 1e6), (1e6, 1e9), (3.5e10, 2.1e9)):
        kw = dict(peak_flops=989e12, hbm_bw=3.35e12, mxu_eff=0.85,
                  hbm_derate=0.8)
        assert kernel_bound_s(*args, **kw) == jax_bound(*args, **kw)


# ---------------------------------------------------------------- retry

def _retry_delays(mod, monkeypatch, attempts, failures):
    monkeypatch.setattr(mod, "_JITTER_RNG", random.Random(0xA11CE))
    slept, retried = [], []
    calls = iter(range(failures + 1))

    def flaky():
        if next(calls) < failures:
            raise OSError("transient")
        return "ok"

    try:
        out = mod.retry_transient(flaky, attempts=attempts,
                                  base_delay=0.005, max_delay=0.02,
                                  sleep=slept.append,
                                  on_retry=lambda a, e, d:
                                  retried.append((a, d)))
    except mod.RetriesExhausted as e:
        out = f"gave up: {e.__cause__!r}"
    return out, slept, retried


@pytest.mark.parametrize("attempts,failures", [(3, 0), (3, 2), (3, 5),
                                               (6, 4)])
def test_retry_delays_match_reference(monkeypatch, attempts, failures):
    port = _retry_delays(port_retry, monkeypatch, attempts, failures)
    ref = _retry_delays(jax_retry, monkeypatch, attempts, failures)
    assert port == ref
    assert len(port[1]) == min(failures, attempts - 1)


def test_retry_gives_up_at_once_on_give_up_on():
    slept = []

    def missing():
        raise FileNotFoundError("gone")

    with pytest.raises(FileNotFoundError):
        port_retry.retry_transient(missing, give_up_on=(FileNotFoundError,),
                                   sleep=slept.append)
    assert slept == []


# ---------------------------------------------------------- plan cache

def test_reference_cache_file_loads_but_never_resolves(caches):
    """A file the reference's tuner wrote has the same schema, so it
    loads without a warning; its keys digest the reference's
    environment, so none of them resolves in the port."""
    port_path, ref_path = caches
    ref_cache = jax_tuning.active_cache()
    entries = [("spm_matmul", "MatmulProblem", (128, 128, 128),
                {"bm": 64, "bn": 64, "bk": 0}),
               ("wkv6", "WkvProblem", (1, 64, 2, 32), {"chunk": 32})]
    for kernel, cls, dims, plan in entries:
        ref_cache.put(jax_tuning.cache_key(
            kernel, getattr(jax_tuning, cls)(*dims)), plan, kernel=kernel)
    ref_cache.save()
    port = PlanCache(str(ref_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(port) == len(entries)
        for kernel, cls, dims, plan in entries:
            problem = getattr(tuning, cls)(*dims)
            assert port.get(cache_key(kernel, problem)) is None
            tuning.reset(port)
            assert cached_pins(kernel, problem,
                               dict.fromkeys(plan)) == {}
    assert port.misses == 2 * len(entries)      # get and cached_pins


def test_cpu_plan_never_resolves_on_an_sm90_card(caches, monkeypatch):
    problem = MatmulProblem(4, 896, 4864, "bfloat16")
    tuning.active_cache().put(cache_key("spm_matmul", problem),
                              {"bm": 32, "bn": 128, "bk": 64})
    assert cached_pins("spm_matmul", problem,
                       {"bm": None, "bn": None, "bk": None}) \
        == {"bm": 32, "bn": 128, "bk": 64}
    cpu_sig = env_sig()
    cache = tuning.active_cache()
    monkeypatch.setattr(compat, "device_identity", lambda: dict(SM90))
    tuning.reset(cache)
    assert env_sig() != cpu_sig
    assert tuning.env_fingerprint()["gpu"] == SM90["gpu"]
    assert cached_pins("spm_matmul", problem,
                       {"bm": None, "bn": None, "bk": None}) == {}
    assert mm_ops.launch_plan(4, 896, 4864, BF16, False, True)["path"] \
        == "splitk"
    monkeypatch.setattr(compat, "device_identity",
                        lambda: dict(SM90, power_limit_w=500.0))
    tuning.reset(cache)
    assert env_sig() not in (cpu_sig,)


def test_plan_cache_round_trip_and_atomic_save(tmp_path):
    path = tmp_path / "sub" / "c.json"
    c1 = PlanCache(str(path))
    c1.put("k|sig|env", {"bm": 128}, kernel="spm_matmul")
    assert c1.save() == path
    assert [p.name for p in path.parent.iterdir()] == ["c.json"]
    c2 = PlanCache(str(path))
    assert c2.get("k|sig|env") == {"bm": 128} and c2.hits == 1
    entry = c2.entry("k|sig|env")
    assert entry["kernel"] == "spm_matmul"
    assert entry["env"] == tuning.env_fingerprint()
    assert c2.get("missing") is None and c2.misses == 1
    assert json.loads(path.read_text())["schema_version"] \
        == CACHE_SCHEMA_VERSION == jax_tuning.plan_cache.CACHE_SCHEMA_VERSION


@pytest.mark.parametrize("text,match", [
    ("{not json at all", "unreadable"),
    (json.dumps({"schema_version": 999, "plans": {}}), "unreadable"),
    (json.dumps({"schema_version": 2, "plans": []}), "unreadable"),
    (json.dumps({"schema_version": 2,
                 "plans": {"bad": {"plan": {"bm": "big"}}}}), "mis-shaped"),
    (json.dumps({"schema_version": 2,
                 "plans": {"bad": {"plan": {"bm": True}}}}), "mis-shaped"),
])
def test_bad_caches_degrade_as_the_reference(tmp_path, text, match):
    for pkg in (tuning, jax_tuning):
        path = tmp_path / f"{pkg.__name__}.json"
        path.write_text(text, encoding="utf-8")
        cache = pkg.PlanCache(str(path))
        with pytest.warns(RuntimeWarning, match=match):
            assert cache.get("bad") is None
        assert cache.misses == 1


def test_unreadable_cache_retries_then_degrades(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"schema_version": 2, "plans": {}}))
    tries = []

    def flaky(op, p):
        tries.append(op)
        raise OSError("nfs blip")

    cache = PlanCache(str(path))
    cache.fault_hook = flaky
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert cache.get("x") is None
    assert tries == ["read_cache"] * 3


def test_schema_v1_model_cache_still_read(caches):
    cfg = problem_config(ModelProblem(**MICRO))
    problem = ModelProblem(**MICRO)
    tuned = dict(default_model_plan(cfg, problem), chunk_q=16)
    port_path, _ = caches
    port_path.write_text(json.dumps({"schema_version": 1, "plans": {
        model_cache_key(problem): {"plan": tuned, "kernel": "model"}}}))
    tuning.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = resolve_model_plan(cfg, problem)
    assert r == {"plan": tuned, "source": "cache"}


def test_corrupt_model_entry_degrades_to_defaults(caches):
    problem = ModelProblem(**MICRO)
    cfg = problem_config(problem)
    port_path, _ = caches
    port_path.write_text(json.dumps({"schema_version": 2, "plans": {
        model_cache_key(problem): {"plan": {"chunk_q": "wat"}}}}))
    tuning.reset()
    with pytest.warns(RuntimeWarning, match="mis-shaped"):
        r = resolve_model_plan(cfg, problem)
    assert r == {"plan": default_model_plan(cfg, problem),
                 "source": "defaults"}


# ------------------------------------------------------ resolution

MM128 = (128, 128, 128)
PRECEDENCE = [  # cached plan, overrides
    ({"bm": 64, "bn": 64, "bk": 0}, {"bm": None, "bn": None, "bk": None}),
    ({"bm": 64, "bn": 64, "bk": 0}, {"bm": 32, "bn": None, "bk": None}),
    ({"bm": 64, "bn": 64, "bk": 0}, {"bm": 32, "bn": 128, "bk": 64}),
    ({"bm": 32, "bn": 128, "bk": 64}, {"bm": None, "bn": 64, "bk": None}),
]


@pytest.mark.parametrize("cached,overrides", PRECEDENCE)
def test_resolve_plan_precedence_matches_reference(caches, cached,
                                                   overrides):
    port_p, ref_p = MatmulProblem(*MM128), jax_tuning.MatmulProblem(*MM128)
    tuning.active_cache().put(cache_key("spm_matmul", port_p), cached)
    jax_tuning.active_cache().put(
        jax_tuning.cache_key("spm_matmul", ref_p), cached)
    port = resolve_plan("spm_matmul", port_p, dict(overrides))
    assert port == jax_tuning.resolve_plan("spm_matmul", ref_p,
                                           dict(overrides))
    assert port == {**cached, **{k: v for k, v in overrides.items()
                                 if v is not None}}


def test_resolve_plan_defaults_without_an_entry(caches):
    for kernel, problem in DEFAULT_PROBLEMS.items():
        params = tuning.TUNE_SPECS[kernel].param_names
        assert resolve_plan(kernel, problem, dict.fromkeys(params)) \
            == defaults_for(kernel, problem)
        assert cached_pins(kernel, problem, dict.fromkeys(params)) == {}


MODEL_CASES = [  # cached (as a change to the defaults), overrides
    (None, {}), (None, {"chunk_q": 16}),
    ({"chunk_q": 16, "decode_scan": 0}, {}),
    ({"chunk_q": 16, "decode_scan": 0}, {"chunk_kv": 8}),
    (None, {"chunk_q": 8, "chunk_kv": 8, "decode_scan": 1, "mm_bm": 16,
            "mm_bn": 64}),
]


@pytest.mark.parametrize("cached,overrides", MODEL_CASES)
def test_resolve_model_plan_matches_reference(caches, cached, overrides):
    port_p = ModelProblem(**MICRO)
    ref_p = jax_tuning.ModelProblem(**MICRO)
    cfg, ref_cfg = problem_config(port_p), jax_tuning.problem_config(ref_p)
    default = default_model_plan(cfg, port_p)
    if cached is not None:
        # the same whole plan in both caches
        tuning.active_cache().put(model_cache_key(port_p),
                                  dict(default, **cached))
        jax_tuning.active_cache().put(jax_tuning.model_cache_key(ref_p),
                                      dict(default, **cached))
    port = resolve_model_plan(cfg, port_p, dict(overrides))
    ref = jax_tuning.resolve_model_plan(ref_cfg, ref_p, dict(overrides))
    assert port["source"] == ref["source"]
    if cached is not None or len(overrides) == len(default):
        assert port["plan"] == ref["plan"]
    assert port["plan"] == {**default, **(cached or {}), **overrides}


def test_autotune_off_ignores_the_cache(caches, monkeypatch):
    problem = ModelProblem(**MICRO)
    cfg = problem_config(problem)
    default = default_model_plan(cfg, problem)
    mm = MatmulProblem(4, 896, 4864, "bfloat16")
    wk = WkvProblem(4, 256, 32, 64, "bfloat16")
    cache = tuning.active_cache()
    cache.put(model_cache_key(problem), dict(default, chunk_q=16))
    cache.put(cache_key("spm_matmul", mm), {"bm": 16, "bn": 64, "bk": 64})
    cache.put(cache_key("wkv6", wk), {"chunk": 16})
    assert resolve_model_plan(cfg, problem)["source"] == "cache"
    assert mm_ops.launch_plan(4, 896, 4864, BF16, False, True)["path"] \
        == "tiled"
    assert wkv_ops.launch_plan(4, 256, 32, 64, BF16)["rows"] == 16
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert resolve_model_plan(cfg, problem) == {"plan": default,
                                                "source": "defaults"}
    assert mm_ops.launch_plan(4, 896, 4864, BF16, False, True)["path"] \
        == "splitk"
    assert wkv_ops.launch_plan(4, 256, 32, 64, BF16)["rows"] == 64
    assert resolve_plan("spm_matmul", mm, {"bm": None, "bn": None,
                                           "bk": None}) \
        == defaults_for("spm_matmul", mm)


# ------------------------------------------- what a card would launch

def _launch(m, k, n, tb, **pins):
    launch = mm_ops.launch_of(m, k, n, BF16, tb, True, **pins)
    return {k: v for k, v in launch.items() if k != "tile"}, \
        dict(launch["tile"])


@pytest.mark.parametrize("shape", MAIN_PRODUCTS,
                         ids=["x".join(map(str, s[:3])) + ("t" if s[3]
                                                            else "")
                              for s in MAIN_PRODUCTS])
def test_launch_plan_without_an_entry_is_the_untuned_launch(caches, shape):
    """With an empty cache (and with autotuning off) every main-path
    product launches what a call with no pins launched before tuning
    existed: path, split and tile.  The default plan written into the
    cache launches it too."""
    m, k, n, tb = shape
    untuned = mm_ops.dispatch(m, k, n, BF16, tb, True)
    launch = mm_ops.launch_plan(m, k, n, BF16, tb, True)
    assert {k: v for k, v in launch.items() if k != "tile"} == untuned
    if untuned["path"] == "tiled":
        assert launch["tile"] == mm_ops.resolve_plan(m, k, n, 2, tb)
    problem = MatmulProblem(m, k, n, "bfloat16", tb)
    tuning.active_cache().put(cache_key("spm_matmul", problem),
                              defaults_for("spm_matmul", problem))
    assert _launch(m, k, n, tb) == _launch(
        m, k, n, tb, **cached_pins("spm_matmul", problem,
                                   {"bm": None, "bn": None, "bk": None}))


def test_main_path_products_cover_the_served_models():
    assert len(MAIN_PRODUCTS) == 35
    for arch, B, P in (("qwen2-0.5b", 4, 256), ("rwkv6-1.6b", 4, 256),
                       ("gemma3-12b", 4, 2048)):
        cfg = get_config(arch)
        for m, k, n, tb, _ in port_model.decode_products(cfg, B):
            assert (m, k, n, tb) in MAIN_PRODUCTS
            if not tb:
                assert (B * P, k, n, tb) in MAIN_PRODUCTS


@pytest.mark.parametrize("shape,cached,path", [
    ((1024, 896, 4864), {"bm": 128, "bn": 128, "bk": 64}, "wgmma"),
    ((1024, 896, 4864), {"bm": 64, "bn": 128, "bk": 128}, "tiled"),
    ((4, 896, 4864), {"bm": 16, "bn": 64}, "splitk"),
    ((4, 896, 4864), {"bm": 16, "bn": 64, "bk": 0}, "tiled"),
    ((4, 896, 4864), {"bm": 32, "bn": 128, "bk": 256}, "tiled"),
])
def test_cached_pins_steer_the_launch(caches, shape, cached, path):
    m, k, n = shape
    tuning.active_cache().put(
        cache_key("spm_matmul", MatmulProblem(m, k, n, "bfloat16")), cached)
    launch = mm_ops.launch_plan(m, k, n, BF16, False, True)
    assert launch["path"] == path
    assert launch == mm_ops.launch_of(m, k, n, BF16, False, True, **cached)
    if path == "tiled":
        want = mm_ops.resolve_plan(m, k, n, 2, False, cached["bm"],
                                   cached["bn"], cached["bk"])
        assert launch["tile"] == want
    # an explicit pin still beats the cache, key by key
    explicit = mm_ops.launch_plan(m, k, n, BF16, False, True, bm=16,
                                  bn=64)
    assert explicit == mm_ops.launch_of(
        m, k, n, BF16, False, True, 16, 64, cached.get("bk"))


CANDIDATE_PROBLEMS = [
    MatmulProblem(4, 896, 4864, "bfloat16"),
    MatmulProblem(4, 15360, 3840, "bfloat16"),
    MatmulProblem(1024, 896, 4864, "bfloat16"),
    MatmulProblem(4, 3840, 262_144, "bfloat16", trans_b=True),
    MatmulProblem(48, 896, 896, "bfloat16"),
    MatmulProblem(512, 512, 512),
    MatmulProblem(4, 896, 128, "float32"),
]


@pytest.mark.parametrize("problem", CANDIDATE_PROBLEMS,
                         ids=[p.sig for p in CANDIDATE_PROBLEMS])
def test_matmul_candidates_launch_distinctly_and_fit(problem):
    p = problem
    cands = enumerate_candidates("spm_matmul", p)
    assert cands[0] == defaults_for("spm_matmul", p)
    keys = set()
    elem = 2 if p.dtype == "bfloat16" else 4
    for plan in cands:
        launch = matmul_launch(p, plan)
        keys.add(tuning.candidates.matmul_launch_key(p, plan))
        assert feasibility("spm_matmul", p, plan).fits
        tile = launch["tile"]
        if launch["path"] == "tiled":
            assert (tile["bm"], tile["bn"]) in mm_ops.TILES
            assert tile == mm_ops.resolve_plan(p.m, p.k, p.n, elem,
                                               p.trans_b, *(plan.get(x)
                                                            for x in
                                                            ("bm", "bn",
                                                             "bk")))
            assert smem_plan(p.m, p.k, p.n, tile["bm"], tile["bn"],
                             tile["bk"], elem, p.trans_b,
                             tile["stages"])["fits"]
        else:
            assert plan == defaults_for("spm_matmul", p)
    assert len(keys) == len(cands)
    fixed = mm_ops.dispatch(p.m, p.k, p.n, compat.torch_dtype(p.dtype),
                            p.trans_b, True)["path"]
    paths = [matmul_launch(p, c)["path"] for c in cands]
    assert paths.count(fixed) == (1 if fixed != "tiled" else len(cands))


def test_decode_candidates_are_splitk_and_five_tiled_depths():
    p = MatmulProblem(4, 896, 4864, "bfloat16")
    cands = enumerate_candidates("spm_matmul", p)
    assert cands[0] == {"bm": 16, "bn": 64}
    assert [matmul_launch(p, c)["tile"]["bkc"] for c in cands[1:]] \
        == [896, 64, 128, 256, 512]
    assert defaults_for("spm_matmul", MatmulProblem(
        1024, 896, 4864, "bfloat16")) == {"bm": 128, "bn": 128, "bk": 64}


WKV_PROBLEMS = [WkvProblem(4, 256, 32, 64, "bfloat16"),
                WkvProblem(1, 100, 2, 32, "bfloat16"),
                WkvProblem(2, 256, 4, 128, "bfloat16"),
                WkvProblem(1, 256, 2, 64), WkvProblem(1, 48, 2, 128)]


@pytest.mark.parametrize("problem", WKV_PROBLEMS,
                         ids=[p.sig for p in WKV_PROBLEMS])
def test_wkv_candidates_launch_distinctly_and_fit(problem):
    p = problem
    cands = enumerate_candidates("wkv6", p)
    assert cands[0] == defaults_for("wkv6", p)
    launches = [wkv_launch(p, c) for c in cands]
    assert len({tuple(sorted(x.items())) for x in launches}) == len(cands)
    for plan, launch in zip(cands, launches):
        assert feasibility("wkv6", p, plan).fits
        if launch["path"] == "tensor_core":
            assert launch["rows"] == plan["chunk"] and plan["chunk"] % 16 \
                == 0
        else:
            assert launch["rows"] == wkv_ops.resolve_chunk(
                p.seq, p.key_dim, plan["chunk"])
            assert wkv_smem_plan(launch["rows"], p.key_dim)["fits"]
    assert wkv_launch(p, {}) == wkv_launch(p, defaults_for("wkv6", p))


def test_flash_has_one_candidate():
    p = AttentionProblem(4, 256, 256, 14, 2, 64, dtype="bfloat16")
    assert enumerate_candidates("flash_attention", p) \
        == [{"bq": 64, "bk": 64}] == [defaults_for("flash_attention", p)]
    assert feasibility("flash_attention", p, {"bq": 64, "bk": 64}).fits
    assert not feasibility("flash_attention", p,
                           {"bq": 128, "bk": 64}).fits
    from repro_torch.kernels.flash_attention import ops as fa_ops
    assert fa_ops.launch_plan(4, 256, 256, 14, 2, 64, True, 0, BF16) \
        == {"bq": 64, "bk": 64}
    with pytest.raises(ValueError):
        fa_ops.launch_plan(4, 256, 256, 14, 2, 64, True, 0, BF16, bq=128)


def test_cost_model_prices_each_path_by_its_loads():
    decode = MatmulProblem(4, 896, 4864, "bfloat16")
    splitk = tuning.cost_summary("spm_matmul", decode, {"bm": 16, "bn": 64})
    tiled = tuning.cost_summary("spm_matmul", decode,
                                {"bm": 16, "bn": 64, "bk": 64})
    # A re-read per 64-column tile on both; B once (one row block)
    a, b, c = 4 * 896 * 2, 896 * 4864 * 2, 4 * 4864 * 2
    assert splitk["bytes"] == tiled["bytes"] == 76 * a + b + c
    assert splitk["grid_steps"] == 2 * tiled["grid_steps"] == 152
    prefill = MatmulProblem(1024, 896, 4864, "bfloat16")
    wg = tuning.cost_summary("spm_matmul", prefill,
                             {"bm": 128, "bn": 128, "bk": 64})
    a, b = 1024 * 896 * 2, 896 * 4864 * 2
    assert wg["bytes"] == 38 * a + 8 * b + 1024 * 4864 * 2
    assert tuning.analytic_cost_s("spm_matmul", prefill, {
        "bm": 16, "bn": 64, "bk": 64}) > tuning.analytic_cost_s(
        "spm_matmul", prefill, {"bm": 128, "bn": 128, "bk": 64})


# ---------------------------------------------------------- model plans

QWEN_FULL = dict(arch="qwen2-0.5b", batch=4, prompt_len=256, gen=32,
                 layers=0, dtype="bfloat16")


def test_cuda_model_enumeration_gives_the_two_decode_programs():
    """qwen2-0.5b at full width and batch 4: the default pins run the
    decode products on split-K; any other pin runs them tiled, clamped
    back to 16 x 64.  The chunking and loop structure change no launch
    on the card, so they stay the defaults."""
    problem = ModelProblem(**QWEN_FULL)
    cfg = problem_config(problem)
    default = default_model_plan(cfg, problem)
    cands = enumerate_model_candidates(cfg, problem, device="cuda")
    assert cands == [default, dict(default, mm_bm=32, mm_bn=64)]
    assert (default["mm_bm"], default["mm_bn"]) == (16, 64)
    programs = [{mm_ops.launch_plan(m, k, n, BF16, tb, True, c["mm_bm"],
                                    c["mm_bn"])["path"]
                 for m, k, n, tb, _ in port_model.decode_products(cfg, 4)
                 if not tb} for c in cands]
    assert programs == [{"splitk"}, {"tiled"}]
    for c in cands:
        for m, k, n, tb, _ in port_model.decode_products(cfg, 4):
            tile = mm_ops.launch_plan(m, k, n, BF16, tb, True, c["mm_bm"],
                                      c["mm_bn"])["tile"]
            assert (tile["bm"], tile["bn"]) == (16, 64)
    assert port_model.model_feasible(cfg, problem, cands[1])


def test_cpu_model_enumeration_is_the_reference_grid():
    problem = ModelProblem(**MICRO)
    ref_p = jax_tuning.ModelProblem(**MICRO)
    cfg = problem_config(problem)
    port = enumerate_model_candidates(cfg, problem, device="cpu")
    ref = jax_tuning.enumerate_model_candidates(
        jax_tuning.problem_config(ref_p), ref_p)
    strip = ("mm_bm", "mm_bn")
    assert [{k: v for k, v in c.items() if k not in strip} for c in port] \
        == [{k: v for k, v in c.items() if k not in strip} for c in ref]
    assert default_model_plan(cfg, problem) in port


def test_decode_products_count_the_serves_products():
    for arch, per_layer in (("qwen2-0.5b", 7), ("rwkv6-1.6b", 16),
                            ("gemma3-12b", 7)):
        cfg = get_config(arch)
        prods = port_model.decode_products(cfg, 4)
        assert sum(c for *_, c in prods) == per_layer * cfg.num_layers + 1
        assert [p[3] for p in prods].count(True) == 1


def test_tuned_serving_plan_has_the_reference_keys():
    problem = ModelProblem(**MICRO)
    cfg = problem_config(problem)
    ref_p = jax_tuning.ModelProblem(**MICRO)
    assert set(default_model_plan(cfg, problem)) == set(
        jax_tuning.default_model_plan(jax_tuning.problem_config(ref_p),
                                      ref_p))
    assert model_cache_key(problem).startswith(
        f"{tuning.MODEL_NS}|{problem.sig}|")


# ------------------------------------------------------------ tuning

KERNEL_TUNES = [("spm_matmul", MatmulProblem(64, 64, 64)),
                ("flash_attention", AttentionProblem(1, 64, 64, 2, 1, 32)),
                ("wkv6", WkvProblem(1, 64, 2, 32))]


@pytest.mark.parametrize("kernel,problem", KERNEL_TUNES,
                         ids=[k for k, _ in KERNEL_TUNES])
def test_tune_cold_then_warm_on_the_cpu(caches, kernel, problem):
    rec = TraceRecorder()
    r1 = tune(kernel, problem, reps=2, warmup=1, max_candidates=2,
              device="cpu", trace=rec)
    assert r1.source == "measured" and r1.measured > 0
    assert measurement_count(rec) == r1.measured == 2 * r1.pruned_to
    assert r1.plan in enumerate_candidates(kernel, problem)
    assert r1.default_plan == defaults_for(kernel, problem)
    assert r1.default_stats is not None and r1.err_ratios == {}
    rec2 = TraceRecorder()
    r2 = tune(kernel, problem, reps=2, device="cpu", trace=rec2)
    assert (r2.source, r2.measured, r2.plan) == ("cache", 0, r1.plan)
    assert measurement_count(rec2) == 0
    rec3 = TraceRecorder()
    r3 = tune(kernel, problem, reps=1, force=True, device="cpu",
              trace=rec3)
    assert r3.source == "measured" and measurement_count(rec3) > 0


def test_tune_model_cold_then_warm_on_the_cpu(caches):
    problem = ModelProblem(**MICRO)
    rec = TraceRecorder()
    res = tune_model(problem, reps=2, warmup=1, max_candidates=2,
                     device="cpu", trace=rec)
    assert res.source == "measured" and res.measured > 0
    assert measurement_count(rec) == res.measured
    assert res.default_plan == default_model_plan(problem_config(problem),
                                                  problem)
    assert set(res.plan) == {"chunk_q", "chunk_kv", "decode_scan", "mm_bm",
                             "mm_bn"}
    rec2 = TraceRecorder()
    res2 = tune_model(problem, reps=2, device="cpu", trace=rec2)
    assert (res2.source, res2.measured, res2.plan) == ("cache", 0, res.plan)
    assert measurement_count(rec2) == 0
    assert resolve_model_plan(problem_config(problem), problem) \
        == {"plan": res.plan, "source": "cache"}


def test_tune_cli_on_the_cpu(caches, capsys):
    port_path, _ = caches
    argv = ["--device", "cpu", "--kernel", "spm_matmul", "--shape",
            "4x64x128t", "--dtype", "bfloat16", "--reps", "2"]
    out = tune_cli.run(argv)
    text = capsys.readouterr().out
    assert out["spans"] > 0 and " us" not in text
    assert "spm_matmul 4x64x128-bfloat16-tb: plan=" in text
    assert tune_cli.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[-1] \
        == "measurement spans: 0"
    assert out["cache"] == port_path
    with pytest.raises(SystemExit):
        tune_cli.run(["--device", "cpu", "--model", "qwen2-0.5b",
                      "--kernel", "wkv6"])


def test_tune_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune_cli.run(["--kernel", "wkv6"])


# ------------------------------------------------------- serve on a plan

SERVE_ARGS = ["--device", "cpu", "--batch", "2", "--prompt-len", "32",
              "--gen", "4", "--d-model", "64", "--vocab", "256", "--dtype",
              "float32", "--deadline-ms", "10000"]


def test_serve_on_a_cached_plan(caches, capsys):
    """A reduced CPU serve resolves the cached plan (``plan_source``
    ``cache``) and, when the cached values are the defaults, gives the
    default serve's tokens; its WCET bound moves with the cached pins."""
    problem = ModelProblem(**MICRO)
    cfg = problem_config(problem)
    default = default_model_plan(cfg, problem)
    base = serve.main(SERVE_ARGS)
    assert base["plan_source"] == "defaults" and base["plan"] == default
    cache = tuning.active_cache()
    cache.put(model_cache_key(problem), default)
    same = serve.main(SERVE_ARGS)
    assert same["plan_source"] == "cache" and same["plan"] == default
    assert all(np.array_equal(a, b) for a, b in zip(same["tokens"],
                                                    base["tokens"]))
    assert same["wcet_s"] == base["wcet_s"]
    cache.put(model_cache_key(problem), dict(default, mm_bm=32, mm_bn=128))
    moved = serve.main(SERVE_ARGS)
    assert moved["plan"]["mm_bn"] == 128 and moved["wcet_s"] \
        != base["wcet_s"]
    assert moved["wcet_s"] == serve.plan_wcet_s(
        cfg, moved["plan"], problem.batch, moved["n_params"])
    explicit = serve.main(SERVE_ARGS + ["--chunk-q", "16"])
    assert explicit["plan_source"] == "explicit+cache"
    assert "serving plan [explicit+cache]" in capsys.readouterr().out


def test_kernel_pins_follow_a_cached_decode_weight_pass_plan(caches):
    problem = ModelProblem(**MICRO)
    cfg = problem_config(problem)
    before = port_model.kernel_pins(cfg, problem)
    assert before == {"mm_bm": 16, "mm_bn": 64}
    tuning.active_cache().put(
        cache_key("spm_matmul", port_model.decode_matmul_problem(cfg,
                                                                 problem)),
        {"bm": 32, "bn": 128, "bk": 0})
    assert port_model.kernel_pins(cfg, problem) == {"mm_bm": 32,
                                                    "mm_bn": 128}


# ------------------------------------------------------ on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card; run chip_smoke.py there")
    return compat.resolve_device("cuda")


@pytest.mark.gpu
def test_tune_a_small_problem_on_the_card(cuda_device, caches):
    problem = MatmulProblem(4, 896, 896, "bfloat16")
    rec = TraceRecorder()
    res = tune("spm_matmul", problem, reps=3, trace=rec)
    assert res.source == "measured" and measurement_count(rec) > 0
    assert all(r < 1 for r in res.err_ratios.values())
    assert len(res.err_ratios) == res.pruned_to
    assert res.stats.p99 > 0
    again = tune("spm_matmul", problem, trace=rec)
    assert again.source == "cache" and again.plan == res.plan
    assert tuning.env_fingerprint()["gpu"] == torch.cuda.get_device_name(0)
