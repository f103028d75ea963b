"""Jitter-aware offline autotuner with a persistent plan cache, for the
port's Hopper kernels (the reference's ``repro.tuning``, name for name).

The paper's schedule construction (§4.3) decides feasibility and
placement *ahead of execution*; this package applies the same
discipline to the kernels' plans: candidates are enumerated (the plans
that launch differently on the card) and pruned analytically
(shared-memory feasibility + roofline ranking), survivors are measured
on the card under the predictability observatory, and selection is by
**p99 latency with a CoV tie-break** — never by mean alone — so a
faster plan is never accepted at the cost of execution-time
fluctuation.  Winners persist to a JSON cache keyed by (kernel,
shape/dtype, environment fingerprint, the card included); warm runs
perform zero measurements.

Layers:

- ``plan``        — problems (shape/dtype signatures) and plan dicts.
- ``candidates``  — per-kernel enumeration + the default plans.
- ``cost_model``  — shared-memory feasibility (the SPM-capacity rule)
  and the analytic roofline pruner.
- ``measure``     — timing (CUDA events on the card) + the
  jitter-aware selection objective.
- ``plan_cache``  — the persistent store ($REPRO_PLAN_CACHE).
- ``autotuner``   — ``tune()``: enumerate -> prune -> measure -> persist.
- ``runtime``     — ``resolve_plan()`` and ``cached_pins()``: what the
  kernel wrappers consult (explicit args > cached plan > defaults;
  $REPRO_AUTOTUNE=0 disables the cache consult).
- ``model``/``model_tuner`` — the same pipeline one level up: serving
  plans (prefill chunking, decode loop structure, decode tile pins)
  measured as full captured prefill+decode passes and cached under the
  ``model|`` key namespace; ``resolve_model_plan()`` is what the
  serving launcher calls.

CLI: ``python -m repro_torch.launch.tune`` (``--model`` for serving
plans).
"""
from repro_torch.tuning.autotuner import (TuneResult, make_runner,
                                          shortlist, tune)
from repro_torch.tuning.candidates import (TUNE_SPECS, defaults_for,
                                           enumerate_candidates)
from repro_torch.tuning.cost_model import (analytic_cost_s, cost_summary,
                                           feasibility, vmem_need)
from repro_torch.tuning.measure import (MEASURE_TRACK, measure_callable,
                                        measurement_count, select_plan)
from repro_torch.tuning.model import (MODEL_NS, ModelProblem,
                                      default_model_plan,
                                      enumerate_model_candidates,
                                      model_analytic_cost_s,
                                      model_cache_key, model_feasible,
                                      parse_model_problem, problem_config,
                                      resolve_model_plan)
from repro_torch.tuning.model_tuner import (ModelTuneResult,
                                            make_serve_runner,
                                            model_shortlist, tune_model,
                                            us_per_token)
from repro_torch.tuning.plan import (DEFAULT_PROBLEMS, AttentionProblem,
                                     MatmulProblem, Plan, Problem,
                                     WkvProblem, parse_problem, plan_sig)
from repro_torch.tuning.plan_cache import (PlanCache, cache_key,
                                           env_fingerprint, env_sig)
from repro_torch.tuning.runtime import (active_cache, autotune_enabled,
                                        reset, resolve_plan)

__all__ = [
    "AttentionProblem",
    "DEFAULT_PROBLEMS",
    "MEASURE_TRACK",
    "MatmulProblem",
    "Plan",
    "PlanCache",
    "Problem",
    "TUNE_SPECS",
    "TuneResult",
    "WkvProblem",
    "active_cache",
    "analytic_cost_s",
    "autotune_enabled",
    "cache_key",
    "cost_summary",
    "defaults_for",
    "enumerate_candidates",
    "env_fingerprint",
    "env_sig",
    "feasibility",
    "make_runner",
    "measure_callable",
    "measurement_count",
    "parse_problem",
    "plan_sig",
    "reset",
    "resolve_plan",
    "select_plan",
    "shortlist",
    "tune",
    "vmem_need",
]
