"""Model-level serving plans of the port, from the reference's
``tuning/model.py`` and ``tuning/plan.py``.

A model *plan* is a flat ``{name: int}`` dict:

  ``chunk_q`` / ``chunk_kv``   prefill attention chunking of the plain
                               (CPU) path (RunOptions),
  ``decode_scan``              0/1: the decode layer-loop structure,
  ``mm_bm`` / ``mm_bn``        the decode weight-pass matmul tile pins:
                               the decode step's spm_matmul products run
                               this tile (``RunOptions.mm_tiles``) and
                               ``core.gpu_mapping.serve_step_schedule``
                               tiles the WCET bound by it.

This slice has no plan cache: ``default_model_plan`` gives the plan,
with the tile pins taken from the port's ``spm_matmul`` defaults.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch import compat
from repro_torch.kernels.spm_matmul.ops import resolve_plan

Plan = Dict[str, int]


def plan_sig(plan: Plan) -> str:
    """Canonical short form of a plan, e.g. ``bk0.bm256.bn512``."""
    return ".".join(f"{k}{v}" for k, v in sorted(plan.items()))


@dataclass(frozen=True)
class ModelProblem:
    """One serving configuration, as the launcher builds it.

    ``layers``/``d_model``/``vocab`` are the reduced dims
    (configs.reduce_config); 0 means --full (the registered size).
    """
    arch: str
    batch: int
    prompt_len: int
    gen: int
    layers: int = 2
    d_model: int = 128
    vocab: int = 512
    dtype: str = "float32"


def decode_matmul_shape(cfg, problem: ModelProblem):
    """The decode step's aggregate weight pass as an (m, k, n) matmul:
    [B, d_model] activations against every weight matrix once."""
    from repro_torch.models.lm import param_count
    n_eff = max(cfg.d_model, 2 * param_count(cfg) // cfg.d_model)
    return problem.batch, cfg.d_model, n_eff


def kernel_pins(cfg, problem: ModelProblem) -> Dict[str, int]:
    """The decode weight-pass tile the port's spm_matmul resolves for
    that shape: its defaults, clamped to the problem and to the compiled
    tiles (the WCET schedule clamps ``mm_bm`` to the batch itself)."""
    m, k, n = decode_matmul_shape(cfg, problem)
    elem = torch.finfo(compat.torch_dtype(problem.dtype)).bits // 8
    plan = resolve_plan(m, k, n, elem, False)
    return {"mm_bm": plan["bm"], "mm_bn": plan["bn"]}


def default_model_plan(cfg, problem: ModelProblem) -> Plan:
    """32-token prefill chunks when 32 divides the prompt (else one
    block), the decode loop structure from cfg.scan_layers, and the
    spm_matmul tile pins."""
    chunk = 32 if problem.prompt_len % 32 == 0 else problem.prompt_len
    plan = {"chunk_q": chunk, "chunk_kv": chunk,
            "decode_scan": int(bool(cfg.scan_layers))}
    plan.update(kernel_pins(cfg, problem))
    return plan
