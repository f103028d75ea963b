"""Analytic parameter / FLOP model (the reference's
``analysis/flops.py``).

MODEL_FLOPS follows the reference: 6*N*D for training (N = active
params, D = tokens), 2*N*D for inference forward passes.  For MoE, N
counts each token's routed experts (top_k + shared), not the full
expert pool.  The roofline's "useful compute" ratio divides it by the
traced per-device FLOPs.  ``launch/train.py::model_flops`` is the
port's other definition (6*N*T plus causal attention), which training
reports beside this one.
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _tree_param_count(cfg: ModelConfig) -> Tuple[int, int]:
    """(all parameters, those on an expert ``we_`` leaf)."""
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.spec import tree_items

    total = expert = 0
    for path, p in tree_items(lm_mod.model_spec(cfg)):
        n = math.prod(p.shape)
        total += n
        if "/we_" in path or path.startswith("we_"):
            expert += n
    return total, expert


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (embeddings included)."""
    return _tree_param_count(cfg)[0]


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: full experts replaced by top_k-worth."""
    total, expert = _tree_param_count(cfg)
    if cfg.moe is None or expert == 0:
        return total
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return int(total - expert + expert * frac)


def _tokens(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.family == "encdec":
        return shape.global_batch * max(
            256, shape.seq_len // cfg.encdec.dec_len_ratio)
    return shape.global_batch * shape.seq_len


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global MODEL_FLOPS for one step of this cell."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * _tokens(cfg, shape)
    if shape.kind == "prefill":
        return 2.0 * n_active * _tokens(cfg, shape)
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
