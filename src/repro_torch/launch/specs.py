"""Input specs for every (architecture x shape) cell (the reference's
``launch/specs.py``).

``meta`` DTensor stand-ins over a production ``DeviceMesh``, placed by
the sharding rules: nothing is ever allocated for the full-size models.
Each spec is a Par tree realized by ``models.spec.shape_tree``; the
same tree through ``pspec_tree`` gives the resolved entries without a
mesh.  ``input_specs`` returns the arguments of the cell's step
function:

  train   -> step(params, opt_state, batch)
  prefill -> step(params, batch)
  decode  -> step(params, cache, token, pos)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models.spec import Par, meta_tensor, shape_tree
from repro_torch.optim.adamw import adamw_init_spec
from repro_torch.sharding.rules import ShardingRules, make_rules


def rules_for(mesh, cfg: ModelConfig, shape: ShapeConfig,
              variant: str = "baseline") -> ShardingRules:
    """Build sharding rules, optionally applying optimization variants
    (all semantics-preserving):

      serving_tp — inference weights stationary on the model axis only
                   (no per-token FSDP gathers).
      seqpar     — Megatron-style sequence parallelism: the residual
                   stream is sharded on the model axis between blocks.
      kvshard    — shard head_dim on the model axis when the (kv-)head
                   count doesn't divide it.

    Combine with '+': e.g. "seqpar+kvshard".
    """
    kind = shape.kind
    if shape.kind == "decode" and shape.global_batch == 1:
        kind = "long_decode"
    r = make_rules(mesh, kind, shape.global_batch)
    parts = set(variant.split("+")) if variant else {"baseline"}
    if "serving_tp" in parts and shape.kind in ("decode", "prefill"):
        r = dataclasses.replace(r, fsdp_axes=())
    if "seqpar" in parts:
        r = dataclasses.replace(r, act_seq_axes=r.tensor_axes)
    if "kvshard" in parts:
        r = dataclasses.replace(r, head_dim_axes=r.tensor_axes)
    return r


def batch_pars(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Par]:
    """Token/target (+ frontend stub) leaves for train/prefill."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        # frames are the encoder input (conv frontend stubbed); decoder
        # sees seq/dec_len_ratio tokens.
        dec = max(256, S // cfg.encdec.dec_len_ratio)
        return {
            "tokens": Par((B, dec), ("batch", None), dtype="int32"),
            "targets": Par((B, dec), ("batch", None), dtype="int32"),
            "frames": Par((B, S, cfg.d_model), ("batch", None, None),
                          dtype=cfg.dtype),
        }
    out = {
        "tokens": Par((B, S), ("batch", None), dtype="int32"),
        "targets": Par((B, S), ("batch", None), dtype="int32"),
    }
    if cfg.frontend.kind == "patches" and cfg.frontend.num_positions:
        out["patch_embeds"] = Par(
            (B, cfg.frontend.num_positions, cfg.d_model),
            ("batch", None, None), dtype=cfg.dtype)
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules) -> Dict:
    return shape_tree(batch_pars(cfg, shape), rules)


def decode_token_par(cfg: ModelConfig, shape: ShapeConfig) -> Par:
    return Par((shape.global_batch,), ("batch",), dtype="int32")


def decode_token_spec(cfg: ModelConfig, shape: ShapeConfig,
                      rules: ShardingRules):
    p = decode_token_par(cfg, shape)
    return meta_tensor(p.shape, p.dtype, rules, p.axes)


def params_specs(cfg: ModelConfig, rules: ShardingRules):
    return shape_tree(lm_mod.model_spec(cfg), rules)


def opt_specs(cfg: ModelConfig, rules: ShardingRules):
    return shape_tree(adamw_init_spec(lm_mod.model_spec(cfg)), rules)


def cache_pars(cfg: ModelConfig, shape: ShapeConfig,
               variant: str = "baseline") -> dict:
    return lm_mod.cache_spec(cfg, shape.global_batch, shape.seq_len,
                             "wincache" in variant)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules, variant: str = "baseline"):
    return shape_tree(cache_pars(cfg, shape, variant), rules)


def act_shardings(cfg: ModelConfig, shape: ShapeConfig,
                  rules: ShardingRules) -> dict:
    """Resolved specs of the activation sharding constraints (see
    ``models.lm._wsc``): residual stream, loss logits, KV-cache buffers.
    Under the `seqpar` variant the residual stream's sequence dim is
    sharded on the model axis (rules.act_seq_axes)."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    out = {
        "x": rules.spec_for(("batch", "seq", None), (B, S, d)),
        "logits": rules.spec_for(("batch", None, "vocab"),
                                 (B, 1, cfg.padded_vocab)),
    }
    if rules.act_seq_axes:
        # full Megatron-SP: block outputs constrained seq-sharded
        out["x_sp"] = rules.spec_for(("batch", "seq", None), (B, S, d))
    if cfg.attention is not None:
        a = cfg.attention
        out["kv"] = rules.spec_for(("batch", "kv_seq", "kv_heads", None),
                                   (B, S, a.num_kv_heads, a.head_dim))
    return out


def run_options(cfg: ModelConfig, shape: ShapeConfig, mesh,
                variant: str = "baseline",
                **overrides) -> "lm_mod.RunOptions":
    rules = rules_for(mesh, cfg, shape, variant)
    kw = dict(shardings=act_shardings(cfg, shape, rules))
    if "moe_gather" in variant:
        kw["moe_impl"] = "gather"
    if "moe_ep" in variant:
        kw["moe_impl"] = "ep"
    if "wincache" in variant:
        kw["windowed_cache"] = True
    kw.update(overrides)
    return lm_mod.RunOptions(**kw)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                variant: str = "baseline") -> Tuple:
    """Everything the cell's step function needs, as meta DTensors."""
    rules = rules_for(mesh, cfg, shape, variant)
    if shape.kind == "train":
        return (params_specs(cfg, rules), opt_specs(cfg, rules),
                batch_specs(cfg, shape, rules))
    if shape.kind == "prefill":
        return (params_specs(cfg, rules), batch_specs(cfg, shape, rules))
    # decode
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return (params_specs(cfg, rules),
            cache_specs(cfg, shape, rules, variant),
            decode_token_spec(cfg, shape, rules), pos)
