"""Compositional cost pieces (the reference's ``analysis/pieces.py``) —
the paper's timing-compositionality (§3.1) applied to roofline
accounting.

A whole-model trace of a 95-layer model would repeat every unit; instead
each *repeat unit* is traced on its own (with the true shardings) and
the costs compose:

    total = sum over pieces ( piece_cost x multiplier )

Pieces are chosen, as the reference's are, so that each piece's
internal loops are degenerate:
 * attention units run with chunk_q=chunk_kv=0 (single-block attention
   is FLOP-identical to the chunked schedule),
 * recurrent units (Mamba2/RWKV6) run at one chunk of sequence with
   multiplier n_units * (S / chunk)  (all their costs are linear in S),
 * zamba2's quadratic shared-attention block is split out as its own
   full-sequence piece,
 * the loss runs with loss_chunk=0,
 * the optimizer update is one piece over the full parameter tree.

A piece is a plain function over ``meta`` DTensors placed by the
sharding rules (``launch/specs.py``).  Train pieces take gradients with
``torch.autograd.grad`` where the reference uses ``jax.grad``.  Plain
tensors the model makes beside its inputs (positions, masks, rope
tables, zero buffers) hold the same values on every device and are
taken as replicated (``implicit_replication``, applied by the runner),
as XLA replicates the reference's iotas and constants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import blocks as blk
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import rmsnorm
from repro_torch.models.lm import RunOptions
from repro_torch.models.spec import (Par, meta_tensor, shape_tree, stack,
                                     tree_from_items, tree_items)
from repro_torch.optim.adamw import adamw_init_spec, adamw_update, cosine_lr
from repro_torch.sharding.rules import ShardingRules, redistribute


@dataclass
class Piece:
    name: str
    multiplier: float
    fn: Callable
    specs: Tuple


def _x_spec(cfg, B, S, rules):
    return meta_tensor((B, S, cfg.d_model), cfg.dtype, rules,
                       ("batch", None, None))


def _unit_param_specs(cfg, stage: blk.StageDescr, rules):
    unit = {f"pos{i}": blk.layer_spec(cfg, dsc)
            for i, dsc in enumerate(stage.unit)}
    return shape_tree(unit, rules)


def _unit_cache_specs(cfg, stage, B, cache_len, rules):
    unit = {f"pos{i}": blk.layer_cache_spec(cfg, dsc, B, cache_len)
            for i, dsc in enumerate(stage.unit)}
    return shape_tree(unit, rules)


def _shared_specs(cfg, rules):
    return shape_tree(stack(blk.shared_block_spec(cfg),
                            cfg.ssm.n_shared_blocks), rules)


def _head_specs(cfg, rules):
    """Embedding, final norm and (untied) head leaves."""
    table = Par((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                dtype=cfg.dtype)
    spec = {"embed": table,
            "final_norm": Par((cfg.d_model,), (None,), dtype="float32")}
    if not cfg.tie_embeddings:
        spec["lm_head"] = table
    return shape_tree(spec, rules)


def _dec_len(cfg, shape) -> int:
    if cfg.family == "encdec":
        return max(256, shape.seq_len // cfg.encdec.dec_len_ratio)
    return shape.seq_len


def _is_recurrent_stage(stage: blk.StageDescr) -> bool:
    return any(d.kind in ("mamba", "rwkv") for d in stage.unit)


def _positions(S):
    return torch.arange(S, dtype=torch.long, device="meta")


def _grads(loss: torch.Tensor, trees) -> list:
    """Gradients of ``loss`` with respect to every leaf of ``trees``
    (the leaves the caller made differentiable), each laid out as its
    leaf is (a Partial sum over the batch shards is reduce-scattered),
    as the reference's gradients come out with their inputs'
    shardings."""
    leaves = [t for tree in trees for t in _leaves(tree) if t.requires_grad]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [g if g is None or not isinstance(g, DTensor)
            else redistribute(g, t.placements)
            for t, g in zip(leaves, grads)]


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for _, t in tree_items(tree)]


def _differentiable(tree):
    """The tree with its floating leaves detached and requiring grad."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().requires_grad_(tree.is_floating_point())
    return tree_from_items(tree, {
        path: t.detach().requires_grad_(t.is_floating_point())
        for path, t in tree_items(tree)})


def _unit_fn(cfg, stage, opts, *, train: bool, collect: bool,
             has_shared: bool, has_memory: bool):
    """fn(unit_params, x, x0, shared?, memory?) running one unit."""

    def fwd(up, x, x0, shared, memory):
        out, aux, cache = lm_mod._apply_unit_full(
            cfg, up, stage.unit, x, x0, _positions(x.shape[1]), opts,
            collect, memory, shared, 0, x.shape[1])
        loss = out.float().sum() + aux
        return (loss, cache) if collect else loss

    if train:
        def step(up, x, x0, shared=None, memory=None):
            up, x = _differentiable(up), _differentiable(x)
            if has_shared:
                shared = _differentiable(shared)
            wrt = (up, x) + ((shared,) if has_shared else ())
            return _grads(fwd(up, x, x0, shared, memory), wrt)
    else:
        def step(up, x, x0, shared=None, memory=None):
            return fwd(up, x, x0, shared, memory)
    return step


def _strip_shared_attn(stage: blk.StageDescr) -> blk.StageDescr:
    unit = tuple(dataclasses.replace(d, shared_attn=False)
                 for d in stage.unit)
    return blk.StageDescr(stage.n_units, unit)


def _chunked_stage_pieces(cfg, stage, si, B, S, rules, opts, train,
                          collect) -> List[Piece]:
    """Recurrent stage: one unit at one chunk of sequence."""
    chunk = (cfg.ssm.chunk_size if cfg.family == "hybrid"
             else cfg.rwkv.chunk_size)
    chunk = min(chunk, S)
    n_chunks = S // chunk
    pieces = []
    # shared-attention applications (zamba2) — full-sequence quadratic
    n_shared_apps = sum(1 for d in stage.unit if d.shared_attn) \
        * stage.n_units
    if n_shared_apps:
        def shared_fn(shared, x, x0):
            def fwd(shared, x, x0):
                sp = blk.tree_index(shared, 0)
                out, _ = lm_mod._shared_block_full(
                    cfg, sp, x, x0, _positions(x.shape[1]),
                    RunOptions(chunk_q=0, chunk_kv=0,
                               shardings=opts.shardings), False)
                return out.float().sum()
            if train:
                shared, x = _differentiable(shared), _differentiable(x)
                return _grads(fwd(shared, x, x0), (shared, x))
            return fwd(shared, x, x0)
        pieces.append(Piece(
            f"stage{si}_shared_attn", n_shared_apps, shared_fn,
            (_shared_specs(cfg, rules), _x_spec(cfg, B, S, rules),
             _x_spec(cfg, B, S, rules))))

    stage1 = _strip_shared_attn(blk.StageDescr(1, (stage.unit[-1],)))
    n_layers = stage.n_units * len(stage.unit)
    fn = _unit_fn(cfg, stage1, opts, train=train, collect=collect,
                  has_shared=False, has_memory=False)
    pieces.append(Piece(
        f"stage{si}_unit_chunk", n_layers * n_chunks, fn,
        (_unit_param_specs(cfg, stage1, rules),
         _x_spec(cfg, B, chunk, rules), _x_spec(cfg, B, chunk, rules))))
    return pieces


def _piece_opts(opts: RunOptions, **kw) -> RunOptions:
    """Exact-FLOP single-block attention and an unchunked loss."""
    return RunOptions(chunk_q=0, chunk_kv=0, shardings=opts.shardings,
                      moe_impl=opts.moe_impl, **kw)


def _stage_pieces(cfg, shape, rules, popts, train: bool) -> List[Piece]:
    """One piece per attention stage's unit (recurrent stages chunked),
    plus whisper's encoder unit."""
    B, S = shape.global_batch, _dec_len(cfg, shape)
    pieces: List[Piece] = []
    for si, stage in enumerate(blk.build_stages(cfg)):
        if _is_recurrent_stage(stage):
            pieces += _chunked_stage_pieces(cfg, stage, si, B, S, rules,
                                            popts, train, False)
            continue
        has_mem = any(d.kind == "dec_attn" for d in stage.unit)
        fn = _unit_fn(cfg, stage, popts, train=train, collect=not train,
                      has_shared=False, has_memory=has_mem)
        specs = [_unit_param_specs(cfg, stage, rules),
                 _x_spec(cfg, B, S, rules), _x_spec(cfg, B, S, rules)]
        if has_mem:
            specs.append(None)   # shared placeholder
            specs.append(_x_spec(cfg, B, shape.seq_len, rules))
        pieces.append(Piece(f"stage{si}_unit", stage.n_units, fn,
                            tuple(specs)))
    if cfg.family == "encdec":
        enc = blk.encoder_stage(cfg)
        fn = _unit_fn(cfg, enc, popts, train=train, collect=False,
                      has_shared=False, has_memory=False)
        pieces.append(Piece(
            "encoder_unit", enc.n_units, fn,
            (_unit_param_specs(cfg, enc, rules),
             _x_spec(cfg, B, shape.seq_len, rules),
             _x_spec(cfg, B, shape.seq_len, rules))))
    return pieces


def train_pieces(cfg: ModelConfig, shape: ShapeConfig,
                 rules: ShardingRules, opts: RunOptions) -> List[Piece]:
    B, S = shape.global_batch, _dec_len(cfg, shape)
    popts = _piece_opts(opts, loss_chunk=0, remat=False)
    pieces = _stage_pieces(cfg, shape, rules, popts, True)

    # embedding + loss (fwd+bwd)
    def embed_loss(ep, tokens, targets, x_fin):
        ep, x_fin = _differentiable(ep), _differentiable(x_fin)
        x = lm_mod._embed(cfg, ep, tokens, None, popts)
        h = rmsnorm(x_fin, ep["final_norm"])
        loss = lm_mod.lm_loss(cfg, ep, h, targets, popts)
        loss = loss + 1e-9 * x.float().sum()
        return _grads(loss, (ep, x_fin))

    tok = meta_tensor((B, S), "int32", rules, ("batch", None))
    pieces.append(Piece("embed_loss", 1.0, embed_loss,
                        (_head_specs(cfg, rules), tok, tok,
                         _x_spec(cfg, B, S, rules))))

    # optimizer update over the whole parameter tree
    tcfg = TrainConfig()
    lr_fn = cosine_lr(tcfg)

    def opt_piece(params, opt_state, grads):
        return adamw_update(grads, opt_state, params, tcfg, lr_fn)

    pspec = shape_tree(lm_mod.model_spec(cfg), rules)
    ospec = shape_tree(adamw_init_spec(lm_mod.model_spec(cfg)), rules)
    pieces.append(Piece("optimizer", 1.0, opt_piece,
                        (pspec, ospec, pspec)))
    return pieces


def prefill_pieces(cfg, shape, rules, opts) -> List[Piece]:
    B, S = shape.global_batch, _dec_len(cfg, shape)
    popts = _piece_opts(opts, loss_chunk=0, remat=False)
    pieces = _stage_pieces(cfg, shape, rules, popts, False)

    def head_fn(ep, tokens, x_fin):
        x = lm_mod._embed(cfg, ep, tokens, None, popts)
        h = rmsnorm(x_fin[:, -1], ep["final_norm"])
        return lm_mod.compute_logits(cfg, ep, h), x.sum()

    tok = meta_tensor((B, S), "int32", rules, ("batch", None))
    pieces.append(Piece("embed_head", 1.0, head_fn,
                        (_head_specs(cfg, rules), tok,
                         _x_spec(cfg, B, S, rules))))
    return pieces


def decode_pieces(cfg, shape, rules, opts) -> List[Piece]:
    B = shape.global_batch
    cache_len = shape.seq_len
    popts = _piece_opts(opts)
    pieces: List[Piece] = []
    for si, stage in enumerate(blk.build_stages(cfg)):
        has_shared = any(d.shared_attn for d in stage.unit)

        def mk(stage_):
            def fn(up, cache_u, x, x0, shared=None):
                out = lm_mod._apply_unit_decode(
                    cfg, up, stage_.unit, x, x0, cache_len - 1, cache_u,
                    shared, 0, popts)
                return out, cache_u
            return fn

        specs = [
            _unit_param_specs(cfg, stage, rules),
            _unit_cache_specs(cfg, stage, B, cache_len, rules),
            _x_spec(cfg, B, 1, rules), _x_spec(cfg, B, 1, rules)]
        if has_shared:
            specs.append(_shared_specs(cfg, rules))
        pieces.append(Piece(f"stage{si}_unit", stage.n_units, mk(stage),
                            tuple(specs)))

    def head_fn(ep, token, x_fin):
        x = lm_mod._embed(cfg, ep, token[:, None], None, popts)
        h = rmsnorm(x_fin[:, 0], ep["final_norm"])
        return lm_mod.compute_logits(cfg, ep, h), x.sum()

    tok = meta_tensor((B,), "int32", rules, ("batch",))
    pieces.append(Piece("embed_head", 1.0, head_fn,
                        (_head_specs(cfg, rules), tok,
                         _x_spec(cfg, B, 1, rules))))
    return pieces


def cost_pieces(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules, opts: RunOptions) -> List[Piece]:
    if shape.kind == "train":
        return train_pieces(cfg, shape, rules, opts)
    if shape.kind == "prefill":
        return prefill_pieces(cfg, shape, rules, opts)
    return decode_pieces(cfg, shape, rules, opts)
