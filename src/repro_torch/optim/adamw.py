"""AdamW, the cosine LR schedule, gradient clipping and the train step
of the port (the reference's ``optim/adamw.py``).

Moments are fp32 regardless of the (bf16) parameter dtype; the update
math runs in fp32 and is cast back.  Decoupled weight decay applies to
matrices only.  Gradients come from autograd (``torch.autograd.grad``
over detached copies of the parameter leaves) where the reference has
``jax.value_and_grad``; trees are the port's nested dicts, walked in the
reference's leaf order (``models.spec.tree_items``).
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models.spec import (Par, tree_from_items, tree_items,
                                     tree_map)


# ---------------------------------------------------------------------------
# schedules


def cosine_lr(tcfg: TrainConfig) -> Callable:
    """step (0-d tensor) -> fp32 learning rate: linear warm-up, then a
    cosine decay to zero at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = tcfg.learning_rate * (step + 1) / max(1, tcfg.warmup_steps)
        prog = torch.clamp((step - tcfg.warmup_steps)
                           / max(1, tcfg.total_steps - tcfg.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog)) * tcfg.learning_rate
        return torch.where(step < tcfg.warmup_steps, warm, cos)
    return lr


# ---------------------------------------------------------------------------
# AdamW


def adamw_init(params: dict) -> dict:
    """Zero fp32 moments beside each leaf and an int32 step count."""
    device = next(p for _, p in tree_items(params)).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_init_spec(spec_tree) -> dict:
    """Par-tree for the optimizer state (the dry run's stand-ins)."""
    f32 = lambda p: replace(p, dtype="float32", init="zeros")
    return {
        "m": tree_map(f32, spec_tree),
        "v": tree_map(f32, spec_tree),
        "count": Par((), (), init="zeros", dtype="int32"),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for _, leaf in tree_items(tree)))


# elements of one slice of a donated leaf's update (its fp32
# temporaries are a few times this, not the leaf's size)
DONATE_SLICE = 1 << 24


def adamw_update(grads: dict, opt_state: dict, params: dict,
                 tcfg: TrainConfig, lr_fn: Callable,
                 gnorm: Optional[torch.Tensor] = None,
                 donate: bool = False):
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).
    ``gnorm`` is ``global_norm(grads)`` when the caller has it.

    ``donate`` writes the new parameters and moments into the given
    ones, a slice of the leading axis at a time, as the reference's
    ``jax.jit(..., donate_argnums=(0, 1))`` lets XLA reuse their
    buffers: the same bits (the update is elementwise), without a second
    copy of the state and the fp32 temporaries of a whole leaf at
    once."""
    count = opt_state["count"] + 1
    lr = lr_fn(opt_state["count"])
    gnorm = global_norm(grads) if gnorm is None else gnorm
    clip = (torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if tcfg.grad_clip > 0 else 1.0)

    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float() * clip
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / c1
        vhat = v_new / c2
        step = mhat / (torch.sqrt(vhat) + eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step = step + wd * p.float()
        p_new = (p.float() - lr * step).to(p.dtype)
        return p_new, m_new, v_new

    leaves = zip(tree_items(params), tree_items(grads),
                 tree_items(opt_state["m"]), tree_items(opt_state["v"]))
    if donate:
        with torch.no_grad():
            for (_, p), (_, g), (_, m), (_, v) in leaves:
                rows = (max(1, DONATE_SLICE * p.shape[0] // p.numel())
                        if p.dim() and p.numel() else 1)
                for i in range(0, p.shape[0] if p.dim() else 1, rows):
                    sl = slice(i, i + rows) if p.dim() else ...
                    for dst, src in zip((p[sl], m[sl], v[sl]),
                                        upd(p[sl], g[sl], m[sl], v[sl])):
                        dst.copy_(src)
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "count": count}, {"grad_norm": gnorm, "lr": lr}
    out = {path: upd(p, g, m, v) for (path, p), (_, g), (_, m), (_, v)
           in leaves}
    part = lambda i: tree_from_items(params, {k: t[i]
                                              for k, t in out.items()})
    new_state = {"m": part(1), "v": part(2), "count": count}
    return part(0), new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# train step factory


def value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)``: autograd over
    detached leaves that share the parameters' storage.  A leaf the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    items = list(tree_items(params))
    leaves = [p.detach().requires_grad_() for _, p in items]
    tree = tree_from_items(params, {path: leaf for (path, _), leaf
                                    in zip(items, leaves)})
    loss = loss_fn(tree, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_from_items(params, {
        path: torch.zeros_like(leaf) if g is None else g
        for (path, _), leaf, g in zip(items, leaves, grads)})


def loss_and_grads(loss_fn: Callable, params: dict, batch: dict,
                   microbatch: int = 0):
    """(loss, grads) of one batch; with ``microbatch`` > 1 the batch is
    cut along its first axis and the microbatches' gradients are summed
    in fp32, then averaged."""
    if not (microbatch and microbatch > 1):
        return value_and_grad(loss_fn, params, batch)
    per = next(iter(batch.values())).shape[0] // microbatch
    first = next(p for _, p in tree_items(params))
    loss = torch.zeros((), dtype=torch.float32, device=first.device)
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(microbatch):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        l, g = value_and_grad(loss_fn, params, mb)
        loss = loss + l
        grads = tree_map(torch.add, grads, g)
    return loss / microbatch, tree_map(lambda g: g / microbatch, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    opts: Optional[lm_mod.RunOptions] = None,
                    donate: bool = False):
    """Returns step(params, opt_state, batch, loss_scale=1.0) ->
    (params, opt_state, metrics); ``batch`` holds tensors on the
    parameters' device.  With ``tcfg.microbatch`` > 1 the batch is cut
    along its first axis and the microbatches' gradients are summed in
    fp32, then averaged.

    Non-finite guard: if the (scaled) loss or the gradient norm comes
    out NaN/Inf — a transient numeric fault, real or injected via
    ``loss_scale`` — no update is made: the step reads the two on the
    host before any update and returns ``params`` and ``opt_state``
    themselves, bit-exact, with ``metrics["finite"]`` False; the
    trainer retries the step.  A healthy step runs exactly the
    unguarded update; with ``donate`` it writes it into ``params`` and
    ``opt_state`` (``adamw_update``)."""
    opts = opts or lm_mod.DEFAULT_OPTS
    lr_fn = cosine_lr(tcfg)
    base_loss_fn = lambda p, b: lm_mod.train_loss(cfg, p, b, opts)

    def step(params, opt_state, batch, loss_scale=1.0):
        # scale *inside* the differentiated function so a NaN scale
        # poisons gradients too (the realistic fault shape); scale 1.0
        # is an IEEE no-op, keeping healthy steps bit-exact
        loss_fn = lambda p, b: base_loss_fn(p, b) * loss_scale
        loss, grads = loss_and_grads(loss_fn, params, batch,
                                     tcfg.microbatch)
        gnorm = global_norm(grads)
        finite = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if finite:
            params, opt_state, info = adamw_update(
                grads, opt_state, params, tcfg, lr_fn, gnorm, donate)
        else:
            info = {"grad_norm": gnorm, "lr": lr_fn(opt_state["count"])}
        return params, opt_state, {"loss": loss, "finite": finite, **info}

    return step
