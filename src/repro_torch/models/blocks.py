"""Layer-stack assembly of the port, from the reference's
``models/blocks.py``.

A model is a sequence of *stages*; each stage repeats ``n_units`` units;
a unit is a fixed tuple of layer descriptors.  Parameters of a stage
are stacked along a leading "stack" axis, one entry per unit, as in the
reference, so converted reference parameters keep their layout.

The port carries every family of the reference: dense and vlm
(including gemma3-style ``layer_pattern`` units of local and global
layers), MoE (every layer MoE, or llama4's alternating MoE and dense
layers), RWKV, hybrid and encoder-decoder:

  zamba2 : stage0: 13 units x [shared_attn+mamba, mamba x5],
           stage1: 1 unit   x [mamba x3]     (81 = 13*6 + 3)
  zamba2-7b-instruct (stages from ``hybrid_layer_ids``, runs of equal
           units): [mamba x6], [hybrid+mamba x4], 11 units x
           [hybrid+mamba x5], [hybrid+mamba x3]  (81 = 6 + 5 + 66 + 4)
  whisper: stage0: 6 units x [dec_attn] (self, cross, FFN); the
           encoder is its own stage (``encoder_stage``): 6 units x
           [enc_attn], not causal

A stage may hold 0 units (zamba2 cut to fewer layers than one unit):
its parameters and caches are stacked leaves with a leading 0, as the
reference's scan over no units gives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import rmsnorm_spec
from repro_torch.models.spec import Par, stack, tree_map


# ---------------------------------------------------------------------------
# descriptors


@dataclass(frozen=True)
class LayerDescr:
    kind: str                  # attn | mamba | rwkv | enc_attn | dec_attn
    window: int = 0            # 0 = global
    theta: float = 10_000.0
    use_moe: bool = False
    shared_attn: bool = False  # zamba2: tied attn block applied first
    causal: bool = True


@dataclass(frozen=True)
class StageDescr:
    n_units: int
    unit: Tuple[LayerDescr, ...]
    # hybrid ordinal of the stage's first tied-block application: unit i
    # (whose first layer runs one) applies block (first_hybrid + i) mod
    # n_shared_blocks
    first_hybrid: int = 0


def _published_hybrid_stages(num_layers: int,
                             ids: Tuple[int, ...]) -> Tuple[StageDescr, ...]:
    """Stages of the published Zamba2 layout: each hybrid id starts a
    segment that runs to the next id (the layers before the first are a
    segment of Mamba layers alone); runs of equal segments are one stage
    of that many units."""
    ids = sorted(ids)
    starts = ([0] if not ids or ids[0] > 0 else []) + ids
    segs = [(i in ids, (starts + [num_layers])[k + 1] - i)
            for k, i in enumerate(starts)]
    stages, ordinal, k = [], 0, 0
    while k < len(segs):
        n = 1
        while k + n < len(segs) and segs[k + n] == segs[k]:
            n += 1
        hyb, length = segs[k]
        unit = tuple(LayerDescr("mamba", shared_attn=hyb and j == 0)
                     for j in range(length))
        stages.append(StageDescr(n, unit, ordinal))
        ordinal += n if hyb else 0
        k += n
    return tuple(stages)


def build_stages(cfg: ModelConfig) -> Tuple[StageDescr, ...]:
    a = cfg.attention
    if cfg.family in ("dense", "vlm"):
        if a.layer_pattern:
            unit = tuple(
                LayerDescr("attn",
                           window=a.window_for_layer(i),
                           theta=(a.rope_theta_global or a.rope_theta)
                           if a.window_for_layer(i) == 0 else a.rope_theta)
                for i in range(len(a.layer_pattern)))
            return (StageDescr(cfg.num_layers // len(unit), unit),)
        unit = (LayerDescr("attn", theta=a.rope_theta),)
        return (StageDescr(cfg.num_layers, unit),)
    if cfg.family == "moe":
        m = cfg.moe
        if m.moe_every == 1:
            unit = (LayerDescr("attn", theta=a.rope_theta, use_moe=True),)
            return (StageDescr(cfg.num_layers, unit),)
        unit = tuple(
            LayerDescr("attn", theta=a.rope_theta,
                       use_moe=(i % m.moe_every == 0))
            for i in range(m.moe_every))
        return (StageDescr(cfg.num_layers // m.moe_every, unit),)
    if cfg.family == "hybrid":
        s = cfg.ssm
        if s.published:
            return _published_hybrid_stages(cfg.num_layers,
                                            s.hybrid_layer_ids)
        per = s.shared_attn_every
        n_full = cfg.num_layers // per
        tail = cfg.num_layers - n_full * per
        unit = tuple(
            LayerDescr("mamba", shared_attn=(i == 0)) for i in range(per))
        stages = [StageDescr(n_full, unit)]
        if tail:
            stages.append(StageDescr(
                1, tuple(LayerDescr("mamba") for _ in range(tail))))
        return tuple(stages)
    if cfg.family == "rwkv":
        return (StageDescr(cfg.num_layers, (LayerDescr("rwkv"),)),)
    if cfg.family == "encdec":
        unit = (LayerDescr("dec_attn", theta=0.0),)
        return (StageDescr(cfg.num_layers, unit),)
    raise ValueError(cfg.family)


def encoder_stage(cfg: ModelConfig) -> StageDescr:
    assert cfg.family == "encdec"
    return StageDescr(cfg.encdec.encoder_layers,
                      (LayerDescr("enc_attn", theta=0.0, causal=False),))


# ---------------------------------------------------------------------------
# per-layer parameter specs


def layer_spec(cfg: ModelConfig, dsc: LayerDescr) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    if dsc.kind in ("attn", "enc_attn"):
        p = {
            "ln_attn": rmsnorm_spec(d),
            "attn": attn_mod.attn_spec(d, cfg.attention, dt),
            "ln_ffn": rmsnorm_spec(d),
        }
        if dsc.use_moe:
            p["moe"] = ffn_mod.moe_spec(d, cfg.moe, cfg.activation, dt)
        else:
            p["ffn"] = ffn_mod.dense_ffn_spec(d, cfg.d_ff, cfg.activation,
                                              dt)
        if cfg.use_post_norm:
            p["ln_attn_post"] = rmsnorm_spec(d)
            p["ln_ffn_post"] = rmsnorm_spec(d)
        return p
    if dsc.kind == "dec_attn":
        return {
            "ln_self": rmsnorm_spec(d),
            "self": attn_mod.attn_spec(d, cfg.attention, dt),
            "ln_cross": rmsnorm_spec(d),
            "cross": attn_mod.attn_spec(d, cfg.attention, dt),
            "ln_ffn": rmsnorm_spec(d),
            "ffn": ffn_mod.dense_ffn_spec(d, cfg.d_ff, cfg.activation, dt),
        }
    if dsc.kind == "mamba":
        p = {
            "ln": rmsnorm_spec(d),
            "mamba": ssm_mod.mamba_spec(d, cfg.ssm, dt),
        }
        if dsc.shared_attn and cfg.ssm.published:
            # the published form's own weights of a hybrid layer: the
            # adapter on the tied block's gate/up product, and linear_i
            r = cfg.ssm.adapter_rank
            if r:
                p["adapter_a"] = Par((d, r), ("embed", None),
                                     init="scaled", dtype=dt)
                p["adapter_b"] = Par((r, 2 * cfg.d_ff), (None, "ffn"),
                                     init="scaled", dtype=dt)
            p["linear"] = Par((d, d), ("embed", None), init="scaled",
                              dtype=dt)
        return p
    if dsc.kind == "rwkv":
        return {
            "ln_tm": rmsnorm_spec(d),
            "tm": rwkv_mod.timemix_spec(d, cfg.rwkv, dt),
            "ln_cm": rmsnorm_spec(d),
            "cm": rwkv_mod.channelmix_spec(d, cfg.d_ff, dt),
        }
    raise ValueError(dsc.kind)


def shared_block_spec(cfg: ModelConfig) -> dict:
    """zamba2's weight-tied attention block operating on concat(x, x0).
    The published form's MLP has one gate/up product ``w_gate_up`` [d,
    2 d_ff] (gate first), as its adapter's output is laid out."""
    d, dt = cfg.d_model, cfg.dtype
    if cfg.ssm.published:
        return {
            "ln_in": rmsnorm_spec(2 * d),
            "attn": attn_mod.attn_spec(2 * d, cfg.attention, dt, d_out=d),
            "ln_ffn": rmsnorm_spec(d),
            "ffn": {
                "w_gate_up": Par((d, 2 * cfg.d_ff), ("embed", "ffn"),
                                 init="scaled", dtype=dt),
                "w_down": Par((cfg.d_ff, d), ("ffn", "embed"),
                              init="scaled", dtype=dt),
            },
        }
    return {
        "ln_in": rmsnorm_spec(2 * d),
        "attn": attn_mod.attn_spec(2 * d, cfg.attention, dt, d_out=d),
        "ln_ffn": rmsnorm_spec(d),
        "ffn": ffn_mod.dense_ffn_spec(d, cfg.d_ff, cfg.activation, dt),
    }


def stage_spec(cfg: ModelConfig, stage: StageDescr) -> dict:
    unit = {f"pos{i}": layer_spec(cfg, dsc)
            for i, dsc in enumerate(stage.unit)}
    return stack(unit, stage.n_units)


# ---------------------------------------------------------------------------
# cache specs (decode state)


def layer_cache_spec(cfg: ModelConfig, dsc: LayerDescr, batch: int,
                     cache_len: int, windowed: bool = False) -> dict:
    dt = cfg.dtype
    a = cfg.attention
    if dsc.kind in ("attn", "enc_attn"):
        L = cache_len
        if windowed and dsc.window > 0:
            # ring buffer: a sliding-window layer never attends past
            # `window` tokens back, so its cache is O(window)
            L = min(cache_len, dsc.window)
        return {
            "k": Par((batch, L, a.num_kv_heads, a.head_dim),
                     ("batch", "kv_seq", "kv_heads", None), init="zeros",
                     dtype=dt),
            "v": Par((batch, L, a.num_kv_heads, a.head_dim),
                     ("batch", "kv_seq", "kv_heads", None), init="zeros",
                     dtype=dt),
        }
    if dsc.kind == "dec_attn":
        # self K/V at the cache length; cross K/V at the encoder memory
        # length the decode steps see
        ek = cfg.encdec.cross_kv_len
        kv = ("batch", "kv_seq", "kv_heads", None)
        mem = ("batch", None, "kv_heads", None)
        return {
            "k": Par((batch, cache_len, a.num_kv_heads, a.head_dim), kv,
                     init="zeros", dtype=dt),
            "v": Par((batch, cache_len, a.num_kv_heads, a.head_dim), kv,
                     init="zeros", dtype=dt),
            "ck": Par((batch, ek, a.num_kv_heads, a.head_dim), mem,
                      init="zeros", dtype=dt),
            "cv": Par((batch, ek, a.num_kv_heads, a.head_dim), mem,
                      init="zeros", dtype=dt),
        }
    if dsc.kind == "mamba":
        c = ssm_mod.mamba_state_spec(batch, cfg.d_model, cfg.ssm, dt)
        if dsc.shared_attn:
            for name in ("shared_k", "shared_v"):
                c[name] = Par(
                    (batch, cache_len, a.num_kv_heads, a.head_dim),
                    ("batch", "kv_seq", "kv_heads", None), init="zeros",
                    dtype=dt)
        return c
    if dsc.kind == "rwkv":
        return rwkv_mod.rwkv_state_spec(batch, cfg.d_model, cfg.rwkv, dt)
    raise ValueError(dsc.kind)


def stage_cache_spec(cfg: ModelConfig, stage: StageDescr, batch: int,
                     cache_len: int, windowed: bool = False) -> dict:
    unit = {f"pos{i}": layer_cache_spec(cfg, dsc, batch, cache_len,
                                        windowed)
            for i, dsc in enumerate(stage.unit)}
    return stack(unit, stage.n_units)


# ---------------------------------------------------------------------------
# tree helpers


def tree_index(tree, i: int):
    """Index the leading (stack) axis of every leaf: views, no copies,
    so in-place writes to an indexed cache land in the stacked buffer."""
    return tree_map(lambda a: a[i], tree)
