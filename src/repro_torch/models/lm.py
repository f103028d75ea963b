"""Language model of the port: the dense decoder (gemma3's local and
global layers among them, and the VLM stub pixtral, whose patch
embeddings replace the first token embeddings), MoE, RWKV, hybrid
(zamba2: Mamba2 layers with weight-tied shared attention blocks) and
encoder-decoder (whisper) paths of the reference's ``models/lm.py``, in
PyTorch.

Public API (the reference's, with an explicit ``device`` and seed):
  model_spec(cfg)                        -> Par tree
  init_params(cfg, seed, device)         -> random params
  cache_spec(cfg, batch, cache_len)      -> Par tree for decode state
  init_cache(cfg, batch, cache_len, device) -> zero cache
  train_loss(cfg, params, batch, opts)   -> scalar loss (fp32)
  prefill(cfg, params, batch, opts)      -> (last_logits [B,Vp], cache)
  decode_step(cfg, params, cache, token, pos, opts) -> (logits, cache)

Parameters, caches and activations keep the reference's layouts
(``wq`` [d, H, hd], ``wo`` [H, hd, d], q [B, S, H, hd], stacked caches
[stack, B, L, KV, hd]), so converted reference parameters
(``repro_torch.convert``) run unchanged and the tests compare like with
like.  Weight-pass products run through ``spm_matmul``, prefill
attention (the shared blocks' too) through ``flash_attention`` and
prefill WKV through ``wkv6``: their hand-written kernels for CUDA
tensors, their plain versions for CPU tensors.  The Mamba2 layers' SSD
scan is torch ops, as the reference's is jnp.

whisper's encoder runs over ``batch["frames"]`` (precomputed frame
embeddings [B, T, d] plus a learned position table) with unmasked
self-attention; each decoder layer projects the encoder memory once
into cross K/V (prefill), which the cache keeps at length T beside the
self K/V, and decode cross-attends over them.  The decoder adds a
learned position table too; decode looks it up at ``pos`` on the
device.

A zamba2 shared block attends over concat(x, x0), x0 the embedding
output, and selects tied block ``unit index % n_shared_blocks``; the
unit loops carry both.  Decode updates every cache buffer in place: the
new K/V rows (the shared blocks' included) and the recurrent states
(RWKV's, Mamba2's conv and SSM), so a captured decode graph's next
replay reads them.

Training: ``train_loss`` (``forward_hidden`` then the chunked
``lm_loss``, plus the MoE balance term) is differentiated by autograd.
Its products run through ``spm_matmul``'s and its prefill attention
through ``flash_attention``'s ``autograd.Function``, so on CUDA the
forward and backward products are kernel launches; each loss chunk's
fp32 logits are recomputed in the backward rather than kept
(``torch.utils.checkpoint``), and with ``RunOptions.remat`` so is each
unit, as the reference's ``jax.checkpoint`` does.

Entry points default to ``device="cuda"`` and take the CPU only when
asked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.spm_matmul import ops as spm_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import embed_lookup, rmsnorm, rmsnorm_spec
from repro_torch.models.spec import Par, init_tree, stack
from repro_torch.models.spec import param_count as spec_param_count
from repro_torch.models.spec import tree_from_items, tree_items, tree_map
from repro_torch.sharding.rules import placements_for, redistribute

Device = Union[str, torch.device]

MAX_POS_TABLE = 32_768  # whisper learned-position tables


@dataclass(frozen=True, eq=False)
class RunOptions:
    chunk_q: int = 512
    chunk_kv: int = 512
    loss_chunk: int = 512
    cache_len: int = 0        # prefill: cache buffer length (0 = seq len)
    remat: bool = True
    aux_weight: float = 0.01  # MoE load-balance loss weight
    moe_impl: str = "einsum"  # einsum (GShard baseline) | gather (§Perf)
    windowed_cache: bool = False  # ring-buffer KV for sliding-window
    #                               layers (wincache variant, §Perf)
    # decode-loop structure: True walks the stacked leaves, indexing
    # each unit as the loop reaches it; False indexes every unit's views
    # up front and walks that list.  None = follow cfg.scan_layers.
    # Both give identical results.
    decode_scan: Optional[bool] = None
    # spm_matmul tile (bm, bn) of the decode step's weight-pass products:
    # the serving plan's mm_bm/mm_bn pins, the tile its WCET bound counts.
    # None = the kernel's default plan for each shape.  (The reference
    # has no such field: its model path runs no kernel.)
    mm_tiles: Optional[Tuple[int, int]] = None
    # activation sharding constraints (resolved specs keyed by role,
    # ``launch.specs.act_shardings``); None = no constraint.  Keys: "x"
    # (residual stream [B,S,d]), "x_sp" (block outputs under seqpar),
    # "logits" ([B,C,V]), "kv" (cache [B,S,KV,hd]).  Read by ``_wsc``.
    shardings: Optional[dict] = None


DEFAULT_OPTS = RunOptions()


def _wsc(x: torch.Tensor, opts: RunOptions, key: str) -> torch.Tensor:
    """The reference's sharding constraint: a DTensor is redistributed
    to the placements ``opts.shardings[key]`` names on its own mesh; a
    plain tensor (every single-device run) is returned as it is.

    These constraints are the mesh-scale 'static schedule': they pin the
    activation layout the same way the paper's management core pins
    scratchpad residency."""
    if not opts.shardings or not isinstance(x, DTensor):
        return x
    spec = opts.shardings.get(key)
    if spec is None:
        return x
    return redistribute(x, placements_for(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# parameter / cache specs


def model_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    spec = {
        "embed": Par((cfg.padded_vocab, d), ("vocab", "embed"),
                     init="normal", dtype=cfg.dtype),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = Par((cfg.padded_vocab, d), ("vocab", "embed"),
                              init="normal", dtype=cfg.dtype)
    for si, st in enumerate(blk.build_stages(cfg)):
        spec[f"stage{si}"] = blk.stage_spec(cfg, st)
    if cfg.family == "hybrid":
        spec["shared"] = stack(blk.shared_block_spec(cfg),
                               cfg.ssm.n_shared_blocks)
    if cfg.family == "encdec":
        spec["encoder"] = {
            "stack": blk.stage_spec(cfg, blk.encoder_stage(cfg)),
            "norm": rmsnorm_spec(d),
            "pos": Par((MAX_POS_TABLE, d), (None, "embed"), init="normal",
                       dtype=cfg.dtype),
        }
        spec["dec_pos"] = Par((MAX_POS_TABLE, d), (None, "embed"),
                              init="normal", dtype=cfg.dtype)
    return spec


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Device = "cuda") -> dict:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""
    dev = compat.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_tree(model_spec(cfg), gen, dev)


def param_count(cfg: ModelConfig) -> int:
    """Total parameter count straight from the spec (no allocation) —
    what the serving WCET model sizes the per-step weight pass with."""
    return spec_param_count(model_spec(cfg))


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int,
               windowed: bool = False) -> dict:
    spec = {}
    for si, st in enumerate(blk.build_stages(cfg)):
        spec[f"stage{si}"] = blk.stage_cache_spec(cfg, st, batch,
                                                  cache_len, windowed)
    return spec


def _zeros(spec, device: torch.device) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape,
                                          dtype=compat.torch_dtype(p.dtype),
                                          device=device), spec)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: Device = "cuda") -> dict:
    return _zeros(cache_spec(cfg, batch, cache_len),
                  compat.resolve_device(device))


# ---------------------------------------------------------------------------
# embedding / logits


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           batch: Optional[dict] = None,
           opts: RunOptions = DEFAULT_OPTS) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if (cfg.frontend.kind == "patches" and cfg.frontend.num_positions
            and batch is not None and "patch_embeds" in batch):
        pe = batch["patch_embeds"].to(x.dtype)
        x[:, :pe.shape[1]] = pe
    return _wsc(x, opts, "x")


def _head_table(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def compute_logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x: [B, d] -> fp32 logits [B, padded_vocab] (padding masked).

    The [V, d] table is read in place as a transposed B operand of
    spm_matmul: no transposed copy of it is made.  ``tile`` pins the
    kernel's (bm, bn)."""
    head = _head_table(cfg, params)
    bm, bn = tile or (None, None)
    logits = spm_ops.matmul(x, head, trans_b=True, out_dtype=torch.float32,
                            bm=bm, bn=bn)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.padded_vocab != cfg.vocab_size:
        logits[:, cfg.vocab_size:] = -1e30
    return logits


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _chunk_loss(cfg: ModelConfig, xx: torch.Tensor, head: torch.Tensor,
                tt: torch.Tensor, opts: RunOptions,
                batch: int) -> torch.Tensor:
    """Sum over one chunk's rows of logsumexp(logits) - logits[target]:
    xx [R, d] (R = ``batch`` x chunk) against the [V, d] table
    (spm_matmul, ``trans_b``, fp32 out), the padded vocabulary masked to
    -1e30 (its rows of the table get exactly zero gradient)."""
    logits = spm_ops.matmul(xx, head, trans_b=True, out_dtype=torch.float32)
    if opts.shardings and isinstance(logits, DTensor):
        R, V = logits.shape
        logits = _wsc(logits.reshape(batch, R // batch, V), opts,
                      "logits").reshape(R, V)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = logits.gather(-1, tt[:, None])
    return torch.sum(lse - gold)


def lm_loss(cfg: ModelConfig, params: dict, x: torch.Tensor,
            targets: torch.Tensor, opts: RunOptions) -> torch.Tensor:
    """Chunked softmax cross-entropy (fp32 reductions).  x: [B,S,d].

    The reference's scan keeps every chunk's fp32 logits for its
    backward (16,384 x 151,936 x 4 B = 9.96 GB for qwen2 at batch 4 x
    4096); under autograd each chunk is recomputed in the backward
    instead (one more logits product per chunk), so one chunk's logits
    live at a time.  The value is the same."""
    B, S, d = x.shape
    head = _head_table(cfg, params)
    C = opts.loss_chunk if (opts.loss_chunk and S % opts.loss_chunk == 0
                            and S > opts.loss_chunk) else S
    recompute = _needs_grad(x, head)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, C):
        xx = x[:, s0:s0 + C].reshape(B * C, d)
        tt = targets[:, s0:s0 + C].reshape(B * C).long()
        if recompute:
            part = checkpoint(_chunk_loss, cfg, xx, head, tt, opts, B,
                              use_reentrant=False)
        else:
            part = _chunk_loss(cfg, xx, head, tt, opts, B)
        tot = tot + part
    return tot / (B * S)


# ---------------------------------------------------------------------------
# full-sequence unit application (train / prefill)


def _to_cache_buf(k: torch.Tensor, cache_len: int,
                  opts: RunOptions = DEFAULT_OPTS,
                  window: int = 0) -> torch.Tensor:
    if opts.windowed_cache and window > 0:
        L = min(cache_len, window)
        S = k.shape[1]
        if S > L:
            # ring layout: position p lives in slot p % L; the last L
            # positions cover every slot exactly once (cyclic shift)
            q0 = S - L
            return _wsc(torch.roll(k[:, q0:S], q0 % L, dims=1), opts, "kv")
        cache_len = L
    if cache_len <= k.shape[1]:
        return _wsc(k, opts, "kv")
    buf = torch.zeros((k.shape[0], cache_len) + tuple(k.shape[2:]),
                      dtype=k.dtype, device=k.device)
    buf[:, :k.shape[1]] = k
    return _wsc(buf, opts, "kv")


def _rwkv_layer_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     collect: bool):
    """One RWKV layer over the whole sequence; with ``collect``, its
    decode state ``{"tm": {"shift", "wkv"}, "cm"}``."""
    h = rmsnorm(x, p["ln_tm"])
    res = rwkv_mod.timemix_forward(p["tm"], h, cfg.rwkv,
                                   return_state=collect)
    tm, st = res if collect else (res, None)
    x = x + tm
    h = rmsnorm(x, p["ln_cm"])
    res = rwkv_mod.channelmix_forward(p["cm"], h, return_state=collect)
    cm, st2 = res if collect else (res, None)
    return x + cm, ({"tm": st, "cm": st2} if collect else None)


def _ffn(cfg: ModelConfig, p: dict, h: torch.Tensor, use_moe: bool,
         opts: RunOptions, tile: Optional[Tuple[int, int]] = None):
    """The layer's feed-forward part: (output, MoE aux loss or None)."""
    if not use_moe:
        return ffn_mod.dense_ffn(p["ffn"], h, cfg.activation, tile), None
    return ffn_mod.moe_ffn(
        p["moe"], h, cfg.moe, cfg.activation, opts.moe_impl,
        opts.shardings.get("x") if opts.shardings else None, tile)


def _shared_block_full(cfg: ModelConfig, sp: dict, x: torch.Tensor,
                       x0: torch.Tensor, positions: torch.Tensor,
                       opts: RunOptions, collect: bool):
    """zamba2's tied attention block over the whole sequence: attention
    over concat(x, x0) (d_in 2 x d_model) back to d_model, then the
    dense FFN.  Returns (x, (k, v) when ``collect``)."""
    h = rmsnorm(torch.cat([x, x0], dim=-1), sp["ln_in"])
    res = attn_mod.self_attention(
        sp["attn"], h, cfg.attention, positions,
        theta=cfg.attention.rope_theta, window=0, chunk_q=opts.chunk_q,
        chunk_kv=opts.chunk_kv, return_kv=collect)
    att, kv = res if collect else (res, None)
    x = x + att
    h2 = rmsnorm(x, sp["ln_ffn"])
    return x + ffn_mod.dense_ffn(sp["ffn"], h2, cfg.activation), kv


def _mamba_layer_full(cfg: ModelConfig, p: dict, dsc: blk.LayerDescr,
                      x: torch.Tensor, x0: torch.Tensor,
                      positions: torch.Tensor, opts: RunOptions,
                      collect: bool, shared: Optional[dict], unit_idx: int,
                      cache_len: int):
    """One hybrid layer over the whole sequence (the unit's first also
    runs its tied shared block); with ``collect``, its decode state
    ``{"conv", "ssm"}`` (and the shared block's ``shared_k``/``_v``)."""
    c = {}
    if dsc.shared_attn:
        sp = blk.tree_index(shared, unit_idx % cfg.ssm.n_shared_blocks)
        x, skv = _shared_block_full(cfg, sp, x, x0, positions, opts,
                                    collect)
        if collect:
            c["shared_k"] = _to_cache_buf(skv[0], cache_len, opts)
            c["shared_v"] = _to_cache_buf(skv[1], cache_len, opts)
    h = rmsnorm(x, p["ln"])
    res = ssm_mod.mamba_forward(p["mamba"], h, cfg.ssm,
                                return_state=collect)
    m, st = res if collect else (res, None)
    if collect:
        c["conv"], c["ssm"] = st["conv"], st["ssm"]
    return x + m, (c if collect else None)


def _dec_layer_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    memory: torch.Tensor, positions: torch.Tensor,
                    opts: RunOptions, collect: bool, cache_len: int):
    """One whisper decoder layer over the whole sequence: causal self
    attention, cross-attention over the encoder memory (projected here
    once into cross K/V), the dense FFN; with ``collect``, its decode
    state ``{"k", "v", "ck", "cv"}``."""
    a = cfg.attention
    h = rmsnorm(x, p["ln_self"])
    res = attn_mod.self_attention(
        p["self"], h, a, positions, theta=0.0, window=0,
        chunk_q=opts.chunk_q, chunk_kv=opts.chunk_kv, return_kv=collect)
    att, kv = res if collect else (res, None)
    x = x + att
    h = rmsnorm(x, p["ln_cross"])
    ck, cv = attn_mod.cross_kv(p["cross"], memory, a)
    x = x + attn_mod.cross_attention(p["cross"], h, ck, cv, a)
    h = rmsnorm(x, p["ln_ffn"])
    x = x + ffn_mod.dense_ffn(p["ffn"], h, cfg.activation)
    if not collect:
        return x, None
    return x, {"k": _to_cache_buf(kv[0], cache_len, opts),
               "v": _to_cache_buf(kv[1], cache_len, opts),
               "ck": ck, "cv": cv}


def _apply_unit_full(cfg: ModelConfig, up: dict, unit, x: torch.Tensor,
                     x0: torch.Tensor, positions: torch.Tensor,
                     opts: RunOptions, collect: bool,
                     memory: Optional[torch.Tensor],
                     shared: Optional[dict], unit_idx: int,
                     cache_len: int):
    cache = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    a = cfg.attention
    for i, dsc in enumerate(unit):
        p = up[f"pos{i}"]
        if dsc.kind in ("rwkv", "mamba", "dec_attn"):
            if dsc.kind == "rwkv":
                x, c = _rwkv_layer_full(cfg, p, x, collect)
            elif dsc.kind == "mamba":
                x, c = _mamba_layer_full(cfg, p, dsc, x, x0, positions,
                                         opts, collect, shared, unit_idx,
                                         cache_len)
            else:
                x, c = _dec_layer_full(cfg, p, x, memory, positions, opts,
                                       collect, cache_len)
            if collect:
                cache[f"pos{i}"] = c
            continue
        if dsc.kind not in ("attn", "enc_attn"):
            raise ValueError(dsc.kind)
        h = rmsnorm(x, p["ln_attn"])
        res = attn_mod.self_attention(
            p["attn"], h, a, positions, theta=dsc.theta, window=dsc.window,
            chunk_q=opts.chunk_q, chunk_kv=opts.chunk_kv,
            causal=dsc.causal, return_kv=collect)
        att, kv = res if collect else (res, None)
        if cfg.use_post_norm:
            att = rmsnorm(att, p["ln_attn_post"])
        x = x + _wsc(att, opts, "x_sp")
        h = rmsnorm(x, p["ln_ffn"])
        f, al = _ffn(cfg, p, h, dsc.use_moe, opts)
        if al is not None:
            aux = aux + al
        if cfg.use_post_norm:
            f = rmsnorm(f, p["ln_ffn_post"])
        x = x + _wsc(f, opts, "x_sp")
        if collect:
            cache[f"pos{i}"] = {
                "k": _to_cache_buf(kv[0], cache_len, opts, dsc.window),
                "v": _to_cache_buf(kv[1], cache_len, opts, dsc.window)}
    return x, aux, (cache if collect else None)


def _unit_params(sp: dict, n_units: int) -> list:
    """Each unit's parameter views, every stacked leaf unbound once.
    Under autograd, indexing a stacked leaf once per unit makes each
    index's backward fill a gradient the size of the whole stack (for
    qwen2, 24 fills of ~0.7 GB a step, then their sum); an unbind's
    backward is one ``stack``."""
    if n_units == 0:
        return []
    parts = {path: torch.unbind(leaf) for path, leaf in tree_items(sp)}
    return [tree_from_items(sp, {path: u[i] for path, u in parts.items()})
            for i in range(n_units)]


def _run_stage_full(cfg: ModelConfig, sp: dict, stage: blk.StageDescr,
                    x: torch.Tensor, x0: torch.Tensor,
                    positions: torch.Tensor, opts: RunOptions,
                    collect: bool, memory: Optional[torch.Tensor],
                    shared: Optional[dict], cache_len: int):
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = opts.remat and not collect and torch.is_grad_enabled()
    for i, up in enumerate(_unit_params(sp, stage.n_units)):
        args = (cfg, up, stage.unit, x, x0, positions, opts, collect,
                memory, shared, i, cache_len)
        if remat:
            # the reference's jax.checkpoint of the unit body: its
            # activations are recomputed in the backward, not kept
            x, d_aux, c = checkpoint(_apply_unit_full, *args,
                                     use_reentrant=False)
        else:
            x, d_aux, c = _apply_unit_full(*args)
        x = _wsc(x, opts, "x")
        aux = aux + d_aux
        caches.append(c)
    if not collect:
        return x, aux, None
    if not caches:
        # a stage of no units: leaves with a leading 0, as the
        # reference's scan over no units stacks them
        return x, aux, _zeros(blk.stage_cache_spec(
            cfg, stage, x.shape[0], cache_len, opts.windowed_cache),
            x.device)
    stacked = tree_map(lambda *xs: torch.stack(xs), *caches)
    return x, aux, stacked


def _encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            opts: RunOptions) -> torch.Tensor:
    """whisper's encoder: frames [B, T, d] in the model dtype plus the
    learned positions, the unmasked encoder stage, its norm."""
    enc = params["encoder"]
    T = frames.shape[1]
    x = frames.to(compat.torch_dtype(cfg.dtype)) + enc["pos"][:T]
    positions = torch.arange(T, dtype=torch.long, device=x.device)
    x, _, _ = _run_stage_full(cfg, enc["stack"], blk.encoder_stage(cfg), x,
                              x, positions, opts, False, None, None, 0)
    return rmsnorm(x, enc["norm"])


def forward_hidden(cfg: ModelConfig, params: dict, batch: dict,
                   opts: RunOptions = DEFAULT_OPTS, collect: bool = False,
                   cache_len: int = 0):
    """Run embeddings (and whisper's encoder) + all stages.  Returns (x,
    aux, caches); ``aux`` is the sum of the MoE layers' balance losses
    (0 without MoE)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens, batch, opts)
    memory = None
    if cfg.family == "encdec":
        x = x + params["dec_pos"][:S]
        memory = _encode(cfg, params, batch["frames"], opts)
    x0 = x
    positions = torch.arange(S, dtype=torch.long, device=tokens.device)
    shared = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    for si, st in enumerate(blk.build_stages(cfg)):
        x, a_i, c_i = _run_stage_full(cfg, params[f"stage{si}"], st, x, x0,
                                      positions, opts, collect, memory,
                                      shared, cache_len)
        aux = aux + a_i
        caches[f"stage{si}"] = c_i
    x = rmsnorm(x, params["final_norm"])
    return x, aux, (caches if collect else None)


# ---------------------------------------------------------------------------
# training


def train_loss(cfg: ModelConfig, params: dict, batch: dict,
               opts: RunOptions = DEFAULT_OPTS) -> torch.Tensor:
    """Scalar fp32 loss of one batch (``tokens``, ``targets``; whisper's
    ``frames``): the chunked cross-entropy plus ``aux_weight`` times
    the MoE layers' balance loss."""
    x, aux, _ = forward_hidden(cfg, params, batch, opts, collect=False)
    loss = lm_loss(cfg, params, x, batch["targets"], opts)
    return loss + opts.aux_weight * aux


# ---------------------------------------------------------------------------
# serving


def prefill(cfg: ModelConfig, params: dict, batch: dict,
            opts: RunOptions = DEFAULT_OPTS):
    """Process the prompt; returns (last-token fp32 logits, cache).
    The cache's buffers are ``opts.cache_len`` long (the prompt length
    when 0) and are updated in place by ``decode_step``."""
    S = batch["tokens"].shape[1]
    cache_len = opts.cache_len or S
    x, _, caches = forward_hidden(cfg, params, batch, opts, collect=True,
                                  cache_len=cache_len)
    logits = compute_logits(cfg, params, x[:, -1])
    return logits, caches


def _rwkv_layer_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       c: dict, tile: Optional[Tuple[int, int]]
                       ) -> torch.Tensor:
    """One RWKV decode step.  The new token-shift and WKV states are
    copied into the cache's buffers (``c``, views of the stacked cache),
    so a captured graph's next replay reads them."""
    h = rmsnorm(x, p["ln_tm"])
    tm, st = rwkv_mod.timemix_forward(p["tm"], h, cfg.rwkv, c["tm"],
                                      return_state=True, tile=tile)
    x = x + tm
    h = rmsnorm(x, p["ln_cm"])
    cm, st2 = rwkv_mod.channelmix_forward(p["cm"], h, c["cm"],
                                          return_state=True, tile=tile)
    c["tm"]["shift"].copy_(st["shift"])
    c["tm"]["wkv"].copy_(st["wkv"])
    c["cm"].copy_(st2)
    return x + cm


def _mamba_layer_decode(cfg: ModelConfig, p: dict, dsc: blk.LayerDescr,
                        x: torch.Tensor, x0: torch.Tensor,
                        pos: Union[int, torch.Tensor], c: dict,
                        shared: Optional[dict], unit_idx: int,
                        tile: Optional[Tuple[int, int]]) -> torch.Tensor:
    """One hybrid decode step.  The shared block's new K/V row is
    written into its cache in place (``decode_attention``); the new
    conv and SSM states are copied into the cache's buffers (``c``,
    views of the stacked cache), so a captured graph's next replay
    reads them."""
    if dsc.shared_attn:
        a = cfg.attention
        sp = blk.tree_index(shared, unit_idx % cfg.ssm.n_shared_blocks)
        h = rmsnorm(torch.cat([x, x0], dim=-1), sp["ln_in"])
        att, _, _ = attn_mod.decode_attention(
            sp["attn"], h, a, c["shared_k"], c["shared_v"], pos,
            theta=a.rope_theta, window=0, tile=tile)
        x = x + att
        h2 = rmsnorm(x, sp["ln_ffn"])
        x = x + ffn_mod.dense_ffn(sp["ffn"], h2, cfg.activation, tile)
    h = rmsnorm(x, p["ln"])
    m, st = ssm_mod.mamba_decode(p["mamba"], h, cfg.ssm,
                                 {"conv": c["conv"], "ssm": c["ssm"]},
                                 tile)
    c["conv"].copy_(st["conv"])
    c["ssm"].copy_(st["ssm"])
    return x + m


def _dec_layer_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      pos: Union[int, torch.Tensor], c: dict,
                      tile: Optional[Tuple[int, int]]) -> torch.Tensor:
    """One whisper decoder step: self decode attention writes its new
    K/V row into the cache in place; cross-attention reads the cached
    cross K/V (``decode=True``: torch ops, one query)."""
    a = cfg.attention
    h = rmsnorm(x, p["ln_self"])
    att, _, _ = attn_mod.decode_attention(p["self"], h, a, c["k"], c["v"],
                                          pos, theta=0.0, window=0,
                                          tile=tile)
    x = x + att
    h = rmsnorm(x, p["ln_cross"])
    x = x + attn_mod.cross_attention(p["cross"], h, c["ck"], c["cv"], a,
                                     decode=True, tile=tile)
    h = rmsnorm(x, p["ln_ffn"])
    return x + ffn_mod.dense_ffn(p["ffn"], h, cfg.activation, tile)


def _apply_unit_decode(cfg: ModelConfig, up: dict, unit, x: torch.Tensor,
                       x0: torch.Tensor, pos: Union[int, torch.Tensor],
                       cache_unit: dict, shared: Optional[dict],
                       unit_idx: int, opts: RunOptions) -> torch.Tensor:
    tile = opts.mm_tiles
    a = cfg.attention
    for i, dsc in enumerate(unit):
        p = up[f"pos{i}"]
        c = cache_unit[f"pos{i}"]
        if dsc.kind == "rwkv":
            x = _rwkv_layer_decode(cfg, p, x, c, tile)
            continue
        if dsc.kind == "mamba":
            x = _mamba_layer_decode(cfg, p, dsc, x, x0, pos, c, shared,
                                    unit_idx, tile)
            continue
        if dsc.kind == "dec_attn":
            x = _dec_layer_decode(cfg, p, x, pos, c, tile)
            continue
        if dsc.kind not in ("attn", "enc_attn"):
            raise ValueError(dsc.kind)
        h = rmsnorm(x, p["ln_attn"])
        att, _, _ = attn_mod.decode_attention(
            p["attn"], h, a, c["k"], c["v"], pos, theta=dsc.theta,
            window=dsc.window, tile=tile)
        if cfg.use_post_norm:
            att = rmsnorm(att, p["ln_attn_post"])
        x = x + att
        h = rmsnorm(x, p["ln_ffn"])
        f, _ = _ffn(cfg, p, h, dsc.use_moe, opts, tile)
        if cfg.use_post_norm:
            f = rmsnorm(f, p["ln_ffn_post"])
        x = x + f
    return x


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: Union[int, torch.Tensor],
                opts: RunOptions = DEFAULT_OPTS):
    """One decode step.  token: [B] int; pos: position of the new token,
    an int or a 0-d long tensor on the token's device (then the step
    reads no host value and can be captured as a CUDA graph).
    Returns (fp32 logits [B, padded_vocab], cache).

    The cache is preallocated and updated in place: the returned cache
    is the same buffers as ``cache``, holding the new token's K/V at
    ``pos`` (RWKV: the new token-shift and WKV states; ``pos`` is
    unused; Mamba2: the new conv and SSM states).  That in-place update
    is what ``compat.donated_jit`` (buffer donation) buys the
    reference.  whisper's decoder position is a device gather at
    ``pos``, so a captured graph replays it at each new position."""
    x = _embed(cfg, params, token[:, None], None, opts)
    if cfg.family == "encdec":
        x = x + params["dec_pos"].index_select(
            0, attn_mod.position_index(pos, x.device))
    x0 = x
    shared = params.get("shared")
    scan_units = (cfg.scan_layers if opts.decode_scan is None
                  else bool(opts.decode_scan))
    for si, st in enumerate(blk.build_stages(cfg)):
        sp, sc = params[f"stage{si}"], cache[f"stage{si}"]
        if scan_units:
            for i in range(st.n_units):
                x = _apply_unit_decode(cfg, blk.tree_index(sp, i), st.unit,
                                       x, x0, pos, blk.tree_index(sc, i),
                                       shared, i, opts)
        else:
            views = [(blk.tree_index(sp, i), blk.tree_index(sc, i))
                     for i in range(st.n_units)]
            for i, (up, cu) in enumerate(views):
                x = _apply_unit_decode(cfg, up, st.unit, x, x0, pos, cu,
                                       shared, i, opts)
    x = rmsnorm(x, params["final_norm"])
    logits = compute_logits(cfg, params, x[:, 0], opts.mm_tiles)
    return logits, cache
