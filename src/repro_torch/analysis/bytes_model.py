"""Itemized analytic HBM-traffic model, bytes per device per step (the
reference's ``analysis/bytes_model.py``, held to it exactly).

The traced "bytes accessed" of a dry run is an UNFUSED upper bound: it
counts every local op's inputs and outputs (the full attention score
matrix among them), which a program with flash-tiled kernels never
moves.  This model itemizes the traffic a deployed program pays:

  * weights: fwd read + bwd read (+ remat re-read) per step,
  * optimizer: fp32 moments read+write, grads read, params read+write,
  * activations: residual stream + block internals per layer, with
    attention at flash cost (K/V re-streamed once per query chunk),
  * embeddings/logits: token gathers + chunked logits,
  * KV cache read/write for decode.

All terms are per device.  The batch, sequence and vocab shards are
divided out with the reference's fixed 16-way data and model axes,
whatever ``chips`` is.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.analysis.flops import active_param_count, param_count
from repro_torch.configs.base import ModelConfig, ShapeConfig

BF16 = 2
F32 = 4


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int = 256,
                   chunk_q: int = 512,
                   weight_shards: int = 0) -> Dict[str, float]:
    """weight_shards: how many ways the weights are sharded (defaults to
    `chips`; 16 under the serving_tp variant where weights live on the
    model axis only)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        S_dec = max(256, S // cfg.encdec.dec_len_ratio)
    else:
        S_dec = S
    d = cfg.d_model
    L = cfg.num_layers
    n_params = param_count(cfg)
    n_active = active_param_count(cfg)

    ws = weight_shards or chips
    items: Dict[str, float] = {}

    if shape.kind == "train":
        tokens_dev = B * S_dec / 16   # batch sharded on data axis (16)
        act = tokens_dev * d * BF16
        # weights: fwd + bwd + remat recompute reads, grad write (f32)
        items["weights"] = 3 * (n_active * BF16 / ws) \
            + n_params * F32 / chips
        # optimizer: m,v read+write (f32), grad read, param read+write
        items["optimizer"] = n_params * (4 * F32 + F32 + 2 * BF16) / chips
        # activations: ~12 residual-width tensors per layer fwd +
        # ~2x that for bwd+recompute
        items["activations"] = L * act * 12 * 3
        if cfg.attention is not None:
            a = cfg.attention
            kv_bytes = B / 16 * S_dec * a.num_kv_heads * a.head_dim * BF16
            n_qchunks = max(1, S_dec // chunk_q)
            items["attention_kv_stream"] = L * 2 * kv_bytes * n_qchunks
        # logits: chunked [B,C,V] f32 write+read (fwd+bwd), vocab/16
        items["logits"] = 2 * 2 * tokens_dev * cfg.padded_vocab / 16 * F32
        items["embed_gather"] = 3 * tokens_dev * d * BF16
    elif shape.kind == "prefill":
        tokens_dev = B * S_dec / 16
        act = tokens_dev * d * BF16
        items["weights"] = n_active * BF16 / ws
        items["activations"] = L * act * 12
        if cfg.attention is not None:
            a = cfg.attention
            kv_bytes = B / 16 * S_dec * a.num_kv_heads * a.head_dim * BF16
            n_qchunks = max(1, S_dec // chunk_q)
            items["attention_kv_stream"] = L * 2 * kv_bytes * n_qchunks
            items["kv_cache_write"] = L * 2 * kv_bytes / 16
        items["logits"] = B / 16 * cfg.padded_vocab / 16 * F32
        items["embed_gather"] = tokens_dev * d * BF16
    else:  # decode
        # every weight shard is read once per token
        items["weights"] = n_active * BF16 / ws
        if cfg.attention is not None and cfg.family not in ("rwkv",):
            a = cfg.attention
            kv_global = (B * S * a.num_kv_heads * a.head_dim * BF16
                         * 2 * L)
            items["kv_cache_read"] = kv_global / chips
            items["kv_cache_write"] = B * a.num_kv_heads * a.head_dim \
                * BF16 * 2 * L / 16
        if cfg.family in ("rwkv", "hybrid"):
            # recurrent state read+write
            if cfg.rwkv is not None:
                H = d // cfg.rwkv.head_dim
                st = B * H * cfg.rwkv.head_dim ** 2 * BF16 * L
            else:
                d_in = cfg.ssm.expand * d
                H = d_in // cfg.ssm.head_dim
                st = B * H * cfg.ssm.state_dim * cfg.ssm.head_dim \
                    * BF16 * L
            items["state_rw"] = 2 * st / 16
        bdev = max(1, B // 16)
        items["activations"] = L * bdev * d * BF16 * 12
        items["logits"] = bdev * cfg.padded_vocab / 16 * F32

    items["total"] = sum(items.values())
    return items
