"""Plain reference of a decoder with image positions: Pixtral-12B's text
backbone (Mistral-NeMo style: pre-norm RMSNorm, GQA with half-split
RoPE, SwiGLU, untied LM head), in float32 with TF32 off.

The vision encoder is a stub: the first ``image`` positions of a prompt
take the given patch embeddings in place of their token embeddings.
Departures from the published model are the configuration's
(``configs/<name>.json``, ``reduced``): RMSNorm's epsilon is the run's.

It imports nothing but torch.  Everything is computed layer by layer
from the bf16 parameters, each layer's weights widened to fp32 as it is
reached, so the reference fits beside the served weights.  The same
forward also gives the control: ``precision="fp8"`` rounds both operands
of every weight product to float8 e4m3 (per output column and per row),
the step below bf16 that would tempt a faster serving path.

Also here, from shapes alone: the parameter layout the benchmark draws,
the kernel launches one replay makes (for the rooflines) and a step's
model FLOPs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench import counts
from portbench.reference.common import (fp32_only, matmul, normal, ones,
                                        rmsnorm)

Q_BLOCK = 1024


def dims(config: dict) -> dict:
    """The sizes this family reads from a configuration file."""
    return {"layers": config["num_hidden_layers"],
            "d": config["hidden_size"],
            "heads": config["num_attention_heads"],
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config["head_dim"],
            "ff": config["intermediate_size"],
            "vocab": config["vocab_size"],
            "rope_theta": float(config["rope_theta"]),
            "eps": float(config["rms_norm_eps"]),
            "dtype": config["dtype"]}


def layout(dm: dict) -> List[tuple]:
    """(path, shape, dtype, init) of every parameter, as the port's
    parameter tree names them.  Weights are N(0, 1/fan-in), the
    embeddings N(0, 1), norm scales N(1, 0.1^2): activations of unit
    size at every layer, and logits whose top few are near each other."""
    L, d, V = dm["layers"], dm["d"], dm["vocab"]
    H, KV, hd, ff = dm["heads"], dm["kv_heads"], dm["head_dim"], dm["ff"]
    w = dm["dtype"]
    s = "stage0/pos0/"
    return [
        ("embed", (V, d), w, normal(1.0)),
        ("final_norm", (d,), "float32", ones()),
        ("lm_head", (V, d), w, normal(d ** -0.5)),
        (s + "attn/wk", (L, d, KV, hd), w, normal(d ** -0.5)),
        (s + "attn/wo", (L, H, hd, d), w, normal((H * hd) ** -0.5)),
        (s + "attn/wq", (L, d, H, hd), w, normal(d ** -0.5)),
        (s + "attn/wv", (L, d, KV, hd), w, normal(d ** -0.5)),
        (s + "ffn/w_down", (L, ff, d), w, normal(ff ** -0.5)),
        (s + "ffn/w_gate", (L, d, ff), w, normal(d ** -0.5)),
        (s + "ffn/w_up", (L, d, ff), w, normal(d ** -0.5)),
        (s + "ln_attn", (L, d), "float32", ones()),
        (s + "ln_ffn", (L, d), "float32", ones()),
    ]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split rotation: x [N, S, n, hd]; cos, sin [S, hd/2]."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal GQA in fp32, a block of queries at a time.
    q [N, S, H, hd], k/v [N, S, KV, hd] -> [N, S, H, hd]."""
    N, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(N, S, KV, G, hd)
    out = torch.empty_like(qg)
    pos = torch.arange(S, device=q.device)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        s = torch.einsum("nqkgh,ntkh->nkgqt", qg[:, q0:q1], k[:, :q1]) * scale
        s = s.masked_fill(pos[None, :q1] > pos[q0:q1, None], -math.inf)
        p = torch.softmax(s, dim=-1)
        out[:, q0:q1] = torch.einsum("nkgqt,ntkh->nqkgh", p, v[:, :q1])
    return out.reshape(N, S, H, hd)


@fp32_only
def logits(dm: dict, params: dict, tokens: torch.Tensor,
           positions: Sequence[int], image: Optional[torch.Tensor] = None,
           precision: str = "fp32") -> torch.Tensor:
    """fp32 logits [N, len(positions), vocab] at ``positions`` of the
    plain forward over ``tokens`` [N, S], the first ``image.shape[1]``
    positions embedded by ``image`` [N, I, d]."""
    mm = matmul(precision)
    N, S = tokens.shape
    d, H, KV, hd = dm["d"], dm["heads"], dm["kv_heads"], dm["head_dim"]
    eps = dm["eps"]
    st = params["stage0"]["pos0"]
    x = params["embed"][tokens].float()
    if image is not None:
        x[:, :image.shape[1]] = image.float()
    inv = 1.0 / dm["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    scale = 1.0 / math.sqrt(hd)
    for layer in range(dm["layers"]):
        a = {k: t[layer] for k, t in st["attn"].items()}
        f = {k: t[layer] for k, t in st["ffn"].items()}
        h = rmsnorm(x, st["ln_attn"][layer], eps)
        q = mm(h, a["wq"].reshape(d, H * hd)).reshape(N, S, H, hd)
        k = mm(h, a["wk"].reshape(d, KV * hd)).reshape(N, S, KV, hd)
        v = mm(h, a["wv"].reshape(d, KV * hd)).reshape(N, S, KV, hd)
        o = _attention(_rope(q, cos, sin), _rope(k, cos, sin), v, scale)
        x = x + mm(o.reshape(N, S, H * hd), a["wo"].reshape(H * hd, d))
        h = rmsnorm(x, st["ln_ffn"][layer], eps)
        g = F.silu(mm(h, f["w_gate"])) * mm(h, f["w_up"])
        x = x + mm(g, f["w_down"])
    h = rmsnorm(x[:, list(positions)], params["final_norm"], eps)
    return mm(h, params["lm_head"].t())


# ---------------------------------------------------------------- counts


def _products(dm: dict, m: int) -> List[tuple]:
    """(m, k, n, count) of the weight products of one pass over every
    layer at m rows."""
    d, H, KV, hd, ff = (dm["d"], dm["heads"], dm["kv_heads"],
                        dm["head_dim"], dm["ff"])
    L = dm["layers"]
    return [(m, d, H * hd, L), (m, d, KV * hd, 2 * L), (m, H * hd, d, L),
            (m, d, ff, 2 * L), (m, ff, d, L)]


def launches(dm: dict, batch: int, prompt: int, phase: str
             ) -> Dict[str, list]:
    """The port's kernel launches of one replay, as ``counts.Cost``s by
    kernel: ``decode`` (one token a sequence) or ``prefill`` (``prompt``
    tokens a sequence; the logits at the last one)."""
    m = batch if phase == "decode" else batch * prompt
    mm = [counts.matmul(mi, k, n) for mi, k, n, c in _products(dm, m)
          for _ in range(c)]
    mm.append(counts.matmul(batch, dm["d"], dm["vocab"],
                            out_bytes=counts.FP32))
    out = {"spm_matmul": mm}
    if phase == "prefill":
        out["flash_attention"] = [counts.flash(
            batch, prompt, prompt, dm["heads"], dm["kv_heads"],
            dm["head_dim"], True)] * dm["layers"]
    return out


def step_flops(dm: dict, batch: int, tokens: int, past: int) -> float:
    """Model FLOPs of ``tokens`` new positions a sequence after ``past``
    cached ones: 2 x the parameters the products read x tokens, the
    logits at one position, and causal attention over the positions
    attended (QK^T and PV, 2 operations a multiply-add)."""
    prods = sum(2.0 * k * n * c for _, k, n, c in _products(dm, 1))
    head = 2.0 * dm["d"] * dm["vocab"]
    pairs = sum(past + i + 1 for i in range(tokens))
    attn = 4.0 * dm["heads"] * dm["head_dim"] * pairs * dm["layers"]
    return batch * (prods * tokens + head + attn)
