"""Plain reference of Zamba2 (Zamba2-7B-Instruct's published form): a
stack of Mamba2 layers, some of which first run one of two weight-tied
transformer blocks over concat(x, x0); in float32 with TF32 off.

Per layer i, x0 the embedding output:

    hybrid (i in hybrid_layer_ids, k its ordinal, block k mod 2):
      T = RMSNorm(concat(x, x0));  T = Attn(T)   (RoPE over the whole
          head, causal, scale (head_dim / 2)^-1/2)
      T = RMSNorm(T);  [g | u] = T W_gu + (T A_k) B_k
      T = (gelu(g) u) W_down;  T = T L_k
      x = x + Mamba(RMSNorm(x + T))
    Mamba only:  x = x + Mamba(RMSNorm(x))

Mamba2: [z | xBC | dt] = h W_in; xBC through a causal depthwise conv of
width K and SiLU; x, then B and C in G groups of N (each shared by H / G
consecutive heads); dt = softplus(dt + dt_bias) (not clamped: the
config's ``time_step_limit`` is null); a = -exp(A_log) dt; the SSD in
its quadratic form, per head h of group g,

    y_i = sum_{j <= i} exp(sum_{j < k <= i} a_k) (C_i . B_j) dt_j x_j
          + D x_i

then RMSNorm(y silu(z)) over each group's channels, and W_out.  The LM
head is the embedding table.  The port computes the same function in
its chunked form; nothing here is taken from it.

It imports nothing but torch.  Layer by layer from the bf16 parameters,
as ``vlm.py``; ``precision="fp8"`` gives the control.  Also here: the
parameter layout, the launches of one replay, a step's model FLOPs, and
the least work of the Mamba layers (``mamba_costs``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench import counts
from portbench.reference.common import (fp32_only, matmul, normal, ones,
                                        rmsnorm, uniform)

Q_BLOCK = 1024


def dims(config: dict) -> dict:
    """The sizes this family reads from a configuration file."""
    return {"layers": config["num_hidden_layers"],
            "d": config["hidden_size"],
            "heads": config["num_attention_heads"],
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config["attention_head_dim"],
            "ff": config["intermediate_size"],
            "vocab": config["vocab_size"],
            "rope_theta": float(config["rope_theta"]),
            "eps": float(config["rms_norm_eps"]),
            "state": config["mamba_d_state"],
            "ssm_head_dim": config["mamba_headdim"],
            "expand": config["mamba_expand"],
            "groups": config["mamba_ngroups"],
            "conv": config["mamba_d_conv"],
            "ssm_heads": config["n_mamba_heads"],
            "chunk": config["chunk_size"],
            "hybrid": tuple(config["hybrid_layer_ids"]),
            "blocks": config["num_mem_blocks"],
            "adapter_rank": config["adapter_rank"],
            "dtype": config["dtype"]}


def stages(dm: dict) -> List[tuple]:
    """(units, layers a unit, whether its first layer is hybrid) of each
    stage, as the port's parameter tree stacks them: a hybrid id starts
    a segment that runs to the next (the layers before the first id are
    one), and runs of equal segments are one stage."""
    ids = sorted(dm["hybrid"])
    starts = ([0] if not ids or ids[0] > 0 else []) + ids
    ends = starts[1:] + [dm["layers"]]
    segs = [(e - s, s in ids) for s, e in zip(starts, ends)]
    out: List[list] = []
    for seg in segs:
        if out and out[-1][1:] == list(seg):
            out[-1][0] += 1
        else:
            out.append([1, *seg])
    return [tuple(s) for s in out]


def _layer_sites(dm: dict) -> List[tuple]:
    """(stage, unit, position in the unit, hybrid ordinal or None) of
    each layer, in order."""
    sites, k = [], 0
    for si, (n, length, hyb) in enumerate(stages(dm)):
        for u in range(n):
            for j in range(length):
                first = hyb and j == 0
                sites.append((si, u, j, k if first else None))
                k += first
    return sites


def _mamba_widths(dm: dict) -> tuple:
    """(d_inner, conv channels, in_proj columns)."""
    di = dm["expand"] * dm["d"]
    conv = di + 2 * dm["groups"] * dm["state"]
    return di, conv, di + conv + dm["ssm_heads"]


def layout(dm: dict) -> List[tuple]:
    """(path, shape, dtype, init) of every parameter, as the port's
    parameter tree names them.  Weights are N(0, 1/fan-in), the tied
    embedding N(0, 1/d) (logits whose top few are near each other, as
    the other families' heads give), norm scales N(1, 0.1^2).  Mamba2's
    own, as its initialisation draws them: A = -exp(A_log) from -1 to
    -16, dt_bias so that softplus gives dt from about 1e-3 to 0.1, D
    near one, the conv N(0, 1/K)."""
    d, V, ff, r = dm["d"], dm["vocab"], dm["ff"], dm["adapter_rank"]
    H, KV, hd, nb = dm["heads"], dm["kv_heads"], dm["head_dim"], dm["blocks"]
    di, conv, n_in = _mamba_widths(dm)
    nh, K = dm["ssm_heads"], dm["conv"]
    w, f32 = dm["dtype"], "float32"
    out = [("embed", (V, d), w, normal(d ** -0.5)),
           ("final_norm", (d,), f32, ones()),
           ("shared/attn/wk", (nb, 2 * d, KV, hd), w, normal((2 * d) ** -0.5)),
           ("shared/attn/wo", (nb, H, hd, d), w, normal((H * hd) ** -0.5)),
           ("shared/attn/wq", (nb, 2 * d, H, hd), w, normal((2 * d) ** -0.5)),
           ("shared/attn/wv", (nb, 2 * d, KV, hd), w, normal((2 * d) ** -0.5)),
           ("shared/ffn/w_down", (nb, ff, d), w, normal(ff ** -0.5)),
           ("shared/ffn/w_gate_up", (nb, d, 2 * ff), w, normal(d ** -0.5)),
           ("shared/ln_ffn", (nb, d), f32, ones()),
           ("shared/ln_in", (nb, 2 * d), f32, ones())]
    for si, (n, length, hyb) in enumerate(stages(dm)):
        for j in range(length):
            s = f"stage{si}/pos{j}/"
            out += [
                (s + "ln", (n, d), f32, ones()),
                (s + "mamba/A_log", (n, nh), f32, uniform(0.0, math.log(16))),
                (s + "mamba/D", (n, nh), f32, ones()),
                (s + "mamba/conv_b", (n, conv), w, normal(0.1)),
                (s + "mamba/conv_w", (n, K, conv), w, normal(K ** -0.5)),
                (s + "mamba/dt_bias", (n, nh), f32, uniform(-6.9, -2.3)),
                (s + "mamba/in_proj", (n, d, n_in), w, normal(d ** -0.5)),
                (s + "mamba/norm", (n, di), f32, ones()),
                (s + "mamba/out_proj", (n, di, d), w, normal(di ** -0.5))]
            if hyb and j == 0:
                out += [(s + "adapter_a", (n, d, r), w, normal(d ** -0.5)),
                        (s + "adapter_b", (n, r, 2 * ff), w,
                         normal(r ** -0.5)),
                        (s + "linear", (n, d, d), w, normal(d ** -0.5))]
    return out


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-split rotation: x [N, S, n, hd]; cos, sin [S, hd/2]."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention in fp32 (as many K/V heads as query heads), a
    block of queries at a time.  q, k, v [N, S, H, hd]."""
    N, S, H, hd = q.shape
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        s = torch.einsum("nqhd,nthd->nhqt", q[:, q0:q1], k[:, :q1]) * scale
        s = s.masked_fill(pos[None, :q1] > pos[q0:q1, None], -math.inf)
        out[:, q0:q1] = torch.einsum("nhqt,nthd->nqhd",
                                     torch.softmax(s, dim=-1), v[:, :q1])
    return out


def _ssd(x, a, Bm, Cm, dt, D) -> torch.Tensor:
    """The SSD's quadratic form.  x [N, S, H, P], a and dt [N, S, H],
    Bm and Cm [N, S, G, n], D [H] -> y [N, S, H, P]; one group's heads
    at a time."""
    N, S, H, P = x.shape
    G = Bm.shape[2]
    Hg = H // G
    cs = torch.cumsum(a, dim=1)                             # [N, S, H]
    later = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    y = torch.empty_like(x)
    for g in range(G):
        hs = slice(g * Hg, (g + 1) * Hg)
        # exp of the log-decays summed over (j, i]: cs_i - cs_j, j <= i
        seg = cs[:, :, hs].permute(0, 2, 1)                 # [N, Hg, S]
        seg = (seg[:, :, :, None] - seg[:, :, None, :]).masked_fill(
            later, -math.inf).exp()                         # [N, Hg, i, j]
        cb = torch.einsum("bic,bjc->bij", Cm[:, :, g], Bm[:, :, g])
        w = seg * cb[:, None] * dt[:, :, hs].permute(0, 2, 1)[:, :, None, :]
        y[:, :, hs] = torch.einsum("nhij,njhp->nihp", w, x[:, :, hs])
    return y + x * D[:, None]


def _mamba(dm: dict, p: dict, h: torch.Tensor, mm) -> torch.Tensor:
    """A Mamba2 mixer over h [N, S, d] (fp32) -> [N, S, d]."""
    N, S, _ = h.shape
    di, conv, _ = _mamba_widths(dm)
    G, n, nh, P = dm["groups"], dm["state"], dm["ssm_heads"], \
        dm["ssm_head_dim"]
    zxbcdt = mm(h, p["in_proj"])
    z, xbc, dt = zxbcdt.split([di, conv, nh], dim=-1)
    K = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    w = p["conv_w"].float()
    xbc = sum(xp[:, k:k + S] * w[k] for k in range(K)) + p["conv_b"].float()
    xbc = F.silu(xbc)
    x, Bm, Cm = xbc.split([di, G * n, G * n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float()) * dt
    y = _ssd(x.reshape(N, S, nh, P), a, Bm.reshape(N, S, G, n),
             Cm.reshape(N, S, G, n), dt, p["D"].float())
    g = (y.reshape(N, S, di) * F.silu(z)).reshape(N, S, G, di // G)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + dm["eps"])
    return mm(g.reshape(N, S, di) * p["norm"].float(), p["out_proj"])


def _tied_block(dm: dict, b: dict, p: dict, x, x0, cos, sin, mm):
    """T of a hybrid layer: tied block ``b`` with the layer's adapter
    and ``linear`` (``p``)."""
    N, S, d = x.shape
    H, hd = dm["heads"], dm["head_dim"]
    eps = dm["eps"]
    h = rmsnorm(torch.cat([x, x0], dim=-1), b["ln_in"], eps)
    q, k, v = (mm(h, b["attn"][w].reshape(2 * d, H * hd))
               .reshape(N, S, H, hd) for w in ("wq", "wk", "wv"))
    o = _attention(_rope(q, cos, sin), _rope(k, cos, sin), v,
                   (hd / 2) ** -0.5)
    t = rmsnorm(mm(o.reshape(N, S, H * hd), b["attn"]["wo"].reshape(-1, d)),
                b["ln_ffn"], eps)
    gu = mm(t, b["ffn"]["w_gate_up"]) + mm(mm(t, p["adapter_a"]),
                                           p["adapter_b"])
    g, u = gu.chunk(2, dim=-1)
    return mm(mm(F.gelu(g) * u, b["ffn"]["w_down"]), p["linear"])


@fp32_only
def logits(dm: dict, params: dict, tokens: torch.Tensor,
           positions: Sequence[int], image: Optional[torch.Tensor] = None,
           precision: str = "fp32") -> torch.Tensor:
    """fp32 logits [N, len(positions), vocab] at ``positions`` of the
    plain forward over ``tokens`` [N, S] (``image``: none in this
    family)."""
    if image is not None:
        raise ValueError("the hybrid family takes no image positions")
    mm = matmul(precision)
    N, S = tokens.shape
    hd, eps = dm["head_dim"], dm["eps"]
    x = params["embed"][tokens].float()
    x0 = x
    inv = 1.0 / dm["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    for si, u, j, k in _layer_sites(dm):
        p = {name: _index(t, u) for name, t in
             params[f"stage{si}"][f"pos{j}"].items()}
        h = x
        if k is not None:
            b = {name: _index(t, k % dm["blocks"])
                 for name, t in params["shared"].items()}
            h = x + _tied_block(dm, b, p, x, x0, cos, sin, mm)
        x = x + _mamba(dm, p["mamba"], rmsnorm(h, p["ln"], eps), mm)
    h = rmsnorm(x[:, list(positions)], params["final_norm"], eps)
    return mm(h, params["embed"][:dm["vocab"]].t())


def _index(t, i: int):
    """Entry ``i`` of a stacked leaf, or of each leaf of a subtree."""
    if isinstance(t, dict):
        return {k: _index(v, i) for k, v in t.items()}
    return t[i]


# ---------------------------------------------------------------- counts


def _products(dm: dict, m: int) -> List[tuple]:
    """(m, k, n, count) of the weight products of one pass over every
    layer at m rows: each Mamba layer's in_proj and out_proj; each
    hybrid layer's q, k, v, o, gate/up, adapter (two), down and
    linear."""
    d, H, hd, ff, r = (dm["d"], dm["heads"], dm["head_dim"], dm["ff"],
                       dm["adapter_rank"])
    di, _, n_in = _mamba_widths(dm)
    L, nh = dm["layers"], len(dm["hybrid"])
    return [(m, d, n_in, L), (m, di, d, L),
            (m, 2 * d, H * hd, 3 * nh), (m, H * hd, d, nh),
            (m, d, 2 * ff, nh), (m, d, r, nh), (m, r, 2 * ff, nh),
            (m, ff, d, nh), (m, d, d, nh)]


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
            dm["head_dim"], True)] * len(dm["hybrid"])
    return out


def _recurrence_flops(dm: dict) -> float:
    """The SSM recurrence of one token in every layer: per head the
    state's decay and B x^T added (2 n P), and C h read out (2 n P)."""
    return (4.0 * dm["state"] * dm["ssm_head_dim"] * dm["ssm_heads"]
            * dm["layers"])


def step_flops(dm: dict, batch: int, tokens: int, past: int) -> float:
    """Model FLOPs of ``tokens`` new positions a sequence after ``past``
    cached ones: 2 x the parameters the products read x tokens, the
    logits at one position, the SSM recurrence, and the tied blocks'
    causal attention over the positions attended (QK^T and PV)."""
    prods = sum(2.0 * k * n * c for _, k, n, c in _products(dm, 1))
    head = 2.0 * dm["d"] * dm["vocab"]
    pairs = sum(past + i + 1 for i in range(tokens))
    attn = 4.0 * dm["heads"] * dm["head_dim"] * pairs * len(dm["hybrid"])
    return batch * ((prods + _recurrence_flops(dm)) * tokens + head + attn)


def mamba_costs(dm: dict, batch: int, prompt: int, phase: str
                ) -> List[counts.Cost]:
    """The least work of the Mamba layers' spans in one replay, a
    ``counts.Cost`` per piece: each layer's in_proj and out_proj
    products (``counts.matmul``), and its scan: the recurrence at 4 n P
    operations a token and head, with x, B, C and z read once and y
    written once in the model's dtype (in decode also the state read
    once and written once, in the cache's dtype, the model's)."""
    elt = counts.BF16 if dm["dtype"] == "bfloat16" else counts.FP32
    tokens = batch * (1 if phase == "decode" else prompt)
    di, _, n_in = _mamba_widths(dm)
    gn = dm["groups"] * dm["state"]
    scan_bytes = tokens * (3 * di + 2 * gn) * elt
    if phase == "decode":
        scan_bytes += 2 * batch * dm["ssm_heads"] * dm["state"] \
            * dm["ssm_head_dim"] * elt
    per_layer = [counts.matmul(tokens, dm["d"], n_in),
                 counts.matmul(tokens, di, dm["d"]),
                 counts.Cost(_recurrence_flops(dm) / dm["layers"] * tokens,
                             float(scan_bytes))]
    return per_layer * dm["layers"]
