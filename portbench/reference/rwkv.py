"""Plain reference of RWKV-6 "Finch" (arXiv:2404.05892): token shift
with data-dependent mixing (a LoRA of five), the WKV recurrence with a
data-dependent decay (a LoRA of its own) and a bonus u, a per-head
group norm and a SiLU gate, then the squared-ReLU channel mix; in
float32 with TF32 off.

Per head, with S a K x V state starting at zero:
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   w_t = exp(-exp(w0 + lora(x)))
run position by position, exactly as written.  Departures from the
published model are the configuration's (``configs/<name>.json``,
``reduced``): RMSNorm in place of LayerNorm, no ``ln0`` after the
embedding, and a group norm without bias.

It imports nothing but torch.  Layer by layer from the bf16 parameters,
as ``vlm.py``; ``precision="fp8"`` gives the control.  Also here: the
parameter layout, the launches of one replay and a step's model FLOPs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench import counts
from portbench.reference.common import (fp32_only, matmul, normal, ones,
                                        rmsnorm, uniform)


def dims(config: dict) -> dict:
    return {"layers": config["n_layer"], "d": config["n_embd"],
            "head_dim": config["head_size_a"], "ff": config["dim_ffn"],
            "vocab": config["vocab_size"],
            "mix_lora": config["time_mix_extra_dim"],
            "decay_lora": config["time_decay_extra_dim"],
            "eps": float(config["norm_eps"]),
            "gn_eps": float(config["group_norm_eps"]),
            "dtype": config["dtype"]}


def layout(dm: dict) -> List[tuple]:
    """(path, shape, dtype, init) of every parameter, as the port's
    tree names them.  Mixing coefficients uniform in [0, 1) as trained
    RWKV-6 models have them, decays w0 in [-6, -0.5) (memories from a
    couple of tokens to some hundreds), u of size 0.5, the LoRAs' second
    halves small so each adjusts its base by about a tenth."""
    L, d, V, ff = dm["layers"], dm["d"], dm["vocab"], dm["ff"]
    hd, ml, dl = dm["head_dim"], dm["mix_lora"], dm["decay_lora"]
    H = d // hd
    w = dm["dtype"]
    s = "stage0/pos0/"
    f32 = "float32"
    return [
        ("embed", (V, d), w, normal(1.0)),
        ("final_norm", (d,), f32, ones()),
        ("lm_head", (V, d), w, normal(d ** -0.5)),
        (s + "cm/maa_k", (L, d), f32, uniform(0.0, 1.0)),
        (s + "cm/maa_r", (L, d), f32, uniform(0.0, 1.0)),
        (s + "cm/wk", (L, d, ff), w, normal(d ** -0.5)),
        (s + "cm/wr", (L, d, d), w, normal(d ** -0.5)),
        (s + "cm/wv", (L, ff, d), w, normal(ff ** -0.5)),
        (s + "ln_cm", (L, d), f32, ones()),
        (s + "ln_tm", (L, d), f32, ones()),
        (s + "tm/ln_x", (L, d), f32, ones()),
        (s + "tm/maa_rkvwg", (L, 5, d), f32, uniform(0.0, 1.0)),
        (s + "tm/maa_x", (L, d), f32, uniform(0.0, 1.0)),
        (s + "tm/mix_w1", (L, d, 5 * ml), w, normal(d ** -0.5)),
        (s + "tm/mix_w2", (L, 5, ml, d), w, normal(0.1 * ml ** -0.5)),
        (s + "tm/u", (L, H, hd), f32, normal(0.5)),
        (s + "tm/w0", (L, d), f32, uniform(-6.0, -0.5)),
        (s + "tm/wd_w1", (L, d, dl), w, normal(d ** -0.5)),
        (s + "tm/wd_w2", (L, dl, d), w, normal(0.5 * dl ** -0.5)),
        (s + "tm/wg", (L, d, d), w, normal(d ** -0.5)),
        (s + "tm/wk", (L, d, d), w, normal(d ** -0.5)),
        (s + "tm/wo", (L, d, d), w, normal(d ** -0.5)),
        (s + "tm/wr", (L, d, d), w, normal(d ** -0.5)),
        (s + "tm/wv", (L, d, d), w, normal(d ** -0.5)),
    ]


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1}, zero before the first position."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _wkv(r, k, v, w, u, chunk: int = 256):
    """The recurrence, position by position.  r, k, v, w [N, S, H, K]
    (w the decay in (0, 1)), u [H, K] -> y [N, S, H, K].  The bonus
    term r_t diag(u) k_t^T v_t = (sum_k r u k) v_t is taken for every
    position at once; each step is then r_t S_{t-1} and S_t = w_t S_{t-1}
    + k_t^T v_t, the outer products made a chunk of positions at a time."""
    N, S, H, K = r.shape
    state = torch.zeros((N, H, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, S, chunk):
        kv = k[:, c0:c0 + chunk, :, :, None] * v[:, c0:c0 + chunk, :, None]
        rc = r[:, c0:c0 + chunk, :, None, :]
        wc = w[:, c0:c0 + chunk, :, :, None]
        for t in range(kv.shape[1]):
            ys.append(torch.matmul(rc[:, t], state))
            state = torch.addcmul(kv[:, t], wc[:, t], state)
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    return torch.stack(ys, dim=1)[:, :, :, 0] + bonus


@fp32_only
def logits(dm: dict, params: dict, tokens: torch.Tensor,
           positions: Sequence[int], image: Optional[torch.Tensor] = None,
           precision: str = "fp32") -> torch.Tensor:
    """fp32 logits [N, len(positions), vocab] at ``positions`` of the
    plain forward over ``tokens`` [N, S]."""
    if image is not None:
        raise ValueError("RWKV-6 takes no image positions")
    mm = matmul(precision)
    N, S = tokens.shape
    d, hd = dm["d"], dm["head_dim"]
    H = d // hd
    st = params["stage0"]["pos0"]
    x = params["embed"][tokens].float()
    for layer in range(dm["layers"]):
        tm = {k: t[layer] for k, t in st["tm"].items()}
        h = rmsnorm(x, st["ln_tm"][layer], dm["eps"])
        dx = _shift(h) - h
        lo = torch.tanh(mm(h + dx * tm["maa_x"].float(), tm["mix_w1"]))
        lo = lo.reshape(N, S, 5, -1)
        xr, xk, xv, xw, xg = (
            h + dx * (tm["maa_rkvwg"][i].float()
                      + mm(lo[:, :, i], tm["mix_w2"][i]))
            for i in range(5))
        r = mm(xr, tm["wr"]).reshape(N, S, H, hd)
        k = mm(xk, tm["wk"]).reshape(N, S, H, hd)
        v = mm(xv, tm["wv"]).reshape(N, S, H, hd)
        g = mm(xg, tm["wg"])
        lw = mm(torch.tanh(mm(xw, tm["wd_w1"])), tm["wd_w2"])
        w = torch.exp(-torch.exp(tm["w0"].float() + lw)).reshape(N, S, H, hd)
        y = _wkv(r, k, v, w, tm["u"].float())
        mu = y.mean(-1, keepdim=True)
        var = y.var(-1, keepdim=True, correction=0)
        y = ((y - mu) * torch.rsqrt(var + dm["gn_eps"])).reshape(N, S, d)
        y = y * tm["ln_x"].float() * torch.nn.functional.silu(g)
        x = x + mm(y, tm["wo"])
        cm = {k: t[layer] for k, t in st["cm"].items()}
        h = rmsnorm(x, st["ln_cm"][layer], dm["eps"])
        dx = _shift(h) - h
        xk = h + dx * cm["maa_k"].float()
        xr = h + dx * cm["maa_r"].float()
        kk = torch.relu(mm(xk, cm["wk"])).square()
        x = x + torch.sigmoid(mm(xr, cm["wr"])) * mm(kk, cm["wv"])
    h = rmsnorm(x[:, list(positions)], params["final_norm"], dm["eps"])
    return mm(h, params["lm_head"].t())


# ---------------------------------------------------------------- counts


def _products(dm: dict, m: int) -> List[tuple]:
    """(m, k, n, count): a layer's sixteen weight products over every
    layer at m rows."""
    d, ff, ml, dl, L = (dm["d"], dm["ff"], dm["mix_lora"],
                        dm["decay_lora"], dm["layers"])
    return [(m, d, 5 * ml, L), (m, ml, d, 5 * L), (m, d, dl, L),
            (m, dl, d, L), (m, d, d, 6 * L), (m, d, ff, L), (m, ff, d, L)]


def launches(dm: dict, batch: int, prompt: int, phase: str
             ) -> Dict[str, list]:
    """The port's kernel launches of one replay by kernel (see
    ``vlm.launches``); the decode step's WKV is torch ops."""
    m = batch if phase == "decode" else batch * prompt
    mm = [counts.matmul(mi, k, n) for mi, k, n, c in _products(dm, m)
          for _ in range(c)]
    mm.append(counts.matmul(batch, dm["d"], dm["vocab"],
                            out_bytes=counts.FP32))
    out = {"spm_matmul": mm}
    if phase == "prefill":
        out["wkv6"] = [counts.wkv6(batch, prompt, dm["d"] // dm["head_dim"],
                                   dm["head_dim"])] * dm["layers"]
    return out


def step_flops(dm: dict, batch: int, tokens: int, past: int) -> float:
    """Model FLOPs of ``tokens`` new positions a sequence: 2 x the
    parameters the products read x tokens, the logits at one position,
    and the WKV recurrence's 4 K^2 a position and head (its cost does
    not grow with ``past``)."""
    prods = sum(2.0 * k * n * c for _, k, n, c in _products(dm, 1))
    head = 2.0 * dm["d"] * dm["vocab"]
    wkv = 4.0 * dm["d"] * dm["head_dim"] * dm["layers"]
    return batch * ((prods + wkv) * tokens + head)
