"""Feed-forward layers of the port, from the reference's
``models/ffn.py``: dense (SwiGLU / GeGLU / GELU / squared-ReLU) and the
capacity-factor mixture of experts.

The dense layer's three weight-pass products go through ``spm_matmul``.
The MoE layer keeps the reference's static-shape GShard dispatch: tokens
are grouped, each expert takes at most ``capacity`` tokens of a group,
and overflow tokens are dropped (their residual passes through).  Its
router product is fp32, as in the reference; the expert products are
batched einsums over the experts, which the reference also computes
outside any Pallas kernel; a shared expert is a dense layer (through
``spm_matmul``).  Every shape is static and nothing reads a device value
on the host (no ``nonzero``, boolean indexing or ``.item()``), so a
decode step that routes through experts can be captured as one CUDA
graph.  ``moe_ffn_ep`` is the reference's expert parallelism over a
device mesh, written on local shards with ``torch.distributed``'s
functional collectives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import compat
from repro_torch.configs.base import MoEConfig
from repro_torch.models.attention import linear
from repro_torch.models.common import activate, is_gated
from repro_torch.models.spec import Par
from repro_torch.sharding.rules import (axis_sizes, placements_for,
                                        redistribute)


def dense_ffn_spec(d_model: int, d_ff: int, activation: str,
                   dtype: str) -> dict:
    p = {
        "w_gate": Par((d_model, d_ff), ("embed", "ffn"), init="scaled",
                      dtype=dtype),
        "w_down": Par((d_ff, d_model), ("ffn", "embed"), init="scaled",
                      dtype=dtype),
    }
    if is_gated(activation):
        p["w_up"] = Par((d_model, d_ff), ("embed", "ffn"), init="scaled",
                        dtype=dtype)
    return p


def dense_ffn(p: dict, x: torch.Tensor, activation: str,
              tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``tile`` pins the products' spm_matmul (bm, bn)."""
    hg = linear(x, p["w_gate"], tile)
    hu = linear(x, p["w_up"], tile) if "w_up" in p else None
    h = activate(hg, hu, activation)
    return linear(h, p["w_down"], tile)


def adapted_gated_ffn(p: dict, x: torch.Tensor, activation: str,
                      adapter: Optional[Tuple[torch.Tensor, torch.Tensor]],
                      tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Zamba2's published tied MLP: [g | u] = x W_gate_up + (x A) B (the
    hybrid layer's adapter (A, B), or none), then the down product of
    act(g, u)."""
    gu = linear(x, p["w_gate_up"], tile)
    if adapter is not None:
        gu = gu + linear(linear(x, adapter[0], tile), adapter[1], tile)
    g, u = gu.chunk(2, dim=-1)
    return linear(activate(g, u, activation), p["w_down"], tile)


# ---------------------------------------------------------------------------
# mixture of experts (capacity-factor, static shapes)


def moe_spec(d_model: int, m: MoEConfig, activation: str,
             dtype: str) -> dict:
    E, f = m.num_experts, m.expert_ff
    p = {
        "router": Par((d_model, E), ("embed", None), init="scaled",
                      dtype="float32"),
        "we_gate": Par((E, d_model, f), ("experts", "expert_ff", None),
                       init="scaled", dtype=dtype),
        "we_down": Par((E, f, d_model), ("experts", None, "expert_ff"),
                       init="scaled", dtype=dtype),
    }
    if is_gated(activation):
        p["we_up"] = Par((E, d_model, f), ("experts", "expert_ff", None),
                         init="scaled", dtype=dtype)
    if m.shared_expert_ff:
        p["shared"] = dense_ffn_spec(d_model, m.shared_expert_ff, activation,
                                     dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """[..., n] one-hot of ``idx``; an index outside [0, n) gives a row
    of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_dispatch(gates: torch.Tensor, top_k: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build combine [G,S,E,C] (fp32 weights) and dispatch (same support,
    value 1.0) from router probabilities ``gates`` [G,S,E].

    Classic GShard position assignment: experts fill in slot order; a
    token whose expert is full in slot j is dropped for that slot.
    """
    G, S, E = gates.shape
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1)     # [G,S,K]
    counts = torch.zeros((G, E), dtype=torch.long, device=gates.device)
    combine = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                          device=gates.device)
    for j in range(top_k):
        oh = _one_hot(top_idx[..., j], E, torch.long)            # [G,S,E]
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]  # [G,S,E]
        pos_j = torch.sum(pos * oh, dim=-1)                      # [G,S]
        keep = pos_j < capacity
        counts = counts + torch.sum(oh, dim=1)
        pos_oh = _one_hot(pos_j, capacity, torch.float32)
        w = torch.where(keep, top_vals[..., j], 0.0)
        combine = combine + (w[..., None, None]
                             * oh.float()[..., None]
                             * pos_oh[..., None, :])
    dispatch = (combine > 0).to(gates.dtype)
    return combine, dispatch


def _gather_dispatch(xg: torch.Tensor, gates: torch.Tensor, m: MoEConfig,
                     C: int):
    """Sort/gather-based static-capacity dispatch: the GShard einsum
    form's routing with O(tokens*d) data movement.  Returns the expert
    buffers [G,E,C,d] and the route ``_gather_combine`` reads.  Each
    kept slot lands in a buffer row of its own, so the scatter writes
    each row once (dropped slots all go to one spare row, as zeros)."""
    G, S, E = gates.shape
    d = xg.shape[-1]
    K = m.top_k
    dev = xg.device
    top_vals, top_idx = torch.topk(gates, K, dim=-1)          # [G,S,K]
    slot_expert = top_idx.reshape(G, S * K)                   # [G,N]
    slot_token = torch.arange(S, device=dev).repeat_interleave(K)
    slot_gate = top_vals.reshape(G, S * K).float()

    order = torch.argsort(slot_expert, dim=1, stable=True)    # [G,N]
    sorted_e = torch.gather(slot_expert, 1, order)
    sorted_t = slot_token[order]                              # [G,N]
    sorted_g = torch.gather(slot_gate, 1, order)

    # position within the expert's run = index - start of the run
    counts = torch.sum(_one_hot(slot_expert, E, torch.long), dim=1)  # [G,E]
    starts = torch.cumsum(counts, dim=1) - counts
    iota = torch.arange(S * K, device=dev).expand(G, S * K)
    pos = iota - torch.gather(starts, 1, sorted_e)
    keep = pos < C
    dest = torch.where(keep, sorted_e * C + pos, E * C)       # drop slot

    xt = torch.gather(xg, 1, sorted_t[..., None].expand(G, S * K, d))
    buf = torch.zeros((G, E * C + 1, d), dtype=xg.dtype, device=dev)
    buf.scatter_(1, dest[..., None].expand(G, S * K, d),
                 torch.where(keep[..., None], xt, 0))
    xe = buf[:, :-1].reshape(G, E, C, d)
    return xe, (dest, sorted_t, sorted_g, keep)


def _gather_combine(ye: torch.Tensor, route, G: int, S: int,
                    d: int) -> torch.Tensor:
    """Each token's weighted expert outputs, summed.  The reference adds
    them into the token's row in expert-sorted order; here the slots are
    regrouped by token (a stable sort keeps that order) and summed one
    after another, which gives the same sums without atomics, so the
    card's bits do not depend on timing."""
    dest, sorted_t, sorted_g, keep = route
    E, C = ye.shape[1], ye.shape[2]
    N = dest.shape[1]
    flat = torch.cat([ye.reshape(G, E * C, d),
                      torch.zeros((G, 1, d), dtype=ye.dtype,
                                  device=ye.device)], dim=1)
    out_slot = torch.gather(flat, 1, dest[..., None].expand(G, N, d))
    w = (sorted_g * keep).to(ye.dtype)[..., None]
    by_token = torch.argsort(sorted_t, dim=1, stable=True)     # [G,N]
    contrib = torch.gather(out_slot * w, 1,
                           by_token[..., None].expand(G, N, d))
    contrib = contrib.reshape(G, S, N // S, d)     # [G,S,K,d]
    y = contrib[:, :, 0]
    for j in range(1, contrib.shape[2]):
        y = y + contrib[:, :, j]
    return y


def _on_mesh(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``t`` laid out as ``spec`` on ``mesh``: a DTensor is
    redistributed; a plain tensor, the same on every rank, is taken as
    replicated and sliced where ``spec`` shards it (no data moves)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return redistribute(t, placements_for(spec, mesh))


def moe_ffn_ep(p: dict, x: torch.Tensor, m: MoEConfig, activation: str,
               x_sharding) -> torch.Tensor:
    """Explicit expert parallelism, the reference's ``shard_map`` form as
    a function on local shards: the MultiVic dataflow at mesh scale.
    Expert weights stay STATIONARY in their 2-D shards (the paper's B
    blocks pinned in scratchpads) and the small thing, capacity-bounded
    token buffers, moves on a static all-to-all schedule.  The per-shard
    capacity is the compile-time worst case for dynamic routing (paper
    §3).

    ``x``: the residual stream [B, S, d] as a DTensor; its mesh is the
    experts' mesh.  ``x_sharding``: the stream's resolved spec (its
    batch entry is kept).  Each shard dispatches all its N tokens as
    one group of capacity ``m.capacity(N)``.  Where the model axis
    divides S, tokens are split over it and an all-to-all over
    ``model`` takes [E, C, d] to [E/model_n, model_n*C, d] (the
    experts' owners) and back; otherwise (decode) every model rank
    holds the tokens, runs its E/model_n experts and a sum over
    ``model`` follows.  With ``data`` > 1 the local experts' weight
    d-slices are gathered over ``data``.  Every shape is static.
    Returns y [B, S, d] laid out as the tokens were dispatched."""
    if not isinstance(x, DTensor):
        raise ValueError("moe_ffn_ep needs x as a DTensor: its mesh is "
                         "the experts' mesh")
    if x_sharding is None:
        raise ValueError("moe_ffn_ep needs the residual stream's spec")
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_ax = "data" if "data" in sizes else None
    data_n = sizes["data"] if data_ax else 1
    B, S, d = x.shape
    E = m.num_experts
    if E % model_n:
        raise ValueError(f"{E} experts do not divide over {model_n} "
                         f"model ranks")
    El = E // model_n
    # shard the tokens' sequence dim over "model" for dispatch if it
    # divides
    seq_ax = "model" if (model_n > 1 and S % model_n == 0) else None
    model_ax = "model" if model_n > 1 else None
    x_spec = (x_sharding[0] if len(x_sharding) else None, seq_ax, None)

    xl = _on_mesh(x, mesh, x_spec).to_local()
    router = _on_mesh(p["router"], mesh, ()).to_local()
    w = {k: _on_mesh(p[k], mesh, (model_ax, None, data_ax)
                     if k == "we_down" else (model_ax, data_ax, None)
                     ).to_local()
         for k in ("we_gate", "we_up", "we_down") if k in p}
    bl, sl, _ = xl.shape
    N = bl * sl
    xf = xl.reshape(1, N, d)
    logits = torch.einsum("gnd,de->gne", xf.float(), router)
    gates = torch.softmax(logits, dim=-1)
    C = m.capacity(N)
    xe, route = _gather_dispatch(xf, gates, m, C)
    buf = xe[0]                                          # [E, C, d]
    if seq_ax:
        # tokens -> expert owners; experts stay put.  The all-to-all
        # sends rows [j*El, (j+1)*El) to model rank j and stacks what
        # it receives by source rank: [model_n, El, C, d]
        model_g = mesh.get_group("model")
        buf = funcol.all_to_all_single_autograd(buf.contiguous(), None,
                                                None, model_g)
        buf = buf.reshape(model_n, El, C, d).transpose(0, 1).reshape(
            El, model_n * C, d)
    elif model_ax:
        # tokens replicated over "model" (decode): each rank runs its
        # own slice of the experts; the results are summed below
        model_g = mesh.get_group("model")
        lo = mesh.get_local_rank("model") * El
        buf = buf[lo:lo + El]
    if data_n > 1:
        # this layer's d-slices of the LOCAL experts (the double-
        # buffered analogue of the paper's per-round B-block DMA)
        data_g = mesh.get_group("data")
        w = {k: compat.all_gather_autograd(
            v, 2 if k == "we_down" else 1, data_g) for k, v in w.items()}
    ye = _expert_ffn(w, buf[None], activation)[0]
    if seq_ax:
        ye = ye.reshape(El, model_n, C, d).transpose(0, 1).contiguous()
        ye = funcol.all_to_all_single_autograd(
            ye.reshape(E, C, d), None, None, model_g)
    elif model_ax:
        ye = torch.cat([ye.new_zeros((lo, C, d)), ye,
                        ye.new_zeros((E - lo - El, C, d))])
    y = _gather_combine(ye[None], route, 1, N, d).reshape(bl, sl, d)
    if model_ax and not seq_ax:
        y = funcol.all_reduce(y, "sum", model_g)
    return DTensor.from_local(y, mesh, placements_for(x_spec, mesh),
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _expert_ffn(p: dict, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """The experts' gated FFN on their buffers xe [G,E,C,d]."""
    hg = torch.einsum("gecd,edf->gecf", xe, p["we_gate"])
    hu = (torch.einsum("gecd,edf->gecf", xe, p["we_up"])
          if "we_up" in p else None)
    h = activate(hg, hu, activation)
    return torch.einsum("gecf,efd->gecd", h, p["we_down"])


def moe_ffn(p: dict, x: torch.Tensor, m: MoEConfig, activation: str,
            impl: str = "einsum", x_sharding=None,
            tile: Optional[Tuple[int, int]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss).  Static shapes throughout.
    impl: "einsum" (GShard-faithful baseline) | "gather" (optimized) |
    "ep" (expert parallelism over the mesh of a DTensor ``x``, which
    raises without ``x_sharding``; a plain ``x`` with no ``x_sharding``
    runs "gather", as in the reference).  ``tile`` pins the shared
    expert's spm_matmul (bm, bn)."""
    B, S, d = x.shape
    tokens = B * S
    gs = min(m.group_size, tokens)
    while tokens % gs:          # largest divisor <= group_size (static)
        gs -= 1
    G = tokens // gs
    C = m.capacity(gs)
    xg = x.reshape(G, gs, d)

    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    gates = torch.softmax(logits, dim=-1)                     # fp32

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(gates, dim=1)                             # [G,E]
    top1 = _one_hot(torch.argmax(gates, dim=-1), m.num_experts,
                    torch.float32)
    ce = torch.mean(top1, dim=1)                              # [G,E]
    aux = m.num_experts * torch.mean(torch.sum(me * ce, dim=-1))

    if impl == "ep" and (x_sharding is not None or isinstance(x, DTensor)):
        # on the tokens as dispatched; the shared expert reads each
        # token alone, so it runs on x as it lies
        y = moe_ffn_ep(p, x, m, activation, x_sharding)
        if "shared" in p:
            y = y + dense_ffn(p["shared"], x, activation, tile)
        return y, aux
    if impl in ("gather", "ep"):        # "ep" without mesh -> gather
        xe, route = _gather_dispatch(xg, gates, m, C)
        y = _gather_combine(_expert_ffn(p, xe, activation), route, G, gs, d)
    else:
        combine, dispatch = _topk_dispatch(gates, m.top_k, C)
        xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
        ye = _expert_ffn(p, xe, activation)
        y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)

    if "shared" in p:
        y = y + dense_ffn(p["shared"], xg, activation, tile)
    return y.reshape(B, S, d), aux
