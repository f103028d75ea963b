"""Model-level serving plans: the autotuner one level up the stack (the
reference's ``tuning/model.py``, for the port's serve).

- a ``ModelProblem`` is the static description of one serving
  configuration — architecture, batch, prompt/generation lengths, the
  reduced dims the launcher actually builds, dtype — everything that
  changes the optimal plan and nothing that doesn't;
- a model *plan* is a flat ``{name: int}`` dict (same shape as kernel
  plans, so the persistent cache validates it unchanged):

  ``chunk_q`` / ``chunk_kv``   prefill attention chunking of the plain
                               (CPU) path (RunOptions); on CUDA flash
                               runs its 64 x 64 tiles whatever they say,
  ``decode_scan``              0/1: the decode layer-loop structure (both
                               settings make the same calls),
  ``mm_bm`` / ``mm_bn``        the decode weight-pass matmul tile pins:
                               the decode step's spm_matmul products run
                               with them (``RunOptions.mm_tiles``),
                               resolved through the KERNEL plan cache
                               (spm_matmul namespace) and fed to
                               ``core.gpu_mapping.serve_step_wcet``,
                               so the WCET bound tracks the served plan.

Candidates: on the CPU, the reference's grid over the chunking and the
loop structure, so the mechanics match the reference's.  On CUDA only
plans that change the launched program are worth a measurement, and
the chunking and loop structure change nothing there, so the candidates
are the decode pins that give distinct decode programs (the launches
of every decode product, ``decode_products``), each with the default
chunking and loop structure.  At batch 4 that is two programs for
qwen2-0.5b: ``splitk`` at the default 16 x 64 pins, and ``tiled``,
which any other pin selects and the wrapper clamps back to 16 x 64.

Candidates are pruned by the kernel tuner's shared-memory rule and
ranked by its roofline model (the prefill attention as flash launches,
each decode step as its products under the pins), and the survivors are
measured end-to-end by ``tuning.model_tuner``.  Winners persist in the
shared ``$REPRO_PLAN_CACHE`` under the ``model|`` key namespace.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.compat import torch_dtype
from repro_torch.core.gpu_mapping import H100, GPUChip
from repro_torch.kernels.spm_matmul import ops as mm_ops
from repro_torch.tuning.candidates import defaults_for
from repro_torch.tuning.cost_model import analytic_cost_s as _kernel_cost_s
from repro_torch.tuning.cost_model import feasibility as _kernel_feasibility
from repro_torch.tuning.plan import plan_sig  # noqa: F401 (re-exported)
from repro_torch.tuning.plan import AttentionProblem, MatmulProblem, Plan
from repro_torch.tuning.plan_cache import cache_key

# Cache namespace: model plans share the kernel cache file but never a
# key (``model|<problem.sig>|<env>``).
MODEL_NS = "model"

_CHUNK_TILES = (16, 32, 64, 128, 256, 512)


@dataclass(frozen=True)
class ModelProblem:
    """One serving configuration, as the launcher builds it.

    ``layers``/``d_model``/``vocab`` are the reduced dims
    (configs.reduce_config); 0 means --full (the registered size).
    """
    arch: str
    batch: int
    prompt_len: int
    gen: int
    layers: int = 2
    d_model: int = 128
    vocab: int = 512
    dtype: str = "float32"

    @property
    def sig(self) -> str:
        dims = ("full" if not self.layers
                else f"l{self.layers}d{self.d_model}v{self.vocab}")
        return (f"{self.arch}-b{self.batch}p{self.prompt_len}"
                f"g{self.gen}-{dims}-{self.dtype}")


def model_cache_key(problem: ModelProblem) -> str:
    return cache_key(MODEL_NS, problem)


def problem_config(problem: ModelProblem):
    """The ModelConfig this problem describes (reduced unless full), in
    the problem's dtype."""
    from repro_torch.configs import get_config, reduce_config
    cfg = get_config(problem.arch)
    if problem.layers:
        cfg = reduce_config(cfg, layers=problem.layers,
                            d_model=problem.d_model, vocab=problem.vocab)
    return dataclasses.replace(cfg, dtype=problem.dtype)


def parse_model_problem(arch: str, text: str, *, layers: int = 2,
                        d_model: int = 128, vocab: int = 512,
                        dtype: str = "float32") -> ModelProblem:
    """CLI shape syntax ``BxPxG`` (batch x prompt_len x gen)."""
    dims = [int(p) for p in text.replace(",", "x").split("x") if p]
    if len(dims) != 3:
        raise ValueError(f"model shape wants BxPxG, got {text!r}")
    b, p, g = dims
    return ModelProblem(arch, b, p, g, layers=layers, d_model=d_model,
                        vocab=vocab, dtype=dtype)


# ------------------------------------------------------- kernel pins

def decode_matmul_problem(cfg, problem: ModelProblem) -> MatmulProblem:
    """The decode step's aggregate weight pass as a matmul problem:
    [B, d_model] activations against every weight matrix once."""
    from repro_torch.models.lm import param_count
    n_eff = max(cfg.d_model, 2 * param_count(cfg) // cfg.d_model)
    return MatmulProblem(problem.batch, cfg.d_model, n_eff,
                         dtype=problem.dtype)


def kernel_pins(cfg, problem: ModelProblem) -> Dict[str, int]:
    """Resolve the decode weight-pass tile plan through the KERNEL
    namespace of the plan cache (a tuned spm_matmul plan if present,
    the plan the wrapper launches for that shape otherwise) and flatten
    it into the model-plan pin fields.  These pins are the decode
    products' tile and parameterize the WCET schedule
    (core.gpu_mapping.serve_step_wcet)."""
    from repro_torch.tuning.runtime import resolve_plan
    plan = resolve_plan("spm_matmul", decode_matmul_problem(cfg, problem),
                        {"bm": None, "bn": None, "bk": None})
    return {"mm_bm": int(plan["bm"]), "mm_bn": int(plan["bn"])}


def decode_products(cfg, batch: int) -> List[Tuple[int, int, int, bool, int]]:
    """``(m, k, n, trans_b, count)``: the spm_matmul products one decode
    step makes, each distinct shape once with its count, layer by layer
    as ``models.blocks.build_stages`` lays the model out: an attention
    layer's projections and dense FFN (an MoE layer's shared expert; its
    routed experts are einsums), an RWKV layer's sixteen, a Mamba2
    layer's ``in_proj`` and ``out_proj`` (and, first in a zamba2 unit,
    its shared block's projections from concat(x, x0) and dense FFN; in
    the published form its gate/up and down products, the layer's
    adapter and ``linear``), a
    whisper decoder layer's self q/k/v/o, cross q and o (its cross k/v
    are projected once, at prefill) and dense FFN, and the logits
    against the [V, d] table."""
    from repro_torch.models import blocks
    from repro_torch.models.ffn import is_gated
    from repro_torch.models.ssm import ssm_dims
    d = cfg.d_model
    counts: Dict[Tuple[int, int], int] = {}

    def add(k, n, times):
        if times:
            counts[(k, n)] = counts.get((k, n), 0) + times

    def attn_ffn(d_in, times, ff):
        a = cfg.attention
        add(d_in, a.num_heads * a.head_dim, times)
        add(d_in, a.num_kv_heads * a.head_dim, 2 * times)
        add(a.num_heads * a.head_dim, d, times)
        if ff:
            add(d, ff, (2 if is_gated(cfg.activation) else 1) * times)
            add(ff, d, times)

    for st in blocks.build_stages(cfg):
        for dsc in st.unit:
            if dsc.kind == "rwkv":
                r = cfg.rwkv
                for k, n, c in ((d, 5 * r.mix_lora, 1), (r.mix_lora, d, 5),
                                (d, r.decay_lora, 1), (r.decay_lora, d, 1),
                                (d, d, 6), (d, cfg.d_ff, 1), (cfg.d_ff, d, 1)):
                    add(k, n, c * st.n_units)
                continue
            if dsc.kind == "mamba":
                s = cfg.ssm
                d_inner, nheads, conv_dim = ssm_dims(d, s)
                if dsc.shared_attn and s.published:
                    # the published block: one gate/up product, the
                    # layer's adapter and linear
                    attn_ffn(2 * d, st.n_units, 0)
                    add(d, 2 * cfg.d_ff, st.n_units)
                    add(cfg.d_ff, d, st.n_units)
                    if s.adapter_rank:
                        add(d, s.adapter_rank, st.n_units)
                        add(s.adapter_rank, 2 * cfg.d_ff, st.n_units)
                    add(d, d, st.n_units)
                elif dsc.shared_attn:
                    attn_ffn(2 * d, st.n_units, cfg.d_ff)
                add(d, d_inner + conv_dim + nheads, st.n_units)
                add(d_inner, d, st.n_units)
                continue
            if dsc.kind == "dec_attn":
                a = cfg.attention
                attn_ffn(d, st.n_units, cfg.d_ff)
                add(d, a.num_heads * a.head_dim, st.n_units)
                add(a.num_heads * a.head_dim, d, st.n_units)
                continue
            if dsc.kind != "attn":
                raise ValueError(dsc.kind)
            attn_ffn(d, st.n_units,
                     cfg.moe.shared_expert_ff if dsc.use_moe else cfg.d_ff)
    products = [(batch, k, n, False, c) for (k, n), c in counts.items()]
    return products + [(batch, d, cfg.padded_vocab, True, 1)]


def _decode_program(cfg, problem: ModelProblem, plan: Plan) -> tuple:
    """The launches of the decode step's products under the plan's pins
    (the tuned kernel plans filling what the pins leave open)."""
    dt = torch_dtype(problem.dtype)
    program = []
    for m, k, n, tb, _ in decode_products(cfg, problem.batch):
        launch = mm_ops.launch_plan(m, k, n, dt, tb, True, plan["mm_bm"],
                                    plan["mm_bn"])
        tile = launch["tile"]
        program.append((launch["path"], launch["splits"], tile["bm"],
                        tile["bn"], tile["bkc"], tile.get("stages")))
    return tuple(program)


# ------------------------------------------------ defaults/candidates

def default_model_plan(cfg, problem: ModelProblem) -> Plan:
    """32-token prefill chunks when 32 divides the prompt (else one
    block), the decode loop structure from cfg.scan_layers, and the
    kernel-plan tile pins."""
    chunk = 32 if problem.prompt_len % 32 == 0 else problem.prompt_len
    plan = {"chunk_q": chunk, "chunk_kv": chunk,
            "decode_scan": int(bool(cfg.scan_layers))}
    plan.update(kernel_pins(cfg, problem))
    return plan


def _chunk_candidates(dim: int) -> List[int]:
    """The reference's tile rule for the chunk grid: the chunks that
    divide ``dim``, plus ``dim`` itself when it is a single block."""
    cands = {t for t in _CHUNK_TILES if t <= dim and dim % t == 0}
    if dim <= max(_CHUNK_TILES) or not cands:
        cands.add(dim)
    return sorted(cands)


def enumerate_model_candidates(cfg, problem: ModelProblem,
                               device: str = "cuda") -> List[Plan]:
    """CUDA: the default plan and one plan per further distinct decode
    program, over the compiled tiles as pins.  CPU: the reference's
    small grid over chunking and loop structure, every candidate with
    the same kernel pins."""
    default = default_model_plan(cfg, problem)
    if torch.device(device).type == "cuda":
        pins = [dict(default, mm_bm=bm, mm_bn=bn) for bm, bn in mm_ops.TILES]
        seen, cands = set(), []
        for plan in [default] + pins:
            program = _decode_program(cfg, problem, plan)
            if program not in seen:
                seen.add(program)
                cands.append(plan)
        return cands
    chunks = _chunk_candidates(problem.prompt_len)
    scans = [int(bool(cfg.scan_layers))]
    if cfg.num_layers and cfg.num_layers <= 8:
        # the scan-vs-unroll choice is only worth measuring on short stacks
        scans = sorted({0, 1} | set(scans))
    pin = {k: default[k] for k in ("mm_bm", "mm_bn")}
    cands = [{"chunk_q": cq, "chunk_kv": ckv, "decode_scan": sc, **pin}
             for cq in chunks for ckv in chunks for sc in scans]
    if default not in cands:
        cands.append(default)
    return cands


# ------------------------------------------------------ analytic prune

def _prefill_attn_problem(cfg, problem: ModelProblem) \
        -> Optional[AttentionProblem]:
    a = cfg.attention
    if a is None:
        return None
    return AttentionProblem(problem.batch, problem.prompt_len,
                            problem.prompt_len, a.num_heads,
                            a.num_kv_heads, a.head_dim,
                            dtype=problem.dtype)


def model_feasible(cfg, problem: ModelProblem, plan: Plan,
                   chip: GPUChip = H100) -> bool:
    """Shared-memory feasibility of the prefill attention: flash runs
    its compiled tile whatever the chunking, so the rule is the kernel
    tuner's on that tile at the model's head dim."""
    ap = _prefill_attn_problem(cfg, problem)
    if ap is None:
        return True
    return _kernel_feasibility("flash_attention", ap,
                               defaults_for("flash_attention", ap), chip).fits


def model_analytic_cost_s(cfg, problem: ModelProblem, plan: Plan,
                          chip: GPUChip = H100) -> float:
    """Modeled worst-case seconds for one full serve pass (prefill +
    ``gen`` decode steps) — the pruning objective, never the verdict.

    Prefill attention is priced per layer with the kernel cost model at
    the tile flash runs; every decode step pays each of its products'
    kernel cost under the plan's pins."""
    cost = 0.0
    ap = _prefill_attn_problem(cfg, problem)
    if ap is not None:
        cost += cfg.num_layers * _kernel_cost_s(
            "flash_attention", ap, defaults_for("flash_attention", ap), chip)
    step = sum(c * _kernel_cost_s(
        "spm_matmul", MatmulProblem(m, k, n, problem.dtype, tb),
        {"bm": plan["mm_bm"], "bn": plan["mm_bn"]}, chip)
        for m, k, n, tb, c in decode_products(cfg, problem.batch))
    return cost + problem.gen * step


# --------------------------------------------------------- resolution

def resolve_model_plan(cfg, problem: ModelProblem,
                       overrides: Optional[Dict[str, Optional[int]]]
                       = None) -> Dict[str, object]:
    """Serving-time plan resolution, same precedence as the kernel
    wrappers: explicit (non-None) overrides > cached tuned plan >
    defaults.  Returns ``{"plan": Plan, "source": str}`` so the serve
    banner can say where its plan came from.

    The cache consult goes through the shared process cache and is
    keyed on the environment fingerprint (the card included): a plan
    tuned on the CPU never resolves on an sm_90 card.
    """
    from repro_torch.tuning.runtime import active_cache, autotune_enabled
    plan = default_model_plan(cfg, problem)
    overrides = overrides or {}
    explicit = {k: int(v) for k, v in overrides.items()
                if v is not None and k in plan}
    source = "defaults"
    if len(explicit) < len(plan) and autotune_enabled():
        cached = active_cache().get(model_cache_key(problem))
        if cached is not None:
            plan.update({k: v for k, v in cached.items() if k in plan})
            source = "cache"
    if explicit:
        plan.update(explicit)
        source = "explicit" if len(explicit) == len(plan) \
            else f"explicit+{source}"
    return {"plan": plan, "source": source}
