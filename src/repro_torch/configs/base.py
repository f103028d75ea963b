"""Configuration system of the PyTorch port: a copy of the JAX
package's ``configs/base.py`` (the port imports nothing of it).

``ModelConfig.param_count`` counts through the port's own analysis
package (``repro_torch.analysis.flops``), lazily, as the reference's
does.  The ``kernels`` field is copied and, as in the reference, read
nowhere: the port routes its kernels by device.

ModelConfig is a frozen dataclass covering every assigned architecture
family (dense / GQA / sliding-window / MoE / SSM / RWKV / enc-dec / VLM
and audio stubs).  Shape configs describe the four assigned input-shape
regimes.  Everything is static: the MultiVic execution model requires
input-independent dataflow (paper §3), so every "dynamic" feature
(MoE routing, cache sizes, vocab padding) is frozen at config time.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# helpers


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# attention / layer-pattern descriptors


@dataclass(frozen=True)
class AttentionConfig:
    """Per-model attention settings."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    # sliding-window support: window <= 0 means full (global) attention.
    sliding_window: int = 0
    # pattern of layer kinds, cycled over the depth.  "L" = local
    # (sliding window), "G" = global.  Empty = all global.
    layer_pattern: str = ""
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None  # gemma3 uses 1M for globals
    softmax_scale: Optional[float] = None

    def window_for_layer(self, layer_idx: int) -> int:
        if not self.layer_pattern:
            return self.sliding_window if self.sliding_window > 0 else 0
        kind = self.layer_pattern[layer_idx % len(self.layer_pattern)]
        return self.sliding_window if kind == "L" else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    """Capacity-factor (static-shape) mixture-of-experts settings.

    Capacity-based dispatch is the static-schedule-compatible MoE: the
    paper requires compile-time-schedulable dataflow, and the capacity
    factor is exactly its "additional assumptions ... during scheduling"
    for dynamic behaviour.
    """

    num_experts: int
    top_k: int
    expert_ff: int
    shared_expert_ff: int = 0  # 0 = no shared expert
    capacity_factor: float = 1.25
    # apply MoE on every `moe_every`-th layer (1 = all layers); other
    # layers use the dense FFN with `dense_ff`.
    moe_every: int = 1
    router_jitter: float = 0.0
    # tokens are grouped for dispatch so the one-hot dispatch tensor
    # stays small; must divide the per-device token count.
    group_size: int = 512

    def capacity(self, group_size: int) -> int:
        cap = int(math.ceil(group_size * self.top_k / self.num_experts
                            * self.capacity_factor))
        return max(4, _round_up(cap, 4))


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings for hybrid/ssm architectures."""

    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    # zamba2: a weight-tied attention block applied every N ssm layers
    shared_attn_every: int = 0
    n_shared_blocks: int = 2  # alternating tied blocks (zamba2 uses 2)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 ("Finch") settings: data-dependent decay linear attention."""

    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk_size: int = 256


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder settings (frontend stubbed)."""

    encoder_layers: int = 6
    # ratio of decoder length to the shape's seq_len during training
    dec_len_ratio: int = 8
    cross_kv_len: int = 1536  # encoder memory length seen by decode steps


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend stub: input_specs() provides precomputed
    frame/patch embeddings; the real conv/ViT stack is out of scope per
    the assignment."""

    kind: str = "none"  # none | patches | frames
    num_positions: int = 0  # e.g. image tokens prepended for VLM


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: FrontendStub = field(default_factory=FrontendStub)
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: embeddings * sqrt(d_model)
    # gemma-style sandwich norms (post-norm in addition to pre-norm)
    use_post_norm: bool = False
    logit_softcap: float = 0.0
    vocab_pad_multiple: int = 128
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"
    # --- implementation knobs (semantics-preserving; hillclimb levers) ---
    # pad attention heads up so they divide the model axis; padded heads
    # have zero output-projection rows => mathematically identical.
    pad_heads_to: int = 0
    remat: str = "full"  # full | none
    scan_layers: bool = True
    kernels: str = "reference"  # reference | pallas

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def repeat_pattern_len(self) -> int:
        """Length of the repeating layer unit (for scan stacking)."""
        if self.attention is not None and self.attention.layer_pattern:
            return len(self.attention.layer_pattern)
        return 1

    @property
    def num_repeat_units(self) -> int:
        p = self.repeat_pattern_len
        assert self.num_layers % p == 0 or p == 1, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern {p}")
        return self.num_layers // p if self.num_layers % p == 0 else self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.analysis.flops import param_count  # lazy: cycle
        return param_count(self)


# ---------------------------------------------------------------------------
# input shapes (the four assigned regimes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# training hyper-parameters


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    # distributed-optimization tricks
    grad_compression: str = "none"  # none | int8
    microbatch: int = 0  # 0 = no gradient accumulation


# ---------------------------------------------------------------------------
# registry

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ModelConfig:
    """Look up an architecture config by id, optionally overriding
    implementation knobs (not the published architecture fields)."""
    import repro_torch.configs.all_archs  # noqa: F401  (populates registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs():
    import repro_torch.configs.all_archs  # noqa: F401

    return sorted(_REGISTRY)


def supported_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the four assigned shapes run for this arch.

    long_500k needs sub-quadratic attention: runs for ssm/hybrid/rwkv and
    sliding-window archs, skipped for pure full-attention archs (see
    DESIGN.md §4).
    """
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    subquadratic = cfg.family in ("ssm", "rwkv", "hybrid") or (
        cfg.attention is not None and cfg.attention.layer_pattern != "")
    if subquadratic:
        shapes.append("long_500k")
    return tuple(shapes)


def reduce_config(cfg: ModelConfig, *, layers: int, d_model: int,
                  vocab: int) -> ModelConfig:
    """CPU-friendly shrink of a registered architecture: same family
    and layer pattern, small dims.  One implementation shared by the
    launchers (launch/train.py --layers/--d-model/--vocab) and the
    serving autotuner (tuning.model), so a plan tuned for a reduced
    arch is tuned for exactly what the launcher serves."""
    kw = dict(num_layers=layers, d_model=d_model, d_ff=d_model * 3,
              vocab_size=vocab, vocab_pad_multiple=64)
    if cfg.attention:
        kw["attention"] = dataclasses.replace(
            cfg.attention, num_heads=4, num_kv_heads=2, head_dim=32)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            expert_ff=64, group_size=32,
            shared_expert_ff=64 if cfg.moe.shared_expert_ff else 0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, chunk_size=32)
        kw["attention"] = dataclasses.replace(
            cfg.attention, num_heads=4, num_kv_heads=4, head_dim=64)
    if cfg.rwkv:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=32,
                                         chunk_size=32)
    if cfg.encdec:
        kw["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=2)
    return dataclasses.replace(cfg, **kw)
