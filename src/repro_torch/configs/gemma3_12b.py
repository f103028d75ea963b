"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab_size=262_144,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,          # gemma3 uses an explicit 256 head_dim
        qk_norm=True,
        sliding_window=1024,
        layer_pattern="LLLLLG",  # 5 local : 1 global
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
    ),
    activation="geglu",
    use_post_norm=True,
    tie_embeddings=True,
    scale_embeddings=True,
))
