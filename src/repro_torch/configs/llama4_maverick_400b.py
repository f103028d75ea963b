"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 with a shared expert on
alternating layers (dense FFN on the others), early-fusion multimodal.
Total params ≈ 400B, ≈17B active.  [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]
"""
from repro_torch.configs.base import (AttentionConfig, FrontendStub, MoEConfig,
                                ModelConfig, register)

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=16384,                  # dense-FFN layers (interleaved)
    vocab_size=202_048,
    attention=AttentionConfig(
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500_000.0,
    ),
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        expert_ff=8192,
        shared_expert_ff=8192,
        moe_every=2,             # MoE on alternating layers (maverick)
        capacity_factor=1.25,
        group_size=512,
    ),
    activation="swiglu",
    frontend=FrontendStub(kind="patches", num_positions=0),  # early fusion
))
