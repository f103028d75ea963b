"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4)
d_ff=1536 (per expert) vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import (AttentionConfig, MoEConfig, ModelConfig,
                                register)

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    d_ff=12288,                  # unused (all layers MoE); kept for ref
    vocab_size=151_936,
    attention=AttentionConfig(
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
    ),
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        expert_ff=1536,
        shared_expert_ff=0,
        moe_every=1,             # every layer is MoE
        capacity_factor=1.25,
        group_size=512,
    ),
    activation="swiglu",
))
