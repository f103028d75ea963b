"""zamba2-7b [hybrid]: 81L d_model=3584 d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone with weight-tied shared attention blocks
(32H MHA, i.e. GQA kv=32) applied periodically.  [arXiv:2411.15242;
unverified]
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      SSMConfig, register)

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32_000,
    attention=AttentionConfig(   # the shared attention block
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,            # 3584 / 32
    ),
    ssm=SSMConfig(
        state_dim=64,
        head_dim=64,
        expand=2,
        conv_kernel=4,
        chunk_size=256,
        shared_attn_every=6,     # shared block before every 6th ssm layer
        n_shared_blocks=2,
    ),
    activation="gelu",
))
