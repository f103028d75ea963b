"""zamba2-7b [hybrid]: the port's (and the JAX package's) variant of
Zamba2-7B: 81L d_model=3584 d_ff=14336 vocab=32000, ssm_state=64 — a
Mamba2 backbone with weight-tied shared attention blocks (32 heads,
kv=32) applied periodically.  It departs from the published model
(``zamba2-7b-instruct``, hf:Zyphra/Zamba2-7B-Instruct) in seven ways:

1. head dim 112, not 224: q, k, v project 7168 -> 3584, not 7168 -> 7168;
2. one B/C group, not two;
3. one RMSNorm over all 7168 gated channels, not one per group;
4. residual adds inside the tied block (x + attn, x + ffn), where the
   published block's output only feeds the Mamba input;
5. no per-layer ``linear_i`` or gate/up adapters;
6. tied blocks before every 6th layer from 0, not at the published
   hybrid ids (6, 11, 17, ..., 77);
7. norm eps 1e-6, not 1e-5.

Its values are the JAX package's, which the port's parity tests hold.
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
        head_dim=112,            # the variant's (published: 224)
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
