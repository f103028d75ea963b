"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo backbone.  The ViT frontend is
a STUB per the assignment: input_specs() provides precomputed patch
embeddings that replace the embeddings at the first `num_positions`
token positions.  [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import (AttentionConfig, FrontendStub,
                                      ModelConfig, register)

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131_072,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000_000.0,
    ),
    activation="swiglu",
    frontend=FrontendStub(kind="patches", num_positions=1024),
))
