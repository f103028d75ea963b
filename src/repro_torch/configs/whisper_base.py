"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 —
encoder-decoder with a conv frontend STUB (input_specs() provides
precomputed frame embeddings).  Vocab padded to 51968 so it shards
16-way; padded logits are masked.  [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import (AttentionConfig, EncDecConfig,
                                      FrontendStub, ModelConfig, register)

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,               # decoder layers; encoder in encdec config
    d_model=512,
    d_ff=2048,
    vocab_size=51_865,
    attention=AttentionConfig(
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        rope_theta=0.0,          # whisper uses learned/sinusoidal positions
    ),
    activation="gelu",
    encdec=EncDecConfig(encoder_layers=6, dec_len_ratio=8,
                        cross_kv_len=1536),
    frontend=FrontendStub(kind="frames"),
))
