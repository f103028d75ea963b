"""rwkv6-1.6b [ssm / linear attention]: 24L d_model=2048 (attn-free)
d_ff=7168 vocab=65536 — "Finch": data-dependent decay linear attention
(WKV6) + token-shift + channel-mix.  [arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    num_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65_536,
    rwkv=RWKVConfig(
        head_dim=64,             # 32 wkv heads
        decay_lora=64,
        mix_lora=32,
        chunk_size=256,
    ),
    activation="relu_sq",        # rwkv channel-mix uses squared relu
))
