"""Import every architecture config the port has brought up, so the
registry is populated.  Other families register with their slices."""
# flake8: noqa: F401
from repro_torch.configs import (gemma3_12b, llama4_maverick_400b,
                                  qwen2_0_5b, qwen3_moe_235b, rwkv6_1_6b,
                                  zamba2_7b)

ALL_ARCH_IDS = (
    "gemma3-12b",
    "qwen2-0.5b",
    "rwkv6-1.6b",
    "qwen3-moe-235b-a22b",
    "llama4-maverick-400b-a17b",
    "zamba2-7b",
)
