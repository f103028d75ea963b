"""Import every architecture config so the registry is populated."""
# flake8: noqa: F401
from repro_torch.configs import (deepseek_67b, gemma3_12b,
                                  llama4_maverick_400b, pixtral_12b,
                                  qwen2_0_5b, qwen2_72b, qwen3_moe_235b,
                                  rwkv6_1_6b, whisper_base, zamba2_7b,
                                  zamba2_7b_instruct)

ALL_ARCH_IDS = (
    "gemma3-12b",
    "qwen2-0.5b",
    "deepseek-67b",
    "qwen2-72b",
    "pixtral-12b",
    "whisper-base",
    "zamba2-7b",
    "llama4-maverick-400b-a17b",
    "qwen3-moe-235b-a22b",
    "rwkv6-1.6b",
)

# registered for the port alone: the JAX package has no such arch
PORT_ONLY_ARCH_IDS = (
    "zamba2-7b-instruct",
)
