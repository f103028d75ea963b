"""Import every architecture config the port has brought up, so the
registry is populated.  Other families register with their slices."""
# flake8: noqa: F401
from repro_torch.configs import qwen2_0_5b, rwkv6_1_6b

ALL_ARCH_IDS = (
    "qwen2-0.5b",
    "rwkv6-1.6b",
)
