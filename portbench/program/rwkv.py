"""The program's configuration for the ``rwkv`` family (rwkv6-1.6b)."""
from __future__ import annotations

import dataclasses


def program_config(dm: dict):
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-1.6b")
    r = dataclasses.replace(cfg.rwkv, head_dim=dm["head_dim"],
                            decay_lora=dm["decay_lora"],
                            mix_lora=dm["mix_lora"])
    return dataclasses.replace(
        cfg, num_layers=dm["layers"], d_model=dm["d"], d_ff=dm["ff"],
        vocab_size=dm["vocab"], rwkv=r, dtype=dm["dtype"])
