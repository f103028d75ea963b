"""The program's configuration for the ``vlm`` family (pixtral-12b)."""
from __future__ import annotations

import dataclasses


def program_config(dm: dict):
    from repro_torch.configs import get_config
    cfg = get_config("pixtral-12b")
    attn = dataclasses.replace(
        cfg.attention, num_heads=dm["heads"], num_kv_heads=dm["kv_heads"],
        head_dim=dm["head_dim"], rope_theta=dm["rope_theta"])
    return dataclasses.replace(
        cfg, num_layers=dm["layers"], d_model=dm["d"], d_ff=dm["ff"],
        vocab_size=dm["vocab"], attention=attn, dtype=dm["dtype"])
