"""The program's configuration for the ``hybrid`` family
(zamba2-7b-instruct)."""
from __future__ import annotations

import dataclasses


def program_config(dm: dict):
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-7b-instruct")
    attn = dataclasses.replace(
        cfg.attention, num_heads=dm["heads"], num_kv_heads=dm["kv_heads"],
        head_dim=dm["head_dim"], rope_theta=dm["rope_theta"],
        softmax_scale=(dm["head_dim"] / 2) ** -0.5)
    ssm = dataclasses.replace(
        cfg.ssm, state_dim=dm["state"], head_dim=dm["ssm_head_dim"],
        expand=dm["expand"], conv_kernel=dm["conv"], chunk_size=dm["chunk"],
        n_shared_blocks=dm["blocks"], n_groups=dm["groups"],
        hybrid_layer_ids=tuple(dm["hybrid"]),
        adapter_rank=dm["adapter_rank"])
    if ssm.expand * dm["d"] // ssm.head_dim != dm["ssm_heads"]:
        raise ValueError(f"{dm['ssm_heads']} Mamba heads of "
                         f"{ssm.head_dim} for d {dm['d']}")
    return dataclasses.replace(
        cfg, num_layers=dm["layers"], d_model=dm["d"], d_ff=dm["ff"],
        vocab_size=dm["vocab"], attention=attn, ssm=ssm,
        norm_eps=dm["eps"], dtype=dm["dtype"])
