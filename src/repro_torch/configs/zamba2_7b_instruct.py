"""zamba2-7b-instruct [hybrid]: Zamba2-7B-Instruct at its published
widths and depth [hf:Zyphra/Zamba2-7B-Instruct config.json; its layer
equations: transformers' ``models/zamba2/modeling_zamba2.py``].

81 layers at d 3584, each a Mamba2 mixer (112 heads of 64, state 64,
two B/C groups, conv 4, chunk 256; a gated RMSNorm over each group's
3584 channels).  The 13 layers of ``hybrid_layer_ids`` first run one of
two weight-tied transformer blocks, in turn by hybrid ordinal, over
concat(x, x0) (x0 the embedding output):

    T = RMSNorm_7168(concat(x, x0))
    T = Attn(T)          # 32 heads of 224, RoPE over the whole head,
                         # scale (224 / 2)^-1/2, o: 7168 -> 3584
    T = RMSNorm_3584(T)
    T = down(gelu(g) * u), [g | u] = gate_up(T) + B_i(A_i(T))
    T = linear_i(T)      # per hybrid layer, as the adapter A_i, B_i
    x = x + Mamba(RMSNorm(x + T))

The tied block has no residual of its own.  GELU is exact (erf); every
norm's eps is 1e-5; the LM head is tied to the embedding
(``Zamba2Config``'s default, the config names none).  7,356,749,648
parameters.  ``time_step_limit`` is null, so dt is not clamped (as the
fused Mamba2 kernels run it; transformers' torch fallback clamps it
below at ``time_step_min``).  ``zamba2-7b`` is the port's own variant.

A port-only arch: not in ``all_archs.ALL_ARCH_IDS``, which equals the
JAX package's list, but in ``PORT_ONLY_ARCH_IDS``.
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      SSMConfig, register)

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = register(ModelConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32_000,
    attention=AttentionConfig(   # the tied blocks' attention
        num_heads=32,
        num_kv_heads=32,
        head_dim=224,            # attention_head_dim: 2 x 3584 / 32
        rope_theta=10_000.0,
        softmax_scale=112 ** -0.5,
    ),
    ssm=SSMConfig(
        state_dim=64,
        head_dim=64,
        expand=2,
        conv_kernel=4,
        chunk_size=256,
        n_shared_blocks=2,
        n_groups=2,
        hybrid_layer_ids=HYBRID_LAYER_IDS,
        adapter_rank=128,
    ),
    activation="geglu_exact",
    norm_eps=1e-5,
    tie_embeddings=True,
))
