from repro_torch.configs.base import (AttentionConfig, EncDecConfig,
                                      FrontendStub, MoEConfig, ModelConfig,
                                      RWKVConfig, SSMConfig, ShapeConfig,
                                      TrainConfig, SHAPES, TRAIN_4K,
                                      PREFILL_32K, DECODE_32K, LONG_500K,
                                      get_config, list_archs,
                                      reduce_config, register,
                                      supported_shapes)

__all__ = [
    "AttentionConfig", "EncDecConfig", "FrontendStub", "MoEConfig",
    "ModelConfig", "RWKVConfig", "SSMConfig", "ShapeConfig", "TrainConfig",
    "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "get_config", "list_archs", "reduce_config", "register",
    "supported_shapes",
]
