from repro_torch.configs.base import (
    EncDecConfig,
    HybridConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    VLMConfig,
    get_config,
    list_configs,
    reduce_for_smoke,
    register,
)
from repro_torch.configs.shapes import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    InputShape,
    get_shape,
)

ASSIGNED_ARCHS = (
    "whisper-base",
    "rwkv6-1.6b",
    "yi-9b",
    "qwen3-moe-235b-a22b",
    "command-r-plus-104b",
    "llama-3.2-vision-11b",
    "zamba2-2.7b",
    "mistral-large-123b",
    "deepseek-v3-671b",
    "h2o-danube-1.8b",
)

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig",
    "EncDecConfig", "VLMConfig", "get_config", "list_configs", "register",
    "reduce_for_smoke", "InputShape", "get_shape", "SHAPES", "TRAIN_4K",
    "PREFILL_32K", "DECODE_32K", "LONG_500K", "ASSIGNED_ARCHS",
]
