from repro_torch.configs.base import (
    ModelConfig, InputShape, INPUT_SHAPES, smoke_shape,
    FULL_ATTN, LOCAL_ATTN, RGLRU, SSD,
)
from repro_torch.configs.registry import (
    ARCH_IDS, get_config, all_configs, get_shape, applicable,
)

__all__ = [
    "ModelConfig", "InputShape", "INPUT_SHAPES", "smoke_shape",
    "FULL_ATTN", "LOCAL_ATTN", "RGLRU", "SSD",
    "ARCH_IDS", "get_config", "all_configs", "get_shape", "applicable",
]
