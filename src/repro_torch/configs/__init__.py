from repro_torch.configs.base import (
    ArchConfig,
    EncoderConfig,
    InputShape,
    LayerSpec,
    MLAConfig,
    MoEConfig,
    SHAPES,
    SSMConfig,
)
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = [
    "ArchConfig",
    "EncoderConfig",
    "InputShape",
    "LayerSpec",
    "MLAConfig",
    "MoEConfig",
    "SHAPES",
    "SSMConfig",
    "ARCHS",
    "get_arch",
]
