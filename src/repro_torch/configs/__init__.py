"""Architecture configs: one public-literature config per assigned arch
(see registry.py) + per-arch module files for --arch discovery."""

from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                ShapeConfig, SHAPES, applicable_shapes)
from repro_torch.configs.registry import ARCHS, FULL_CONFIGS, load_config, smoke

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "applicable_shapes", "ARCHS", "FULL_CONFIGS", "load_config",
           "smoke"]
