"""Model, shape and run configs: the reference's ``configs`` package, copied
as plain dataclasses and data (``get_config`` gives equal configs)."""

from repro_torch.configs.base import (MLAConfig, MambaConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, TrainConfig,
                                      SHAPES, SMOKE_SHAPES)
from repro_torch.configs.registry import (ARCH_IDS, all_archs, get_config,
                                          register)

__all__ = ["MLAConfig", "MambaConfig", "ModelConfig", "MoEConfig",
           "ShapeConfig", "TrainConfig", "SHAPES", "SMOKE_SHAPES",
           "ARCH_IDS", "all_archs", "get_config", "register"]
