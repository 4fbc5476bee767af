"""Model and input-shape configs (a copy of ``repro.configs``)."""
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs, register)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config",
           "list_archs"]
