"""Assigned-architecture configs (one module per arch) + shape table."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: F401
                                      EncoderConfig, MLAConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig,
                                      cell_is_runnable, get_config,
                                      get_smoke_config)
