from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: F401
                                      ModelConfig, ShapeConfig,
                                      cell_is_runnable, get_config,
                                      get_smoke_config)
