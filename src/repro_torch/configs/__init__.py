# Architecture and shape configurations: plain-Python dataclasses, the
# reference's field for field, with the ten architectures registered.
from repro_torch.configs.base import (SHAPES, ArchConfig, MoECfg, ShapeCfg,
                                      SSMCfg, all_archs, applicability,
                                      get_config, reduced_shape)

__all__ = ["SHAPES", "ArchConfig", "MoECfg", "ShapeCfg", "SSMCfg",
           "all_archs", "applicability", "get_config", "reduced_shape"]
