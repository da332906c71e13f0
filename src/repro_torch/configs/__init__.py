"""Per-architecture configs (assigned pool) + paper workloads."""

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig, ShapeCell,
                                      all_cells, get_config, shape_applicable)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeCell", "all_cells",
           "get_config", "shape_applicable"]
