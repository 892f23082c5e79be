"""Architecture configs for the port (counterpart of ``repro.configs``)."""
from .base import (SHAPES, ArchConfig, ShapeConfig, arch_names, get_arch,
                   register_arch, shape_cells)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "arch_names", "get_arch",
           "register_arch", "shape_cells"]
