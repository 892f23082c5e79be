"""Architecture configs for the port (counterpart of ``repro.configs``)."""
from .base import ArchConfig, get_arch, register_arch

__all__ = ["ArchConfig", "get_arch", "register_arch"]
