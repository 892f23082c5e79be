"""Architecture configuration: the ``ArchConfig`` fields the DiT reads
(a subset of ``repro.configs.base.ArchConfig``, same names and values) and
the registry.  The DiT's norms are RMSNorm, whatever the JAX config's
``norm`` field says; the port has no such field."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None
    patch_size: int = 0
    in_channels: int = 0
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


_ARCHS = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from . import srds_dit  # noqa: F401  (self-registers the DiT configs)
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCHS)}")
    return _ARCHS[name]
