"""Architecture configuration: the ``ArchConfig`` fields the DiT and the
training launcher read (a subset of ``repro.configs.base.ArchConfig``, same
names and values) and the registry.  The DiT's norms are RMSNorm, whatever
the JAX config's ``norm`` field says; the port has no such field.  The
registry holds the DiT configs only: any other name, such as an arch of
the JAX package's language-model zoo, raises ``NotImplementedError``
naming ROADMAP A11."""
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
    family: str = "dit"              # the only family until the zoo (A11)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the DiT fields of
        ``repro.configs.base.ArchConfig.reduced``)."""
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=2, d_model=64,
            num_heads=max(2, min(4, self.num_heads)),
            num_kv_heads=max(1, min(2, self.num_kv_heads)), head_dim=16,
            d_ff=128,
            patch_size=min(self.patch_size, 2) if self.patch_size else 0,
            dtype="float32")


_ARCHS = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from . import srds_dit  # noqa: F401  (self-registers the DiT configs)
    if name not in _ARCHS:
        raise NotImplementedError(
            f"{name!r} is not a DiT of the port (have {sorted(_ARCHS)}); the "
            f"JAX package's LM zoo is not ported yet (ROADMAP A11)")
    return _ARCHS[name]
