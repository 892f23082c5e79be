"""Architecture configuration: the ``ArchConfig`` fields the DiT, the
training launcher and the language models read (a subset of
``repro.configs.base.ArchConfig``, same names, defaults and values), and
the registry.

The DiT reads none of ``norm``, ``act``, ``causal`` or ``vocab_size``: its
norms are RMSNorm and its MLP is GELU whatever the config says (the JAX
DiT configs say ``norm="layernorm"``; the port's carry the same values so
that a config compares equal to JAX's field for field).  The registry
holds the DiT configs and the language models the port serves
(``qwen3-8b``, ``rwkv6-1.6b``, ``hymba-1.5b``); any other name of the JAX
package's zoo raises ``NotImplementedError`` naming ROADMAP A11."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int = 0
    head_dim: Optional[int] = None
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None     # sliding-window attention size
    rope_theta: float = 10_000.0
    # block wiring
    block: str = "attn_mlp"          # attn_mlp | rwkv6 | hymba
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    # SSM / RWKV
    ssm_state: int = 0               # hymba per-head SSM state size
    ssm_d_inner: int = 0             # hymba SSM inner width (0 -> d_model)
    rwkv_head_dim: int = 64
    # DiT specifics
    patch_size: int = 0
    in_channels: int = 0
    dtype: str = "bfloat16"
    source: str = ""
    family: str = "dit"              # dit | dense | ssm | hybrid (the JAX
                                     # zoo's names)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def padded_heads(self, model_parallel: int) -> Tuple[int, int]:
        """(q_heads, kv_heads) padded so tensor parallelism over
        ``model_parallel`` divides them: q heads first, then kv heads to the
        smallest divisor of the padded q count that is >= the original."""
        hq, hkv = self.num_heads, self.num_kv_heads
        if hq % model_parallel:
            hq = _round_up(hq, model_parallel)
        if hq % hkv:
            hkv = min(d for d in range(hkv, hq + 1) if hq % d == 0)
        return hq, hkv

    def padded_vocab(self, model_parallel: int) -> int:
        return _round_up(self.vocab_size, max(128, model_parallel))

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the fields of
        ``repro.configs.base.ArchConfig.reduced`` that the port has)."""
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=2, d_model=64,
            num_heads=max(2, min(4, self.num_heads)),
            num_kv_heads=max(1, min(2, self.num_kv_heads)), head_dim=16,
            d_ff=128, vocab_size=256, ssm_state=min(self.ssm_state, 8),
            ssm_d_inner=64 if self.block == "hymba" else 0, rwkv_head_dim=16,
            window=min(self.window, 32) if self.window else None,
            patch_size=min(self.patch_size, 2) if self.patch_size else 0,
            dtype="float32")


_ARCHS = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    # the config modules self-register
    from . import hymba_1_5b, qwen3_8b, rwkv6_1_6b, srds_dit  # noqa: F401
    if name not in _ARCHS:
        raise NotImplementedError(
            f"{name!r} is not an arch of the port (have {sorted(_ARCHS)}); "
            f"the rest of the JAX package's LM zoo is not ported yet "
            f"(ROADMAP A11)")
    return _ARCHS[name]
