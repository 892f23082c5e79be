"""Architecture and shape configuration (counterpart of
``repro.configs.base``): ``ArchConfig`` with JAX's fields, defaults and
derived counts (``padded_heads``, ``padded_vocab``, ``param_count``,
``active_param_count``), ``ShapeConfig`` and the assignment's ``SHAPES``
with :func:`shape_cells`' skip rules, and the registry.

The DiT reads none of ``norm``, ``act``, ``causal`` or ``vocab_size``: its
norms are RMSNorm and its MLP is GELU whatever the config says (the JAX
DiT configs say ``norm="layernorm"``; the port's carry the same values so
that a config compares equal to JAX's field for field).  The registry
holds every architecture of the JAX package (:func:`arch_names`: the
three DiTs and the ten language models of its zoo, dense, MoE, RWKV6,
hybrid, audio and vision); an unknown name raises ``KeyError``, as
JAX's does."""
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
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP beside the MoE
    moe_capacity_factor: float = 1.25
    # SSM / RWKV
    ssm_state: int = 0               # hymba per-head SSM state size
    ssm_d_inner: int = 0             # hymba SSM inner width (0 -> d_model)
    rwkv_head_dim: int = 64
    # modality frontends (stubs: the batch carries precomputed embeddings)
    frontend: Optional[str] = None   # vision | audio
    num_prefix_embeds: int = 0       # image patches spliced as a prefix
    # DiT specifics
    patch_size: int = 0
    in_channels: int = 0
    dtype: str = "bfloat16"
    source: str = ""
    family: str = "dit"              # dit | dense | moe | ssm | hybrid |
                                     # vlm | audio (the JAX zoo's names)

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

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM, sliding window, RWKV)."""
        return self.block in ("rwkv6", "hymba") or self.window is not None

    def param_count(self) -> int:
        """JAX's approximate parameter count (embeddings + blocks)."""
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * d
        mlp_mult = 3 if self.act == "swiglu" else 2
        if self.block == "rwkv6":
            per_layer = 4 * d * d + 2 * d * self.d_ff + d * d
        elif self.block == "hymba":
            din = self.ssm_d_inner or d
            ssm = d * 2 * din + din * (2 * self.ssm_state + 2) + din * d
            per_layer = attn + ssm + mlp_mult * d * self.d_ff
        else:
            per_layer = attn + mlp_mult * d * self.d_ff
            if self.moe_experts:
                per_layer += (self.moe_experts * mlp_mult * d * self.moe_d_ff
                              + d * self.moe_experts)
                if not self.moe_dense_residual:
                    per_layer -= mlp_mult * d * self.d_ff
        embed = self.vocab_size * d * (1 if self.is_encoder_only else 2)
        return self.num_layers * per_layer + embed

    def active_param_count(self) -> int:
        """Parameters a token uses (MoE: ``moe_top_k`` of the experts)."""
        if not self.moe_experts:
            return self.param_count()
        mlp_mult = 3 if self.act == "swiglu" else 2
        inactive = (self.moe_experts - self.moe_top_k) * mlp_mult \
            * self.d_model * self.moe_d_ff
        return self.param_count() - self.num_layers * inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests
        (``repro.configs.base.ArchConfig.reduced``)."""
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=2, d_model=64,
            num_heads=max(2, min(4, self.num_heads)),
            num_kv_heads=max(1, min(2, self.num_kv_heads)), head_dim=16,
            d_ff=128, vocab_size=256,
            moe_experts=min(self.moe_experts, 4),
            moe_d_ff=64 if self.moe_experts else 0,
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=min(self.ssm_state, 8),
            ssm_d_inner=64 if self.block == "hymba" else 0, rwkv_head_dim=16,
            window=min(self.window, 32) if self.window else None,
            num_prefix_embeds=min(self.num_prefix_embeds, 4),
            patch_size=min(self.patch_size, 2) if self.patch_size else 0,
            dtype="float32")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_ARCHS = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    # the config modules self-register
    from . import (arctic_480b, hubert_xlarge, hymba_1_5b,  # noqa: F401
                   kimi_k2, phi3_vision, qwen1_5_32b, qwen3_8b, qwen3_14b,
                   rwkv6_1_6b, srds_dit, stablelm_3b)


def get_arch(name: str) -> ArchConfig:
    _load_all()
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCHS)}")
    return _ARCHS[name]


def arch_names():
    _load_all()
    return sorted(_ARCHS)


def shape_cells(arch: ArchConfig):
    """The runnable (arch x shape) cells by the assignment's skip rules:
    full-attention archs skip the 500k decode, encoder-only archs every
    decode."""
    cells = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not arch.supports_long_context:
            continue
        if s.is_decode and arch.is_encoder_only:
            continue
        cells.append(s)
    return cells
