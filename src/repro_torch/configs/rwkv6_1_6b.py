"""rwkv6-1.6b 'Finch' [ssm]: attention-free, data-dependent decay (same
values as ``repro.configs.rwkv6_1_6b``)."""
from .base import ArchConfig, register_arch

RWKV6_1_6B = register_arch(ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    block="rwkv6", rwkv_head_dim=64, norm="layernorm", act="swiglu",
    source="arXiv:2404.05892; unverified",
))
