"""stablelm-3b [dense] (same values as ``repro.configs.stablelm_3b``)."""
from .base import ArchConfig, register_arch

STABLELM_3B = register_arch(ArchConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    qkv_bias=False, qk_norm=False, act="swiglu", norm="layernorm",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
))
