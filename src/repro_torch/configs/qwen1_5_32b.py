"""qwen1.5-32b [dense]: QKV bias (same values as
``repro.configs.qwen1_5_32b``)."""
from .base import ArchConfig, register_arch

QWEN15_32B = register_arch(ArchConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, act="swiglu", norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))
