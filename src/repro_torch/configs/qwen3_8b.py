"""qwen3-8b [dense]: qk-norm, GQA (same values as ``repro.configs.qwen3_8b``)."""
from .base import ArchConfig, register_arch

QWEN3_8B = register_arch(ArchConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, act="swiglu", norm="rmsnorm", rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
))
