"""qwen3-14b [dense]: qk-norm, GQA (same values as
``repro.configs.qwen3_14b``)."""
from .base import ArchConfig, register_arch

QWEN3_14B = register_arch(ArchConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True, act="swiglu", norm="rmsnorm", rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
))
