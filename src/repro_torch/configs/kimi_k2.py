"""kimi-k2-1t-a32b [moe]: 384 experts, top 8, with a dense residual MLP
(same values as ``repro.configs.kimi_k2``)."""
from .base import ArchConfig, register_arch

KIMI_K2 = register_arch(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    moe_experts=384, moe_top_k=8, moe_d_ff=2048, moe_dense_residual=True,
    act="swiglu", norm="rmsnorm",
    source="arXiv:2501.kimi2; unverified",
))
