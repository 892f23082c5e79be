"""arctic-480b [moe]: 128 experts, top 2, with a dense residual MLP (same
values as ``repro.configs.arctic_480b``)."""
from .base import ArchConfig, register_arch

ARCTIC_480B = register_arch(ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    moe_experts=128, moe_top_k=2, moe_d_ff=4864, moe_dense_residual=True,
    act="swiglu", norm="rmsnorm",
    source="hf:Snowflake/snowflake-arctic-base; hf",
))
