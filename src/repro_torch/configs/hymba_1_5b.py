"""hymba-1.5b [hybrid]: parallel attention and selective-SSM heads in every
layer, all layers sliding-window (same values as
``repro.configs.hymba_1_5b``)."""
from .base import ArchConfig, register_arch

HYMBA_1_5B = register_arch(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    block="hymba", ssm_state=16, ssm_d_inner=1600,
    window=1024, act="swiglu", norm="rmsnorm",
    source="arXiv:2411.13676; hf",
))
