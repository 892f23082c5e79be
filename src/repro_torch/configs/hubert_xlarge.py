"""hubert-xlarge [audio]: encoder-only; the convolutional frontend is a
stub (the batch carries frame features) (same values as
``repro.configs.hubert_xlarge``)."""
from .base import ArchConfig, register_arch

HUBERT_XLARGE = register_arch(ArchConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, act="gelu", norm="layernorm",
    frontend="audio",
    source="arXiv:2106.07447; unverified",
))
